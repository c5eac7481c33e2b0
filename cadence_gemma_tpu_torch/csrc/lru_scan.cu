// RG-LRU scans over the time axis of [batch, seq, dim] inputs with an fp32
// carry, outputs in the input type and the final carry in fp32:
//
//   forward (cg_lru_scan_forward):    h_t = a_t * h_{t-1} + x_t, y_t = h_t;
//   backward (cg_lru_scan_backward):  the cotangent scan, walked against the
//     forward's direction: h += g_t, dx_t = h, then h *= a_t. The carry
//     starts at dh_last, and the final carry is dh0 = a_0 * dh_0.
//
// The *_a_prod entry points also write the running product of `a` in the
// walk's order, a_prod_t = a_t * a_prod_{t-1} from an fp32 carry that starts
// at 1, in the input type, and its final value a_prod_last in fp32: what a
// sequence-parallel shard needs to correct its local scan
// (parallel/sharding.py::multi_shard_correction).
//
// Replaces the TPU kernel cadence_gemma_tpu/ops/pallas_lru.py::_lru_kernel,
// reached through lru_pallas_scan -> _lru_pallas_call: in forward mode
// (premultiply=False) and in backward mode (premultiply=True, the cotangent
// scan of _lru_bwd), each with compute_a_prod=False (the plain entry points)
// and compute_a_prod=True (the *_a_prod entry points, called by
// _sharded_scan). The complex body (_lru_complex_kernel) is
// lru_scan_complex.cu.
//
// What bounds it: device memory, and the walk. Each element of x (or g) and
// a is read once and each output written once with two flops in between
// (three with the product), far below the ~295 flops per byte where an H100
// stops being memory-bound. But every step of a channel depends on the one
// before, so a channel's t steps run one after another in one thread
// whatever the grid: the walk of one tile of st steps, not the bytes, sets
// the pace at the model's shapes (~25 cycles a step on an H100, where the
// fp32 multiply and add alone take ~8: the step's shared-memory loads and
// stores are what the warp issues most).
//
// Design: the TMA ring of lru_ring.cuh (ring_kernel) with its real walk
// (RealWalk) in tiles of st = 128 steps: a block owns C = 32 channels of one
// batch row (16 when batch * ceil(dim / 32) blocks would not cover the
// SMs), a producer thread streams [1, 128, C] boxes of x (or g) and a into
// 6 stages at C = 32 (12 at C = 16; 96 KB a block in bf16, 192 KB in
// fp32), one consumer thread a channel walks each tile with the fp32 carry
// (and the product's) in registers, in the plain loops' exact operations
// and order, and y (dx) and a_prod overwrite their inputs in the stage and
// leave by TMA store.
//
// A launch whose tensors TMA cannot describe -- a row of dim * sizeof(T) that
// is not a multiple of 16 bytes, a base that is not 16-byte aligned, or an
// empty time axis -- takes the per-thread walk instead (thread_walk_kernel):
// one thread a (batch, channel), or a bf16 channel pair, walks the whole
// time axis from global memory, kUnroll steps of loads ahead. ops/lru_scan.py
// counts the two routes apart (takes_ring has its twin there).
//
// The multiply and add are rounded separately (no fused multiply-add) so both
// routes reproduce the plain PyTorch loops bit for bit. The backward shares
// the forward's code through the kBackprop template flag: only the order of
// the add and the multiply and the direction of the walk differ. The product
// is a third template flag, so the entry points without it compile to code
// that has none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "lru_access.cuh"
#include "lru_ring.cuh"

namespace {

// ------------------------------------------------------- the TMA ring route

constexpr int kSteps = 128;  // st: time steps a tile

template <typename T, int C, bool kBackprop, bool kAProd>
using Walk = lru_ring::RealWalk<T, C, kSteps, kBackprop, kAProd>;

// ------------------------------------------------ the per-thread walk route

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

template <typename T, int V, bool kBackprop, bool kAProd>
__global__ void __launch_bounds__(kThreads)
    thread_walk_kernel(const T* __restrict__ x, const T* __restrict__ a,
                       const float* __restrict__ h0, T* __restrict__ y,
                       float* __restrict__ h_last, T* __restrict__ a_prod,
                       float* __restrict__ a_prod_last, int batch, int seq,
                       int dim, int reverse) {
  const bool descending = (reverse != 0) != kBackprop;
  const int groups = dim / V;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(batch) * groups) return;
  const int b = static_cast<int>(idx / groups);
  const int c = static_cast<int>(idx % groups) * V;

  float h[V];
  float p[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    h[v] = h0 == nullptr ? 0.f : h0[static_cast<int64_t>(b) * dim + c + v];
    p[v] = 1.f;
  }

  const int64_t base = static_cast<int64_t>(b) * seq * dim + c;
  for (int i0 = 0; i0 < seq; i0 += kUnroll) {
    float xs[kUnroll][V];
    float as[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u;
      if (i < seq) {
        const int t = descending ? seq - 1 - i : i;
        const int64_t off = base + static_cast<int64_t>(t) * dim;
        Access<T, V>::load(x + off, xs[u]);
        Access<T, V>::load(a + off, as[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u;
      if (i < seq) {
        const int t = descending ? seq - 1 - i : i;
        if (kBackprop) {
#pragma unroll
          for (int v = 0; v < V; ++v) h[v] = __fadd_rn(h[v], xs[u][v]);
          Access<T, V>::store(y + base + static_cast<int64_t>(t) * dim, h);
#pragma unroll
          for (int v = 0; v < V; ++v) h[v] = __fmul_rn(h[v], as[u][v]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            h[v] = __fadd_rn(__fmul_rn(as[u][v], h[v]), xs[u][v]);
          }
          Access<T, V>::store(y + base + static_cast<int64_t>(t) * dim, h);
        }
        if (kAProd) {
#pragma unroll
          for (int v = 0; v < V; ++v) p[v] = __fmul_rn(p[v], as[u][v]);
          Access<T, V>::store(a_prod + base + static_cast<int64_t>(t) * dim,
                              p);
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    h_last[static_cast<int64_t>(b) * dim + c + v] = h[v];
    if (kAProd) a_prod_last[static_cast<int64_t>(b) * dim + c + v] = p[v];
  }
}

template <typename T, int V, bool kBackprop, bool kAProd>
cudaError_t launch_thread_walk(const void* x, const void* a, const void* h0,
                               void* y, void* h_last, void* a_prod,
                               void* a_prod_last, int batch, int seq, int dim,
                               int reverse, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(batch) * (dim / V);
  if (threads == 0) return cudaSuccess;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  thread_walk_kernel<T, V, kBackprop, kAProd>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_last), static_cast<T*>(a_prod),
      static_cast<float*>(a_prod_last), batch, seq, dim, reverse);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- dispatch

template <typename T, bool kBackprop, bool kAProd>
int dispatch_type(const void* x, const void* a, const void* h0, void* y,
                  void* h_last, void* a_prod, void* a_prod_last, int batch,
                  int seq, int dim, int reverse, cudaStream_t s) {
  if (batch == 0 || dim == 0) return cudaSuccess;
  if (lru_ring::takes_ring(seq, dim, sizeof(T), x, a, y, a_prod)) {
    const void* loads[2] = {x, a};
    void* stores[2] = {y, a_prod};
    const lru_ring::Carries carries{{static_cast<const float*>(h0), nullptr},
                                    {static_cast<float*>(h_last), nullptr},
                                    {static_cast<float*>(a_prod_last),
                                     nullptr}};
    return lru_ring::launch<Walk<T, 32, kBackprop, kAProd>,
                            Walk<T, 16, kBackprop, kAProd>>(
        loads, stores, carries, batch, seq, dim, (reverse != 0) != kBackprop,
        s);
  }
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (paired_bf16(dim, x, a, y, a_prod)) {
      return launch_thread_walk<T, 2, kBackprop, kAProd>(
          x, a, h0, y, h_last, a_prod, a_prod_last, batch, seq, dim, reverse,
          s);
    }
  }
  return launch_thread_walk<T, 1, kBackprop, kAProd>(
      x, a, h0, y, h_last, a_prod, a_prod_last, batch, seq, dim, reverse, s);
}

template <bool kBackprop, bool kAProd>
int dispatch(const void* x, const void* a, const void* h0, void* y,
             void* h_last, void* a_prod, void* a_prod_last, int batch,
             int seq, int dim, int dtype, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_type<float, kBackprop, kAProd>(
        x, a, h0, y, h_last, a_prod, a_prod_last, batch, seq, dim, reverse, s);
  }
  if (dtype == 1) {
    return dispatch_type<__nv_bfloat16, kBackprop, kAProd>(
        x, a, h0, y, h_last, a_prod, a_prod_last, batch, seq, dim, reverse, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. h0 may be null (zero initial state).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cg_lru_scan_forward(const void* x, const void* a,
                                   const void* h0, void* y, void* h_last,
                                   int batch, int seq, int dim, int dtype,
                                   int reverse, void* stream) {
  return dispatch<false, false>(x, a, h0, y, h_last, nullptr, nullptr, batch,
                                seq, dim, dtype, reverse, stream);
}

// The cotangent scan of a forward scan run with the same `reverse`: g is the
// cotangent of y, dh_last (may be null: zeros) that of h_last; writes dx in
// g's type and dh0 in fp32. Returns the cudaError_t of the launch.
extern "C" int cg_lru_scan_backward(const void* g, const void* a,
                                    const void* dh_last, void* dx, void* dh0,
                                    int batch, int seq, int dim, int dtype,
                                    int reverse, void* stream) {
  return dispatch<true, false>(g, a, dh_last, dx, dh0, nullptr, nullptr,
                               batch, seq, dim, dtype, reverse, stream);
}

// cg_lru_scan_forward that also writes the running product of `a` in the
// walk's order: a_prod in x's type, a_prod_last (the whole product) in fp32.
extern "C" int cg_lru_scan_forward_a_prod(const void* x, const void* a,
                                          const void* h0, void* y,
                                          void* h_last, void* a_prod,
                                          void* a_prod_last, int batch,
                                          int seq, int dim, int dtype,
                                          int reverse, void* stream) {
  return dispatch<false, true>(x, a, h0, y, h_last, a_prod, a_prod_last,
                               batch, seq, dim, dtype, reverse, stream);
}

// cg_lru_scan_backward that also writes the running product of `a` in its
// walk's order (against the forward's): a_prod in g's type, a_prod_last fp32.
extern "C" int cg_lru_scan_backward_a_prod(const void* g, const void* a,
                                           const void* dh_last, void* dx,
                                           void* dh0, void* a_prod,
                                           void* a_prod_last, int batch,
                                           int seq, int dim, int dtype,
                                           int reverse, void* stream) {
  return dispatch<true, true>(g, a, dh_last, dx, dh0, a_prod, a_prod_last,
                              batch, seq, dim, dtype, reverse, stream);
}

// The TMA ring kernel's resources (its ascending walk) for the entry point
// named by `backprop` and `a_prod`, at dtype (0 float32, 1 bfloat16) and C =
// `channels` (16 or 32): info = {registers a thread at launch, local
// (spilled) bytes a thread, dynamic shared memory bytes a block, threads a
// block}.
extern "C" int cg_lru_scan_attributes(int backprop, int a_prod, int dtype,
                                      int channels, int* info) {
  return lru_ring::walk_attributes<Walk>(backprop, a_prod, dtype, channels,
                                         info);
}
