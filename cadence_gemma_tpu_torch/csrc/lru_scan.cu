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
// _sharded_scan). The complex body (_lru_complex_kernel) is not ported here.
//
// What bounds it: device memory. Each element of x (or g) and a is read once
// and each output written once with two flops in between (three with the
// product), far below the ~295 flops per byte where an H100 stops being
// memory-bound.
//
// Design: one thread owns one (batch, channel) pair -- two adjacent channels
// for bf16, loaded as one bf16x2 -- and keeps the fp32 carry (and the
// product's carry) in registers while it walks the time axis. Neighbouring
// threads own neighbouring channels, so every load and store of a warp is one
// coalesced row segment. The TPU kernel's sequential grid axis ("arbitrary"
// semantics, carry in a VMEM scratch) becomes this in-thread loop; its
// [b, t, d/128, 128] reshape and padding existed only for the TPU's tiling
// and are gone. Loads of kUnroll steps are issued before their multiply-adds
// so that several memory requests are in flight per thread. With b * d / 2
// threads (5120 for the 2B at batch 2) the card is under-occupied; a chunked
// two-pass scan over t is the later fix.
//
// The multiply and add are rounded separately (no fused multiply-add) so the
// kernel reproduces the plain PyTorch loops bit for bit. The backward shares
// the forward's code through the kBackprop template flag: only the order of
// the add and the multiply and the direction of the walk differ. The product
// is a third template flag, so the entry points without it compile to the
// same code as before it existed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

template <typename T, int V>
struct Access;

template <>
struct Access<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    out[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct Access<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    out[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    p[0] = __float2bfloat16_rn(v[0]);
  }
};

template <>
struct Access<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x;
    out[1] = f.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};

// kBackprop = false: the forward scan, time ascending unless `reverse`.
// kBackprop = true: the cotangent scan of that forward, walked the other way.
// kAProd: also write the running product of `a` (a_prod, a_prod_last).
template <typename T, int V, bool kBackprop, bool kAProd>
__global__ void __launch_bounds__(kThreads)
    lru_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
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
          // The TPU kernel's p = p * a_t in either mode, rounded alone.
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
cudaError_t launch(const void* x, const void* a, const void* h0, void* y,
                   void* h_last, void* a_prod, void* a_prod_last, int batch,
                   int seq, int dim, int reverse, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(batch) * (dim / V);
  if (threads == 0) return cudaSuccess;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  lru_scan_kernel<T, V, kBackprop, kAProd>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_last), static_cast<T*>(a_prod),
      static_cast<float*>(a_prod_last), batch, seq, dim, reverse);
  return cudaGetLastError();
}

template <bool kBackprop, bool kAProd>
int dispatch(const void* x, const void* a, const void* h0, void* y,
             void* h_last, void* a_prod, void* a_prod_last, int batch,
             int seq, int dim, int dtype, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, 1, kBackprop, kAProd>(x, a, h0, y, h_last, a_prod,
                                               a_prod_last, batch, seq, dim,
                                               reverse, s);
  }
  if (dtype == 1) {
    const bool paired =
        dim % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
        reinterpret_cast<uintptr_t>(a) % 4 == 0 &&
        reinterpret_cast<uintptr_t>(y) % 4 == 0 &&
        reinterpret_cast<uintptr_t>(a_prod) % 4 == 0;
    if (paired) {
      return launch<__nv_bfloat16, 2, kBackprop, kAProd>(
          x, a, h0, y, h_last, a_prod, a_prod_last, batch, seq, dim, reverse,
          s);
    }
    return launch<__nv_bfloat16, 1, kBackprop, kAProd>(
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
