// Complex-valued RG-LRU scans over the time axis of [batch, seq, dim]
// inputs, each complex stream held as two planar real tensors (re, im) of
// the input type, with an fp32 carry per component:
//
//   forward (cg_lru_scan_complex_forward):   h_t = a_t * h_{t-1} + x_t,
//     y_t = h_t, in the complex product
//     (hr, hi) <- ((ar*hr - ai*hi) + xr, (ar*hi + ai*hr) + xi);
//   backward (cg_lru_scan_complex_backward): the cotangent scan of that
//     forward, walked against its direction: h += g_t, dx_t = h, then
//     h *= conj(a_t). The carry starts at dh_last; the final carry is dh0.
//
// The *_a_prod entry points also write the running product of the walk's
// multipliers (a in the forward, conj(a) in the backward) from an fp32 carry
// that starts at 1 + 0i, p <- p * m, in the input type, and its final value
// in fp32: what a sequence-parallel shard needs to correct its local scan.
//
// Replaces the TPU kernel cadence_gemma_tpu/ops/pallas_lru.py::
// _lru_complex_kernel, reached through lru_pallas_scan -> _lru_pallas_call
// with complex_lib.Complex operands: forward (premultiply=False) and backward
// (premultiply=True, from _lru_bwd), each with and without compute_a_prod
// (_sharded_scan). JAX's caller negates a.imag before the backward call;
// here the backward entry points negate it as they load it, so no
// conjugated copy of `a` is written or read.
//
// What bounds it: device memory in principle. Each step reads four
// components (x, a) and writes two (y), four with the product, with eight
// to fourteen flops in between, far below the ~295 flops per byte where an
// H100 stops being memory-bound. In practice the walk, as for the real
// scan: the step's dependent chain (a multiply, a subtract and an add on
// the carry) and the shared-memory accesses the warp issues for it, four
// loads and two stores a step (four stores with the product).
//
// Design: the TMA ring of lru_ring.cuh with the complex walk below
// (ComplexWalk) in tiles of st = 64 steps. A stage holds the x.real,
// x.imag, a.real and a.imag tiles of one row's C channels, which one
// producer thread loads by TMA behind one expect_tx: 6 stages at C = 32,
// 12 at C = 16 (96 KB a block in bf16, so two blocks share an SM; 192 KB in
// fp32). One consumer thread a channel keeps the carry (hr, hi), and the
// product's (pr, pi), in registers; y (dx) overwrites the x tiles and the
// product the a tiles, and one TMA store a stream writes each tile back.
// The cotangent walk negates a.imag as it widens the loaded value.
//
// Launches TMA cannot describe (a row of dim * sizeof(T) that is not a
// multiple of 16 bytes, a component whose base is not 16-byte aligned, or
// an empty time axis) take the per-thread walk (thread_walk_kernel): one
// thread owns one (batch, channel) pair -- two adjacent channels for bf16,
// loaded as one bf16x2 a component -- and walks the whole time axis from
// global memory, kUnroll steps of loads issued before their arithmetic.
// ops/lru_scan.py counts the two routes apart.
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, which nvcc never contracts into a fused multiply-add), in the
// order of the Pallas body and of complex_lib.Complex's product, so the
// kernel reproduces the plain PyTorch loops bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "lru_access.cuh"
#include "lru_ring.cuh"

namespace {

// ------------------------------------------------------- the TMA ring route

constexpr int kRingSteps = 64;  // st: time steps a tile

// The complex walk: streams x.real, x.imag, a.real and a.imag (g for x in
// the cotangent walk); y (dx) over x, the running product over a. Each step
// rounds today's operations alone in the plain loops' order.
template <typename Elem, int kC, bool kBackprop, bool kAProd>
struct ComplexWalk {
  using T = Elem;
  static constexpr int kChannels = kC;
  static constexpr int kSteps = kRingSteps;
  static constexpr int kStreams = 4;
  static constexpr int kStores = kAProd ? 4 : 2;
  // Steps of operands loaded a chunk ahead: 8 keeps the four streams' raw
  // and widened chunks (64 registers) clear of spills.
  static constexpr int kChunk = 8;
  static_assert(kSteps % kChunk == 0, "a tile is whole chunks");
  static constexpr int kTileBytes = kSteps * kC * static_cast<int>(sizeof(T));

  struct Carry {
    float hr, hi, pr, pi;
  };

  static __device__ __forceinline__ Carry start(const lru_ring::Carries& c,
                                                int64_t at, bool valid) {
    return {c.h0[0] != nullptr && valid ? c.h0[0][at] : 0.f,
            c.h0[1] != nullptr && valid ? c.h0[1][at] : 0.f, 1.f, 0.f};
  }

  static __device__ __forceinline__ void finish(const lru_ring::Carries& c,
                                                int64_t at,
                                                const Carry& carry) {
    c.h_last[0][at] = carry.hr;
    c.h_last[1][at] = carry.hi;
    if (kAProd) {
      c.a_prod_last[0][at] = carry.pr;
      c.a_prod_last[1][at] = carry.pi;
    }
  }

  // As RealWalk::tile: chunks of kChunk steps in a loop that is not
  // unrolled, each chunk's raw operands loaded by the iteration before and
  // widened after the back-edge. Stream s of step j of a chunk lies at
  // base + s * kTileBytes + j * kStep.
  template <bool kDescending, bool kPartial>
  static __device__ __forceinline__ void tile(uint32_t col, int rows,
                                              Carry& carry) {
    using S = lru_ring::Smem<T>;
    constexpr int kStep =
        (kDescending ? -1 : 1) * kC * static_cast<int>(sizeof(T));
    const int first = kDescending ? kSteps - 1 : 0;
    uint32_t base = col + first * kC * sizeof(T);
    float hr = carry.hr, hi = carry.hi, pr = carry.pr, pi = carry.pi;
    typename S::Raw raw[kStreams][kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
#pragma unroll
      for (int s = 0; s < kStreams; ++s) {
        raw[s][j] = S::load(base + s * kTileBytes + j * kStep);
      }
    }
#pragma unroll 1
    for (int s0 = 0; s0 < kSteps; s0 += kChunk) {
      float v[kStreams][kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
#pragma unroll
        for (int s = 0; s < kStreams; ++s) v[s][j] = S::to_f32(raw[s][j]);
        if (kBackprop) v[3][j] = -v[3][j];  // conj(a)
      }
      if (s0 + kChunk < kSteps) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
#pragma unroll
          for (int s = 0; s < kStreams; ++s) {
            raw[s][j] = S::load(base + s * kTileBytes + (kChunk + j) * kStep);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (kPartial) {
          const int s = s0 + j;
          if ((kDescending ? kSteps - 1 - s : s) >= rows) continue;
        }
        const float xr = v[0][j], xi = v[1][j], mr = v[2][j], mi = v[3][j];
        if (kBackprop) {
          // premultiply: emit h + g, then multiply the carry by conj(a).
          hr = __fadd_rn(hr, xr);
          hi = __fadd_rn(hi, xi);
          S::store(base + j * kStep, hr);
          S::store(base + kTileBytes + j * kStep, hi);
          const float nr = __fsub_rn(__fmul_rn(hr, mr), __fmul_rn(hi, mi));
          const float ni = __fadd_rn(__fmul_rn(hr, mi), __fmul_rn(hi, mr));
          hr = nr;
          hi = ni;
        } else {
          const float nr = __fadd_rn(
              __fsub_rn(__fmul_rn(mr, hr), __fmul_rn(mi, hi)), xr);
          const float ni = __fadd_rn(
              __fadd_rn(__fmul_rn(mr, hi), __fmul_rn(mi, hr)), xi);
          hr = nr;
          hi = ni;
          S::store(base + j * kStep, hr);
          S::store(base + kTileBytes + j * kStep, hi);
        }
        if (kAProd) {
          // p = p * m, rounded as the Pallas body's pr*mr - pi*mi and
          // pr*mi + pi*mr.
          const float nr = __fsub_rn(__fmul_rn(pr, mr), __fmul_rn(pi, mi));
          const float ni = __fadd_rn(__fmul_rn(pr, mi), __fmul_rn(pi, mr));
          pr = nr;
          pi = ni;
          S::store(base + 2 * kTileBytes + j * kStep, pr);
          S::store(base + 3 * kTileBytes + j * kStep, pi);
        }
      }
      base += kChunk * kStep;
    }
    carry = Carry{hr, hi, pr, pi};
  }
};

// ------------------------------------------------ the per-thread walk route

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

// The planar (re, im) pointers of the scan's streams.
template <typename T>
struct Streams {
  const T* xr;
  const T* xi;
  const T* ar;
  const T* ai;
  const float* h0r;
  const float* h0i;
  T* yr;
  T* yi;
  float* hlr;
  float* hli;
  T* pr;
  T* pi;
  float* plr;
  float* pli;
};

// kBackprop = false: the forward scan, time ascending unless `reverse`.
// kBackprop = true: the cotangent scan of that forward, walked the other
// way, multiplying by conj(a).
// kAProd: also write the running product of the multipliers.
template <typename T, int V, bool kBackprop, bool kAProd>
__global__ void __launch_bounds__(kThreads)
    thread_walk_kernel(Streams<T> s, int batch, int seq, int dim,
                       int reverse) {
  const bool descending = (reverse != 0) != kBackprop;
  const int groups = dim / V;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(batch) * groups) return;
  const int b = static_cast<int>(idx / groups);
  const int c = static_cast<int>(idx % groups) * V;
  const int64_t state = static_cast<int64_t>(b) * dim + c;

  float hr[V], hi[V], pr[V], pi[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    hr[v] = s.h0r == nullptr ? 0.f : s.h0r[state + v];
    hi[v] = s.h0i == nullptr ? 0.f : s.h0i[state + v];
    pr[v] = 1.f;
    pi[v] = 0.f;
  }

  const int64_t base = static_cast<int64_t>(b) * seq * dim + c;
  for (int i0 = 0; i0 < seq; i0 += kUnroll) {
    float xr[kUnroll][V], xi[kUnroll][V], mr[kUnroll][V], mi[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u;
      if (i < seq) {
        const int t = descending ? seq - 1 - i : i;
        const int64_t off = base + static_cast<int64_t>(t) * dim;
        Access<T, V>::load(s.xr + off, xr[u]);
        Access<T, V>::load(s.xi + off, xi[u]);
        Access<T, V>::load(s.ar + off, mr[u]);
        Access<T, V>::load(s.ai + off, mi[u]);
        if (kBackprop) {
#pragma unroll
          for (int v = 0; v < V; ++v) mi[u][v] = -mi[u][v];  // conj(a)
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u;
      if (i < seq) {
        const int64_t off =
            base + static_cast<int64_t>(descending ? seq - 1 - i : i) * dim;
        if (kBackprop) {
          // premultiply: emit h + g, then multiply the carry by conj(a).
#pragma unroll
          for (int v = 0; v < V; ++v) {
            hr[v] = __fadd_rn(hr[v], xr[u][v]);
            hi[v] = __fadd_rn(hi[v], xi[u][v]);
          }
          Access<T, V>::store(s.yr + off, hr);
          Access<T, V>::store(s.yi + off, hi);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float nr = __fsub_rn(__fmul_rn(hr[v], mr[u][v]),
                                       __fmul_rn(hi[v], mi[u][v]));
            const float ni = __fadd_rn(__fmul_rn(hr[v], mi[u][v]),
                                       __fmul_rn(hi[v], mr[u][v]));
            hr[v] = nr;
            hi[v] = ni;
          }
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float nr = __fadd_rn(__fsub_rn(__fmul_rn(mr[u][v], hr[v]),
                                                 __fmul_rn(mi[u][v], hi[v])),
                                       xr[u][v]);
            const float ni = __fadd_rn(__fadd_rn(__fmul_rn(mr[u][v], hi[v]),
                                                 __fmul_rn(mi[u][v], hr[v])),
                                       xi[u][v]);
            hr[v] = nr;
            hi[v] = ni;
          }
          Access<T, V>::store(s.yr + off, hr);
          Access<T, V>::store(s.yi + off, hi);
        }
        if (kAProd) {
          // p = p * m, rounded as the Pallas body's pr*mr - pi*mi and
          // pr*mi + pi*mr.
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float nr = __fsub_rn(__fmul_rn(pr[v], mr[u][v]),
                                       __fmul_rn(pi[v], mi[u][v]));
            const float ni = __fadd_rn(__fmul_rn(pr[v], mi[u][v]),
                                       __fmul_rn(pi[v], mr[u][v]));
            pr[v] = nr;
            pi[v] = ni;
          }
          Access<T, V>::store(s.pr + off, pr);
          Access<T, V>::store(s.pi + off, pi);
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    s.hlr[state + v] = hr[v];
    s.hli[state + v] = hi[v];
    if (kAProd) {
      s.plr[state + v] = pr[v];
      s.pli[state + v] = pi[v];
    }
  }
}

template <typename T, int V, bool kBackprop, bool kAProd>
cudaError_t launch_thread_walk(const Streams<T>& s, int batch, int seq,
                               int dim, int reverse, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(batch) * (dim / V);
  if (threads == 0) return cudaSuccess;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  thread_walk_kernel<T, V, kBackprop, kAProd>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          s, batch, seq, dim, reverse);
  return cudaGetLastError();
}

template <typename T>
Streams<T> streams(const void* xr, const void* xi, const void* ar,
                   const void* ai, const void* h0r, const void* h0i, void* yr,
                   void* yi, void* hlr, void* hli, void* pr, void* pi,
                   void* plr, void* pli) {
  return Streams<T>{
      static_cast<const T*>(xr),    static_cast<const T*>(xi),
      static_cast<const T*>(ar),    static_cast<const T*>(ai),
      static_cast<const float*>(h0r), static_cast<const float*>(h0i),
      static_cast<T*>(yr),          static_cast<T*>(yi),
      static_cast<float*>(hlr),     static_cast<float*>(hli),
      static_cast<T*>(pr),          static_cast<T*>(pi),
      static_cast<float*>(plr),     static_cast<float*>(pli)};
}

template <typename T, bool kBackprop, bool kAProd>
int dispatch_type(const Streams<T>& s, int batch, int seq, int dim,
                  int reverse, cudaStream_t stream) {
  if (batch == 0 || dim == 0) return cudaSuccess;
  if (lru_ring::takes_ring(seq, dim, sizeof(T), s.xr, s.xi, s.ar, s.ai, s.yr,
                           s.yi, s.pr, s.pi)) {
    const void* loads[4] = {s.xr, s.xi, s.ar, s.ai};
    void* stores[4] = {s.yr, s.yi, s.pr, s.pi};
    const lru_ring::Carries carries{
        {s.h0r, s.h0i}, {s.hlr, s.hli}, {s.plr, s.pli}};
    return lru_ring::launch<ComplexWalk<T, 32, kBackprop, kAProd>,
                            ComplexWalk<T, 16, kBackprop, kAProd>>(
        loads, stores, carries, batch, seq, dim, (reverse != 0) != kBackprop,
        stream);
  }
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (paired_bf16(dim, s.xr, s.xi, s.ar, s.ai, s.yr, s.yi, s.pr, s.pi)) {
      return launch_thread_walk<T, 2, kBackprop, kAProd>(s, batch, seq, dim,
                                                         reverse, stream);
    }
  }
  return launch_thread_walk<T, 1, kBackprop, kAProd>(s, batch, seq, dim,
                                                     reverse, stream);
}

template <bool kBackprop, bool kAProd>
int dispatch(const void* xr, const void* xi, const void* ar, const void* ai,
             const void* h0r, const void* h0i, void* yr, void* yi, void* hlr,
             void* hli, void* pr, void* pi, void* plr, void* pli, int batch,
             int seq, int dim, int dtype, int reverse, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_type<float, kBackprop, kAProd>(
        streams<float>(xr, xi, ar, ai, h0r, h0i, yr, yi, hlr, hli, pr, pi,
                       plr, pli),
        batch, seq, dim, reverse, cs);
  }
  if (dtype == 1) {
    return dispatch_type<__nv_bfloat16, kBackprop, kAProd>(
        streams<__nv_bfloat16>(xr, xi, ar, ai, h0r, h0i, yr, yi, hlr, hli, pr,
                               pi, plr, pli),
        batch, seq, dim, reverse, cs);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the components' type). h0r/h0i may be
// null (zero initial state). Returns the cudaError_t of the launch.
extern "C" int cg_lru_scan_complex_forward(
    const void* xr, const void* xi, const void* ar, const void* ai,
    const void* h0r, const void* h0i, void* yr, void* yi, void* hlr,
    void* hli, int batch, int seq, int dim, int dtype, int reverse,
    void* stream) {
  return dispatch<false, false>(xr, xi, ar, ai, h0r, h0i, yr, yi, hlr, hli,
                                nullptr, nullptr, nullptr, nullptr, batch, seq,
                                dim, dtype, reverse, stream);
}

// The cotangent scan of a forward run with the same `reverse` and decay a:
// g is the cotangent of y, dh_last (may be null: zeros) that of h_last;
// multiplies by conj(a); writes dx in g's type and dh0 in fp32.
extern "C" int cg_lru_scan_complex_backward(
    const void* gr, const void* gi, const void* ar, const void* ai,
    const void* dhr, const void* dhi, void* dxr, void* dxi, void* dh0r,
    void* dh0i, int batch, int seq, int dim, int dtype, int reverse,
    void* stream) {
  return dispatch<true, false>(gr, gi, ar, ai, dhr, dhi, dxr, dxi, dh0r, dh0i,
                               nullptr, nullptr, nullptr, nullptr, batch, seq,
                               dim, dtype, reverse, stream);
}

// cg_lru_scan_complex_forward that also writes the running product of `a`
// in the walk's order: (pr, pi) in x's type, (plr, pli) in fp32.
extern "C" int cg_lru_scan_complex_forward_a_prod(
    const void* xr, const void* xi, const void* ar, const void* ai,
    const void* h0r, const void* h0i, void* yr, void* yi, void* hlr,
    void* hli, void* pr, void* pi, void* plr, void* pli, int batch, int seq,
    int dim, int dtype, int reverse, void* stream) {
  return dispatch<false, true>(xr, xi, ar, ai, h0r, h0i, yr, yi, hlr, hli, pr,
                               pi, plr, pli, batch, seq, dim, dtype, reverse,
                               stream);
}

// cg_lru_scan_complex_backward that also writes the running product of
// conj(a) in its walk's order (against the forward's).
extern "C" int cg_lru_scan_complex_backward_a_prod(
    const void* gr, const void* gi, const void* ar, const void* ai,
    const void* dhr, const void* dhi, void* dxr, void* dxi, void* dh0r,
    void* dh0i, void* pr, void* pi, void* plr, void* pli, int batch, int seq,
    int dim, int dtype, int reverse, void* stream) {
  return dispatch<true, true>(gr, gi, ar, ai, dhr, dhi, dxr, dxi, dh0r, dh0i,
                              pr, pi, plr, pli, batch, seq, dim, dtype,
                              reverse, stream);
}

// The TMA ring kernel's resources (its ascending walk) for the entry point
// named by `backprop` and `a_prod`, at dtype (0 float32, 1 bfloat16) and C =
// `channels` (16 or 32): info = {registers a thread at launch, local
// (spilled) bytes a thread, dynamic shared memory bytes a block, threads a
// block}.
extern "C" int cg_lru_scan_complex_attributes(int backprop, int a_prod,
                                              int dtype, int channels,
                                              int* info) {
  return lru_ring::walk_attributes<ComplexWalk>(backprop, a_prod, dtype,
                                                channels, info);
}
