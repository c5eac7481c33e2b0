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
// What bounds it: device memory, as for the real scan. Each step reads four
// components (x, a) and writes two (y), four with the product, with six to
// ten flops in between, far below the ~295 flops per byte where an H100
// stops being memory-bound. The step's latency, a dependent chain of a
// multiply, a subtract and an add on the carry, sets the time at the 2B's
// b * d threads, as for the real scan.
//
// Design: one thread owns one (batch, channel) pair -- two adjacent
// channels for bf16, loaded as one bf16x2 per component -- and keeps the
// carry (hr, hi) and the product's (pr, pi) in registers while it walks the
// time axis. Neighbouring threads own neighbouring channels, so every load
// and store of a warp is one coalesced row segment of one component. The
// TPU kernel's (re, im) lane blocks with their [b, t, d/128, 128] reshape
// and neutral padding become two planar tensors with a ragged last warp.
// Loads of kUnroll steps are issued before their arithmetic so that several
// memory requests are in flight per thread.
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, which nvcc never contracts into a fused multiply-add), in the
// order of the Pallas body and of complex_lib.Complex's product, so the
// kernel reproduces the plain PyTorch loops bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lru_access.cuh"

namespace {

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
    lru_scan_complex_kernel(Streams<T> s, int batch, int seq, int dim,
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
cudaError_t launch(const Streams<T>& s, int batch, int seq, int dim,
                   int reverse, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(batch) * (dim / V);
  if (threads == 0) return cudaSuccess;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  lru_scan_complex_kernel<T, V, kBackprop, kAProd>
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

template <bool kBackprop, bool kAProd>
int dispatch(const void* xr, const void* xi, const void* ar, const void* ai,
             const void* h0r, const void* h0i, void* yr, void* yi, void* hlr,
             void* hli, void* pr, void* pi, void* plr, void* pli, int batch,
             int seq, int dim, int dtype, int reverse, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, 1, kBackprop, kAProd>(
        streams<float>(xr, xi, ar, ai, h0r, h0i, yr, yi, hlr, hli, pr, pi,
                       plr, pli),
        batch, seq, dim, reverse, cs);
  }
  if (dtype == 1) {
    const auto s = streams<__nv_bfloat16>(xr, xi, ar, ai, h0r, h0i, yr, yi,
                                          hlr, hli, pr, pi, plr, pli);
    if (paired_bf16(dim, xr, xi, ar, ai, yr, yi, pr, pi)) {
      return launch<__nv_bfloat16, 2, kBackprop, kAProd>(s, batch, seq, dim,
                                                         reverse, cs);
    }
    return launch<__nv_bfloat16, 1, kBackprop, kAProd>(s, batch, seq, dim,
                                                       reverse, cs);
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
