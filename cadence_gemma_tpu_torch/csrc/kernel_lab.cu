// The RG-LRU kernel lab's two forward-scan variants, h_t = a_t * h_{t-1} +
// x_t over [batch, seq, dim] inputs (bf16 or fp32) with an fp32 carry from
// h0, outputs in the input type and the final carry in fp32. Timing
// variants for the scan's redesign, run by
// cadence_gemma_tpu_torch/benchmarks/kernel_lab.py; no library path
// launches them.
//
//   A (cg_lab_unrolled): replaces benchmarks/kernel_lab.py::kernel_unrolled
//     (its pallas_call at :74): a sequential scan over `st`-step time tiles
//     with the carry kept between tiles. Each block owns `dw` channels of
//     one batch row; it stages the [st, dw] tiles of x and a into shared
//     memory with coalesced loads (neighbouring threads, neighbouring
//     channels), then each thread walks its channel through the tile with
//     the carry in a register. Multiply and add are rounded apart
//     (__fmul_rn, __fadd_rn): bit for bit the plain sequential loop.
//
//   B (cg_lab_logscan): replaces benchmarks/kernel_lab.py::kernel_logscan
//     (its pallas_call at :128): a Hillis-Steele log-scan of an (st, dl)
//     tile with time on the tile's rows. Each block owns `dl` channels
//     (batch 1, as the lab asserts) and walks the time tiles in order. A
//     tile of (h, p) = (x, a) in fp32 goes through log2(st) rounds
//     h_r += p_r * h_{r-k}, p_r *= p_{r-k} for rows r >= k, each round
//     reading one shared-memory buffer and writing the other (double
//     buffering keeps a round's reads apart from its writes); then
//     h += p * carry, with the carry the previous tile's last row (h0 for
//     the first). The association differs from the sequential scan's, so
//     it is not bit-exact with it; it is with its own plain version, which
//     rounds the same operations in the same order.
//
// What bounds them: device memory in principle (each element of x and a
// read once, y written once, 2 flops a step for A, ~2 log2(st) for B), far
// below the ~295 flops per byte where an H100 stops being memory-bound. In
// practice the number of blocks in flight: A has batch * dim / dw blocks of
// dw threads, B dim / dl blocks of 1024 threads, and each walks its time
// tiles one after the other.
//
// The TPU lab's tiles are VMEM sizes (B up to 256 x 2560 of fp32 h and p,
// 5.2 MB); here a tile must fit the 227 KB a block may use: A takes
// 2 * st * dw * sizeof(T) bytes, B 16 * st * dl + 4 * dl bytes
// (double-buffered fp32 h and p, and the carry).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Variant A. blockDim.x == dw; grid (dim / dw, batch).
template <typename T>
__global__ void lab_unrolled_kernel(const T* __restrict__ x,
                                    const T* __restrict__ a,
                                    const float* __restrict__ h0,
                                    T* __restrict__ y,
                                    float* __restrict__ h_last, int seq,
                                    int dim, int st) {
  extern __shared__ unsigned char smem[];
  const int dw = blockDim.x;
  T* xs = reinterpret_cast<T*>(smem);
  T* as = xs + st * dw;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * dw;
  const int c = c0 + threadIdx.x;
  const int64_t row = static_cast<int64_t>(b) * seq * dim;
  float h = h0[static_cast<int64_t>(b) * dim + c];
  for (int t0 = 0; t0 < seq; t0 += st) {
    // Stage the tile: element e is row e / dw, channel e % dw.
    for (int e = threadIdx.x; e < st * dw; e += dw) {
      const int64_t off = row + static_cast<int64_t>(t0 + e / dw) * dim +
                          c0 + e % dw;
      xs[e] = x[off];
      as[e] = a[off];
    }
    __syncthreads();
    for (int r = 0; r < st; ++r) {
      h = __fadd_rn(__fmul_rn(to_float(as[r * dw + threadIdx.x]), h),
                    to_float(xs[r * dw + threadIdx.x]));
      y[row + static_cast<int64_t>(t0 + r) * dim + c] = from_float<T>(h);
    }
    __syncthreads();  // the next tile overwrites xs and as
  }
  h_last[static_cast<int64_t>(b) * dim + c] = h;
}

constexpr int kLogscanThreads = 1024;

// Variant B, batch 1. grid (dim / dl), kLogscanThreads threads.
template <typename T>
__global__ void __launch_bounds__(kLogscanThreads)
    lab_logscan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                       const float* __restrict__ h0, T* __restrict__ y,
                       float* __restrict__ h_last, int seq, int dim, int st,
                       int dl) {
  extern __shared__ float fsmem[];
  const int n = st * dl;
  float* hbuf[2] = {fsmem, fsmem + 2 * n};
  float* pbuf[2] = {fsmem + n, fsmem + 3 * n};
  float* carry = fsmem + 4 * n;
  const int c0 = blockIdx.x * dl;
  for (int e = threadIdx.x; e < dl; e += blockDim.x) carry[e] = h0[c0 + e];

  for (int t0 = 0; t0 < seq; t0 += st) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int64_t off = static_cast<int64_t>(t0 + e / dl) * dim + c0 +
                          e % dl;
      hbuf[0][e] = to_float(x[off]);
      pbuf[0][e] = to_float(a[off]);
    }
    __syncthreads();
    int cur = 0;
    for (int k = 1; k < st; k *= 2) {
      const float* hs = hbuf[cur];
      const float* ps = pbuf[cur];
      float* hd = hbuf[cur ^ 1];
      float* pd = pbuf[cur ^ 1];
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        if (e / dl >= k) {
          const int src = e - k * dl;
          hd[e] = __fadd_rn(hs[e], __fmul_rn(ps[e], hs[src]));
          pd[e] = __fmul_rn(ps[e], ps[src]);
        } else {
          hd[e] = hs[e];
          pd[e] = ps[e];
        }
      }
      cur ^= 1;
      __syncthreads();
    }
    float* h = hbuf[cur];
    const float* p = pbuf[cur];
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const float v = __fadd_rn(h[e], __fmul_rn(p[e], carry[e % dl]));
      h[e] = v;
      y[static_cast<int64_t>(t0 + e / dl) * dim + c0 + e % dl] =
          from_float<T>(v);
    }
    __syncthreads();  // every thread has read the old carry
    for (int e = threadIdx.x; e < dl; e += blockDim.x) {
      carry[e] = h[(st - 1) * dl + e];
    }
    __syncthreads();  // the carry is written before the next tile reads it
  }
  for (int e = threadIdx.x; e < dl; e += blockDim.x) h_last[c0 + e] = carry[e];
}

template <typename T>
int unrolled(const void* x, const void* a, const void* h0, void* y,
             void* h_last, int batch, int seq, int dim, int st, int dw,
             cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(st) * dw * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      lab_unrolled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lab_unrolled_kernel<T><<<dim3(dim / dw, batch), dw, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_last), seq, dim, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int logscan(const void* x, const void* a, const void* h0, void* y,
            void* h_last, int seq, int dim, int st, int dl,
            cudaStream_t stream) {
  const size_t smem = (4 * static_cast<size_t>(st) * dl + dl) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lab_logscan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lab_logscan_kernel<T><<<dim / dl, kLogscanThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_last), seq, dim, st, dl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. seq % st == 0 and dim % dw == 0 (the
// wrapper checks); dw threads a block. Returns the cudaError_t.
extern "C" int cg_lab_unrolled(const void* x, const void* a, const void* h0,
                               void* y, void* h_last, int batch, int seq,
                               int dim, int dtype, int st, int dw,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return unrolled<float>(x, a, h0, y, h_last, batch, seq, dim, st, dw, s);
  }
  if (dtype == 1) {
    return unrolled<__nv_bfloat16>(x, a, h0, y, h_last, batch, seq, dim, st,
                                   dw, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Batch 1; seq % st == 0 and dim % dl == 0 (the wrapper checks).
// Returns the cudaError_t.
extern "C" int cg_lab_logscan(const void* x, const void* a, const void* h0,
                              void* y, void* h_last, int seq, int dim,
                              int dtype, int st, int dl, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return logscan<float>(x, a, h0, y, h_last, seq, dim, st, dl, s);
  if (dtype == 1) {
    return logscan<__nv_bfloat16>(x, a, h0, y, h_last, seq, dim, st, dl, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
