// Fused residual add + RMSNorm, the epilogue between a residual block's
// temporal mixer and its MLP:
//
//   y      = x + residual                        (the new residual stream)
//   normed = y * rsqrt(mean_f32(y^2) + eps) * (scale + 1)
//
// x, residual, scale, y and normed share one dtype (bf16 or fp32); the sum of
// squares and the gain are fp32, y is rounded to the input dtype before its
// square is taken (as the JAX kernel computes y in the input dtype first).
//
// Replaces the TPU kernel cadence_gemma_tpu/ops/fused_epilogue.py::_kernel,
// reached through fused_add_rmsnorm -> _pallas_add_rmsnorm.
//
// What bounds it: one read of x and residual and one write of y and normed,
// two flops and a few more per element -- bound by memory bytes.
//
// Design: one block per row; each thread moves 16-byte vectors, keeps the
// fp32 values of y in shared memory for the second pass, and the row's sum
// of squares is reduced by warp shuffles and one exchange through shared
// memory. A decode step has two rows, so the launch, not the bytes, sets its
// time there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
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

template <typename T>
__global__ void add_rmsnorm_kernel(const T* __restrict__ x,
                                   const T* __restrict__ residual,
                                   const T* __restrict__ scale,
                                   T* __restrict__ y, T* __restrict__ normed,
                                   int width, float eps) {
  constexpr int kElems = 16 / sizeof(T);  // elements per 16-byte vector
  extern __shared__ float s_y[];           // width fp32 values of y
  __shared__ float s_warp[32];
  const int64_t offset = static_cast<int64_t>(blockIdx.x) * width;
  const int vecs = width / kElems;

  float sum_sq = 0.f;
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    const int64_t at = offset + static_cast<int64_t>(i) * kElems;
    __align__(16) T xv[kElems];
    __align__(16) T rv[kElems];
    *reinterpret_cast<uint4*>(xv) = *reinterpret_cast<const uint4*>(x + at);
    *reinterpret_cast<uint4*>(rv) =
        *reinterpret_cast<const uint4*>(residual + at);
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      xv[e] = from_float<T>(to_float(xv[e]) + to_float(rv[e]));
      const float f = to_float(xv[e]);
      s_y[i * kElems + e] = f;
      sum_sq += f * f;
    }
    *reinterpret_cast<uint4*>(y + at) = *reinterpret_cast<const uint4*>(xv);
  }

  for (int delta = 16; delta > 0; delta /= 2) {
    sum_sq += __shfl_xor_sync(0xffffffff, sum_sq, delta);
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) s_warp[warp] = sum_sq;
  __syncthreads();
  if (warp == 0) {
    float total =
        lane < static_cast<int>(blockDim.x / 32) ? s_warp[lane] : 0.f;
    for (int delta = 16; delta > 0; delta /= 2) {
      total += __shfl_xor_sync(0xffffffff, total, delta);
    }
    if (lane == 0) s_warp[0] = total;
  }
  __syncthreads();
  const float inv_rms = rsqrtf(s_warp[0] / width + eps);

  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    __align__(16) T sv[kElems];
    *reinterpret_cast<uint4*>(sv) =
        *reinterpret_cast<const uint4*>(scale + i * kElems);
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      sv[e] = from_float<T>(s_y[i * kElems + e] * inv_rms *
                            (to_float(sv[e]) + 1.f));
    }
    *reinterpret_cast<uint4*>(normed + offset +
                              static_cast<int64_t>(i) * kElems) =
        *reinterpret_cast<const uint4*>(sv);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* residual, const void* scale,
                   void* y, void* normed, int rows, int width, float eps,
                   cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  constexpr int kElems = 16 / sizeof(T);
  if (width <= 0 || width % kElems) return cudaErrorInvalidValue;
  const int vecs = width / kElems;
  const int threads = std::min(1024, std::max(32, (vecs + 31) / 32 * 32));
  const size_t smem = sizeof(float) * static_cast<size_t>(width);
  if (smem > 48 * 1024) {  // above the default limit only when needed
    cudaError_t err = cudaFuncSetAttribute(
        add_rmsnorm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  add_rmsnorm_kernel<T><<<rows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(residual),
      static_cast<const T*>(scale), static_cast<T*>(y), static_cast<T*>(normed),
      width, eps);
  return cudaGetLastError();
}

}  // namespace

// x, residual, y, normed: [rows, width] contiguous; scale: [width]; all of one
// dtype (dtype_code 0: fp32, 1: bf16) and 16-byte aligned; width a multiple
// of 16 bytes. Returns the cudaError_t of the launch (0 on success).
extern "C" int cg_add_rmsnorm(const void* x, const void* residual,
                              const void* scale, void* y, void* normed,
                              int rows, int width, int dtype_code, float eps,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch<float>(x, residual, scale, y, normed, rows, width, eps, s);
    case 1:
      return launch<__nv_bfloat16>(x, residual, scale, y, normed, rows, width,
                                   eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
