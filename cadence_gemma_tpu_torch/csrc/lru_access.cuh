// Loads and stores of the RG-LRU scans (lru_scan.cu, lru_scan_complex.cu):
// V adjacent channels of one time step, converted to and from the fp32 the
// carry is kept in. bf16 channels go in pairs, one bf16x2 access, when the
// width is even and every pointer the kernel touches is 4-byte aligned
// (paired_bf16); otherwise one channel a thread.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {

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

// Whether a bf16 scan of width `dim` may take Access<__nv_bfloat16, 2> over
// the [batch, seq, dim] tensors `ptrs` (null ones, not written, pass).
template <typename... P>
bool paired_bf16(int dim, P... ptrs) {
  return dim % 2 == 0 &&
         ((reinterpret_cast<uintptr_t>(ptrs) % 4 == 0) && ...);
}

}  // namespace
