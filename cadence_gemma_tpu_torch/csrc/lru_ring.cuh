// The TMA ring of the RG-LRU scans: the real scan's four walks
// (lru_scan.cu), the complex scan's four (lru_scan_complex.cu) and the
// kernel lab's variant A (kernel_lab.cu) all run on ring_kernel below, each
// with its own walk of one tile.
//
// The TPU kernel's sequential grid axis over time tiles, whose HBM DMAs
// Mosaic double-buffers while the carry walks in VMEM, becomes a ring of
// shared-memory stages here:
//
// - Grid. A block owns C adjacent channels of one batch row and walks that
//   row's whole time axis in tiles of kSteps steps. C = 32 when
//   batch * ceil(dim / 32) blocks cover the card's SMs, else C = 16 (launch
//   below): the 2B's [2, t, 2560] and [1, t, 2560] both give 160 blocks for
//   132 SMs. C is derived from the launch's shape, not an option.
// - Ring. One producer thread (warp 1) loads the walk's kStreams boxes of
//   [1, kSteps, C] (x and a for the real scan; x.real, x.imag, a.real and
//   a.imag for the complex one) by TMA into one stage, behind one expect_tx
//   on the stage's full mbarrier. The stages of a block hold kElements
//   elements whatever the walk (96 KB in bf16, 192 KB in fp32), so two bf16
//   blocks share an SM: 6 stages of a real walk at C = 32 and 128 steps, 12
//   at C = 16; 6 of a complex walk at C = 32 and 64 steps. Descending walks
//   take the tiles from the high end. The tiles sit on multiples of kSteps,
//   so only the top tile can be partial; TMA fills its missing steps (and
//   channels past dim) with zeros, and the walk skips those steps.
// - Walk. Warp 0 holds one consumer thread a channel, which keeps the fp32
//   carry in registers and walks each tile from shared memory (W::tile).
//   A warp reads one 32- or 64-byte row of a stream a step: no bank
//   conflicts.
// - Outputs. The walk writes its outputs over the first W::kStores input
//   tiles of the stage (y over x, a_prod over a); one TMA store a stored
//   stream writes them back (TMA drops what lies past seq or dim), and the
//   stage goes back to the producer once those stores have read it, kLag
//   tiles later. The final carries are written at the end (W::finish).
//
// A walk W provides: the element type T; kChannels (C), kSteps, kStreams
// and kStores; a Carry of registers; start(carries, at, valid) and
// finish(carries, at, carry) for the state at index `at` of the [batch,
// dim] carries; and tile<kDescending, kPartial>(col, rows, carry), which
// walks one tile whose stream s has this thread's column at shared address
// col + s * kTileBytes (a row every C elements), of which only rows r <
// rows exist when kPartial. RealWalk, the real scan's, is below;
// lru_scan_complex.cu holds the complex one.
//
// Tensors TMA cannot describe -- a row of dim * sizeof(T) that is not a
// multiple of 16 bytes, a base that is not 16-byte aligned, or an empty
// time axis (takes_ring) -- are left to each caller's other route.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {
namespace lru_ring {

constexpr int kLag = 2;          // tiles a stage is held after its walk
constexpr int kThreads = 64;     // warp 0 consumers, warp 1 the producer
constexpr int kElements = 384 * 128;  // elements in a block's stages
constexpr int kMaxDevices = 64;

template <class W>
struct Ring {
  using T = typename W::T;
  static constexpr int C = W::kChannels;
  static constexpr int kStages = kElements / (W::kStreams * W::kSteps * C);
  static_assert(kStages > kLag, "a stage is released kLag tiles late");
  static constexpr int kTileBytes = W::kSteps * C * static_cast<int>(sizeof(T));
  static constexpr int kStageBytes = W::kStreams * kTileBytes;
  static constexpr int kBars = kStages * kStageBytes;
  // + 128: the dynamic shared memory base is aligned up to 128 bytes.
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 128;
  static constexpr unsigned kMask = C == 32 ? 0xffffffffu : (1u << C) - 1u;
};

// Shared-memory accesses of one element at a 32-bit shared address, as
// inline PTX (LDS and STS: the compiler did not infer the tile's address
// space and issued generic accesses). A bf16 load keeps its raw bits; to_f32
// widens them where the walk needs the value.
template <typename T>
struct Smem;

template <>
struct Smem<float> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(uint32_t addr) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
    return v;
  }
  static __device__ __forceinline__ float to_f32(Raw v) { return v; }
  static __device__ __forceinline__ void store(uint32_t addr, float v) {
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
  }
};

template <>
struct Smem<__nv_bfloat16> {
  using Raw = uint32_t;
  static __device__ __forceinline__ Raw load(uint32_t addr) {
    unsigned short v;
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
    return v;
  }
  static __device__ __forceinline__ float to_f32(Raw v) {
    return __uint_as_float(v << 16);
  }
  static __device__ __forceinline__ void store(uint32_t addr, float v) {
    const __nv_bfloat16 b = __float2bfloat16_rn(v);
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr),
                 "h"(*reinterpret_cast<const unsigned short*>(&b))
                 : "memory");
  }
};

// The fp32 states at the walk's two ends, one pointer a component (the
// second unused by a real walk): the initial carry (null: zeros), the final
// carry, and the running product's final value (unused without it).
struct Carries {
  const float* h0[2];
  float* h_last[2];
  float* a_prod_last[2];
};

// The real scan's walk: streams x (or g) and a; y (dx) over x and a_prod
// over a. kBackprop = false: the forward scan h = a * h + x, y = h;
// true: its cotangent scan h += g, dx = h, h *= a. kAProd: also the running
// product p = p * a (the TPU kernel's, rounded alone in either mode).
template <typename Elem, int kC, int kTileSteps, bool kBackprop, bool kAProd>
struct RealWalk {
  using T = Elem;
  static constexpr int kChannels = kC;
  static constexpr int kSteps = kTileSteps;
  static constexpr int kStreams = 2;
  static constexpr int kStores = kAProd ? 2 : 1;
  static constexpr int kChunk = 16;  // steps of operands loaded a chunk ahead
  static_assert(kSteps % kChunk == 0, "a tile is whole chunks");
  static constexpr int kTileBytes = kSteps * kC * static_cast<int>(sizeof(T));

  struct Carry {
    float h;
    float p;
  };

  static __device__ __forceinline__ Carry start(const Carries& c, int64_t at,
                                                bool valid) {
    return {c.h0[0] != nullptr && valid ? c.h0[0][at] : 0.f, 1.f};
  }

  static __device__ __forceinline__ void finish(const Carries& c, int64_t at,
                                                const Carry& carry) {
    c.h_last[0][at] = carry.h;
    if (kAProd) c.a_prod_last[0][at] = carry.p;
  }

  // The walk runs in chunks of kChunk steps, a loop that is not unrolled:
  // each chunk's operands were loaded by the iteration before and are
  // widened to fp32 only after the back-edge, so no instruction waits on a
  // load that was just issued (a warp issues in order); what remains on the
  // critical path is the carry's multiply and add.
  template <bool kDescending, bool kPartial>
  static __device__ __forceinline__ void tile(uint32_t col, int rows,
                                              Carry& carry) {
    using S = Smem<T>;
    // The walk's step s of a chunk based at address b: b + s * kStep.
    constexpr int kStep =
        (kDescending ? -1 : 1) * kC * static_cast<int>(sizeof(T));
    const int first = kDescending ? kSteps - 1 : 0;
    uint32_t xb = col + first * kC * sizeof(T);
    uint32_t ab = col + kTileBytes + first * kC * sizeof(T);
    float h = carry.h;
    float p = carry.p;
    typename S::Raw xr[kChunk];
    typename S::Raw ar[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      xr[j] = S::load(xb + j * kStep);
      ar[j] = S::load(ab + j * kStep);
    }
#pragma unroll 1
    for (int s0 = 0; s0 < kSteps; s0 += kChunk) {
      float xf[kChunk];
      float af[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        xf[j] = S::to_f32(xr[j]);
        af[j] = S::to_f32(ar[j]);
      }
      if (s0 + kChunk < kSteps) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          xr[j] = S::load(xb + (kChunk + j) * kStep);
          ar[j] = S::load(ab + (kChunk + j) * kStep);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (kPartial) {
          const int s = s0 + j;
          if ((kDescending ? kSteps - 1 - s : s) >= rows) continue;
        }
        float out;
        if (kBackprop) {
          h = __fadd_rn(h, xf[j]);
          out = h;
          h = __fmul_rn(h, af[j]);
        } else {
          h = __fadd_rn(__fmul_rn(af[j], h), xf[j]);
          out = h;
        }
        S::store(xb + j * kStep, out);
        if (kAProd) {
          p = __fmul_rn(p, af[j]);
          S::store(ab + j * kStep, p);
        }
      }
      xb += kChunk * kStep;
      ab += kChunk * kStep;
    }
    carry.h = h;
    carry.p = p;
  }
};

// The tensor maps of a launch: one a loaded stream, one a stored one.
template <int kLoads, int kStores>
struct Maps {
  CUtensorMap load[kLoads];
  CUtensorMap store[kStores];
};

// One block walks C channels of one batch row over the whole time axis,
// from the high end when kDescending.
template <class W, bool kDescending>
__global__ void __launch_bounds__(kThreads)
    ring_kernel(const __grid_constant__ Maps<W::kStreams, W::kStores> maps,
                const Carries carries, int seq, int dim) {
  using R = Ring<W>;
  using T = typename W::T;
  constexpr int C = W::kChannels;
  constexpr int kSteps = W::kSteps;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t{127});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kBars);
  uint64_t* empty = full + R::kStages;
  const int column_blocks = (dim + C - 1) / C;
  const int b = blockIdx.x / column_blocks;
  const int c0 = (blockIdx.x % column_blocks) * C;
  const int tiles = (seq + kSteps - 1) / kSteps;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 32) {  // the producer warp
    if (lane != 0) return;
    for (int i = 0; i < tiles; ++i) {
      const int stage = i % R::kStages;
      // The consumers release a stage once its tile's stores have read it.
      hopper::mbar_wait(&empty[stage], ((i / R::kStages) & 1) ^ 1);
      const int t0 = (kDescending ? tiles - 1 - i : i) * kSteps;
      unsigned char* tile = smem + stage * R::kStageBytes;
      hopper::mbar_expect_tx(&full[stage], R::kStageBytes);
#pragma unroll
      for (int s = 0; s < W::kStreams; ++s) {
        hopper::tma_load_3d(tile + s * R::kTileBytes, &maps.load[s],
                            &full[stage], c0, t0, b);
      }
    }
    return;
  }
  if (lane >= C) return;

  const int c = c0 + lane;
  const int64_t at = static_cast<int64_t>(b) * dim + c;
  typename W::Carry carry = W::start(carries, at, c < dim);
  for (int i = 0; i < tiles; ++i) {
    const int stage = i % R::kStages;
    const int t0 = (kDescending ? tiles - 1 - i : i) * kSteps;
    const int rows = min(kSteps, seq - t0);
    unsigned char* tile = smem + stage * R::kStageBytes;
    const uint32_t col = hopper::smem_u32(tile) + lane * sizeof(T);
    hopper::mbar_wait(&full[stage], (i / R::kStages) & 1);
    if (rows == kSteps) {
      W::template tile<kDescending, false>(col, rows, carry);
    } else {
      W::template tile<kDescending, true>(col, rows, carry);
    }
    // Every consumer's writes reach the async proxy before the stores read.
    hopper::fence_proxy_async_shared();
    __syncwarp(R::kMask);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < W::kStores; ++s) {
        hopper::tma_store_3d(&maps.store[s], tile + s * R::kTileBytes, c0, t0,
                             b);
      }
      hopper::bulk_commit();
      if (i >= kLag) {
        // The stores kLag tiles back have read their stage: hand it back.
        hopper::bulk_wait_read<kLag>();
        hopper::mbar_arrive(&empty[(i - kLag) % R::kStages]);
      }
    }
  }
  if (lane == 0) hopper::bulk_wait<0>();
  if (c < dim) W::finish(carries, at, carry);
}

// ------------------------------------------------------------------ host

template <typename T>
constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
template <>
constexpr CUtensorMapDataType kMapType<__nv_bfloat16> =
    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// Whether TMA can describe the launch's [batch, seq, dim] tensors (null
// ones pass): a non-empty time axis, rows of a multiple of 16 bytes, bases
// 16-byte aligned. ops/lru_scan.py::_takes_ring is its twin.
template <typename... P>
bool takes_ring(int seq, int dim, int elem_bytes, P... ptrs) {
  return seq > 0 && (static_cast<int64_t>(dim) * elem_bytes) % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(ptrs) % 16 == 0) && ...);
}

// The card's SM count, once per device.
inline cudaError_t sm_count(int* sms) {
  static int counts[kMaxDevices] = {};
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && counts[device] > 0) {
    *sms = counts[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < kMaxDevices) counts[device] = *sms;
  return err;
}

// Once per device and kernel: the dynamic shared memory it asks for.
template <class W, bool kDescending>
cudaError_t prepare_ring() {
  static bool ready[kMaxDevices] = {};
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < kMaxDevices && ready[device])) {
    return err;
  }
  err = cudaFuncSetAttribute(ring_kernel<W, kDescending>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Ring<W>::kBytes);
  if (err == cudaSuccess && device < kMaxDevices) ready[device] = true;
  return err;
}

template <class W, bool kDescending>
cudaError_t launch_ring_in(const Maps<W::kStreams, W::kStores>& maps,
                           const Carries& carries, int batch, int seq, int dim,
                           cudaStream_t stream) {
  cudaError_t err = prepare_ring<W, kDescending>();
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      static_cast<int64_t>(batch) * ((dim + W::kChannels - 1) / W::kChannels);
  ring_kernel<W, kDescending>
      <<<static_cast<unsigned>(blocks), kThreads, Ring<W>::kBytes, stream>>>(
          maps, carries, seq, dim);
  return cudaGetLastError();
}

// Walk W over [batch, seq, dim] tensors: `loads` its W::kStreams input
// streams, `stores` its W::kStores outputs (each written over the input of
// its index in the stage).
template <class W>
cudaError_t launch_ring(const void* const* loads, void* const* stores,
                        const Carries& carries, int batch, int seq, int dim,
                        bool descending, cudaStream_t stream) {
  using T = typename W::T;
  // [batch, seq, dim] innermost first; boxes of one row's kSteps x C.
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dim),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {dims[0] * sizeof(T),
                                 dims[0] * dims[1] * sizeof(T)};
  const cuuint32_t box[3] = {W::kChannels, W::kSteps, 1};
  Maps<W::kStreams, W::kStores> maps;
  for (int i = 0; i < W::kStreams + W::kStores; ++i) {
    const bool load = i < W::kStreams;
    const cudaError_t err = hopper::make_tensor_map(
        load ? &maps.load[i] : &maps.store[i - W::kStreams],
        load ? loads[i] : stores[i - W::kStreams], 3, dims, strides, box,
        CU_TENSOR_MAP_SWIZZLE_NONE, kMapType<T>);
    if (err != cudaSuccess) return err;
  }
  return descending ? launch_ring_in<W, true>(maps, carries, batch, seq, dim,
                                              stream)
                    : launch_ring_in<W, false>(maps, carries, batch, seq, dim,
                                               stream);
}

// Launches Wide (C = 32) when batch * ceil(dim / 32) blocks cover the
// card's SMs, else Narrow (C = 16): the same walk at half the width, so
// that a batch-1 row still fills the card.
template <class Wide, class Narrow>
cudaError_t launch(const void* const* loads, void* const* stores,
                   const Carries& carries, int batch, int seq, int dim,
                   bool descending, cudaStream_t stream) {
  static_assert(Wide::kChannels == 32 && Narrow::kChannels == 16,
                "a wide and a narrow walk");
  int sms;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const bool wide = static_cast<int64_t>(batch) * ((dim + 31) / 32) >= sms;
  return wide ? launch_ring<Wide>(loads, stores, carries, batch, seq, dim,
                                  descending, stream)
              : launch_ring<Narrow>(loads, stores, carries, batch, seq, dim,
                                    descending, stream);
}

// The resources of walk W's ring kernel (its ascending walk): info =
// {registers a thread at launch, local (spilled) bytes a thread, dynamic
// shared memory bytes a block, threads a block}.
template <class W>
cudaError_t ring_attributes(int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, ring_kernel<W, false>);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = Ring<W>::kBytes;
  info[3] = kThreads;
  return cudaSuccess;
}

template <template <typename, int, bool, bool> class Walk, bool kBackprop,
          bool kAProd>
cudaError_t attributes_of(int dtype, int channels, int* info) {
  const bool wide = channels == 32;
  if (channels != 16 && !wide) return cudaErrorInvalidValue;
  if (dtype == 0) {
    return wide ? ring_attributes<Walk<float, 32, kBackprop, kAProd>>(info)
                : ring_attributes<Walk<float, 16, kBackprop, kAProd>>(info);
  }
  if (dtype == 1) {
    return wide
               ? ring_attributes<Walk<__nv_bfloat16, 32, kBackprop, kAProd>>(
                     info)
               : ring_attributes<Walk<__nv_bfloat16, 16, kBackprop, kAProd>>(
                     info);
  }
  return cudaErrorInvalidValue;
}

// ring_attributes of a scan's walk Walk<T, C, kBackprop, kAProd> for the
// entry point named by `backprop` and `a_prod`, at dtype (0 float32, 1
// bfloat16) and C = `channels` (16 or 32).
template <template <typename, int, bool, bool> class Walk>
cudaError_t walk_attributes(int backprop, int a_prod, int dtype,
                            int channels, int* info) {
  if (backprop) {
    return a_prod ? attributes_of<Walk, true, true>(dtype, channels, info)
                  : attributes_of<Walk, true, false>(dtype, channels, info);
  }
  return a_prod ? attributes_of<Walk, false, true>(dtype, channels, info)
                : attributes_of<Walk, false, false>(dtype, channels, info);
}

}  // namespace lru_ring
}  // namespace
