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
// Design: the TPU kernel's sequential grid axis over time tiles, whose HBM
// DMAs Mosaic double-buffers while the carry walks in VMEM, becomes a TMA
// ring here (ring_kernel):
//
// - Grid. A block owns C adjacent channels of one batch row and walks that
//   row's whole time axis in tiles of st = 128 steps. C = 32 when
//   batch * ceil(dim / 32) blocks cover the card's SMs, else C = 16: the 2B's
//   [2, t, 2560] and [1, t, 2560] both give 160 blocks for 132 SMs. C is
//   derived from the launch's shape, not an option.
// - Ring. One producer thread (warp 1) loads [1, st, C] boxes of x (or g) and
//   a by TMA into S stages of shared memory, S * C = 192 (6 stages at C = 32,
//   12 at C = 16: 96 KB a block in bf16, 192 KB in fp32), behind full/empty
//   mbarriers. Descending walks (the cotangent walk, or `reverse`) take the
//   tiles from the high end. The tiles sit on multiples of st, so only the
//   top tile can be partial; TMA fills its missing steps (and channels past
//   dim) with zeros, and the walk skips those steps.
// - Walk. Warp 0 holds one consumer thread per channel with the fp32 carry
//   (and the product's) in registers. It walks a tile from shared memory in
//   the plain loops' exact operations and order (below), in chunks of 16
//   steps whose operands the chunk before loaded (walk_tile). A warp reads
//   one 32- or 64-byte row a step: no bank conflicts.
// - Outputs. Each step's y (dx) overwrites its x (g) in the stage, and
//   a_prod its a; one TMA store a tile writes them back (TMA drops what lies
//   past seq or dim), and the stage goes back to the producer once that store
//   has read it, kLag = 2 tiles later. h_last and a_prod_last are written at
//   the end.
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

#include "hopper.cuh"
#include "lru_access.cuh"

namespace {

// ------------------------------------------------------- the TMA ring route

constexpr int kSteps = 128;      // st: time steps a tile
constexpr int kChunk = 16;       // steps of operands loaded a chunk ahead
constexpr int kLag = 2;          // tiles a stage is held after its walk
constexpr int kRingThreads = 64; // warp 0 consumers, warp 1 the producer
constexpr int kMaxDevices = 64;

template <typename T, int C>
struct Ring {
  static constexpr int kStages = 192 / C;
  static_assert(kStages > kLag, "a stage is released kLag tiles late");
  static constexpr int kTileBytes = kSteps * C * static_cast<int>(sizeof(T));
  static constexpr int kBars = kStages * 2 * kTileBytes;
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

// One tile of one channel. x_col and a_col are the shared addresses of this
// thread's column of the stage's x (g) and a tiles (a row every C
// elements); only rows r < rows exist when kPartial. Writes y (dx) over x
// and a_prod over a. The walk runs in chunks of kChunk steps, a loop that is
// not unrolled: each chunk's operands were loaded by the iteration before
// and are widened to fp32 only after the back-edge, so no instruction waits
// on a load that was just issued (a warp issues in order); what remains on
// the critical path is the carry's multiply and add.
template <typename T, int C, bool kBackprop, bool kAProd, bool kDescending,
          bool kPartial>
__device__ __forceinline__ void walk_tile(uint32_t x_col, uint32_t a_col,
                                          int rows, float& h, float& p) {
  using S = Smem<T>;
  // The walk's step s of a chunk based at address b: b + s * kStep.
  constexpr int kStep = (kDescending ? -1 : 1) * C * static_cast<int>(sizeof(T));
  const int first = kDescending ? kSteps - 1 : 0;
  uint32_t xb = x_col + first * C * sizeof(T);
  uint32_t ab = a_col + first * C * sizeof(T);
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
        // The TPU kernel's p = p * a_t in either mode, rounded alone.
        p = __fmul_rn(p, af[j]);
        S::store(ab + j * kStep, p);
      }
    }
    xb += kChunk * kStep;
    ab += kChunk * kStep;
  }
}

// kBackprop = false: the forward scan; true: its cotangent scan. The walk
// runs from the high end of the time axis when kDescending (reverse != 0
// for the forward, reverse == 0 for the cotangent walk). tm_p is read only
// when kAProd.
template <typename T, int C, bool kBackprop, bool kAProd, bool kDescending>
__global__ void __launch_bounds__(kRingThreads)
    ring_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_y,
                const __grid_constant__ CUtensorMap tm_p,
                const float* __restrict__ h0, float* __restrict__ h_last,
                float* __restrict__ a_prod_last, int seq, int dim) {
  using R = Ring<T, C>;
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
      // The consumers release a stage once its tile's store has read it.
      hopper::mbar_wait(&empty[stage], ((i / R::kStages) & 1) ^ 1);
      const int t0 = (kDescending ? tiles - 1 - i : i) * kSteps;
      unsigned char* x_tile = smem + stage * 2 * R::kTileBytes;
      hopper::mbar_expect_tx(&full[stage], 2 * R::kTileBytes);
      hopper::tma_load_3d(x_tile, &tm_x, &full[stage], c0, t0, b);
      hopper::tma_load_3d(x_tile + R::kTileBytes, &tm_a, &full[stage], c0, t0,
                          b);
    }
    return;
  }
  if (lane >= C) return;

  const int c = c0 + lane;
  const int64_t at = static_cast<int64_t>(b) * dim + c;
  float h = h0 != nullptr && c < dim ? h0[at] : 0.f;
  float p = 1.f;
  for (int i = 0; i < tiles; ++i) {
    const int stage = i % R::kStages;
    const int t0 = (kDescending ? tiles - 1 - i : i) * kSteps;
    const int rows = min(kSteps, seq - t0);
    unsigned char* x_tile = smem + stage * 2 * R::kTileBytes;
    unsigned char* a_tile = x_tile + R::kTileBytes;
    const uint32_t x_col = hopper::smem_u32(x_tile) + lane * sizeof(T);
    const uint32_t a_col = x_col + R::kTileBytes;
    hopper::mbar_wait(&full[stage], (i / R::kStages) & 1);
    if (rows == kSteps) {
      walk_tile<T, C, kBackprop, kAProd, kDescending, false>(x_col, a_col,
                                                             rows, h, p);
    } else {
      walk_tile<T, C, kBackprop, kAProd, kDescending, true>(x_col, a_col,
                                                            rows, h, p);
    }
    // Every consumer's writes reach the async proxy before the store reads.
    hopper::fence_proxy_async_shared();
    __syncwarp(R::kMask);
    if (lane == 0) {
      hopper::tma_store_3d(&tm_y, x_tile, c0, t0, b);
      if (kAProd) hopper::tma_store_3d(&tm_p, a_tile, c0, t0, b);
      hopper::bulk_commit();
      if (i >= kLag) {
        // The store kLag tiles back has read its stage: hand it back.
        hopper::bulk_wait_read<kLag>();
        hopper::mbar_arrive(&empty[(i - kLag) % R::kStages]);
      }
    }
  }
  if (lane == 0) hopper::bulk_wait<0>();
  if (c < dim) {
    h_last[at] = h;
    if (kAProd) a_prod_last[at] = p;
  }
}

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
cudaError_t sm_count(int* sms) {
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
template <typename T, int C, bool kBackprop, bool kAProd, bool kDescending>
cudaError_t prepare_ring() {
  static bool ready[kMaxDevices] = {};
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < kMaxDevices && ready[device])) {
    return err;
  }
  err = cudaFuncSetAttribute(ring_kernel<T, C, kBackprop, kAProd, kDescending>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Ring<T, C>::kBytes);
  if (err == cudaSuccess && device < kMaxDevices) ready[device] = true;
  return err;
}

template <typename T, int C, bool kBackprop, bool kAProd, bool kDescending>
cudaError_t launch_ring_in(const CUtensorMap* maps, const void* h0,
                           void* h_last, void* a_prod_last, int batch, int seq,
                           int dim, cudaStream_t stream) {
  cudaError_t err = prepare_ring<T, C, kBackprop, kAProd, kDescending>();
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(batch) * ((dim + C - 1) / C);
  ring_kernel<T, C, kBackprop, kAProd, kDescending>
      <<<static_cast<unsigned>(blocks), kRingThreads, Ring<T, C>::kBytes,
         stream>>>(maps[0], maps[1], maps[2], maps[3],
                   static_cast<const float*>(h0),
                   static_cast<float*>(h_last),
                   static_cast<float*>(a_prod_last), seq, dim);
  return cudaGetLastError();
}

template <typename T, int C, bool kBackprop, bool kAProd>
cudaError_t launch_ring(const void* x, const void* a, const void* h0, void* y,
                        void* h_last, void* a_prod, void* a_prod_last,
                        int batch, int seq, int dim, bool descending,
                        cudaStream_t stream) {
  // [batch, seq, dim] innermost first; boxes of one row's st x C.
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dim),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {dims[0] * sizeof(T),
                                 dims[0] * dims[1] * sizeof(T)};
  const cuuint32_t box[3] = {C, kSteps, 1};
  const void* bases[4] = {x, a, y, kAProd ? a_prod : y};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = hopper::make_tensor_map(
        &maps[i], bases[i], 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
        kMapType<T>);
    if (err != cudaSuccess) return err;
  }
  return descending
             ? launch_ring_in<T, C, kBackprop, kAProd, true>(
                   maps, h0, h_last, a_prod_last, batch, seq, dim, stream)
             : launch_ring_in<T, C, kBackprop, kAProd, false>(
                   maps, h0, h_last, a_prod_last, batch, seq, dim, stream);
}

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
  if (takes_ring(seq, dim, sizeof(T), x, a, y, a_prod)) {
    int sms;
    cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    const bool descending = (reverse != 0) != kBackprop;
    const bool wide = static_cast<int64_t>(batch) * ((dim + 31) / 32) >= sms;
    return wide ? launch_ring<T, 32, kBackprop, kAProd>(
                      x, a, h0, y, h_last, a_prod, a_prod_last, batch, seq,
                      dim, descending, s)
                : launch_ring<T, 16, kBackprop, kAProd>(
                      x, a, h0, y, h_last, a_prod, a_prod_last, batch, seq,
                      dim, descending, s);
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

template <typename T, int C, bool kBackprop, bool kAProd>
cudaError_t ring_attributes(int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, ring_kernel<T, C, kBackprop, kAProd, false>);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = Ring<T, C>::kBytes;
  info[3] = kRingThreads;
  return cudaSuccess;
}

template <bool kBackprop, bool kAProd>
int attributes_of(int dtype, int channels, int* info) {
  if (dtype == 0 && channels == 32) {
    return ring_attributes<float, 32, kBackprop, kAProd>(info);
  }
  if (dtype == 0 && channels == 16) {
    return ring_attributes<float, 16, kBackprop, kAProd>(info);
  }
  if (dtype == 1 && channels == 32) {
    return ring_attributes<__nv_bfloat16, 32, kBackprop, kAProd>(info);
  }
  if (dtype == 1 && channels == 16) {
    return ring_attributes<__nv_bfloat16, 16, kBackprop, kAProd>(info);
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
  if (backprop) {
    return a_prod ? attributes_of<true, true>(dtype, channels, info)
                  : attributes_of<true, false>(dtype, channels, info);
  }
  return a_prod ? attributes_of<false, true>(dtype, channels, info)
                : attributes_of<false, false>(dtype, channels, info);
}
