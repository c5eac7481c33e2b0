// The RG-LRU kernel lab's two forward-scan variants, h_t = a_t * h_{t-1} +
// x_t over [batch, seq, dim] inputs (bf16 or fp32) with an fp32 carry from
// h0, outputs in the input type and the final carry in fp32. Timing
// variants for the scan's redesign, run by
// cadence_gemma_tpu_torch/benchmarks/kernel_lab.py; no library path
// launches them.
//
//   A (cg_lab_unrolled): replaces benchmarks/kernel_lab.py::kernel_unrolled
//     (its pallas_call at :74): a sequential scan over `st`-step time tiles
//     with the carry kept between tiles. It is the real forward walk of the
//     scans' TMA ring (lru_ring.cuh: ring_kernel with RealWalk), instanced
//     at st = 64, 128 and 256, the JAX lab's values: a block owns C = 32
//     channels of one row (16 when the blocks would not cover the SMs), a
//     producer thread streams [1, st, C] boxes of x and a into the ring's
//     stages, one thread a channel walks each tile with the carry in a
//     register and y leaves by TMA store. At st = 128 it is the code of the
//     library's forward scan (lru_scan.cu). Multiply and add are rounded
//     apart (__fmul_rn, __fadd_rn): bit for bit the plain sequential loop.
//
//   B (cg_lab_logscan): replaces benchmarks/kernel_lab.py::kernel_logscan
//     (its pallas_call at :128): a Hillis-Steele log-scan of st-step tiles
//     with time on the tile's rows, batch 1, as the lab asserts. Per tile
//     and channel, (h, p) = (x, a) in fp32 go through log2(st) rounds
//     h_r += p_r * h_{r-k}, p_r *= p_{r-k} for rows r >= k (k = 1, 2, ...
//     st / 2), both read from the round before; then h += p * carry, the
//     carry being the previous tile's last row after its own fix-up (h0
//     for the first). Its association differs from the sequential scan's,
//     so it is not bit-exact with that; it is with its own plain version,
//     which rounds the same operations (a product, then a sum, each rounded
//     alone) in the same graph. The JAX lab's dl only tiled its grid's
//     channels, which are independent: the kernel takes its own.
//
// What bounds them: device memory in principle (each element of x and a
// read once, y written once, 2 flops a step for A, 3 a live row of each of
// B's log2(st) rounds), far below the ~295 flops per byte where an H100
// stops being memory-bound. In practice A's walk, one dependent step after
// another in each thread; and B's shared-memory pipe and the order of its
// phases: an element takes 10 warp shuffles and ~10 shared-memory accesses
// (the transposing store, the scan's load and store of h and p, the
// output's loads), and a block's load, scan, chain and store follow one
// another behind barriers (PERF.md section 7 has the measured split).
//
// B's design for Hopper (section "Variant B" below): time on the lanes,
// the rounds in registers, the tiles in parallel.
//   - A warp scans one channel's st-step tile: lane l holds rows l + 32 j,
//     j < st / 32, of h and p. Rounds k >= 32 read the same lane's register
//     j - k / 32; rounds k < 32 take register j of lane l - k by a shuffle,
//     or register j - 1 of lane l - k + 32 where l < k. A warp scans two
//     tiles at once (one at st = 512), two independent chains to issue.
//   - An item is C = 16 channels (a 32-byte row segment in bf16) of a
//     group of tiles, 256 rows (one tile at st = 512). A block's 256
//     threads widen its x and a, loaded by 16-byte loads (a warp reads 16
//     whole 32-byte sectors), into a transposed fp32 tile, [C][rows + 2]: a
//     stride of 2 (mod 32) words keeps the transposing stores, the warps'
//     column reads and the output's reads free of bank conflicts. Its 8
//     warps scan the item's C x G (channel, tile) pairs and write (h, p)
//     back; 16 threads chain the carries through the G tiles in order; the
//     block writes y = h + p * carry row by row, packed to 16 bytes.
//   - Time is parallel: the items of a strip's groups run on any SMs at
//     once (1280 items at [1, 2048, 2560] and st <= 256). Blocks are
//     persistent, as many as are resident, and draw items by an atomic
//     ticket, group-major, so the previous group of an item's strip was
//     drawn, and is held by a running block, before it; while a block
//     scans one item, the loads of its next are in flight in registers.
//     The carry crosses groups by a chained scan: the block awaits the
//     previous group's 16 final carries in a scratch buffer after its
//     rounds, and publishes its own before it writes y. A carry word
//     holds a published flag beside the fp32 bits, one 64-bit store and
//     load, so it needs no fence. The scratch buffer (the ticket counter
//     and the carry words) is zeroed by the caller before each call, on
//     the launch's stream. The chain stays tile by tile: carry_i = h_i +
//     p_i * carry_{i-1} at the tile's last row, the value the plain
//     version computes there.
//
// The TPU lab's tiles are VMEM sizes (B up to 256 x 2560 of fp32 h and p,
// 5.2 MB); here a tile must fit the 227 KB a block may use: A's ring holds
// lru_ring::kElements elements whatever st (96 KB in bf16), so st = 256 at
// C = 32 leaves 3 stages, the least a ring that releases a stage kLag = 2
// tiles late can run on; B holds an item of fp32 h and p, 2 * 16 * (rows +
// 2) * 4 bytes (33 KB at 256 rows, 66 KB at st = 512).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lru_ring.cuh"

namespace {

// ---- Variant B ----------------------------------------------------------

namespace logscan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = 16;    // C: a strip's channels
constexpr int kItemRows = 256;  // an item's rows, or one tile if longer

// An item's shape at tile length kSt: the C channels of a strip over
// kTiles st-step tiles.
template <int kSt>
struct Group {
  static_assert(kSt >= 32 && (kSt & (kSt - 1)) == 0, "st: 32, 64, ...");
  static constexpr int kRegs = kSt / 32;  // rows a lane holds of a tile
  static constexpr int kTiles = kSt >= kItemRows ? 1 : kItemRows / kSt;
  static constexpr int kRows = kTiles * kSt;
  // Pairs a warp scans at once: two up to st = 256, one at 512 (h, p and
  // their shuffled copies are 4 * 16 registers a pair there).
  static constexpr int kAtOnce = kSt >= 512 ? 1 : 2;
  static_assert(kChannels % (kWarps * kAtOnce) == 0, "whole pair rounds");
  // Words between two channels of the transposed tile: 2 (mod 32), so the
  // 16 rows a warp's chunks span fall in distinct banks.
  static constexpr int kStride = kRows + 2;
  // h and p, then the carry into each tile.
  static constexpr int kBytes =
      (2 * kChannels * kStride + kTiles * kChannels) * sizeof(float);
};

// A 16-byte chunk of a row: 8 bf16 or 4 fp32 channels.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void widen(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 narrow(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // Exact: a bf16 is the top half of its fp32.
  static __device__ __forceinline__ void widen(const uint4& v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // Rounded to nearest even, as PyTorch's .to(torch.bfloat16).
  static __device__ __forceinline__ uint4 narrow(const float (&f)[8]) {
    return make_uint4(hopper::pack_bf16(f[0], f[1]),
                      hopper::pack_bf16(f[2], f[3]),
                      hopper::pack_bf16(f[4], f[5]),
                      hopper::pack_bf16(f[6], f[7]));
  }
};

constexpr unsigned kFull = 0xffffffffu;

// The Hillis-Steele rounds of N channels' tiles at once (independent
// chains the scheduler interleaves), lane l holding rows l + 32 j of tile n
// in h[n][j] and p[n][j]. Each round reads the round before's values: a
// shuffled round copies them first, an in-lane round goes from the top
// register down. A product, then a sum, each rounded alone. Templates, not
// loops over k, so every register index is a constant (a loop that ptxas
// left rolled put h and p in local memory).

// Round k = K < 32: row l + 32 j - K is lane l - K's register j, or lane
// l - K + 32's register j - 1 where l < K; rows below K (j = 0, l < K) keep
// their values.
template <int K, int N, int J>
__device__ __forceinline__ void shuffled_round(float (&h)[N][J],
                                               float (&p)[N][J], int lane) {
  float rh[N][J], rp[N][J];
  const int src = (lane - K) & 31;
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      rh[n][j] = __shfl_sync(kFull, h[n][j], src);
      rp[n][j] = __shfl_sync(kFull, p[n][j], src);
    }
  }
  const bool wrap = lane < K;
#pragma unroll
  for (int j = J - 1; j >= 1; --j) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float hs = wrap ? rh[n][j - 1] : rh[n][j];
      const float ps = wrap ? rp[n][j - 1] : rp[n][j];
      h[n][j] = __fadd_rn(h[n][j], __fmul_rn(p[n][j], hs));
      p[n][j] = __fmul_rn(p[n][j], ps);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float h0 = __fadd_rn(h[n][0], __fmul_rn(p[n][0], rh[n][0]));
    const float p0 = __fmul_rn(p[n][0], rp[n][0]);
    h[n][0] = wrap ? h[n][0] : h0;
    p[n][0] = wrap ? p[n][0] : p0;
  }
}

// Rounds k = 32 M, 64 M, ... < 32 J: row l + 32 (j - M) is this lane's
// register j - M.
template <int M, int N, int J>
__device__ __forceinline__ void in_lane_rounds(float (&h)[N][J],
                                               float (&p)[N][J]) {
  if constexpr (M < J) {
#pragma unroll
    for (int j = J - 1; j >= M; --j) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n][j] = __fadd_rn(h[n][j], __fmul_rn(p[n][j], h[n][j - M]));
        p[n][j] = __fmul_rn(p[n][j], p[n][j - M]);
      }
    }
    in_lane_rounds<2 * M>(h, p);
  }
}

template <int N, int J>
__device__ __forceinline__ void rounds(float (&h)[N][J], float (&p)[N][J],
                                       int lane) {
  shuffled_round<1>(h, p, lane);
  shuffled_round<2>(h, p, lane);
  shuffled_round<4>(h, p, lane);
  shuffled_round<8>(h, p, lane);
  shuffled_round<16>(h, p, lane);
  in_lane_rounds<1>(h, p);
}

// A carry word: 1 in the high half once published (the caller zeroes it),
// the fp32 bits in the low. One 64-bit access carries both, so the word
// needs no ordering with any other memory: relaxed at the device's scope
// (through the L2), no fence.
__device__ __forceinline__ void publish(unsigned long long* word,
                                        float carry) {
  const unsigned long long v = (1ull << 32) | __float_as_uint(carry);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(word), "l"(v)
               : "memory");
}

__device__ __forceinline__ float await(const unsigned long long* word) {
  unsigned long long v;
  while (true) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
                 : "=l"(v)
                 : "l"(word)
                 : "memory");
    if (v >> 32) break;
  }
  return __uint_as_float(static_cast<unsigned>(v));
}

// An item: the tiles of group `group` of the strip of C channels `strip`;
// ticket t is item (t / strips, t % strips), group-major.
struct Item {
  int group, strip, tiles, rows, c0;
  int64_t row0;
};

template <int kSt>
__device__ __forceinline__ Item locate(int ticket, int strips, int seq) {
  using G = Group<kSt>;
  Item it;
  it.group = ticket / strips;
  it.strip = ticket % strips;
  it.tiles = min(G::kTiles, seq / kSt - it.group * G::kTiles);
  it.rows = it.tiles * kSt;
  it.c0 = it.strip * kChannels;
  it.row0 = static_cast<int64_t>(it.group) * G::kRows;
  return it;
}

// Persistent blocks of kThreads threads, as many as are resident; see the
// header. A block draws tickets until they run out, and loads the next
// item's x and a into registers while it scans the current one.
template <typename T, int kSt>
__global__ void __launch_bounds__(kThreads)
    lab_logscan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                       const float* __restrict__ h0, T* __restrict__ y,
                       float* __restrict__ h_last, unsigned* ticket,
                       unsigned long long* carries, int seq, int dim) {
  using G = Group<kSt>;
  constexpr int kVec = Chunk<T>::kVec;
  constexpr int kChunks = kChannels / kVec;  // chunks a row
  // A thread's chunk q of the rows r0 + n kRowStep, n < kIters, of an item
  // (those below its `rows`).
  constexpr int kRowStep = kThreads / kChunks;
  constexpr int kIters = G::kRows / kRowStep;
  extern __shared__ float smem[];
  float* const sh = smem;                            // [C][kStride]
  float* const sp = smem + kChannels * G::kStride;   // [C][kStride]
  float* const sc = sp + kChannels * G::kStride;     // [kTiles][C]
  __shared__ int drawn;

  const int strips = dim / kChannels;
  const int items = strips * ((seq / kSt + G::kTiles - 1) / G::kTiles);
  const int q = threadIdx.x % kChunks;
  const int r0 = threadIdx.x / kChunks;
  const int64_t step = static_cast<int64_t>(kRowStep) * dim;
  float* const hq = sh + q * kVec * G::kStride;
  float* const pq = sp + q * kVec * G::kStride;
  const int lane = threadIdx.x % 32;
  // Through a shuffle the compiler sees these warp-uniform, and issues the
  // rounds' shuffles without divergence handling.
  const int warp = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 32, 0);

  // A block draws until it holds a ticket past the items.
  if (threadIdx.x == 0) drawn = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  int item = __shfl_sync(kFull, drawn, 0);
  __syncthreads();  // every warp has read `drawn` before the loop redraws
  uint4 vx[kIters], va[kIters];
  // Issues the loads of chunk q of an item's rows into vx and va.
  auto fetch = [&](int of) {
    if (of >= items) return;
    const Item it = locate<kSt>(of, strips, seq);
    const int64_t first = (it.row0 + r0) * dim + it.c0 + q * kVec;
#pragma unroll
    for (int n = 0; n < kIters; ++n) {
      if (r0 + n * kRowStep < it.rows) {
        vx[n] = __ldg(reinterpret_cast<const uint4*>(x + first + n * step));
        va[n] = __ldg(reinterpret_cast<const uint4*>(a + first + n * step));
      }
    }
  };
  fetch(item);

  while (item < items) {
    const Item it = locate<kSt>(item, strips, seq);
    // Widen the fetched chunks into column r of channels q kVec ... + kVec
    // - 1, and draw the next ticket.
#pragma unroll
    for (int n = 0; n < kIters; ++n) {
      const int r = r0 + n * kRowStep;
      if (r < it.rows) {
        float fx[kVec], fa[kVec];
        Chunk<T>::widen(vx[n], fx);
        Chunk<T>::widen(va[n], fa);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          hq[i * G::kStride + r] = fx[i];
          pq[i * G::kStride + r] = fa[i];
        }
      }
    }
    if (threadIdx.x == 0) drawn = static_cast<int>(atomicAdd(ticket, 1u));
    __syncthreads();
    const int next = __shfl_sync(kFull, drawn, 0);
    fetch(next);  // in flight while this item is scanned

    // Scan: a warp kAtOnce (channel, tile) pairs at a time, pairs warp,
    // warp + kWarps, ... (their count, 16 a tile, is a multiple of kWarps
    // * kAtOnce).
    const int pairs = kChannels * __shfl_sync(kFull, it.tiles, 0);
    for (int base = warp; base < pairs; base += kWarps * G::kAtOnce) {
      int at[G::kAtOnce];
      float h[G::kAtOnce][G::kRegs], p[G::kAtOnce][G::kRegs];
#pragma unroll
      for (int n = 0; n < G::kAtOnce; ++n) {
        const int pair = base + n * kWarps;
        at[n] = (pair % kChannels) * G::kStride + (pair / kChannels) * kSt +
                lane;
#pragma unroll
        for (int j = 0; j < G::kRegs; ++j) {
          h[n][j] = sh[at[n] + 32 * j];
          p[n][j] = sp[at[n] + 32 * j];
        }
      }
      rounds(h, p, lane);
#pragma unroll
      for (int n = 0; n < G::kAtOnce; ++n) {
#pragma unroll
        for (int j = 0; j < G::kRegs; ++j) {
          sh[at[n] + 32 * j] = h[n][j];
          sp[at[n] + 32 * j] = p[n][j];
        }
      }
    }
    __syncthreads();

    // Chain: a thread a channel takes the carry into the item (h0, or the
    // previous group's), records the carry into each tile and publishes
    // the item's last.
    if (threadIdx.x < kChannels) {
      const int c = threadIdx.x;
      float carry =
          it.group == 0
              ? h0[it.c0 + c]
              : await(carries +
                      static_cast<int64_t>(item - strips) * kChannels + c);
      for (int i = 0; i < it.tiles; ++i) {
        sc[i * kChannels + c] = carry;
        const int last = c * G::kStride + i * kSt + kSt - 1;
        carry = __fadd_rn(sh[last], __fmul_rn(sp[last], carry));
      }
      if (it.row0 + it.rows < seq) {
        publish(carries + static_cast<int64_t>(item) * kChannels + c, carry);
      } else {
        h_last[it.c0 + c] = carry;
      }
    }
    __syncthreads();

    // Fix up and store: y = h + p * carry, 16 bytes a thread.
    const int64_t first = (it.row0 + r0) * dim + it.c0 + q * kVec;
#pragma unroll
    for (int n = 0; n < kIters; ++n) {
      const int r = r0 + n * kRowStep;
      if (r < it.rows) {
        float carry[kVec];
        const float4* cv = reinterpret_cast<const float4*>(
            sc + (r / kSt) * kChannels + q * kVec);
#pragma unroll
        for (int i = 0; i < kVec / 4; ++i) {
          const float4 v = cv[i];
          carry[4 * i] = v.x;
          carry[4 * i + 1] = v.y;
          carry[4 * i + 2] = v.z;
          carry[4 * i + 3] = v.w;
        }
        float v[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const int at = i * G::kStride + r;
          v[i] = __fadd_rn(hq[at], __fmul_rn(pq[at], carry[i]));
        }
        *reinterpret_cast<uint4*>(y + first + n * step) = Chunk<T>::narrow(v);
      }
    }
    __syncthreads();  // the tile is read before the next item's widening
    item = next;
  }
}

// The items of a call: strips of C channels times groups of tiles.
template <int kSt>
int64_t items(int seq, int dim) {
  using G = Group<kSt>;
  return static_cast<int64_t>(dim / kChannels) *
         ((seq / kSt + G::kTiles - 1) / G::kTiles);
}

// scratch, zeroed: one 64-bit word for the ticket, then a carry word per
// channel of every item (the item's index times C, plus the channel).
template <int kSt>
int64_t scratch_bytes(int seq, int dim) {
  return (1 + items<kSt>(seq, dim) * kChannels) * 8;
}

template <typename T, int kSt>
cudaError_t launch(const void* x, const void* a, const void* h0, void* y,
                   void* h_last, void* scratch, int seq, int dim,
                   cudaStream_t stream) {
  using G = Group<kSt>;
  static int resident[lru_ring::kMaxDevices] = {};  // blocks a card holds
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= lru_ring::kMaxDevices) return cudaErrorInvalidValue;
  if (resident[device] == 0) {
    err = cudaFuncSetAttribute(lab_logscan_kernel<T, kSt>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::kBytes);
    if (err != cudaSuccess) return err;
    int per_sm, sms;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lab_logscan_kernel<T, kSt>, kThreads, G::kBytes);
    if (err != cudaSuccess) return err;
    err = lru_ring::sm_count(&sms);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[device] = per_sm * sms;
  }
  const int64_t n = items<kSt>(seq, dim);
  const int blocks = static_cast<int>(n < resident[device] ? n
                                                          : resident[device]);
  auto* words = static_cast<unsigned long long*>(scratch);
  lab_logscan_kernel<T, kSt><<<blocks, kThreads, G::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_last), reinterpret_cast<unsigned*>(words),
      words + 1, seq, dim);
  return cudaGetLastError();
}

template <typename T, int kSt>
cudaError_t attributes(int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, lab_logscan_kernel<T, kSt>);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = Group<kSt>::kBytes;
  info[3] = kThreads;
  return cudaSuccess;
}

// The launch, the attributes and the scratch size as functors of <T, kSt>.
struct Launch {
  const void *x, *a, *h0;
  void *y, *h_last, *scratch;
  int seq, dim;
  cudaStream_t stream;
  template <typename T, int kSt>
  cudaError_t run() const {
    return launch<T, kSt>(x, a, h0, y, h_last, scratch, seq, dim, stream);
  }
};

struct ScratchBytes {
  int seq, dim;
  int64_t* bytes;
  template <typename T, int kSt>
  cudaError_t run() const {
    *bytes = scratch_bytes<kSt>(seq, dim);
    return cudaSuccess;
  }
};

struct Attributes {
  int* info;
  template <typename T, int kSt>
  cudaError_t run() const {
    return attributes<T, kSt>(info);
  }
};

// f.run<T, kSt>() for dtype (0 float32, 1 bfloat16) and st in {32, 64, 128,
// 256, 512}.
template <typename F>
cudaError_t dispatch(int dtype, int st, const F& f) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  switch (st) {
    case 32:
      return bf16 ? f.template run<__nv_bfloat16, 32>()
                  : f.template run<float, 32>();
    case 64:
      return bf16 ? f.template run<__nv_bfloat16, 64>()
                  : f.template run<float, 64>();
    case 128:
      return bf16 ? f.template run<__nv_bfloat16, 128>()
                  : f.template run<float, 128>();
    case 256:
      return bf16 ? f.template run<__nv_bfloat16, 256>()
                  : f.template run<float, 256>();
    case 512:
      return bf16 ? f.template run<__nv_bfloat16, 512>()
                  : f.template run<float, 512>();
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace logscan

// ---- Variant A ----------------------------------------------------------

template <typename T, int kSteps>
int unrolled_at(const void* x, const void* a, const void* h0, void* y,
                void* h_last, int batch, int seq, int dim,
                cudaStream_t stream) {
  using Wide = lru_ring::RealWalk<T, 32, kSteps, false, false>;
  using Narrow = lru_ring::RealWalk<T, 16, kSteps, false, false>;
  const void* loads[2] = {x, a};
  void* stores[1] = {y};
  const lru_ring::Carries carries{{static_cast<const float*>(h0), nullptr},
                                  {static_cast<float*>(h_last), nullptr},
                                  {nullptr, nullptr}};
  return static_cast<int>(lru_ring::launch<Wide, Narrow>(
      loads, stores, carries, batch, seq, dim, false, stream));
}

template <typename T>
int unrolled(const void* x, const void* a, const void* h0, void* y,
             void* h_last, int batch, int seq, int dim, int st,
             cudaStream_t stream) {
  if (batch == 0 || dim == 0) return cudaSuccess;
  if (!lru_ring::takes_ring(seq, dim, sizeof(T), x, a, y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (st) {
    case 64:
      return unrolled_at<T, 64>(x, a, h0, y, h_last, batch, seq, dim, stream);
    case 128:
      return unrolled_at<T, 128>(x, a, h0, y, h_last, batch, seq, dim, stream);
    case 256:
      return unrolled_at<T, 256>(x, a, h0, y, h_last, batch, seq, dim, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; st 64, 128 or 256. Tensors TMA can
// describe (a non-empty time axis, rows of a multiple of 16 bytes, 16-byte
// aligned bases; the wrapper checks, as it checks seq % st == 0, which the
// lab's grid requires). Returns the cudaError_t.
extern "C" int cg_lab_unrolled(const void* x, const void* a, const void* h0,
                               void* y, void* h_last, int batch, int seq,
                               int dim, int dtype, int st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return unrolled<float>(x, a, h0, y, h_last, batch, seq, dim, st, s);
  }
  if (dtype == 1) {
    return unrolled<__nv_bfloat16>(x, a, h0, y, h_last, batch, seq, dim, st,
                                   s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Batch 1; st in {32, 64, 128, 256, 512}, seq % st == 0, dim % 16 == 0,
// 16-byte aligned bases (the wrapper checks). scratch: the bytes
// cg_lab_logscan_scratch_bytes gives, zeroed on `stream` before the call.
// Returns the cudaError_t.
extern "C" int cg_lab_logscan(const void* x, const void* a, const void* h0,
                              void* y, void* h_last, void* scratch, int seq,
                              int dim, int dtype, int st, void* stream) {
  if (seq <= 0 || dim <= 0 || st <= 0 || seq % st || dim % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const logscan::Launch f{x, a, h0, y, h_last, scratch, seq, dim,
                          static_cast<cudaStream_t>(stream)};
  return static_cast<int>(logscan::dispatch(dtype, st, f));
}

// The bytes of cg_lab_logscan's scratch buffer at seq, dim and st, into
// *bytes. Returns the cudaError_t.
extern "C" int cg_lab_logscan_scratch_bytes(int seq, int dim, int st,
                                            int64_t* bytes) {
  if (seq <= 0 || dim <= 0 || st <= 0 || seq % st || dim % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      logscan::dispatch(0, st, logscan::ScratchBytes{seq, dim, bytes}));
}

// Variant B's kernel at dtype and st: info = {registers a thread at
// launch, local (spilled) bytes a thread, dynamic shared memory bytes a
// block, threads a block}.
extern "C" int cg_lab_logscan_attributes(int dtype, int st, int* info) {
  return static_cast<int>(
      logscan::dispatch(dtype, st, logscan::Attributes{info}));
}
