// Weight-only int8 matrix product with a per-output-channel scale:
//
//   y[b, m, n] = bf16( bf16( sum_k A[b, m, k] * Q[b, n, k] ) * bf16(scale[b, n]) )
//
// A is bf16 [B, M, K] with K contiguous and free batch and row strides (a
// shared activation has batch stride 0, the heads of a block-diagonal gate
// batch stride i and row stride h * i); Q is int8 [B, N, K], K contiguous;
// scale is fp32 [B, N]; y is bf16 [B, M, N], contiguous. The sum is fp32.
//
// Replaces no Pallas kernel: the JAX package contracts against int8 weights
// with XLA's dot, whose operand read fuses the int8 -> bf16 convert, so only
// int8 crosses device memory (cadence_gemma_tpu/ops/quantization.py:3-7,
// models/layers.py:166-170). No torch composition fuses that convert: one
// `x @ q.to(bf16)` writes and reads back a bf16 copy of every weight, about
// five bytes a parameter against bf16's two. This kernel widens Q on chip.
//
// What bounds it: at decode (M = 2 to 8 rows) the bytes of Q, one byte a
// parameter; at prefill (M in the thousands) the bf16 tensor-core operations.
//
// Design, simple first: blocks of 4 warps own a BM x 64 output tile
// (BM = 16 for at most 16 rows, else 64) and walk K in 64-wide tiles through
// a 3-stage cp.async ring in shared memory (rows padded so fragment loads hit
// distinct banks). Each warp runs mma.sync.m16n8k16 (bf16 in, fp32 sums); its
// B fragments are read from the int8 tile two values at a time and widened
// to bf16 in registers (|q| <= 127 converts exactly). The epilogue rounds
// the sum to bf16 and multiplies by the bf16 scale. When the output tiles
// would not give every SM two blocks (decode shapes), the wrapper splits K
// over blockIdx.z: each split writes fp32 partial sums to a workspace and a
// second kernel adds them in split order and applies the epilogue. No
// atomics, so two launches give the same bits.
//
// This is the decode-row kernel (ops/int8_matmul.py routes by rows:
// `uses_wgmma`); the Hopper forward for prefill and training rows and the
// input gradient are in int8_wgmma.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kStages = 3;
constexpr int kThreads = 128;
// Shared-memory row pitches: 16 bytes of padding a row.
constexpr int kAPitch = kBK + 8;   // bf16 elements
constexpr int kQPitch = kBK + 16;  // int8 elements

struct Args {
  const __nv_bfloat16* a;
  const int8_t* q;
  const float* scale;
  __nv_bfloat16* y;
  float* partial;  // [splits, B, M, N] fp32, or null without a split
  int m, n, k;
  int64_t a_batch, a_row;  // strides of A in elements
  int splits;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two int8 values (low byte first) -> a packed pair of bf16, exactly.
__device__ __forceinline__ uint32_t widen2(uint16_t pair) {
  const float lo = static_cast<float>(static_cast<int8_t>(pair & 0xff));
  const float hi = static_cast<float>(static_cast<int8_t>(pair >> 8));
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ __nv_bfloat16 epilogue(float sum, float scale) {
  const float rounded = __bfloat162float(__float2bfloat16_rn(sum));
  const float s = __bfloat162float(__float2bfloat16_rn(scale));
  return __float2bfloat16_rn(rounded * s);  // exact product, one rounding
}

// WARPS_M x WARPS_N warps; each owns MI m16 tiles and NJ n8 tiles.
template <int WARPS_M, int WARPS_N, int MI, int NJ>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const Args args) {
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "four warps");
  static_assert(WARPS_N * NJ * 8 == kBN, "64 columns");
  constexpr int kBM = WARPS_M * MI * 16;
  __shared__ __align__(16) __nv_bfloat16 s_a[kStages][kBM * kAPitch];
  __shared__ __align__(16) int8_t s_q[kStages][kBN * kQPitch];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_m = warp / WARPS_N;
  const int warp_n = warp % WARPS_N;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int batch = blockIdx.z / args.splits;
  const int split = blockIdx.z % args.splits;

  const int k_tiles = (args.k + kBK - 1) / kBK;
  const int t_begin = static_cast<int>(
      static_cast<int64_t>(k_tiles) * split / args.splits);
  const int t_end = static_cast<int>(
      static_cast<int64_t>(k_tiles) * (split + 1) / args.splits);
  const int tiles = t_end - t_begin;

  const __nv_bfloat16* a_base = args.a + batch * args.a_batch;
  const int8_t* q_base =
      args.q + static_cast<int64_t>(batch) * args.n * args.k;

  // One K tile of A (kBM rows x 8 chunks of 8 bf16) and of Q (64 rows x 4
  // chunks of 16 int8) into stage `stage`; chunks past M, N or K read
  // nothing and land as zeros.
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    for (int c = tid; c < kBM * (kBK / 8); c += kThreads) {
      const int row = c / (kBK / 8);
      const int col = (c % (kBK / 8)) * 8;
      const bool valid = m0 + row < args.m && k0 + col < args.k;
      const __nv_bfloat16* src =
          valid ? a_base + (m0 + row) * args.a_row + k0 + col : args.a;
      cp_async16(&s_a[stage][row * kAPitch + col], src, valid);
    }
    for (int c = tid; c < kBN * (kBK / 16); c += kThreads) {
      const int row = c / (kBK / 16);
      const int col = (c % (kBK / 16)) * 16;
      const bool valid = n0 + row < args.n && k0 + col < args.k;
      const int8_t* src =
          valid ? q_base + static_cast<int64_t>(n0 + row) * args.k + k0 + col
                : args.q;
      cp_async16(&s_q[stage][row * kQPitch + col], src, valid);
    }
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_tile(t_begin + s, s);
    cp_async_commit();
  }

  const int group = lane / 4;        // fragment row (A) or column (B)
  const int pair = (lane % 4) * 2;   // fragment k offset
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // Refill the stage read one iteration ago; every warp has passed the
    // barrier above, so none still reads it.
    const int next = t + kStages - 1;
    if (next < tiles) load_tile(t_begin + next, next % kStages);
    cp_async_commit();

    const __nv_bfloat16* sa = s_a[t % kStages];
    const int8_t* sq = s_q[t % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int row = (warp_m * MI + i) * 16 + group;
        const __nv_bfloat16* p = sa + row * kAPitch + kk + pair;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kAPitch);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kAPitch + 8);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = (warp_n * NJ + j) * 8 + group;
        const int8_t* p = sq + col * kQPitch + kk + pair;
        uint32_t bf[2];
        bf[0] = widen2(*reinterpret_cast<const uint16_t*>(p));
        bf[1] = widen2(*reinterpret_cast<const uint16_t*>(p + 8));
#pragma unroll
        for (int i = 0; i < MI; ++i) mma_bf16(acc[i][j], af[i], bf);
      }
    }
  }
  cp_async_wait<0>();

  // Accumulator element e of tile (i, j): row group (+ 8 for e >= 2),
  // column pair + (e % 2).
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + (warp_m * MI + i) * 16 + group + (e >= 2 ? 8 : 0);
        const int n = n0 + (warp_n * NJ + j) * 8 + pair + (e % 2);
        if (m >= args.m || n >= args.n) continue;
        const int64_t out = (static_cast<int64_t>(batch) * args.m + m) *
                                args.n + n;
        if (args.partial != nullptr) {
          const int64_t plane =
              static_cast<int64_t>(gridDim.z / args.splits) * args.m * args.n;
          args.partial[split * plane + out] = acc[i][j][e];
        } else {
          args.y[out] = epilogue(
              acc[i][j][e],
              args.scale[static_cast<int64_t>(batch) * args.n + n]);
        }
      }
    }
  }
}

// The split-K pass: sums the partials in split order, then the epilogue.
__global__ void int8_matmul_reduce_kernel(const float* __restrict__ partial,
                                          const float* __restrict__ scale,
                                          __nv_bfloat16* __restrict__ y,
                                          int64_t elements, int m, int n,
                                          int splits) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= elements) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[s * elements + i];
  const int64_t batch = i / (static_cast<int64_t>(m) * n);
  const int col = static_cast<int>(i % n);
  y[i] = epilogue(sum, scale[batch * n + col]);
}

template <int WARPS_M, int WARPS_N, int MI, int NJ>
cudaError_t launch(const Args& args, int batches, cudaStream_t stream) {
  constexpr int kBM = WARPS_M * MI * 16;
  const dim3 grid((args.n + kBN - 1) / kBN, (args.m + kBM - 1) / kBM,
                  batches * args.splits);
  int8_matmul_kernel<WARPS_M, WARPS_N, MI, NJ>
      <<<grid, kThreads, 0, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// The output tile's rows for `m` rows of A (the wrapper sizes its split-K
// workspace by it).
extern "C" int cg_int8_matmul_block_rows(int m) { return m <= 16 ? 16 : 64; }

// a: bf16 [batches, m, k] with strides (a_batch, a_row, 1) in elements; q:
// int8 [batches, n, k] contiguous; scale: fp32 [batches, n]; y: bf16
// [batches, m, n] contiguous. splits > 1 needs `partial`, fp32 [splits,
// batches, m, n]; splits must not exceed ceil(k / 64). k must be a multiple
// of 16, a, q and the strides 16-byte aligned. Returns the cudaError_t of
// the launches (0 on success).
extern "C" int cg_int8_weight_matmul(const void* a, const void* q,
                                     const void* scale, void* y,
                                     void* partial, int batches, int m, int n,
                                     int k, long long a_batch, long long a_row,
                                     int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batches <= 0 || m <= 0 || n <= 0) return cudaSuccess;
  if (k <= 0 || k % 16 || splits < 1 || splits > (k + kBK - 1) / kBK ||
      (splits > 1 && partial == nullptr) || a_row % 8 || a_batch % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args{static_cast<const __nv_bfloat16*>(a),
            static_cast<const int8_t*>(q),
            static_cast<const float*>(scale),
            static_cast<__nv_bfloat16*>(y),
            splits > 1 ? static_cast<float*>(partial) : nullptr,
            m, n, k, a_batch, a_row, splits};
  cudaError_t err = m <= 16 ? launch<1, 4, 1, 2>(args, batches, s)
                            : launch<2, 2, 2, 4>(args, batches, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t elements = static_cast<int64_t>(batches) * m * n;
  const int threads = 256;
  int8_matmul_reduce_kernel<<<
      static_cast<unsigned>((elements + threads - 1) / threads), threads, 0,
      s>>>(static_cast<const float*>(partial),
           static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
           elements, m, n, splits);
  return static_cast<int>(cudaGetLastError());
}
