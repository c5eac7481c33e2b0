// Weight-only int8 product at prefill and training rows, and its input
// gradient, Hopper designs (TMA ring, the int8 tile widened once a block in
// shared memory, wgmma):
//
//   y[b, m, n]  = bf16( bf16( sum_k A[b, m, k] * Q[b, n, k] ) * bf16(scale[b, n]) )
//   dA[b, m, k] = bf16( sum_n bf16( dY[b, m, n] * bf16(scale[b, n]) ) * Q[b, n, k] )
//
// The forward is int8_matmul.cu's function, whose mma.sync kernel keeps the
// decode rows (ops/int8_matmul.py routes the forward by rows: `uses_wgmma`);
// the input gradient runs here at every shape. A is bf16 [B, M, K], K
// contiguous, described by the caller's tensor map (a shared activation,
// batch stride 0, is one [M, K] loaded at the same coordinates for every b;
// the block-diagonal gates' heads are read in place as a 3D [M, H, I] box);
// Q is int8 [B, N, K] contiguous; scale fp32 [B, N]; y and dA bf16,
// contiguous. With a shared activation the gradient's contraction
// runs over (b, n) into one [1, M, K].
//
// Replaces no Pallas kernel: the JAX package contracts against int8 weights
// with XLA's dot, whose operand read fuses the int8 -> bf16 convert
// (cadence_gemma_tpu/ops/quantization.py:3-7, models/layers.py:166-170), and
// differentiates it with XLA's transpose of that dot (layers.py:171-173).
// No bf16 copy of a weight reaches device memory here either.
//
// What bounds them: at these rows (hundreds to thousands) the bf16
// tensor-core operations, 2 M N K of them against one byte a weight.
//
// Design. A block is three warpgroups: two consumers of 64 rows each and a
// producer warpgroup whose warp 0 keeps the A ring (A, or dY with its 64
// scales) and warp 1 the Q ring (int8 tiles as bytes) in flight by TMA,
// each stage with a full and an empty mbarrier. An A stage comes back when
// its products are done, a Q stage as soon as its tile is widened, so the
// int8 tiles run further ahead. The consumers widen each int8 tile once a
// block, each of the 256 threads a share, into one of three bf16 tiles in
// the layout wgmma's descriptor reads (|q| <= 127 converts exactly: two
// bytes at a time, bf16 128 + the low seven bits less 128 or 256 when the
// sign bit is set: one prmt, two lop3, one bf16x2 subtraction). Tile t + 1
// is widened while tile t's products run (wgmma is asynchronous); a named
// barrier a tile makes the widened tile visible (after
// fence.proxy.async) and frees the one two tiles back. fp32 sums stay in
// registers (setmaxnreg: 232 a consumer thread, 40 a producer thread).
// - Forward: a 128 x 256 output tile, 64-deep K tiles, 4 + 4 stages (A 16
//   KB, Q 16 KB), widened tiles of 32 KB, K-major (the layout of K in
//   S = Q K^T, hopper.cuh); both operands from shared memory. Epilogue:
//   round the sum to bf16, multiply by the bf16 scale, round again; the
//   tile is staged in the widened tiles and written by TMA (N % 8 == 0;
//   else by the threads' own stores), as the gradient's is.
// - Input gradient: a 128 x 128 tile of dA, the contraction in 64-deep
//   tiles of N (of every b when summing over the batches), 6 + 6 stages
//   (dY 16 KB and its scales, Q 8 KB); the widened tile is MN-major (SBO
//   one 8-row atom, LBO one 64-column box: V's layout in O += P V). dY is
//   the register-sourced operand: each thread's fragments come from the
//   swizzled tile by ldmatrix and are multiplied by the bf16 scales of
//   their columns, JAX's one bf16 rounding, without writing dY back, then
//   feed wgmma (two register buffers, tiles taken two at a time). The
//   contraction is long (the logits' 256000 words) and wgmma's fp32 sum
//   does not round to nearest: every kFold tiles' products are summed into
//   a fresh accumulator and then added to an fp32 running sum (summed in
//   the accumulator alone, the logits' sum strays beyond 2^-6 of the
//   float64 one).
// - Shapes: TMA fills out-of-bounds boxes with zeros (int8 zero widens to
//   zero; a gradient tile wholly past the end, added to make the count
//   even, adds nothing), and the epilogue writes no row >= M or column >= N
//   (K).
// - Why the forward keeps both operands in shared memory and not CUTLASS's
//   register-sourced, swapped operands: a thread's fragment of an int8 row
//   is bytes 2q, 2q + 1, 2q + 8, 2q + 9, which no wide load or ldmatrix
//   hands it, while one widened tile serves both consumers through the
//   descriptors and the epilogue needs no transpose. The gradient's dY is
//   bf16 already, so ldmatrix gives its fragments and the scale costs
//   registers instead of a shared-memory pass.
// Tried and dropped: the int8 tiles fetched into registers by ld.global two
// tiles ahead instead of the Q ring (slower at every shape timed).
// Two launches give the same bits (no atomics, a fixed summation order);
// the tensor maps are __grid_constant__ parameters, so a captured CUDA
// graph replays them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;  // consumers: warpgroups 0-1; producers: 2
constexpr int kConsumers = 256;
constexpr int kConsumerWarps = 8;
constexpr int kBK = 64;    // depth of a tile: a 128-byte row of bf16
constexpr int kRow = 128;  // bytes of a swizzled row
constexpr int kWidened = 3;  // widened tiles: tile t's while t + 1's is made
// setmaxnreg: the producer warpgroup's registers go to the consumers. The
// block holds kThreads x its launch registers, which must cover both.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMinLaunchRegs =
    (128 * kProducerRegs + kConsumers * kConsumerRegs + kThreads - 1) /
    kThreads;

struct Fwd {
  static constexpr int kBM = 128, kBN = 256;
  static constexpr int kStagesA = 4, kStagesQ = 4;
  static constexpr int kABytes = kBM * kRow;   // bf16 [128 rows][64]
  static constexpr int kQBytes = kBN * kBK;    // int8 [256 rows][64]
  static constexpr int kWBytes = kBN * kRow;   // bf16 [256 rows][64]
  // The output tile staged in the widened tiles: four [128][64] boxes.
  static constexpr int kOutBox = kBM * kRow;
  static constexpr int kA = 0;
  static constexpr int kQ = kA + kStagesA * kABytes;
  static constexpr int kW = kQ + kStagesQ * kQBytes;
  static constexpr int kBars = kW + kWidened * kWBytes;
  // + 1024: the base is aligned up to the 128-byte swizzle's 1 KB period.
  static constexpr int kBytes =
      kBars + 16 * (kStagesA + kStagesQ) + 1024;
};

struct Dgrad {
  // kFold even: the tiles are taken two at a time (the fragments' two
  // register buffers).
  static constexpr int kBM = 128, kBN = 128, kFold = 8;
  static constexpr int kStagesA = 6, kStagesQ = 6;
  static constexpr int kABytes = kBM * kRow;         // dY bf16 [128][64 n]
  static constexpr int kSBytes = kBK * 4;            // its scales, fp32 [64]
  static constexpr int kQBytes = kBK * kBN;          // int8 [64 n][128 k]
  static constexpr int kBox = kBK * kRow;            // [64 n][64 k] bf16
  static constexpr int kWBytes = (kBN / 64) * kBox;  // two boxes
  static constexpr int kOutBox = kBM * kRow;  // dA staged: two [128][64]
  static constexpr int kA = 0;
  static constexpr int kQ = kA + kStagesA * kABytes;
  static constexpr int kW = kQ + kStagesQ * kQBytes;
  static constexpr int kS = kW + kWidened * kWBytes;
  static constexpr int kBars = kS + kStagesA * kSBytes;
  static constexpr int kBytes =
      kBars + 16 * (kStagesA + kStagesQ) + 1024;
};

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// (a & mask) | c in one lop3.
template <uint32_t kMask>
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "n"(kMask),
      "r"(c));
  return d;
}

// Two int8 values (bytes `kSel` picks from `w`: 0x4140 bytes 0-1, 0x4342
// bytes 2-3) -> a bf16x2, exactly: bf16 128 + the low seven bits, less 128
// (or 256 when the sign bit is set). `bias` holds bf16x2 (128, 128).
template <uint32_t kSel>
__device__ __forceinline__ uint32_t widen2(uint32_t w, uint32_t bias) {
  const uint32_t spread = __byte_perm(w, 0, kSel);  // 0x00b1_00b0
  const uint32_t hi = and_or<0x007F007Fu>(spread, bias);
  const uint32_t lo = and_or<0x00800080u>(spread, bias);
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
              *reinterpret_cast<const __nv_bfloat162*>(&lo));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// 16 int8 values -> two 16-byte chunks of 8 bf16.
__device__ __forceinline__ void widen16(const uint4 v, uint4& lo, uint4& hi) {
  uint32_t bias = 0x43004300u;
  asm volatile("" : "+r"(bias));  // kept in a register for the lop3s
  lo.x = widen2<0x4140>(v.x, bias);
  lo.y = widen2<0x4342>(v.x, bias);
  lo.z = widen2<0x4140>(v.y, bias);
  lo.w = widen2<0x4342>(v.y, bias);
  hi.x = widen2<0x4140>(v.z, bias);
  hi.y = widen2<0x4342>(v.z, bias);
  hi.z = widen2<0x4140>(v.w, bias);
  hi.w = widen2<0x4342>(v.w, bias);
}

// The forward's int8 tile [256 rows][64 bytes] -> bf16 [256 rows][64],
// K-major under the 128-byte swizzle (chunk c of row r at c ^ (r % 8)).
// Consumer thread i takes chunks i + 256 j: a warp reads 512 contiguous
// bytes and each quarter-warp's stores fall in eight distinct bank groups.
__device__ __forceinline__ void widen_k_major(uint32_t q8, uint32_t w,
                                              int i) {
  constexpr int kChunks = Fwd::kQBytes / 16 / kConsumers;
  uint4 v[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) v[j] = lds128(q8 + (i + kConsumers * j) * 16);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int g = i + kConsumers * j;
    const int row = g >> 2;
    const int c = 2 * (g & 3);
    uint4 lo, hi;
    widen16(v[j], lo, hi);
    const uint32_t dst = w + row * kRow;
    sts128(dst + ((c ^ (row & 7)) << 4), lo);
    sts128(dst + (((c + 1) ^ (row & 7)) << 4), hi);
  }
}

// The gradient's int8 tile [64 n][128 k bytes] -> bf16 MN-major: two boxes
// of [64 n][64 k] under the 128-byte swizzle.
__device__ __forceinline__ void widen_mn_major(uint32_t q8, uint32_t w,
                                               int i) {
  constexpr int kChunks = Dgrad::kQBytes / 16 / kConsumers;
  uint4 v[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c16 = (i & 3) + 4 * j;  // 16-byte column chunk
    v[j] = lds128(q8 + (i >> 2) * Dgrad::kBN + c16 * 16);
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c16 = (i & 3) + 4 * j;
    const int n = i >> 2;
    uint4 lo, hi;
    widen16(v[j], lo, hi);
    const uint32_t dst = w + (c16 >> 2) * Dgrad::kBox + n * kRow;
    const int c = 2 * (c16 & 3);
    sts128(dst + ((c ^ (n & 7)) << 4), lo);
    sts128(dst + (((c + 1) ^ (n & 7)) << 4), hi);
  }
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t lds_bf16_pair(uint32_t addr) {
  float lo, hi;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(lo), "=f"(hi)
               : "r"(addr));
  return hopper::pack_bf16(lo, hi);
}

// This thread's fragments of a dY tile [128 rows][64 n] (swizzled) as
// wgmma's register A operand for four 16-deep steps (rows 16 w + lane / 4
// (+ 8) of warpgroup `wg`'s 64, columns 2 (lane % 4) (+ 1, + 8, + 9)), each
// times the bf16 scale of its column: JAX's `dy * scale.astype(bf16)`, the
// product of two bf16 rounded once. `s` holds the tile's 64 fp32 scales.
__device__ __forceinline__ void load_scaled(uint32_t g, uint32_t s, int wg,
                                            uint32_t (&f)[4][4]) {
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int mi = lane / 8;  // ldmatrix's matrix: rows + 8, columns + 8
  const int r = lane % 8;   // = its row % 8, the swizzle's
  const uint32_t row = g + (wg * 64 + warp * 16 + (mi & 1) * 8 + r) * kRow;
  const uint32_t cols = s + 8 * (lane % 4);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    ldmatrix_x4(row + (((2 * kk + (mi >> 1)) ^ r) << 4), f[kk]);
    const uint32_t lo = lds_bf16_pair(cols + 64 * kk);
    const uint32_t hi = lds_bf16_pair(cols + 64 * kk + 32);
    f[kk][0] = mul_bf16x2(f[kk][0], lo);
    f[kk][1] = mul_bf16x2(f[kk][1], lo);
    f[kk][2] = mul_bf16x2(f[kk][2], hi);
    f[kk][3] = mul_bf16x2(f[kk][3], hi);
  }
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], both K-major in shared memory;
// `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_n256_kmajor(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
        "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
        "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A from registers (the
// accumulator layout of a 64 x 16 product, bf16 pairs), B MN-major in shared
// memory; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n128_mnmajor(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return hopper::make_desc(addr, 16, 1024, hopper::kSwizzle128B);
}

__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return hopper::make_desc(addr, Dgrad::kBox, 1024, hopper::kSwizzle128B);
}

__device__ __forceinline__ __nv_bfloat16 epilogue(float sum, float scale) {
  const float rounded = __bfloat162float(__float2bfloat16_rn(sum));
  const float s = __bfloat162float(__float2bfloat16_rn(scale));
  return __float2bfloat16_rn(rounded * s);  // exact product, one rounding
}

// The rings' barriers after the tiles: full and empty for each stage of
// the A (or dY) ring and of the Q ring.
struct Bars {
  uint64_t* full_a;
  uint64_t* empty_a;
  uint64_t* full_q;
  uint64_t* empty_q;
};

template <int kStagesA, int kStagesQ>
__device__ __forceinline__ Bars init_bars(unsigned char* base) {
  uint64_t* b = reinterpret_cast<uint64_t*>(base);
  const Bars bars{b, b + kStagesA, b + 2 * kStagesA,
                  b + 2 * kStagesA + kStagesQ};
  if (threadIdx.x == kConsumers) {
    for (int s = 0; s < kStagesA; ++s) {
      hopper::mbar_init(&bars.full_a[s], 1);
      hopper::mbar_init(&bars.empty_a[s], kConsumerWarps);  // lane 0 each
    }
    for (int s = 0; s < kStagesQ; ++s) {
      hopper::mbar_init(&bars.full_q[s], 1);
      hopper::mbar_init(&bars.empty_q[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  return bars;
}

// The producer warpgroup: lane 0 of warp 0 keeps the A ring full, lane 0
// of warp 1 the Q ring (`load_a(t)`, `load_q(t)` issue tile t into stage
// t % stages). A stage of A comes back when its products are done, one of
// Q when its tile is widened, so Q runs further ahead.
template <int kStagesA, int kStagesQ, typename LoadA, typename LoadQ>
__device__ __forceinline__ void run_producers(const Bars& bars, int tiles,
                                              LoadA load_a, LoadQ load_q) {
  hopper::reg_dealloc<kProducerRegs>();
  const int i = threadIdx.x - kConsumers;
  if (i == 0) {
    for (int t = 0; t < tiles; ++t) {
      hopper::mbar_wait(&bars.empty_a[t % kStagesA],
                        ((t / kStagesA) & 1) ^ 1);
      load_a(t);
    }
  } else if (i == 32) {
    for (int t = 0; t < tiles; ++t) {
      hopper::mbar_wait(&bars.empty_q[t % kStagesQ],
                        ((t / kStagesQ) & 1) ^ 1);
      load_q(t);
    }
  }
}

__device__ __forceinline__ void release(uint64_t* bar) {
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(bar);
}

// The consumers over tiles [t0, t1) into `acc` (overwritten by the first
// product). Per tile t: a named barrier (every consumer has widened tile t,
// and both warpgroups' products of tile t - 2 are done, so the widened tile
// t + 1 overwrites is free), tile t's products issued, tile t + 1 widened
// (`widen(t + 1)`) while they run, then tile t - 1's products waited for
// and its A stage released.
template <int kStagesA, int N, typename Issue, typename Widen>
__device__ __forceinline__ void run_tiles(const Bars& bars, float (&acc)[N],
                                          int t0, int t1, int tiles,
                                          Issue issue, Widen widen) {
  for (int t = t0; t < t1; ++t) {
    hopper::named_barrier_sync(1, kConsumers);
    hopper::mbar_wait(&bars.full_a[t % kStagesA], (t / kStagesA) & 1);
    hopper::fence_registers(acc);
    hopper::wgmma_fence();
    issue(t, t > t0);
    hopper::wgmma_commit();
    hopper::fence_registers(acc);
    if (t + 1 < tiles) widen(t + 1);
    hopper::wgmma_wait<1>();
    hopper::fence_registers(acc);
    if (t > t0) release(&bars.empty_a[(t - 1) % kStagesA]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_registers(acc);
  release(&bars.empty_a[(t1 - 1) % kStagesA]);
}

__global__ void __launch_bounds__(kThreads, 1)
    int8_wgmma_forward_kernel(const __grid_constant__ CUtensorMap tm_a,
                              const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_y,
                              const float* __restrict__ scale,
                              __nv_bfloat16* __restrict__ y, int m, int n,
                              int k, int a_heads, int a_shared, int y_tma) {
  using C = Fwd;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const Bars bars = init_bars<C::kStagesA, C::kStagesQ>(smem + C::kBars);
  __syncthreads();
  const int m0 = blockIdx.x * C::kBM;
  const int n0 = blockIdx.y * C::kBN;
  const int b = blockIdx.z;
  const int tiles = (k + kBK - 1) / kBK;

  if (threadIdx.x >= kConsumers) {
    const int ab = a_shared ? 0 : b;
    run_producers<C::kStagesA, C::kStagesQ>(
        bars, tiles,
        [&](int t) {
          const int s = t % C::kStagesA;
          hopper::mbar_expect_tx(&bars.full_a[s], C::kABytes);
          unsigned char* dst = smem + C::kA + s * C::kABytes;
          if (a_heads) {  // [M, H, K]: the heads' rows read in place
            hopper::tma_load_3d(dst, &tm_a, &bars.full_a[s], t * kBK, ab, m0);
          } else {
            hopper::tma_load_3d(dst, &tm_a, &bars.full_a[s], t * kBK, m0, ab);
          }
        },
        [&](int t) {
          const int s = t % C::kStagesQ;
          hopper::mbar_expect_tx(&bars.full_q[s], C::kQBytes);
          hopper::tma_load_3d(smem + C::kQ + s * C::kQBytes, &tm_q,
                              &bars.full_q[s], t * kBK, n0, b);
        });
    return;
  }

  hopper::reg_alloc<kConsumerRegs>();
  const int i = threadIdx.x;
  const int wg = i / 128;
  const uint32_t a_base = hopper::smem_u32(smem + C::kA) + wg * 64 * kRow;
  const uint32_t q_base = hopper::smem_u32(smem + C::kQ);
  const uint32_t w_base = hopper::smem_u32(smem + C::kW);
  auto widen = [&](int t) {
    const int s = t % C::kStagesQ;
    hopper::mbar_wait(&bars.full_q[s], (t / C::kStagesQ) & 1);
    widen_k_major(q_base + s * C::kQBytes,
                  w_base + (t % kWidened) * C::kWBytes, i);
    hopper::fence_proxy_async_shared();  // the writes, for wgmma's reads
    __syncwarp();  // the warp's reads of the int8 tile are done
    release(&bars.empty_q[s]);
  };
  widen(0);
  // No zero fill: the first product overwrites the sums (a fill ahead of
  // the products made ptxas serialize them, C7515).
  float acc[C::kBN / 2];
  run_tiles<C::kStagesA>(
      bars, acc, 0, tiles, tiles,
      [&](int t, bool more) {
        const uint32_t a = a_base + (t % C::kStagesA) * C::kABytes;
        const uint32_t w = w_base + (t % kWidened) * C::kWBytes;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wgmma_n256_kmajor(acc, kmajor_desc(a + kk * 32),
                            kmajor_desc(w + kk * 32), more || kk > 0);
        }
      },
      widen);

  // Register 4 c + 2 r + j: row 16 (t / 32) + (t % 32) / 4 + 8 r, column
  // 8 c + 2 (t % 4) + j of the warpgroup's 64 x 256 tile.
  const int tt = i % 128;
  const int row_in = wg * 64 + (tt / 32) * 16 + (tt % 32) / 4;
  const int quad = tt % 4;
  const float* scale_b = scale + static_cast<int64_t>(b) * n;
  if (y_tma) {
    // n % 8 == 0. Both warpgroups' products are done: the widened tiles
    // hold the output tile as four swizzled [128 rows][64 columns] boxes,
    // and TMA writes the rows and columns in bounds.
    hopper::named_barrier_sync(1, kConsumers);
#pragma unroll
    for (int c = 0; c < C::kBN / 8; ++c) {
      const int col = n0 + 8 * c + 2 * quad;
      const float s0 = col < n ? scale_b[col] : 0.f;
      const float s1 = col < n ? scale_b[col + 1] : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_in + 8 * r;
        __nv_bfloat162 pair;
        pair.x = epilogue(acc[4 * c + 2 * r], s0);
        pair.y = epilogue(acc[4 * c + 2 * r + 1], s1);
        sts32(w_base + (c / 8) * C::kOutBox + row * kRow +
                  (((c % 8) ^ (row & 7)) << 4) + 4 * quad,
              *reinterpret_cast<const uint32_t*>(&pair));
      }
    }
    hopper::fence_proxy_async_shared();  // the writes, for TMA's reads
    hopper::named_barrier_sync(1, kConsumers);
    if (i == 0) {
#pragma unroll
      for (int box = 0; box < C::kBN / 64; ++box) {
        if (n0 + 64 * box < n) {
          hopper::tma_store_3d(&tm_y, smem + C::kW + box * C::kOutBox,
                               n0 + 64 * box, m0, b);
        }
      }
      hopper::bulk_commit();
      hopper::bulk_wait<0>();
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < C::kBN / 8; ++c) {
    const int col = n0 + 8 * c + 2 * quad;
    if (col >= n) continue;
    const bool second = col + 1 < n;
    const float s0 = scale_b[col];
    const float s1 = second ? scale_b[col + 1] : 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + row_in + 8 * r;
      if (row >= m) continue;
      __nv_bfloat16* dst = y + (static_cast<int64_t>(b) * m + row) * n + col;
      dst[0] = epilogue(acc[4 * c + 2 * r], s0);
      if (second) dst[1] = epilogue(acc[4 * c + 2 * r + 1], s1);
    }
  }
}

// One tile of the gradient's consumers (see run_tiles): tile t's scaled dY
// fragments loaded into `cur` and its products issued; `prev` holds tile
// t - 1's, which its products read until the wait.
template <typename Widen>
__device__ __forceinline__ void dgrad_tile(const Bars& bars, float (&acc)[64],
                                           uint32_t (&cur)[4][4],
                                           uint32_t (&prev)[4][4], int t,
                                           int t0, int tiles, uint32_t g_base,
                                           uint32_t s_base, uint32_t w_base,
                                           int wg, Widen widen) {
  using C = Dgrad;
  const int sa = t % C::kStagesA;
  hopper::named_barrier_sync(1, kConsumers);
  hopper::mbar_wait(&bars.full_a[sa], (t / C::kStagesA) & 1);
  load_scaled(g_base + sa * C::kABytes, s_base + sa * C::kSBytes, wg, cur);
  hopper::fence_registers(acc);
  hopper::wgmma_fence();
  const uint32_t w = w_base + (t % kWidened) * C::kWBytes;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {  // 16 n: 16 rows of the tile
    wgmma_rs_n128_mnmajor(acc, cur[kk], mnmajor_desc(w + kk * 16 * kRow),
                          t > t0 || kk > 0);
  }
  hopper::wgmma_commit();
  hopper::fence_registers(acc);
  if (t + 1 < tiles) widen(t + 1);
  hopper::wgmma_wait<1>();
  hopper::fence_registers(acc);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) hopper::fence_registers(prev[kk]);
  if (t > t0) release(&bars.empty_a[(t - 1) % C::kStagesA]);
}

__global__ void __launch_bounds__(kThreads, 1)
    int8_wgmma_dgrad_kernel(const __grid_constant__ CUtensorMap tm_g,
                            const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_s,
                            const __grid_constant__ CUtensorMap tm_out,
                            int batches, int m, int n, int k, int reduce) {
  using C = Dgrad;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const Bars bars = init_bars<C::kStagesA, C::kStagesQ>(smem + C::kBars);
  __syncthreads();
  const int k0 = blockIdx.x * C::kBN;  // output columns: Q's contiguous axis
  const int m0 = blockIdx.y * C::kBM;
  const int ob = blockIdx.z;
  const int n_tiles = (n + kBK - 1) / kBK;
  // Contraction tiles, rounded up to even (tiles go two at a time): a tile
  // past the end maps outside the tensors, and TMA fills it with zeros.
  const int tiles = ((reduce ? n_tiles * batches : n_tiles) + 1) & ~1;
  // Contraction tile t: batch and first n.
  auto at = [&](int t, int& b, int& nn) {
    b = reduce ? t / n_tiles : ob;
    nn = (reduce ? t % n_tiles : t) * kBK;
  };

  if (threadIdx.x >= kConsumers) {
    run_producers<C::kStagesA, C::kStagesQ>(
        bars, tiles,
        [&](int t) {  // dY's tile and its scales
          const int s = t % C::kStagesA;
          int b, nn;
          at(t, b, nn);
          hopper::mbar_expect_tx(&bars.full_a[s], C::kABytes + C::kSBytes);
          hopper::tma_load_3d(smem + C::kA + s * C::kABytes, &tm_g,
                              &bars.full_a[s], nn, m0, b);
          hopper::tma_load_3d(smem + C::kS + s * C::kSBytes, &tm_s,
                              &bars.full_a[s], nn, b, 0);
        },
        [&](int t) {
          const int s = t % C::kStagesQ;
          int b, nn;
          at(t, b, nn);
          hopper::mbar_expect_tx(&bars.full_q[s], C::kQBytes);
          hopper::tma_load_3d(smem + C::kQ + s * C::kQBytes, &tm_q,
                              &bars.full_q[s], k0, nn, b);
        });
    return;
  }

  hopper::reg_alloc<kConsumerRegs>();
  const int i = threadIdx.x;
  const int wg = i / 128;
  const uint32_t g_base = hopper::smem_u32(smem + C::kA);
  const uint32_t s_base = hopper::smem_u32(smem + C::kS);
  const uint32_t q_base = hopper::smem_u32(smem + C::kQ);
  const uint32_t w_base = hopper::smem_u32(smem + C::kW);
  auto widen = [&](int t) {
    const int s = t % C::kStagesQ;
    hopper::mbar_wait(&bars.full_q[s], (t / C::kStagesQ) & 1);
    widen_mn_major(q_base + s * C::kQBytes,
                   w_base + (t % kWidened) * C::kWBytes, i);
    hopper::fence_proxy_async_shared();  // the writes, for wgmma's reads
    __syncwarp();
    release(&bars.empty_q[s]);
  };
  widen(0);
  float acc[C::kBN / 2], sum[C::kBN / 2];
  uint32_t frag0[4][4], frag1[4][4];
#pragma unroll
  for (int v = 0; v < C::kBN / 2; ++v) sum[v] = 0.f;
  for (int t0 = 0; t0 < tiles; t0 += C::kFold) {
    const int t1 = min(t0 + C::kFold, tiles);  // t1 - t0 even
    for (int t = t0; t < t1; t += 2) {
      dgrad_tile(bars, acc, frag0, frag1, t, t0, tiles, g_base, s_base,
                 w_base, wg, widen);
      dgrad_tile(bars, acc, frag1, frag0, t + 1, t0, tiles, g_base, s_base,
                 w_base, wg, widen);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_registers(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) hopper::fence_registers(frag1[kk]);
    release(&bars.empty_a[(t1 - 1) % C::kStagesA]);
#pragma unroll
    for (int v = 0; v < C::kBN / 2; ++v) sum[v] += acc[v];
  }

  // Register 4 c + 2 r + j: row 16 (t / 32) + (t % 32) / 4 + 8 r, column
  // 8 c + 2 (t % 4) + j of the warpgroup's 64 x 128 tile of dA, staged in
  // the widened tiles as two swizzled [128 rows][64 columns] boxes once
  // both warpgroups' products are done; TMA writes what lies in bounds.
  hopper::named_barrier_sync(1, kConsumers);
  const int tt = i % 128;
  const int row = wg * 64 + (tt / 32) * 16 + (tt % 32) / 4;
#pragma unroll
  for (int c = 0; c < C::kBN / 8; ++c) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sts32(w_base + (c / 8) * C::kOutBox + (row + 8 * r) * kRow +
                (((c % 8) ^ ((row + 8 * r) & 7)) << 4) + 4 * (tt % 4),
            hopper::pack_bf16(sum[4 * c + 2 * r], sum[4 * c + 2 * r + 1]));
    }
  }
  hopper::fence_proxy_async_shared();  // the writes, for TMA's reads
  hopper::named_barrier_sync(1, kConsumers);
  if (i == 0) {
#pragma unroll
    for (int box = 0; box < C::kBN / 64; ++box) {
      if (k0 + 64 * box < k) {
        hopper::tma_store_3d(&tm_out, smem + C::kW + box * C::kOutBox,
                             k0 + 64 * box, m0, ob);
      }
    }
    hopper::bulk_commit();
    hopper::bulk_wait<0>();
  }
}

// Once per device and kernel: the shared memory it asks for, and a check of
// its launch registers (fewer would leave the consumers' setmaxnreg.inc
// waiting forever for registers the block does not hold).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes, bool* ready) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && ready[device])) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs < kMinLaunchRegs) return cudaErrorInvalidConfiguration;
  if (device < 64) ready[device] = true;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t attributes(Kernel kernel, int bytes, int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = bytes;
  info[3] = kThreads;
  return cudaSuccess;
}

cudaError_t map_3d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                   cuuint64_t d0, cuuint64_t d1, cuuint64_t d2, cuuint64_t s1,
                   cuuint64_t s2, cuuint32_t b0, cuuint32_t b1, cuuint32_t b2,
                   CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, b2};
  return hopper::make_tensor_map(map, base, 3, dims, strides, box, swizzle,
                                 type);
}

}  // namespace

// The forward at rows >= the wrapper's crossover. a: bf16 through a 3D
// tensor map the caller describes, innermost first: dims (k, a_dim1,
// a_dim2), byte strides (a_stride1, a_stride2); a_heads = 1 when dim 1 is
// the batch (the block-diagonal heads: coordinates (k, b, m)), else dim 1
// is m and dim 2 the batch (coordinates (k, m, b), b = 0 with a_shared).
// q: int8 [batches, n, k] with byte strides (q_stride1, q_stride2) of its
// rows and batches, k innermost; scale: fp32 [batches, n]; y: bf16
// [batches, m, n] contiguous. Pointers and strides 16-byte aligned; any k
// (the maps fill the last tile's columns past k with zeros). Returns the
// cudaError_t of the launch.
extern "C" int cg_int8_wgmma_forward(const void* a, const void* q,
                                     const void* scale, void* y, int batches,
                                     int m, int n, int k, long long a_dim1,
                                     long long a_dim2, long long a_stride1,
                                     long long a_stride2, long long q_stride1,
                                     long long q_stride2, int a_heads,
                                     int a_shared, void* stream) {
  if (batches <= 0 || m <= 0 || n <= 0) return cudaSuccess;
  if (k <= 0 || q_stride1 < k || q_stride1 % 16 || q_stride2 % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm_a, tm_q;
  cudaError_t err =
      map_3d(&tm_a, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, a_dim1, a_dim2,
             a_stride1, a_stride2, kBK, a_heads ? 1 : Fwd::kBM,
             a_heads ? Fwd::kBM : 1, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = map_3d(&tm_q, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, n, batches,
                 q_stride1, q_stride2, kBK, Fwd::kBN, 1,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  // The output by TMA when its rows are whole 16-byte units, else by the
  // threads' own stores.
  const int y_tma = n % 8 == 0;
  CUtensorMap tm_y = {};
  if (err == cudaSuccess && y_tma) {
    err = map_3d(&tm_y, y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, n, m, batches,
                 2ull * n, 2ull * n * m, 64, Fwd::kBM, 1,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  }
  static bool ready[64] = {};
  if (err == cudaSuccess) {
    err = prepare(int8_wgmma_forward_kernel, Fwd::kBytes, ready);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + Fwd::kBM - 1) / Fwd::kBM, (n + Fwd::kBN - 1) / Fwd::kBN,
                  batches);
  int8_wgmma_forward_kernel<<<grid, kThreads, Fwd::kBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      tm_a, tm_q, tm_y, static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(y), m, n, k, a_heads, a_shared, y_tma);
  return static_cast<int>(cudaGetLastError());
}

// The input gradient, at every shape. g: bf16 [batches, m, n]
// contiguous (the cotangent of y); q: int8 [batches, n, k] contiguous;
// scale: fp32 [batches, n]; out: bf16 [reduce ? 1 : batches, m, k]
// contiguous; reduce = 1 sums over the batches too. n must be a multiple of
// 8, k of 16; pointers 16-byte aligned. Returns the cudaError_t.
extern "C" int cg_int8_wgmma_dgrad(const void* g, const void* q,
                                   const void* scale, void* out, int batches,
                                   int m, int n, int k, int reduce,
                                   void* stream) {
  if (batches <= 0 || m <= 0 || k <= 0) return cudaSuccess;
  if (n <= 0 || n % 8 || k % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm_g, tm_q, tm_s, tm_out;
  const cuuint64_t mn = static_cast<cuuint64_t>(m) * n;
  cudaError_t err =
      map_3d(&tm_g, g, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, n, m, batches,
             2ull * n, 2 * mn, kBK, Dgrad::kBM, 1, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = map_3d(&tm_q, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, n, batches, k,
                 static_cast<cuuint64_t>(n) * k, Dgrad::kBN, kBK, 1,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess) {
    err = map_3d(&tm_s, scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, n, batches, 1,
                 4ull * n, 4ull * n * batches, kBK, 1, 1,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  const int out_batches = reduce ? 1 : batches;
  if (err == cudaSuccess) {
    err = map_3d(&tm_out, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, m,
                 out_batches, 2ull * k, 2ull * k * m, 64, Dgrad::kBM, 1,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  }
  static bool ready[64] = {};
  if (err == cudaSuccess) {
    err = prepare(int8_wgmma_dgrad_kernel, Dgrad::kBytes, ready);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((k + Dgrad::kBN - 1) / Dgrad::kBN,
                  (m + Dgrad::kBM - 1) / Dgrad::kBM, out_batches);
  int8_wgmma_dgrad_kernel<<<grid, kThreads, Dgrad::kBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      tm_g, tm_q, tm_s, tm_out, batches, m, n, k, reduce ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// A kernel's resources (0: the forward, 1: the input gradient): info =
// {registers a thread, local (spilled) bytes a thread, dynamic shared
// memory bytes a block, threads a block}.
extern "C" int cg_int8_wgmma_attributes(int which, int* info) {
  if (which == 0) {
    return static_cast<int>(
        attributes(int8_wgmma_forward_kernel, Fwd::kBytes, info));
  }
  return static_cast<int>(
      attributes(int8_wgmma_dgrad_kernel, Dgrad::kBytes, info));
}
