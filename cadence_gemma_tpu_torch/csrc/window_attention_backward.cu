// Causal sliding-window multi-query flash attention, backward: two kernels.
//
// Inputs as the forward (csrc/window_attention.cu) saw them -- q [b, t, n, h],
// k and v [b, P + t, 1, h] whose first P = kv_prefix rows precede the
// queries in time (a sequence-parallel shard's halo), segment_pos [b, t] --
// plus the forward's fp32 logsumexp lse [b, n, t], the output cotangent
// dO [b, t, n, h] and delta = rowsum(dO * O) [b, n, t] in fp32. Positions
// are taken in the keys' frame, where query i sits at qp = P + i; key kp is
// visible to it iff
//   max(0, qp - W, qp - segment_pos[i]) <= kp <= qp  (segment_pos[i] >= 0).
// Probabilities are recomputed from the logits and lse, p = exp(s - lse); a
// row that saw no key has lse = 1e30 and no visible key, so its p is 0.
//
//   cg_window_attention_dq:  dq = sum_k ds * k, ds = p (dO.v - delta) scale,
//     streaming the same key band as the forward.
//   cg_window_attention_dkv: dk = sum_{n, q} ds * q and dv = sum_{n, q} p dO,
//     streaming the transposed query band of each key tile and looping over
//     the query heads that share the one key/value head.
//
// Replaces the TPU kernels cadence_gemma_tpu/ops/pallas_attention.py::
// _dq_kernel and ::_dkv_kernel, reached through flash_window_attention's
// backward _bwd -> _flash_window_backward. As there, p is rounded to bf16
// before dv += p^T dO and ds before the dq and dk products, and both
// products accumulate in fp32. The TPU kernel writes dk/dv per head and sums
// the heads outside; here one block loops over the heads and keeps the sum
// in fp32 registers, which needs no n-times larger buffer and rounds to bf16
// once. dk and dv cover all P + t keys: the halo's rows carry the gradient
// back to the shard that sent them, and a halo key no query sees (shard 0's
// zero halo) gets zeros.
//
// What bounds them: tensor-core operations. Per visible (query, key) pair
// and head the dq kernel does 3 products of h multiply-adds (s, dO.v, ds k)
// and the dk/dv kernel 4 (s, dO.v, p dO, ds q), against ~2000 keys per query
// in the 2B's window: far above the H100's ~295 flops per byte. The second
// cost is the L2 traffic of the streamed tiles, which the designs share
// between heads (dq) or keep to one pass per (head, query tile) for 64 keys
// (dk/dv).
//
// Design, both kernels (Hopper: wgmma, TMA, warp specialization, as the
// forward): three warpgroups, two consumers and one producer whose thread
// keeps a ring of TMA loads (128-byte swizzle, 64-column boxes) in flight
// behind full/empty mbarriers; products by wgmma with the score and
// gradient accumulators in registers (setmaxnreg 40 / 232). Descriptors are
// built once a tile and each product adds its offset to the low word (a
// rebuild per product cost ~12 instructions, and dq issues 34 products a
// 32-key tile). Each consumer issues its next score products before it
// waits for its previous gradient product, so the two queue back to back
// on the tensor cores; it releases a stage only after that wait, with no
// product in flight (a release between two waits made ptxas serialize the
// products, C7518). Tiles run in one order and nothing is summed by
// atomics: two launches give the same bits, and a fully masked halo that is
// a multiple of the tiles long leaves every sum as without it.
//
// - dq: a block is one 64-query tile x kGroups = 2 query heads x one batch
//   row; each consumer warpgroup takes one head, and every K/V tile of the
//   ring serves both (the forward's grid). Q and dO of both heads stay in
//   shared memory. S = Q K^T and dP = dO V^T by wgmma from shared memory
//   (both K-major), ds = p (dP - delta) scale formed in registers, and
//   dq += dS K with dS from registers (bf16) and K as the MN-major operand.
//   The two warpgroups take turns to issue their score products (named
//   barriers), so one's ds overlaps the other's products. At head_dim 256
//   the key tiles are 32 wide (m64n32 scores): Q and dO of two heads take
//   128 KB, two 32-key K/V stages 64 KB, and a thread holds dq (128
//   floats), S and dP (16 each) and dS (8). At head_dim 128: 64-key tiles,
//   four stages.
// - dk/dv: a block owns 64 keys of one batch row, K and V resident, and
//   streams (head, query tile) steps: Q and dO tiles through a TMA ring, and
//   each step's lse, delta and row bounds through the same stage, written
//   by a second producer warp. Keys are wgmma's M: warpgroup 0 computes
//   S^T = K Q^T, forms P^T in registers and owns dV += P^T dO; warpgroup 1
//   computes dP^T = V dO^T, reads P^T (fp32, 16 KB) from shared memory
//   behind a named barrier, forms dS^T and owns dK += dS^T Q. P^T and dS^T
//   feed their products from registers, dO and Q as MN-major operands:
//   nothing is transposed through shared memory. At head_dim 256: K and V
//   64 KB, two Q/dO stages 128 KB, P^T 16 KB. A block's query tiles run
//   from max(k0 - P, 0) to W rows past its last key, less P (the TPU
//   kernel's _first_q_block(kv_block, q_offset)); a key tile no query
//   reaches runs no step and writes zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;   // query rows a tile, both kernels
constexpr int kBlockKv = 64;  // key rows a dk/dv block
constexpr int kGroups = 2;    // dq: query heads (consumer warpgroups) a block
constexpr int kThreads = 3 * 128;  // two consumer warpgroups and a producer
// setmaxnreg: the producer warpgroup's registers go to the consumers. The
// block holds kThreads x its launch registers, which must cover both.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMinLaunchRegs =
    (128 * kProducerRegs + 2 * 128 * kConsumerRegs + kThreads - 1) / kThreads;
constexpr int kBoxCols = 64;    // bf16 columns of a 128-byte swizzled row
constexpr int kRowBytes = 128;  // one row of a box
constexpr int kMaxSmem = 232448;
// Named barriers of the two consumer warpgroups (256 threads). dq: turn g
// (ids 1, 2) lets warpgroup g issue its score products. dk/dv: P^T written,
// P^T read.
constexpr int kTurn = 1;
constexpr int kPFull = 1;  // warpgroup 0 has written P^T
constexpr int kPFree = 2;  // warpgroup 1 has read it
constexpr int kPairThreads = 256;

// ---------------------------------------------------------------- products

// Start offset (16-byte units) of step kk of h inside a K-major tile of
// `rows` rows: 32 bytes further inside a 128-byte row, the next box every
// fourth step.
__host__ __device__ constexpr uint32_t k_step(int kk, int rows) {
  return ((kk / 4) * rows * kRowBytes + (kk % 4) * 32) >> 4;
}

// S = A B^T of one score tile (issued, not waited for): A is a 64-row tile
// and B a kN-row tile, both K-major in boxes of 64 columns, h in steps of
// 16. Each descriptor is built once; a step adds its offset to the low word.
template <int H, int kN>
__device__ __forceinline__ void issue_scores(float (&s)[kN / 2],
                                             uint32_t a_base,
                                             uint32_t b_base) {
  const uint32_t a = hopper::desc128_lo(a_base, 16);
  const uint32_t b = hopper::desc128_lo(b_base, 16);
  hopper::fence_registers(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    hopper::wgmma_ss<kN>(s, hopper::desc128(a + k_step(kk, kBlockQ)),
                         hopper::desc128(b + k_step(kk, kN)), kk > 0);
  }
  hopper::wgmma_commit();
  hopper::fence_registers(s);
}

// The dq kernel's two score products of one key tile in one group:
// S = Q K^T and dP = dO V^T.
template <int H, int kN>
__device__ __forceinline__ void issue_score_pair(float (&s)[kN / 2],
                                                 float (&dp)[kN / 2],
                                                 uint32_t q_base,
                                                 uint32_t do_base,
                                                 uint32_t k_base,
                                                 uint32_t v_base) {
  const uint32_t q = hopper::desc128_lo(q_base, 16);
  const uint32_t d_o = hopper::desc128_lo(do_base, 16);
  const uint32_t k = hopper::desc128_lo(k_base, 16);
  const uint32_t v = hopper::desc128_lo(v_base, 16);
  hopper::fence_registers(s);
  hopper::fence_registers(dp);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    const uint32_t a_off = k_step(kk, kBlockQ), b_off = k_step(kk, kN);
    hopper::wgmma_ss<kN>(s, hopper::desc128(q + a_off),
                         hopper::desc128(k + b_off), kk > 0);
    hopper::wgmma_ss<kN>(dp, hopper::desc128(d_o + a_off),
                         hopper::desc128(v + b_off), kk > 0);
  }
  hopper::wgmma_commit();
  hopper::fence_registers(s);
  hopper::fence_registers(dp);
}

// acc[64 x H] += A[64 x kRows] B[kRows x H] (issued, not waited for): A from
// registers in bf16 pairs, B a kRows-row tile as the MN-major operand, in
// steps of 16 rows (16 rows of every box).
template <int H, int kRows>
__device__ __forceinline__ void issue_gradient(float (&acc)[H / 2],
                                               uint32_t (&a)[kRows / 4],
                                               uint32_t b_base) {
  const uint32_t b = hopper::desc128_lo(b_base, kRows * kRowBytes);
  hopper::fence_registers(acc);
  hopper::fence_registers(a);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    hopper::WgmmaRS<H>::mma(acc, a + 4 * kk,
                            hopper::desc128(b + (kk * 16 * kRowBytes >> 4)));
  }
  hopper::wgmma_commit();
  hopper::fence_registers(acc);
}

// Writes a 64-row fp32 accumulator (rows r0 and r0 + 8 of this thread) as
// bf16 rows of `row_stride` elements; only the first `valid` rows.
template <int H>
__device__ __forceinline__ void store_rows(const float (&acc)[H / 2],
                                           __nv_bfloat16* __restrict__ dst,
                                           int64_t row_stride, int r0,
                                           int quad, int valid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= valid) continue;
    __nv_bfloat16* row = dst + r * row_stride + 2 * quad;
#pragma unroll
    for (int c = 0; c < H / 8; ++c) {
      *reinterpret_cast<uint32_t*>(row + 8 * c) =
          hopper::pack_bf16(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------- dq kernel

template <int H>
struct DqConfig {
  static constexpr int kBlockK = H == 256 ? 32 : 64;  // keys a ring tile
  static constexpr int kStages = H == 256 ? 2 : 4;
  static constexpr int kBoxes = H / kBoxCols;
  static constexpr int kQBoxBytes = kBlockQ * kRowBytes;
  static constexpr int kQTileBytes = kBoxes * kQBoxBytes;
  static constexpr int kKBoxBytes = kBlockK * kRowBytes;
  static constexpr int kKTileBytes = kBoxes * kKBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kGroups * kQTileBytes;
  static constexpr int kK = kDo + kGroups * kQTileBytes;
  static constexpr int kV = kK + kStages * kKTileBytes;
  // full[kStages], empty[kStages], q_full[kGroups]
  static constexpr int kBars = kV + kStages * kKTileBytes;
  // Each row's first visible key, then per half-block min and max.
  static constexpr int kBounds = kBars + 8 * (2 * kStages + kGroups);
  // + 1024: the base is aligned up to the 128-byte swizzle's 1 KB period.
  static constexpr int kBytes = kBounds + 4 * (kBlockQ + 4) + 1024;
  static_assert(kBytes <= kMaxSmem, "dq shared memory");
  // A consumer releases a stage one tile late: one stage would deadlock.
  static_assert(kStages >= 2, "dq ring");
};

// One consumer warpgroup of the dq kernel: one head of the block's 64 query
// rows. Per key tile: S and dP, ds in registers, dq += dS K; the stage goes
// back to the producer once the dq product that reads K is done.
template <int H>
__device__ __forceinline__ void dq_consume(
    unsigned char* smem, uint64_t* full, uint64_t* empty, uint64_t* q_full,
    const int* s_lower, int group, int head, int batch, int q0, int q_rows,
    int seq, int heads, int kv_prefix, int kb_first, int num_tiles,
    int lo_max, float scale, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    bool paired) {
  using C = DqConfig<H>;
  constexpr int kN = C::kBlockK;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // rows r0 and r0 + 8
  const int quad = lane % 4;
  const float scale_log2 = scale * hopper::kLog2e;

  int lower[2], diag[2];
  float lse_log2[2], row_delta[2];
  const int64_t stat0 = (static_cast<int64_t>(batch) * heads + head) * seq + q0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    lower[i] = s_lower[r];
    diag[i] = kv_prefix + q0 + r;
    lse_log2[i] = r < q_rows ? lse[stat0 + r] * hopper::kLog2e : 0.f;
    row_delta[i] = r < q_rows ? delta[stat0 + r] : 0.f;
  }
  const int diag_min = kv_prefix + q0;

  float acc[H / 2];  // dq, 64 x H fp32 over the warpgroup
#pragma unroll
  for (int v = 0; v < H / 2; ++v) acc[v] = 0.f;
  float s[kN / 2], dp[kN / 2];
#pragma unroll
  for (int v = 0; v < kN / 2; ++v) s[v] = dp[v] = 0.f;
  uint32_t ds[kN / 4];

  const uint32_t q_base =
      hopper::smem_u32(smem + C::kQ + group * C::kQTileBytes);
  const uint32_t do_base =
      hopper::smem_u32(smem + C::kDo + group * C::kQTileBytes);
  if (num_tiles > 0) hopper::mbar_wait(&q_full[group], 0);
  // With both heads present the warpgroups take turns to issue their score
  // products (ping-pong): the tensor cores run one's while the other forms
  // its ds. Warpgroup 0 goes first.
  if (paired && group == 1 && num_tiles > 0) {
    hopper::named_barrier_arrive(kTurn, kPairThreads);
  }
  for (int i = 0; i < num_tiles; ++i) {
    const int stage = i % C::kStages;
    hopper::mbar_wait(&full[stage], (i / C::kStages) & 1);
    if (paired) hopper::named_barrier_sync(kTurn + group, kPairThreads);
    const uint32_t k_base =
        hopper::smem_u32(smem + C::kK + stage * C::kKTileBytes);
    issue_score_pair<H, kN>(
        s, dp, q_base, do_base, k_base,
        hopper::smem_u32(smem + C::kV + stage * C::kKTileBytes));
    if (paired && !(group == 1 && i + 1 == num_tiles)) {
      hopper::named_barrier_arrive(kTurn + 1 - group, kPairThreads);
    }
    // This tile's scores and the previous tile's dq product are done: the
    // previous stage goes back.
    hopper::wgmma_wait<0>();
    hopper::fence_registers(acc);
    hopper::fence_registers(s);
    hopper::fence_registers(dp);
    if (i > 0 && lane == 0) {
      hopper::mbar_arrive(&empty[(i - 1) % C::kStages]);
    }

    // ds = p (dP - delta) scale where visible; register 4 c + 2 i + j is
    // row r0 + 8 i, key k0 + 8 c + 2 quad + j. Tiles inside [lo_max, the
    // block's first diagonal] need no mask.
    const int k0 = (kb_first + i) * kN;
    const bool unmasked = k0 >= lo_max && k0 + kN - 1 <= diag_min;
    // A masked score goes to exp2(-inf) = 0 by a select, not a branch.
#pragma unroll
    for (int v = 0; v < kN / 2; ++v) {
      const int r = (v >> 1) & 1;
      const int kp = k0 + (v >> 2) * 8 + 2 * quad + (v & 1);
      const bool visible = unmasked || (kp >= lower[r] && kp <= diag[r]);
      const float p = exp2f(
          visible ? fmaf(s[v], scale_log2, -lse_log2[r]) : -INFINITY);
      s[v] = p * (dp[v] - row_delta[r]) * scale;
    }
    hopper::to_bf16(s, ds);
    issue_gradient<H, kN>(acc, ds, k_base);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_registers(acc);
  if (num_tiles > 0 && lane == 0) {
    hopper::mbar_arrive(&empty[(num_tiles - 1) % C::kStages]);
  }

  // Rows that see no key have ds = 0 everywhere and write zeros.
  const int64_t row_stride = static_cast<int64_t>(heads) * H;
  store_rows<H>(acc,
                dq + (static_cast<int64_t>(batch) * seq + q0) * row_stride +
                    static_cast<int64_t>(head) * H,
                row_stride, r0, quad, q_rows);
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
    window_attention_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const int* __restrict__ segment_pos,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dq, int seq,
                               int heads, int window, int kv_prefix,
                               float scale) {
  using C = DqConfig<H>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* empty = full + C::kStages;
  uint64_t* q_full = empty + C::kStages;
  int* s_lower = reinterpret_cast<int*>(smem + C::kBounds);

  // The longest bands first: the last query tile takes block 0.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int head0 = blockIdx.y * kGroups;
  const int batch = blockIdx.z;
  const int groups = min(kGroups, heads - head0);
  const int q_rows = min(kBlockQ, seq - q0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  // Per-row first visible key in the keys' frame, never before key 0;
  // INT_MAX marks a row that sees nothing (left padding, past the end).
  if (tid < kBlockQ) {
    int lower = INT_MAX;
    if (tid < q_rows) {
      const int qp = kv_prefix + q0 + tid;
      const int pos =
          segment_pos[static_cast<int64_t>(batch) * seq + q0 + tid];
      if (pos >= 0) lower = max(0, max(qp - window, qp - pos));
    }
    s_lower[tid] = lower;
    const int lo = __reduce_min_sync(0xffffffff, lower);
    const int hi = __reduce_max_sync(0xffffffff, lower);
    if (tid % 32 == 0) {
      s_lower[kBlockQ + warp] = lo;
      s_lower[kBlockQ + 2 + warp] = hi;
    }
  } else if (tid == kBlockQ) {
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * groups);  // lane 0 of each warp
    }
    for (int g = 0; g < kGroups; ++g) hopper::mbar_init(&q_full[g], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int kv_lo = min(s_lower[kBlockQ], s_lower[kBlockQ + 1]);
  const int lo_max = max(s_lower[kBlockQ + 2], s_lower[kBlockQ + 3]);
  // Key tiles from the first visible key of the block to its diagonal.
  const int kb_first = kv_lo == INT_MAX ? 0 : kv_lo / C::kBlockK;
  const int num_tiles =
      kv_lo == INT_MAX
          ? 0
          : (kv_prefix + q0 + q_rows - 1) / C::kBlockK - kb_first + 1;

  if (warp >= 4 * kGroups) {  // the producer warpgroup
    hopper::reg_dealloc<kProducerRegs>();
    if (tid == 4 * kGroups * 32 && num_tiles > 0) {
      for (int g = 0; g < groups; ++g) {
        hopper::mbar_expect_tx(&q_full[g], 2 * C::kQTileBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          const int col = (head0 + g) * H + c * kBoxCols;
          const int off = g * C::kQTileBytes + c * C::kQBoxBytes;
          hopper::tma_load_3d(smem + C::kQ + off, &tm_q, &q_full[g], col, q0,
                              batch);
          hopper::tma_load_3d(smem + C::kDo + off, &tm_do, &q_full[g], col,
                              q0, batch);
        }
      }
      for (int i = 0; i < num_tiles + C::kStages; ++i) {
        const int stage = i % C::kStages;
        // Wait for the consumers to release this stage's previous tile; the
        // last kStages waits drain the ring before the thread exits.
        hopper::mbar_wait(&empty[stage], ((i / C::kStages) & 1) ^ 1);
        if (i >= num_tiles) continue;
        const int k0 = (kb_first + i) * C::kBlockK;
        hopper::mbar_expect_tx(&full[stage], 2 * C::kKTileBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          const int off = stage * C::kKTileBytes + c * C::kKBoxBytes;
          hopper::tma_load_3d(smem + C::kK + off, &tm_k, &full[stage],
                              c * kBoxCols, k0, batch);
          hopper::tma_load_3d(smem + C::kV + off, &tm_v, &full[stage],
                              c * kBoxCols, k0, batch);
        }
      }
    }
  } else {  // a consumer warpgroup: one head
    hopper::reg_alloc<kConsumerRegs>();
    const int group = warp / 4;
    if (group < groups) {
      dq_consume<H>(smem, full, empty, q_full, s_lower, group, head0 + group,
                    batch, q0, q_rows, seq, heads, kv_prefix, kb_first,
                    num_tiles, lo_max, scale, lse, delta, dq,
                    groups == kGroups);
    }
  }
}

// ------------------------------------------------------------- dk/dv kernel

template <int H>
struct DkvConfig {
  static constexpr int kStages = H == 256 ? 2 : 4;
  static constexpr int kBoxes = H / kBoxCols;
  static constexpr int kBoxBytes = kBlockQ * kRowBytes;  // 64 rows
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTileBytes;
  static constexpr int kQ = kV + kTileBytes;
  static constexpr int kDo = kQ + kStages * kTileBytes;
  // P^T of one step, fp32, in the accumulator's order (16 KB).
  static constexpr int kP = kDo + kStages * kTileBytes;
  // A stage's statistics: lse * log2(e) and delta (fp32) and the first
  // visible key (int32) of its 64 query rows.
  static constexpr int kStats = kP + kBlockKv * kBlockQ * 4;
  static constexpr int kStatBytes = 3 * 4 * kBlockQ;
  // full[kStages], empty[kStages], kv_full
  static constexpr int kBars = kStats + kStages * kStatBytes;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
  static_assert(kBytes <= kMaxSmem, "dk/dv shared memory");
  static_assert(kStages >= 2, "dk/dv ring");
};

// The two consumer warpgroups of the dk/dv kernel on the block's 64 keys
// (rows r0 and r0 + 8 of this thread). Warpgroup 0 (dv): S^T = K Q^T, P^T
// masked in registers and handed over through shared memory, dV += P^T dO.
// Warpgroup 1 (dk): dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale,
// dK += dS^T Q. Both return their fp32 sum over the block's steps.
template <int H, bool kOwnsDv>
__device__ __forceinline__ void dkv_consume(
    unsigned char* smem, uint64_t* full, uint64_t* empty, int k0, int qb_first,
    int q_tiles, int steps, int kv_prefix, float scale, float (&acc)[H / 2]) {
  using C = DkvConfig<H>;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // keys k0 + r0 and + 8
  const int quad = lane % 4;
  const float scale_log2 = scale * hopper::kLog2e;

  float s[32];  // S^T (warpgroup 0) or dP^T (warpgroup 1): 64 keys x 64 rows
#pragma unroll
  for (int v = 0; v < 32; ++v) s[v] = 0.f;
  uint32_t a[16];  // P^T or dS^T in bf16, the gradient product's A operand
  float4* p_buf = reinterpret_cast<float4*>(smem + C::kP);
  // S^T from K, dP^T from V: the resident tile is the A operand.
  const uint32_t kv_base = hopper::smem_u32(smem + (kOwnsDv ? C::kK : C::kV));

  for (int i = 0; i < steps; ++i) {
    const int stage = i % C::kStages;
    hopper::mbar_wait(&full[stage], (i / C::kStages) & 1);
    const uint32_t q_base =
        hopper::smem_u32(smem + C::kQ + stage * C::kTileBytes);
    const uint32_t do_base =
        hopper::smem_u32(smem + C::kDo + stage * C::kTileBytes);
    issue_scores<H, kBlockQ>(s, kv_base, kOwnsDv ? q_base : do_base);
    // This step's scores and the previous step's gradient product are
    // done: the previous stage goes back.
    hopper::wgmma_wait<0>();
    hopper::fence_registers(acc);
    hopper::fence_registers(s);
    if (i > 0 && lane == 0) {
      hopper::mbar_arrive(&empty[(i - 1) % C::kStages]);
    }

    // Register 4 c + 2 i + j is key k0 + r0 + 8 i, query row
    // q0 + 8 c + 2 quad + j of the step's tile.
    const unsigned char* stats = smem + C::kStats + stage * C::kStatBytes;
    if constexpr (kOwnsDv) {
      const float* st_lse = reinterpret_cast<const float*>(stats);
      const int* st_lower = reinterpret_cast<const int*>(stats) + 2 * kBlockQ;
      const int qp0 = kv_prefix + (qb_first + i % q_tiles) * kBlockQ;
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int kp = k0 + r0 + 8 * ((v >> 1) & 1);
        const int col = (v >> 2) * 8 + 2 * quad + (v & 1);
        const float p = exp2f(fmaf(s[v], scale_log2, -st_lse[col]));
        s[v] = kp >= st_lower[col] && kp <= qp0 + col ? p : 0.f;
      }
      // Warpgroup 1 has read the previous step's P^T.
      if (i > 0) hopper::named_barrier_sync(kPFree, kPairThreads);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p_buf[j * 128 + tid] =
            make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      }
      hopper::named_barrier_arrive(kPFull, kPairThreads);
    } else {
      const float* st_delta = reinterpret_cast<const float*>(stats) + kBlockQ;
      hopper::named_barrier_sync(kPFull, kPairThreads);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = p_buf[j * 128 + tid];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int v = 4 * j + e;
          const int col = (v >> 2) * 8 + 2 * quad + (v & 1);
          s[v] = pv[e] * (s[v] - st_delta[col]) * scale;
        }
      }
      if (i + 1 < steps) hopper::named_barrier_arrive(kPFree, kPairThreads);
    }
    hopper::to_bf16(s, a);
    // dV += P^T dO or dK += dS^T Q, the stage's tile as the MN-major B.
    issue_gradient<H, kBlockQ>(acc, a, kOwnsDv ? do_base : q_base);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_registers(acc);
  if (steps > 0 && lane == 0) {
    hopper::mbar_arrive(&empty[(steps - 1) % C::kStages]);
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
    window_attention_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_do,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const int* __restrict__ segment_pos,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int seq,
                                int heads, int window, int kv_prefix,
                                float scale) {
  using C = DkvConfig<H>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* empty = full + C::kStages;
  uint64_t* kv_full = empty + C::kStages;

  const int k0 = blockIdx.x * kBlockKv;
  const int batch = blockIdx.y;
  const int kv_len = kv_prefix + seq;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  // Query tiles that can see a key of this tile: from the tile's diagonal
  // to W rows past its last key, in the queries' frame (P rows earlier). A
  // tile that no query reaches runs no step and writes zeros.
  const int qb_first = max(k0 - kv_prefix, 0) / kBlockQ;
  const int64_t reach =
      static_cast<int64_t>(k0) + kBlockKv - 1 + window - kv_prefix;
  const int64_t q_hi = reach < seq - 1 ? reach : seq - 1;
  const int q_tiles =
      q_hi < 0 ? 0 : static_cast<int>(q_hi / kBlockQ) - qb_first + 1;
  const int steps = heads * q_tiles;  // (head, query tile), heads outer

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      // The TMA thread's arrive and the statistics warp's 32.
      hopper::mbar_init(&full[s], 1 + 32);
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_init(kv_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup
    hopper::reg_dealloc<kProducerRegs>();
    if (warp == 8 && tid % 32 == 0 && steps > 0) {
      hopper::mbar_expect_tx(kv_full, 2 * C::kTileBytes);
      for (int c = 0; c < C::kBoxes; ++c) {
        hopper::tma_load_3d(smem + C::kK + c * C::kBoxBytes, &tm_k, kv_full,
                            c * kBoxCols, k0, batch);
        hopper::tma_load_3d(smem + C::kV + c * C::kBoxBytes, &tm_v, kv_full,
                            c * kBoxCols, k0, batch);
      }
      for (int i = 0; i < steps + C::kStages; ++i) {
        const int stage = i % C::kStages;
        // The last kStages waits drain the ring before the thread exits.
        hopper::mbar_wait(&empty[stage], ((i / C::kStages) & 1) ^ 1);
        if (i >= steps) continue;
        const int head = i / q_tiles;
        const int q0 = (qb_first + i % q_tiles) * kBlockQ;
        hopper::mbar_expect_tx(&full[stage], 2 * C::kTileBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          const int off = stage * C::kTileBytes + c * C::kBoxBytes;
          const int col = head * H + c * kBoxCols;
          hopper::tma_load_3d(smem + C::kQ + off, &tm_q, &full[stage], col, q0,
                              batch);
          hopper::tma_load_3d(smem + C::kDo + off, &tm_do, &full[stage], col,
                              q0, batch);
        }
      }
    } else if (warp == 9) {
      // Each step's statistics, two query rows a lane, into its stage.
      const int lane = tid % 32;
      for (int i = 0; i < steps; ++i) {
        const int stage = i % C::kStages;
        hopper::mbar_wait(&empty[stage], ((i / C::kStages) & 1) ^ 1);
        const int head = i / q_tiles;
        const int q0 = (qb_first + i % q_tiles) * kBlockQ;
        float* st = reinterpret_cast<float*>(smem + C::kStats +
                                             stage * C::kStatBytes);
        int* st_lower = reinterpret_cast<int*>(st) + 2 * kBlockQ;
        for (int r = lane; r < kBlockQ; r += 32) {
          const int q = q0 + r;
          float row_lse = 0.f, row_delta = 0.f;
          int lower = INT_MAX;
          if (q < seq) {
            const int64_t stat =
                (static_cast<int64_t>(batch) * heads + head) * seq + q;
            row_lse = lse[stat] * hopper::kLog2e;
            row_delta = delta[stat];
            const int pos = segment_pos[static_cast<int64_t>(batch) * seq + q];
            const int qp = kv_prefix + q;
            if (pos >= 0) lower = max(0, max(qp - window, qp - pos));
          }
          st[r] = row_lse;
          st[kBlockQ + r] = row_delta;
          st_lower[r] = lower;
        }
        hopper::mbar_arrive(&full[stage]);
      }
    }
  } else {  // the consumer warpgroups: warpgroup 0 owns dV, 1 owns dK
    hopper::reg_alloc<kConsumerRegs>();
    float acc[H / 2];
#pragma unroll
    for (int v = 0; v < H / 2; ++v) acc[v] = 0.f;
    if (steps > 0) hopper::mbar_wait(kv_full, 0);
    if (warp < 4) {
      dkv_consume<H, true>(smem, full, empty, k0, qb_first, q_tiles, steps,
                           kv_prefix, scale, acc);
    } else {
      dkv_consume<H, false>(smem, full, empty, k0, qb_first, q_tiles, steps,
                            kv_prefix, scale, acc);
    }
    const int lane = tid % 32;
    store_rows<H>(acc,
                  (warp < 4 ? dv : dk) +
                      (static_cast<int64_t>(batch) * kv_len + k0) * H,
                  H, ((tid % 128) / 32) * 16 + lane / 4, lane % 4,
                  min(kBlockKv, kv_len - k0));
  }
}

// ------------------------------------------------------------------ host

// Once per device and kernel: the shared memory it asks for, and a check of
// its launch registers (fewer would leave the consumers' setmaxnreg.inc
// waiting forever for registers the block does not hold).
template <typename Kernel>
cudaError_t prepare(Kernel* kernel, int bytes, bool (&ready)[64]) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && ready[device])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs < kMinLaunchRegs) return cudaErrorInvalidConfiguration;
  if (device < 64) ready[device] = true;
  return cudaSuccess;
}

// Tensor maps of q and dO as [b, t, n * h] and of k and v as [b, P + t, h]
// (innermost first), boxes of 64 columns x 64 query rows and 64 columns x
// `key_rows` keys, 128-byte swizzle, zeros out of bounds.
cudaError_t make_maps(CUtensorMap* maps, const void* q, const void* d_out,
                      const void* k, const void* v, int batch, int seq,
                      int heads, int head_dim, int kv_prefix, int key_rows) {
  const cuuint64_t kv_len = static_cast<cuuint64_t>(kv_prefix) + seq;
  const cuuint64_t q_dims[3] = {static_cast<cuuint64_t>(heads) * head_dim,
                                static_cast<cuuint64_t>(seq),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t q_strides[2] = {q_dims[0] * 2, q_dims[0] * 2 * seq};
  const cuuint64_t kv_dims[3] = {static_cast<cuuint64_t>(head_dim), kv_len,
                                 static_cast<cuuint64_t>(batch)};
  const cuuint64_t kv_strides[2] = {kv_dims[0] * 2, kv_dims[0] * 2 * kv_len};
  const cuuint32_t q_box[3] = {kBoxCols, kBlockQ, 1};
  const cuuint32_t kv_box[3] = {kBoxCols, static_cast<cuuint32_t>(key_rows),
                                1};
  const void* bases[4] = {q, d_out, k, v};
  for (int m = 0; m < 4; ++m) {
    const bool query = m < 2;
    const cudaError_t err = hopper::make_tensor_map(
        &maps[m], bases[m], 3, query ? q_dims : kv_dims,
        query ? q_strides : kv_strides, query ? q_box : kv_box,
        CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int H>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const int* segment_pos, const float* lse,
                      const float* delta, const void* d_out, void* dq,
                      int batch, int seq, int heads, int window,
                      int kv_prefix, float scale, cudaStream_t stream) {
  if (batch == 0 || seq == 0 || heads == 0) return cudaSuccess;
  using C = DqConfig<H>;
  static bool ready[64] = {};
  CUtensorMap maps[4];
  cudaError_t err = make_maps(maps, q, d_out, k, v, batch, seq, heads, H,
                              kv_prefix, C::kBlockK);
  if (err == cudaSuccess) {
    err = prepare(window_attention_dq_kernel<H>, C::kBytes, ready);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ,
                  (heads + kGroups - 1) / kGroups, batch);
  window_attention_dq_kernel<H><<<grid, kThreads, C::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], segment_pos, lse, delta,
      static_cast<__nv_bfloat16*>(dq), seq, heads, window, kv_prefix, scale);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const int* segment_pos, const float* lse,
                       const float* delta, const void* d_out, void* dk,
                       void* dv, int batch, int seq, int heads, int window,
                       int kv_prefix, float scale, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(batch) * (kv_prefix + seq) * H * 2;
  if (bytes == 0) return cudaSuccess;
  if (seq == 0 || heads == 0) {  // no query sees the halo: zeros
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, stream);
    return err == cudaSuccess ? cudaMemsetAsync(dv, 0, bytes, stream) : err;
  }
  using C = DkvConfig<H>;
  static bool ready[64] = {};
  CUtensorMap maps[4];
  cudaError_t err = make_maps(maps, q, d_out, k, v, batch, seq, heads, H,
                              kv_prefix, kBlockKv);
  if (err == cudaSuccess) {
    err = prepare(window_attention_dkv_kernel<H>, C::kBytes, ready);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((kv_prefix + seq + kBlockKv - 1) / kBlockKv, batch);
  window_attention_dkv_kernel<H><<<grid, kThreads, C::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], segment_pos, lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), seq,
      heads, window, kv_prefix, scale);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t attributes(Kernel* kernel, int bytes, int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = bytes;
  info[3] = kThreads;
  return cudaSuccess;
}

}  // namespace

// Pointers must be 16-byte aligned and the tensors contiguous; k, v, dk and
// dv hold kv_prefix + seq rows a batch. head_dim is 256 (RecurrentGemma) or
// 128 (Griffin). Each returns the cudaError_t of its launch (0 on success).
extern "C" int cg_window_attention_dq(const void* q, const void* k,
                                      const void* v, const int* segment_pos,
                                      const float* lse, const float* delta,
                                      const void* d_out, void* dq, int batch,
                                      int seq, int heads, int head_dim,
                                      int window, int kv_prefix, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_prefix < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 128:
      return launch_dq<128>(q, k, v, segment_pos, lse, delta, d_out, dq,
                            batch, seq, heads, window, kv_prefix, scale, s);
    case 256:
      return launch_dq<256>(q, k, v, segment_pos, lse, delta, d_out, dq,
                            batch, seq, heads, window, kv_prefix, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int cg_window_attention_dkv(const void* q, const void* k,
                                       const void* v, const int* segment_pos,
                                       const float* lse, const float* delta,
                                       const void* d_out, void* dk, void* dv,
                                       int batch, int seq, int heads,
                                       int head_dim, int window,
                                       int kv_prefix, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_prefix < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 128:
      return launch_dkv<128>(q, k, v, segment_pos, lse, delta, d_out, dk, dv,
                             batch, seq, heads, window, kv_prefix, scale, s);
    case 256:
      return launch_dkv<256>(q, k, v, segment_pos, lse, delta, d_out, dk, dv,
                             batch, seq, heads, window, kv_prefix, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernels' resources at `head_dim`: info = {registers a thread at
// launch, local (spilled) bytes a thread, dynamic shared memory bytes a
// block, threads a block}.
extern "C" int cg_window_attention_dq_attributes(int head_dim, int* info) {
  switch (head_dim) {
    case 128:
      return attributes(window_attention_dq_kernel<128>,
                        DqConfig<128>::kBytes, info);
    case 256:
      return attributes(window_attention_dq_kernel<256>,
                        DqConfig<256>::kBytes, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int cg_window_attention_dkv_attributes(int head_dim, int* info) {
  switch (head_dim) {
    case 128:
      return attributes(window_attention_dkv_kernel<128>,
                        DkvConfig<128>::kBytes, info);
    case 256:
      return attributes(window_attention_dkv_kernel<256>,
                        DkvConfig<256>::kBytes, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
