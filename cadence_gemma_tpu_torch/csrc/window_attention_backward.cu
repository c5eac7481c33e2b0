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
// zero halo) gets zeros. With P = 0 the arithmetic is the same as before
// kv_prefix existed, and so are the bits.
//
// What bounds them: tensor-core operations. Per visible (query, key) pair
// and head the dq kernel does 3 products of h multiply-adds (s, dO.v, ds k)
// and the dk/dv kernel 4 (s, dO.v, p dO, ds q), against ~2000 keys per query
// in the 2B's window: far above the H100's ~295 flops per byte.
//
// Design, both kernels: 8 warps, WMMA bf16 products with fp32 accumulation,
// tiles staged in shared memory (row strides padded against bank conflicts,
// every fragment start 32-byte aligned) and the running gradient sums held
// in WMMA accumulator fragments in registers across the loop. dq: one block
// per (64-row query tile, head, batch). dk/dv: one block per (32-row key
// tile, batch); its 64-row query tiles run from the key tile's diagonal to
// W rows past its end. At head_dim 256 the dq block takes ~175 KB of shared
// memory and the dk/dv block ~126 KB, so one block runs per SM; wgmma, TMA
// and pipelined tile rings are for a later change. With the halo the dk/dv
// grid covers the P + t keys, and a key tile's query tiles run from
// max(k0 - P, 0) to W rows past its end, less P (the TPU kernel's
// _first_q_block(kv_block, q_offset)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 64;   // query rows per tile, both kernels
constexpr int kBlockK = 64;   // key rows per tile, dq kernel
constexpr int kBlockKv = 32;  // key rows per block, dk/dv kernel

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Copies `rows` rows of H bf16 each (global row stride `stride` elements)
// into a shared tile with row stride `ld`; rows at or past `valid` are zero.
template <int H>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int rows,
                                          int valid) {
  constexpr int kVecs = H / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Query i's first visible key in the keys' frame, or INT_MAX if it sees
// none (left padding, or past the end of the sequence).
__device__ __forceinline__ int row_lower(const int* segment_pos, int64_t row0,
                                         int i, int seq, int window,
                                         int kv_prefix) {
  if (i >= seq) return INT_MAX;
  const int pos = segment_pos[row0 + i];
  const int qp = kv_prefix + i;
  return pos < 0 ? INT_MAX : max(0, max(qp - window, qp - pos));
}

// acc[16 x 16] = A[16 x K] . B[K x 16] over K = `depth`, where A is row-major
// at `a` (stride lda) and B is read transposed: B[k][n] = b[n * ldb + k].
template <int kDepth>
__device__ __forceinline__ void mma_abt(FragAcc& acc,
                                        const __nv_bfloat16* a, int lda,
                                        const __nv_bfloat16* b, int ldb) {
  wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
  for (int kk = 0; kk < kDepth; kk += 16) {
    FragA a_frag;
    FragBCol b_frag;
    wmma::load_matrix_sync(a_frag, a + kk, lda);
    wmma::load_matrix_sync(b_frag, b + kk, ldb);
    wmma::mma_sync(acc, a_frag, b_frag, acc);
  }
}

// Writes a [rows x H] fp32 tile from shared memory (stride ld) to bf16 rows
// of global memory with row stride `stride`; only the first `valid` rows.
template <int H>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst,
                                                int64_t stride,
                                                const float* src, int ld,
                                                int valid) {
  constexpr int kVecs = H / 8;
  for (int i = threadIdx.x; i < valid * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    const float* row = src + r * ld + c;
    __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      packed[j] = __floats2bfloat162_rn(row[2 * j], row[2 * j + 1]);
    }
    *reinterpret_cast<uint4*>(dst + r * stride + c) =
        *reinterpret_cast<const uint4*>(packed);
  }
}

// ---------------------------------------------------------------- dq kernel

template <int H>
struct DqLayout {
  static constexpr int kLdQkv = H + 8;      // bf16 q / dO / k / v tiles
  static constexpr int kLdS = kBlockK + 4;  // fp32 s and dO.v
  static constexpr int kLdP = kBlockK + 8;  // bf16 ds
  static constexpr int kLdOut = H + 4;      // fp32 dq, staged for the store

  static constexpr size_t kTile = sizeof(__nv_bfloat16) * 64 * kLdQkv;
  static constexpr size_t kQ = 0;
  static constexpr size_t kDo = kQ + kTile;
  static constexpr size_t kK = kDo + kTile;
  static constexpr size_t kV = kK + kTile;
  static constexpr size_t kS = kV + kTile;
  static constexpr size_t kDp = kS + sizeof(float) * kBlockQ * kLdS;
  static constexpr size_t kDs = kDp + sizeof(float) * kBlockQ * kLdS;
  static constexpr size_t kStats = kDs + sizeof(__nv_bfloat16) * kBlockQ * kLdP;
  // lse, delta (fp32) and the lower bound (int32) of each row, then the
  // block's smallest lower bound.
  static constexpr size_t kBytes = kStats + 3 * sizeof(float) * kBlockQ + 16;
  // The fp32 dq tile reuses the k and v tiles once the loop is done.
  static_assert(sizeof(float) * kBlockQ * kLdOut <= 2 * kTile, "dq staging");
};

template <int H>
__global__ void __launch_bounds__(kThreads)
    window_attention_dq_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const int* __restrict__ segment_pos,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const __nv_bfloat16* __restrict__ d_out,
                               __nv_bfloat16* __restrict__ dq, int seq,
                               int heads, int window, int kv_prefix,
                               float scale) {
  using L = DqLayout<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  __nv_bfloat16* s_do = reinterpret_cast<__nv_bfloat16*>(smem + L::kDo);
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  __nv_bfloat16* s_v = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  float* s_dp = reinterpret_cast<float*>(smem + L::kDp);
  __nv_bfloat16* s_ds = reinterpret_cast<__nv_bfloat16*>(smem + L::kDs);
  float* s_lse = reinterpret_cast<float*>(smem + L::kStats);
  float* s_delta = s_lse + kBlockQ;
  int* s_lower = reinterpret_cast<int*>(s_delta + kBlockQ);
  int& kv_lo = s_lower[kBlockQ];
  float* s_out = reinterpret_cast<float*>(smem + L::kK);  // after the loop

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int q_rows = min(kBlockQ, seq - q0);
  const int kv_len = kv_prefix + seq;

  if (tid == 0) kv_lo = INT_MAX;
  __syncthreads();
  const int64_t stat0 = (static_cast<int64_t>(batch) * heads + head) * seq;
  for (int r = tid; r < kBlockQ; r += kThreads) {
    const int lower = row_lower(segment_pos, static_cast<int64_t>(batch) * seq,
                                q0 + r, seq, window, kv_prefix);
    s_lower[r] = lower;
    s_lse[r] = r < q_rows ? lse[stat0 + q0 + r] : 0.f;
    s_delta[r] = r < q_rows ? delta[stat0 + q0 + r] : 0.f;
    if (lower != INT_MAX) atomicMin(&kv_lo, lower);
  }
  const int64_t q_stride = static_cast<int64_t>(heads) * H;
  const int64_t q_off = (static_cast<int64_t>(batch) * seq + q0) * q_stride +
                        static_cast<int64_t>(head) * H;
  load_tile<H>(s_q, L::kLdQkv, q + q_off, q_stride, kBlockQ, q_rows);
  load_tile<H>(s_do, L::kLdQkv, d_out + q_off, q_stride, kBlockQ, q_rows);
  __syncthreads();

  // dq accumulators: 4 x (H / 16) fragments; warp w owns row (w % 4) and
  // half of the columns.
  constexpr int kColFrags = H / 16 / 2;
  const int acc_row = warp % 4;
  const int acc_col0 = (warp / 4) * kColFrags;
  FragAcc acc[kColFrags];
#pragma unroll
  for (int j = 0; j < kColFrags; ++j) wmma::fill_fragment(acc[j], 0.f);

  const __nv_bfloat16* k_b = k + static_cast<int64_t>(batch) * kv_len * H;
  const __nv_bfloat16* v_b = v + static_cast<int64_t>(batch) * kv_len * H;
  // Key tiles from the block's first visible key to its diagonal.
  const int kb_first = kv_lo == INT_MAX ? 1 : kv_lo / kBlockK;
  const int kb_last =
      kv_lo == INT_MAX ? 0 : (kv_prefix + q0 + q_rows - 1) / kBlockK;

  // Elementwise split: 4 threads per row, 16 columns each.
  const int ew_row = tid / 4;
  const int ew_col = (tid % 4) * 16;

  for (int kb = kb_first; kb <= kb_last; ++kb) {
    const int k0 = kb * kBlockK;
    const int k_rows = min(kBlockK, kv_len - k0);
    load_tile<H>(s_k, L::kLdQkv, k_b + static_cast<int64_t>(k0) * H, H,
                 kBlockK, k_rows);
    load_tile<H>(s_v, L::kLdQkv, v_b + static_cast<int64_t>(k0) * H, H,
                 kBlockK, k_rows);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, 4 x 4 fragments each; warp w owns row
    // (w / 2) and the two columns 2 * (w % 2) + {0, 1} of both.
    {
      const int fr = warp / 2;
      const int fc0 = (warp % 2) * 2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int fc = fc0 + j;
        FragAcc s_frag;
        mma_abt<H>(s_frag, s_q + fr * 16 * L::kLdQkv, L::kLdQkv,
                   s_k + fc * 16 * L::kLdQkv, L::kLdQkv);
        wmma::store_matrix_sync(s_s + fr * 16 * L::kLdS + fc * 16, s_frag,
                                L::kLdS, wmma::mem_row_major);
        mma_abt<H>(s_frag, s_do + fr * 16 * L::kLdQkv, L::kLdQkv,
                   s_v + fc * 16 * L::kLdQkv, L::kLdQkv);
        wmma::store_matrix_sync(s_dp + fr * 16 * L::kLdS + fc * 16, s_frag,
                                L::kLdS, wmma::mem_row_major);
      }
    }
    __syncthreads();

    // ds = p (dp - delta) scale, p = exp(s scale - lse) where visible.
    {
      const int qp = kv_prefix + q0 + ew_row;
      const int lower = s_lower[ew_row];
      const float row_lse = s_lse[ew_row];
      const float row_delta = s_delta[ew_row];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = ew_col + j;
        const int kp = k0 + c;
        float ds = 0.f;
        if (kp >= lower && kp <= qp) {
          const float p = expf(s_s[ew_row * L::kLdS + c] * scale - row_lse);
          ds = p * (s_dp[ew_row * L::kLdS + c] - row_delta) * scale;
        }
        s_ds[ew_row * L::kLdP + c] = __float2bfloat16_rn(ds);
      }
    }
    __syncthreads();

    // dq += ds K.
#pragma unroll
    for (int kk = 0; kk < kBlockK; kk += 16) {
      FragA a_frag;
      wmma::load_matrix_sync(a_frag, s_ds + acc_row * 16 * L::kLdP + kk,
                             L::kLdP);
#pragma unroll
      for (int j = 0; j < kColFrags; ++j) {
        FragBRow b_frag;
        wmma::load_matrix_sync(
            b_frag, s_k + kk * L::kLdQkv + (acc_col0 + j) * 16, L::kLdQkv);
        wmma::mma_sync(acc[j], a_frag, b_frag, acc[j]);
      }
    }
    __syncthreads();
  }

  // Stage the fp32 sums in the (now free) k/v tiles and write bf16 rows.
#pragma unroll
  for (int j = 0; j < kColFrags; ++j) {
    wmma::store_matrix_sync(
        s_out + acc_row * 16 * L::kLdOut + (acc_col0 + j) * 16, acc[j],
        L::kLdOut, wmma::mem_row_major);
  }
  __syncthreads();
  store_rows_bf16<H>(dq + q_off, q_stride, s_out, L::kLdOut, q_rows);
}

// ------------------------------------------------------------- dk/dv kernel

template <int H>
struct DkvLayout {
  static constexpr int kLdQkv = H + 8;       // bf16 q / dO / k / v tiles
  static constexpr int kLdS = kBlockQ + 4;   // fp32 s^T and (dO.v)^T
  static constexpr int kLdP = kBlockQ + 8;   // bf16 p^T and ds^T
  static constexpr int kLdOut = H + 4;       // fp32 dk / dv, staged

  static constexpr size_t kQ = 0;
  static constexpr size_t kDo = kQ + sizeof(__nv_bfloat16) * kBlockQ * kLdQkv;
  static constexpr size_t kK = kDo + sizeof(__nv_bfloat16) * kBlockQ * kLdQkv;
  static constexpr size_t kV = kK + sizeof(__nv_bfloat16) * kBlockKv * kLdQkv;
  static constexpr size_t kS = kV + sizeof(__nv_bfloat16) * kBlockKv * kLdQkv;
  static constexpr size_t kDp = kS + sizeof(float) * kBlockKv * kLdS;
  static constexpr size_t kP = kDp + sizeof(float) * kBlockKv * kLdS;
  static constexpr size_t kDs = kP + sizeof(__nv_bfloat16) * kBlockKv * kLdP;
  static constexpr size_t kStats = kDs + sizeof(__nv_bfloat16) * kBlockKv * kLdP;
  // lse, delta (fp32) and the lower bound (int32) of each query row.
  static constexpr size_t kBytes = kStats + 3 * sizeof(float) * kBlockQ;
  // The fp32 dk and dv tiles reuse the q and dO tiles after the loop.
  static_assert(2 * sizeof(float) * kBlockKv * kLdOut <= kK, "dk/dv staging");
};

template <int H>
__global__ void __launch_bounds__(kThreads)
    window_attention_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const int* __restrict__ segment_pos,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                const __nv_bfloat16* __restrict__ d_out,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int seq,
                                int heads, int window, int kv_prefix,
                                float scale) {
  using L = DkvLayout<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  __nv_bfloat16* s_do = reinterpret_cast<__nv_bfloat16*>(smem + L::kDo);
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  __nv_bfloat16* s_v = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);
  float* s_st = reinterpret_cast<float*>(smem + L::kS);
  float* s_dpt = reinterpret_cast<float*>(smem + L::kDp);
  __nv_bfloat16* s_pt = reinterpret_cast<__nv_bfloat16*>(smem + L::kP);
  __nv_bfloat16* s_dst = reinterpret_cast<__nv_bfloat16*>(smem + L::kDs);
  float* s_lse = reinterpret_cast<float*>(smem + L::kStats);
  float* s_delta = s_lse + kBlockQ;
  int* s_lower = reinterpret_cast<int*>(s_delta + kBlockQ);
  float* s_dk_out = reinterpret_cast<float*>(smem + L::kQ);  // after the loop
  float* s_dv_out = s_dk_out + kBlockKv * L::kLdOut;

  const int k0 = blockIdx.x * kBlockKv;
  const int batch = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int kv_len = kv_prefix + seq;
  const int k_rows = min(kBlockKv, kv_len - k0);

  const __nv_bfloat16* k_b = k + static_cast<int64_t>(batch) * kv_len * H;
  const __nv_bfloat16* v_b = v + static_cast<int64_t>(batch) * kv_len * H;
  load_tile<H>(s_k, L::kLdQkv, k_b + static_cast<int64_t>(k0) * H, H,
               kBlockKv, k_rows);
  load_tile<H>(s_v, L::kLdQkv, v_b + static_cast<int64_t>(k0) * H, H,
               kBlockKv, k_rows);

  // Accumulators: dk and dv are 2 x (H / 16) fragments each. Warps 0-3 own
  // dk, warps 4-7 dv; within each group warp w owns row (w % 2) and half
  // of the columns.
  constexpr int kColFrags = H / 16 / 2;
  const bool owns_dv = warp >= 4;
  const int acc_row = warp % 2;
  const int acc_col0 = ((warp / 2) % 2) * kColFrags;
  FragAcc acc[kColFrags];
#pragma unroll
  for (int j = 0; j < kColFrags; ++j) wmma::fill_fragment(acc[j], 0.f);

  // Query tiles that can see a key of this tile: from the tile's diagonal
  // to W rows past its last key, in the queries' frame (P rows earlier). A
  // tile that no query reaches runs no step and writes zeros.
  const int qb_first = max(k0 - kv_prefix, 0) / kBlockQ;
  const int q_hi = min(seq - 1, k0 + kBlockKv - 1 + window - kv_prefix);
  const int qb_last = q_hi < 0 ? -1 : q_hi / kBlockQ;
  const int64_t q_stride = static_cast<int64_t>(heads) * H;

  // Elementwise split over the [32 keys x 64 queries] tile: 8 threads per
  // key row, 8 query columns each.
  const int ew_row = tid / 8;
  const int ew_col = (tid % 8) * 8;

  for (int head = 0; head < heads; ++head) {
    const int64_t stat0 = (static_cast<int64_t>(batch) * heads + head) * seq;
    for (int qb = qb_first; qb <= qb_last; ++qb) {
      const int q0 = qb * kBlockQ;
      const int q_rows = min(kBlockQ, seq - q0);
      __syncthreads();  // the previous step is done with q, dO and stats
      for (int r = tid; r < kBlockQ; r += kThreads) {
        s_lower[r] = row_lower(segment_pos,
                               static_cast<int64_t>(batch) * seq, q0 + r, seq,
                               window, kv_prefix);
        s_lse[r] = r < q_rows ? lse[stat0 + q0 + r] : 0.f;
        s_delta[r] = r < q_rows ? delta[stat0 + q0 + r] : 0.f;
      }
      const int64_t q_off =
          (static_cast<int64_t>(batch) * seq + q0) * q_stride +
          static_cast<int64_t>(head) * H;
      load_tile<H>(s_q, L::kLdQkv, q + q_off, q_stride, kBlockQ, q_rows);
      load_tile<H>(s_do, L::kLdQkv, d_out + q_off, q_stride, kBlockQ,
                   q_rows);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, [32 x 64] = 2 x 4 fragments each;
      // warp w owns row (w / 4) and column (w % 4) of both.
      {
        const int fr = warp / 4;
        const int fc = warp % 4;
        FragAcc frag;
        mma_abt<H>(frag, s_k + fr * 16 * L::kLdQkv, L::kLdQkv,
                   s_q + fc * 16 * L::kLdQkv, L::kLdQkv);
        wmma::store_matrix_sync(s_st + fr * 16 * L::kLdS + fc * 16, frag,
                                L::kLdS, wmma::mem_row_major);
        mma_abt<H>(frag, s_v + fr * 16 * L::kLdQkv, L::kLdQkv,
                   s_do + fc * 16 * L::kLdQkv, L::kLdQkv);
        wmma::store_matrix_sync(s_dpt + fr * 16 * L::kLdS + fc * 16, frag,
                                L::kLdS, wmma::mem_row_major);
      }
      __syncthreads();

      // p^T and ds^T where key kp is visible to query qp.
      {
        const int kp = k0 + ew_row;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = ew_col + j;
          const int qp = kv_prefix + q0 + c;
          float p = 0.f;
          float ds = 0.f;
          if (kp >= s_lower[c] && kp <= qp) {
            p = expf(s_st[ew_row * L::kLdS + c] * scale - s_lse[c]);
            ds = p * (s_dpt[ew_row * L::kLdS + c] - s_delta[c]) * scale;
          }
          s_pt[ew_row * L::kLdP + c] = __float2bfloat16_rn(p);
          s_dst[ew_row * L::kLdP + c] = __float2bfloat16_rn(ds);
        }
      }
      __syncthreads();

      // dv += p^T dO (warps 4-7), dk += ds^T Q (warps 0-3).
      {
        const __nv_bfloat16* a_tile = owns_dv ? s_pt : s_dst;
        const __nv_bfloat16* b_tile = owns_dv ? s_do : s_q;
#pragma unroll
        for (int kk = 0; kk < kBlockQ; kk += 16) {
          FragA a_frag;
          wmma::load_matrix_sync(a_frag, a_tile + acc_row * 16 * L::kLdP + kk,
                                 L::kLdP);
#pragma unroll
          for (int j = 0; j < kColFrags; ++j) {
            FragBRow b_frag;
            wmma::load_matrix_sync(
                b_frag, b_tile + kk * L::kLdQkv + (acc_col0 + j) * 16,
                L::kLdQkv);
            wmma::mma_sync(acc[j], a_frag, b_frag, acc[j]);
          }
        }
      }
    }
  }
  __syncthreads();

  // Stage the fp32 sums in the (now free) q and dO tiles, write bf16 rows.
  float* s_acc_out = owns_dv ? s_dv_out : s_dk_out;
#pragma unroll
  for (int j = 0; j < kColFrags; ++j) {
    wmma::store_matrix_sync(
        s_acc_out + acc_row * 16 * L::kLdOut + (acc_col0 + j) * 16, acc[j],
        L::kLdOut, wmma::mem_row_major);
  }
  __syncthreads();
  const int64_t kv_off = (static_cast<int64_t>(batch) * kv_len + k0) * H;
  store_rows_bf16<H>(dk + kv_off, H, s_dk_out, L::kLdOut, k_rows);
  store_rows_bf16<H>(dv + kv_off, H, s_dv_out, L::kLdOut, k_rows);
}

template <int H>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const int* segment_pos, const float* lse,
                      const float* delta, const void* d_out, void* dq,
                      int batch, int seq, int heads, int window,
                      int kv_prefix, float scale, cudaStream_t stream) {
  if (batch == 0 || seq == 0 || heads == 0) return cudaSuccess;
  constexpr size_t kSmem = DqLayout<H>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_dq_kernel<H>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  window_attention_dq_kernel<H><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), segment_pos, lse, delta,
      static_cast<const __nv_bfloat16*>(d_out),
      static_cast<__nv_bfloat16*>(dq), seq, heads, window, kv_prefix, scale);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const int* segment_pos, const float* lse,
                       const float* delta, const void* d_out, void* dk,
                       void* dv, int batch, int seq, int heads, int window,
                       int kv_prefix, float scale, cudaStream_t stream) {
  if (batch == 0 || kv_prefix + seq == 0) return cudaSuccess;
  constexpr size_t kSmem = DkvLayout<H>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_dkv_kernel<H>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((kv_prefix + seq + kBlockKv - 1) / kBlockKv, batch);
  window_attention_dkv_kernel<H><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), segment_pos, lse, delta,
      static_cast<const __nv_bfloat16*>(d_out),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), seq,
      heads, window, kv_prefix, scale);
  return cudaGetLastError();
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
