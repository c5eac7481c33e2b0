// Causal sliding-window multi-query flash attention, forward (prefill).
//
// q [b, t, n, h], k and v [b, P + t, 1, h] in bf16, where the first P =
// kv_prefix keys and values precede the queries in time (a sequence-parallel
// shard's halo: the previous shard's last keys); out [b, t, n, h] in bf16 and
// the fp32 logsumexp lse [b, n, t]. Positions are taken in the keys' frame,
// where query i sits at qp = P + i. Key kp is visible to query i iff
//   max(0, qp - W, qp - segment_pos[i]) <= kp <= qp,
// i.e. inside the window and inside the query's document. Rows with
// segment_pos < 0 (left padding) output zeros and lse = 1e30. Scores are
// scaled by `scale` (head_dim ** -0.5); softmax statistics and the output
// accumulator are fp32. With P = 0 the arithmetic is the same as before
// kv_prefix existed, and so are the bits.
//
// Replaces the TPU kernel cadence_gemma_tpu/ops/pallas_attention.py::
// _attn_kernel, reached through flash_window_attention ->
// _flash_window_forward, with and without its kv_prefix (q_offset) halo.
// The backward kernels are in window_attention_backward.cu.
//
// What bounds it: at the 2B's head_dim 256 and window 2048 the band holds
// ~2000 keys per query, so the two products QK^T and PV do ~1000 flops per
// byte of q, k, v and out -- far above the card's ~295 flops per byte. It is
// bound by tensor-core operations.
//
// Design: one block of 8 warps per (q tile of 64 rows, head, batch). The
// block loops only over the 64-key tiles of its band: from the smallest
// per-row lower bound of its rows (computed here from segment_pos, so a
// tile of left padding or a fresh document skips keys it cannot see) to its
// diagonal. QK^T and PV run on the tensor cores through WMMA (bf16 inputs,
// fp32 accumulation); the online softmax keeps the running max, the
// normalizer and the output accumulator of its 64 rows in shared memory, as
// the TPU kernel kept them in VMEM scratch. At head_dim 256 the q, k and v
// tiles and the fp32 accumulator take ~190 KB of shared memory, so one block
// runs per SM; wgmma, TMA and a pipelined ring of K/V tiles are for a later
// change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kMaskedLse = 1e30f;

template <int H>
struct Layout {
  // Row strides padded so WMMA loads do not hit the same bank on every row;
  // every fragment start stays 32-byte aligned.
  static constexpr int kLdQkv = H + 8;      // bf16 q / k / v tiles
  static constexpr int kLdS = kBlockK + 4;  // fp32 scores
  static constexpr int kLdP = kBlockK + 8;  // bf16 probabilities
  static constexpr int kLdO = H + 4;        // fp32 output accumulator

  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(__nv_bfloat16) * kBlockQ * kLdQkv;
  static constexpr size_t kV = kK + sizeof(__nv_bfloat16) * kBlockK * kLdQkv;
  static constexpr size_t kS = kV + sizeof(__nv_bfloat16) * kBlockK * kLdQkv;
  static constexpr size_t kP = kS + sizeof(float) * kBlockQ * kLdS;
  static constexpr size_t kO = kP + sizeof(__nv_bfloat16) * kBlockQ * kLdP;
  static constexpr size_t kStats = kO + sizeof(float) * kBlockQ * kLdO;
  // m, l, correction (fp32) and the lower bound (int32) of each row, then
  // the block's smallest lower bound.
  static constexpr size_t kBytes = kStats + 4 * sizeof(float) * kBlockQ + 16;
};

// Copies `rows` rows of h bf16 each (global row stride `stride` elements)
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

template <int H>
__global__ void __launch_bounds__(kThreads)
    window_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const int* __restrict__ segment_pos,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int seq, int heads,
                            int window, int kv_prefix, float scale) {
  using L = Layout<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  __nv_bfloat16* s_v = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  __nv_bfloat16* s_p = reinterpret_cast<__nv_bfloat16*>(smem + L::kP);
  float* s_o = reinterpret_cast<float*>(smem + L::kO);
  float* s_m = reinterpret_cast<float*>(smem + L::kStats);
  float* s_l = s_m + kBlockQ;
  float* s_corr = s_l + kBlockQ;
  int* s_lower = reinterpret_cast<int*>(s_corr + kBlockQ);
  int& kv_lo = s_lower[kBlockQ];

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int q_rows = min(kBlockQ, seq - q0);
  const int kv_len = kv_prefix + seq;

  if (tid == 0) kv_lo = INT_MAX;
  __syncthreads();
  // Per-row first visible key in the keys' frame, never before key 0
  // (positions need not start at 0 when no cache precedes them); INT_MAX
  // marks a row that sees nothing. A shard's halo is masked for a row whose
  // document starts inside the shard, by the same bound.
  for (int r = tid; r < kBlockQ; r += kThreads) {
    int lower = INT_MAX;
    if (r < q_rows) {
      const int qp = kv_prefix + q0 + r;
      const int pos = segment_pos[static_cast<int64_t>(batch) * seq + q0 + r];
      if (pos >= 0) lower = max(0, max(qp - window, qp - pos));
    }
    s_lower[r] = lower;
    s_m[r] = -INFINITY;
    s_l[r] = 0.f;
    if (lower != INT_MAX) atomicMin(&kv_lo, lower);
  }
  for (int i = tid; i < kBlockQ * L::kLdO; i += kThreads) s_o[i] = 0.f;

  const int64_t q_stride = static_cast<int64_t>(heads) * H;
  load_tile<H>(s_q, L::kLdQkv,
               q + (static_cast<int64_t>(batch) * seq + q0) * q_stride +
                   static_cast<int64_t>(head) * H,
               q_stride, kBlockQ, q_rows);
  __syncthreads();

  const __nv_bfloat16* k_b = k + static_cast<int64_t>(batch) * kv_len * H;
  const __nv_bfloat16* v_b = v + static_cast<int64_t>(batch) * kv_len * H;
  // Key tiles from the first visible key of the block to its diagonal.
  const int kb_first = kv_lo == INT_MAX ? 1 : kv_lo / kBlockK;
  const int kb_last =
      kv_lo == INT_MAX ? 0 : (kv_prefix + q0 + q_rows - 1) / kBlockK;

  // Softmax work split: 4 threads per row, 16 columns each.
  const int sm_row = tid / 4;
  const int sm_col = (tid % 4) * 16;

  for (int kb = kb_first; kb <= kb_last; ++kb) {
    const int k0 = kb * kBlockK;
    const int k_rows = min(kBlockK, kv_len - k0);
    load_tile<H>(s_k, L::kLdQkv, k_b + static_cast<int64_t>(k0) * H, H,
                 kBlockK, k_rows);
    load_tile<H>(s_v, L::kLdQkv, v_b + static_cast<int64_t>(k0) * H, H,
                 kBlockK, k_rows);
    __syncthreads();

    // S = Q K^T: 4x4 fragments of 16x16; warp w owns row (w / 2) and the
    // two columns 2 * (w % 2) + {0, 1}.
    {
      const int fr = warp / 2;
      const int fc0 = (warp % 2) * 2;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
      wmma::fill_fragment(acc[0], 0.f);
      wmma::fill_fragment(acc[1], 0.f);
#pragma unroll 4
      for (int kk = 0; kk < H; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a_frag;
        wmma::load_matrix_sync(a_frag, s_q + fr * 16 * L::kLdQkv + kk,
                               L::kLdQkv);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major>
              b_frag;
          wmma::load_matrix_sync(b_frag,
                                 s_k + (fc0 + j) * 16 * L::kLdQkv + kk,
                                 L::kLdQkv);
          wmma::mma_sync(acc[j], a_frag, b_frag, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(s_s + fr * 16 * L::kLdS + (fc0 + j) * 16,
                                acc[j], L::kLdS, wmma::mem_row_major);
      }
    }
    __syncthreads();

    // Online softmax over this tile's 64 columns.
    {
      const int qp = kv_prefix + q0 + sm_row;
      const int lower = s_lower[sm_row];
      float sv[16];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kp = k0 + sm_col + j;
        const bool visible = kp >= lower && kp <= qp;
        sv[j] = visible ? s_s[sm_row * L::kLdS + sm_col + j] * scale
                        : -INFINITY;
        mx = fmaxf(mx, sv[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      const float m_prev = s_m[sm_row];
      const float m_new = fmaxf(m_prev, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = sv[j] == -INFINITY ? 0.f : expf(sv[j] - m_use);
        sum += p;
        s_p[sm_row * L::kLdP + sm_col + j] = __float2bfloat16_rn(p);
      }
      sum += __shfl_xor_sync(0xffffffff, sum, 1);
      sum += __shfl_xor_sync(0xffffffff, sum, 2);
      if (tid % 4 == 0) {
        const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_use);
        s_m[sm_row] = m_new;
        s_l[sm_row] = s_l[sm_row] * corr + sum;
        s_corr[sm_row] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < kBlockQ * H; i += kThreads) {
      const int r = i / H;
      s_o[r * L::kLdO + i % H] *= s_corr[r];
    }
    __syncthreads();

    // O += P V: 4 x (H / 16) fragments; warp w owns row (w % 4) and half of
    // the columns.
    {
      constexpr int kColFrags = H / 16 / 2;
      const int fr = warp % 4;
      const int fc0 = (warp / 4) * kColFrags;
      for (int j = 0; j < kColFrags; ++j) {
        const int fc = fc0 + j;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        float* o_ptr = s_o + fr * 16 * L::kLdO + fc * 16;
        wmma::load_matrix_sync(acc, o_ptr, L::kLdO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kBlockK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              a_frag;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              b_frag;
          wmma::load_matrix_sync(a_frag, s_p + fr * 16 * L::kLdP + kk,
                                 L::kLdP);
          wmma::load_matrix_sync(b_frag, s_v + kk * L::kLdQkv + fc * 16,
                                 L::kLdQkv);
          wmma::mma_sync(acc, a_frag, b_frag, acc);
        }
        wmma::store_matrix_sync(o_ptr, acc, L::kLdO, wmma::mem_row_major);
      }
    }
    __syncthreads();
  }

  // Normalize and write out; rows that saw no key have l == 0 and acc == 0.
  constexpr int kVecs = H / 8;
  for (int i = tid; i < q_rows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    const float l = s_l[r];
    const float denom = l == 0.f ? 1.f : l;
    const float* o_row = s_o + r * L::kLdO + c;
    __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      packed[j] = __floats2bfloat162_rn(o_row[2 * j] / denom,
                                        o_row[2 * j + 1] / denom);
    }
    *reinterpret_cast<uint4*>(
        out + (static_cast<int64_t>(batch) * seq + q0 + r) * q_stride +
        static_cast<int64_t>(head) * H + c) =
        *reinterpret_cast<const uint4*>(packed);
  }
  for (int r = tid; r < q_rows; r += kThreads) {
    const float l = s_l[r];
    const float m = s_m[r] == -INFINITY ? 0.f : s_m[r];
    lse[(static_cast<int64_t>(batch) * heads + head) * seq + q0 + r] =
        l == 0.f ? kMaskedLse : m + logf(l);
  }
}

template <int H>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* segment_pos, void* out, float* lse, int batch,
                   int seq, int heads, int window, int kv_prefix, float scale,
                   cudaStream_t stream) {
  if (batch == 0 || seq == 0 || heads == 0) return cudaSuccess;
  constexpr size_t kSmem = Layout<H>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  window_attention_kernel<H><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), segment_pos,
      static_cast<__nv_bfloat16*>(out), lse, seq, heads, window, kv_prefix,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Pointers must be 16-byte aligned and the tensors contiguous; k and v hold
// kv_prefix + seq rows a batch. head_dim is one the presets use: 256
// (RecurrentGemma) or 128 (Griffin). Returns the cudaError_t of the launch
// (0 on success).
extern "C" int cg_window_attention_forward(const void* q, const void* k,
                                           const void* v,
                                           const int* segment_pos, void* out,
                                           float* lse, int batch, int seq,
                                           int heads, int head_dim, int window,
                                           int kv_prefix, float scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_prefix < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 128:
      return launch<128>(q, k, v, segment_pos, out, lse, batch, seq, heads,
                         window, kv_prefix, scale, s);
    case 256:
      return launch<256>(q, k, v, segment_pos, out, lse, batch, seq, heads,
                         window, kv_prefix, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
