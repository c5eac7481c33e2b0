// Bidirectional multi-head flash attention, forward (the vision towers).
//
// q, k, v [b, t, n, h] in bf16, each row of h values dense, rows t and
// batches b apart by the given strides (so the three thirds of a fused qkv
// projection are read in place); out [b, t, n, h] bf16, contiguous. Every
// query sees every key of its (batch, head); keys at or past t are masked.
// Scores are scaled by `scale` (the real head_dim ** -0.5); softmax
// statistics and the output accumulator are fp32, the unnormalized
// probabilities are rounded to bf16 before PV.
//
// Replaces the TPU kernels cadence_gemma_tpu/ops/pallas_attention.py::
// _mha_onepass_kernel (whole sequence per (batch, head), t_pad <= 1024) and
// _mha_kernel (tiled online softmax, longer sequences), both reached through
// flash_mha_attention -> _flash_mha_forward. The two compute one function;
// on the TPU they differ only in how much of a head's [t, t] logits fit in
// VMEM. One online-softmax loop over 64-key tiles covers every t here.
//
// What bounds it: at the towers' shapes (t = 729 or 734, head_dim 64 or 72)
// QK^T and PV do 4 t h flops per query row against 8 h bytes of q, k, v and
// out per token -- about t / 2 ~ 360 flops per byte, above the card's ~295:
// bound by tensor-core operations, though not by much.
//
// Design: one block of 8 warps per (64-query tile, head, batch) loops over
// all 64-key tiles, as the window-attention kernel loops over its band. QK^T
// and PV
// run on the tensor cores through WMMA (bf16 inputs, fp32 accumulation). The
// head dim is zero-padded in shared memory to a multiple of 16 (SigLIP's 72
// to 80): zero columns change neither QK^T nor PV, and only the real columns
// are written. Query rows past t are zero, take a harmless uniform softmax
// and are not written. About 83 KB of shared memory at head_dim 72, so two
// blocks share an SM; wgmma, TMA and a ring of K/V tiles are for a later
// change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// HP: the head dim padded to a multiple of 16.
template <int HP>
struct Layout {
  // Row strides padded so WMMA loads do not hit the same bank on every row;
  // every fragment start stays 32-byte aligned.
  static constexpr int kLdQkv = HP + 8;     // bf16 q / k / v tiles
  static constexpr int kLdS = kBlockK + 4;  // fp32 scores
  static constexpr int kLdP = kBlockK + 8;  // bf16 probabilities
  static constexpr int kLdO = HP + 4;       // fp32 output accumulator

  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(__nv_bfloat16) * kBlockQ * kLdQkv;
  static constexpr size_t kV = kK + sizeof(__nv_bfloat16) * kBlockK * kLdQkv;
  static constexpr size_t kS = kV + sizeof(__nv_bfloat16) * kBlockK * kLdQkv;
  static constexpr size_t kP = kS + sizeof(float) * kBlockQ * kLdS;
  static constexpr size_t kO = kP + sizeof(__nv_bfloat16) * kBlockQ * kLdP;
  static constexpr size_t kStats = kO + sizeof(float) * kBlockQ * kLdO;
  // m, l and the correction of each row (fp32).
  static constexpr size_t kBytes = kStats + 3 * sizeof(float) * kBlockQ;
};

// Copies 64 rows of head_dim bf16 each (global row stride `stride`
// elements) into a shared tile of HP columns with row stride HP + 8; rows
// at or past `valid` and columns at or past head_dim are zero.
template <int HP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int valid,
                                          int head_dim) {
  constexpr int kVecs = HP / 8;  // 16-byte vectors per padded row
  const int real_vecs = head_dim / 8;
  for (int i = threadIdx.x; i < kBlockQ * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = i % kVecs;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid && c < real_vecs) {
      val = *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * Layout<HP>::kLdQkv + c * 8) = val;
  }
}

template <int HP>
__global__ void __launch_bounds__(kThreads)
    mha_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, int64_t q_sb,
                         int64_t q_st, int64_t k_sb, int64_t k_st,
                         int64_t v_sb, int64_t v_st, int seq, int heads,
                         int head_dim, float scale) {
  using L = Layout<HP>;
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

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int q_rows = min(kBlockQ, seq - q0);

  for (int r = tid; r < kBlockQ; r += kThreads) {
    s_m[r] = -INFINITY;
    s_l[r] = 0.f;
  }
  for (int i = tid; i < kBlockQ * L::kLdO; i += kThreads) s_o[i] = 0.f;
  load_tile<HP>(s_q, q + batch * q_sb + q0 * q_st + head * head_dim, q_st,
                q_rows, head_dim);

  const __nv_bfloat16* k_bh = k + batch * k_sb + head * head_dim;
  const __nv_bfloat16* v_bh = v + batch * v_sb + head * head_dim;
  const int num_kb = (seq + kBlockK - 1) / kBlockK;

  // Softmax work split: 4 threads per row, 16 columns each.
  const int sm_row = tid / 4;
  const int sm_col = (tid % 4) * 16;

  for (int kb = 0; kb < num_kb; ++kb) {
    const int k0 = kb * kBlockK;
    const int k_rows = min(kBlockK, seq - k0);
    load_tile<HP>(s_k, k_bh + k0 * k_st, k_st, k_rows, head_dim);
    load_tile<HP>(s_v, v_bh + k0 * v_st, v_st, k_rows, head_dim);
    __syncthreads();

    // S = Q K^T: 4x4 fragments of 16x16; warp w owns row (w / 2) and the
    // two columns 2 * (w % 2) + {0, 1}.
    {
      const int fr = warp / 2;
      const int fc0 = (warp % 2) * 2;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
      wmma::fill_fragment(acc[0], 0.f);
      wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
      for (int kk = 0; kk < HP; kk += 16) {
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

    // Online softmax over this tile's 64 columns; keys past t are masked.
    {
      float sv[16];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const bool visible = sm_col + j < k_rows;
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

    for (int i = tid; i < kBlockQ * HP; i += kThreads) {
      const int r = i / HP;
      s_o[r * L::kLdO + i % HP] *= s_corr[r];
    }
    __syncthreads();

    // O += P V: 4 x (HP / 16) fragments shared round-robin by the warps.
    for (int f = warp; f < 4 * (HP / 16); f += kWarps) {
      const int fr = f % 4;
      const int fc = f / 4;
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
    __syncthreads();
  }

  // Normalize and write the real rows and columns. Every row sees at least
  // one key, so l > 0; the guard only keeps a division by zero out.
  const int real_vecs = head_dim / 8;
  const int64_t out_stride = static_cast<int64_t>(heads) * head_dim;
  for (int i = tid; i < q_rows * real_vecs; i += kThreads) {
    const int r = i / real_vecs;
    const int c = (i % real_vecs) * 8;
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
        out + (static_cast<int64_t>(batch) * seq + q0 + r) * out_stride +
        static_cast<int64_t>(head) * head_dim + c) =
        *reinterpret_cast<const uint4*>(packed);
  }
}

template <int HP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t q_sb, int64_t q_st, int64_t k_sb, int64_t k_st,
                   int64_t v_sb, int64_t v_st, int batch, int seq, int heads,
                   int head_dim, float scale, cudaStream_t stream) {
  if (batch == 0 || seq == 0 || heads == 0) return cudaSuccess;
  constexpr size_t kSmem = Layout<HP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      mha_attention_kernel<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  mha_attention_kernel<HP><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      q_sb, q_st, k_sb, k_st, v_sb, v_st, seq, heads, head_dim, scale);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements: *_sb between batches, *_st between tokens; heads
// are head_dim apart within a token. Pointers and strides must keep 16-byte
// alignment. head_dim is 64 (DINOv2-L) or 72 (SigLIP-so400m). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int cg_mha_attention_forward(const void* q, const void* k,
                                        const void* v, void* out, int q_sb,
                                        int q_st, int k_sb, int k_st, int v_sb,
                                        int v_st, int batch, int seq,
                                        int heads, int head_dim, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, out, q_sb, q_st, k_sb, k_st, v_sb, v_st,
                        batch, seq, heads, head_dim, scale, s);
    case 72:
      return launch<80>(q, k, v, out, q_sb, q_st, k_sb, k_st, v_sb, v_st,
                        batch, seq, heads, head_dim, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
