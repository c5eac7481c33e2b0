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
// accumulator are fp32, the unnormalized probabilities are rounded to bf16
// before PV. Head dims 128 (Griffin) and 256 (RecurrentGemma).
//
// Replaces the TPU kernel cadence_gemma_tpu/ops/pallas_attention.py::
// _attn_kernel (:71), reached through flash_window_attention ->
// _flash_window_forward (:207, pallas_call :240), with and without its
// kv_prefix (q_offset) halo. The backward kernels are in
// window_attention_backward.cu.
//
// What bounds it: at the 2B's head_dim 256 and window 2048 the band holds
// ~2000 keys per query, so QK^T and PV do ~1000 flops per byte of q, k, v
// and out -- far above the card's ~295 flops per byte: bound by tensor-core
// operations. The second cost is the L2 traffic of K and V: every block of
// 64 queries walks ~33 tiles of the one shared K/V head.
//
// Design (Hopper: wgmma, TMA, warp specialization):
// - A block is one 64-query tile x a group of kGroups = 2 query heads x one
//   batch row: two consumer warpgroups, one head each, and a producer
//   warpgroup. Each K/V tile is loaded once and serves both heads, which
//   share one mask because they share positions (multi-query reuse: half
//   the L2 traffic of a block per head). When kGroups does not divide the
//   head count, the last block's second warpgroup has no head and exits.
// - One producer thread keeps a ring of kStages K/V stages in flight with
//   TMA (cp.async.bulk.tensor, 128-byte swizzle, boxes of 64 rows x 64
//   columns: a 256-wide row is four boxes), full/empty mbarriers per stage:
//   the loads of the next tiles overlap the products of this one. Q is
//   loaded once per warpgroup by TMA.
// - S = Q K^T by wgmma m64n64k16 from shared memory (both K-major), in
//   registers; the band mask from each row's bounds, the online softmax in
//   registers (a row lives in one quad of threads: two shuffles), P
//   converted to bf16 in registers and fed to O += P V as wgmma's A operand
//   from registers, V as the MN-major B operand.
// - O (64 x h fp32) stays in registers, 128 a thread at h = 256, rescaled
//   there; the producer gives registers to the consumers (setmaxnreg 24 /
//   240). The epilogue normalizes in registers and writes bf16 out and
//   fp32 lse.
// - Shared memory at h = 256: Q 2 x 32 KB + 2 stages x (K 32 KB + V 32 KB)
//   = 192 KB; at h = 128, 4 stages in 160 KB. One block per SM.
// - Key tiles start at multiples of 64 in the keys' frame and run from the
//   group's smallest row bound (clamped at key 0) to its diagonal, in
//   order, without atomics: a fully masked halo of 128 keys gives the same
//   bits as no halo, and two launches the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kGroups = 2;  // query heads (consumer warpgroups) a block
constexpr int kThreads = (kGroups + 1) * 128;
// setmaxnreg: the producer warpgroup's registers go to the consumers. The
// block holds kThreads x its launch registers, which must cover both.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kMinLaunchRegs =
    (128 * kProducerRegs + kGroups * 128 * kConsumerRegs + kThreads - 1) /
    kThreads;
constexpr int kBoxCols = 64;  // bf16 columns of a 128-byte swizzled row
constexpr int kBoxBytes = 64 * kBoxCols * 2;
constexpr float kMaskedLse = 1e30f;

template <int H>
struct Config {
  static constexpr int kStages = H == 256 ? 2 : 4;
  static constexpr int kBoxes = H / kBoxCols;  // boxes of a 64-row tile
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kGroups * kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  // full[kStages], empty[kStages], q_full[kGroups]
  static constexpr int kBars = kV + kStages * kTileBytes;
  // Each row's first visible key, then per half-block min and max.
  static constexpr int kBounds = kBars + 8 * (2 * kStages + kGroups);
  // + 1024: the base is aligned up to the 128-byte swizzle's 1 KB period.
  static constexpr int kBytes = kBounds + 4 * (kBlockQ + 4) + 1024;
};

// S = Q K^T of one key tile (issued, not waited for): h in steps of 16, 32
// bytes further inside a 128-byte row, the next box every fourth step.
template <int H>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t q_base,
                                             uint32_t k_base) {
  hopper::fence_registers(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    hopper::wgmma_ss_m64n64k16(
        s, hopper::make_desc(q_base + off, 16, 1024, hopper::kSwizzle128B),
        hopper::make_desc(k_base + off, 16, 1024, hopper::kSwizzle128B),
        kk > 0);
  }
  hopper::wgmma_commit();
  hopper::fence_registers(s);
}

// O += P V of one key tile (issued, not waited for): P from registers,
// V as the MN-major operand, keys in steps of 16 (16 rows of every box).
template <int H>
__device__ __forceinline__ void issue_values(float (&o)[H / 2],
                                             uint32_t (&p)[16],
                                             uint32_t v_base) {
  hopper::fence_registers(o);
  hopper::fence_registers(p);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    hopper::WgmmaRS<H>::mma(
        o, p + 4 * kk,
        hopper::make_desc(v_base + kk * 16 * 128, kBoxBytes, 1024,
                          hopper::kSwizzle128B));
  }
  hopper::wgmma_commit();
  hopper::fence_registers(o);
}

// The band of the tile at key k0: register 4 c + 2 i + j is row r0 + 8 i,
// key k0 + 8 c + 2 quad + j. Tiles inside [lo_max, the block's first
// diagonal] need no mask.
__device__ __forceinline__ void mask_band(float (&s)[32], int k0, int quad,
                                          const int (&lower)[2],
                                          const int (&diag)[2], int lo_max,
                                          int diag_min) {
  if (k0 >= lo_max && k0 + kBlockK - 1 <= diag_min) return;
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    const int i = (v >> 1) & 1;
    const int kp = k0 + (v >> 2) * 8 + 2 * quad + (v & 1);
    if (kp < lower[i] || kp > diag[i]) s[v] = -INFINITY;
  }
}

// One consumer warpgroup: one head of the block's 64 query rows. Per key
// tile: S = Q K^T, the masked online softmax, O = O corr + P V, then the
// stage goes back to the producer. The two warpgroups of a block take turns
// on the tensor cores: one's softmax runs while the other's products do.
template <int H>
__device__ __forceinline__ void consume(
    unsigned char* smem, uint64_t* full, uint64_t* empty, uint64_t* q_full,
    const int* s_lower, int group, int head, int batch, int q0, int q_rows,
    int seq, int heads, int kv_prefix, int kb_first, int num_tiles,
    int lo_max, float scale, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse) {
  using C = Config<H>;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // rows r0 and r0 + 8
  const int quad = lane % 4;
  const float scale_log2 = scale * hopper::kLog2e;

  int lower[2], diag[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lower[i] = s_lower[r0 + 8 * i];
    diag[i] = kv_prefix + q0 + r0 + 8 * i;
  }
  const int diag_min = kv_prefix + q0;

  float o[H / 2];  // 64 x H fp32 over the warpgroup
#pragma unroll
  for (int v = 0; v < H / 2; ++v) o[v] = 0.f;
  float s[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) s[v] = 0.f;
  uint32_t p[16];
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.f, 0.f};              // this thread's part of the sum
  float corr[2];

  const uint32_t q_base =
      hopper::smem_u32(smem + C::kQ + group * C::kTileBytes);
  if (num_tiles > 0) hopper::mbar_wait(&q_full[group], 0);
  for (int i = 0; i < num_tiles; ++i) {
    const int stage = i % C::kStages;
    hopper::mbar_wait(&full[stage], (i / C::kStages) & 1);
    issue_scores<H>(
        s, q_base, hopper::smem_u32(smem + C::kK + stage * C::kTileBytes));
    hopper::wgmma_wait<0>();
    hopper::fence_registers(s);
    mask_band(s, (kb_first + i) * kBlockK, quad, lower, diag, lo_max,
              diag_min);
    hopper::online_softmax(s, m, l, corr, scale_log2);
    hopper::to_bf16(s, p);
    hopper::rescale(o, corr);
    issue_values<H>(
        o, p, hopper::smem_u32(smem + C::kV + stage * C::kTileBytes));
    hopper::wgmma_wait<0>();
    hopper::fence_registers(o);
    hopper::fence_registers(p);
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);  // K and V are read
  }

  // Normalize and write; rows that saw no key have l == 0 and o == 0.
  float inv[2];
  hopper::finish_rows(l, inv);
  const int64_t row_stride = static_cast<int64_t>(heads) * H;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= q_rows) continue;
    __nv_bfloat16* dst = out + (static_cast<int64_t>(batch) * seq + q0 + r) *
                                   row_stride +
                         static_cast<int64_t>(head) * H + 2 * quad;
#pragma unroll
    for (int c = 0; c < H / 8; ++c) {
      *reinterpret_cast<uint32_t*>(dst + 8 * c) = hopper::pack_bf16(
          o[4 * c + 2 * i] * inv[i], o[4 * c + 2 * i + 1] * inv[i]);
    }
    if (quad == 0) {
      const float m_use = m[i] == -INFINITY ? 0.f : m[i];
      lse[(static_cast<int64_t>(batch) * heads + head) * seq + q0 + r] =
          l[i] == 0.f ? kMaskedLse : m_use * scale + logf(l[i]);
    }
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
    window_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const int* __restrict__ segment_pos,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int seq, int heads,
                            int window, int kv_prefix, float scale) {
  using C = Config<H>;
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

  // Per-row first visible key in the keys' frame, never before key 0
  // (positions need not start at 0 when no cache precedes them); INT_MAX
  // marks a row that sees nothing. A shard's halo is masked for a row whose
  // document starts inside the shard, by the same bound.
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
  const int kb_first = kv_lo == INT_MAX ? 0 : kv_lo / kBlockK;
  const int num_tiles =
      kv_lo == INT_MAX ? 0
                       : (kv_prefix + q0 + q_rows - 1) / kBlockK - kb_first + 1;

  if (warp >= 4 * kGroups) {  // the producer warpgroup
    hopper::reg_dealloc<kProducerRegs>();
    if (tid == 4 * kGroups * 32 && num_tiles > 0) {
      for (int g = 0; g < groups; ++g) {
        hopper::mbar_expect_tx(&q_full[g], C::kTileBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          hopper::tma_load_3d(smem + C::kQ + g * C::kTileBytes + c * kBoxBytes,
                              &tm_q, &q_full[g], (head0 + g) * H + c * kBoxCols,
                              q0, batch);
        }
      }
      for (int i = 0; i < num_tiles + C::kStages; ++i) {
        const int stage = i % C::kStages;
        // Wait for the consumers to release this stage's previous tile; the
        // last kStages waits drain the ring before the thread exits.
        hopper::mbar_wait(&empty[stage], ((i / C::kStages) & 1) ^ 1);
        if (i >= num_tiles) continue;
        const int k0 = (kb_first + i) * kBlockK;
        hopper::mbar_expect_tx(&full[stage], 2 * C::kTileBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          hopper::tma_load_3d(
              smem + C::kK + stage * C::kTileBytes + c * kBoxBytes, &tm_k,
              &full[stage], c * kBoxCols, k0, batch);
          hopper::tma_load_3d(
              smem + C::kV + stage * C::kTileBytes + c * kBoxBytes, &tm_v,
              &full[stage], c * kBoxCols, k0, batch);
        }
      }
    }
  } else {  // a consumer warpgroup: one head
    hopper::reg_alloc<kConsumerRegs>();
    const int group = warp / 4;
    if (group < groups) {
      consume<H>(smem, full, empty, q_full, s_lower, group, head0 + group,
                 batch, q0, q_rows, seq, heads, kv_prefix, kb_first,
                 num_tiles, lo_max, scale, out, lse);
    }
  }
}

// Once per device: the shared memory the kernel asks for, and a check of
// its launch registers (fewer would leave the consumers' setmaxnreg.inc
// waiting forever for registers the block does not hold).
template <int H>
cudaError_t prepare() {
  static bool ready[64] = {};
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && ready[device])) return err;
  err = cudaFuncSetAttribute(window_attention_kernel<H>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Config<H>::kBytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr, window_attention_kernel<H>);
  }
  if (err != cudaSuccess) return err;
  if (attr.numRegs < kMinLaunchRegs) return cudaErrorInvalidConfiguration;
  if (device < 64) ready[device] = true;
  return cudaSuccess;
}

template <int H>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* segment_pos, void* out, float* lse, int batch,
                   int seq, int heads, int window, int kv_prefix, float scale,
                   cudaStream_t stream) {
  if (batch == 0 || seq == 0 || heads == 0) return cudaSuccess;
  using C = Config<H>;
  const cuuint64_t kv_len = static_cast<cuuint64_t>(kv_prefix) + seq;
  const cuuint32_t box[3] = {kBoxCols, 64, 1};
  // q as [b, t, n * h]; k and v as [b, P + t, h] (innermost first).
  const cuuint64_t q_dims[3] = {static_cast<cuuint64_t>(heads) * H,
                                static_cast<cuuint64_t>(seq),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t q_strides[2] = {q_dims[0] * 2, q_dims[0] * 2 * seq};
  const cuuint64_t kv_dims[3] = {H, kv_len, static_cast<cuuint64_t>(batch)};
  const cuuint64_t kv_strides[2] = {H * 2, H * 2 * kv_len};
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = hopper::make_tensor_map(&tm_q, q, 3, q_dims, q_strides,
                                            box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = hopper::make_tensor_map(&tm_k, k, 3, kv_dims, kv_strides, box,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) {
    err = hopper::make_tensor_map(&tm_v, v, 3, kv_dims, kv_strides, box,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) err = prepare<H>();
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ,
                  (heads + kGroups - 1) / kGroups, batch);
  window_attention_kernel<H><<<grid, kThreads, C::kBytes, stream>>>(
      tm_q, tm_k, tm_v, segment_pos, static_cast<__nv_bfloat16*>(out), lse,
      seq, heads, window, kv_prefix, scale);
  return cudaGetLastError();
}

template <int H>
cudaError_t attributes(int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr,
                                                window_attention_kernel<H>);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = Config<H>::kBytes;
  info[3] = kThreads;
  return cudaSuccess;
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

// The kernel's resources at `head_dim`: info = {registers a thread at
// launch, local (spilled) bytes a thread, dynamic shared memory bytes a
// block, threads a block}.
extern "C" int cg_window_attention_attributes(int head_dim, int* info) {
  switch (head_dim) {
    case 128:
      return attributes<128>(info);
    case 256:
      return attributes<256>(info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
