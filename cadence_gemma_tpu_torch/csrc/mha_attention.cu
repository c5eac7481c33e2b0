// Bidirectional multi-head flash attention, forward (the vision towers).
//
// q, k, v [b, t, n, h] in bf16, each row of h values dense, rows t and
// batches b apart by the given strides (so the three thirds of a fused qkv
// projection are read in place); out [b, t, n, h] bf16, contiguous. Every
// query sees every key of its (batch, head); keys at or past t are masked.
// Scores are scaled by `scale` (the real head_dim ** -0.5); softmax
// statistics and the output accumulator are fp32, the unnormalized
// probabilities are rounded to bf16 before PV. Head dims 64 (DINOv2-L) and
// 72 (SigLIP-so400m).
//
// Replaces the TPU kernels cadence_gemma_tpu/ops/pallas_attention.py::
// _mha_onepass_kernel (:700, whole sequence per (batch, head), t_pad <=
// 1024; pallas_call :752) and _mha_kernel (:623, tiled online softmax,
// longer sequences; pallas_call :803), both reached through
// flash_mha_attention -> _flash_mha_forward. The two compute one function;
// on the TPU they differ only in how much of a head's [t, t] logits fit in
// VMEM. One online-softmax loop over 64-key tiles covers every t here.
//
// What bounds it: at the towers' shapes (t = 729 or 734, head_dim 64 or 72)
// QK^T and PV do 4 t h flops per query row against 8 h bytes of q, k, v and
// out per token -- about t / 2 ~ 360 flops per byte, above the card's ~295:
// bound by tensor-core operations, though not by much. Every query tile
// reads its head's whole K and V from L2: with one query tile a block that
// is 75 MB a call at [2, 734, 16, 64], for 6 MB of q, k and v, and
// SigLIP's 144-byte rows sit half off a 32-byte sector.
//
// Design (Hopper: wgmma, TMA, warp specialization):
// - A block is kGroups = 3 query tiles of 64 rows of one (batch, head):
//   three consumer warpgroups share every K/V tile, a third of the L2
//   traffic, and a producer warp (416 threads; 90 KB of shared memory at
//   head_dim 64, 113 KB at 72; one block per SM). [2, 734, 16, 64] gives
//   4 blocks a head, 128 blocks for 132 SMs.
// - The producer's one thread keeps a ring of kStages = 4 K/V tiles in
//   flight with TMA (full/empty mbarriers), from 4-d tensor maps over
//   (h, n, t, b) with the callers' strides, so the fused qkv views are read
//   in place. Boxes are 64 rows x 16 columns under the 32-byte swizzle; the
//   map's inner extent is the real head dim, so SigLIP's 72 columns pad to
//   80 with TMA's zero fill and never read the next head's. Q is loaded once
//   a tile by TMA.
// - S = Q K^T by wgmma m64n64k16 (one box per step of 16), in registers;
//   keys at or past t are set to -inf explicitly (TMA's zero fill gives a
//   score of 0, not a masked one). The online softmax runs in registers, P
//   is converted to bf16 in registers and fed to O += P V (wgmma m64n64k16
//   or m64n80k16, A from registers, V as the MN-major B operand).
// - O (64 x 64 or 64 x 80 fp32: 32 or 40 registers a thread) stays in
//   registers; the epilogue normalizes there and writes the real columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kGroups = 3;  // query tiles (consumer warpgroups) a block
constexpr int kStages = 4;
constexpr int kThreads = kGroups * 128 + 32;  // and one producer warp
constexpr int kBoxCols = 16;  // bf16 columns of a 32-byte swizzled row
constexpr int kBoxBytes = 64 * kBoxCols * 2;

// HP: the head dim padded to a multiple of 16.
template <int HP>
struct Config {
  static constexpr int kBoxes = HP / kBoxCols;  // boxes of a 64-row tile
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kGroups * kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  // full[kStages], empty[kStages], q_full[kGroups]
  static constexpr int kBars = kV + kStages * kTileBytes;
  // + 256: the base is aligned up to the 32-byte swizzle's 256-byte period.
  static constexpr int kBytes = kBars + 8 * (2 * kStages + kGroups) + 256;
};

// S = Q K^T of one key tile (issued, not waited for): one 16-column box a
// step.
template <int HP>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t q_base,
                                             uint32_t k_base) {
  hopper::fence_registers(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HP / kBoxCols; ++kk) {
    hopper::wgmma_ss_m64n64k16(
        s,
        hopper::make_desc(q_base + kk * kBoxBytes, 16, 256,
                          hopper::kSwizzle32B),
        hopper::make_desc(k_base + kk * kBoxBytes, 16, 256,
                          hopper::kSwizzle32B),
        kk > 0);
  }
  hopper::wgmma_commit();
  hopper::fence_registers(s);
}

// O += P V of one key tile (issued, not waited for): P from registers,
// V as the MN-major operand, keys in steps of 16 (16 rows of every box).
template <int HP>
__device__ __forceinline__ void issue_values(float (&o)[HP / 2],
                                             uint32_t (&p)[16],
                                             uint32_t v_base) {
  hopper::fence_registers(o);
  hopper::fence_registers(p);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    hopper::WgmmaRS<HP>::mma(
        o, p + 4 * kk,
        hopper::make_desc(v_base + kk * 16 * 32, kBoxBytes, 256,
                          hopper::kSwizzle32B));
  }
  hopper::wgmma_commit();
  hopper::fence_registers(o);
}

// Keys at or past t, which TMA filled with zeros (a score of 0, not a
// masked one): register 4 c + 2 i + j is key k0 + 8 c + 2 quad + j.
__device__ __forceinline__ void mask_keys(float (&s)[32], int k0, int seq,
                                          int quad) {
  if (k0 + kBlockK <= seq) return;
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    if (k0 + (v >> 2) * 8 + 2 * quad + (v & 1) >= seq) s[v] = -INFINITY;
  }
}

template <int HP>
__global__ void __launch_bounds__(kThreads, 1)
    mha_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         __nv_bfloat16* __restrict__ out, int seq, int heads,
                         int head_dim, float scale) {
  using C = Config<HP>;
  constexpr int kO = HP / 2;  // accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 255) & ~uintptr_t{255});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int block_q0 = blockIdx.x * kGroups * kBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int tid = threadIdx.x;
  const int num_tiles = (seq + kBlockK - 1) / kBlockK;
  // Query tiles of this block; the last block's may be fewer.
  const int groups = min(kGroups, (seq - block_q0 + kBlockQ - 1) / kBlockQ);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * groups);  // lane 0 of each warp
    }
    for (int g = 0; g < kGroups; ++g) hopper::mbar_init(&q_full[g], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kGroups * 128) {  // the producer warp
    if (tid == kGroups * 128) {
      for (int g = 0; g < groups; ++g) {
        hopper::mbar_expect_tx(&q_full[g], C::kTileBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          hopper::tma_load_4d(smem + C::kQ + g * C::kTileBytes + c * kBoxBytes,
                              &tm_q, &q_full[g], c * kBoxCols, head,
                              block_q0 + g * kBlockQ, batch);
        }
      }
      for (int i = 0; i < num_tiles + kStages; ++i) {
        const int stage = i % kStages;
        // Wait for the consumers to release this stage's previous tile; the
        // last kStages waits drain the ring before the thread exits.
        hopper::mbar_wait(&empty[stage], ((i / kStages) & 1) ^ 1);
        if (i >= num_tiles) continue;
        hopper::mbar_expect_tx(&full[stage], 2 * C::kTileBytes);
        for (int c = 0; c < C::kBoxes; ++c) {
          hopper::tma_load_4d(smem + C::kK + stage * C::kTileBytes +
                                  c * kBoxBytes,
                              &tm_k, &full[stage], c * kBoxCols, head,
                              i * kBlockK, batch);
          hopper::tma_load_4d(smem + C::kV + stage * C::kTileBytes +
                                  c * kBoxBytes,
                              &tm_v, &full[stage], c * kBoxCols, head,
                              i * kBlockK, batch);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: one query tile. Register 4 c + 2 i + j of a
  // 64 x N accumulator is row r0 + 8 i, column 8 c + 2 quad + j.
  const int group = tid / 128;
  if (group >= groups) return;
  const int q0 = block_q0 + group * kBlockQ;
  const int lane = tid % 32;
  const int r0 = (tid % 128 / 32) * 16 + lane / 4;
  const int quad = lane % 4;
  const float scale_log2 = scale * hopper::kLog2e;

  float o[kO];
#pragma unroll
  for (int v = 0; v < kO; ++v) o[v] = 0.f;
  float s[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) s[v] = 0.f;
  uint32_t p[16];
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.f, 0.f};              // this thread's part of the sum
  float corr[2];

  const uint32_t q_base =
      hopper::smem_u32(smem + C::kQ + group * C::kTileBytes);
  hopper::mbar_wait(&q_full[group], 0);
  for (int i = 0; i < num_tiles; ++i) {
    const int stage = i % kStages;
    hopper::mbar_wait(&full[stage], (i / kStages) & 1);
    issue_scores<HP>(
        s, q_base, hopper::smem_u32(smem + C::kK + stage * C::kTileBytes));
    hopper::wgmma_wait<0>();
    hopper::fence_registers(s);
    mask_keys(s, i * kBlockK, seq, quad);
    hopper::online_softmax(s, m, l, corr, scale_log2);
    hopper::to_bf16(s, p);
    hopper::rescale(o, corr);
    issue_values<HP>(
        o, p, hopper::smem_u32(smem + C::kV + stage * C::kTileBytes));
    hopper::wgmma_wait<0>();
    hopper::fence_registers(o);
    hopper::fence_registers(p);
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);  // K and V are read
  }

  // Normalize and write the real rows and columns. Every row sees key 0, so
  // l > 0.
  float inv[2];
  hopper::finish_rows(l, inv);
  const int64_t row_stride = static_cast<int64_t>(heads) * head_dim;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= seq) continue;
    __nv_bfloat16* dst = out + (static_cast<int64_t>(batch) * seq + row) *
                                   row_stride +
                         static_cast<int64_t>(head) * head_dim + 2 * quad;
#pragma unroll
    for (int c = 0; c < HP / 8; ++c) {
      if (8 * c < head_dim) {
        *reinterpret_cast<uint32_t*>(dst + 8 * c) = hopper::pack_bf16(
            o[4 * c + 2 * r] * inv[r], o[4 * c + 2 * r + 1] * inv[r]);
      }
    }
  }
}

// Once per device: the shared memory the kernel asks for.
template <int HP>
cudaError_t prepare() {
  static bool ready[64] = {};
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && ready[device])) return err;
  err = cudaFuncSetAttribute(mha_attention_kernel<HP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Config<HP>::kBytes);
  if (err == cudaSuccess && device < 64) ready[device] = true;
  return err;
}

template <int HP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t q_sb, int64_t q_st, int64_t k_sb, int64_t k_st,
                   int64_t v_sb, int64_t v_st, int batch, int seq, int heads,
                   int head_dim, float scale, cudaStream_t stream) {
  if (batch == 0 || seq == 0 || heads == 0) return cudaSuccess;
  using C = Config<HP>;
  // (h, n, t, b), innermost first; strides in bytes.
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint32_t box[4] = {kBoxCols, 1, 64, 1};
  const void* bases[3] = {q, k, v};
  const int64_t strides[3][2] = {{q_st, q_sb}, {k_st, k_sb}, {v_st, v_sb}};
  CUtensorMap maps[3];
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 3 && err == cudaSuccess; ++i) {
    const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(head_dim) * 2,
                                 static_cast<cuuint64_t>(strides[i][0]) * 2,
                                 static_cast<cuuint64_t>(strides[i][1]) * 2};
    err = hopper::make_tensor_map(&maps[i], bases[i], 4, dims, bytes, box,
                                  CU_TENSOR_MAP_SWIZZLE_32B);
  }
  if (err == cudaSuccess) err = prepare<HP>();
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kGroups * kBlockQ - 1) / (kGroups * kBlockQ), heads,
                  batch);
  mha_attention_kernel<HP><<<grid, kThreads, C::kBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), seq, heads,
      head_dim, scale);
  return cudaGetLastError();
}

template <int HP>
cudaError_t attributes(int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr,
                                                mha_attention_kernel<HP>);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = Config<HP>::kBytes;
  info[3] = kThreads;
  return cudaSuccess;
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

// The kernel's resources at `head_dim`: info = {registers a thread, local
// (spilled) bytes a thread, dynamic shared memory bytes a block, threads a
// block}.
extern "C" int cg_mha_attention_attributes(int head_dim, int* info) {
  switch (head_dim) {
    case 64:
      return attributes<64>(info);
    case 72:
      return attributes<80>(info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
