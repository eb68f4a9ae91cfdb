// The attention forward from the packed QKV projection for Hopper (sm_90a),
// shared by the serving kernel (mha_from_qkv.cu, TRAIN = false) and the
// training forward (mha_train.cu, TRAIN = true): bf16 in and out, float32
// scores, row sums and accumulation.
//
// Replaces: thunder_tpu/kernels/attn_onepanel.py::mha_from_qkv and the forward
// of thunder_tpu/kernels/attn_train.py::mha_train (the Pallas TPU kernels).
// Also replaces, at dh = 80, thunder_tpu/models/wav2vec2.py::_flash_mha (jax's Pallas
// TPU flash_attention, its forward pallas_call).
// For a packed qkv (B, T, 3H), head h, query t and key j (dh = 64 or 80, H = heads * dh):
//   q      = bf16( qkv[b, t, h*dh : h*dh+dh] * bf16(dh^-0.5) )         (0.125 at dh 64, exact)
//   s[j]   = sum_d q[d] * qkv[b, j, H + h*dh + d]  (f32)  + (j < len[b] ? 0 : -FLT_MAX)
//   p[j]   = exp(s[j] - m), m = max_j s[j]                (f32), z = sum_j p[j]
//   out[b, t, h*dh + d] = bf16( sum_j bf16(p[j]) * qkv[b, j, 2H + h*dh + d] / z )
// The mask is added, never -inf: a row of length 0 averages every key and stays
// finite, and padded query rows attend the valid keys like any other row.
// With TRAIN, the rounded probabilities that the dropout mask (dropout_hash.cuh,
// stream b * heads + h plus the launch's stream offset, row t, column j) drops are zeroed, the division becomes
// / (z * (1 - rate)) with z still the sum of the undropped exponentials, and m
// and z of every row are written for the backward as (2, B, heads, T) float32.
//
// What bounds it on this card: operations. 4 T^2 dh bf16 FLOP a head and row
// against 2 T 3 dh bytes in and 2 T dh out: about 250 operations a byte at
// T = 749, so the tensor cores bound it, not memory.
//
// Design, for the tensor cores' rate at any T:
// - one block per (128 queries, head, batch row): two consumer warpgroups of 64
//   query rows each and one producer warp;
// - the producer's lane 0 copies the q tiles and then the keys' and values'
//   64 x dh tiles with TMA (cp.async.bulk.tensor over a 3D tensor map of qkv,
//   (B, T, 3H), 128-byte swizzle), into a ring of STAGES stages with a "full"
//   and an "empty" mbarrier each; rows past T arrive as zeros and a box never
//   crosses into the next batch row. A row of 80 bf16 is 160 bytes, wider than
//   the 128-byte swizzle's box: at dh 80 a tile is two boxes from two tensor
//   maps, columns 0-63 in the 128-byte swizzle (8 KB) and columns 64-79 in the
//   32-byte swizzle right after it (2 KB), each read by wgmma through its own
//   descriptor: S takes a fifth k-step from the second boxes, and P V is an
//   m64n64 product on the first box of V and an m64n16 one on the second;
// - each consumer warpgroup scales its q tile by bf16(dh^-0.5) in shared memory
//   (rounded to bf16 once, as the plain version does), then
//   for each key tile: S = q k^T with wgmma (q and K both K-major), the mask,
//   a streaming softmax (running row max and sum in registers; the output
//   accumulator is rescaled by exp(m_old - m_new) when the max grows), p =
//   exp(s - m) rounded to bf16 in registers, which is the A fragment of
//   O += P V (wgmma with A from registers and V as the MN-major B operand
//   through the descriptor's transpose bit), and releases the stage;
// - shared memory does not depend on T: the q tiles and STAGES K/V tiles,
//   about 65 KB at dh 64 and 81 KB at dh 80, so two blocks share an SM;
// - past a length of at least 1 the keys add exactly 0 (exp(-FLT_MAX - m) is
//   0 in f32), so key tiles wholly past the length are skipped; a row of
//   length 0 visits every key;
// - the epilogue divides once by the row sum and stages the bf16 tile through
//   the q tile's shared memory for 16-byte stores (in TMA's swizzle at dh 64,
//   row by row at dh 80).
// The probabilities are rounded with the running max, not the final one, so
// each p may differ from the plain version's by one bf16 rounding before the
// f32 rescale; the output is a weighted mean of them, within the checks'
// bf16 ULPs (kernels/selftest.py).

#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder lookup

namespace mha_fwd {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;                          // query rows of a consumer warpgroup
constexpr int CONSUMERS = 2;                    // consumer warpgroups: 128 query rows a block
constexpr int BN = 64;                          // keys of a K or V tile
constexpr int STAGES = 3;                       // K/V ring depth
constexpr int THREADS = 128 * CONSUMERS + 32;   // plus the producer warp
constexpr int LO_BYTES = 64 * 64 * 2;           // a tile's first box: 64 rows x columns 0-63, 128-byte rows, 8 KB
constexpr float NEG = -FLT_MAX;                 // finfo(float32).min, the additive key mask

// What a head width changes. A tile is 64 rows by dh columns: one 64 x 64 box in the 128-byte swizzle, and at
// dh 80 a 64 x 16 box in the 32-byte swizzle (32-byte rows) right after it.
template <int DH>
struct Head {
  static_assert(DH == 64 || DH == 80, "the kernels take heads of 64 or 80");
  static constexpr int HI = DH - 64;             // columns of the second box
  static constexpr int HI_REGS = HI / 2;         // a thread's share of an m64n16 accumulator
  static constexpr int TILE = 64 * DH * 2;       // both boxes: 8 KB or 10 KB
  static constexpr float QSCALE = DH == 64 ? 0.125f : 0.11181640625f;       // bf16(dh^-0.5)
  static constexpr float SCALE = DH == 64 ? 0.125f : 0.111803397536277771f;  // float32(dh^-0.5)
};

// The tensor maps of one (batch, t, width) tensor: 64 x 64 boxes in the 128-byte swizzle, and at dh 80 64 x 16
// boxes in the 32-byte swizzle for columns 64-79 of a head
template <int DH>
struct Maps {
  CUtensorMap lo;
};
template <>
struct Maps<80> {
  CUtensorMap lo, hi;
};

// the 64-row tile of a head (columns [col, col + dh), rows [row, row + 64) of batch row b) into shared memory at
// dst, completing on bar
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const Maps<DH>& maps, uint32_t bar, int col, int row, int b) {
  tma_load(dst, &maps.lo, bar, col, row, b);
  if constexpr (DH == 80) tma_load(dst + LO_BYTES, &maps.hi, bar, col + 64, row, b);
}

// wgmma's descriptors of a tile's second box (dh 80), read K-major (a k-step of 16 columns) or MN-major (16 rows
// a k-step, 512 bytes apart): 8-row groups 256 bytes apart either way
__device__ __forceinline__ uint64_t hi_desc(uint32_t tile) { return desc_sw32(tile + LO_BYTES, 16, 256); }

// Accumulator layout of a warpgroup's m64nN tile: thread (warp w, lane l) holds rows 16 w + l / 4 (entries
// i % 4 < 2) and that row + 8 (i % 4 >= 2), columns 8 (i / 4) + 2 (l % 4) + (i % 2). Entries 8k..8k+7 of S are,
// packed in pairs, the A fragment of keys 16k..16k+15 for P V.
template <bool TRAIN, int DH>
__global__ void __launch_bounds__(THREADS, 2)
    mha_forward_kernel(const __grid_constant__ Maps<DH> qkv_map, const int* __restrict__ lengths,
                       bf16* __restrict__ out, float* __restrict__ stats, const int* __restrict__ seed, float rate,
                       int t, int heads, uint32_t stream_offset) {
  using W = Head<DH>;
  constexpr int TILE_BYTES = W::TILE;
  constexpr int Q_OFF = 0;
  constexpr int K_OFF = Q_OFF + CONSUMERS * TILE_BYTES;
  constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;  // full[STAGES], empty[STAGES], q
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + BAR_OFF;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t qbar = empty + 8 * STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * (BM * CONSUMERS);
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int h = heads * DH;
  const int valid = min(max(lengths[b], 0), t);
  const int n_tiles = ((valid > 0 ? valid : t) + BN - 1) / BN;  // past a length >= 1 the keys add exactly 0

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {  // the producer warp: lane 0 issues every copy
    if (lane == 0) {
      mbar_expect_tx(qbar, CONSUMERS * TILE_BYTES);
      for (int c = 0; c < CONSUMERS; ++c) load_tile(base + Q_OFF + c * TILE_BYTES, qkv_map, qbar, head * DH, q0 + c * BM, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * TILE_BYTES);
        load_tile(base + K_OFF + s * TILE_BYTES, qkv_map, full + 8 * s, h + head * DH, it * BN, b);
        load_tile(base + V_OFF + s * TILE_BYTES, qkv_map, full + 8 * s, 2 * h + head * DH, it * BN, b);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: 64 query rows
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int row0 = 16 * (warp % 4) + lane / 4;  // this thread's rows row0 and row0 + 8 of the warpgroup's 64
  const int col0 = 2 * (lane % 4);              // and columns col0, col0 + 1 of each group of 8
  const uint32_t q_tile = base + Q_OFF + wg * TILE_BYTES;
  bf16* q_smem = reinterpret_cast<bf16*>(smem + Q_OFF + wg * TILE_BYTES);

  // the q tile times bf16(dh^-0.5), rounded to bf16, in place (0.125 at dh 64: exact): an elementwise map
  // commutes with the swizzle
  mbar_wait(qbar, 0);
  for (int i = tid; i < BM * DH / 8; i += 128) {
    uint4 v = reinterpret_cast<uint4*>(q_smem)[i];
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * W::QSCALE);
    reinterpret_cast<uint4*>(q_smem)[i] = v;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the generic writes, visible to wgmma
  named_sync(1 + wg);

  const bool drop = TRAIN && rate > 0.f;
  const int grow0 = q0 + wg * BM + row0;
  uint32_t key[2] = {0u, 0u};
  if (drop) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      key[r] = thunder_dropout::row_key((uint32_t)seed[0], (uint32_t)(b * heads + head) + stream_offset,
                                        (uint32_t)(grow0 + 8 * r));
  }
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float o_hi[W::HI_REGS > 0 ? W::HI_REGS : 1];  // columns 64-79 at dh 80
#pragma unroll
  for (int i = 0; i < W::HI_REGS; ++i) o_hi[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float z[2] = {0.f, 0.f};  // this thread's share of the row sums
  const uint64_t q_desc = desc_sw128(q_tile, 16, 1024);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(full + 8 * s, (it / STAGES) & 1);

    // S = q k^T: four k-steps of 16 along dh, 32 bytes apart inside the swizzled 128-byte rows (and at dh 80 a
    // fifth from the second boxes)
    float sc[32] = {};
    const uint32_t k_tile = base + K_OFF + s * TILE_BYTES;
    const uint64_t k_desc = desc_sw128(k_tile, 16, 1024);
    pin(o);
    if constexpr (DH == 80) pin(o_hi);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
    if constexpr (DH == 80) wgmma_ss(sc, hi_desc(q_tile), hi_desc(k_tile), 1);
    wgmma_commit();
    wgmma_wait();
    pin(sc);

    // the key mask, keys past T excluded, the running max
    const int k0 = it * BN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = k0 + 8 * (i / 4) + col0 + (i % 2);
      const float v = j < t ? sc[i] + (j < valid ? 0.f : NEG) : -INFINITY;
      sc[i] = v;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
    }
    float scale[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: key 0 < T lies in the first tile
      scale[r] = expf(m[r] - m_new);           // 0 on the first tile
      m[r] = m_new;
      z[r] *= scale[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= scale[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < W::HI_REGS; ++i) o_hi[i] *= scale[(i >> 1) & 1];

    // p = exp(s - m) summed in f32 before dropout, then rounded to bf16 as P V's A fragments
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      float p0 = expf(sc[i] - m[r]);
      float p1 = expf(sc[i + 1] - m[r]);
      z[r] += p0;
      z[r] += p1;
      if (drop) {
        const int j = k0 + 8 * (i / 4) + col0;
        if (!thunder_dropout::keep(key[r], (uint32_t)j, rate)) p0 = 0.f;
        if (!thunder_dropout::keep(key[r], (uint32_t)(j + 1), rate)) p1 = 0.f;
      }
      pa[i / 2] = pack_bf16(p0, p1);
    }

    // O += P V: four k-steps of 16 keys, 16 rows of 128 bytes (2048 bytes) apart (and at dh 80 the m64n16
    // products on the second box, 16 rows of 32 bytes apart)
    const uint32_t v_tile = base + V_OFF + s * TILE_BYTES;
    const uint64_t v_desc = desc_sw128(v_tile, 16, 1024);
    pin(o);
    if constexpr (DH == 80) pin(o_hi);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], v_desc + 128 * kk);
    if constexpr (DH == 80) {
      const uint64_t v_hi = hi_desc(v_tile);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_n16(o_hi, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], v_hi + 32 * kk);
    }
    wgmma_commit();
    wgmma_wait();
    pin(o);
    if constexpr (DH == 80) pin(o_hi);
    mbar_arrive(empty + 8 * s);  // this stage's K and V are read
  }

  // ---- epilogue: the row sums, the statistics, O / z (with dropout / (z * (1 - rate))) as bf16
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    z[r] += __shfl_xor_sync(0xffffffffu, z[r], 1);
    z[r] += __shfl_xor_sync(0xffffffffu, z[r], 2);
    den[r] = drop ? z[r] * (1.f - rate) : z[r];
    if (TRAIN && lane % 4 == 0 && grow0 + 8 * r < t) {
      const size_t at = ((size_t)b * heads + head) * t + grow0 + 8 * r;
      stats[at] = m[r];
      stats[(size_t)gridDim.z * heads * t + at] = z[r];
    }
  }
  named_sync(1 + wg);  // every warp of the warpgroup is done with its q tile
  if constexpr (DH == 64) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {  // into the q tile's shared memory, 16-byte chunks swizzled as TMA's
      const int r = (i >> 1) & 1;
      const int row = row0 + 8 * r;
      const int chunk = (i / 4) ^ (row % 8);
      *reinterpret_cast<uint32_t*>(q_smem + row * DH + chunk * 8 + col0) = pack_bf16(o[i] / den[r], o[i + 1] / den[r]);
    }
    named_sync(1 + wg);
    bf16* dst = out + (size_t)b * t * h + head * DH;
    for (int i = tid; i < BM * DH / 8; i += 128) {
      const int row = i / 8;
      const int c = i % 8;
      const int grow = q0 + wg * BM + row;
      if (grow < t)
        *reinterpret_cast<uint4*>(dst + (size_t)grow * h + c * 8) =
            *reinterpret_cast<const uint4*>(q_smem + row * DH + (c ^ (row % 8)) * 8);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {  // into the q tile's shared memory as 64 plain rows of dh
      const int r = (i >> 1) & 1;
      *reinterpret_cast<uint32_t*>(q_smem + (row0 + 8 * r) * DH + 8 * (i / 4) + col0) =
          pack_bf16(o[i] / den[r], o[i + 1] / den[r]);
    }
#pragma unroll
    for (int i = 0; i < W::HI_REGS; i += 2) {
      const int r = (i >> 1) & 1;
      *reinterpret_cast<uint32_t*>(q_smem + (row0 + 8 * r) * DH + 64 + 8 * (i / 4) + col0) =
          pack_bf16(o_hi[i] / den[r], o_hi[i + 1] / den[r]);
    }
    named_sync(1 + wg);
    bf16* dst = out + (size_t)b * t * h + head * DH;
    for (int i = tid; i < BM * DH / 8; i += 128) {
      const int row = i / (DH / 8);
      const int c = i % (DH / 8);
      const int grow = q0 + wg * BM + row;
      if (grow < t)
        *reinterpret_cast<uint4*>(dst + (size_t)grow * h + c * 8) =
            *reinterpret_cast<const uint4*>(q_smem + row * DH + c * 8);
    }
  }
}

// A tensor map of a (batch, t, width) bf16 tensor in boxes of `cols` columns (64 in the 128-byte swizzle, or 16
// in the 32-byte swizzle) by 64 rows; rows past t read as zeros. Returns a cudaError_t.
inline int encode_rows(CUtensorMap* map, const void* p, int width, int t, int batch, int cols = 64) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)t, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)width * sizeof(bf16), (cuuint64_t)width * sizeof(bf16) * t};
  const cuuint32_t box[3] = {(cuuint32_t)cols, 64, 1};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box, element_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// The tensor maps of a (batch, t, width) tensor of heads dh wide. Returns a cudaError_t.
template <int DH>
inline int encode_maps(Maps<DH>* maps, const void* p, int width, int t, int batch) {
  const int status = encode_rows(&maps->lo, p, width, t, batch);
  if constexpr (DH == 80) {
    if (status == (int)cudaSuccess) return encode_rows(&maps->hi, p, width, t, batch, 16);
  }
  return status;
}

// Launch the forward over (batch, t, heads): the tensor maps of qkv encoded for this call, one block per 128
// queries, head and batch row. stream_offset is added to each (batch row * heads + head) dropout stream: the
// first batch row's global index times heads when the rows are a slice of a larger batch. Returns a cudaError_t.
template <bool TRAIN, int DH>
inline int launch(const void* qkv, const int* lengths, void* out, float* stats, const int* seed, float rate, int batch,
                  int t, int heads, uint32_t stream_offset, void* stream) {
  if (batch < 1 || batch > 65535 || t < 1 || heads < 1 || heads > 65535) return (int)cudaErrorInvalidValue;
  Maps<DH> maps;
  const int status = encode_maps(&maps, qkv, 3 * heads * DH, t, batch);
  if (status != (int)cudaSuccess) return status;
  constexpr int SMEM_BYTES = (CONSUMERS + 2 * STAGES) * Head<DH>::TILE + (2 * STAGES + 1) * 8 + 1024;  // + room to
                                                                                     // align the base to 1024 bytes
  cudaError_t err =
      cudaFuncSetAttribute(mha_forward_kernel<TRAIN, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BM * CONSUMERS - 1) / (BM * CONSUMERS), heads, batch);
  mha_forward_kernel<TRAIN, DH><<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps, lengths, static_cast<bf16*>(out), stats, seed, rate, t, heads, stream_offset);
  return (int)cudaGetLastError();
}

// The forward at the head width dh (64 or 80); cudaErrorInvalidValue for another
template <bool TRAIN>
inline int launch_dh(int dh, const void* qkv, const int* lengths, void* out, float* stats, const int* seed, float rate,
                     int batch, int t, int heads, uint32_t stream_offset, void* stream) {
  if (dh == 64) return launch<TRAIN, 64>(qkv, lengths, out, stats, seed, rate, batch, t, heads, stream_offset, stream);
  if (dh == 80) return launch<TRAIN, 80>(qkv, lengths, out, stats, seed, rate, batch, t, heads, stream_offset, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mha_fwd
