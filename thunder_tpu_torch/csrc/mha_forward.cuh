// The attention forward from the packed QKV projection for Hopper (sm_90a),
// shared by the serving kernel (mha_from_qkv.cu, TRAIN = false) and the
// training forward (mha_train.cu, TRAIN = true): bf16 in and out, float32
// scores, row sums and accumulation.
//
// Replaces: thunder_tpu/kernels/attn_onepanel.py::mha_from_qkv and the forward
// of thunder_tpu/kernels/attn_train.py::mha_train (the Pallas TPU kernels).
// For a packed qkv (B, T, 3H), head h, query t and key j (dh = 64, H = heads * 64):
//   q      = bf16( qkv[b, t, h*64 : h*64+64] * bf16(0.125) )           (0.125 = dh^-0.5, exact)
//   s[j]   = sum_d q[d] * qkv[b, j, H + h*64 + d]  (f32)  + (j < len[b] ? 0 : -FLT_MAX)
//   p[j]   = exp(s[j] - m), m = max_j s[j]                (f32), z = sum_j p[j]
//   out[b, t, h*64 + d] = bf16( sum_j bf16(p[j]) * qkv[b, j, 2H + h*64 + d] / z )
// The mask is added, never -inf: a row of length 0 averages every key and stays
// finite, and padded query rows attend the valid keys like any other row.
// With TRAIN, the rounded probabilities that the dropout mask (dropout_hash.cuh,
// stream b * heads + h, row t, column j) drops are zeroed, the division becomes
// / (z * (1 - rate)) with z still the sum of the undropped exponentials, and m
// and z of every row are written for the backward as (2, B, heads, T) float32.
//
// What bounds it on this card: operations. 4 T^2 64 bf16 FLOP a head and row
// against 2 T 3 64 bytes in and 2 T 64 out: about 250 operations a byte at
// T = 749, so the tensor cores bound it, not memory.
//
// Design, for the tensor cores' rate at any T:
// - one block per (128 queries, head, batch row): two consumer warpgroups of 64
//   query rows each and one producer warp;
// - the producer's lane 0 copies the q tiles and then the keys' and values'
//   64 x 64 tiles with TMA (cp.async.bulk.tensor over a 3D tensor map of qkv,
//   (B, T, 3H), 128-byte swizzle), into a ring of STAGES stages with a "full"
//   and an "empty" mbarrier each; rows past T arrive as zeros and a box never
//   crosses into the next batch row;
// - each consumer warpgroup scales its q tile by 0.125 in shared memory, then
//   for each key tile: S = q k^T with wgmma (q and K both K-major), the mask,
//   a streaming softmax (running row max and sum in registers; the output
//   accumulator is rescaled by exp(m_old - m_new) when the max grows), p =
//   exp(s - m) rounded to bf16 in registers, which is the A fragment of
//   O += P V (wgmma with A from registers and V as the MN-major B operand
//   through the descriptor's transpose bit), and releases the stage;
// - shared memory does not depend on T: the q tiles and STAGES K/V tiles,
//   about 65 KB, so two blocks share an SM;
// - past a length of at least 1 the keys add exactly 0 (exp(-FLT_MAX - m) is
//   0 in f32), so key tiles wholly past the length are skipped; a row of
//   length 0 visits every key;
// - the epilogue divides once by the row sum and stages the bf16 tile through
//   the q tile's shared memory for 16-byte stores.
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

constexpr int DH = 64;                          // head width
constexpr int BM = 64;                          // query rows of a consumer warpgroup
constexpr int CONSUMERS = 2;                    // consumer warpgroups: 128 query rows a block
constexpr int BN = 64;                          // keys of a K or V tile
constexpr int STAGES = 3;                       // K/V ring depth
constexpr int THREADS = 128 * CONSUMERS + 32;   // plus the producer warp
constexpr int TILE_BYTES = 64 * DH * 2;         // a 64 x 64 bf16 tile: 128-byte rows, 8 KB
constexpr int Q_OFF = 0;
constexpr int K_OFF = Q_OFF + CONSUMERS * TILE_BYTES;
constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;                  // full[STAGES], empty[STAGES], q
constexpr int SMEM_BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + room to align the base to 1024 bytes
constexpr float NEG = -FLT_MAX;                 // finfo(float32).min, the additive key mask

static_assert(BM == 64 && BN == 64 && DH == 64, "one TMA box and one wgmma shape (m64n64k16) for every tile");

// Accumulator layout of a warpgroup's m64n64 tile: thread (warp w, lane l) holds rows 16 w + l / 4 (entries
// i % 4 < 2) and that row + 8 (i % 4 >= 2), columns 8 (i / 4) + 2 (l % 4) + (i % 2). Entries 8k..8k+7 of S are,
// packed in pairs, the A fragment of keys 16k..16k+15 for P V.
template <bool TRAIN>
__global__ void __launch_bounds__(THREADS, 2)
    mha_forward_kernel(const __grid_constant__ CUtensorMap qkv_map, const int* __restrict__ lengths,
                       bf16* __restrict__ out, float* __restrict__ stats, const int* __restrict__ seed, float rate,
                       int t, int heads) {
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
      for (int c = 0; c < CONSUMERS; ++c) tma_load(base + Q_OFF + c * TILE_BYTES, &qkv_map, qbar, head * DH, q0 + c * BM, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * TILE_BYTES);
        tma_load(base + K_OFF + s * TILE_BYTES, &qkv_map, full + 8 * s, h + head * DH, it * BN, b);
        tma_load(base + V_OFF + s * TILE_BYTES, &qkv_map, full + 8 * s, 2 * h + head * DH, it * BN, b);
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

  // the q tile times bf16(dh^-0.5) = 0.125 (exact), in place: an elementwise map commutes with the swizzle
  mbar_wait(qbar, 0);
  for (int i = tid; i < BM * DH / 8; i += 128) {
    uint4 v = reinterpret_cast<uint4*>(q_smem)[i];
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * 0.125f);
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
      key[r] = thunder_dropout::row_key((uint32_t)seed[0], (uint32_t)(b * heads + head), (uint32_t)(grow0 + 8 * r));
  }
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float z[2] = {0.f, 0.f};  // this thread's share of the row sums
  const uint64_t q_desc = desc_sw128(q_tile, 16, 1024);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(full + 8 * s, (it / STAGES) & 1);

    // S = q k^T: four k-steps of 16 along dh, 32 bytes apart inside the swizzled 128-byte rows
    float sc[32] = {};
    const uint64_t k_desc = desc_sw128(base + K_OFF + s * TILE_BYTES, 16, 1024);
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
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

    // O += P V: four k-steps of 16 keys, 16 rows of 128 bytes (2048 bytes) apart
    const uint64_t v_desc = desc_sw128(base + V_OFF + s * TILE_BYTES, 16, 1024);
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], v_desc + 128 * kk);
    wgmma_commit();
    wgmma_wait();
    pin(o);
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
}

// A tensor map of a (batch, t, width) bf16 tensor in 64 x 64 boxes (one head's columns, 64 rows) in the 128-byte
// swizzle; rows past t read as zeros. Returns a cudaError_t.
inline int encode_rows(CUtensorMap* map, const void* p, int width, int t, int batch) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)t, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)width * sizeof(bf16), (cuuint64_t)width * sizeof(bf16) * t};
  const cuuint32_t box[3] = {DH, 64, 1};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box, element_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// Launch the forward over (batch, t, heads): a tensor map of qkv encoded for this call, one block per 128
// queries, head and batch row. Returns a cudaError_t.
template <bool TRAIN>
inline int launch(const void* qkv, const int* lengths, void* out, float* stats, const int* seed, float rate, int batch,
                  int t, int heads, void* stream) {
  if (batch < 1 || batch > 65535 || t < 1 || heads < 1 || heads > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int status = encode_rows(&map, qkv, 3 * heads * DH, t, batch);
  if (status != (int)cudaSuccess) return status;
  cudaError_t err =
      cudaFuncSetAttribute(mha_forward_kernel<TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BM * CONSUMERS - 1) / (BM * CONSUMERS), heads, batch);
  mha_forward_kernel<TRAIN><<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map, lengths, static_cast<bf16*>(out), stats, seed, rate, t, heads);
  return (int)cudaGetLastError();
}

}  // namespace mha_fwd
