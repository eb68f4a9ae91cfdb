// Training multi-head attention straight from the packed QKV projection, with
// dropout on the probabilities inside the kernels, forward and backward, for
// Hopper (sm_90a): bf16 in and out, float32 scores, row sums and accumulation.
//
// Replaces: thunder_tpu/kernels/attn_train.py::mha_train (the Pallas TPU kernels
// _fwd_kernel and _bwd_kernel, and _dropout_keep_masks).
// Forward: mha_forward_kernel<true> of mha_forward.cuh (streaming softmax,
// wgmma, TMA): the serving kernel's
// math; the rounded probabilities that the mask drops are zeroed, the output is
// divided by z * (1 - rate) with z the sum of the undropped exponentials, and
// each row's m and z go out as (2, B, heads, T) float32. The TPU kernel saves no
// statistics because of its lane layout; here they spare the backward a second
// softmax pass over the keys and let it stream the keys at any T.
// Backward, per head, with qh = bf16(q * 0.125), e = exp(s - m), keep the
// forward's mask (dropout_hash.cuh: stream b * heads + head, row = query, column
// = key), inv_keep = 1 / (1 - rate):
//   delta = rowsum(f32(dO) * f32(O))                 (the saved bf16 output)
//   dP    = dO V^T, masked and scaled: keep ? dP * inv_keep : 0
//   dS    = bf16( e * (dP - delta) * (1 / z) )
//   dq    = bf16( (dS K) * 0.125 )
//   dk    = bf16( dS^T qh )
//   dv    = bf16( Pd^T dO' ),  Pd = keep ? bf16(e) : 0,  dO' = bf16( f32(dO) * (1 / z) * inv_keep )
// written in place into one packed (B, T, 3H) tensor [dq | dk | dv].
// qh is never formed: 0.125 is a power of two, so s = (q k^T) * 0.125 and
// dk = (dS^T q) * 0.125 in float32 are the same numbers as from qh (for |q|
// above 2^-123), and q feeds the products as it is.
//
// What bounds it on this card: operations. The function needs 10 T^2 64 bf16
// FLOP a head and row (five products) against a few T * 64 * 2 bytes; the two
// kernels compute seven (S and dP in both, so that neither needs atomics and
// every run gives the same bits), and evaluate e and the dropout hash once per
// (query, key) in each kernel on the CUDA cores: that elementwise work, not the
// tensor cores, sets their time, and warps in flight hide its latency.
//
// Design of the backward, two kernels in the forward's shape (mha_forward.cuh),
// one block an SM per (192 rows, head, batch row): three consumer warpgroups of
// 64 rows and a producer warpgroup, which hands its registers to the consumers
// (setmaxnreg) and of which one warp works; tiles come in by TMA in the 128-byte
// swizzle (rows past T arrive as zeros), every product is a wgmma:
// - mha_train_dq_kernel, rows = queries. The producer copies the q and dO tiles,
//   then a ring of 64-key K and V tiles. Each consumer computes delta for its
//   rows (and writes it for the second kernel), then for each key tile S = q K^T
//   and dP = dO V^T (m64n64, both operands K-major in shared memory), dS in
//   registers, and dq += dS K with dS as the register A fragment and K as the
//   MN-major B operand. Key tiles wholly past a length of at least 1 add exactly
//   0 and are skipped, as in the forward.
// - mha_train_dkv_kernel, rows = keys. The K and V tiles load once; the
//   producer streams 64-query q and dO tiles through the ring, and its 32 lanes
//   write each tile's query statistics (m, 1 / z, delta, the dropout row key;
//   plain loads, since a (b, head) row of them is not 16-byte aligned) and
//   dO' (a per-query scaling of the B operand, written in the same swizzle,
//   fenced for the async proxy) before they release the stage. Each consumer
//   takes a tile in two halves of 32 queries, so that dk, dv and the half's
//   S^T, dP^T fit its registers: S^T = K q^T and dP^T = V dO^T (m64n32), dS^T
//   and Pd^T in registers, then dk += dS^T q and dv += Pd^T dO' with q and dO'
//   as MN-major B operands. A block whose keys all lie past a length of at
//   least 1 writes zeros and ends.
// Shared memory does not depend on T (97 KB for dq, 124 KB for dk/dv).

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "hopper.cuh"
#include "mha_forward.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int DH = 64;                          // head width
constexpr int BM = 64;                          // rows of a consumer warpgroup: queries (dq) or keys (dk/dv)
constexpr int CONSUMERS = 3;                    // 192 rows a block
constexpr int BN = 64;                          // keys (dq) or queries (dk/dv) of a streamed tile
constexpr int STAGES = 3;                       // ring depth
constexpr int THREADS = 128 * (CONSUMERS + 1);  // plus the producer warpgroup
// registers a thread after setmaxnreg: the producer warpgroup gives its share to the consumers
constexpr int DQ_PRODUCER_REGS = 24, DQ_CONSUMER_REGS = 160;
constexpr int KV_PRODUCER_REGS = 40, KV_CONSUMER_REGS = 152;
static_assert(128 * DQ_PRODUCER_REGS + 128 * CONSUMERS * DQ_CONSUMER_REGS <= 65536 &&
                  128 * KV_PRODUCER_REGS + 128 * CONSUMERS * KV_CONSUMER_REGS <= 65536,
              "one block an SM");
constexpr int TILE = 64 * DH * 2;               // a 64 x 64 bf16 tile: 128-byte rows, 8 KB
constexpr float NEG = -FLT_MAX;                 // finfo(float32).min, the additive key mask
constexpr float SCALE = 0.125f;                 // dh^-0.5, a power of two

// shared memory of the dq kernel: the q and dO tiles of the consumers, the K and V ring, the barriers
constexpr int DQ_Q = 0;
constexpr int DQ_DO = DQ_Q + CONSUMERS * TILE;
constexpr int DQ_K = DQ_DO + CONSUMERS * TILE;
constexpr int DQ_V = DQ_K + STAGES * TILE;
constexpr int DQ_BAR = DQ_V + STAGES * TILE;  // full[STAGES], empty[STAGES], the q and dO tiles'
constexpr int DQ_SMEM = DQ_BAR + (2 * STAGES + 1) * 8 + 1024;  // + room to align the base to 1024 bytes

// shared memory of the dk/dv kernel: the consumers' K and V tiles, the ring of q, dO, dO' tiles and query
// statistics, the barriers
constexpr int KV_K = 0;
constexpr int KV_V = KV_K + CONSUMERS * TILE;
constexpr int KV_Q = KV_V + CONSUMERS * TILE;
constexpr int KV_DO = KV_Q + STAGES * TILE;
constexpr int KV_DOZ = KV_DO + STAGES * TILE;
constexpr int KV_STAT = KV_DOZ + STAGES * TILE;  // float4 (m, 1 / z, delta, row key) per query
constexpr int KV_BAR = KV_STAT + STAGES * BN * 16;  // full[STAGES], ready[STAGES], empty[STAGES], the K and V tiles'
constexpr int KV_SMEM = KV_BAR + (3 * STAGES + 1) * 8 + 1024;

static_assert(BM == 64 && BN == 64 && DH == 64, "one TMA box (64 x 64) for every tile");

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// One (query, key) entry from the raw products s = q k^T and dp = dO V^T: dS, and Pd (e where kept, else 0)
struct Entry {
  float ds, pd;
};

__device__ __forceinline__ Entry entry(float s, float dp, int key, int valid, float m, float invz, float delta,
                                       uint32_t row_key, bool drop, float rate, float inv_keep) {
  const float e = expf(s * SCALE + (key < valid ? 0.f : NEG) - m);
  bool kept = true;
  if (drop) {
    kept = thunder_dropout::keep(row_key, (uint32_t)key, rate);
    dp = kept ? dp * inv_keep : 0.f;
  }
  return {e * (dp - delta) * invz, kept ? e : 0.f};
}

// The accumulator layout of a warpgroup's m64nN tile: thread (warp w, lane l) holds rows 16 (w % 4) + l / 4
// (entries i % 4 < 2) and that row + 8 (i % 4 >= 2), columns 8 (i / 4) + 2 (l % 4) + (i % 2). Entries 8k..8k+7,
// packed in pairs, are the A fragment of columns 16k..16k+15 as the next product's K dimension.

// a warpgroup's 64 x 64 accumulator, times `scale`, as bf16 into its tile's shared memory in TMA's swizzle, then
// 16-byte stores into rows [r0, r0 + 64) (those below t) of columns [col, col + 64) of dst
__device__ __forceinline__ void store_rows(const float (&acc)[32], float scale, bf16* tile, bf16* __restrict__ dst,
                                           size_t row_stride, int col, int r0, int t, int wg) {
  const int lane = threadIdx.x % 32;
  const int row0 = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  named_sync(1 + wg);  // every warp of the warpgroup is past its last product on the tile
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = row0 + 8 * ((i >> 1) & 1);
    const int chunk = (i / 4) ^ (row % 8);
    *reinterpret_cast<uint32_t*>(tile + row * DH + chunk * 8 + col0) = pack_bf16(acc[i] * scale, acc[i + 1] * scale);
  }
  named_sync(1 + wg);
  for (int i = threadIdx.x % 128; i < BM * DH / 8; i += 128) {
    const int row = i / 8;
    const int c = i % 8;
    if (r0 + row < t)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + row) * row_stride + col + c * 8) =
          *reinterpret_cast<const uint4*>(tile + row * DH + (c ^ (row % 8)) * 8);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    mha_train_dq_kernel(const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap do_map,
                        const int* __restrict__ lengths, const bf16* __restrict__ o, const bf16* __restrict__ dout,
                        const float* __restrict__ stats, const int* __restrict__ seed, float rate,
                        bf16* __restrict__ dqkv, float* __restrict__ delta, int t, int heads) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + DQ_BAR;
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

  if (warp >= 4 * CONSUMERS) {  // the producer warpgroup: lane 0 of its first warp issues every copy
    setmaxnreg_dec<DQ_PRODUCER_REGS>();
    if (warp == 4 * CONSUMERS && lane == 0) {
      mbar_expect_tx(qbar, 2 * CONSUMERS * TILE);
      for (int c = 0; c < CONSUMERS; ++c) {
        tma_load(base + DQ_Q + c * TILE, &qkv_map, qbar, head * DH, q0 + c * BM, b);
        tma_load(base + DQ_DO + c * TILE, &do_map, qbar, head * DH, q0 + c * BM, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * TILE);
        tma_load(base + DQ_K + s * TILE, &qkv_map, full + 8 * s, h + head * DH, it * BN, b);
        tma_load(base + DQ_V + s * TILE, &qkv_map, full + 8 * s, 2 * h + head * DH, it * BN, b);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: 64 query rows; this thread's rows grow0 and grow0 + 8
  setmaxnreg_inc<DQ_CONSUMER_REGS>();
  const int wg = warp / 4;
  const int row0 = 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int grow0 = q0 + wg * BM + row0;
  const bool drop = rate > 0.f;
  const float inv_keep = 1.f / (1.f - rate);
  const size_t at0 = ((size_t)b * heads + head) * t;
  const size_t plane = (size_t)gridDim.z * heads * t;

  // the rows' m, 1 / z (0 past T: those rows contribute exactly 0), dropout keys, and delta = rowsum(dO * O):
  // each of a quad's four threads sums 16 of a row's 64 columns
  float m[2], invz[2], dl[2];
  uint32_t key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = grow0 + 8 * r;
    const bool in = g < t;
    m[r] = in ? stats[at0 + g] : 0.f;
    invz[r] = in ? 1.f / stats[plane + at0 + g] : 0.f;
    key[r] = drop ? thunder_dropout::row_key((uint32_t)seed[0], (uint32_t)(b * heads + head), (uint32_t)g) : 0u;
    float acc = 0.f;
    if (in) {
      const size_t at = ((size_t)b * t + g) * h + head * DH + 16 * (lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + at + 8 * half);
        const uint4 ov = *reinterpret_cast<const uint4*>(o + at + 8 * half);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc += __bfloat162float(de[j]) * __bfloat162float(oe[j]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[r] = acc;
    if (in && lane % 4 == 0) delta[at0 + g] = acc;
  }

  mbar_wait(qbar, 0);
  const uint32_t q_tile = base + DQ_Q + wg * TILE;
  const uint64_t q_desc = desc_sw128(q_tile, 16, 1024);
  const uint64_t do_desc = desc_sw128(base + DQ_DO + wg * TILE, 16, 1024);
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(full + 8 * s, (it / STAGES) & 1);

    // S = q K^T and dP = dO V^T: four k-steps of 16 along dh each, 32 bytes apart in the swizzled rows
    float sc[32] = {};
    float dp[32] = {};
    const uint64_t k_desc = desc_sw128(base + DQ_K + s * TILE, 16, 1024);
    const uint64_t v_desc = desc_sw128(base + DQ_V + s * TILE, 16, 1024);
    pin(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(dp, do_desc + 2 * kk, v_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait();
    pin(sc);
    pin(dp);

    // dS in registers, rounded to bf16 as the A fragments of dS K
    const int k0 = it * BN;
    uint32_t da[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const int j = k0 + 8 * (i / 4) + col0;
      const Entry a = entry(sc[i], dp[i], j, valid, m[r], invz[r], dl[r], key[r], drop, rate, inv_keep);
      const Entry c = entry(sc[i + 1], dp[i + 1], j + 1, valid, m[r], invz[r], dl[r], key[r], drop, rate, inv_keep);
      da[i / 2] = pack_bf16(a.ds, c.ds);  // keys past T meet zero rows of K
    }

    // dq += dS K: four k-steps of 16 keys, K as the MN-major B operand, 16 rows of 128 bytes apart
    pin(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs(dq, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3], k_desc + 128 * kk);
    wgmma_commit();
    wgmma_wait();
    pin(dq);
    mbar_arrive(empty + 8 * s);  // this stage's K and V are read
  }

  store_rows(dq, SCALE, reinterpret_cast<bf16*>(smem + DQ_Q + wg * TILE), dqkv + (size_t)b * t * 3 * h, 3 * (size_t)h,
             head * DH, q0 + wg * BM, t, wg);
}

__global__ void __launch_bounds__(THREADS, 1)
    mha_train_dkv_kernel(const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap do_map,
                         const int* __restrict__ lengths, const float* __restrict__ stats,
                         const float* __restrict__ delta, const int* __restrict__ seed, float rate,
                         bf16* __restrict__ dqkv, int t, int heads) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + KV_BAR;
  const uint32_t ready = full + 8 * STAGES;
  const uint32_t empty = ready + 8 * STAGES;
  const uint32_t kvbar = empty + 8 * STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * (BM * CONSUMERS);
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int h = heads * DH;
  const size_t row_stride = 3 * (size_t)h;
  bf16* dst = dqkv + (size_t)b * t * row_stride;
  const int valid = min(max(lengths[b], 0), t);
  const int n_tiles = (t + BN - 1) / BN;  // every query attends the keys

  if (valid > 0 && k0 >= valid) {  // every key past a length >= 1: dS and Pd are exactly 0
    for (int i = threadIdx.x; i < 2 * BM * CONSUMERS * (DH / 8); i += THREADS) {
      const int part = i / (BM * CONSUMERS * (DH / 8));
      const int row = (i / (DH / 8)) % (BM * CONSUMERS);
      if (k0 + row < t)
        *reinterpret_cast<uint4*>(dst + (size_t)(k0 + row) * row_stride + (1 + part) * h + head * DH + (i % 8) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, 32);
      mbar_init(empty + 8 * s, 128 * CONSUMERS);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const bool drop = rate > 0.f;
  const float inv_keep = 1.f / (1.f - rate);
  const size_t at0 = ((size_t)b * heads + head) * t;

  if (warp >= 4 * CONSUMERS) {  // the producer warpgroup: its first warp prepares each stage, lane 0 copies
    setmaxnreg_dec<KV_PRODUCER_REGS>();
    if (warp != 4 * CONSUMERS) return;
    const auto issue = [&](int it) {
      const int s = it % STAGES;
      mbar_expect_tx(full + 8 * s, 2 * TILE);
      tma_load(base + KV_Q + s * TILE, &qkv_map, full + 8 * s, head * DH, it * BN, b);
      tma_load(base + KV_DO + s * TILE, &do_map, full + 8 * s, head * DH, it * BN, b);
    };
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * CONSUMERS * TILE);
      for (int c = 0; c < CONSUMERS; ++c) {
        tma_load(base + KV_K + c * TILE, &qkv_map, kvbar, h + head * DH, k0 + c * BM, b);
        tma_load(base + KV_V + c * TILE, &qkv_map, kvbar, 2 * h + head * DH, k0 + c * BM, b);
      }
      for (int it = 0; it < min(STAGES, n_tiles); ++it) issue(it);
    }
    const size_t plane = (size_t)gridDim.z * heads * t;
    const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      // the queries' statistics; past T, m = +inf and 1 / z = 0 make e, dS and Pd exactly 0
      float4* st = reinterpret_cast<float4*>(smem + KV_STAT + s * BN * 16);
      for (int r = lane; r < BN; r += 32) {
        const int g = it * BN + r;
        const bool in = g < t;
        float4 v;
        v.x = in ? stats[at0 + g] : INFINITY;
        v.y = in ? 1.f / stats[plane + at0 + g] : 0.f;
        v.z = in ? delta[at0 + g] : 0.f;
        v.w = __uint_as_float(drop ? thunder_dropout::row_key(sd, (uint32_t)(b * heads + head), (uint32_t)g) : 0u);
        st[r] = v;
      }
      __syncwarp();
      // dO' = bf16( f32(dO) * (1 / z) * inv_keep ), row by row: the swizzle only permutes 16-byte chunks in a row
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint4* src = reinterpret_cast<const uint4*>(smem + KV_DO + s * TILE);
      uint4* doz = reinterpret_cast<uint4*>(smem + KV_DOZ + s * TILE);
      for (int i = lane; i < BN * DH / 8; i += 32) {
        const float f = st[i / 8].y * inv_keep;
        uint4 v = src[i];
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * f);
        doz[i] = v;
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the generic writes, visible to wgmma
      mbar_arrive(ready + 8 * s);
      // refill the slot of tile it - 1 with tile it - 1 + STAGES once the consumers have released it
      if (it >= 1 && it - 1 + STAGES < n_tiles) {
        mbar_wait(empty + 8 * ((it - 1) % STAGES), ((it - 1) / STAGES) & 1);
        if (lane == 0) issue(it - 1 + STAGES);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: 64 keys; this thread's keys key0 and key0 + 8, queries 8 (i / 4) + col0 + (i % 2)
  setmaxnreg_inc<KV_CONSUMER_REGS>();
  const int wg = warp / 4;
  const int row0 = 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int key0 = k0 + wg * BM + row0;
  mbar_wait(kvbar, 0);
  const uint64_t k_desc = desc_sw128(base + KV_K + wg * TILE, 16, 1024);
  const uint64_t v_desc = desc_sw128(base + KV_V + wg * TILE, 16, 1024);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    mbar_wait(full + 8 * s, parity);

    // in two halves of 32 queries, for registers: S^T = K q^T and dP^T = V dO^T (m64n32, both operands K-major),
    // dS^T and Pd^T, then dk += dS^T q and dv += Pd^T dO' with q and dO' as MN-major B operands
    const uint64_t q_desc = desc_sw128(base + KV_Q + s * TILE, 16, 1024);
    const uint64_t do_desc = desc_sw128(base + KV_DO + s * TILE, 16, 1024);
    const uint64_t doz_desc = desc_sw128(base + KV_DOZ + s * TILE, 16, 1024);
    const float4* qs = reinterpret_cast<const float4*>(smem + KV_STAT + s * BN * 16);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float st[16] = {};
      float dpt[16] = {};
      pin(dk);
      pin(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n32(st, k_desc + 2 * kk, q_desc + 256 * half + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n32(dpt, v_desc + 2 * kk, do_desc + 256 * half + 2 * kk, kk);
      wgmma_commit();
      if (half == 0) mbar_wait(ready + 8 * s, parity);  // the queries' statistics and dO', while the products run
      wgmma_wait();
      pin(st);
      pin(dpt);
      uint32_t da[8], pa[8];
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = (i >> 1) & 1;
        const int c = 32 * half + 8 * (i / 4) + col0;
        const float4 a = qs[c];
        const float4 n = qs[c + 1];
        const Entry x = entry(st[i], dpt[i], key0 + 8 * r, valid, a.x, a.y, a.z, __float_as_uint(a.w), drop, rate,
                              inv_keep);
        const Entry y = entry(st[i + 1], dpt[i + 1], key0 + 8 * r, valid, n.x, n.y, n.z, __float_as_uint(n.w), drop,
                              rate, inv_keep);
        da[i / 2] = pack_bf16(x.ds, y.ds);
        pa[i / 2] = pack_bf16(x.pd, y.pd);
      }
      pin(dk);
      pin(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3], q_desc + 128 * (2 * half + kk));
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], doz_desc + 128 * (2 * half + kk));
      wgmma_commit();
      wgmma_wait();
      pin(dk);
      pin(dv);
    }
    mbar_arrive(empty + 8 * s);  // this stage's tiles and statistics are read
  }

  store_rows(dk, SCALE, reinterpret_cast<bf16*>(smem + KV_K + wg * TILE), dst, row_stride, h + head * DH,
             k0 + wg * BM, t, wg);
  store_rows(dv, 1.f, reinterpret_cast<bf16*>(smem + KV_V + wg * TILE), dst, row_stride, 2 * h + head * DH,
             k0 + wg * BM, t, wg);
}

}  // namespace

// qkv: (batch, t, 3 * heads * 64) bf16, 16-byte aligned; lengths: (batch,) int32; seed: one int32 on the
// device (not read at rate 0); out: (batch, t, heads * 64) bf16; stats: (2, batch, heads, t) f32, the row
// maxima and row sums. Returns cudaGetLastError().
extern "C" int thunder_mha_train_fwd(const void* qkv, const int* lengths, const int* seed, void* out, float* stats,
                                     int batch, int t, int heads, float rate, void* stream) {
  if (!(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  return mha_fwd::launch<true>(qkv, lengths, out, stats, seed, rate, batch, t, heads, stream);
}

// o, dout: (batch, t, heads * 64) bf16, 16-byte aligned; stats from the forward; delta: (batch, heads, t) f32
// scratch; dqkv: (batch, t, 3 * heads * 64) bf16, every element written. Launches the dq kernel, then the
// dk/dv kernel (which reads the dq kernel's delta). Returns cudaGetLastError().
extern "C" int thunder_mha_train_bwd(const void* qkv, const int* lengths, const int* seed, const void* o,
                                     const void* dout, const float* stats, float* delta, void* dqkv, int batch, int t,
                                     int heads, float rate, void* stream) {
  if (batch < 1 || batch > 65535 || t < 1 || heads < 1 || heads > 65535 || !(rate >= 0.f && rate < 1.f))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qkv_map, do_map;
  int status = mha_fwd::encode_rows(&qkv_map, qkv, 3 * heads * DH, t, batch);
  if (status != (int)cudaSuccess) return status;
  status = mha_fwd::encode_rows(&do_map, dout, heads * DH, t, batch);
  if (status != (int)cudaSuccess) return status;
  cudaError_t err = cudaFuncSetAttribute(mha_train_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mha_train_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((t + BM * CONSUMERS - 1) / (BM * CONSUMERS), heads, batch);
  mha_train_dq_kernel<<<grid, THREADS, DQ_SMEM, st>>>(qkv_map, do_map, lengths, static_cast<const bf16*>(o),
                                                      static_cast<const bf16*>(dout), stats, seed, rate,
                                                      static_cast<bf16*>(dqkv), delta, t, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mha_train_dkv_kernel<<<grid, THREADS, KV_SMEM, st>>>(qkv_map, do_map, lengths, stats, delta, seed, rate,
                                                       static_cast<bf16*>(dqkv), t, heads);
  return (int)cudaGetLastError();
}
