// Training multi-head attention straight from the packed QKV projection, with
// dropout on the probabilities inside the kernels, forward and backward, for
// Hopper (sm_90a): bf16 in and out, float32 scores, row sums and accumulation.
//
// Replaces: thunder_tpu/kernels/attn_train.py::mha_train (the Pallas TPU kernels
// _fwd_kernel and _bwd_kernel, and _dropout_keep_masks).
// Forward: mha_forward_kernel<true> of mha_forward.cuh: the serving kernel's
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
//
// What bounds it on this card: operations, as the serving kernel: the function
// needs 4 T^2 64 bf16 FLOP a head and row forward and 10 T^2 64 backward (five
// products) against a few T * 64 * 2 bytes. The two backward kernels compute
// seven products (q k^T and dO V^T twice), through nvcuda::wmma fragments staged
// in shared memory by all threads between barriers, far from wgmma's rate.
//
// Design of the backward (simple first, no atomics, the same bits every run):
// - mha_train_dq_kernel, one block of 4 warps per (32 queries, head, batch row):
//   it computes delta for its rows (and writes it for the second kernel), then
//   streams the keys by chunks of 64: S and dP tiles (32 x 64) through wmma into
//   shared memory, dS elementwise with the regenerated mask, dq += dS K in
//   fragments;
// - mha_train_dkv_kernel, one block per (64 keys, head, batch row): its K and V
//   tile stays in shared memory, it streams the queries by chunks of 32, computes
//   the same S, dP, dS and Pd tiles, and accumulates dk += dS^T qh and
//   dv += Pd^T dO' in fragments (the transposed operands are col-major loads of
//   the same tiles: no transpose in memory).
// Both take m and z from the forward, so neither holds a key panel: any T.

#include "mha_forward.cuh"

namespace {

constexpr int LDS = KC + 4;  // f32 row stride of the S and dP tiles

struct BackwardSmem {
  bf16* Qs;    // [QT][LDQ] the scaled q tile
  bf16* dOs;   // [QT][LDQ]
  bf16* dOz;   // [QT][LDQ] dO' (dkv kernel)
  bf16* dSb;   // [QT][LDQ] dS, 64 key columns
  bf16* Pdb;   // [QT][LDQ] Pd (dkv kernel)
  bf16* Ks;    // [KC][LDQ]
  bf16* Vs;    // [KC][LDQ]
  float* S;    // [QT][LDS], then with dP the staging tile of the outputs
  float* dP;   // [QT][LDS]
  float* m;    // [QT] row max, 1 / z, delta
  float* invz;
  float* delta;
  uint32_t* key;  // [QT] dropout row keys
};

constexpr size_t BACKWARD_SMEM_BYTES =
    (5 * QT + 2 * KC) * LDQ * sizeof(bf16) + 2 * QT * LDS * sizeof(float) + 4 * QT * sizeof(float);
static_assert(2 * QT * LDS >= KC * LDS, "S and dP together stage a 64-row output tile");

__device__ inline BackwardSmem carve(unsigned char* smem) {
  BackwardSmem s;
  s.Qs = reinterpret_cast<bf16*>(smem);
  s.dOs = s.Qs + QT * LDQ;
  s.dOz = s.dOs + QT * LDQ;
  s.dSb = s.dOz + QT * LDQ;
  s.Pdb = s.dSb + QT * LDQ;
  s.Ks = s.Pdb + QT * LDQ;
  s.Vs = s.Ks + KC * LDQ;
  s.S = reinterpret_cast<float*>(s.Vs + KC * LDQ);
  s.dP = s.S + QT * LDS;
  s.m = s.dP + QT * LDS;
  s.invz = s.m + QT;
  s.delta = s.invz + QT;
  s.key = reinterpret_cast<uint32_t*>(s.delta + QT);
  return s;
}

// For queries [q0, q0 + QT) and keys [k0, k0 + KC), from the tiles in shared memory: S = qh K^T and
// dP = dO V^T, then dS (bf16) and, with PD, the kept unnormalised probabilities Pd (bf16). Entries of
// queries or keys beyond T are 0. Ends with a barrier.
template <bool PD>
__device__ inline void ds_tile(const BackwardSmem& s, int q0, int k0, int t, int len, bool drop, float rate,
                               float inv_keep, int wr, int wc) {
  tile_abt(s.S, LDS, s.Qs, s.Ks, wr, wc);
  tile_abt(s.dP, LDS, s.dOs, s.Vs, wr, wc);
  __syncthreads();
  for (int i = threadIdx.x; i < QT * KC; i += THREADS) {
    const int r = i / KC;
    const int c = i % KC;
    const int j = k0 + c;
    float ds = 0.f, pd = 0.f;
    if (j < t && q0 + r < t) {
      const float e = expf(s.S[r * LDS + c] + (j < len ? 0.f : NEG) - s.m[r]);
      const bool kept = !drop || thunder_dropout::keep(s.key[r], (uint32_t)j, rate);
      float dp = s.dP[r * LDS + c];
      if (drop) dp = kept ? dp * inv_keep : 0.f;
      ds = e * (dp - s.delta[r]) * s.invz[r];
      pd = kept ? e : 0.f;
    }
    s.dSb[r * LDQ + c] = __float2bfloat16(ds);
    if (PD) s.Pdb[r * LDQ + c] = __float2bfloat16(pd);
  }
  __syncthreads();
}

// the row statistics of queries [q0, q0 + QT): m, 1 / z, the dropout row key (threads 0..QT-1)
__device__ inline void load_row_stats(const BackwardSmem& s, const float* __restrict__ stats, size_t plane, size_t at0,
                                      int q0, int t, bool drop, uint32_t seed, uint32_t stream) {
  const int r = threadIdx.x;
  if (r < QT) {
    const bool valid = q0 + r < t;
    s.m[r] = valid ? stats[at0 + q0 + r] : 0.f;
    s.invz[r] = valid ? 1.f / stats[plane + at0 + q0 + r] : 0.f;
    s.key[r] = drop ? thunder_dropout::row_key(seed, stream, (uint32_t)(q0 + r)) : 0u;
  }
}

// a (rows x 64) f32 tile staged in shared memory -> bf16 columns [col, col + 64) of rows [r0, r0 + rows) of dqkv
__device__ inline void store_tile(bf16* __restrict__ dst, size_t row_stride, int col, const float* tile, int r0, int rows,
                                  int t, float scale) {
  for (int i = threadIdx.x; i < rows * (DH / 8); i += THREADS) {
    const int r = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    if (r0 + r >= t) continue;
    uint4 v;
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(tile[r * LDS + c + j] * scale);
    *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * row_stride + col + c) = v;
  }
}

__global__ void __launch_bounds__(THREADS)
    mha_train_dq_kernel(const bf16* __restrict__ qkv, const int* __restrict__ lengths, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, const float* __restrict__ stats, const int* __restrict__ seed,
                        float rate, bf16* __restrict__ dqkv, float* __restrict__ delta, int t, int heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BackwardSmem s = carve(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int q0 = blockIdx.x * QT;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int h = heads * DH;
  const size_t row_stride = 3 * (size_t)h;
  const bf16* base = qkv + (size_t)b * t * row_stride;
  const bf16* obase = o + (size_t)b * t * h;
  const bf16* dobase = dout + (size_t)b * t * h;
  const int len = lengths[b];
  const bool drop = rate > 0.f;
  const float inv_keep = 1.f / (1.f - rate);
  const size_t at0 = ((size_t)b * heads + head) * t;

  load_rows(s.Qs, base, row_stride, head * DH, q0, QT, t, true);
  load_rows(s.dOs, dobase, h, head * DH, q0, QT, t, false);
  load_row_stats(s, stats, (size_t)gridDim.z * heads * t, at0, q0, t, drop, drop ? (uint32_t)seed[0] : 0u,
                 (uint32_t)(b * heads + head));
  {  // delta[r] = sum_d f32(dO) * f32(O): 4 threads a row, 16 values each
    const int r = tid / 4;
    const int c = (tid % 4) * 16;
    float acc = 0.f;
    if (q0 + r < t) {
      const size_t at = (size_t)(q0 + r) * h + head * DH + c;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4 dv = *reinterpret_cast<const uint4*>(dobase + at + 8 * half);
        const uint4 ov = *reinterpret_cast<const uint4*>(obase + at + 8 * half);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc += __bfloat162float(de[j]) * __bfloat162float(oe[j]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (tid % 4 == 0) {
      s.delta[r] = acc;
      if (q0 + r < t) delta[at0 + q0 + r] = acc;
    }
  }

  const int wr = (warp / 2) * 16;
  const int wc = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int k0 = 0; k0 < t; k0 += KC) {
    load_rows(s.Ks, base, row_stride, h + head * DH, k0, KC, t, false);
    load_rows(s.Vs, base, row_stride, 2 * h + head * DH, k0, KC, t, false);
    __syncthreads();
    ds_tile<false>(s, q0, k0, t, len, drop, rate, inv_keep, wr, wc);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {  // dq += dS (QT x KC) . K (KC x 64)
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, s.dSb + wr * LDQ + kk, LDQ);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, s.Ks + kk * LDQ + wc + 16 * j, LDQ);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();  // the next chunk overwrites Ks, Vs and the tiles
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::store_matrix_sync(s.S + wr * LDS + wc + 16 * j, acc[j], LDS, wmma::mem_row_major);
  __syncthreads();
  store_tile(dqkv + (size_t)b * t * row_stride, row_stride, head * DH, s.S, q0, QT, t, 0.125f);
}

__global__ void __launch_bounds__(THREADS)
    mha_train_dkv_kernel(const bf16* __restrict__ qkv, const int* __restrict__ lengths, const bf16* __restrict__ dout,
                         const float* __restrict__ stats, const float* __restrict__ delta, const int* __restrict__ seed,
                         float rate, bf16* __restrict__ dqkv, int t, int heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BackwardSmem s = carve(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int k0 = blockIdx.x * KC;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int h = heads * DH;
  const size_t row_stride = 3 * (size_t)h;
  const bf16* base = qkv + (size_t)b * t * row_stride;
  const bf16* dobase = dout + (size_t)b * t * h;
  const int len = lengths[b];
  const bool drop = rate > 0.f;
  const float inv_keep = 1.f / (1.f - rate);
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const size_t at0 = ((size_t)b * heads + head) * t;

  load_rows(s.Ks, base, row_stride, h + head * DH, k0, KC, t, false);
  load_rows(s.Vs, base, row_stride, 2 * h + head * DH, k0, KC, t, false);

  const int wr = (warp / 2) * 16;
  const int wc = (warp % 2) * 32;
  // this warp's 16 keys x 64 of dk and dv
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[4], dv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }
  for (int q0 = 0; q0 < t; q0 += QT) {
    load_rows(s.Qs, base, row_stride, head * DH, q0, QT, t, true);
    load_rows(s.dOs, dobase, h, head * DH, q0, QT, t, false);
    load_row_stats(s, stats, (size_t)gridDim.z * heads * t, at0, q0, t, drop, sd, (uint32_t)(b * heads + head));
    if (tid < QT) s.delta[tid] = q0 + tid < t ? delta[at0 + q0 + tid] : 0.f;
    __syncthreads();
    for (int i = tid; i < QT * DH; i += THREADS) {  // dO' = bf16( f32(dO) * (1 / z) * inv_keep )
      const int r = i / DH;
      const int c = i % DH;
      s.dOz[r * LDQ + c] = __float2bfloat16(__bfloat162float(s.dOs[r * LDQ + c]) * (s.invz[r] * inv_keep));
    }
    ds_tile<true>(s, q0, k0, t, len, drop, rate, inv_keep, wr, wc);
#pragma unroll
    for (int kk = 0; kk < QT; kk += 16) {
      // the transposed tiles as col-major operands: element (key, query) of dS^T at dSb[query * LDQ + key]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fs, fp;
      wmma::load_matrix_sync(fs, s.dSb + kk * LDQ + 16 * warp, LDQ);
      wmma::load_matrix_sync(fp, s.Pdb + kk * LDQ + 16 * warp, LDQ);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fq, fo;
        wmma::load_matrix_sync(fq, s.Qs + kk * LDQ + 16 * j, LDQ);
        wmma::load_matrix_sync(fo, s.dOz + kk * LDQ + 16 * j, LDQ);
        wmma::mma_sync(dk[j], fs, fq, dk[j]);
        wmma::mma_sync(dv[j], fp, fo, dv[j]);
      }
    }
    __syncthreads();  // the next chunk overwrites the q, dO and the tiles
  }
  float* stage = s.S;  // [KC][LDS] over S and dP
  bf16* dst = dqkv + (size_t)b * t * row_stride;
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(stage + 16 * warp * LDS + 16 * j, dk[j], LDS, wmma::mem_row_major);
  __syncthreads();
  store_tile(dst, row_stride, h + head * DH, stage, k0, KC, t, 1.f);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(stage + 16 * warp * LDS + 16 * j, dv[j], LDS, wmma::mem_row_major);
  __syncthreads();
  store_tile(dst, row_stride, 2 * h + head * DH, stage, k0, KC, t, 1.f);
}

}  // namespace

// qkv: (batch, t, 3 * heads * 64) bf16, 16-byte aligned; lengths: (batch,) int32; seed: one int32 on the
// device (not read at rate 0); out: (batch, t, heads * 64) bf16; stats: (2, batch, heads, t) f32, the row
// maxima and row sums. Returns cudaGetLastError().
extern "C" int thunder_mha_train_fwd(const void* qkv, const int* lengths, const int* seed, void* out, float* stats,
                                     int batch, int t, int heads, float rate, void* stream) {
  if (!(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  return launch_mha_forward<true>(qkv, lengths, out, stats, seed, rate, batch, t, heads, stream);
}

// o, dout: (batch, t, heads * 64) bf16; stats from the forward; delta: (batch, heads, t) f32 scratch;
// dqkv: (batch, t, 3 * heads * 64) bf16, every element written. Launches the dq kernel, then the
// dk/dv kernel. Returns cudaGetLastError().
extern "C" int thunder_mha_train_bwd(const void* qkv, const int* lengths, const int* seed, const void* o,
                                     const void* dout, const float* stats, float* delta, void* dqkv, int batch, int t,
                                     int heads, float rate, void* stream) {
  if (batch < 1 || batch > 65535 || t < 1 || heads < 1 || heads > 65535 || !(rate >= 0.f && rate < 1.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = (int)BACKWARD_SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(mha_train_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mha_train_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bf16* qkv_ = static_cast<const bf16*>(qkv);
  const bf16* dout_ = static_cast<const bf16*>(dout);
  mha_train_dq_kernel<<<dim3((t + QT - 1) / QT, heads, batch), THREADS, smem, st>>>(
      qkv_, lengths, static_cast<const bf16*>(o), dout_, stats, seed, rate, static_cast<bf16*>(dqkv), delta, t, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mha_train_dkv_kernel<<<dim3((t + KC - 1) / KC, heads, batch), THREADS, smem, st>>>(
      qkv_, lengths, dout_, stats, delta, seed, rate, static_cast<bf16*>(dqkv), t, heads);
  return (int)cudaGetLastError();
}
