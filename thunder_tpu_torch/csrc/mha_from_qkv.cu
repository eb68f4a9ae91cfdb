// Serving multi-head attention straight from the packed QKV projection, for
// Hopper (sm_90a): bf16 in and out, float32 scores, row sums and accumulation.
//
// Replaces: thunder_tpu/kernels/attn_onepanel.py::mha_from_qkv (the Pallas TPU kernel).
// For a packed qkv (B, T, 3H), head h, query t and key j (dh = 64, H = heads * 64):
//   q      = bf16( qkv[b, t, h*64 : h*64+64] * bf16(0.125) )           (0.125 = dh^-0.5, exact)
//   s[j]   = sum_d q[d] * qkv[b, j, H + h*64 + d]  (f32)  + (j < len[b] ? 0 : -FLT_MAX)
//   p[j]   = exp(s[j] - max_j s[j])                       (f32), z = sum_j p[j]
//   out[b, t, h*64 + d] = bf16( sum_j bf16(p[j]) * qkv[b, j, 2H + h*64 + d] / z )
// The mask is added, never -inf: a row of length 0 averages every key and stays
// finite, and padded query rows attend the valid keys like any other row.
//
// What bounds it on this card: operations. 4 * T^2 * 64 bf16 FLOP per (row,
// head) against 2 * T * 3 * 64 bytes of qkv in and T * 64 * 2 out: at T = 749
// about 250 operations a byte, so the tensor cores bound it, not memory. In this
// first version the staging is the real limit: nvcuda::wmma (mma.sync) fragments
// read through shared memory, K and V chunks loaded by all threads between two
// barriers with no overlap, and 4 warps a block, far from wgmma's rate.
//
// Design (simple first; wgmma, TMA, a streaming softmax and warp specialisation
// are later work):
// - one block of 4 warps per (query tile of QT = 32 rows, head, batch row);
// - the q tile, pre-scaled, sits in shared memory; keys go by chunks of 64
//   (zero beyond T) through one shared K/V buffer;
// - S = q k^T for the whole key panel goes to shared memory as f32
//   (32 x round_up(T, 64) floats: 99 KB at T = 749, 197 KB at T = 1536);
// - each warp takes 8 rows of the softmax: the masked row max, then exp(s - m)
//   summed in f32 and written as bf16 IN PLACE over the row's own f32 scores
//   (column j's two bytes lie inside floats already read), so no second panel;
// - P V accumulates in wmma fragments over the same key chunks; the epilogue
//   stages O through shared memory, divides by the row sums and stores bf16
//   with 16-byte writes.
// The TPU kernel's head-pair lane packing (for Mosaic's 128-lane blocks) and
// its T % 128 requirement are not carried over: T is any length up to 1664.

#include <cfloat>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int DH = 64;        // head width
constexpr int QT = 32;        // query rows per block
constexpr int KC = 64;        // keys per staged K or V chunk
constexpr int THREADS = 128;  // 4 warps: a 2 x 2 grid of 16 x 32 warp tiles over QT x 64
constexpr int LDQ = DH + 8;   // bf16 row stride of the q tile and the K/V chunk
constexpr int LDO = DH + 4;   // f32 row stride of the staged output tile
constexpr float NEG = -FLT_MAX;  // finfo(float32).min, the additive key mask

static_assert(QT == 2 * 16 && DH == 2 * 32 && THREADS == 4 * 32, "warp tiling");
static_assert(QT * LDO * sizeof(float) <= KC * LDQ * sizeof(bf16), "the output tile reuses the K/V buffer");

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// f32 row stride of the score panel: every key chunk, plus 4 floats against bank conflicts
__host__ __device__ inline int score_ld(int t) { return round_up(t, KC) + 4; }

size_t smem_bytes(int t) {
  return (size_t)QT * score_ld(t) * sizeof(float)  // S, then P (bf16) in place
         + (size_t)QT * LDQ * sizeof(bf16)         // q tile
         + (size_t)KC * LDQ * sizeof(bf16)         // K or V chunk, then the output tile
         + (size_t)QT * sizeof(float);             // row sums
}

// keys [k0, k0 + KC) of one head's 64 columns starting at `col`, zero beyond T
__device__ inline void load_chunk(bf16* dst, const bf16* base, size_t row_stride, int col, int k0, int t) {
  for (int i = threadIdx.x; i < KC * (DH / 8); i += THREADS) {
    const int r = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    const int key = k0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (key < t) v = *reinterpret_cast<const uint4*>(base + (size_t)key * row_stride + col + c);
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = v;
  }
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
    mha_from_qkv_kernel(const bf16* __restrict__ qkv, const int* __restrict__ lengths, bf16* __restrict__ out, int t,
                        int heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = score_ld(t);
  const int t_pad = round_up(t, KC);
  float* S = reinterpret_cast<float*>(smem);             // [QT][ld] f32
  bf16* P = reinterpret_cast<bf16*>(smem);               // [QT][2 * ld] bf16, in place over S
  bf16* Qs = reinterpret_cast<bf16*>(S + (size_t)QT * ld);  // [QT][LDQ]
  bf16* KV = Qs + QT * LDQ;                              // [KC][LDQ]
  float* rowsum = reinterpret_cast<float*>(KV + KC * LDQ);  // [QT]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int h = heads * DH;
  const size_t row_stride = 3 * (size_t)h;
  const bf16* base = qkv + (size_t)b * t * row_stride;
  const int len = lengths[b];

  // ---- the q tile, multiplied by bf16(dh^-0.5) = 0.125 (exact)
  for (int i = tid; i < QT * (DH / 8); i += THREADS) {
    const int r = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < t) v = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * row_stride + head * DH + c);
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * 0.125f);
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c) = v;
  }

  // ---- S = q k^T over the whole key panel
  const int wr = (warp / 2) * 16;  // warp tile rows
  const int wc = (warp % 2) * 32;  // warp tile columns within a chunk (keys for S, dh for O)
  for (int k0 = 0; k0 < t_pad; k0 += KC) {
    load_chunk(KV, base, row_stride, h + head * DH, k0, t);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, Qs + wr * LDQ + kk, LDQ);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // k^T as a col-major (dh x keys) operand: element (d, key) at KV[key * LDQ + d]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, KV + (wc + 16 * j) * LDQ + kk, LDQ);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(S + (size_t)wr * ld + k0 + wc + 16 * j, acc[j], ld, wmma::mem_row_major);
    __syncthreads();  // the next chunk overwrites KV
  }

  // ---- softmax, a warp per row: masked max, then exp(s - m) as bf16 in place, f32 row sum
  for (int r = warp; r < QT; r += THREADS / 32) {
    const float* srow = S + (size_t)r * ld;
    bf16* prow = P + (size_t)r * 2 * ld;
    float m = -INFINITY;
    for (int j = lane; j < t; j += 32) m = fmaxf(m, srow[j] + (j < len ? 0.f : NEG));
    m = warp_max(m);
    float z = 0.f;
    for (int j0 = 0; j0 < t_pad; j0 += 32) {
      const int j = j0 + lane;
      const float p = j < t ? expf(srow[j] + (j < len ? 0.f : NEG) - m) : 0.f;
      __syncwarp();  // every lane has read floats j0..j0+31 before bf16 j0..j0+31 (floats j0/2..) are written
      prow[j] = __float2bfloat16(p);
      z += p;
    }
    z = warp_sum(z);
    if (lane == 0) rowsum[r] = z;
  }
  __syncthreads();

  // ---- O = P V over the same key chunks
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[2];
  wmma::fill_fragment(o[0], 0.f);
  wmma::fill_fragment(o[1], 0.f);
  for (int k0 = 0; k0 < t_pad; k0 += KC) {
    load_chunk(KV, base, row_stride, 2 * h + head * DH, k0, t);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, P + (size_t)wr * 2 * ld + k0 + kk, 2 * ld);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, KV + kk * LDQ + wc + 16 * j, LDQ);
        wmma::mma_sync(o[j], fa, fb, o[j]);
      }
    }
    __syncthreads();  // the next chunk (or the output tile) overwrites KV
  }

  // ---- epilogue: O / z as bf16, 8 values (16 bytes) a thread
  float* Os = reinterpret_cast<float*>(KV);  // [QT][LDO]
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::store_matrix_sync(Os + wr * LDO + wc + 16 * j, o[j], LDO, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < QT * (DH / 8); i += THREADS) {
    const int r = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    if (q0 + r >= t) continue;
    const float z = rowsum[r];
    uint4 v;
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(Os[r * LDO + c + j] / z);
    *reinterpret_cast<uint4*>(out + ((size_t)b * t + q0 + r) * h + head * DH + c) = v;
  }
}

}  // namespace

// qkv: (batch, t, 3 * heads * 64) bf16, 16-byte aligned; lengths: (batch,) int32;
// out: (batch, t, heads * 64) bf16. Returns cudaGetLastError().
extern "C" int thunder_mha_from_qkv(const void* qkv, const int* lengths, void* out, int batch, int t, int heads,
                                    void* stream) {
  if (batch < 1 || batch > 65535 || t < 1 || heads < 1 || heads > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(t);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mha_from_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + QT - 1) / QT, heads, batch);
  mha_from_qkv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), lengths, static_cast<bf16*>(out), t, heads);
  return (int)cudaGetLastError();
}
