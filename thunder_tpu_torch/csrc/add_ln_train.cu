// Residual add + dropout + LayerNorm for training, forward and backward, for
// Hopper (sm_90a): bf16 activations, float32 statistics and parameters.
//
// Replaces: thunder_tpu/kernels/add_ln_train.py::add_ln_dropout_train (forward
// and backward Pallas TPU kernels) and ::dropout_keep_mask.
// Forward, for rows of D features:
//   yd  = keep ? float(y) / (1 - rate) : 0            (keep: dropout_hash.cuh, stream 0, row + row_offset)
//   s   = float(x) + yd
//   out = bf16( (s - mean) * (rsqrt(max(E[s^2] - mean^2, 0) + eps) * g) + b )
// It saves no statistics. Backward re-reads x and y, regenerates the mask,
// recomputes mean and rstd, and with shat = (s - mean) * rstd, gd = do * g:
//   ds = rstd * (gd - mean(gd) - shat * mean(gd * shat))
//   dx = bf16(ds),  dy = bf16(keep ? ds / (1 - rate) : 0)
//   dg = sum_rows do * shat,  db = sum_rows do         (float32)
//
// What bounds it on this card: bytes. The forward reads two bf16 values and
// writes one per element (3 passes), the backward reads three and writes two
// (5 passes), each for a few dozen float32 operations and one 32-bit hash. At
// wav2vec2-base's training step (5,992 rows of 768, rate 0.1) the bounds are
// 0.0082 ms and 0.0137 ms at 3.35 TB/s, and a step finds the inputs in device
// memory, not in the L2. L2-cold device time a call, six input sets in turns
// (kernels/compare_builds.py --parts add_ln; NVIDIA H100 80GB HBM3, 700 W):
//                      before this design      this design
//   forward                0.0126-0.0129        (unchanged: 65 % of its bound)
//   backward + sum         0.0507-0.0515        0.0231-0.0234
// of which the backward kernel 0.038 -> 0.021 ms and the sum 0.0074 -> 0.0022.
//
// Forward: one warp per row, as add_ln.cu: a lane keeps VECS 16-byte vectors of
// the row in registers (D <= 256 * VECS; the kernels are instantiated for VECS
// = 1, 2, 3, 4, 6, 8) and the row statistics go through warp shuffles.
//
// Backward: the TPU kernel carries dg and db across a sequential grid; here the
// rows run concurrently. The grid comes from the SM count, BWD_BLOCKS_PER_SM
// blocks an SM (264 on 132 SMs, both resident: 118 registers a thread at VECS
// = 3, 77 KB of shared memory a block at D = 768), and block b takes a
// balanced range of rows, its warp w the rows lo + w, lo + w + 8, ... So the
// card is full at 5,992 rows (an earlier design's 8 rows a warp left 94 blocks
// on 132 SMs). Each warp streams its rows through a ring of two rows in shared
// memory filled by 16-byte cp.async: a row's x, y and dout are all in flight
// before its first reduction, and once a row has landed the next row's loads
// are issued before its arithmetic (an earlier design loaded dout only after
// the statistics, with nothing of the next row in flight). A ring of three
// rows, issuing after the arithmetic, and four warps a block were each slower
// at the step's shape. The ring keeps the registers for the warp's share of
// dg and db, which stays in registers across its rows; the block's warps then
// add their shares in warp order through shared memory into ONE partial row a
// block (1.6 MB at the step's shape, from 4.6 MB for a partial row a warp), and
// a second small kernel, launched as a programmatic dependent launch so that
// its launch overlaps the backward's end, sums the partial rows by columns
// (32) and groups of partial rows (32), on 2 x 24 blocks at D = 768, in a fixed
// order. No float atomics: the same inputs give the same bits from run to run.
// The keep bits are the hash's integer compare (dropout_hash.cuh, keep_at).
// Even L2-warm the backward takes most of its cold time: latency, not bytes,
// is what is left (16 warps an SM, two warp reductions a row).
// Any other width (not a multiple of 8, over 2048, or a tensor not 16-byte
// aligned) runs the *_any kernels: the forward a warp a row, the backward a
// block a row over the same blocks' rows, each a bf16 a thread at a time,
// re-reading x and y (and regenerating the mask) in each pass instead of
// keeping the row in registers; a thread keeps the columns it owns of the
// block's partial row of dg and db in the workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "dropout_hash.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;              // warps per block
constexpr int BWD_BLOCKS_PER_SM = 2;  // backward: the grid, and so the partial rows of dg and db, from the SM count
constexpr int MASK_BLOCKS_PER_SM = 8;  // the keep mask: 64 warps an SM, the most an SM holds
constexpr int RED_X = 32, RED_Y = 32;  // the partial sum's block: 32 columns by 32 strided groups of partial rows

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// both sums across the warp, their shuffles interleaved
__device__ inline void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

__device__ inline void unpack8(const uint4& a, float (&v)[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&a);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
}

// s = x + dropout(y) of one vector of 8, with its keep bits
__device__ inline void sum_vec(const uint4& xa, const uint4& ya, unsigned kept, float rate, float inv_keep,
                               float (&s)[8]) {
  float xv[8], yv[8];
  unpack8(xa, xv);
  unpack8(ya, yv);
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = xv[j] + (rate > 0.f ? ((kept >> j & 1u) ? yv[j] * inv_keep : 0.f) : yv[j]);
}

// the keep bits of vector c of a row (thunder_dropout::keep as its integer compare at the rate's threshold)
__device__ inline unsigned keep_bits(uint32_t key, int c, float rate, uint32_t threshold) {
  unsigned kept = 0xffu;
  if (rate > 0.f) {
    kept = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      kept |= (thunder_dropout::keep_at(key, (uint32_t)(c * 8 + j), threshold) ? 1u : 0u) << j;
    }
  }
  return kept;
}

// s = x + dropout(y) of one row into registers; returns the keep bits of each vector
template <int VECS>
__device__ inline void load_sum(const bf16* __restrict__ x, const bf16* __restrict__ y, int row, int d, int lane,
                                uint32_t seed, uint32_t row_offset, float rate, float inv_keep, float (&s)[VECS][8],
                                unsigned (&kept)[VECS], float& sum, float& sq) {
  const int nvec = d / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  const uint4* yr = reinterpret_cast<const uint4*>(y + (size_t)row * d);
  const uint32_t key = thunder_dropout::row_key(seed, 0u, (uint32_t)row + row_offset);
  sum = 0.f;
  sq = 0.f;
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int c = lane + 32 * i;
    kept[i] = 0xffu;
    if (c < nvec) {
      const uint4 xa = xr[c];
      const uint4 ya = yr[c];
      const bf16* xe = reinterpret_cast<const bf16*>(&xa);
      const bf16* ye = reinterpret_cast<const bf16*>(&ya);
      if (rate > 0.f) {
        kept[i] = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j) kept[i] |= (thunder_dropout::keep(key, (uint32_t)(c * 8 + j), rate) ? 1u : 0u) << j;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float yd = __bfloat162float(ye[j]);
        if (rate > 0.f) yd = (kept[i] >> j & 1u) ? yd * inv_keep : 0.f;
        const float v = __bfloat162float(xe[j]) + yd;
        s[i][j] = v;
        sum += v;
        sq += v * v;
      }
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
}

__device__ inline void load8(const float* __restrict__ p, int c, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[2 * c];
  const float4 b = reinterpret_cast<const float4*>(p)[2 * c + 1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <int VECS>
__global__ void __launch_bounds__(WARPS * 32)
    add_ln_train_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const float* __restrict__ g,
                            const float* __restrict__ b, const int* __restrict__ seed, bf16* __restrict__ out, int rows,
                            int d, float rate, float eps, uint32_t row_offset) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int nvec = d / 8;
  const float inv_keep = 1.f / (1.f - rate);
  float s[VECS][8];
  unsigned kept[VECS];
  float sum, sq;
  load_sum<VECS>(x, y, row, d, lane, (uint32_t)seed[0], row_offset, rate, inv_keep, s, kept, sum, sq);
  const float mean = sum / d;
  const float rstd = rsqrtf(fmaxf(sq / d - mean * mean, 0.f) + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * d);
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      float gv[8], bv[8];
      load8(g, c, gv);
      load8(b, c, bv);
      uint4 o;
      bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int j = 0; j < 8; ++j) oe[j] = __float2bfloat16((s[i][j] - mean) * (rstd * gv[j]) + bv[j]);
      orow[c] = o;
    }
  }
}

// the rows of block `blk` of `blocks` in the backward: [lo, hi), a balanced split (every block gets one or more)
__device__ inline void block_rows(int rows, int blocks, int blk, int& lo, int& hi) {
  lo = (int)((long long)blk * rows / blocks);
  hi = (int)((long long)(blk + 1) * rows / blocks);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Backward, rows in registers: block b takes rows [lo, hi) (block_rows), warp w of it rows lo + w, lo + w + WARPS,
// ...; each warp streams its rows through a ring of two rows (x, y, dout) in shared memory, filled by 16-byte
// cp.async: once a row has landed, the next row's loads are issued, then this row's arithmetic runs. A lane reads
// back only the vectors it copied, so the ring needs no barrier. Three passes over the row: statistics, the two
// means and this lane's share of dg and db (registers), then dx and dy. At the end the warps' shares of dg and db
// meet in shared memory and are added in warp order into the block's partial row.
template <int VECS>
__global__ void __launch_bounds__(WARPS * 32, VECS <= 4 ? 2 : 1)
    add_ln_train_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const float* __restrict__ g,
                            const int* __restrict__ seed, const bf16* __restrict__ dout, bf16* __restrict__ dx,
                            bf16* __restrict__ dy, float* __restrict__ part_g, float* __restrict__ part_b, int rows,
                            int d, float rate, float eps, uint32_t row_offset) {
  constexpr bool KEEP_S = VECS <= 3;  // the row's shat stays in registers; wider rows re-read x and y from the ring
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nvec = d / 8;
  float4* g_lo = reinterpret_cast<float4*>(smem);  // [nvec] scale, columns 8c..8c+3, then [nvec] 8c+4..8c+7
  float4* g_hi = g_lo + nvec;
  uint4* ring = reinterpret_cast<uint4*>(g_hi + nvec) + (size_t)warp * 6 * nvec;  // [2][x, y, dout][nvec]
  int lo, hi;
  block_rows(rows, gridDim.x, blockIdx.x, lo, hi);
  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    g_lo[c] = reinterpret_cast<const float4*>(g)[2 * c];
    g_hi[c] = reinterpret_cast<const float4*>(g)[2 * c + 1];
  }
  const uint32_t threshold = thunder_dropout::threshold(rate);
  const float inv_keep = 1.f / (1.f - rate);
  const uint32_t sd = (uint32_t)seed[0];

  auto issue = [&](int row, int stage) {  // row's x, y and dout into the ring's stage; an empty group past hi
    if (row < hi) {
      uint4* st = ring + stage * 3 * nvec;
      const uint4* xr = reinterpret_cast<const uint4*>(x) + (size_t)row * nvec;
      const uint4* yr = reinterpret_cast<const uint4*>(y) + (size_t)row * nvec;
      const uint4* dr = reinterpret_cast<const uint4*>(dout) + (size_t)row * nvec;
#pragma unroll
      for (int i = 0; i < VECS; ++i) {
        const int c = lane + 32 * i;
        if (c < nvec) {
          cp_async16(st + c, xr + c);
          cp_async16(st + nvec + c, yr + c);
          cp_async16(st + 2 * nvec + c, dr + c);
        }
      }
    }
    cp_async_commit();
  };
  const int first = lo + warp;
  issue(first, 0);

  float acc_g[VECS][8], acc_b[VECS][8];
#pragma unroll
  for (int i = 0; i < VECS; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_g[i][j] = acc_b[i][j] = 0.f;
  __syncthreads();  // the scale is in shared memory

  int stage = 0;
  for (int row = first; row < hi; row += WARPS) {
    cp_async_wait_all();  // this row's x, y and dout
    issue(row + WARPS, stage ^ 1);  // the next row's, into the half the previous row left
    const uint4* sx = ring + stage * 3 * nvec;
    const uint4* sy = sx + nvec;
    const uint4* sdo = sx + 2 * nvec;
    const uint32_t key = thunder_dropout::row_key(sd, 0u, (uint32_t)row + row_offset);
    unsigned kept[VECS];
    float s[KEEP_S ? VECS : 1][8];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < VECS; ++i) {  // stage: statistics
      const int c = lane + 32 * i;
      kept[i] = 0xffu;
      if (c < nvec) {
        kept[i] = keep_bits(key, c, rate, threshold);
        float v[8];
        sum_vec(sx[c], sy[c], kept[i], rate, inv_keep, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sum += v[j];
          sq += v[j] * v[j];
          if constexpr (KEEP_S) s[i][j] = v[j];
        }
      }
    }
    warp_sum2(sum, sq);
    const float mean = sum / d;
    const float rstd = rsqrtf(fmaxf(sq / d - mean * mean, 0.f) + eps);
    float sg = 0.f, sgs = 0.f;
#pragma unroll
    for (int i = 0; i < VECS; ++i) {  // stage: the two means, and this lane's share of dg and db
      const int c = lane + 32 * i;
      if (c < nvec) {
        float v[8], dv[8];
        if constexpr (KEEP_S) {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = s[i][j];
        } else {
          sum_vec(sx[c], sy[c], kept[i], rate, inv_keep, v);
        }
        unpack8(sdo[c], dv);
        const float4 ga = g_lo[c], gb = g_hi[c];
        const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float shat = (v[j] - mean) * rstd;
          const float gdv = __fmul_rn(dv[j], gv[j]);  // rounded, as the next pass recomputes it
          sg += gdv;
          sgs += gdv * shat;
          acc_g[i][j] += dv[j] * shat;
          acc_b[i][j] += dv[j];
          if constexpr (KEEP_S) s[i][j] = shat;
        }
      }
    }
    warp_sum2(sg, sgs);
    const float gm = sg / d;
    const float gsm = sgs / d;
    uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * d);
    uint4* dyr = reinterpret_cast<uint4*>(dy + (size_t)row * d);
#pragma unroll
    for (int i = 0; i < VECS; ++i) {  // stage: dx, dy
      const int c = lane + 32 * i;
      if (c < nvec) {
        float shat[8], dv[8];
        if constexpr (KEEP_S) {
#pragma unroll
          for (int j = 0; j < 8; ++j) shat[j] = s[i][j];
        } else {
          sum_vec(sx[c], sy[c], kept[i], rate, inv_keep, shat);
#pragma unroll
          for (int j = 0; j < 8; ++j) shat[j] = (shat[j] - mean) * rstd;
        }
        unpack8(sdo[c], dv);
        const float4 ga = g_lo[c], gb = g_hi[c];
        const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
        uint4 ox, oy;
        bf16* oxe = reinterpret_cast<bf16*>(&ox);
        bf16* oye = reinterpret_cast<bf16*>(&oy);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float ds = rstd * (__fmul_rn(dv[j], gv[j]) - gm - shat[j] * gsm);
          oxe[j] = __float2bfloat16(ds);
          oye[j] = __float2bfloat16(rate > 0.f ? ((kept[i] >> j & 1u) ? ds * inv_keep : 0.f) : ds);
        }
        dxr[c] = ox;
        dyr[c] = oy;
      }
    }
    stage ^= 1;
  }
  cp_async_wait_all();

  // stage: the block's partial row, the warps' shares added in warp order (each warp's share in its own ring)
  float4* share = reinterpret_cast<float4*>(ring);  // [dg lo, dg hi, db lo, db hi][nvec]
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      share[c] = make_float4(acc_g[i][0], acc_g[i][1], acc_g[i][2], acc_g[i][3]);
      share[nvec + c] = make_float4(acc_g[i][4], acc_g[i][5], acc_g[i][6], acc_g[i][7]);
      share[2 * nvec + c] = make_float4(acc_b[i][0], acc_b[i][1], acc_b[i][2], acc_b[i][3]);
      share[3 * nvec + c] = make_float4(acc_b[i][4], acc_b[i][5], acc_b[i][6], acc_b[i][7]);
    }
  }
  __syncthreads();
  const float4* shares = reinterpret_cast<const float4*>(g_hi + nvec);
  const size_t per_warp = (size_t)6 * nvec;
  for (int q = threadIdx.x; q < 4 * nvec; q += blockDim.x) {
    float4 a = shares[q];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 b = shares[w * per_warp + q];
      a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
    }
    const int part = q / nvec, c = q - part * nvec;
    float* dst = (part < 2 ? part_g : part_b) + (size_t)blockIdx.x * d + 8 * c + 4 * (part & 1);
    *reinterpret_cast<float4*>(dst) = a;
  }
}

// any width and alignment: x + dropout(y) at column c of a row, recomputed in each pass
struct AnyRow {
  const bf16* x;
  const bf16* y;
  uint32_t key;
  float rate, inv_keep;
  __device__ bool kept(int c) const { return rate <= 0.f || thunder_dropout::keep(key, (uint32_t)c, rate); }
  __device__ float operator()(int c) const {
    float yd = __bfloat162float(y[c]);
    if (rate > 0.f) yd = kept(c) ? yd * inv_keep : 0.f;
    return __bfloat162float(x[c]) + yd;
  }
};

__device__ inline AnyRow any_row(const bf16* x, const bf16* y, int row, int d, uint32_t seed, uint32_t row_offset,
                                 float rate) {
  return {x + (size_t)row * d, y + (size_t)row * d, thunder_dropout::row_key(seed, 0u, (uint32_t)row + row_offset),
          rate, 1.f / (1.f - rate)};
}

// (mean, rstd) of one row, a pass over it
__device__ inline void any_stats(const AnyRow& s, int d, int lane, float eps, float& mean, float& rstd) {
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = s(c);
    sum += v;
    sq += v * v;
  }
  mean = warp_sum(sum) / d;
  rstd = rsqrtf(fmaxf(warp_sum(sq) / d - mean * mean, 0.f) + eps);
}

__global__ void __launch_bounds__(WARPS * 32)
    add_ln_train_fwd_any_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const float* __restrict__ g,
                                const float* __restrict__ b, const int* __restrict__ seed, bf16* __restrict__ out,
                                int rows, int d, float rate, float eps, uint32_t row_offset) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const AnyRow s = any_row(x, y, row, d, (uint32_t)seed[0], row_offset, rate);
  float mean, rstd;
  any_stats(s, d, lane, eps, mean, rstd);
  bf16* orow = out + (size_t)row * d;
  for (int c = lane; c < d; c += 32) orow[c] = __float2bfloat16((s(c) - mean) * (rstd * g[c]) + b[c]);
}

// both sums across the block, added in warp order; red: [2][WARPS] shared floats
__device__ inline void block_sum2(float& a, float& b, float (*red)[WARPS]) {
  warp_sum2(a, b);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = red[0][0];
  b = red[1][0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    a += red[0][w];
    b += red[1][w];
  }
  __syncthreads();  // red is free again
}

// Backward, any width: block b takes rows [lo, hi) (block_rows) one after the other, a row across the whole block
// (column c to thread c % blockDim.x), re-reading x and y in each pass; thread t keeps the columns it owns of the
// block's partial row of dg and db in the workspace, so one partial row a block as the vectorised kernel.
__global__ void __launch_bounds__(WARPS * 32)
    add_ln_train_bwd_any_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const float* __restrict__ g,
                                const int* __restrict__ seed, const bf16* __restrict__ dout, bf16* __restrict__ dx,
                                bf16* __restrict__ dy, float* __restrict__ part_g, float* __restrict__ part_b,
                                int rows, int d, float rate, float eps, uint32_t row_offset) {
  __shared__ float red[2][WARPS];
  const int tid = threadIdx.x, nt = blockDim.x;
  int lo, hi;
  block_rows(rows, gridDim.x, blockIdx.x, lo, hi);
  float* pg = part_g + (size_t)blockIdx.x * d;
  float* pb = part_b + (size_t)blockIdx.x * d;
  for (int row = lo; row < hi; ++row) {
    const AnyRow s = any_row(x, y, row, d, (uint32_t)seed[0], row_offset, rate);
    float sum = 0.f, sq = 0.f;
    for (int c = tid; c < d; c += nt) {
      const float v = s(c);
      sum += v;
      sq += v * v;
    }
    block_sum2(sum, sq, red);
    const float mean = sum / d;
    const float rstd = rsqrtf(fmaxf(sq / d - mean * mean, 0.f) + eps);
    const bf16* dor = dout + (size_t)row * d;
    float sg = 0.f, sgs = 0.f;
    for (int c = tid; c < d; c += nt) {  // the row's two means, and its share of dg and db (same thread, in order)
      const float shat = (s(c) - mean) * rstd;
      const float dov = __bfloat162float(dor[c]);
      const float gdv = __fmul_rn(dov, g[c]);  // rounded, as the next pass recomputes it: no fused multiply-add
      sg += gdv;
      sgs += gdv * shat;
      pg[c] = (row == lo ? 0.f : pg[c]) + dov * shat;
      pb[c] = (row == lo ? 0.f : pb[c]) + dov;
    }
    block_sum2(sg, sgs, red);
    const float gm = sg / d;
    const float gsm = sgs / d;
    bf16* dxr = dx + (size_t)row * d;
    bf16* dyr = dy + (size_t)row * d;
    for (int c = tid; c < d; c += nt) {
      const float shat = (s(c) - mean) * rstd;
      const float ds = rstd * (__fmul_rn(__bfloat162float(dor[c]), g[c]) - gm - shat * gsm);
      dxr[c] = __float2bfloat16(ds);
      dyr[c] = __float2bfloat16(rate > 0.f ? (s.kept(c) ? ds * s.inv_keep : 0.f) : ds);
    }
  }
}

// dg[c] = sum_p part_g[p][c] (blockIdx.y 0), db likewise (1), in a fixed order: thread (cx, py) sums the partial
// rows py, py + RED_Y, ... in turn, then the RED_Y sums of a column are added in order
__global__ void __launch_bounds__(RED_X * RED_Y)
    add_ln_train_sum_kernel(const float* __restrict__ part_g, const float* __restrict__ part_b, float* __restrict__ dg,
                            float* __restrict__ db, int parts, int d) {
  __shared__ float sh[RED_Y][RED_X];
  asm volatile("griddepcontrol.wait;" ::: "memory");  // launched early (programmatic dependent launch): the partials
  const float* part = blockIdx.y == 0 ? part_g : part_b;
  const int c = blockIdx.x * RED_X + threadIdx.x;
  float a = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int p = threadIdx.y; p < parts; p += RED_Y) a += part[(size_t)p * d + c];
  }
  sh[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    a = sh[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < RED_Y; ++i) a += sh[i][threadIdx.x];
    (blockIdx.y == 0 ? dg : db)[c] = a;
  }
}

// The keep mask as float32 0/1 (dropout_keep_mask; no train step launches it). What bounds it on this card: bytes,
// the 4 bytes a value written (0.0055 ms at 5,992 x 768), then the hash (about 13 integer operations a value). An
// earlier design ran a thread a value: a 64-bit division and remainder for its row and column, the row's key
// recomputed (two mix32) and the float compare for each value, 4-byte stores. Device time a call at 5,992 x 768,
// rate 0.1 (kernels/compare_builds.py --parts add_ln, both in one call; NVIDIA H100 80GB HBM3, 700 W): 0.0145-0.0146
// ms before, 0.0067-0.0068 now, 81 % of the bound. Here a warp a row,
// rows strided over the warps of a grid from the SM count: the row's key once, the rate's integer threshold once
// (keep_at, as the forward kernel tests it), four consecutive columns a lane stored as one float4 where the rows
// are 16-byte aligned (d % 4 == 0 and an aligned mask), a value a lane otherwise.
__global__ void __launch_bounds__(WARPS * 32) dropout_keep_mask_kernel(const int* __restrict__ seed,
                                                                       float* __restrict__ mask, int rows, int d,
                                                                       uint32_t threshold, bool vec4,
                                                                       uint32_t row_offset) {
  const int lane = threadIdx.x & 31;
  const uint32_t s = (uint32_t)__ldg(seed);
  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < rows; row += gridDim.x * WARPS) {
    const uint32_t key = thunder_dropout::row_key(s, 0u, (uint32_t)row + row_offset);
    float* out = mask + (size_t)row * d;
    if (vec4) {
      for (int c = 4 * lane; c < d; c += 128) {
        float4 v;
        v.x = thunder_dropout::keep_at(key, (uint32_t)c, threshold) ? 1.f : 0.f;
        v.y = thunder_dropout::keep_at(key, (uint32_t)c + 1u, threshold) ? 1.f : 0.f;
        v.z = thunder_dropout::keep_at(key, (uint32_t)c + 2u, threshold) ? 1.f : 0.f;
        v.w = thunder_dropout::keep_at(key, (uint32_t)c + 3u, threshold) ? 1.f : 0.f;
        *reinterpret_cast<float4*>(out + c) = v;
      }
    } else {
      for (int c = lane; c < d; c += 32) out[c] = thunder_dropout::keep_at(key, (uint32_t)c, threshold) ? 1.f : 0.f;
    }
  }
}

bool bad_shape(int rows, int d) { return rows < 1 || d < 1; }

// the row in registers: a multiple of 8 up to 2048, every pointer 16-byte aligned
bool vectorised(int d, std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return d % 8 == 0 && d <= 2048 && (bits & 15) == 0;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 1;
  return n > 0 ? n : 1;
}

// the backward's grid: BWD_BLOCKS_PER_SM blocks an SM, no more than WARPS rows a block need; one partial row each
int bwd_blocks(int rows, int sms) {
  const int need = (rows + WARPS - 1) / WARPS;
  return need < BWD_BLOCKS_PER_SM * sms ? need : BWD_BLOCKS_PER_SM * sms;
}

// the vectorised backward's shared memory: the scale (2 nvec float4) and each warp's ring (2 x 3 x nvec uint4)
size_t bwd_smem(int d) { return (size_t)(d / 8) * 16 * (2 + (size_t)WARPS * 6); }

// the smallest instantiated VECS with 256 * VECS >= d
#define DISPATCH_VECS(d, CALL)        \
  do {                                \
    const int v_ = ((d) + 255) / 256; \
    if (v_ <= 1) { CALL(1); }         \
    else if (v_ <= 2) { CALL(2); }    \
    else if (v_ <= 3) { CALL(3); }    \
    else if (v_ <= 4) { CALL(4); }    \
    else if (v_ <= 6) { CALL(6); }    \
    else { CALL(8); }                 \
  } while (0)

}  // namespace

// x, y, out: (rows, d) bf16; g, b: (d,) f32; seed: one int32 on the device; any d >= 1 (vectorised() picks the
// kernel); 0 <= rate < 1; row_offset: added to each row's index in the dropout hash, the first row's index in a
// larger (rows, d) input (0 for a whole one). Returns cudaGetLastError().
extern "C" int thunder_add_ln_train_fwd(const void* x, const void* y, const float* g, const float* b, const int* seed,
                                        void* out, int rows, int d, float rate, float eps, unsigned row_offset,
                                        void* stream) {
  if (bad_shape(rows, d) || !(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + WARPS - 1) / WARPS;
  if (!vectorised(d, {x, y, g, b, out})) {
    add_ln_train_fwd_any_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(y), g, b, seed, static_cast<bf16*>(out), rows, d, rate,
        eps, row_offset);
    return (int)cudaGetLastError();
  }
#define CALL(V)                                                                                             \
  add_ln_train_fwd_kernel<V><<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(                 \
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), g, b, seed, static_cast<bf16*>(out), rows, d, rate, \
      eps, row_offset)
  DISPATCH_VECS(d, CALL);
#undef CALL
  return (int)cudaGetLastError();
}

// The backward's plan on the current device for `rows` rows of width d (kernels/add_ln_train.py::backward_plan
// computes the same): out[0] blocks, which is the partial rows of dg and db (part_g, part_b: (out[0], d) f32),
// out[1] warps a block, out[2] the device's SMs, out[3] the vectorised kernel's shared bytes a block (0 for a
// width it does not take).
extern "C" int thunder_add_ln_train_plan(int rows, int d, int* out) {
  if (bad_shape(rows, d)) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  out[0] = bwd_blocks(rows, sms);
  out[1] = WARPS;
  out[2] = sms;
  out[3] = d % 8 == 0 && d <= 2048 ? (int)bwd_smem(d) : 0;
  return 0;
}

// dout, dx, dy: (rows, d) bf16, any d >= 1 as the forward; part_g, part_b: (blocks, d) f32 scratch, blocks from
// thunder_add_ln_train_plan; dg, db: (d,) f32; row_offset as the forward's. Launches the backward and the sum of
// the partials. Returns cudaGetLastError().
extern "C" int thunder_add_ln_train_bwd(const void* x, const void* y, const float* g, const int* seed, const void* dout,
                                        void* dx, void* dy, float* part_g, float* part_b, float* dg, float* db,
                                        int rows, int d, float rate, float eps, unsigned row_offset, void* stream) {
  if (bad_shape(rows, d) || !(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  const int blocks = bwd_blocks(rows, sm_count());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vectorised(d, {x, y, g, dout, dx, dy, part_g, part_b})) {
    const size_t smem = bwd_smem(d);
    cudaError_t err = cudaSuccess;
#define CALL(V)                                                                                                  \
  err = cudaFuncSetAttribute(add_ln_train_bwd_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
  if (err != cudaSuccess) return (int)err;                                                                       \
  add_ln_train_bwd_kernel<V><<<blocks, WARPS * 32, smem, st>>>(                                                  \
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), g, seed, static_cast<const bf16*>(dout),        \
      static_cast<bf16*>(dx), static_cast<bf16*>(dy), part_g, part_b, rows, d, rate, eps, row_offset)
    DISPATCH_VECS(d, CALL);
#undef CALL
  } else {
    add_ln_train_bwd_any_kernel<<<blocks, WARPS * 32, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(y), g, seed, static_cast<const bf16*>(dout),
        static_cast<bf16*>(dx), static_cast<bf16*>(dy), part_g, part_b, rows, d, rate, eps, row_offset);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the sum as a programmatic dependent launch: it is launched while the backward ends, and waits for it
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((d + RED_X - 1) / RED_X, 2);
  config.blockDim = dim3(RED_X, RED_Y);
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, add_ln_train_sum_kernel, (const float*)part_g, (const float*)part_b, dg, db, blocks,
                           d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// mask: (rows, d) f32, 1 where add_ln_train keeps y under this seed, rate and row_offset, else 0.
extern "C" int thunder_dropout_keep_mask(const int* seed, float* mask, int rows, int d, float rate, unsigned row_offset,
                                         void* stream) {
  if (rows < 1 || d < 1 || !(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  const int need = (rows + WARPS - 1) / WARPS;
  const int blocks = need < MASK_BLOCKS_PER_SM * sm_count() ? need : MASK_BLOCKS_PER_SM * sm_count();
  const bool vec4 = d % 4 == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  dropout_keep_mask_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, mask, rows, d, thunder_dropout::threshold(rate), vec4, row_offset);
  return (int)cudaGetLastError();
}
