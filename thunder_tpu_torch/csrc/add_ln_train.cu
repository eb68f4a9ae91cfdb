// Residual add + dropout + LayerNorm for training, forward and backward, for
// Hopper (sm_90a): bf16 activations, float32 statistics and parameters.
//
// Replaces: thunder_tpu/kernels/add_ln_train.py::add_ln_dropout_train (forward
// and backward Pallas TPU kernels) and ::dropout_keep_mask.
// Forward, for rows of D features:
//   yd  = keep ? float(y) / (1 - rate) : 0            (keep: dropout_hash.cuh, stream 0)
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
// (5 passes), each for a few dozen float32 operations and one 32-bit hash.
//
// Design: one warp per row, as add_ln.cu: a lane keeps VECS 16-byte vectors
// of the row in registers (D <= 256 * VECS; the kernels are instantiated for
// VECS = 1, 2, 3, 4, 6, 8) and the row statistics go through warp shuffles.
// The TPU kernel carries dg and db across a sequential grid; here the rows
// run concurrently, so in the backward each warp takes ROWS_PER_WARP
// consecutive rows, keeps its share of dg and db in registers and writes one
// partial row to a (warps, D) float32 workspace, and a second small kernel
// sums the partials in a fixed order. No float atomics: the same inputs give
// the same bits from run to run.
// Any other width (not a multiple of 8, over 2048, or a tensor not 16-byte
// aligned) runs the *_any kernels: the same warp a row and the same partial
// rows of dg and db, a bf16 a lane at a time, re-reading x and y (and
// regenerating the mask) in each pass instead of keeping the row in
// registers; the warp's partial row of dg and db is kept in the workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "dropout_hash.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;          // warps per block
constexpr int ROWS_PER_WARP = 8;  // backward: consecutive rows a warp reduces into one partial of dg, db
constexpr int RED_X = 32, RED_Y = 8;  // the partial sum's block: 32 columns by 8 strided groups of partials

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s = x + dropout(y) of one row into registers; returns the keep bits of each vector
template <int VECS>
__device__ inline void load_sum(const bf16* __restrict__ x, const bf16* __restrict__ y, int row, int d, int lane,
                                uint32_t seed, float rate, float inv_keep, float (&s)[VECS][8], unsigned (&kept)[VECS],
                                float& sum, float& sq) {
  const int nvec = d / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  const uint4* yr = reinterpret_cast<const uint4*>(y + (size_t)row * d);
  const uint32_t key = thunder_dropout::row_key(seed, 0u, (uint32_t)row);
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
                            int d, float rate, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int nvec = d / 8;
  const float inv_keep = 1.f / (1.f - rate);
  float s[VECS][8];
  unsigned kept[VECS];
  float sum, sq;
  load_sum<VECS>(x, y, row, d, lane, (uint32_t)seed[0], rate, inv_keep, s, kept, sum, sq);
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

template <int VECS>
__global__ void __launch_bounds__(WARPS * 32)
    add_ln_train_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const float* __restrict__ g,
                            const int* __restrict__ seed, const bf16* __restrict__ dout, bf16* __restrict__ dx,
                            bf16* __restrict__ dy, float* __restrict__ part_g, float* __restrict__ part_b, int rows,
                            int d, float rate, float eps) {
  const int lane = threadIdx.x % 32;
  const int part = blockIdx.x * WARPS + threadIdx.x / 32;  // this warp's partial row of dg, db
  const int row0 = part * ROWS_PER_WARP;
  if (row0 >= rows) return;
  const int nvec = d / 8;
  const float inv_keep = 1.f / (1.f - rate);
  const uint32_t sd = (uint32_t)seed[0];

  float gv[VECS][8], acc_g[VECS][8], acc_b[VECS][8];
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) gv[i][j] = acc_g[i][j] = acc_b[i][j] = 0.f;
    if (c < nvec) load8(g, c, gv[i]);
  }

  for (int row = row0; row < min(row0 + ROWS_PER_WARP, rows); ++row) {
    float s[VECS][8], gd[VECS][8];
    unsigned kept[VECS];
    float sum, sq;
    load_sum<VECS>(x, y, row, d, lane, sd, rate, inv_keep, s, kept, sum, sq);
    const float mean = sum / d;
    const float rstd = rsqrtf(fmaxf(sq / d - mean * mean, 0.f) + eps);
    const uint4* dor = reinterpret_cast<const uint4*>(dout + (size_t)row * d);
    float sg = 0.f, sgs = 0.f;
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        const uint4 da = dor[c];
        const bf16* de = reinterpret_cast<const bf16*>(&da);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float shat = (s[i][j] - mean) * rstd;
          const float dov = __bfloat162float(de[j]);
          const float gdv = dov * gv[i][j];
          s[i][j] = shat;
          gd[i][j] = gdv;
          sg += gdv;
          sgs += gdv * shat;
          acc_g[i][j] += dov * shat;
          acc_b[i][j] += dov;
        }
      }
    }
    const float gm = warp_sum(sg) / d;
    const float gsm = warp_sum(sgs) / d;
    uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * d);
    uint4* dyr = reinterpret_cast<uint4*>(dy + (size_t)row * d);
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        uint4 ox, oy;
        bf16* oxe = reinterpret_cast<bf16*>(&ox);
        bf16* oye = reinterpret_cast<bf16*>(&oy);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float ds = rstd * (gd[i][j] - gm - s[i][j] * gsm);
          oxe[j] = __float2bfloat16(ds);
          oye[j] = __float2bfloat16(rate > 0.f ? ((kept[i] >> j & 1u) ? ds * inv_keep : 0.f) : ds);
        }
        dxr[c] = ox;
        dyr[c] = oy;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      float4* pg = reinterpret_cast<float4*>(part_g + (size_t)part * d) + 2 * c;
      float4* pb = reinterpret_cast<float4*>(part_b + (size_t)part * d) + 2 * c;
      pg[0] = make_float4(acc_g[i][0], acc_g[i][1], acc_g[i][2], acc_g[i][3]);
      pg[1] = make_float4(acc_g[i][4], acc_g[i][5], acc_g[i][6], acc_g[i][7]);
      pb[0] = make_float4(acc_b[i][0], acc_b[i][1], acc_b[i][2], acc_b[i][3]);
      pb[1] = make_float4(acc_b[i][4], acc_b[i][5], acc_b[i][6], acc_b[i][7]);
    }
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

__device__ inline AnyRow any_row(const bf16* x, const bf16* y, int row, int d, uint32_t seed, float rate) {
  return {x + (size_t)row * d, y + (size_t)row * d, thunder_dropout::row_key(seed, 0u, (uint32_t)row), rate,
          1.f / (1.f - rate)};
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
                                int rows, int d, float rate, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const AnyRow s = any_row(x, y, row, d, (uint32_t)seed[0], rate);
  float mean, rstd;
  any_stats(s, d, lane, eps, mean, rstd);
  bf16* orow = out + (size_t)row * d;
  for (int c = lane; c < d; c += 32) orow[c] = __float2bfloat16((s(c) - mean) * (rstd * g[c]) + b[c]);
}

__global__ void __launch_bounds__(WARPS * 32)
    add_ln_train_bwd_any_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const float* __restrict__ g,
                                const int* __restrict__ seed, const bf16* __restrict__ dout, bf16* __restrict__ dx,
                                bf16* __restrict__ dy, float* __restrict__ part_g, float* __restrict__ part_b,
                                int rows, int d, float rate, float eps) {
  const int lane = threadIdx.x % 32;
  const int part = blockIdx.x * WARPS + threadIdx.x / 32;
  const int row0 = part * ROWS_PER_WARP;
  if (row0 >= rows) return;
  float* pg = part_g + (size_t)part * d;
  float* pb = part_b + (size_t)part * d;
  for (int row = row0; row < min(row0 + ROWS_PER_WARP, rows); ++row) {
    const AnyRow s = any_row(x, y, row, d, (uint32_t)seed[0], rate);
    float mean, rstd;
    any_stats(s, d, lane, eps, mean, rstd);
    const bf16* dor = dout + (size_t)row * d;
    float sg = 0.f, sgs = 0.f;
    for (int c = lane; c < d; c += 32) {  // the row's two means, and its share of dg and db (same lane, in order)
      const float shat = (s(c) - mean) * rstd;
      const float dov = __bfloat162float(dor[c]);
      const float gdv = __fmul_rn(dov, g[c]);  // rounded, as the next pass recomputes it: no fused multiply-add
      sg += gdv;
      sgs += gdv * shat;
      pg[c] = (row == row0 ? 0.f : pg[c]) + dov * shat;
      pb[c] = (row == row0 ? 0.f : pb[c]) + dov;
    }
    const float gm = warp_sum(sg) / d;
    const float gsm = warp_sum(sgs) / d;
    bf16* dxr = dx + (size_t)row * d;
    bf16* dyr = dy + (size_t)row * d;
    for (int c = lane; c < d; c += 32) {
      const float shat = (s(c) - mean) * rstd;
      const float ds = rstd * (__fmul_rn(__bfloat162float(dor[c]), g[c]) - gm - shat * gsm);
      dxr[c] = __float2bfloat16(ds);
      dyr[c] = __float2bfloat16(rate > 0.f ? (s.kept(c) ? ds * s.inv_keep : 0.f) : ds);
    }
  }
}

// dg[c] = sum_p part_g[p][c], db likewise, in a fixed order: thread (cx, py) sums the partials
// py, py + RED_Y, ... in turn, then the RED_Y sums of a column are added in order
__global__ void __launch_bounds__(RED_X * RED_Y)
    add_ln_train_sum_kernel(const float* __restrict__ part_g, const float* __restrict__ part_b, float* __restrict__ dg,
                            float* __restrict__ db, int parts, int d) {
  __shared__ float sh_g[RED_Y][RED_X], sh_b[RED_Y][RED_X];
  const int c = blockIdx.x * RED_X + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (c < d) {
    for (int p = threadIdx.y; p < parts; p += RED_Y) {
      a += part_g[(size_t)p * d + c];
      b += part_b[(size_t)p * d + c];
    }
  }
  sh_g[threadIdx.y][threadIdx.x] = a;
  sh_b[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    a = sh_g[0][threadIdx.x];
    b = sh_b[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < RED_Y; ++i) {
      a += sh_g[i][threadIdx.x];
      b += sh_b[i][threadIdx.x];
    }
    dg[c] = a;
    db[c] = b;
  }
}

__global__ void dropout_keep_mask_kernel(const int* __restrict__ seed, float* __restrict__ mask, int rows, int d,
                                         float rate) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * d) return;
  const uint32_t row = (uint32_t)(i / d), col = (uint32_t)(i % d);
  mask[i] = thunder_dropout::keep(thunder_dropout::row_key((uint32_t)seed[0], 0u, row), col, rate) ? 1.f : 0.f;
}

bool bad_shape(int rows, int d) { return rows < 1 || d < 1; }

// the row in registers: a multiple of 8 up to 2048, every pointer 16-byte aligned
bool vectorised(int d, std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return d % 8 == 0 && d <= 2048 && (bits & 15) == 0;
}

int parts_of(int rows) { return (rows + ROWS_PER_WARP - 1) / ROWS_PER_WARP; }

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
// kernel); 0 <= rate < 1. Returns cudaGetLastError().
extern "C" int thunder_add_ln_train_fwd(const void* x, const void* y, const float* g, const float* b, const int* seed,
                                        void* out, int rows, int d, float rate, float eps, void* stream) {
  if (bad_shape(rows, d) || !(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + WARPS - 1) / WARPS;
  if (!vectorised(d, {x, y, g, b, out})) {
    add_ln_train_fwd_any_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(y), g, b, seed, static_cast<bf16*>(out), rows, d, rate,
        eps);
    return (int)cudaGetLastError();
  }
#define CALL(V)                                                                                          \
  add_ln_train_fwd_kernel<V><<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(              \
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), g, b, seed, static_cast<bf16*>(out), rows, d, rate, eps)
  DISPATCH_VECS(d, CALL);
#undef CALL
  return (int)cudaGetLastError();
}

// The number of partial rows the backward writes for `rows` rows: part_g and part_b are (parts, d) f32.
extern "C" int thunder_add_ln_train_parts(int rows) { return parts_of(rows); }

// dout, dx, dy: (rows, d) bf16, any d >= 1 as the forward; part_g, part_b: (thunder_add_ln_train_parts(rows), d)
// f32 scratch; dg, db: (d,) f32. Launches the backward and the sum of the partials. Returns cudaGetLastError().
extern "C" int thunder_add_ln_train_bwd(const void* x, const void* y, const float* g, const int* seed, const void* dout,
                                        void* dx, void* dy, float* part_g, float* part_b, float* dg, float* db,
                                        int rows, int d, float rate, float eps, void* stream) {
  if (bad_shape(rows, d) || !(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  const int parts = parts_of(rows);
  const int blocks = (parts + WARPS - 1) / WARPS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(V)                                                                                                  \
  add_ln_train_bwd_kernel<V><<<blocks, WARPS * 32, 0, st>>>(                                                     \
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), g, seed, static_cast<const bf16*>(dout),        \
      static_cast<bf16*>(dx), static_cast<bf16*>(dy), part_g, part_b, rows, d, rate, eps)
  if (vectorised(d, {x, y, g, dout, dx, dy, part_g, part_b})) {
    DISPATCH_VECS(d, CALL);
  } else {
    add_ln_train_bwd_any_kernel<<<blocks, WARPS * 32, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(y), g, seed, static_cast<const bf16*>(dout),
        static_cast<bf16*>(dx), static_cast<bf16*>(dy), part_g, part_b, rows, d, rate, eps);
  }
#undef CALL
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  add_ln_train_sum_kernel<<<(d + RED_X - 1) / RED_X, dim3(RED_X, RED_Y), 0, st>>>(part_g, part_b, dg, db, parts, d);
  return (int)cudaGetLastError();
}

// mask: (rows, d) f32, 1 where add_ln_train keeps y under this seed and rate, else 0.
extern "C" int thunder_dropout_keep_mask(const int* seed, float* mask, int rows, int d, float rate, void* stream) {
  if (rows < 1 || d < 1 || !(rate >= 0.f && rate < 1.f)) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)rows * d;
  dropout_keep_mask_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(seed, mask, rows,
                                                                                                        d, rate);
  return (int)cudaGetLastError();
}
