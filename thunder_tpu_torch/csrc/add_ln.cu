// Residual add + LayerNorm in one pass for Hopper (sm_90a): bf16 in and out,
// float32 statistics.
//
// Replaces: thunder_tpu/kernels/add_ln.py::add_layer_norm (the Pallas TPU kernel).
// For rows of D features:
//   s   = float(x) + float(y)
//   out = bf16( ((s - mean) * rsqrt(max(E[s^2] - mean^2, 0) + eps)) * g + b )
// with g and b float32.
//
// What bounds it on this card: bytes. Per element it reads two bf16 values and
// writes one (6 bytes) for about 8 float32 operations, far below the card's
// operations-per-byte balance. The unfused PyTorch expression moves the row
// through device memory five or more times (add, float copy, statistics,
// normalise, cast); this kernel reads x and y once and writes out once.
//
// Design: one warp per row. A lane loads 16 bytes (8 bf16) of x and of y at a
// time, keeps the float32 sums in registers (at most MAX_VECS vectors a lane,
// so D <= 32 * 8 * MAX_VECS), reduces the sum and the sum of squares across
// the warp with shuffles, and writes the normalised row with 16-byte stores.
// Rows are independent, so there is no shared memory and no block barrier.
// Any other width (not a multiple of 8, over 2048, or a tensor not 16-byte
// aligned) runs add_ln_any_kernel: the same warp a row, a bf16 a lane at a
// time, reading the row twice (the statistics, then the output; the second
// read mostly hits L1 and L2) instead of keeping it in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;     // rows per block
constexpr int MAX_VECS = 8;  // 16-byte vectors a lane keeps: D <= 2048

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(WARPS * 32)
    add_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const float* __restrict__ g,
                  const float* __restrict__ b, bf16* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int nvec = d / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  const uint4* yr = reinterpret_cast<const uint4*>(y + (size_t)row * d);

  float s[MAX_VECS][8];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_VECS; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      const uint4 xa = xr[c];
      const uint4 ya = yr[c];
      const bf16* xe = reinterpret_cast<const bf16*>(&xa);
      const bf16* ye = reinterpret_cast<const bf16*>(&ya);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = __bfloat162float(xe[j]) + __bfloat162float(ye[j]);
        s[i][j] = v;
        sum += v;
        sq += v * v;
      }
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mean = sum / d;
  const float var = fmaxf(sq / d - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);

  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * d);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int i = 0; i < MAX_VECS; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      const float4 ga = g4[2 * c], gb = g4[2 * c + 1];
      const float4 ba = b4[2 * c], bb = b4[2 * c + 1];
      const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      const float bv[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
      uint4 o;
      bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int j = 0; j < 8; ++j) oe[j] = __float2bfloat16((s[i][j] - mean) * inv * gv[j] + bv[j]);
      orow[c] = o;
    }
  }
}

// any width and alignment: the row read twice, a bf16 a lane at a time
__global__ void __launch_bounds__(WARPS * 32)
    add_ln_any_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const float* __restrict__ g,
                      const float* __restrict__ b, bf16* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  const bf16* yr = y + (size_t)row * d;
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = __bfloat162float(xr[c]) + __bfloat162float(yr[c]);
    sum += v;
    sq += v * v;
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mean = sum / d;
  const float var = fmaxf(sq / d - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  bf16* orow = out + (size_t)row * d;
  for (int c = lane; c < d; c += 32) {
    const float v = __bfloat162float(xr[c]) + __bfloat162float(yr[c]);
    orow[c] = __float2bfloat16((v - mean) * inv * g[c] + b[c]);
  }
}

}  // namespace

// x, y, out: (rows, d) bf16; g, b: (d,) f32; any d >= 1. A multiple of 8 up to 2048 with every pointer 16-byte
// aligned keeps the row in registers, any other runs add_ln_any_kernel. Returns cudaGetLastError().
extern "C" int thunder_add_layer_norm(const void* x, const void* y, const float* g, const float* b, void* out,
                                      int rows, int d, float eps, void* stream) {
  if (rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + WARPS - 1) / WARPS;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const auto kernel = aligned && d % 8 == 0 && d <= 32 * 8 * MAX_VECS ? add_ln_kernel : add_ln_any_kernel;
  kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), g, b, static_cast<bf16*>(out), rows, d, eps);
  return (int)cudaGetLastError();
}
