// One separable conv repeat in one launch for Hopper (sm_90a): bf16 in and out,
// float32 accumulation.
//
// Replaces: thunder_tpu/kernels/separable_conv.py::fused_separable_conv and
// thunder_tpu/kernels/repeat_tm.py::fused_repeat_tm (the Pallas TPU kernels).
// For a channels-last input x (B, T_in, C_in), zero beyond each row's length:
//   d[b, t, c]   = bf16( sum_j x[b, t*stride - pad + j*dilation, c] * dw[j, c] )   (f32 sum)
//   out[b, t, o] = t < out_lengths[b] ? act( sum_c d[b, t, c] * pw[c, o] + bias[o] ) : 0
// with act = ReLU or identity, the BN scale already folded into pw and bias.
// Unlike the TPU kernels it takes any stride, dilation and channel count (a
// multiple of 8), so the stem (stride 2, 64 channels) and the tail (dilation 2)
// of QuartzNet run through it too.
//
// What bounds it on this card: by operation count the pointwise GEMM, 2*C_in*C_out
// per frame against 2*k*C_in for the depthwise (8x more at QuartzNet's widths),
// with bf16 tensor cores at 989 TFLOP/s against 67 TFLOP/s of f32 FMA for the
// depthwise. Device-memory traffic is small: one read of x and one write of
// out, where the unfused path writes and re-reads the depthwise result, the
// GEMM result and the masked epilogue. In this first version the GEMM's
// staging is the bound: measured time follows C_in * C_out, not k, because the
// weight tile is refilled two bytes per thread between two barriers for every
// 32-deep chunk (see PERF.md).
//
// Design (simple first; wgmma, TMA and warp specialisation are later work):
// - one block of 8 warps per (row, tile of TT output frames);
// - for each chunk of KC input channels, the input span of the tile is staged
//   in shared memory as f32 (converted once on load), and the depthwise sums
//   for the TT x KC tile go, rounded to bf16, into a TT x C_in tile that stays
//   in shared memory, so the depthwise conv is computed once per block;
// - the pointwise product runs on the tensor cores through nvcuda::wmma bf16
//   16x16x16 fragments (mma.sync), TO output channels at a time, with the
//   weights staged per KC-row chunk;
// - the epilogue (bias, ReLU, zero beyond out_lengths, bf16 store) reads the
//   accumulators back through shared memory, which the span staging reuses.
// The TPU kernel's time-major layout and 3-tile DMA shift register were
// sublane workarounds and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int TT = 64;        // output frames per block
constexpr int KC = 32;        // input channels per depthwise / GEMM-depth chunk
constexpr int TO = 128;       // output channels per GEMM tile
constexpr int THREADS = 256;  // 8 warps: a 2 x 4 grid of 32 x 32 warp tiles over TT x TO
constexpr int A_PAD = 8;      // bf16 padding per row of the depthwise tile
constexpr int B_LD = TO + 8;  // bf16 row stride of the staged weights
constexpr int C_LD = TO + 4;  // f32 row stride of the accumulator tile
constexpr int ROWS = TT / (THREADS / KC);  // depthwise frames per thread

static_assert(THREADS % KC == 0 && TT % (THREADS / KC) == 0, "depthwise thread mapping");
static_assert(TT == 2 * 32 && TO == 4 * 32 && THREADS == 8 * 32, "warp tiling");

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ inline int span_rows(int k, int stride, int dilation) {
  return (TT - 1) * stride + (k - 1) * dilation + 1;
}

size_t smem_bytes(int c_in, int k, int stride, int dilation) {
  const size_t a = (size_t)TT * (round_up(c_in, KC) + A_PAD) * sizeof(bf16);
  const size_t b = (size_t)KC * B_LD * sizeof(bf16);
  const size_t span = (size_t)span_rows(k, stride, dilation) * KC;
  const size_t c = (size_t)TT * C_LD;
  return a + b + (span > c ? span : c) * sizeof(float);
}

__global__ void __launch_bounds__(THREADS)
    separable_repeat_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dw, const bf16* __restrict__ pw,
                            const float* __restrict__ bias, const int* __restrict__ out_lengths,
                            bf16* __restrict__ out, int t_in, int t_out, int c_in, int c_out, int k, int stride,
                            int dilation, int pad, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c_in_pad = round_up(c_in, KC);
  const int lda = c_in_pad + A_PAD;
  const int span = span_rows(k, stride, dilation);
  bf16* a_tile = reinterpret_cast<bf16*>(smem);                      // [TT][lda]
  bf16* b_tile = a_tile + (size_t)TT * lda;                          // [KC][B_LD]
  float* scratch = reinterpret_cast<float*>(b_tile + KC * B_LD);     // span [span][KC] or C [TT][C_LD]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int valid = out_lengths[b];
  const bf16* xb = x + (size_t)b * t_in * c_in;
  const int in0 = t0 * stride - pad;  // input frame of span row 0

  // ---- depthwise: TT x C_in tile into shared memory, KC channels at a time
  const int lane_c = tid % KC;
  const int row0 = tid / KC;
  for (int c0 = 0; c0 < c_in_pad; c0 += KC) {
    for (int i = tid; i < span * KC; i += THREADS) {
      const int p = i / KC;
      const int ch = c0 + i % KC;
      const int t = in0 + p;
      scratch[i] = (t >= 0 && t < t_in && ch < c_in) ? __bfloat162float(xb[(size_t)t * c_in + ch]) : 0.f;
    }
    __syncthreads();
    const int ch = c0 + lane_c;
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    if (ch < c_in) {
      for (int j = 0; j < k; ++j) {
        const float w = __bfloat162float(dw[(size_t)j * c_in + ch]);
        const float* col = scratch + (size_t)j * dilation * KC + lane_c;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int t = row0 + r * (THREADS / KC);
          acc[r] = fmaf(col[t * stride * KC], w, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) a_tile[(row0 + r * (THREADS / KC)) * lda + ch] = __float2bfloat16(acc[r]);
    __syncthreads();  // the next chunk overwrites the span
  }

  // ---- pointwise GEMM on the tensor cores, TO output channels at a time
  const int warp = tid / 32;
  const int wr = (warp / 4) * 32;  // warp tile row in TT
  const int wc = (warp % 4) * 32;  // warp tile column in TO
  for (int o0 = 0; o0 < c_out; o0 += TO) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(cf[i][j], 0.f);

    for (int kc = 0; kc < c_in_pad; kc += KC) {
      for (int i = tid; i < KC * TO; i += THREADS) {
        const int r = i / TO;
        const int c = i % TO;
        const int ci = kc + r;
        const int co = o0 + c;
        b_tile[r * B_LD + c] = (ci < c_in && co < c_out) ? pw[(size_t)ci * c_out + co] : __float2bfloat16(0.f);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], a_tile + (wr + 16 * i) * lda + kc + kk, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], b_tile + kk * B_LD + wc + 16 * j, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(cf[i][j], fa[i], fb[j], cf[i][j]);
      }
      __syncthreads();  // the next chunk overwrites b_tile
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(scratch + (wr + 16 * i) * C_LD + wc + 16 * j, cf[i][j], C_LD, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < TT * TO; i += THREADS) {
      const int r = i / TO;
      const int c = i % TO;
      const int t = t0 + r;
      const int co = o0 + c;
      if (t < t_out && co < c_out) {
        float v = scratch[r * C_LD + c] + bias[co];
        if (relu) v = fmaxf(v, 0.f);
        if (t >= valid) v = 0.f;
        out[((size_t)b * t_out + t) * c_out + co] = __float2bfloat16(v);
      }
    }
    __syncthreads();  // the next output tile overwrites the accumulator tile
  }
}

}  // namespace

// x: (batch, t_in, c_in) bf16, zero beyond each row's input length; dw: (k, c_in) bf16;
// pw: (c_in, c_out) bf16; bias: (c_out,) f32; out_lengths: (batch,) int32;
// out: (batch, t_out, c_out) bf16. Returns cudaGetLastError().
extern "C" int thunder_separable_repeat(const void* x, const void* dw, const void* pw, const float* bias,
                                        const int* out_lengths, void* out, int batch, int t_in, int t_out, int c_in,
                                        int c_out, int k, int stride, int dilation, int pad, int relu,
                                        void* stream) {
  if (batch < 1 || batch > 65535 || t_out < 1 || c_in % 8 || c_out % 8 || k < 1 || stride < 1 || dilation < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(c_in, k, stride, dilation);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(separable_repeat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_out + TT - 1) / TT, batch);
  separable_repeat_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dw), static_cast<const bf16*>(pw), bias, out_lengths,
      static_cast<bf16*>(out), t_in, t_out, c_in, c_out, k, stride, dilation, pad, relu);
  return (int)cudaGetLastError();
}
