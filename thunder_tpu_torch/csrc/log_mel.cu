// Fused log-mel frontend for Hopper (sm_90a), float32 in and out.
//
// Replaces: thunder_tpu/kernels/frontend_pallas.py::fused_log_mel (the Pallas
// TPU kernel). Preemphasis and the centered reflect pad run before this kernel
// in PyTorch; the kernel reads the padded audio and writes
//   out[b, f, m] = log( sum_k |sum_n xp[b, f*hop + n] * basis[n, k]|^2 * mel[k, m] + 2^-24 )
// where basis holds the windowed cos columns, then the windowed sin columns.
//
// What bounds it on this card: float32 FMA throughput. The windowed DFT is
// 2 * n_fft * n_freqs FMAs per frame (about 263 K for n_fft = 512), against
// 4 * hop bytes of new audio per frame, so it is compute-bound by a wide
// margin; with exact float32 required (no TF32, no bf16 split), the tensor
// cores are out and the FP32 pipes are the roof.
//
// Design:
// - one block per (row, tile of FRAME_TILE frames), one thread per frequency
//   bin (the block is n_freqs rounded up to a warp);
// - the audio span of the tile (FRAME_TILE-1)*hop + n_fft samples sits in
//   shared memory; a thread keeps FRAME_TILE real and imaginary sums in
//   registers, so each basis value read from global memory (the 1 MB basis
//   stays in the 50 MB L2) feeds 2 * FRAME_TILE FMAs, and each float4 audio
//   read is a broadcast that feeds 8 FMAs;
// - the power of the tile stays in shared memory for the mel projection and
//   the log, so neither the frame tensor nor the power spectrum reaches
//   device memory (the plain version writes both).
// The TPU kernel's 3-pass bf16 split, its 128-lane and 8-sublane rounding and
// its chunked shifted matmuls were Mosaic workarounds and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int FRAME_TILE = 16;  // frames per block

__global__ void log_mel_kernel(const float* __restrict__ xp, const float* __restrict__ basis,
                               const float* __restrict__ melmat, float* __restrict__ out, int padded_len,
                               int n_frames, int n_fft, int hop, int n_freqs, int n_mels) {
  extern __shared__ __align__(16) float smem[];
  const int span = (FRAME_TILE - 1) * hop + n_fft;
  float* audio = smem;         // [span]
  float* power = smem + span;  // [FRAME_TILE][n_freqs]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FRAME_TILE;
  const float* row = xp + (size_t)b * padded_len;
  const int start = f0 * hop;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int p = start + i;
    audio[i] = p < padded_len ? row[p] : 0.f;
  }
  __syncthreads();

  const size_t two_f = 2 * (size_t)n_freqs;
  for (int k = threadIdx.x; k < n_freqs; k += blockDim.x) {
    float re[FRAME_TILE], im[FRAME_TILE];
#pragma unroll
    for (int f = 0; f < FRAME_TILE; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    const float* cos_col = basis + k;
    const float* sin_col = basis + n_freqs + k;
    for (int n = 0; n < n_fft; n += 4) {
      float c[4], s[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c[q] = __ldg(cos_col + (n + q) * two_f);
        s[q] = __ldg(sin_col + (n + q) * two_f);
      }
#pragma unroll
      for (int f = 0; f < FRAME_TILE; ++f) {
        const float4 a = *reinterpret_cast<const float4*>(audio + f * hop + n);
        re[f] = fmaf(a.x, c[0], re[f]);
        im[f] = fmaf(a.x, s[0], im[f]);
        re[f] = fmaf(a.y, c[1], re[f]);
        im[f] = fmaf(a.y, s[1], im[f]);
        re[f] = fmaf(a.z, c[2], re[f]);
        im[f] = fmaf(a.z, s[2], im[f]);
        re[f] = fmaf(a.w, c[3], re[f]);
        im[f] = fmaf(a.w, s[3], im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FRAME_TILE; ++f) power[f * n_freqs + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < FRAME_TILE * n_mels; idx += blockDim.x) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    if (f0 + f >= n_frames) continue;
    const float* p = power + f * n_freqs;
    float acc = 0.f;
    for (int k = 0; k < n_freqs; ++k) acc = fmaf(p[k], __ldg(melmat + (size_t)k * n_mels + m), acc);
    out[((size_t)b * n_frames + f0 + f) * n_mels + m] = logf(acc + 5.9604644775390625e-08f);  // 2^-24
  }
}

}  // namespace

// xp: (batch, padded_len) preemphasised, reflect-padded audio; basis: (n_fft, 2*n_freqs);
// melmat: (n_freqs, n_mels); out: (batch, n_frames, n_mels). hop and n_fft must be
// multiples of 4 (float4 reads of the audio span). Returns cudaGetLastError().
extern "C" int thunder_log_mel(const float* xp, const float* basis, const float* melmat, float* out, int batch,
                               int padded_len, int n_frames, int n_fft, int hop, int n_freqs, int n_mels,
                               void* stream) {
  if (hop % 4 || n_fft % 4 || n_freqs > 1024 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int threads = (n_freqs + 31) / 32 * 32;
  const size_t smem = sizeof(float) * ((size_t)(FRAME_TILE - 1) * hop + n_fft + (size_t)FRAME_TILE * n_freqs);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_frames + FRAME_TILE - 1) / FRAME_TILE, batch);
  log_mel_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(xp, basis, melmat, out, padded_len,
                                                                             n_frames, n_fft, hop, n_freqs, n_mels);
  return (int)cudaGetLastError();
}
