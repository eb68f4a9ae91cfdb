// Fused log-mel frontend for Hopper (sm_90a), float32 in and out.
//
// Replaces: thunder_tpu/kernels/frontend_pallas.py::fused_log_mel (the Pallas
// TPU kernel). From the raw audio x of a row it computes
//   y[j]   = x[j] - preemph * x[j-1],  y[0] = x[0]          (preemphasis)
//   xp[p]  = y[reflect(p - n_fft/2)]                          (centered reflect pad)
//   X_f[k] = sum_n w[n] xp[f*hop + n] e^{-2 pi i n k / n_fft} (w: hann(win) centered in n_fft)
//   out[b, f, m] = log( sum_k |X_f[k]|^2 mel[k, m] + 2^-24 )
// and writes nothing to device memory but the log-mel.
//
// What bounds it on this card: bytes. With an FFT a frame costs about
// 2.5 n_fft log2 n_fft + 4 n_fft operations (about 15 K at n_fft = 512) against
// 4 * hop bytes of new audio (640 B) and 4 * n_mels bytes of output (256 B):
// about 17 operations a byte, under the float32 pipes' 20 a byte at 3.35 TB/s.
// The least time is the 61 MB of audio in and 25 MB of log-mel out at 64 x 15 s
// (0.026 ms). What sets the time in practice is each block's instruction
// issue (index arithmetic, shared-memory loads, the log), its barriers, and
// the latency of its first load from device memory: three blocks of eight
// warps share an SM.
//
// Design:
// - one block a tile of `frames` frames of one row (make_plan: at most 4,096
//   complex points a tile, fewer frames when the audio span does not fit); the
//   block first copies the host's packed tables (twiddles, window, mel bands)
//   into shared memory with cp.async, 16 bytes a copy;
// - the audio: an interior tile (one that the reflect pad does not reach)
//   copies its raw samples, (frames-1)*hop + win + 1 of them from the one
//   before the first under the window, with the same cp.async, and the first
//   FFT stage takes the preemphasis y[j] = x[j] - c x[j-1] on its read; a tile
//   at a row's end loads its span sample by sample with the reflection and
//   the preemphasis. The samples outside the window are never read;
// - path "fft" (n_fft a power of two, 32..4096): a real FFT of N as a complex
//   FFT of N/2 on the packed even/odd samples z[m] = w x[2m] + i w x[2m+1],
//   then the split step, a thread a pair of bins k and N/2 - k. The complex
//   FFT is Stockham (self-sorting, out of place between two shared buffers):
//   radix-16 stages, each a thread's 16 points in registers (a 4 x 4 DFT),
//   after a radix-2, radix-4 or radix-2 + radix-4 start for log2(N/2) mod 4
//   (N = 512: two radix-16 stages, two passes over shared memory); the first
//   stage reads the windowed samples straight from the audio. The buffers'
//   points are swizzled (sw: the low 4 bits of an index XORed with the next
//   4), which spreads the first stage's stride-16 stores, 16-way bank
//   conflicts otherwise, over all banks. Stockham stages in shared memory
//   were chosen over a register FFT across a warp because one loop covers
//   every size from 32 to 4096 points (a warp's registers hold 8 points a
//   lane at N = 512 but not the 64 of N = 4096). Twiddles come from a float32
//   table the host makes in float64 (e^{-2 pi i k / N}, k < N; the stages
//   read entry 2k for e^{-2 pi i k / (N/2)}); the 4 x 4 DFT's constants are
//   that table's entries for N = 16;
// - path "dense" (any other n_fft, such as 400): the windowed DFT as a product
//   with the windowed basis, a thread a frequency bin (at most 1,024 threads,
//   looping over the bins), FT frames of sums in registers, basis rows outside
//   the window skipped, scalar reads (any hop and n_fft);
// - both paths: the tile's power stays in shared memory; the mel product runs
//   over each filter's non-zeros only (first bin, count, offset and weights in
//   ascending bin order, from the host), a thread a (mel, frame), so that a
//   warp reads one or two filters' weights and loops alike; then logf with
//   no fast-math log into a padded tile, and the tile's rows go out coalesced;
// - path "wide" (an n_fft whose dense tile does not fit in shared memory, past
//   about 16,000 with a long window): the power goes through device memory, a
//   float32 (rows, frames, n_freqs) workspace, in two launches. The first is
//   the dense path's product over slices of 256 bins (a block a tile of frames,
//   a slice of bins and a row, the span of its frames in shared memory), with
//   the windowed basis made in registers, cos and sin of 2 pi r / n_fft by
//   sincospif with r = n k mod n_fft stepped by k, times the window from
//   device memory, each rounded as the host rounds its table; the second is
//   the mel product and the log over the workspace's rows, a block a tile of
//   frames. The wrapper sizes the workspace for a slice of rows and the launches
//   go slice by slice.
// - rows: launches over slices of at most 65,535 rows (the grid's y extent).
// The TPU kernel's 3-pass bf16 split, its 128-lane and 8-sublane rounding and
// its chunked shifted matmuls were Mosaic workarounds and are not carried over.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr long MAX_SMEM = 232448;      // 227 KB, one block
constexpr int FFT_THREADS = 256;
constexpr int FFT_MIN = 32, FFT_MAX = 4096;
constexpr int FFT_TILE_POINTS = 4096;  // complex points a tile: two 32 KB buffers
constexpr int FFT_MAX_FRAMES = 64;
constexpr int DENSE_MAX_FRAMES = 16;
constexpr int PATH_FFT = 1, PATH_DENSE = 2, PATH_WIDE = 3;
constexpr int WIDE_BINS = 256;        // bins a block of the wide path's power launch: a thread a bin
constexpr int WIDE_MAX_FRAMES = 16;
constexpr int WIDE_MEL_FRAMES = 16;   // frames a block of its mel launch
constexpr int MAX_ROWS = 65535;       // rows a launch: the grid's y (z on the wide path) extent
constexpr float LOG_GUARD = 5.9604644775390625e-08f;  // 2^-24

struct Plan {
  int path = 0;
  long smem = 0;  // 0: refused
  int frames = 0, threads = 0;
  long buf = 0;  // floats in each of the FFT path's two buffers
};

long round4(long x) { return (x + 3) / 4 * 4; }

// The launch plan (kernels/frontend.py::log_mel_plan reads it through thunder_log_mel_plan). The tables sit in
// shared memory as the host packs them (each part padded to 16 bytes): on the FFT path the twiddles and the
// window, then on both paths each mel filter's first bin, count and offset, and the filters' weights (at most two
// a bin). Each FFT buffer holds a tile's complex points, or its raw audio (span + 1 samples in 16-byte chunks from
// the boundary at or below the first) and then its span, or its log-mel rows (n_mels + 1 floats a frame).
Plan make_plan(int n_fft, int hop, int win, int n_mels) {
  Plan p;
  const bool pow2 = n_fft > 0 && (n_fft & (n_fft - 1)) == 0;
  p.path = pow2 && n_fft >= FFT_MIN && n_fft <= FFT_MAX ? PATH_FFT : PATH_DENSE;
  if (n_fft < 2 || hop < 1 || win < 1 || win > n_fft || n_mels < 1) return p;
  const int n_freqs = n_fft / 2 + 1;
  const long mel_tables = 4 * (round4(3 * n_mels) + round4(2 * n_freqs));
  if (p.path == PATH_FFT) {
    const int m = n_fft / 2;
    p.threads = FFT_THREADS;
    for (int ft = std::min(FFT_MAX_FRAMES, FFT_TILE_POINTS / m); ft >= 1; ft /= 2) {
      const long span = (long)(ft - 1) * hop + win;
      const long buf = round4(std::max({2L * ft * m, span + 8, (long)ft * (n_mels + 1)}));
      const long smem = 8 * buf + 4 * (2L * n_fft + round4(win)) + mel_tables;
      if (smem <= MAX_SMEM) {
        p.smem = smem;
        p.frames = ft;
        p.buf = buf;
        return p;
      }
    }
    return p;
  }
  p.threads = std::min(1024, (n_freqs + 31) / 32 * 32);
  for (int ft = DENSE_MAX_FRAMES; ft >= 1; ft /= 2) {
    const long smem = 4L * ((long)(ft - 1) * hop + win + (long)ft * n_freqs + (long)ft * (n_mels + 1)) + mel_tables;
    if (smem <= MAX_SMEM) {
      p.smem = smem;
      p.frames = ft;
      return p;
    }
  }
  // the wide path: the power launch holds its frames' span only
  p.path = PATH_WIDE;
  p.threads = WIDE_BINS;
  for (int ft = WIDE_MAX_FRAMES; ft >= 1; ft /= 2) {
    const long smem = 4L * ((long)(ft - 1) * hop + win);
    if (smem <= MAX_SMEM) {
      p.smem = smem;
      p.frames = ft;
      return p;
    }
  }
  return p;
}

// cp.async of `chunks` 16-byte chunks into shared memory, through L2 only; the block waits for all of its copies
// with wait_copies.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int chunks) {
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(static_cast<float4*>(dst) + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(static_cast<const float4*>(src) + i));
  }
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// y[j] = x[j] - preemph * x[j-1] (y[0] = x[0]), rounded as the plain version rounds it (no fused multiply-add).
__device__ __forceinline__ float preemphasised(float x, float x_prev, float preemph) {
  return __fsub_rn(x, __fmul_rn(preemph, x_prev));
}

// The tile's span from global memory, sample by sample: span[i] = y[reflect(start + i - half)], 0 past the padded
// end (the frames past n_frames of the last tile read there and are never written). For the tiles at a row's
// ends, where the reflect pad acts, and for the dense path.
__device__ __forceinline__ void load_span(float* span, const float* __restrict__ row, long start, int span_len,
                                          int time, int half, float preemph) {
  const long padded_len = (long)time + 2L * half;
#pragma unroll 4
  for (int i = threadIdx.x; i < span_len; i += blockDim.x) {
    const long p = start + i;
    float v = 0.f;
    if (p < padded_len) {
      long j = p - half;
      if (j < 0) j = -j;
      else if (j >= time) j = 2L * (time - 1) - j;
      v = j == 0 ? __ldg(row) : preemphasised(__ldg(row + j), __ldg(row + j - 1), preemph);
    }
    span[i] = v;
  }
}

// The tile's log-mel into tile[f * (n_mels + 1) + mel], a thread a (mel, frame) with the frame fastest (2^log_ft
// frames): a warp reads one or two filters' weights (broadcasts) and its frames' power rows at a stride of `stride`
// floats, and its lanes loop the same number of times.
__device__ __forceinline__ void mel_tile(const float* power, int stride, int log_ft, const int* bands,
                                         const float* weights, float* tile, int n_mels) {
  for (int idx = threadIdx.x; idx < n_mels << log_ft; idx += blockDim.x) {
    const int mel = idx >> log_ft, f = idx & ((1 << log_ft) - 1);
    const int count = bands[n_mels + mel];
    const float* p = power + f * stride + bands[mel];
    const float* w = weights + bands[2 * n_mels + mel];
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < count; ++i) acc = fmaf(p[i], w[i], acc);
    tile[f * (n_mels + 1) + mel] = logf(acc + LOG_GUARD);
  }
}

// The tile's first `rows` rows to out (rows of n_mels floats, contiguous), coalesced.
__device__ __forceinline__ void store_tile(const float* tile, float* __restrict__ out, int rows, int n_mels) {
  int f = threadIdx.x / n_mels, mel = threadIdx.x - f * n_mels;  // element i of out is tile[i + f]
  const int df = blockDim.x / n_mels, dm = blockDim.x - df * n_mels;
  for (int i = threadIdx.x; i < rows * n_mels; i += blockDim.x) {
    out[i] = tile[i + f];
    f += df;
    mel += dm;
    if (mel >= n_mels) {
      mel -= n_mels;
      ++f;
    }
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// The 4-point DFT in place, natural order in and out.
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c, float2& d) {
  const float2 a0 = make_float2(a.x + c.x, a.y + c.y), a1 = make_float2(a.x - c.x, a.y - c.y);
  const float2 a2 = make_float2(b.x + d.x, b.y + d.y), a3 = make_float2(b.y - d.y, d.x - b.x);  // (b - d) * -i
  a = make_float2(a0.x + a2.x, a0.y + a2.y);
  b = make_float2(a1.x + a3.x, a1.y + a3.y);
  c = make_float2(a0.x - a2.x, a0.y - a2.y);
  d = make_float2(a1.x - a3.x, a1.y - a3.y);
}

// The 16-point DFT in registers as 4 x 4 (n = 4 n1 + n2, k = k1 + 4 k2): 4-point DFTs over n1, the twiddles
// W16^(n2 k1), 4-point DFTs over n2. X[k1 + 4 k2] ends in v[4 k1 + k2]. The constants are the host table's
// entries for N = 16 (float64 cos and sin of p pi / 8, rounded to float32).
__device__ __forceinline__ void dft16(float2 (&v)[16]) {
  constexpr float C1 = 0.92387953251128674f, S1 = 0.38268343236508978f, H = 0.70710678118654752f;
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) dft4(v[n2], v[n2 + 4], v[n2 + 8], v[n2 + 12]);
  v[5] = cmul(v[5], make_float2(C1, -S1));    // W^1
  v[9] = cmul(v[9], make_float2(H, -H));      // W^2
  v[13] = cmul(v[13], make_float2(S1, -C1));  // W^3
  v[6] = cmul(v[6], make_float2(H, -H));      // W^2
  v[10] = make_float2(v[10].y, -v[10].x);     // W^4 = -i
  v[14] = cmul(v[14], make_float2(-H, -H));   // W^6
  v[7] = cmul(v[7], make_float2(S1, -C1));    // W^3
  v[11] = cmul(v[11], make_float2(-H, -H));   // W^6
  v[15] = cmul(v[15], make_float2(-C1, S1));  // W^9
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) dft4(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3]);
}

// Where complex point i of the FFT buffers lives: its low 4 bits XORed with the next 4, a bijection within each 16
// points that spreads a radix-16 stage's stride-16 stores (Ns = 1) and its stride-16 loads over all banks.
__device__ __forceinline__ int sw(int i) { return i ^ ((i >> 4) & 15); }

// Where a stage reads: the FFT buffer, or (the first stage) the tile's samples under the window, packed two to a
// complex point: from its span of preemphasised samples, or from its raw audio (one sample before the span) with
// the preemphasis taken on the read.
enum Source { FROM_BUFFER, FROM_SPAN, FROM_RAW };

struct Frames {
  const float* samples;  // the span, or the raw audio
  const float* window;
  int hop, win, lpad;
  float preemph;
};

// The windowed sample at frame position n of frame f: 0 outside the window.
template <Source S>
__device__ __forceinline__ float windowed(const Frames& in, int f, int n) {
  const int i = n - in.lpad;
  if ((unsigned)i >= (unsigned)in.win) return 0.f;
  const int p = f * in.hop + i;
  const float y = S == FROM_RAW ? preemphasised(in.samples[p + 1], in.samples[p], in.preemph) : in.samples[p];
  return in.window[i] * y;
}

// One Stockham stage of radix R (2, 4 or 16) over every frame of the tile: butterfly j of a frame reads
// src[j + r*M/R], multiplies entry r by e^{-2 pi i r (j mod Ns) / (Ns R)}, takes the R-point DFT and writes entry
// r to dst[(j / Ns) Ns R + j mod Ns + r Ns]. The first stage (Ns = 1, no twiddles) reads the packed windowed
// samples instead of src.
template <int R, Source S>
__device__ __forceinline__ void fft_stage(const float2* src, float2* dst, const Frames& in, const float2* tw, int ft,
                                          int log_m, int log_ns) {
  constexpr int LOG_R = R == 16 ? 4 : R == 4 ? 2 : 1;
  const int log_q = log_m - LOG_R;
  const int q = 1 << log_q, ns = 1 << log_ns;
  const int tw_shift = log_m + 1 - log_ns - LOG_R;  // the table's step for e^{-2 pi i / (Ns R)}
  for (int idx = threadIdx.x; idx < ft << log_q; idx += blockDim.x) {
    const int f = idx >> log_q, j = idx & (q - 1);
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (S != FROM_BUFFER) {
        const int n = 2 * (j + r * q);
        v[r] = make_float2(windowed<S>(in, f, n), windowed<S>(in, f, n + 1));
      } else {
        v[r] = src[sw((f << log_m) + j + r * q)];
      }
    }
    const int jj = j & (ns - 1);
    if constexpr (S == FROM_BUFFER) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[(r * jj) << tw_shift]);
    }
    if constexpr (R == 2) {
      const float2 a = v[0], c = v[1];
      v[0] = make_float2(a.x + c.x, a.y + c.y);
      v[1] = make_float2(a.x - c.x, a.y - c.y);
    } else if constexpr (R == 4) {
      dft4(v[0], v[1], v[2], v[3]);
    } else {
      dft16(v);
    }
    const int base = (f << log_m) + ((j >> log_ns) << (log_ns + LOG_R)) + jj;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[sw(base + (r << log_ns))] = v[R == 16 ? 4 * (r & 3) + (r >> 2) : r];
  }
}

// The stages before the radix-16 ones, from the tile's samples in buf1 to buf0: radix 16 (log2 M = 0 mod 4), 4,
// 2, or 2 then 4 (back to buf1; src and dst are swapped so that the data is in dst). Returns log2 Ns after them.
template <Source S>
__device__ __forceinline__ int first_stages(float2*& src, float2*& dst, const Frames& in, const float2* tw, int ft,
                                            int log_m) {
  switch (log_m & 3) {
    case 0:
      fft_stage<16, S>(src, dst, in, tw, ft, log_m, 0);
      return 4;
    case 2:
      fft_stage<4, S>(src, dst, in, tw, ft, log_m, 0);
      return 2;
    case 1:
      fft_stage<2, S>(src, dst, in, tw, ft, log_m, 0);
      return 1;
    default:
      fft_stage<2, S>(src, dst, in, tw, ft, log_m, 0);
      __syncthreads();
      fft_stage<4, FROM_BUFFER>(dst, src, in, tw, ft, log_m, 1);
      float2* t = src;
      src = dst;
      dst = t;
      return 3;
  }
}

__global__ void __launch_bounds__(FFT_THREADS) log_mel_fft_kernel(
    const float* __restrict__ audio, const float4* __restrict__ tables, float* __restrict__ out, int time,
    int n_frames, int log_n, int hop, int win, int n_mels, int table_words, int log_ft, int buf, float preemph) {
  extern __shared__ __align__(16) float smem[];
  const int log_m = log_n - 1, m = 1 << log_m, ft = 1 << log_ft;
  float2* buf0 = reinterpret_cast<float2*>(smem);
  float2* buf1 = reinterpret_cast<float2*>(smem + buf);
  float2* tw = reinterpret_cast<float2*>(smem + 2 * buf);
  float* window = smem + 2 * buf + 4 * m;
  const int* bands = reinterpret_cast<const int*>(window + (win + 3) / 4 * 4);
  const float* weights = reinterpret_cast<const float*>(bands + (3 * n_mels + 3) / 4 * 4);

  // the tile's audio and the tables into shared memory: an interior tile (no reflection, inside the row) copies
  // x[a - 1 .. a + span_len) asynchronously into buf1, from the 16-byte boundary at or below x[a - 1] (the chunks
  // hold valid samples, so they lie inside the tensor's allocation), and its first stage takes the preemphasis
  // on the read; a tile at a row's end loads its span sample by sample
  const int b = blockIdx.y, f0 = blockIdx.x * ft;
  const int lpad = (2 * m - win) / 2;
  const int span_len = (ft - 1) * hop + win;
  const long start = (long)f0 * hop + lpad;  // the padded position of span[0]
  const long a = start - m;                  // the sample of span[0] when no reflection acts
  const float* row = audio + (size_t)b * time;
  const bool interior = a >= 1 && a + span_len <= time;
  float* samples = reinterpret_cast<float*>(buf1);
  if (interior) {
    const float* first = row + a - 1;
    const int lead = (int)((reinterpret_cast<size_t>(first) >> 2) & 3);
    copy_async(samples, first - lead, (lead + span_len + 4) / 4);
    samples += lead;
  }
  copy_async(tw, tables, table_words / 4);
  if (!interior) load_span(samples, row, start, span_len, time, m, preemph);
  wait_copies();
  __syncthreads();

  // the first stages, then radix 16 (M = 256: two radix-16 stages)
  const Frames in{samples, window, hop, win, lpad, preemph};
  float2* src = buf1;
  float2* dst = buf0;
  int log_ns = interior ? first_stages<FROM_RAW>(src, dst, in, tw, ft, log_m)
                        : first_stages<FROM_SPAN>(src, dst, in, tw, ft, log_m);
  for (; log_ns < log_m; log_ns += 4) {
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
    fft_stage<16, FROM_BUFFER>(src, dst, in, tw, ft, log_m, log_ns);
  }
  __syncthreads();

  // split, a thread a pair of bins (k, M - k) for k < M/2: with A = (Z[k] + conj Z[M-k]) / 2,
  // B = -i (Z[k] - conj Z[M-k]) / 2 and t = W^k B, X[k] = A + t and X[M-k] = conj(A - t) (k = 0: bins 0 and M);
  // bin M/2 is |Z[M/2]|^2. Z = FFT(z) is in dst; the power goes to src, M + 1 bins a frame.
  const float2* z = dst;
  float* power = reinterpret_cast<float*>(src);
  const int half = m / 2;
  for (int idx = threadIdx.x; idx < ft * half; idx += blockDim.x) {
    const int f = idx >> (log_m - 1), k = idx & (half - 1);
    const int zf = f << log_m;
    const float2 zk = z[sw(zf + k)], zc = z[sw(zf + ((m - k) & (m - 1)))];  // zc conjugated below
    const float2 h = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
    const float2 g = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
    const float2 t = cmul(tw[k], g);
    float* pf = power + f * (m + 1);
    const float re0 = h.x + t.x, im0 = h.y + t.y, re1 = h.x - t.x, im1 = h.y - t.y;
    pf[k] = re0 * re0 + im0 * im0;
    pf[m - k] = re1 * re1 + im1 * im1;
    if (k == 0) {
      const float2 u = z[sw(zf + half)];
      pf[half] = u.x * u.x + u.y * u.y;
    }
  }
  __syncthreads();
  float* tile = reinterpret_cast<float*>(dst);
  mel_tile(power, m + 1, log_ft, bands, weights, tile, n_mels);
  __syncthreads();
  store_tile(tile, out + ((size_t)b * n_frames + f0) * n_mels, min(ft, n_frames - f0), n_mels);
}

template <int FT>
__global__ void __launch_bounds__(1024) log_mel_dense_kernel(
    const float* __restrict__ audio, const float* __restrict__ basis, const float4* __restrict__ tables,
    float* __restrict__ out, int time, int n_frames, int n_fft, int hop, int win, int n_mels, int table_words,
    float preemph) {
  constexpr int LOG_FT = FT == 16 ? 4 : FT == 8 ? 3 : FT == 4 ? 2 : FT == 2 ? 1 : 0;
  extern __shared__ __align__(16) float smem[];
  const int n_freqs = n_fft / 2 + 1;
  const int span_len = (FT - 1) * hop + win;
  const int* bands = reinterpret_cast<const int*>(smem);
  const float* weights = smem + (3 * n_mels + 3) / 4 * 4;
  float* span = smem + table_words;
  float* power = span + span_len;      // [FT][n_freqs]
  float* tile = power + FT * n_freqs;  // [FT][n_mels + 1]
  const int b = blockIdx.y, f0 = blockIdx.x * FT;
  const int lpad = (n_fft - win) / 2;
  copy_async(smem, tables, table_words / 4);
  load_span(span, audio + (size_t)b * time, (long)f0 * hop + lpad, span_len, time, n_fft / 2, preemph);
  wait_copies();
  __syncthreads();

  const size_t two_f = 2 * (size_t)n_freqs;
  for (int k = threadIdx.x; k < n_freqs; k += blockDim.x) {
    float re[FT], im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    const float* cos_col = basis + (size_t)lpad * two_f + k;  // rows outside the window are zero: skipped
    for (int i = 0; i < win; ++i) {
      const float c = __ldg(cos_col + i * two_f), s = __ldg(cos_col + i * two_f + n_freqs);
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const float x = span[f * hop + i];
        re[f] = fmaf(x, c, re[f]);
        im[f] = fmaf(x, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) power[f * n_freqs + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();
  mel_tile(power, n_freqs, LOG_FT, bands, weights, tile, n_mels);
  __syncthreads();
  store_tile(tile, out + ((size_t)b * n_frames + f0) * n_mels, min(FT, n_frames - f0), n_mels);
}

// The wide path's power: power[b, f, k] = |sum_i x_f[i] w[i] e^{-2 pi i (lpad + i) k / n_fft}|^2 for the block's
// FT frames (a tile), WIDE_BINS bins (a thread a bin) and row. The basis entry is rounded as the host's table:
// float32 cos and sin (sincospif, within an ulp or two of the host's float64 ones rounded), then times the window.
template <int FT>
__global__ void __launch_bounds__(WIDE_BINS) log_mel_wide_power_kernel(
    const float* __restrict__ audio, const float* __restrict__ window, float* __restrict__ power, int time,
    int n_frames, int n_fft, int hop, int win, float preemph) {
  extern __shared__ __align__(16) float span[];
  const int n_freqs = n_fft / 2 + 1;
  const int span_len = (FT - 1) * hop + win;
  const int b = blockIdx.z, f0 = blockIdx.x * FT, k = blockIdx.y * WIDE_BINS + threadIdx.x;
  const int lpad = (n_fft - win) / 2;
  load_span(span, audio + (size_t)b * time, (long)f0 * hop + lpad, span_len, time, n_fft / 2, preemph);
  __syncthreads();
  if (k >= n_freqs) return;
  float re[FT], im[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) re[f] = im[f] = 0.f;
  const float two_over_n = 2.0f / (float)n_fft;
  int r = (int)(((long)lpad * k) % n_fft);  // (lpad + i) k mod n_fft, stepped by k
  for (int i = 0; i < win; ++i) {
    float s, c;
    sincospif((float)r * two_over_n, &s, &c);
    const float w = __ldg(window + i);
    c = __fmul_rn(c, w);
    s = __fmul_rn(-s, w);
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const float x = span[f * hop + i];
      re[f] = fmaf(x, c, re[f]);
      im[f] = fmaf(x, s, im[f]);
    }
    r += k;
    if (r >= n_fft) r -= n_fft;
  }
  float* out = power + ((size_t)b * n_frames + f0) * n_freqs + k;
#pragma unroll
  for (int f = 0; f < FT; ++f)
    if (f0 + f < n_frames) out[(size_t)f * n_freqs] = re[f] * re[f] + im[f] * im[f];
}

// The wide path's mel product and log over the power workspace: a block WIDE_MEL_FRAMES frames of one row, the
// filters' tables read from device memory.
__global__ void __launch_bounds__(FFT_THREADS) log_mel_wide_mel_kernel(
    const float* __restrict__ power, const float* __restrict__ tables, float* __restrict__ out, int n_frames,
    int n_freqs, int n_mels) {
  extern __shared__ __align__(16) float tile[];  // [WIDE_MEL_FRAMES][n_mels + 1]
  constexpr int LOG_FT = 4;
  static_assert(WIDE_MEL_FRAMES == 1 << LOG_FT, "the mel tile's frames");
  const int b = blockIdx.y, f0 = blockIdx.x * WIDE_MEL_FRAMES;
  const int rows = min(WIDE_MEL_FRAMES, n_frames - f0);
  const int* bands = reinterpret_cast<const int*>(tables);
  const float* weights = tables + (3 * n_mels + 3) / 4 * 4;
  // the frames past n_frames read row f0 (inside the workspace) and are never stored
  const float* rows_in = power + ((size_t)b * n_frames + f0) * n_freqs;
  for (int idx = threadIdx.x; idx < n_mels << LOG_FT; idx += blockDim.x) {
    const int mel = idx >> LOG_FT, f = idx & (WIDE_MEL_FRAMES - 1);
    const int count = bands[n_mels + mel];
    const float* p = rows_in + (size_t)(f < rows ? f : 0) * n_freqs + bands[mel];
    const float* w = weights + bands[2 * n_mels + mel];
    float acc = 0.f;
    for (int i = 0; i < count; ++i) acc = fmaf(p[i], w[i], acc);
    tile[f * (n_mels + 1) + mel] = logf(acc + LOG_GUARD);
  }
  __syncthreads();
  store_tile(tile, out + ((size_t)b * n_frames + f0) * n_mels, rows, n_mels);
}

template <int FT>
cudaError_t launch_wide(const Plan& p, int batch, cudaStream_t stream, const float* audio, const float* window,
                        const float* tables, float* power, float* out, int time, int n_frames, int n_fft, int hop,
                        int win, int n_mels, float preemph) {
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(log_mel_wide_power_kernel<FT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  const int n_freqs = n_fft / 2 + 1;
  const dim3 grid((n_frames + FT - 1) / FT, (n_freqs + WIDE_BINS - 1) / WIDE_BINS, batch);
  log_mel_wide_power_kernel<FT><<<grid, WIDE_BINS, p.smem, stream>>>(audio, window, power, time, n_frames, n_fft,
                                                                      hop, win, preemph);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 mel_grid((n_frames + WIDE_MEL_FRAMES - 1) / WIDE_MEL_FRAMES, batch);
  log_mel_wide_mel_kernel<<<mel_grid, FFT_THREADS, 4 * WIDE_MEL_FRAMES * (n_mels + 1), stream>>>(
      power, tables, out, n_frames, n_freqs, n_mels);
  return cudaGetLastError();
}

template <int FT>
cudaError_t launch_dense(const Plan& p, dim3 grid, cudaStream_t stream, const float* audio, const float* basis,
                         const float4* tables, float* out, int time, int n_frames, int n_fft, int hop, int win,
                         int n_mels, int table_words, float preemph) {
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(log_mel_dense_kernel<FT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  log_mel_dense_kernel<FT><<<grid, p.threads, p.smem, stream>>>(audio, basis, tables, out, time, n_frames, n_fft, hop,
                                                                 win, n_mels, table_words, preemph);
  return cudaGetLastError();
}

}  // namespace

// The plan for these sizes: out[0] the path (1 fft, 2 dense, 3 wide), out[1] shared memory a block (0: refused;
// on the wide path its power launch's), out[2] frames a block, out[3] threads a block.
extern "C" int thunder_log_mel_plan(int n_fft, int hop, int win, int n_mels, int* out) {
  const Plan p = make_plan(n_fft, hop, win, n_mels);
  out[0] = p.path;
  out[1] = (int)p.smem;
  out[2] = p.frames;
  out[3] = p.threads;
  return 0;
}

// audio: (batch, time) raw float32; tables: the host's packed tables, table_words floats (a multiple of 4, each
// part padded to one): on the fft path the twiddles e^{-2 pi i k / n_fft} as (n_fft, 2) and the win_length hann
// window, then on both paths the (3, n_mels) int32 first bin, count and offset of each mel filter's non-zeros
// and the weights (at most two a bin); basis: the windowed basis (n_fft, 2 * n_freqs) on the dense path, the
// window (win,) on the wide path, else unused; power: on the wide path a (slice_rows, n_frames, n_freqs) float32
// workspace, else unused; out: (batch, n_frames, n_mels). The launches go over slices of slice_rows rows (at most
// 65,535). Returns cudaGetLastError().
extern "C" int thunder_log_mel(const float* audio, const float* tables, const float* basis, float* power, float* out,
                               int batch, int time, int n_frames, int n_fft, int hop, int win, int n_mels,
                               int table_words, int slice_rows, float preemph, void* stream) {
  const Plan p = make_plan(n_fft, hop, win, n_mels);
  const int n_freqs = n_fft / 2 + 1;
  const long fft_words = p.path == PATH_FFT ? 2L * n_fft + round4(win) : 0;
  if (p.smem == 0 || batch < 1 || slice_rows < 1 || slice_rows > MAX_ROWS || time <= n_fft / 2 || n_frames < 1 ||
      table_words % 4 || table_words > fft_words + round4(3 * n_mels) + round4(2 * n_freqs) ||
      (p.path == PATH_WIDE && power == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* tables4 = reinterpret_cast<const float4*>(tables);
  int log_n = 0, log_ft = 0;
  while ((1 << log_n) < n_fft) ++log_n;
  while ((1 << log_ft) < p.frames) ++log_ft;
  if (p.path == PATH_FFT && p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(log_mel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  decltype(&launch_dense<1>) dense = launch_dense<1>;
  decltype(&launch_wide<1>) wide = launch_wide<1>;
  switch (p.frames) {
    case 16: dense = launch_dense<16>; wide = launch_wide<16>; break;
    case 8: dense = launch_dense<8>; wide = launch_wide<8>; break;
    case 4: dense = launch_dense<4>; wide = launch_wide<4>; break;
    case 2: dense = launch_dense<2>; wide = launch_wide<2>; break;
  }
  for (int r0 = 0; r0 < batch; r0 += slice_rows) {
    const int rows = std::min(slice_rows, batch - r0);
    const float* a = audio + (size_t)r0 * time;
    float* o = out + (size_t)r0 * n_frames * n_mels;
    const dim3 grid((n_frames + p.frames - 1) / p.frames, rows);
    cudaError_t err;
    if (p.path == PATH_FFT) {
      log_mel_fft_kernel<<<grid, p.threads, p.smem, s>>>(a, tables4, o, time, n_frames, log_n, hop, win, n_mels,
                                                          table_words, log_ft, (int)p.buf, preemph);
      err = cudaGetLastError();
    } else if (p.path == PATH_DENSE) {
      err = dense(p, grid, s, a, basis, tables4, o, time, n_frames, n_fft, hop, win, n_mels, table_words, preemph);
    } else {
      err = wide(p, rows, s, a, basis, tables, power, o, time, n_frames, n_fft, hop, win, n_mels, preemph);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
