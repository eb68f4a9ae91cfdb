// One separable conv repeat in one launch for Hopper (sm_90a): bf16 in and out,
// float32 accumulation.
//
// Replaces: thunder_tpu/kernels/separable_conv.py::fused_separable_conv and
// thunder_tpu/kernels/repeat_tm.py::fused_repeat_tm (the Pallas TPU kernels).
// For a channels-last input x (B, T_in, C_in), zero beyond each row's length:
//   d[b, t, c]   = bf16( sum_j x[b, t*stride - pad + j*dilation, c] * dw[j, c] )   (f32 sum, j in order)
//   out[b, t, o] = t < out_lengths[b] ? act( sum_c d[b, t, c] * pw[c, o] + bias[o] ) : 0
// with act = ReLU or identity, the BN scale already folded into pw and bias.
// Unlike the TPU kernels it takes any stride, dilation and channel count (a
// multiple of 8 here; kernels/separable_conv.py pads others with zeros), so the
// stem (stride 2, 64 channels) and the tail (dilation 2) of QuartzNet run
// through it too.
//
// What bounds it on this card: by the operations, the depthwise, 2 k C_in f32
// operations a frame on the CUDA cores (67 TFLOP/s), beside the pointwise
// product's 2 C_in C_out bf16 operations on the tensor cores (989 TFLOP/s);
// device memory (one read of x, one write of out) is small beside both. In
// practice L2 traffic binds it: each block reads all of pw (512 KB at C = 512)
// and its chunks' input span with its halo and the taps, about 550 MB a launch
// at 64 x 751 x 512, against about 3 TB/s out of L2 (PERF.md).
//
// Design:
// - one block of two warpgroups per (batch row, tile of TT = 64 output frames);
//   at C_in = 512 a block holds 113 KB of shared memory, so two blocks share an
//   SM and one block's depthwise (CUDA cores) overlaps the other's products
//   (tensor cores);
// - depthwise, 64 channels at a time: the chunk's input span and its taps are
//   copied into shared memory as bf16 (128-byte rows), and each thread owns
//   R = 8 consecutive output frames of two channels. At stride 1 it loads a
//   window of R + (U - 1) * dilation rows into registers and applies U = 8
//   taps to it, so one 4-byte shared load feeds up to 2 R FMAs. Other strides
//   (the stem) load each input directly. The f32 sums, rounded to bf16, go
//   straight into the A operand: one 8 KB panel per 64 channels, 128-byte rows
//   in the 128-byte swizzle (16-byte chunk c of row r at c ^ (r & 7)),
//   channels past C_in as zeros;
// - pointwise product on wgmma: each warpgroup owns every other 64-wide column
//   box of the output. Its weight boxes, 64 (C_in) x 64 (C_out) in the 128-byte
//   swizzle, arrive by TMA (one elected thread per warpgroup, no producer warp)
//   into the warpgroup's own ring of `stages` boxes with full and empty
//   mbarriers; pw (C_in, C_out) with C_out contiguous is wgmma's MN-major B
//   operand (the transpose bit), rows past C_in and columns past C_out arrive
//   as zeros. Four m64n64k16 steps per box, A and B from shared memory;
// - the epilogue (bias, ReLU, zero beyond out_lengths, bf16 store) runs from
//   the accumulator registers, with no trip through shared memory;
// - the span and taps share their bytes with the weight ring when both do not
//   fit beside the A tile (C_in = 512: A 64 KB, ring 2 x 3 x 8 KB); where they
//   fit, the first weight boxes are requested before the depthwise starts.
// - an input too wide for its A tile (C_in past about 1,500 at k = 33) runs
//   as `parts` launches over slices of C_in of `part` channels each (the
//   widest whose plan fits): each adds its product into a float32 (B, T_out,
//   C_out) workspace in place, and the last adds bias, ReLU and the mask and
//   stores bf16. x and dw keep their row stride x_ld = C_in; the weight map
//   covers the part's rows of pw only, so the box past them arrives as zeros.
// - a span too long for even 64 channels beside their A tile (k past 560 at
//   dilation 2) runs as launches over slices of the taps, `taps` of them each
//   (the most, a multiple of U, whose span fits), each slice over the channel
//   slices above: every slice but the last only adds its taps into the
//   depthwise sums, kept in a float32 (B, T_out, C_in) workspace, and stops
//   there; each slice after the first starts its sums from the workspace; the
//   last rounds them to bf16 and runs the product and the epilogue. The f32
//   sums take the taps in order, one fused multiply-add each, as one launch
//   would, so slicing the taps does not change the result. These launches take
//   the direct depthwise (any stride and dilation).
// The first 4 x 256 16-byte chunks of the next channel chunk's span are
// loaded into registers while this chunk's depthwise runs (8 of them, or the
// rest batched four at a time, cost registers and gained less); keeping one
// wgmma group in flight was measured and slowed the products (PERF.md).
// The TPU kernel's time-major layout and 3-tile DMA shift register were
// sublane workarounds and are not carried over.

#include <algorithm>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int TT = 64;                   // output frames per block: the m of one wgmma
constexpr int KC = 64;                   // channels per depthwise chunk: one 128-byte panel of the A operand
constexpr int R = 8;                     // consecutive output frames per thread in the depthwise
constexpr int U = 8;                     // taps applied to one register window
constexpr int WARPGROUPS = 2;
constexpr int THREADS = 128 * WARPGROUPS;
constexpr int BOX_BYTES = 64 * 64 * 2;   // a 64 x 64 bf16 weight box
constexpr int PANEL_BYTES = TT * 128;    // 64 channels of TT frames
constexpr int ROW_BYTES = KC * 2;        // a span row: 64 bf16 channels
constexpr long TWO_BLOCKS_SMEM = 115712;  // (228 KB - 1 KB reserved per block) / 2
constexpr long MAX_SMEM = 232448;        // 227 KB, one block
constexpr int MAX_STAGES = 4;
constexpr int PREFETCH = 4;              // 16-byte span chunks a thread loads one channel chunk ahead

static_assert(THREADS == (TT / R) * (KC / 2), "depthwise mapping: one thread per R frames x 2 channels");

__host__ __device__ inline long round_up(long x, long m) { return (x + m - 1) / m * m; }

__host__ __device__ inline int span_rows(int k, int stride, int dilation) {
  return (TT - 1) * stride + (int)(round_up(k, U) - 1) * dilation + 1;
}

struct Plan {
  long smem = 0;  // 0: does not fit
  int stages = 0, prefetch = 0, ring_off = 0, span_off = 0, layout = 0;
  int part = 0, parts = 0;       // input channels a launch, launches over them (channel_plan)
  int taps = 0, tap_slices = 0;  // taps a launch, launches over them (split_plan)
};

// Shared-memory layout from the 1024-byte aligned base: the A tile, each warpgroup's ring, then the chunk's input
// span and taps (after the ring when they fit, else over it). 1 KB more aligns the base, and the barriers (at most
// 128 bytes) live in whichever side of that slack holds them. The deepest ring that keeps two blocks on an SM, else
// the deepest that fits one.
Plan make_plan(int c_in, int k, int stride, int dilation) {
  const long a = round_up(c_in, KC) / KC * PANEL_BYTES;
  const long span = (long)(span_rows(k, stride, dilation) + round_up(k, U)) * ROW_BYTES;
  for (long limit : {TWO_BLOCKS_SMEM, MAX_SMEM}) {
    for (int stages = MAX_STAGES; stages >= 2; --stages) {
      const long ring = (long)WARPGROUPS * stages * BOX_BYTES;
      for (int prefetch = 1; prefetch >= 0; --prefetch) {
        const long span_off = prefetch ? a + ring : a;
        const long layout = std::max(a + ring, span_off + span);
        if (layout + 1024 <= limit) {
          Plan p;
          p.smem = layout + 1024;
          p.stages = stages;
          p.prefetch = prefetch;
          p.ring_off = (int)a;
          p.span_off = (int)span_off;
          p.layout = (int)layout;
          return p;
        }
      }
    }
  }
  return Plan{};
}

// All of C_in in one launch when its plan fits; else the fewest launches over slices of at most the widest multiple
// of KC channels that fits, the slices as even as KC allows. smem 0: not even KC channels fit (the span alone is
// too long).
Plan channel_plan(int c_in, int k, int stride, int dilation) {
  Plan p = make_plan(c_in, k, stride, dilation);
  int widest = c_in;
  while (p.smem == 0 && widest > KC) {
    widest = (int)round_up(widest, KC) - KC;
    p = make_plan(widest, k, stride, dilation);
  }
  if (p.smem == 0) return Plan{};
  const int parts = (c_in + widest - 1) / widest;
  const int part = parts == 1 ? c_in : (int)round_up((c_in + parts - 1) / parts, KC);
  if (part != widest) p = make_plan(part, k, stride, dilation);  // narrower: it fits too
  p.part = part;
  p.parts = parts;
  return p;
}

// channel_plan over all k taps when it fits; else over slices of `taps` taps, the most (a multiple of U) whose span
// fits beside KC channels. The plan made for `taps` holds the shorter last slice too. smem 0: not even U taps fit.
Plan split_plan(int c_in, int k, int stride, int dilation) {
  Plan p = channel_plan(c_in, k, stride, dilation);
  int taps = k;
  if (p.smem == 0) {
    taps = (int)round_up(k, U) - U;
    while (taps >= U && make_plan(KC, taps, stride, dilation).smem == 0) taps -= U;
    if (taps < U) return Plan{};
    p = channel_plan(c_in, taps, stride, dilation);
  }
  p.taps = taps;
  p.tap_slices = (k + taps - 1) / taps;
  return p;
}

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// stride 1, dilation D: `span` is this thread's column at its first frame's row, `taps` at tap 0 (rows of 32 words;
// the taps are zero from k to a multiple of U)
template <int D>
__device__ __forceinline__ void depthwise_window(const uint32_t* span, const uint32_t* taps, int k, float (&a0)[R],
                                                 float (&a1)[R]) {
  constexpr int W = R + (U - 1) * D;
  for (int j0 = 0; j0 < k; j0 += U) {
    float w0[U], w1[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t v = taps[(j0 + u) * 32];
      w0[u] = lo_f(v);
      w1[u] = hi_f(v);
    }
    float x0[W], x1[W];
#pragma unroll
    for (int m = 0; m < W; ++m) {
      const uint32_t v = span[(j0 * D + m) * 32];
      x0[m] = lo_f(v);
      x1[m] = hi_f(v);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a0[i] = fmaf(x0[i + u * D], w0[u], a0[i]);
        a1[i] = fmaf(x1[i + u * D], w1[u], a1[i]);
      }
  }
}

// any stride and dilation: `span` is this thread's column at row 0, frame f reads row f * stride + j * dilation
__device__ __forceinline__ void depthwise_direct(const uint32_t* span, const uint32_t* taps, int k, int f0, int stride,
                                                 int dilation, float (&a0)[R], float (&a1)[R]) {
  for (int j = 0; j < k; ++j) {
    const uint32_t w = taps[j * 32];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const uint32_t v = span[((f0 + i) * stride + j * dilation) * 32];
      a0[i] = fmaf(lo_f(v), lo_f(w), a0[i]);
      a1[i] = fmaf(hi_f(v), hi_f(w), a1[i]);
    }
  }
}

// MODE 1: stride 1, dilation 1; MODE 2: stride 1, dilation 2; MODE 0: any stride and dilation. SPLIT: one of
// several launches over slices of C_in (x_ld, partial, first and last are read only then). TAPS: one of several
// launches over slices of the taps (dw_sum, a (B, t_out, x_ld) f32 workspace, tap_in and tap_out are read only
// then): tap_in starts the depthwise sums from dw_sum, tap_out stores them there and ends the launch
template <int MODE, bool SPLIT, bool TAPS>
__global__ void __launch_bounds__(THREADS, 2)
    separable_repeat_kernel(const __grid_constant__ CUtensorMap pw_map, const bf16* __restrict__ x,
                            const bf16* __restrict__ dw, const float* __restrict__ bias,
                            const int* __restrict__ out_lengths, bf16* __restrict__ out,
                            float* __restrict__ partial, float* __restrict__ dw_sum, int t_in, int t_out, int c_in,
                            int x_ld, int c_out, int k, int stride, int dilation, int pad, int relu, int first,
                            int last, int tap_in, int tap_out, int stages, int prefetch, int ring_off, int span_off,
                            int layout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t lead = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + lead;
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wtid = tid % 128;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int panels = (c_in + KC - 1) / KC;
  const int n_boxes = (c_out + 63) / 64;
  // this warpgroup's weight boxes, in order: output columns q = wg, wg + 2, ..., each over every panel of C_in
  const int my_boxes = (n_boxes > wg ? (n_boxes - wg + 1) / 2 : 0) * panels;
  const uint32_t ring = base + ring_off + wg * stages * BOX_BYTES;
  // the barriers: in the alignment slack before the base when it holds them, else in the slack after the layout
  const uint32_t bars = lead >= WARPGROUPS * MAX_STAGES * 16 ? smem_u32(smem_raw) : base + layout;
  const uint32_t full = bars + wg * stages * 16;
  const uint32_t empty = full + 8 * stages;

  if (wtid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* map = &pw_map;
  auto issue = [&](int n) {  // this warpgroup's box n into stage n % stages
    const int s = n % stages;
    mbar_expect_tx(full + 8 * s, BOX_BYTES);
    tma_load(ring + s * BOX_BYTES, map, full + 8 * s, (wg + 2 * (n / panels)) * 64, (n % panels) * KC, 0);
  };
  if (prefetch && wtid == 0)
    for (int n = 0; n < min(stages, my_boxes); ++n) issue(n);

  // ---- depthwise: 64 channels at a time into the A panels
  const int p = tid % 32;  // channel pair: this thread's channels c0 + 2p, c0 + 2p + 1
  const int g = tid / 32;  // frame group: frames g R .. g R + R - 1 of the tile
  unsigned char* span = smem + span_off;
  const int rows = span_rows(k, stride, dilation);
  const int chunks = (rows + (int)round_up(k, U)) * 8;  // 16-byte chunks of the span and of the taps after it
  const int in0 = t0 * stride - pad;  // input frame of span row 0
  const int ld = SPLIT ? x_ld : c_in;  // the row stride of x, dw and dw_sum
  const bf16* xb = x + (size_t)b * t_in * ld;
  // 16-byte chunk i of channel chunk c0: span row i / 8 (zero outside the input), then the taps (zero past k)
  auto fetch = [&](int i, int c0) {
    const int row = i / 8;
    const int ch = c0 + 8 * (i % 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows) {
      const int t = in0 + row;
      if (t >= 0 && t < t_in && ch < c_in) v = *reinterpret_cast<const uint4*>(xb + (size_t)t * ld + ch);
    } else if (row - rows < k && ch < c_in && i < chunks) {
      v = *reinterpret_cast<const uint4*>(dw + (size_t)(row - rows) * ld + ch);
    }
    return v;
  };
  uint4 ahead[PREFETCH];  // the first PREFETCH * THREADS chunks of the next channel chunk, loaded a chunk early
#pragma unroll
  for (int u = 0; u < PREFETCH; ++u) ahead[u] = fetch(u * THREADS + tid, 0);
  for (int c0 = 0; c0 < c_in; c0 += KC) {
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int i = u * THREADS + tid;
      if (i < chunks) *reinterpret_cast<uint4*>(span + (size_t)i * 16) = ahead[u];
    }
    for (int i = PREFETCH * THREADS + tid; i < chunks; i += THREADS)  // the rest, loaded now
      *reinterpret_cast<uint4*>(span + (size_t)i * 16) = fetch(i, c0);
    __syncthreads();
    if (c0 + KC < c_in) {
#pragma unroll
      for (int u = 0; u < PREFETCH; ++u) ahead[u] = fetch(u * THREADS + tid, c0 + KC);
    }

    float a0[R], a1[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a0[i] = a1[i] = 0.f;
    const int ch = c0 + 2 * p;
    float* sums = TAPS ? dw_sum + ((size_t)b * t_out + t0 + g * R) * ld + ch : nullptr;  // at its first frame
    if (TAPS && tap_in && ch < c_in) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (t0 + g * R + i < t_out) {
          const float2 v = *reinterpret_cast<const float2*>(sums + (size_t)i * ld);
          a0[i] = v.x;
          a1[i] = v.y;
        }
    }
    const uint32_t* col = reinterpret_cast<const uint32_t*>(span) + p;
    const uint32_t* taps = col + rows * 32;
    if (MODE == 1)
      depthwise_window<1>(col + g * R * 32, taps, k, a0, a1);
    else if (MODE == 2)
      depthwise_window<2>(col + g * R * 32, taps, k, a0, a1);
    else
      depthwise_direct(col, taps, k, g * R, stride, dilation, a0, a1);

    if (TAPS && tap_out) {
      if (ch < c_in) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (t0 + g * R + i < t_out) *reinterpret_cast<float2*>(sums + (size_t)i * ld) = make_float2(a0[i], a1[i]);
      }
    } else {
      unsigned char* panel = smem + (c0 / KC) * PANEL_BYTES;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = g * R + i;
        *reinterpret_cast<uint32_t*>(panel + r * 128 + (((p >> 2) ^ (r & 7)) << 4) + (p & 3) * 4) =
            pack_bf16(a0[i], a1[i]);
      }
    }
    __syncthreads();  // the next chunk overwrites the span
  }
  if (TAPS && tap_out) return;  // the later tap slices go on from the sums; no weight box was requested
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the A tile, visible to wgmma; the span, free for TMA
  __syncthreads();

  // ---- pointwise product: this warpgroup's column boxes, 64 x 64 each
  if (!prefetch && wtid == 0)
    for (int n = 0; n < min(stages, my_boxes); ++n) issue(n);
  const int warp = wtid / 32;
  const int lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;  // accumulator rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);        // and columns col0, col0 + 1 of each group of 8
  const int valid = out_lengths[b];
  bf16* ob = out + (size_t)b * t_out * c_out;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int n = 0; n < my_boxes; ++n) {
    const int s = n % stages;
    const int kc = n % panels;
    mbar_wait(full + 8 * s, (n / stages) & 1);
    const uint64_t a_desc = desc_sw128(base + kc * PANEL_BYTES, 16, 1024);
    const uint64_t b_desc = desc_sw128(ring + s * BOX_BYTES, 16, 1024);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)  // A: 32 bytes along the swizzled rows; B: 16 rows of 128 bytes
      wgmma_ss_bmn(acc, a_desc + 2 * kk, b_desc + 128 * kk, kc > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait();
    pin(acc);
    mbar_arrive(empty + 8 * s);
    if (wtid == 0 && n + stages < my_boxes) {
      mbar_wait(empty + 8 * s, (n / stages) & 1);
      issue(n + stages);
    }
    if (kc == panels - 1) {  // the epilogue of output columns 64 q ..
      const int q = wg + 2 * (n / panels);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int t = t0 + row0 + 8 * ((i >> 1) & 1);
        const int o = q * 64 + 8 * (i / 4) + col0;
        if (t < t_out && o < c_out) {
          float v0 = acc[i], v1 = acc[i + 1];
          if (SPLIT) {
            float2* ps = reinterpret_cast<float2*>(partial + ((size_t)b * t_out + t) * c_out + o);
            if (!first) {  // the earlier slices' sum
              const float2 sp = *ps;
              v0 += sp.x;
              v1 += sp.y;
            }
            if (!last) {
              *ps = make_float2(v0, v1);
              continue;
            }
          }
          v0 += bias[o];
          v1 += bias[o + 1];
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          if (t >= valid) v0 = v1 = 0.f;
          *reinterpret_cast<uint32_t*>(ob + (size_t)t * c_out + o) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

using Kernel = decltype(&separable_repeat_kernel<1, false, false>);

template <bool SPLIT>
Kernel pick_mode(int stride, int dilation, bool taps) {
  if (taps) return separable_repeat_kernel<0, SPLIT, true>;
  if (stride == 1 && dilation == 1) return separable_repeat_kernel<1, SPLIT, false>;
  if (stride == 1 && dilation == 2) return separable_repeat_kernel<2, SPLIT, false>;
  return separable_repeat_kernel<0, SPLIT, false>;
}

Kernel pick(int stride, int dilation, const Plan& plan) {
  const bool taps = plan.tap_slices > 1;
  return plan.parts > 1 ? pick_mode<true>(stride, dilation, taps) : pick_mode<false>(stride, dilation, taps);
}

}  // namespace

// The launch's plan for these widths (split_plan): out[0] shared-memory bytes per block (0: the span of 64
// channels and 8 taps does not fit in 227 KB), out[1] the weight ring's stages per warpgroup, out[2] 1 if the first
// weight boxes are requested before the depthwise, out[3] resident blocks per SM, out[4] the launches over slices
// of C_in, out[5] the channels of each slice, out[6] the taps a launch, out[7] the launches over slices of the
// taps (each over the slices of C_in). Returns a cudaError_t.
extern "C" int thunder_separable_repeat_plan(int c_in, int k, int stride, int dilation, int* out) {
  if (c_in < 8 || c_in % 8 || k < 1 || stride < 1 || dilation < 1) return (int)cudaErrorInvalidValue;
  const Plan plan = split_plan(c_in, k, stride, dilation);
  out[0] = (int)plan.smem;
  out[1] = plan.stages;
  out[2] = plan.prefetch;
  out[3] = 0;
  out[4] = plan.parts;
  out[5] = plan.part;
  out[6] = plan.taps;
  out[7] = plan.tap_slices;
  if (plan.smem == 0) return 0;
  const Kernel kernel = pick(stride, dilation, plan);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, THREADS, plan.smem);
}

// x: (batch, t_in, c_in) bf16, zero beyond each row's input length; dw: (k, c_in) bf16;
// pw: (c_in, c_out) bf16; bias: (c_out,) f32; out_lengths: (batch,) int32;
// out: (batch, t_out, c_out) bf16; x, dw, pw and out 16-byte aligned; partial: a (batch, t_out, c_out) f32
// workspace when thunder_separable_repeat_plan gives more than one launch over C_in, else unused; dw_sum: a
// (batch, t_out, c_in) f32 workspace when it gives more than one launch over the taps, else unused. Returns
// cudaGetLastError().
extern "C" int thunder_separable_repeat(const void* x, const void* dw, const void* pw, const float* bias,
                                        const int* out_lengths, void* out, float* partial, float* dw_sum, int batch,
                                        int t_in, int t_out, int c_in, int c_out, int k, int stride, int dilation,
                                        int pad, int relu, void* stream) {
  if (batch < 1 || batch > 65535 || t_in < 1 || t_out < 1 || c_in < 8 || c_in % 8 || c_out < 8 || c_out % 8 ||
      k < 1 || stride < 1 || dilation < 1)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dw) | reinterpret_cast<uintptr_t>(pw) |
       reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(partial) |
       reinterpret_cast<uintptr_t>(dw_sum)) &
      15)
    return (int)cudaErrorMisalignedAddress;
  const Plan plan = split_plan(c_in, k, stride, dilation);
  if (plan.smem == 0) return (int)cudaErrorInvalidValue;  // thunder_separable_repeat_plan names the reason
  if ((plan.parts > 1 && partial == nullptr) || (plan.tap_slices > 1 && dw_sum == nullptr))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const Kernel kernel = pick(stride, dilation, plan);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_out + TT - 1) / TT, batch);
  for (int j0 = 0; j0 < k; j0 += plan.taps) {
    const int taps = std::min(plan.taps, k - j0);
    const int tap_out = j0 + taps < k;
    for (int c0 = 0; c0 < c_in; c0 += plan.part) {
      const int part = std::min(plan.part, c_in - c0);
      // this slice's rows of pw as (c_out, part, 1), innermost first: 64 x 64 boxes in the 128-byte swizzle, zeros
      // past either edge
      const cuuint64_t dims[3] = {(cuuint64_t)c_out, (cuuint64_t)part, 1};
      const cuuint64_t strides[2] = {(cuuint64_t)c_out * sizeof(bf16), (cuuint64_t)c_out * sizeof(bf16) * part};
      const cuuint32_t box[3] = {64, 64, 1};
      const cuuint32_t element_strides[3] = {1, 1, 1};
      CUtensorMap map;
      if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                 const_cast<bf16*>(static_cast<const bf16*>(pw) + (size_t)c0 * c_out), dims, strides, box,
                 element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
      // tap slice j0 of the taps: its taps' rows of dw, its input frames from j0 * dilation later (pad less that)
      kernel<<<grid, THREADS, plan.smem, static_cast<cudaStream_t>(stream)>>>(
          map, static_cast<const bf16*>(x) + c0, static_cast<const bf16*>(dw) + (size_t)j0 * c_in + c0, bias,
          out_lengths, static_cast<bf16*>(out), partial, dw_sum == nullptr ? nullptr : dw_sum + c0, t_in, t_out, part,
          c_in, c_out, taps, stride, dilation, pad - j0 * dilation, relu, c0 == 0, c0 + part >= c_in, j0 > 0, tap_out,
          plan.stages, tap_out ? 0 : plan.prefetch, plan.ring_off, plan.span_off, plan.layout);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}
