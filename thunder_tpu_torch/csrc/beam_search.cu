// CTC prefix beam search for Hopper (sm_90a): the frame scan and the pointer-walk backtrace.
//
// Replaces: thunder_tpu/kernels/beam_pallas.py::beam_scan_pallas (the Pallas TPU kernel
// _kernel) and ::beam_backtrace_pallas (_backtrace_kernel). The boundary is the JAX
// wrappers': log-probs logp (B, T, V) float32 (with, when K < V, the top-K candidates
// topv/topi (B, T, K) that the wrapper pre-prunes in PyTorch), lengths, the prune floor
// and the carried state (pb, pnb, h1, h2, last), each (B, W), go in; the per-frame
// pointers parents/exts (B, T, W), total (B, W) and the final state come out. The
// backtrace takes (parents, exts, slots0 (B, n_out)) and gives toks (B, n_out, T) and
// origin (B, n_out).
//
// Per frame and row, as the TPU kernel computes it:
//   stay rows (W):       pb' = total + p_blank (p_blank >= floor), pnb' = pnb + p(last)
//                        (last among the frame's kept candidates)
//   extend rows (W*K):   pnb' = (v == last ? pb : total) + p(v), v kept and not blank;
//                        hashes h1*1000003 + (v+2), h2*2654435761 + (v+2), uint32
//   merge:               an extend row whose hashes equal a stay row's is absorbed into it
//                        (masked max of the matching rows, then logaddexp) and dies
//   top-W:               over W + W*K candidates (stay rows first, then parent*K + slot),
//                        value descending, ties to the lower index; a pick is killed to
//                        -inf, so once every candidate is -inf every further pick is 0
//   commit:              a no-op (identity parents, -1 exts) past the row's length or
//                        when the frame's best candidate is -inf
// The arithmetic is the plain version's operation for operation (logaddexp as torch
// computes it: max + log1pf(expf(-|a-b|)), -inf with -inf gives -inf; expf and log1pf
// at full precision, the build has no fast-math), so ids, pointers and state agree
// exactly with thunder_tpu_torch/kernels/beam.py::beam_scan_reference on the card.
//
// What bounds it on this card: the serial chain of T frames in each row, not bytes and
// not operations. At the QuartzNet serving shape (B = 64, T = 751, V = K = 29, W = 16)
// the scan reads B*T*(2K+1)*4 bytes and writes 2*B*T*W*4, about 17.5 MB, about 5 us at
// 3.35 TB/s; a frame is some 2,000 dependent integer and float steps in one warp (16
// rounds of a warp arg-max among them), and 751 frames run back to back. B = 64 rows fill
// 64 of the 132 SMs with one warp each.
//
// Design: one warp per row (a block of 32 threads), the W-beam state double-buffered in
// shared memory across all frames, the frame's K candidates staged in shared memory, the
// W + W*K candidate totals in shared memory. The merge is one pass over the extend rows,
// each comparing its hashes with the W stay rows and taking the masked max through an
// integer atomicMax on order-preserving float bits. The top-W is W rounds of a warp
// arg-max by shuffles over each lane's cached best; only the lane that owned the pick
// rescans. A row stops at its length and fills the rest of its pointers with identity.
// Nothing needs a barrier wider than the warp. The TPU's time-major (T, K, B) layout, the
// batch on the 128 lanes and the TB-frame padding were Mosaic's and are not carried over.
//
// The backtrace: one block per row (and per 128 output slots), which stages the row's
// pointers in shared memory in chunks of frames, newest first; one thread per output
// slot walks t = T-1 ... 0, writing toks[t] = exts[t][slot] and then slot = parents[t][slot].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t M1 = 1000003u;
constexpr uint32_t M2 = 2654435761u;
constexpr uint32_t DEAD_H1 = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int NO_INDEX = 0x7FFFFFFF;
constexpr size_t MAX_SMEM = 232448;       // what a block may opt into on sm_90
constexpr size_t BACKTRACE_SMEM = 49152;  // the backtrace's frame chunks fit the default
constexpr int BACKTRACE_THREADS = 128;

__device__ __forceinline__ float lae(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// float bits -> int with the same order (no NaN here), for atomicMax
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float unordered(int i) { return __int_as_float(i >= 0 ? i : i ^ 0x7FFFFFFF); }

// value descending, ties to the lower index
__device__ __forceinline__ bool better(float v, int i, float w, int j) { return v > w || (v == w && i < j); }

__device__ __forceinline__ void lane_best(const float* cand, int C, int lane, float& bv, int& bi) {
  bv = -INFINITY;
  bi = NO_INDEX;
  for (int c = lane; c < C; c += 32) {
    if (better(cand[c], c, bv, bi)) {
      bv = cand[c];
      bi = c;
    }
  }
}

// kernels/beam.py::scan_shared_bytes computes the same, to refuse a configuration above MAX_SMEM
size_t scan_smem_bytes(int W, int K) {
  const size_t C = (size_t)W + (size_t)W * K;
  return 4 * (C + 2 * (size_t)K + 17 * (size_t)W);
}

__global__ void __launch_bounds__(32) beam_scan_kernel(
    const float* __restrict__ logp, const float* __restrict__ topv, const int* __restrict__ topi,
    const int* __restrict__ lens, float floor_, const float* __restrict__ pb0, const float* __restrict__ pnb0,
    const int* __restrict__ h10, const int* __restrict__ h20, const int* __restrict__ last0,
    int* __restrict__ parents, int* __restrict__ exts, float* __restrict__ total_out, float* __restrict__ pb_out,
    float* __restrict__ pnb_out, int* __restrict__ h1_out, int* __restrict__ h2_out, int* __restrict__ last_out,
    int T, int V, int K, int W, int blank) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = W + W * K;
  float* cand = reinterpret_cast<float*>(smem);  // [C] candidate totals, stay rows first
  float* cv = cand + C;                          // [K] the frame's candidate log-probs
  int* ci = reinterpret_cast<int*>(cv + K);      // [K] and their token ids
  float* pbs = reinterpret_cast<float*>(ci + K);  // [2][W] state, double-buffered
  float* pnbs = pbs + 2 * W;
  uint32_t* h1s = reinterpret_cast<uint32_t*>(pnbs + 2 * W);
  uint32_t* h2s = h1s + 2 * W;
  int* lasts = reinterpret_cast<int*>(h2s + 2 * W);
  float* tot = reinterpret_cast<float*>(lasts + 2 * W);  // [W] logaddexp(pb, pnb)
  float* spb = tot + W;                                  // [W] stay rows' pb
  float* spnb = spb + W;                                 // [W] stay rows' pnb
  int* extra = reinterpret_cast<int*>(spnb + W);         // [W] merged extend mass, ordered bits
  int* pidx = extra + W;                                 // [W] the picks
  float* pbest = reinterpret_cast<float*>(pidx + W);
  float* ppnb = pbest + W;

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int len = max(0, min(lens[b], T));
  const size_t row = (size_t)b * W;
  for (int w = lane; w < W; w += 32) {
    pbs[w] = pb0[row + w];
    pnbs[w] = pnb0[row + w];
    h1s[w] = (uint32_t)h10[row + w];
    h2s[w] = (uint32_t)h20[row + w];
    lasts[w] = last0[row + w];
  }
  __syncwarp();
  int* par_out = parents + (size_t)b * T * W;
  int* ext_out = exts + (size_t)b * T * W;
  int cur = 0;

  for (int t = 0; t < len; ++t) {
    const float* P = pbs + cur * W;
    const float* N = pnbs + cur * W;
    const uint32_t* H1 = h1s + cur * W;
    const uint32_t* H2 = h2s + cur * W;
    const int* L = lasts + cur * W;
    const float* lpt = logp + ((size_t)b * T + t) * V;
    const float pblank = lpt[blank];
    if (topv != nullptr) {
      const size_t o = ((size_t)b * T + t) * K;
      for (int k = lane; k < K; k += 32) {
        cv[k] = topv[o + k];
        ci[k] = topi[o + k];
      }
    } else {
      for (int k = lane; k < K; k += 32) {
        cv[k] = lpt[k];
        ci[k] = k;
      }
    }
    __syncwarp();

    // stay rows: the blank path and the repeated-last path
    for (int w = lane; w < W; w += 32) {
      const float tw = lae(P[w], N[w]);
      tot[w] = tw;
      spb[w] = pblank >= floor_ ? tw + pblank : -INFINITY;
      const int lw = L[w];
      float p_last = -INFINITY;
      bool lin = false;
      for (int k = 0; k < K; ++k) {
        if (ci[k] == lw) {
          p_last = cv[k];
          lin = lin || cv[k] >= floor_;
        }
      }
      spnb[w] = (lin && lw >= 0) ? N[w] + p_last : -INFINITY;
      extra[w] = ordered(-INFINITY);
    }
    __syncwarp();

    // extend rows, each merged into the stay row that holds the same prefix
    for (int e = lane; e < W * K; e += 32) {
      const int p = e / K;
      const int k = e - p * K;
      const float v = cv[k];
      const int tok = ci[k];
      const bool ok = v >= floor_ && tok != blank;
      const float base = tok == L[p] ? P[p] : tot[p];
      const float ext = ok ? base + v : -INFINITY;
      const uint32_t vv = (uint32_t)(tok + 2);
      const uint32_t e1 = H1[p] * M1 + vv;
      const uint32_t e2 = H2[p] * M2 + vv;
      bool absorbed = false;
      for (int q = 0; q < W; ++q) {
        if (e1 == H1[q] && e2 == H2[q]) {
          absorbed = true;
          atomicMax(&extra[q], ordered(ext));
        }
      }
      cand[W + e] = absorbed ? -INFINITY : ext;
    }
    __syncwarp();
    for (int w = lane; w < W; w += 32) {
      const float sp = lae(spnb[w], unordered(extra[w]));
      spnb[w] = sp;
      cand[w] = lae(spb[w], sp);
    }
    __syncwarp();

    // top-W: W rounds of a warp arg-max; the pick is killed to -inf
    float bv;
    int bi;
    lane_best(cand, C, lane, bv, bi);
    for (int j = 0; j < W; ++j) {
      float v = bv;
      int i = bi;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(FULL, v, off);
        const int oi = __shfl_xor_sync(FULL, i, off);
        if (better(ov, oi, v, i)) {
          v = ov;
          i = oi;
        }
      }
      const float pn = i < W ? spnb[i] : cand[i];
      if (lane == 0) {
        pidx[j] = i;
        pbest[j] = v;
        ppnb[j] = pn;
      }
      __syncwarp();
      if ((i & 31) == lane) {
        cand[i] = -INFINITY;
        lane_best(cand, C, lane, bv, bi);
      }
      __syncwarp();
    }

    // commit, or keep the state when every candidate is -inf
    const bool valid = isfinite(pbest[0]);
    const int nxt = cur ^ 1;
    for (int j = lane; j < W; j += 32) {
      int par = j, ext = -1;
      if (valid) {
        const int i = pidx[j];
        const bool dead = !isfinite(pbest[j]);
        const bool stay = i < W;
        int tok = -1;
        if (stay) {
          par = i;
        } else {
          const int e = i - W;
          par = e / K;
          tok = ci[e - par * K];
        }
        ext = tok;
        const uint32_t vv = (uint32_t)(tok + 2);
        pbs[nxt * W + j] = (dead || !stay) ? -INFINITY : spb[par];
        pnbs[nxt * W + j] = dead ? -INFINITY : ppnb[j];
        h1s[nxt * W + j] = dead ? DEAD_H1 : (stay ? H1[par] : H1[par] * M1 + vv);
        h2s[nxt * W + j] = dead ? (uint32_t)j : (stay ? H2[par] : H2[par] * M2 + vv);
        lasts[nxt * W + j] = dead ? -1 : (stay ? L[par] : tok);
      } else {
        pbs[nxt * W + j] = P[j];
        pnbs[nxt * W + j] = N[j];
        h1s[nxt * W + j] = H1[j];
        h2s[nxt * W + j] = H2[j];
        lasts[nxt * W + j] = L[j];
      }
      par_out[(size_t)t * W + j] = par;
      ext_out[(size_t)t * W + j] = ext;
    }
    __syncwarp();
    cur = nxt;
  }

  // frames past the length: identity pointers, no emission
  for (size_t o = (size_t)len * W + lane; o < (size_t)T * W; o += 32) {
    par_out[o] = (int)(o % W);
    ext_out[o] = -1;
  }
  for (int w = lane; w < W; w += 32) {
    const float p = pbs[cur * W + w], n = pnbs[cur * W + w];
    pb_out[row + w] = p;
    pnb_out[row + w] = n;
    h1_out[row + w] = (int)h1s[cur * W + w];
    h2_out[row + w] = (int)h2s[cur * W + w];
    last_out[row + w] = lasts[cur * W + w];
    total_out[row + w] = lae(p, n);
  }
}

__global__ void __launch_bounds__(BACKTRACE_THREADS) beam_backtrace_kernel(
    const int* __restrict__ parents, const int* __restrict__ exts, const int* __restrict__ slots0,
    int* __restrict__ toks, int* __restrict__ origin, int T, int W, int n_out, int chunk) {
  extern __shared__ int sh[];  // [chunk][W] parents, then [chunk][W] exts
  int* sp = sh;
  int* se = sh + (size_t)chunk * W;
  const int b = blockIdx.x;
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = n < n_out;
  const size_t g = (size_t)b * n_out + n;
  int slot = live ? slots0[g] : 0;
  const int* P = parents + (size_t)b * T * W;
  const int* E = exts + (size_t)b * T * W;
  int* out = toks + g * T;
  for (int hi = T; hi > 0; hi -= chunk) {
    const int lo = max(0, hi - chunk);
    const int count = (hi - lo) * W;
    __syncthreads();  // the previous chunk's walk is done
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      sp[i] = P[(size_t)lo * W + i];
      se[i] = E[(size_t)lo * W + i];
    }
    __syncthreads();
    if (live) {
      for (int t = hi - 1; t >= lo; --t) {
        if (slot >= 0 && slot < W) {
          const int o = (t - lo) * W + slot;
          out[t] = se[o];
          slot = sp[o];
        } else {  // as the TPU kernel's gather: no emission, slot 0
          out[t] = -1;
          slot = 0;
        }
      }
    }
  }
  if (live) origin[g] = slot;
}

}  // namespace

// logp: (B, T, V) float32 log-probs; topv/topi: (B, T, K) float32/int32 candidates, or both
// null for K == V (ids 0..V-1); lens: (B,) int32; floor_: the prune floor; pb0, pnb0 (B, W)
// float32, h10, h20, last0 (B, W) int32: the state going in (hashes as uint32 bits);
// parents, exts: (B, T, W) int32 out; total, pb, pnb (B, W) float32 and h1, h2, last
// (B, W) int32 out: the final state. Returns cudaGetLastError().
extern "C" int thunder_beam_scan(const float* logp, const float* topv, const int* topi, const int* lens, float floor_,
                                 const float* pb0, const float* pnb0, const int* h10, const int* h20,
                                 const int* last0, int* parents, int* exts, float* total, float* pb, float* pnb,
                                 int* h1, int* h2, int* last, int B, int T, int V, int K, int W, int blank,
                                 void* stream) {
  if (B < 1 || T < 0 || V < 1 || K < 1 || K > V || W < 1 || blank < 0 || blank >= V) return (int)cudaErrorInvalidValue;
  if ((topv == nullptr) != (topi == nullptr) || (topv == nullptr && K != V)) return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem_bytes(W, K);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 49152) {
    const cudaError_t err =
        cudaFuncSetAttribute(beam_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  beam_scan_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      logp, topv, topi, lens, floor_, pb0, pnb0, h10, h20, last0, parents, exts, total, pb, pnb, h1, h2, last, T, V,
      K, W, blank);
  return (int)cudaGetLastError();
}

// parents, exts: (B, T, W) int32; slots0: (B, n_out) int32 start slots; toks: (B, n_out, T)
// int32 out (-1 where the path emitted nothing); origin: (B, n_out) int32 out, each path's
// slot in the window's initial state. Returns cudaGetLastError().
extern "C" int thunder_beam_backtrace(const int* parents, const int* exts, const int* slots0, int* toks, int* origin,
                                      int B, int T, int W, int n_out, void* stream) {
  if (B < 1 || T < 0 || W < 1 || n_out < 1) return (int)cudaErrorInvalidValue;
  const int chunk = (int)(BACKTRACE_SMEM / (2 * sizeof(int) * (size_t)W));
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int frames = T < chunk ? (T > 0 ? T : 1) : chunk;
  const size_t smem = 2 * sizeof(int) * (size_t)frames * W;
  const dim3 grid(B, (n_out + BACKTRACE_THREADS - 1) / BACKTRACE_THREADS);
  beam_backtrace_kernel<<<grid, BACKTRACE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      parents, exts, slots0, toks, origin, T, W, n_out, frames);
  return (int)cudaGetLastError();
}
