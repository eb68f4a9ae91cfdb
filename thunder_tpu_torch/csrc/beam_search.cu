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
// the scan reads B*T*(K+1)*4 bytes and writes 2*B*T*W*4, about 12 MB, under 4 us at
// 3.35 TB/s, and B <= 132 rows give each row one SM: the time is T times the latency
// of one frame through its stages. Cycles a frame at that shape, by stage (thread 0 of each
// row, the mean over rows, kernels/beam_cycles.py; NVIDIA H100 80GB HBM3, 700 W; a barrier's
// wait falls in the stage after it):
//                      one warp a row (before)   this design
//   candidate load                596                  284
//   extend + merge             24,345                1,208
//   stay rows                   1,666                1,209
//   top-W                      14,571                3,647 (sort 900, select 2,747)
//   commit                        629                  648
//   a frame                    41,807 (21.1 us)      6,996 (3.8 us)
// The top-W's tree of merges is now the largest stage, then the stay rows' two logaddexps
// and the extend rows, each a chain of shared-memory loads and shuffles.
//
// Design: one block per row; a thread per candidate (C = W + W*K in runs of 32, at most
// 512 threads for W <= 32 and 1024 above, a thread taking every blockDim-th candidate past
// that). The W-beam state (pb, pnb, their logaddexp, h1, h2, last) is double-buffered in
// shared memory across frames. A frame:
//   1. extend + merge: a thread per extend row (parent p, slot k) computes its value and
//      hashes, compares its h1 with the W stay rows' (broadcast loads with no store between
//      them, so they pipeline) and, only where an h1 matches, both hashes: a match absorbs
//      the row, its mass taken by an integer atomicMax on order-preserving float bits
//      (exact, order-free). The thread whose token is the parent's last token also writes
//      the stay row's repeated-last value: the token -> slot lookup is done by the threads
//      that hold the slots, with no loop over K.
//   2. stay rows and sorts: warp 0's first W lanes finish the stay rows (the blank path, the
//      merged mass); every warp sorts its runs of 32 candidates in registers by a bitonic
//      network of shuffles, as 64-bit keys (the value's bits made monotone above the
//      index's complement: value descending, index ascending is one unsigned compare).
//   3. top-W: for W <= 32 a warp keeps the best 32 of its runs, and the warps' lists merge
//      in a tree: at distance d, warp w + d hands its best W to warp w through shared memory
//      under a named barrier of the two warps (one id for each pair of each level, 15 at
//      most); warp 0 ends with the picks. For W > 32 every run keeps its 32, sorted in shared
//      memory (a key's slot swizzled by its run against bank conflicts), and a candidate's
//      rank is the sum over runs of the run's keys above its own, by binary searches that G
//      lanes share. The order is total, so ranks are exact. A pick that is -inf is taken as
//      index 0, which is what the TPU kernel's kill-to--inf rounds give.
//   4. commit: the first W threads write the new state and the pointers; the new
//      logaddexp(pb, pnb) is the pick's own value. The next frame's K candidates and blank
//      log-prob, requested by cp.async at the top of this frame into the other half of a
//      double buffer, are waited for here, so no device-memory latency is on the chain.
// Barriers a frame: three __syncthreads (after the extend rows, the picks and the commit) and
// one named barrier for each warp that sends in the tree for W <= 32; four __syncthreads
// above. A row stops at its length and fills the rest of its pointers with identity. The
// TPU's time-major (T, K, B) layout, the batch on the 128 lanes and the TB-frame padding
// were Mosaic's and are not carried over.
//
// Past one block (the chunked plan): where the keys of all W + W*K candidates do not fit beside
// the state (at W = 16, K above 1,605), beam_scan_chunked_kernel walks a frame's candidates in
// chunks of runs: the extend rows first, then the stay rows, whose merged mass is complete only
// once every extend row has run. A chunk computes its rows as stage 1 does (the atomicMax into
// `extra` and the repeated-last value in `slast` persist across chunks, until the commit), sorts its
// runs, and merges its best W into a running top-W kept in `picks`: for W <= 32 the warps' tree as
// above, then warp 0 merges the tree's list with the picks; for W > 32 the picks are copied as
// sorted runs beside the chunk's and all are ranked together, a candidate below the W-th pick
// skipped (it has W keys above it), at most 128 runs a chunk so that the ranking stays near the
// one-block cost. A run with no key above the W-th running pick (or, for W <= 32, above the W-th
// of its warp's list) is not sorted: it cannot reach the top W. The key order is total, so the
// chunked top-W is the one-block top-W, in the same order. The chunks read their candidates from
// device memory (L2), not from a double buffer of the whole frame. The one-block kernel is left as
// it is, for the shapes it takes. At 16 x 188 x 3,000 (W = 16) a frame takes 67 us (NVIDIA H100
// 80GB HBM3, 700 W; kernels/compare_builds.py --parts beam): 48,000 extend rows on 16 warps, the
// block capped at 512 threads by the tree's 15 named barriers.
//
// Past the shared memory of one block (the workspace plan): where the state (18 W words) and the
// picks' runs do not fit beside one chunk (W above 2,901), the same chunked kernel keeps every array
// it held in shared memory (the picks' runs and the chunk's keys, the picks, the double-buffered
// state and the stay rows' four vectors) in a row of a device-memory workspace that the wrapper
// allocates, one row a block; a template argument picks where they live, so the frame loop is the
// chunked plan's and the plans up to W = 2,901 compile to the kernels they were. The merge then
// compares each of W*K extend rows with the W stay rows' hashes through L1, which is slow and exact;
// no caller asks for such a width.
//
// The backtrace: for each path, toks[t] = exts[t][slot], then slot = parents[t][slot], for t = T-1 ... 0;
// origin = the slot after frame 0. A slot outside [0, W) emits -1 and goes to slot 0 (the TPU kernel's
// gather). What bounds it on this card: a chain of T dependent loads a path, not bytes. At the served
// shape (B = 64, T = 751, W = 16, one path a row) the walk reads one 32-byte sector of each pointer field a
// frame, 3.1 MB (0.9 us at 3.35 TB/s), and staging both fields whole pulls 6.15 MB (1.8 us); one step of the walk alone takes 24.9 ns on this card (thunder_beam_walk_chain), so 751 steps 18.7 us.
// An earlier design ran one block of 128 threads a row and one thread a path: it staged 48 KB of frames
// at a time by a scalar loop between two block barriers, then one thread walked the 751 loads while 127
// idled. Device time a call with the pointers in device memory (kernels/compare_builds.py --parts beam,
// the earlier design in the same call; NVIDIA H100 80GB HBM3, 700 W): 0.0908-0.0912 ms before, 0.0085-0.0086
// now; a predict_long window (1 x 1,001, every slot's path) 0.119 before, 0.0088 now. This design:
//   - staging by bulk copies: one thread issues cp.async.bulk copies of a span's parents, then of its exts,
//     each completing on its own mbarrier, so the walk waits only for the parents. A span is as many frames
//     as fit one block's shared memory (all 751 at W = 16), newest first, the entry slots carried from span
//     to span. Frames are 4W bytes: where a span does not start or end on 16 bytes, the bulk copy takes the
//     aligned middle and threads load the at most six words around it; the caller's tensors are not padded;
//   - the walk composed over segments where that shortens the chain (backtrace_plan: W <= 63, n_out at most
//     two a thread, 2 ceil(n / 32) + 31 < n for a span of n frames): segment k of 32 composes its frames' maps
//     into a table of W + 1 slots (slot W: "outside"), the paths' entry slots are handed down from the newest
//     segment to the oldest by one table lookup each, and each segment is re-walked from its entry slots,
//     emitting. The chain falls from n steps to 2 ceil(n / 32) + 31: 79 at T = 751 (2.0 us), from 751. A segment's
//     threads are consecutive (min(W + 1, 32) of them), so a warp reads the words of two or three frames at a
//     time, not 32 frames a segment apart, whose words share banks. Elsewhere a thread a path walks the span
//     (thunder_beam_backtrace_serial takes this route at any W <= 6,144: 0.0258 ms at the served shape, 0.037 a
//     window, against the composed walk's 0.0087 and 0.0089 in the same call; 0.169 at 264 x 751 x 300, one path
//     a row, against the earlier design's 0.845);
//   - tokens through shared memory (rows of odd stride) and out as contiguous runs along T, a warp a path.
// Past W = 6,144 (WALK_MAX_W), beam_backtrace_walk_kernel walks with its loads from device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr uint32_t M1 = 1000003u;
constexpr uint32_t M2 = 2654435761u;
constexpr uint32_t DEAD_H1 = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr size_t MAX_SMEM = 232448;  // what a block may opt into on sm_90
constexpr int MAX_THREADS = 1024;
constexpr int MAX_TREE_THREADS = 512;  // W <= 32: at most 16 lists, 15 pair barriers (ids 1-15)
constexpr int MAX_RANK_CHUNK_RUNS = 128;  // the chunked plan, W > 32: runs a chunk ranks beside the picks' runs
constexpr int BACKTRACE_THREADS = 128;  // the walk from device memory: paths a block
constexpr int WALK_MAX_W = 6144;        // past it the backtrace walks from device memory
constexpr int SERIAL_PATHS = 128;       // the serial walk on staged spans: paths a block
constexpr int SEGMENTS = 32;            // the composed walk: segments of a span, entry slots handed down 31 times
constexpr int COMPOSE_MAX_W = 63;       // the composed walk: at most two table entries a thread
enum { BACKTRACE_WALK = 0, BACKTRACE_SERIAL = 1, BACKTRACE_COMPOSED = 2 };

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

// (value descending, index ascending) as one unsigned key, larger is better: the float's bits made
// monotone above the complement of the index. Every candidate's key is above 0, which pads a run.
__device__ __forceinline__ uint64_t sort_key(float v, int i) {
  const uint32_t u = __float_as_uint(v);
  return ((uint64_t)(u & 0x80000000u ? ~u : u | 0x80000000u) << 32) | (uint32_t)(0xFFFFFFFFu - (uint32_t)i);
}

__device__ __forceinline__ float key_value(uint64_t key) {
  const uint32_t u = (uint32_t)(key >> 32);
  return __uint_as_float(u & 0x80000000u ? u & 0x7FFFFFFFu : ~u);
}

__device__ __forceinline__ int key_index(uint64_t key) { return (int)(0xFFFFFFFFu - (uint32_t)key); }

// a sorted run's key j sits at j ^ (r & 15) of run r's 32 slots: runs searched side by side at the
// same j then fall on different banks
__device__ __forceinline__ int slot(int r, int j) { return r * 32 + (j ^ (r & 15)); }

// how many of sorted run r's 32 keys are above `key`: binary lifting
__device__ __forceinline__ int count_above(const uint64_t* keys, int r, uint64_t key) {
  int n = 0;
#pragma unroll
  for (int step = 32; step > 0; step >>= 1) {
    const int j = n + step - 1;
    if (j < 32 && keys[slot(r, j)] > key) n += step;  // once n is 32, j leaves the run
  }
  return n;
}

// a warp's 32 keys sorted descending across the lanes (a bitonic network of shuffles)
__device__ __forceinline__ uint64_t sort32(uint64_t key, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const uint64_t other = __shfl_xor_sync(FULL, key, j);
      if ((other > key) == (((lane & j) == 0) == ((lane & k) == 0))) key = other;
    }
  }
  return key;
}

// the best 32 of two descending lists, descending: a against b reversed is bitonic, then a half merge
__device__ __forceinline__ uint64_t merge32(uint64_t a, uint64_t b, int lane) {
  const uint64_t rb = __shfl_sync(FULL, b, 31 - lane);
  uint64_t key = a > rb ? a : rb;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const uint64_t other = __shfl_xor_sync(FULL, key, j);
    if ((other > key) == ((lane & j) == 0)) key = other;
  }
  return key;
}

__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory"); }
__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory"); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Threads and shared memory of one scan block (kernels/beam.py::scan_plan computes the same):
// C = W + W*K candidates in R = ceil(C/32) runs of 32; a thread per candidate, up to 512 for W <= 32
// and 1024 above; 4-byte words: the candidates' 8-byte keys 2 x 32R, the picks' keys 2W, the state
// 2 x 6W, the stay rows' pb, pnb, merged mass and repeated-last value 4W, the frame's candidates
// double-buffered 2 x 2K and the blank's log-prob 2. Where that is over MAX_SMEM, the chunked plan:
// the state 18W, the picks' runs 64 ceil(W/32) for W > 32, and a chunk's keys 64 a run, as many runs
// as fit (at most MAX_RANK_CHUNK_RUNS for W > 32, and no more than the extend rows take). Where one
// run does not fit beside the state, the workspace plan: the same words, MAX_RANK_CHUNK_RUNS runs a
// chunk (no more than the extend rows take), in a row of device memory a block and no shared memory.
struct ScanPlan {
  int threads;
  size_t smem;
  int chunk_runs;    // 0: the one-block plan
  size_t workspace;  // bytes of device memory a row (the workspace plan), else 0
};

__host__ __device__ inline int pick_runs(int W) { return W <= 32 ? 0 : (W + 31) / 32; }

ScanPlan scan_plan(int W, int K) {
  const long long runs = ((long long)W + (long long)W * K + 31) / 32;
  const long long cap = W <= 32 ? MAX_TREE_THREADS : MAX_THREADS;
  const size_t one_block = 4 * (size_t)(18LL * W + 64 * runs + 4LL * K + 2);
  if (one_block <= MAX_SMEM) return {(int)(runs * 32 < cap ? runs * 32 : cap), one_block, 0};
  const long long fixed = 18LL * W + 64LL * pick_runs(W);
  const bool in_smem = 4 * (size_t)(fixed + 64) <= MAX_SMEM;
  long long chunk = in_smem ? ((long long)(MAX_SMEM / 4) - fixed) / 64 : MAX_RANK_CHUNK_RUNS;
  if (W > 32 && chunk > MAX_RANK_CHUNK_RUNS) chunk = MAX_RANK_CHUNK_RUNS;
  const long long extend_runs = ((long long)W * K + 31) / 32;
  if (chunk > extend_runs) chunk = extend_runs;
  if (chunk < 1) chunk = 1;
  const long long threads = 32 * (pick_runs(W) + chunk) < cap ? 32 * (pick_runs(W) + chunk) : cap;
  const size_t bytes = 4 * (size_t)(fixed + 64 * chunk);
  return {(int)threads, in_smem ? bytes : 0, (int)chunk, in_smem ? 0 : bytes};
}

__global__ void __launch_bounds__(MAX_THREADS, 1) beam_scan_kernel(
    const float* __restrict__ logp, const float* __restrict__ topv, const int* __restrict__ topi,
    const int* __restrict__ lens, float floor_, const float* __restrict__ pb0, const float* __restrict__ pnb0,
    const int* __restrict__ h10, const int* __restrict__ h20, const int* __restrict__ last0,
    int* __restrict__ parents, int* __restrict__ exts, float* __restrict__ total_out, float* __restrict__ pb_out,
    float* __restrict__ pnb_out, int* __restrict__ h1_out, int* __restrict__ h2_out, int* __restrict__ last_out,
    int T, int V, int K, int W, int blank) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = W + W * K;
  const int R = (C + 31) >> 5;
  int G = 1;  // W > 32: lanes that rank one candidate, each over every G-th run, four runs at a time
  while (G < 32 && 4 * G < R) G <<= 1;
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);  // [32R] candidate keys, then sorted runs
  uint64_t* picks = keys + 32 * R;                     // [W] the picks, best first
  float* Ps = reinterpret_cast<float*>(picks + W);     // [2][W] each: the state, double-buffered
  float* Ns = Ps + 2 * W;
  float* Ts = Ns + 2 * W;  // logaddexp(pb, pnb)
  uint32_t* H1s = reinterpret_cast<uint32_t*>(Ts + 2 * W);
  uint32_t* H2s = H1s + 2 * W;
  int* Ls = reinterpret_cast<int*>(H2s + 2 * W);
  float* spb = reinterpret_cast<float*>(Ls + 2 * W);  // [W] stay rows' pb
  float* spnb = spb + W;                               // [W] stay rows' pnb, merged
  int* extra = reinterpret_cast<int*>(spnb + W);       // [W] merged extend mass, ordered bits
  float* slast = reinterpret_cast<float*>(extra + W);  // [W] pnb + p(last), or -inf
  float* cv = slast + W;                               // [2][K] the frame's candidate log-probs
  int* ci = reinterpret_cast<int*>(cv + 2 * K);        // [2][K] and their token ids
  float* pbl = reinterpret_cast<float*>(ci + 2 * K);   // [2] the blank's log-prob

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int len = max(0, min(lens[b], T));
  const size_t row = (size_t)b * W;
  const float* lp_row = logp + (size_t)b * T * V;
  const float* tv_row = topv == nullptr ? nullptr : topv + (size_t)b * T * K;
  const int* ti_row = topi == nullptr ? nullptr : topi + (size_t)b * T * K;
  // frame t's candidates into half s of the double buffer, asynchronously
  auto fetch = [&](int t, int s) {
    if (tv_row != nullptr) {
      for (int k = tid; k < K; k += nt) {
        cp_async4(cv + s * K + k, tv_row + (size_t)t * K + k);
        cp_async4(ci + s * K + k, ti_row + (size_t)t * K + k);
      }
    } else {
      for (int k = tid; k < K; k += nt) cp_async4(cv + s * K + k, lp_row + (size_t)t * V + k);
    }
    if (tid == nt - 1) cp_async4(pbl + s, lp_row + (size_t)t * V + blank);
  };

  for (int w = tid; w < W; w += nt) {
    const float p = pb0[row + w], n = pnb0[row + w];
    Ps[w] = p;
    Ns[w] = n;
    Ts[w] = lae(p, n);
    H1s[w] = (uint32_t)h10[row + w];
    H2s[w] = (uint32_t)h20[row + w];
    Ls[w] = last0[row + w];
    extra[w] = ordered(-INFINITY);
    slast[w] = -INFINITY;
  }
  if (topi == nullptr) {
    for (int k = tid; k < 2 * K; k += nt) ci[k] = k < K ? k : k - K;
  }
  if (len > 0) fetch(0, 0);
  cp_async_wait_all();
  __syncthreads();
  int* par_out = parents + (size_t)b * T * W;
  int* ext_out = exts + (size_t)b * T * W;
  int cur = 0;
  const int p0 = tid / K, k0 = tid - p0 * K;  // this thread's first extend row, and the stride in rows
  const int dp = nt / K, dk = nt - dp * K;

  for (int t = 0; t < len; ++t) {
    const int s = t & 1;
    if (t + 1 < len) fetch(t + 1, s ^ 1);
    const float* P = Ps + cur * W;
    const float* N = Ns + cur * W;
    const float* TT = Ts + cur * W;
    const uint32_t* H1 = H1s + cur * W;
    const uint32_t* H2 = H2s + cur * W;
    const int* L = Ls + cur * W;
    const float* fv = cv + s * K;
    const int* fi = ci + s * K;

    // stage: extend + merge, a thread per extend row
    for (int e = tid, p = p0, k = k0; e < W * K; e += nt) {
      const float v = fv[k];
      const int tok = fi[k];
      const int lp = L[p];
      const bool kept = v >= floor_;
      const float ext = kept && tok != blank ? (tok == lp ? P[p] : TT[p]) + v : -INFINITY;
      if (tok == lp && kept) slast[p] = N[p] + v;  // the stay row's repeated-last path (ids are unique a frame)
      const uint32_t vv = (uint32_t)(tok + 2);
      const uint32_t e1 = H1[p] * M1 + vv;
      const uint32_t e2 = H2[p] * M2 + vv;
      bool absorbed = false, near = false;
#pragma unroll 8
      for (int q = 0; q < W; ++q) near |= e1 == H1[q];  // loads only: pipelined
      if (near) {
        for (int q = 0; q < W; ++q) {
          if (e1 == H1[q] && e2 == H2[q]) {
            absorbed = true;
            atomicMax(&extra[q], ordered(ext));
          }
        }
      }
      keys[W + e] = sort_key(absorbed ? -INFINITY : ext, W + e);
      p += dp;
      k += dk;
      if (k >= K) {
        k -= K;
        ++p;
      }
    }
    __syncthreads();

    // stage: stay rows, then each warp sorts its runs of 32 candidates, best first
    const float pblank = pbl[s];
    uint64_t best = 0;  // W <= 32: the warp's best 32, descending across the lanes
    for (int r = warp; r < R; r += nwarps) {
      const int c = r * 32 + lane;
      uint64_t key = 0;
      if (c < W) {
        const float sp = lae(slast[c], unordered(extra[c]));
        const float sb = pblank >= floor_ ? TT[c] + pblank : -INFINITY;
        spb[c] = sb;
        spnb[c] = sp;
        key = sort_key(lae(sb, sp), c);
      } else if (c < C) {
        key = keys[c];
      }
      // stage: top-W sort
      key = sort32(key, lane);
      if (W <= 32) {
        best = r == warp ? key : merge32(best, key, lane);
      } else {
        __syncwarp();  // every lane has read its candidate before any slot of the run is written
        keys[slot(r, lane)] = key;
      }
    }
    // stage: top-W select
    if (W <= 32) {
      // a tree of pairwise merges over the warps' lists: at distance d, warp w (w % 2d == d) hands its best W
      // to warp w - d through shared memory (its own run's slots, which only it read) under a named barrier of
      // the two warps, one id for each pair of each level (15 at most); warp 0 ends with the picks
      const int lists = min(R, nwarps);
      int id = 1;
      for (int d = 1; d < lists && warp < lists; d <<= 1) {
        const int pair = id + warp / (2 * d);
        if (warp % (2 * d) == d) {
          if (lane < W) keys[warp * 32 + lane] = best;
          bar_arrive(pair);
          break;
        }
        if (warp + d < lists) {
          bar_sync(pair);
          best = merge32(best, lane < W ? keys[(warp + d) * 32 + lane] : 0, lane);
        }
        id += (lists + 2 * d - 1) / (2 * d);
      }
      if (warp == 0 && lane < W) picks[lane] = best;
    } else {
      // W > 32: each of the R runs keeps all 32; a candidate's rank is the sum over runs of the run's keys above
      // its own. G lanes share a candidate, each searching every G-th run, four at a time, and add up by shuffles
      __syncthreads();
      const int S = R * 32;
      const int per_warp = 32 / G;
      const int g = lane & (G - 1);
      for (int s0 = warp * per_warp; s0 < S; s0 += nwarps * per_warp) {
        const int sv = s0 + lane / G;
        uint64_t key = 0;
        if (sv < S) {
          const int pos = sv / R;
          key = keys[slot(sv - pos * R, pos)];
        }
        int n = 0;
        for (int r = g; r < R; r += 4 * G) {
          const int n0 = count_above(keys, r, key);
          const int n1 = r + G < R ? count_above(keys, r + G, key) : 0;
          const int n2 = r + 2 * G < R ? count_above(keys, r + 2 * G, key) : 0;
          const int n3 = r + 3 * G < R ? count_above(keys, r + 3 * G, key) : 0;
          n += n0 + n1 + n2 + n3;
        }
        for (int o = 1; o < G; o <<= 1) n += __shfl_xor_sync(FULL, n, o);
        if (g == 0 && key != 0 && n < W) picks[n] = key;
      }
    }
    __syncthreads();

    // stage: commit, or keep the state when every candidate is -inf
    const bool valid = isfinite(key_value(picks[0]));
    const int nxt = cur ^ 1;
    for (int j = tid; j < W; j += nt) {
      int par = j, ext = -1;
      float np = P[j], nn = N[j], ntot = TT[j];
      uint32_t n1 = H1[j], n2 = H2[j];
      int nl = L[j];
      if (valid) {
        const float pv = key_value(picks[j]);
        const bool dead = !isfinite(pv);
        const int i = dead ? 0 : key_index(picks[j]);
        const bool stay = i < W;
        int tok = -1;
        if (stay) {
          par = i;
        } else {
          const int e = i - W;
          par = e / K;
          tok = fi[e - par * K];
        }
        ext = tok;
        const uint32_t vv = (uint32_t)(tok + 2);
        np = (dead || !stay) ? -INFINITY : spb[par];
        nn = dead ? -INFINITY : (stay ? spnb[i] : pv);
        n1 = dead ? DEAD_H1 : (stay ? H1[par] : H1[par] * M1 + vv);
        n2 = dead ? (uint32_t)j : (stay ? H2[par] : H2[par] * M2 + vv);
        nl = dead ? -1 : (stay ? L[par] : tok);
        ntot = dead ? -INFINITY : pv;  // lae(np, nn): the pick's own value (lae(-inf, x) is x)
      }
      Ps[nxt * W + j] = np;
      Ns[nxt * W + j] = nn;
      Ts[nxt * W + j] = ntot;
      H1s[nxt * W + j] = n1;
      H2s[nxt * W + j] = n2;
      Ls[nxt * W + j] = nl;
      extra[j] = ordered(-INFINITY);
      slast[j] = -INFINITY;
      par_out[(size_t)t * W + j] = par;
      ext_out[(size_t)t * W + j] = ext;
    }
    cp_async_wait_all();  // the next frame's candidates
    __syncthreads();
    cur = nxt;
  }

  // frames past the length: identity pointers, no emission
  for (size_t o = (size_t)len * W + tid; o < (size_t)T * W; o += nt) {
    par_out[o] = (int)(o % W);
    ext_out[o] = -1;
  }
  for (int w = tid; w < W; w += nt) {
    pb_out[row + w] = Ps[cur * W + w];
    pnb_out[row + w] = Ns[cur * W + w];
    h1_out[row + w] = (int)H1s[cur * W + w];
    h2_out[row + w] = (int)H2s[cur * W + w];
    last_out[row + w] = Ls[cur * W + w];
    total_out[row + w] = Ts[cur * W + w];
  }
}

// The chunked plan: beam_scan_kernel's frame, over chunks of chunk_runs runs (see the note at the top). IN_SMEM:
// its arrays in shared memory; else in the block's row of `workspace`, ws_row bytes a row (the workspace plan).
template <bool IN_SMEM>
__global__ void __launch_bounds__(MAX_THREADS, 1) beam_scan_chunked_kernel(
    const float* __restrict__ logp, const float* __restrict__ topv, const int* __restrict__ topi,
    const int* __restrict__ lens, float floor_, const float* __restrict__ pb0, const float* __restrict__ pnb0,
    const int* __restrict__ h10, const int* __restrict__ h20, const int* __restrict__ last0,
    int* __restrict__ parents, int* __restrict__ exts, float* __restrict__ total_out, float* __restrict__ pb_out,
    float* __restrict__ pnb_out, int* __restrict__ h1_out, int* __restrict__ h2_out, int* __restrict__ last_out,
    int T, int V, int K, int W, int blank, int chunk_runs, unsigned char* __restrict__ workspace, size_t ws_row) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int PR = pick_runs(W);  // W > 32: the running picks, ranked as sorted runs beside the chunk's
  const int CH = 32 * chunk_runs;
  unsigned char* base = IN_SMEM ? smem : workspace + (size_t)blockIdx.x * ws_row;
  uint64_t* keys = reinterpret_cast<uint64_t*>(base);  // [32 PR] the picks' runs, then [CH] the chunk's keys
  uint64_t* ck = keys + 32 * PR;
  uint64_t* picks = ck + CH;                         // [W] the running picks, best first (0: none yet)
  float* Ps = reinterpret_cast<float*>(picks + W);  // [2][W] each: the state, double-buffered
  float* Ns = Ps + 2 * W;
  float* Ts = Ns + 2 * W;
  uint32_t* H1s = reinterpret_cast<uint32_t*>(Ts + 2 * W);
  uint32_t* H2s = H1s + 2 * W;
  int* Ls = reinterpret_cast<int*>(H2s + 2 * W);
  float* spb = reinterpret_cast<float*>(Ls + 2 * W);
  float* spnb = spb + W;
  int* extra = reinterpret_cast<int*>(spnb + W);
  float* slast = reinterpret_cast<float*>(extra + W);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int len = max(0, min(lens[b], T));
  const size_t row = (size_t)b * W;
  const float* lp_row = logp + (size_t)b * T * V;
  const float* tv_row = topv == nullptr ? nullptr : topv + (size_t)b * T * K;
  const int* ti_row = topi == nullptr ? nullptr : topi + (size_t)b * T * K;
  const int E = W * K;
  const int n_ext = (E + CH - 1) / CH;
  const int n_chunks = n_ext + (W + CH - 1) / CH;
  const int dp = nt / K, dk = nt - dp * K;

  for (int w = tid; w < W; w += nt) {
    const float p = pb0[row + w], n = pnb0[row + w];
    Ps[w] = p;
    Ns[w] = n;
    Ts[w] = lae(p, n);
    H1s[w] = (uint32_t)h10[row + w];
    H2s[w] = (uint32_t)h20[row + w];
    Ls[w] = last0[row + w];
    extra[w] = ordered(-INFINITY);
    slast[w] = -INFINITY;
    picks[w] = 0;
  }
  __syncthreads();
  int* par_out = parents + (size_t)b * T * W;
  int* ext_out = exts + (size_t)b * T * W;
  int cur = 0;

  for (int t = 0; t < len; ++t) {
    const float* P = Ps + cur * W;
    const float* N = Ns + cur * W;
    const float* TT = Ts + cur * W;
    const uint32_t* H1 = H1s + cur * W;
    const uint32_t* H2 = H2s + cur * W;
    const int* L = Ls + cur * W;
    const float* fv = tv_row != nullptr ? tv_row + (size_t)t * K : lp_row + (size_t)t * V;
    const int* fi = ti_row != nullptr ? ti_row + (size_t)t * K : nullptr;

    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const bool stay_rows = chunk >= n_ext;
      const int lo = (stay_rows ? chunk - n_ext : chunk) * CH;
      const int n = min(CH, (stay_rows ? W : E) - lo);
      const int runs = (n + 31) >> 5;
      if (!stay_rows) {
        // stage: extend + merge, a thread per extend row of the chunk (as beam_scan_kernel's)
        const int e0 = lo + tid;
        for (int i = tid, p = e0 / K, k = e0 - (e0 / K) * K; i < n; i += nt) {
          const float v = __ldg(fv + k);
          const int tok = fi != nullptr ? __ldg(fi + k) : k;
          const int lp = L[p];
          const bool kept = v >= floor_;
          const float ext = kept && tok != blank ? (tok == lp ? P[p] : TT[p]) + v : -INFINITY;
          if (tok == lp && kept) slast[p] = N[p] + v;
          const uint32_t vv = (uint32_t)(tok + 2);
          const uint32_t e1 = H1[p] * M1 + vv;
          const uint32_t e2 = H2[p] * M2 + vv;
          bool absorbed = false, near = false;
#pragma unroll 8
          for (int q = 0; q < W; ++q) near |= e1 == H1[q];
          if (near) {
            for (int q = 0; q < W; ++q) {
              if (e1 == H1[q] && e2 == H2[q]) {
                absorbed = true;
                atomicMax(&extra[q], ordered(ext));
              }
            }
          }
          ck[i] = sort_key(absorbed ? -INFINITY : ext, W + lo + i);
          p += dp;
          k += dk;
          if (k >= K) {
            k -= K;
            ++p;
          }
        }
      } else {
        // stage: stay rows, once every extend row has merged into them
        const float pblank = __ldg(lp_row + (size_t)t * V + blank);
        for (int i = tid; i < n; i += nt) {
          const int c = lo + i;
          const float sp = lae(slast[c], unordered(extra[c]));
          const float sb = pblank >= floor_ ? TT[c] + pblank : -INFINITY;
          spb[c] = sb;
          spnb[c] = sp;
          ck[i] = sort_key(lae(sb, sp), c);
        }
      }
      __syncthreads();

      // stage: top-W sort, each warp its runs of the chunk. A run none of whose keys is above the W-th running
      // pick, or above the W-th best of the warp's own list, cannot reach the top W: it is not sorted
      const uint64_t pick_floor = picks[W - 1];
      if (W <= 32) {
        uint64_t best = 0;
        for (int r = warp; r < runs; r += nwarps) {
          const int i = r * 32 + lane;
          const uint64_t key = i < n ? ck[i] : 0;
          const uint64_t own = __shfl_sync(FULL, best, W - 1);
          if (__ballot_sync(FULL, key > pick_floor && key > own) == 0) continue;
          best = merge32(best, sort32(key, lane), lane);
        }
        // stage: top-W select, the tree of beam_scan_kernel over the chunk's lists, then into the picks
        const int lists = min(runs, nwarps);
        int id = 1;
        for (int d = 1; d < lists && warp < lists; d <<= 1) {
          const int pair = id + warp / (2 * d);
          if (warp % (2 * d) == d) {
            if (lane < W) ck[warp * 32 + lane] = best;
            bar_arrive(pair);
            break;
          }
          if (warp + d < lists) {
            bar_sync(pair);
            best = merge32(best, lane < W ? ck[(warp + d) * 32 + lane] : 0, lane);
          }
          id += (lists + 2 * d - 1) / (2 * d);
        }
        if (warp == 0) {
          best = merge32(best, lane < W ? picks[lane] : 0, lane);
          if (lane < W) picks[lane] = best;
        }
      } else {
        for (int r = warp; r < runs; r += nwarps) {
          const int i = r * 32 + lane;
          uint64_t key = i < n ? ck[i] : 0;
          key = __ballot_sync(FULL, key > pick_floor) == 0 ? 0 : sort32(key, lane);  // a run of 0s ranks nothing
          __syncwarp();
          keys[slot(PR + r, lane)] = key;
        }
        // the running picks, sorted already, as runs beside the chunk's
        for (int i = tid; i < 32 * PR; i += nt) keys[slot(i >> 5, i & 31)] = i < W ? picks[i] : 0;
        __syncthreads();
        // stage: top-W select, ranks over the picks' runs and the chunk's; a key below the W-th pick is out
        const int R = PR + runs;
        int G = 1;
        while (G < 32 && 4 * G < R) G <<= 1;
        const uint64_t floor_key = keys[slot((W - 1) >> 5, (W - 1) & 31)];
        const int S = R * 32;
        const int per_warp = 32 / G;
        const int g = lane & (G - 1);
        for (int s0 = warp * per_warp; s0 < S; s0 += nwarps * per_warp) {
          const int sv = s0 + lane / G;
          uint64_t key = 0;
          if (sv < S) {
            const int pos = sv / R;
            key = keys[slot(sv - pos * R, pos)];
          }
          const bool live = key != 0 && key >= floor_key;
          int cnt = 0;
          if (live) {
            for (int r = g; r < R; r += 4 * G) {
              const int n0 = count_above(keys, r, key);
              const int n1 = r + G < R ? count_above(keys, r + G, key) : 0;
              const int n2 = r + 2 * G < R ? count_above(keys, r + 2 * G, key) : 0;
              const int n3 = r + 3 * G < R ? count_above(keys, r + 3 * G, key) : 0;
              cnt += n0 + n1 + n2 + n3;
            }
          }
          for (int o = 1; o < G; o <<= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
          if (g == 0 && live && cnt < W) picks[cnt] = key;
        }
      }
      __syncthreads();
    }

    // stage: commit, or keep the state when every candidate is -inf
    const bool valid = isfinite(key_value(picks[0]));
    const int nxt = cur ^ 1;
    for (int j = tid; j < W; j += nt) {
      int par = j, ext = -1;
      float np = P[j], nn = N[j], ntot = TT[j];
      uint32_t n1 = H1[j], n2 = H2[j];
      int nl = L[j];
      if (valid) {
        const float pv = key_value(picks[j]);
        const bool dead = !isfinite(pv);
        const int i = dead ? 0 : key_index(picks[j]);
        const bool stay = i < W;
        int tok = -1;
        if (stay) {
          par = i;
        } else {
          const int e = i - W;
          par = e / K;
          tok = fi != nullptr ? __ldg(fi + (e - par * K)) : e - par * K;
        }
        ext = tok;
        const uint32_t vv = (uint32_t)(tok + 2);
        np = (dead || !stay) ? -INFINITY : spb[par];
        nn = dead ? -INFINITY : (stay ? spnb[i] : pv);
        n1 = dead ? DEAD_H1 : (stay ? H1[par] : H1[par] * M1 + vv);
        n2 = dead ? (uint32_t)j : (stay ? H2[par] : H2[par] * M2 + vv);
        nl = dead ? -1 : (stay ? L[par] : tok);
        ntot = dead ? -INFINITY : pv;
      }
      Ps[nxt * W + j] = np;
      Ns[nxt * W + j] = nn;
      Ts[nxt * W + j] = ntot;
      H1s[nxt * W + j] = n1;
      H2s[nxt * W + j] = n2;
      Ls[nxt * W + j] = nl;
      extra[j] = ordered(-INFINITY);
      slast[j] = -INFINITY;
      par_out[(size_t)t * W + j] = par;
      ext_out[(size_t)t * W + j] = ext;
    }
    __syncthreads();
    for (int j = tid; j < W; j += nt) picks[j] = 0;  // the next frame's picks start empty
    cur = nxt;
  }

  for (size_t o = (size_t)len * W + tid; o < (size_t)T * W; o += nt) {
    par_out[o] = (int)(o % W);
    ext_out[o] = -1;
  }
  for (int w = tid; w < W; w += nt) {
    pb_out[row + w] = Ps[cur * W + w];
    pnb_out[row + w] = Ns[cur * W + w];
    h1_out[row + w] = (int)H1s[cur * W + w];
    h2_out[row + w] = (int)H2s[cur * W + w];
    last_out[row + w] = Ls[cur * W + w];
    total_out[row + w] = Ts[cur * W + w];
  }
}

// ---- the backtrace

// A slot as the tables and the hand-down hold it: [0, W), or W for "outside [0, W)". A frame maps slot s < W to
// parents[t][s] (made canonical) and W to 0, and emits exts[t][s] for s < W, -1 for W: the TPU kernel's gather.
// The walks carry the same slot as (s, out): see step().
__device__ __forceinline__ int canonical(int slot, int W) { return (unsigned)slot < (unsigned)W ? slot : W; }

// The backtrace's plan for beam width W, n_out paths a row and T frames (kernels/beam.py::backtrace_plan mirrors it).
struct BacktracePlan {
  int route;    // BACKTRACE_WALK, BACKTRACE_SERIAL or BACKTRACE_COMPOSED
  int threads;  // a block's
  int span;     // frames staged at a time (0: the walk from device memory)
  size_t smem;  // dynamic shared bytes of a block
  int blocks_y; // blocks a row: the serial walk takes its paths SERIAL_PATHS to a block
};

__host__ __device__ inline int round4(int words) { return (words + 3) & ~3; }

// the paths a block walks
__host__ __device__ inline int block_paths(int n_out, bool composed) {
  return composed || n_out < SERIAL_PATHS ? n_out : SERIAL_PATHS;
}

// the composed walk's words beside the span: the segments' tables of W + 1 entries, the hand-down's entry slot of
// each segment and path, and the raw slot each path leaves the span with
__host__ __device__ inline int compose_words(int W, int n_out, bool composed) {
  return composed ? round4(SEGMENTS * (W + 1)) + round4(SEGMENTS * n_out) + round4(n_out) : 0;
}

// A block's shared bytes for a span: two mbarriers; the span's parents and exts, each at its source's word offset in
// a 16-byte line (a bulk copy keeps the alignment); the paths' tokens, in rows of odd stride (span | 1) against bank
// conflicts; the composed walk's words.
__host__ __device__ inline size_t backtrace_smem(int W, int n_out, int span, bool composed) {
  const int words = 2 * round4(span * W + 3) + round4(block_paths(n_out, composed) * (span | 1)) +
                    compose_words(W, n_out, composed);
  return 16 + 4 * (size_t)words;
}

// The longest span (at most T frames, at least 1) whose block fits MAX_SMEM: with round4(x) <= x + 3, a block's
// words (the mbarriers' 4 among them) are at most span * (2W + paths) + 19 + paths + compose_words.
inline int backtrace_span(int W, int n_out, int T, bool composed) {
  const int paths = block_paths(n_out, composed);
  const long long room = (long long)(MAX_SMEM / 4) - 19 - paths - compose_words(W, n_out, composed);
  const long long span = room / (2LL * W + paths);
  const int frames = T > 1 ? T : 1;
  return span < frames ? (int)span : frames;
}

// the serial walk on staged spans (W <= WALK_MAX_W): a thread a path, SERIAL_PATHS paths a block
inline BacktracePlan serial_plan(int W, int n_out, int T) {
  const int span = backtrace_span(W, n_out, T, false);
  return {BACKTRACE_SERIAL, (block_paths(n_out, false) + 31) & ~31, span, backtrace_smem(W, n_out, span, false),
          (n_out + SERIAL_PATHS - 1) / SERIAL_PATHS};
}

inline BacktracePlan backtrace_plan(int W, int n_out, int T) {
  if (W > WALK_MAX_W) {
    return {BACKTRACE_WALK, BACKTRACE_THREADS, 0, 0, (n_out + BACKTRACE_THREADS - 1) / BACKTRACE_THREADS};
  }
  const int per_segment = W + 1 < 32 ? W + 1 : 32;  // the composed walk's threads a segment
  if (W <= COMPOSE_MAX_W && n_out <= 2 * per_segment) {
    const int span = backtrace_span(W, n_out, T, true);
    if (2 * ((span + SEGMENTS - 1) / SEGMENTS) + SEGMENTS - 1 < span) {  // the composed chain is the shorter one
      return {BACKTRACE_COMPOSED, SEGMENTS * per_segment, span, backtrace_smem(W, n_out, span, true), 1};
    }
  }
  return serial_plan(W, n_out, T);
}

// The words of one field's span (n words from src) in shared memory: word i at buf[shift + i], shift = src's word
// offset in its 16-byte line. Words [head, head + body) go by one bulk copy (16-byte aligned at both ends), the at
// most 3 + 3 around them by plain loads.
struct Staged {
  int shift, head, body;
};

__device__ __forceinline__ Staged staged(const int* src, int n) {
  const int shift = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min(n, (4 - shift) & 3);
  return {shift, head, ((n - head) >> 2) << 2};
}

// Thread 0 issues the bulk copies of a span's parents (completing on bar_p) and then its exts (bar_e); threads 0-15
// load the words around them. The caller's __syncthreads makes those visible; the waits on the mbarriers, the
// copies.
__device__ __forceinline__ void stage_span(int* sp, int* se, const int* P, const int* E, int n, uint32_t bar_p,
                                           uint32_t bar_e, int tid) {
  if (tid == 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the last span's reads, before the copies' writes
    const Staged a = staged(P, n), b = staged(E, n);
    hopper::mbar_expect_tx(bar_p, 4u * a.body);
    if (a.body > 0) hopper::bulk_load(hopper::smem_u32(sp + a.shift + a.head), P + a.head, 4u * a.body, bar_p);
    hopper::mbar_expect_tx(bar_e, 4u * b.body);
    if (b.body > 0) hopper::bulk_load(hopper::smem_u32(se + b.shift + b.head), E + b.head, 4u * b.body, bar_e);
  }
  if (tid < 16) {
    const int* src = tid < 8 ? P : E;
    int* buf = tid < 8 ? sp : se;
    const Staged s = staged(src, n);
    const int j = tid & 7;
    const int i = j < 4 ? j : s.head + s.body + (j - 4);
    if ((j < 4 && i < s.head) || (j >= 4 && i < n)) buf[s.shift + i] = src[i];
  }
}

// One frame of a walk on (s, out), s in [0, W) and out for a slot outside [0, W), given r = parents[t][s]: a slot
// outside goes to slot 0; else the parent, or (0, out) if the parent is outside. The chain a frame is the load of r,
// one compare and one select: the load never needs a guard, since s is always a slot of the frame.
__device__ __forceinline__ void step(int r, int& s, bool& out, int W) {
  const bool keep = !out && (unsigned)r < (unsigned)W;
  out = !out && !keep;
  s = keep ? r : 0;
}

// Frames f_hi - 1 down to f_lo of a staged span from the canonical slot `entry`, the tokens into tok[f]; returns the
// slot after frame f_lo as the plain walk carries it (a parent outside [0, W) as it is, 0 after a slot outside).
__device__ __forceinline__ int walk(const int* pp, const int* ee, int* tok, int f_hi, int f_lo, int entry, int W) {
  int s = entry < W ? entry : 0, raw = entry;
  bool out = entry >= W;
#pragma unroll 4
  for (int f = f_hi - 1; f >= f_lo; --f) {
    const int o = f * W + s;
    const int t = ee[o], r = pp[o];
    tok[f] = out ? -1 : t;
    raw = out ? 0 : r;
    step(r, s, out, W);
  }
  return raw;
}

// One block a row (and, on the serial route, a group of SERIAL_PATHS paths). Spans of `span` frames, newest first:
// staged by bulk copies (the parents first, then the exts, each on its own mbarrier), then walked.
//   COMPOSED = false: a thread a path walks the span's frames one after another.
//   COMPOSED = true: the span falls into SEGMENTS segments of ceil(n / SEGMENTS) frames, segment 31 the newest.
//     1. each segment's map (the composition of its frames' maps on W + 1 slots) into a table: thread (k, j) of
//        segment k walks entries j and j + per_segment through the segment, the lookups of a frame independent;
//     2. a thread a path hands its entry slot down from segment 31 to segment 0, one table lookup a segment;
//     3. thread (k, j) re-walks segment k for paths j and j + per_segment from their entry slots, emitting tokens.
//     The dependent chain is 2 ceil(n / 32) + 31 loads, against n for the serial walk.
//   Tokens go through shared memory and out as contiguous runs along T, a warp a path.
template <bool COMPOSED>
__global__ void __launch_bounds__(MAX_THREADS) beam_backtrace_kernel(
    const int* __restrict__ parents, const int* __restrict__ exts, const int* __restrict__ slots0,
    int* __restrict__ toks, int* __restrict__ origin, int T, int W, int n_out, int span) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int p0 = blockIdx.y * SERIAL_PATHS;  // the block's first path (0 on the composed route)
  const int paths = min(n_out - p0, COMPOSED ? n_out : SERIAL_PATHS);
  const int per_segment = W + 1 < 32 ? W + 1 : 32;
  const int stride = span | 1;  // a path's token row
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  int* sp = reinterpret_cast<int*>(smem_raw + 16);
  int* se = sp + round4(span * W + 3);
  int* stok = se + round4(span * W + 3);
  int* table = stok + round4(paths * stride);          // COMPOSED: [SEGMENTS][W + 1]
  int* entry = table + round4(SEGMENTS * (W + 1));     // COMPOSED: [SEGMENTS][n_out]
  int* leave = entry + round4(SEGMENTS * n_out);       // COMPOSED: [n_out]
  const uint32_t bar_p = hopper::smem_u32(bars), bar_e = hopper::smem_u32(bars + 1);
  if (tid == 0) {
    hopper::mbar_init(bar_p, 1);
    hopper::mbar_init(bar_e, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // A path's walker (thread tid for path p0 + tid) carries its slot across spans as (s, out): s in [0, W), and out
  // for a slot outside [0, W), which emits -1 and goes to slot 0; raw is the slot as the plain walk carries it.
  int raw = tid < paths ? slots0[(size_t)b * n_out + p0 + tid] : 0;
  const int* P = parents + (size_t)b * T * W;
  const int* E = exts + (size_t)b * T * W;
  int phase = 0;
  for (int hi = T; hi > 0; hi -= span, phase ^= 1) {
    const int lo = max(0, hi - span), n = hi - lo;
    __syncthreads();  // the previous span is consumed (on the first, the mbarriers are initialised)
    stage_span(sp, se, P + (size_t)lo * W, E + (size_t)lo * W, n * W, bar_p, bar_e, tid);
    __syncthreads();  // the plain loads around the bulk copies
    const int* pp = sp + staged(P + (size_t)lo * W, n * W).shift;  // pp[f * W + s]: frame lo + f
    const int* ee = se + staged(E + (size_t)lo * W, n * W).shift;
    hopper::mbar_wait(bar_p, phase);
    if constexpr (!COMPOSED) {
      hopper::mbar_wait(bar_e, phase);
      if (tid < paths) raw = walk(pp, ee, stok + tid * stride, n, 0, canonical(raw, W), W);
      __syncthreads();
    } else {
      const int seg = (n + SEGMENTS - 1) / SEGMENTS;
      const int k = tid / per_segment, j = tid - k * per_segment;
      const int f_lo = k * seg, f_hi = min(f_lo + seg, n);
      // phase 1, compose: each segment's map on slots 0..W, a thread's one or two entries walked together
      if (j + per_segment <= W) {
        int s0 = j, s1 = j + per_segment < W ? j + per_segment : 0;
        bool o0 = false, o1 = j + per_segment >= W;
        for (int f = f_hi - 1; f >= f_lo; --f) {
          const int r0 = pp[f * W + s0], r1 = pp[f * W + s1];
          step(r0, s0, o0, W);
          step(r1, s1, o1, W);
        }
        table[k * (W + 1) + j + per_segment] = o1 ? W : s1;
        table[k * (W + 1) + j] = o0 ? W : s0;
      } else {
        int s0 = j < W ? j : 0;
        bool o0 = j >= W;
#pragma unroll 4
        for (int f = f_hi - 1; f >= f_lo; --f) step(pp[f * W + s0], s0, o0, W);
        table[k * (W + 1) + j] = o0 ? W : s0;
      }
      __syncthreads();
      // phase 2, hand-down: a path's entry slot of each segment, newest first
      if (tid < n_out) {
        int e = canonical(raw, W);
        for (int s = SEGMENTS - 1; s > 0; --s) {
          entry[s * n_out + tid] = e;
          e = table[s * (W + 1) + e];
        }
        entry[tid] = e;
      }
      __syncthreads();
      hopper::mbar_wait(bar_e, phase);
      // phase 3, re-walk: each segment from its entry slots, emitting tokens; segment 0 holds the oldest frame
      for (int q = j; q < n_out; q += per_segment) {
        const int r = walk(pp, ee, stok + q * stride, f_hi, f_lo, entry[k * n_out + q], W);
        if (k == 0) leave[q] = r;
      }
      __syncthreads();
      if (tid < n_out) raw = leave[tid];
    }
    // the span's tokens, a warp a path, as contiguous runs along T
    for (int q = warp; q < paths; q += nt >> 5) {
      int* out = toks + ((size_t)b * n_out + p0 + q) * T + lo;
#pragma unroll 8
      for (int f = lane; f < n; f += 32) out[f] = stok[q * stride + f];
    }
  }
  if (tid < paths) origin[(size_t)b * n_out + p0 + tid] = raw;
}

// Past W = 6,144 (WALK_MAX_W): a thread a path walks with its loads straight from device memory.
__global__ void __launch_bounds__(BACKTRACE_THREADS) beam_backtrace_walk_kernel(
    const int* __restrict__ parents, const int* __restrict__ exts, const int* __restrict__ slots0,
    int* __restrict__ toks, int* __restrict__ origin, int T, int W, int n_out) {
  const int b = blockIdx.x;
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  if (n >= n_out) return;
  const size_t g = (size_t)b * n_out + n;
  int slot = slots0[g];
  const int* P = parents + (size_t)b * T * W;
  const int* E = exts + (size_t)b * T * W;
  int* out = toks + g * T;
  for (int t = T - 1; t >= 0; --t) {
    if (slot >= 0 && slot < W) {
      const size_t o = (size_t)t * W + slot;
      out[t] = __ldg(E + o);
      slot = __ldg(P + o);
    } else {  // as the TPU kernel's gather: no emission, slot 0
      out[t] = -1;
      slot = 0;
    }
  }
  origin[g] = slot;
}

// thunder_beam_walk_chain: one thread, `steps` dependent steps of the walks' chain, nothing else on it
__global__ void beam_walk_chain_kernel(int* __restrict__ out, int steps, int W) {
  __shared__ int field[64 * 16];
  for (int i = threadIdx.x; i < 64 * W; i += blockDim.x) field[i] = (i * 7 + 3) % W;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int s = 0;
  bool outside = false;
  for (int i = 0; i < steps; ++i) step(field[(i & 63) * W + s], s, outside, W);
  out[0] = outside ? W : s;
}

}  // namespace

// out[0] = threads, out[1] = shared bytes of one scan block for beam width W and K candidates, out[2] = the runs
// of a chunk (0: the one-block plan), out[3] = 4-byte words of device memory a row (the workspace plan, else 0).
extern "C" int thunder_beam_scan_plan(int W, int K, int* out) {
  if (W < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const ScanPlan plan = scan_plan(W, K);
  if (plan.workspace / 4 > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  out[0] = plan.threads;
  out[1] = (int)plan.smem;
  out[2] = plan.chunk_runs;
  out[3] = (int)(plan.workspace / 4);
  return 0;
}

// logp: (B, T, V) float32 log-probs; topv/topi: (B, T, K) float32/int32 candidates, or both
// null for K == V (ids 0..V-1); lens: (B,) int32; floor_: the prune floor; pb0, pnb0 (B, W)
// float32, h10, h20, last0 (B, W) int32: the state going in (hashes as uint32 bits);
// parents, exts: (B, T, W) int32 out; total, pb, pnb (B, W) float32 and h1, h2, last
// (B, W) int32 out: the final state; workspace: B rows of the plan's workspace bytes (the workspace plan),
// else null. Any K and W. Returns cudaGetLastError().
extern "C" int thunder_beam_scan(const float* logp, const float* topv, const int* topi, const int* lens, float floor_,
                                 const float* pb0, const float* pnb0, const int* h10, const int* h20,
                                 const int* last0, int* parents, int* exts, float* total, float* pb, float* pnb,
                                 int* h1, int* h2, int* last, int B, int T, int V, int K, int W, int blank,
                                 void* workspace, void* stream) {
  if (B < 1 || T < 0 || V < 1 || K < 1 || K > V || W < 1 || blank < 0 || blank >= V) return (int)cudaErrorInvalidValue;
  if ((topv == nullptr) != (topi == nullptr) || (topv == nullptr && K != V)) return (int)cudaErrorInvalidValue;
  if ((long long)W * K + W > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const ScanPlan plan = scan_plan(W, K);
  if (plan.workspace > 0 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan.chunk_runs == 0) {
    if (plan.smem > 49152) {
      const cudaError_t err =
          cudaFuncSetAttribute(beam_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
      if (err != cudaSuccess) return (int)err;
    }
    beam_scan_kernel<<<B, plan.threads, plan.smem, st>>>(logp, topv, topi, lens, floor_, pb0, pnb0, h10, h20, last0,
                                                         parents, exts, total, pb, pnb, h1, h2, last, T, V, K, W,
                                                         blank);
  } else if (plan.workspace == 0) {
    const cudaError_t err = cudaFuncSetAttribute(beam_scan_chunked_kernel<true>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
    beam_scan_chunked_kernel<true><<<B, plan.threads, plan.smem, st>>>(
        logp, topv, topi, lens, floor_, pb0, pnb0, h10, h20, last0, parents, exts, total, pb, pnb, h1, h2, last, T, V,
        K, W, blank, plan.chunk_runs, nullptr, 0);
  } else {
    beam_scan_chunked_kernel<false><<<B, plan.threads, 0, st>>>(
        logp, topv, topi, lens, floor_, pb0, pnb0, h10, h20, last0, parents, exts, total, pb, pnb, h1, h2, last, T, V,
        K, W, blank, plan.chunk_runs, static_cast<unsigned char*>(workspace), plan.workspace);
  }
  return (int)cudaGetLastError();
}

// out[0] = the route (0: the walk from device memory, 1: the serial walk on staged spans, 2: the composed walk),
// out[1] = threads of a block, out[2] = frames of a span, out[3] = shared bytes of a block, out[4] = blocks a row,
// for beam width W, n_out paths a row and T frames.
extern "C" int thunder_beam_backtrace_plan(int W, int n_out, int T, int* out) {
  if (W < 1 || n_out < 1 || T < 0) return (int)cudaErrorInvalidValue;
  const BacktracePlan plan = backtrace_plan(W, n_out, T);
  out[0] = plan.route;
  out[1] = plan.threads;
  out[2] = plan.span;
  out[3] = (int)plan.smem;
  out[4] = plan.blocks_y;
  return 0;
}

static int launch_backtrace(const BacktracePlan& plan, const int* parents, const int* exts, const int* slots0, int* toks,
                     int* origin, int B, int T, int W, int n_out, void* stream) {
  const dim3 grid(B, plan.blocks_y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan.route == BACKTRACE_WALK) {
    beam_backtrace_walk_kernel<<<grid, BACKTRACE_THREADS, 0, st>>>(parents, exts, slots0, toks, origin, T, W, n_out);
    return (int)cudaGetLastError();
  }
  const bool composed = plan.route == BACKTRACE_COMPOSED;
  const auto kernel = composed ? &beam_backtrace_kernel<true> : &beam_backtrace_kernel<false>;
  if (plan.smem > 49152) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, plan.threads, plan.smem, st>>>(parents, exts, slots0, toks, origin, T, W, n_out, plan.span);
  return (int)cudaGetLastError();
}

// parents, exts: (B, T, W) int32; slots0: (B, n_out) int32 start slots; toks: (B, n_out, T)
// int32 out (-1 where the path emitted nothing); origin: (B, n_out) int32 out, each path's
// slot in the window's initial state. Returns cudaGetLastError().
extern "C" int thunder_beam_backtrace(const int* parents, const int* exts, const int* slots0, int* toks, int* origin,
                                      int B, int T, int W, int n_out, void* stream) {
  if (B < 1 || T < 0 || W < 1 || n_out < 1) return (int)cudaErrorInvalidValue;
  return launch_backtrace(backtrace_plan(W, n_out, T), parents, exts, slots0, toks, origin, B, T, W, n_out, stream);
}

// The same function by the serial walk on staged spans whatever the plan picks (W <= 6,144), for timing the
// composed walk against it (kernels/compare_builds.py) and holding both routes to the plain walk at one shape.
extern "C" int thunder_beam_backtrace_serial(const int* parents, const int* exts, const int* slots0, int* toks,
                                             int* origin, int B, int T, int W, int n_out, void* stream) {
  if (B < 1 || T < 0 || W < 1 || W > WALK_MAX_W || n_out < 1) return (int)cudaErrorInvalidValue;
  return launch_backtrace(serial_plan(W, n_out, T), parents, exts, slots0, toks, origin, B, T, W, n_out, stream);
}

// The floor of the backtrace's chains on this card: `steps` dependent steps of the walk (a shared-memory load of
// the slot's parent, a compare and a select: step()) in one thread, over 64 frames of a field of width W <= 16
// whose parents are in [0, W); out[0] = the last slot. Returns cudaGetLastError().
extern "C" int thunder_beam_walk_chain(int* out, int steps, int W, void* stream) {
  if (steps < 1 || W < 1 || W > 16) return (int)cudaErrorInvalidValue;
  beam_walk_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(out, steps, W);
  return (int)cudaGetLastError();
}
