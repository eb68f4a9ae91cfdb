// Native host runtime of thunder_tpu_torch (host C++, no CUDA).
//
// Port of csrc/thunder_native.cpp: WAV and FLAC decode, resampling, edit
// distance, CTC collapse, the n-gram (stupid backoff and ARPA) scorers, the
// sentencepiece unigram encoder, word-level fusion and the CTC prefix beam
// search (one utterance, a batch threaded over samples, or carried windows).
// Exposed through a plain C ABI consumed via ctypes
// (thunder_tpu_torch/native.py), which builds it with g++ on first use into
// thunder_tpu_torch/build/. It is never linked into the CUDA kernel library.
//
// Three repairs against the source it copies:
// - tn_wav_info clamps the data chunk to the bytes the file holds (in whole
//   frames), as tn_load_wav does, so a lying header cannot report a duration
//   that is not there;
// - the (format, bits) pair is validated in both WAV entry points: PCM at
//   8/16/24/32 bits, IEEE float at 32/64 bits, WAVE_FORMAT_EXTENSIBLE only
//   with its 40-byte fmt chunk (the port's Python reader accepts exactly
//   these); every other pair is an error, never a file of zeros;
// - a FLAC sample outside the stream's bit depth (a corrupt frame: CRCs are
//   not verified) is an error, so integer PCM always decodes into [-1, 1].

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

struct TnAudio {
  float* data;        // planar (channels x frames)
  int32_t channels;
  int64_t frames;
  int32_t sample_rate;
};

static int read_exact(FILE* f, void* buf, size_t n) {
  return fread(buf, 1, n, f) == n ? 0 : -1;
}

// The (format, bits) pairs that decode: PCM at 8/16/24/32 bits, IEEE float
// at 32/64 bits (thunder_tpu_torch/data/audio_io.py's VALID_BITS).
static bool wav_pair_valid(uint16_t fmt, uint16_t bits) {
  if (fmt == 1) return bits == 8 || bits == 16 || bits == 24 || bits == 32;
  if (fmt == 3) return bits == 32 || bits == 64;
  return false;
}

// Decodes a RIFF/WAVE file (PCM 8/16/24/32-bit and IEEE float32/64).
// Returns 0 on success; caller frees with tn_free_audio.
int tn_load_wav(const char* path, TnAudio* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[12];
  if (read_exact(f, hdr, 12) || memcmp(hdr, "RIFF", 4) || memcmp(hdr + 8, "WAVE", 4)) {
    fclose(f);
    return -2;
  }
  fseek(f, 0, SEEK_END);
  const long fsize = ftell(f);
  fseek(f, 12, SEEK_SET);
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  bool have_fmt = false;
  std::vector<uint8_t> raw;
  while (true) {
    uint8_t chunk[8];
    if (read_exact(f, chunk, 8)) break;
    uint32_t size;
    memcpy(&size, chunk + 4, 4);
    if (!memcmp(chunk, "fmt ", 4)) {
      // the spec's fmt chunk is 16/18/40 bytes; a corrupt size field must
      // neither drive a huge allocation nor an out-of-bounds field read
      if (size < 16 || size > 4096) { fclose(f); return -3; }
      std::vector<uint8_t> fbuf(size);
      if (read_exact(f, fbuf.data(), size)) { fclose(f); return -3; }
      memcpy(&fmt, fbuf.data(), 2);
      memcpy(&channels, fbuf.data() + 2, 2);
      memcpy(&rate, fbuf.data() + 4, 4);
      memcpy(&bits, fbuf.data() + 14, 2);
      if (fmt == 0xFFFE && size >= 40) memcpy(&fmt, fbuf.data() + 24, 2);  // extensible
      have_fmt = true;
      if (size & 1) fseek(f, 1, SEEK_CUR);
    } else if (!memcmp(chunk, "data", 4)) {
      if (!have_fmt) { fclose(f); return -4; }
      // clamp a lying data-size field to the bytes actually present so a
      // truncated file decodes its real payload (the python parser's
      // semantics) instead of allocating the claimed size
      const long pos = ftell(f);
      uint64_t avail = (pos >= 0 && fsize > pos) ? (uint64_t)(fsize - pos) : 0;
      uint64_t want = size < avail ? size : avail;
      raw.resize(want);
      if (want && read_exact(f, raw.data(), want)) { fclose(f); return -5; }
      break;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  if (!have_fmt || raw.empty() || channels == 0) return -6;
  if (!wav_pair_valid(fmt, bits)) return -6;

  const int bytes = bits / 8;
  const int64_t frames = (int64_t)raw.size() / (channels * bytes);
  float* data = (float*)malloc(sizeof(float) * frames * channels);
  if (!data) return -7;

  for (int64_t i = 0; i < frames; ++i) {
    for (int c = 0; c < channels; ++c) {
      const uint8_t* p = raw.data() + (i * channels + c) * bytes;
      float v = 0.f;
      if (fmt == 3) {  // IEEE float
        if (bits == 32) { float t; memcpy(&t, p, 4); v = t; }
        else if (bits == 64) { double t; memcpy(&t, p, 8); v = (float)t; }
      } else {
        if (bits == 16) { int16_t t; memcpy(&t, p, 2); v = t / 32768.f; }
        else if (bits == 32) { int32_t t; memcpy(&t, p, 4); v = t / 2147483648.f; }
        else if (bits == 8) { v = ((int)p[0] - 128) / 128.f; }
        else if (bits == 24) {
          int32_t t = p[0] | (p[1] << 8) | (p[2] << 16);
          if (t >= (1 << 23)) t -= (1 << 24);
          v = t / 8388608.f;
        }
      }
      data[(int64_t)c * frames + i] = v;  // planar
    }
  }
  out->data = data;
  out->channels = channels;
  out->frames = frames;
  out->sample_rate = (int32_t)rate;
  return 0;
}

void tn_free_audio(TnAudio* a) {
  if (a && a->data) { free(a->data); a->data = nullptr; }
}

// Header-only info: frames + rate + channels (for duration bucketing). The
// data chunk is clamped to the bytes the file holds, in whole frames, and
// the (format, bits) pair is validated, as in tn_load_wav.
int tn_wav_info(const char* path, int64_t* frames, int32_t* rate, int32_t* channels, int32_t* bits) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[12];
  if (read_exact(f, hdr, 12) || memcmp(hdr, "RIFF", 4) || memcmp(hdr + 8, "WAVE", 4)) {
    fclose(f); return -2;
  }
  fseek(f, 0, SEEK_END);
  const long fsize = ftell(f);
  fseek(f, 12, SEEK_SET);
  uint16_t fmt = 0, ch = 0, b = 0;
  uint32_t r = 0;
  bool have_fmt = false;
  while (true) {
    uint8_t chunk[8];
    if (read_exact(f, chunk, 8)) { fclose(f); return -3; }
    uint32_t size;
    memcpy(&size, chunk + 4, 4);
    if (!memcmp(chunk, "fmt ", 4)) {
      if (size < 16 || size > 4096) { fclose(f); return -3; }  // see tn_load_wav
      std::vector<uint8_t> fbuf(size);
      if (read_exact(f, fbuf.data(), size)) { fclose(f); return -3; }
      memcpy(&fmt, fbuf.data(), 2);
      memcpy(&ch, fbuf.data() + 2, 2);
      memcpy(&r, fbuf.data() + 4, 4);
      memcpy(&b, fbuf.data() + 14, 2);
      if (fmt == 0xFFFE && size >= 40) memcpy(&fmt, fbuf.data() + 24, 2);  // extensible
      have_fmt = true;
      if (size & 1) fseek(f, 1, SEEK_CUR);
    } else if (!memcmp(chunk, "data", 4)) {
      const long pos = ftell(f);
      fclose(f);
      if (!have_fmt || ch == 0) return -4;
      if (!wav_pair_valid(fmt, b)) return -4;
      const uint64_t avail = (pos >= 0 && fsize > pos) ? (uint64_t)(fsize - pos) : 0;
      const uint64_t held = size < avail ? size : avail;
      *frames = (int64_t)(held / ((uint64_t)ch * (b / 8)));
      *rate = (int32_t)r;
      *channels = ch;
      *bits = b;
      return 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
}

// ---------------------------------------------------------------------------
// Polyphase windowed-sinc resampler
// ---------------------------------------------------------------------------

// y has ceil(n_in * up / down) samples; filter: Hann-windowed sinc with
// `zeros` zero crossings per side at the lower of the two Nyquists.
int tn_resample(const float* x, int64_t n_in, float* y, int64_t n_out,
                int32_t up, int32_t down, int32_t zeros) {
  if (up <= 0 || down <= 0) return -1;
  const double cutoff = 0.5 / std::max(up, down);   // in units of up-rate
  const int64_t half = (int64_t)zeros * std::max(up, down);
  const double norm = 2.0 * cutoff * up;
  for (int64_t j = 0; j < n_out; ++j) {
    // output j corresponds to up-rate index j*down; convolve with sinc taps
    const int64_t center = j * down;
    double acc = 0.0;
    // input samples map to up-rate indices i*up
    int64_t i_lo = (center - half + up - 1) / up;
    int64_t i_hi = (center + half) / up;
    if (i_lo < 0) i_lo = 0;
    if (i_hi >= n_in) i_hi = n_in - 1;
    for (int64_t i = i_lo; i <= i_hi; ++i) {
      const double t = (double)(center - i * up);  // up-rate offset
      const double xs = 2.0 * M_PI * cutoff * t;
      double s = (t == 0.0) ? 1.0 : std::sin(xs) / xs;
      const double w = 0.5 * (1.0 + std::cos(M_PI * t / half));  // Hann
      acc += (double)x[i] * s * w;
    }
    y[j] = (float)(acc * norm);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Edit distance (Levenshtein) over int32 token sequences
// ---------------------------------------------------------------------------

int64_t tn_edit_distance(const int32_t* a, int64_t la, const int32_t* b, int64_t lb) {
  if (la < lb) { std::swap(a, b); std::swap(la, lb); }
  if (lb == 0) return la;
  std::vector<int64_t> prev(lb + 1), cur(lb + 1);
  for (int64_t j = 0; j <= lb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= la; ++i) {
    cur[0] = i;
    const int32_t ca = a[i - 1];
    for (int64_t j = 1; j <= lb; ++j) {
      const int64_t sub = prev[j - 1] + (ca != b[j - 1]);
      cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1), sub);
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

// ---------------------------------------------------------------------------
// CTC greedy collapse: drop consecutive repeats; returns new length
// ---------------------------------------------------------------------------

int64_t tn_ctc_collapse(const int32_t* ids, int64_t n, int32_t* out) {
  if (n == 0) return 0;
  int64_t m = 0;
  int32_t prev = ids[0] - 1;  // != ids[0]
  for (int64_t i = 0; i < n; ++i) {
    if (ids[i] != prev) out[m++] = ids[i];
    prev = ids[i];
  }
  return m;
}

// ---------------------------------------------------------------------------
// CTC prefix beam search (Hannun et al., 2014)
//
// Exact host-side decode summing posterior probability over all alignments
// of each label prefix.  Prefixes live in a trie (parent, token) so beams
// are integer node ids; per-step merging is a hash map over node ids.
// Validated against the numpy reference in
// thunder_tpu_torch/ops/ctc_beam.py (tests/test_torch_lm.py).
// ---------------------------------------------------------------------------

}  // extern "C"

#include <unordered_map>
#include <limits>
#include <string>
#include <thread>
#include <atomic>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

inline double log_add(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  const double m = a > b ? a : b;
  return m + std::log1p(std::exp(-std::fabs(a - b)));
}

struct BeamProbs {
  double pb = kNegInf;   // ends in blank
  double pnb = kNegInf;  // ends in non-blank
};

// N-gram LM over int32 token ids, the native mirror of the scorers in
// thunder_tpu_torch/text/lm.py — so shallow fusion (lm_weight * score per prefix
// extension) can run inside the C++ beam search instead of forcing the
// numpy fallback.  Two modes:
//   kCounts — stupid backoff over raw counts (NGramLM; Brants et al., 2007)
//   kArpa   — Katz backoff over explicit (ln P, ln bow) entries (ArpaLM,
//             loaded from the KenLM/SRILM ARPA interchange format)
// Tables are loaded from Python; n-grams key a hash map by their raw id
// bytes (order<=4 grams fit std::string's SSO buffer).
// magic tags let the beam entry points accept either scorer kind through
// one void* parameter (first int32 of the struct identifies it)
constexpr int32_t kLmMagic = 0x544E4C4D;  // "MLNT"
constexpr int32_t kWfMagic = 0x544E5746;  // "FWNT"

struct NGramLM {
  const int32_t magic = kLmMagic;
  enum Mode { kCounts = 0, kArpa = 1 };
  Mode mode = kCounts;
  int32_t order = 1;
  double log_backoff = 0.0;  // kCounts: per-level penalty
  double oov_logp = -12.0;   // floor (kArpa: used when no <unk> entry)
  int32_t unk_id = -1;       // kArpa: <unk> vocab id, -1 if absent
  std::unordered_map<std::string, int64_t> counts;          // grams of every length
  std::unordered_map<std::string, int64_t> context_totals;  // contexts of len>=2 grams
  int64_t total_unigrams = 0;
  struct ArpaEntry { double logp, bow; };
  std::unordered_map<std::string, ArpaEntry> arpa;

  static std::string key_of(const int32_t* ids, int32_t n) {
    return std::string(reinterpret_cast<const char*>(ids), (size_t)n * sizeof(int32_t));
  }

  double score(const int32_t* ctx, int32_t ctx_len, int32_t token) const {
    if (ctx_len > order - 1) {
      ctx += ctx_len - (order - 1);
      ctx_len = order - 1;
    }
    if (ctx_len < 0) ctx_len = 0;
    std::vector<int32_t> gram(ctx, ctx + ctx_len);
    gram.push_back(token);
    return mode == kArpa ? score_arpa(gram) : score_counts(gram);
  }

  // stupid backoff: longest matching context wins, log(backoff) penalty per
  // level skipped, oov floor at the unigram level.
  double score_counts(std::vector<int32_t>& gram) const {
    int32_t start = 0;
    double penalty = 0.0;
    while (true) {
      const int32_t glen = (int32_t)gram.size() - start;
      auto it = counts.find(key_of(gram.data() + start, glen));
      if (it != counts.end() && it->second > 0) {
        double denom;
        if (glen == 1) {
          denom = (double)total_unigrams;
        } else {
          auto ct = context_totals.find(key_of(gram.data() + start, glen - 1));
          denom = ct != context_totals.end() ? (double)ct->second : 0.0;
        }
        return penalty + std::log((double)it->second / denom);
      }
      if (glen <= 1) return penalty + oov_logp;
      ++start;
      penalty += log_backoff;
    }
  }

  // Katz backoff: explicit ln P when the gram is listed, else the context's
  // backoff weight plus the lower-order score; unknown tokens (-1) bottom
  // out at <unk>'s unigram or the oov floor.  Mirror of ArpaLM.score_ids.
  double score_arpa(std::vector<int32_t>& gram) const {
    const int32_t token = gram.back();
    int32_t start = 0;
    double penalty = 0.0;
    while (true) {
      const int32_t glen = (int32_t)gram.size() - start;
      if (token >= 0) {
        auto it = arpa.find(key_of(gram.data() + start, glen));
        if (it != arpa.end()) return penalty + it->second.logp;
      }
      if (glen <= 1) {
        if (token != unk_id && unk_id >= 0) {
          auto unk = arpa.find(key_of(&unk_id, 1));
          if (unk != arpa.end()) return penalty + unk->second.logp;
        }
        return penalty + oov_logp;
      }
      auto bo = arpa.find(key_of(gram.data() + start, glen - 1));
      if (bo != arpa.end()) penalty += bo->second.bow;
      ++start;
    }
  }
};

// Word-level shallow fusion config (mirror of text/word_fusion.py:
// WordFusionLM): scores a completed word against the word history whenever
// a candidate token closes a word boundary.  The word LM is an NGramLM in
// either mode (counts / ARPA).
struct WordFusion {
  const int32_t magic = kWfMagic;
  const NGramLM* wlm = nullptr;  // word LM (nullable: hotwords/word_score only)
  int32_t style = 0;     // 0 = char + separator token, 1 = sentencepiece
  int32_t space_id = -1; // style 0: the separator token id
  int32_t bos_id = -1;   // seed word history (-1 = none)
  int32_t unk_id = -1;   // history/scoring id for OOV words (-1 = opaque)
  double word_score = 0.0;  // flat bonus per completed word (insertion knob)
  std::vector<std::string> pieces;               // token id -> text (UTF-8)
  std::unordered_map<std::string, int32_t> word_ids;  // word -> LM vocab id
  std::unordered_map<std::string, double> hotwords;   // word -> extra boost

  int32_t lookup(const std::string& word) const {
    auto it = word_ids.find(word);
    return it != word_ids.end() ? it->second : unk_id;
  }

  static bool sp_start(const std::string& piece) {
    // "▁" is 0xE2 0x96 0x81 in UTF-8
    return piece.size() >= 3 && (uint8_t)piece[0] == 0xE2 &&
           (uint8_t)piece[1] == 0x96 && (uint8_t)piece[2] == 0x81;
  }
};

// Prefix beam search over a label trie.  Reusable across windows: seed the
// beam set (root, or carried prefixes from a previous window), run frames,
// read the ranked survivors — the basis of cross-chunk long-audio decoding.
struct BeamSearch {
  int64_t V;
  int32_t blank, beam_width;
  float prune_logp;
  int32_t max_tokens_per_step;
  const NGramLM* lm = nullptr;  // optional token-level shallow fusion
  const WordFusion* wf = nullptr;  // optional word-level shallow fusion
  double lm_weight = 0.0;

  // trie: node 0 is the empty prefix
  std::vector<int32_t> parent{-1};
  std::vector<int32_t> token{-1};
  std::unordered_map<int64_t, int32_t> child;  // (node * V + tok) -> node
  std::unordered_map<int32_t, BeamProbs> beams;

  // word-fusion state per trie node (only populated when wf is set)
  struct WfState {
    std::vector<int32_t> hist;  // last order-1 completed word ids
    std::string partial;        // word under construction (UTF-8)
  };
  std::vector<WfState> wstate;

  BeamSearch(int64_t V, int32_t blank, int32_t beam_width, float prune_logp,
             int32_t max_tokens_per_step)
      : V(V), blank(blank), beam_width(beam_width), prune_logp(prune_logp),
        max_tokens_per_step(max_tokens_per_step) {}

  // Attach a scorer (called before seeding; the root's word state depends
  // on it).  A kLmMagic handle is token-level, kWfMagic word-level.
  void set_scorer(const void* scorer, double weight) {
    lm_weight = weight;
    if (!scorer) return;
    const int32_t m = *static_cast<const int32_t*>(scorer);
    if (m == kWfMagic) {
      wf = static_cast<const WordFusion*>(scorer);
      WfState root;
      if (wf->bos_id >= 0) root.hist.push_back(wf->bos_id);
      wstate.push_back(std::move(root));
    } else {
      lm = static_cast<const NGramLM*>(scorer);
    }
  }

  void push_word(WfState& st) const {
    if (wf->wlm) {
      st.hist.push_back(wf->lookup(st.partial));
      const size_t keep = wf->wlm->order > 1 ? (size_t)(wf->wlm->order - 1) : 0;
      if (st.hist.size() > keep)
        st.hist.erase(st.hist.begin(), st.hist.end() - keep);
    }
    st.partial.clear();
  }

  int32_t get_child(int32_t node, int32_t tok) {
    const int64_t key = static_cast<int64_t>(node) * V + tok;
    auto it = child.find(key);
    if (it != child.end()) return it->second;
    const int32_t id = static_cast<int32_t>(parent.size());
    parent.push_back(node);
    token.push_back(tok);
    child.emplace(key, id);
    if (wf) {  // derive the child's word state from the parent's
      WfState st = wstate[node];
      const std::string& piece = wf->pieces[tok];
      if (wf->style == 0) {
        if (tok == wf->space_id) {
          if (!st.partial.empty()) push_word(st);
        } else {
          st.partial += piece;
        }
      } else if (WordFusion::sp_start(piece)) {
        if (!st.partial.empty()) push_word(st);
        st.partial.assign(piece, 3, std::string::npos);
      } else {
        st.partial += piece;
      }
      wstate.push_back(std::move(st));
    }
    return id;
  }

  // bonus for extending `node`'s prefix with token v: the word LM score of
  // the completed word, or 0 when v does not close a word boundary
  double wf_bonus(int32_t node, int32_t v) const {
    if (wstate[node].partial.empty()) return 0.0;
    if (wf->style == 0) {
      if (v != wf->space_id) return 0.0;
    } else if (!WordFusion::sp_start(wf->pieces[v])) {
      return 0.0;
    }
    return wf_final_bonus(node);  // same completed-word score, boundary-gated
  }

  void seed_root() { beams[0] = BeamProbs{0.0, kNegInf}; }

  // Seed one carried beam (tokens of a prefix + its blank/non-blank probs);
  // duplicate prefixes log-add.  Returns false on an out-of-range token.
  bool seed_prefix(const int32_t* toks, int32_t len, double pb, double pnb) {
    int32_t node = 0;
    for (int32_t i = 0; i < len; ++i) {
      if (toks[i] < 0 || toks[i] >= V) return false;
      node = get_child(node, toks[i]);
    }
    BeamProbs& b = beams[node];
    b.pb = log_add(b.pb, pb);
    b.pnb = log_add(b.pnb, pnb);
    return true;
  }

  void run(const float* logp, int64_t T) {
    std::vector<int32_t> keep;
    keep.reserve(V);
    std::vector<std::pair<int32_t, BeamProbs>> ranked;
    // reused across frames: clear() keeps the bucket array, so the hot loop
    // does no per-frame rehash/alloc (measured ~1.8x on serving shapes)
    std::unordered_map<int32_t, BeamProbs> next;
    for (int64_t t = 0; t < T; ++t) {
      const float* step = logp + t * V;
      keep.clear();
      for (int32_t v = 0; v < V; ++v)
        if (step[v] >= prune_logp) keep.push_back(v);
      if (max_tokens_per_step > 0 &&
          static_cast<int32_t>(keep.size()) > max_tokens_per_step) {
        // cap to the top-K emissions; always retain the blank
        std::partial_sort(keep.begin(), keep.begin() + max_tokens_per_step,
                          keep.end(), [step](int32_t a, int32_t b) {
                            return step[a] > step[b];
                          });
        keep.resize(max_tokens_per_step);
        if (std::find(keep.begin(), keep.end(), blank) == keep.end() &&
            step[blank] >= prune_logp)
          keep.push_back(blank);
        std::sort(keep.begin(), keep.end());
      }
      if (keep.empty()) continue;

      next.clear();
      next.reserve(beams.size() * (keep.size() + 1));
      std::vector<int32_t> ctx;  // LM context: last order-1 tokens of the prefix
      for (const auto& kv : beams) {
        const int32_t node = kv.first;
        const double pb = kv.second.pb, pnb = kv.second.pnb;
        const double total = log_add(pb, pnb);
        const int32_t last = token[node];  // -1 at root
        if (lm) {
          ctx.clear();
          int32_t n = node;
          for (int32_t i = 0; i < lm->order - 1 && n != 0; ++i, n = parent[n])
            ctx.push_back(token[n]);
          std::reverse(ctx.begin(), ctx.end());
        }
        for (int32_t v : keep) {
          const double p = step[v];
          if (v == blank) {
            BeamProbs& tgt = next[node];
            tgt.pb = log_add(tgt.pb, total + p);
            continue;
          }
          double bonus = 0.0;
          if (lm) bonus = lm_weight * lm->score(ctx.data(), (int32_t)ctx.size(), v);
          else if (wf) bonus = lm_weight * wf_bonus(node, v);
          if (v == last) {
            BeamProbs& same = next[node];
            same.pnb = log_add(same.pnb, pnb + p);
            const int32_t ext = get_child(node, v);
            BeamProbs& e = next[ext];
            e.pnb = log_add(e.pnb, pb + p + bonus);
          } else {
            const int32_t ext = get_child(node, v);
            BeamProbs& e = next[ext];
            e.pnb = log_add(e.pnb, total + p + bonus);
          }
        }
      }
      ranked.assign(next.begin(), next.end());
      const size_t k = std::min<size_t>(beam_width, ranked.size());
      std::partial_sort(ranked.begin(), ranked.begin() + k, ranked.end(),
                        [](const std::pair<int32_t, BeamProbs>& a,
                           const std::pair<int32_t, BeamProbs>& b) {
                          return log_add(a.second.pb, a.second.pnb) >
                                 log_add(b.second.pb, b.second.pnb);
                        });
      beams.clear();
      for (size_t i = 0; i < k; ++i) beams.emplace(ranked[i].first, ranked[i].second);
    }
  }

  // bonus for a COMPLETED utterance whose prefix ends in a pending partial
  // word: word fusion is boundary-driven, so without this the final word of
  // every utterance (all of a single-word one) would never see the LM or a
  // hotword boost.  Applied at final ranking only — never baked into
  // carried (stream) state, where the partial may still grow.
  double wf_final_bonus(int32_t node) const {
    const WfState& st = wstate[node];
    if (st.partial.empty()) return 0.0;
    double bonus = wf->word_score;
    if (wf->wlm)
      bonus += wf->wlm->score(st.hist.data(), (int32_t)st.hist.size(),
                              wf->lookup(st.partial));
    if (!wf->hotwords.empty()) {
      auto hw = wf->hotwords.find(st.partial);
      if (hw != wf->hotwords.end()) bonus += hw->second;
    }
    return bonus;
  }

  // surviving beams, best-first, truncated to beam_width.  finalize adds
  // the pending-partial-word fusion bonus to the ranking key (one-shot /
  // batch decodes of complete utterances; stream windows pass false).
  std::vector<std::pair<int32_t, BeamProbs>> ranked_beams(bool finalize = false) const {
    std::vector<std::pair<int32_t, BeamProbs>> out(beams.begin(), beams.end());
    const bool fin = finalize && wf != nullptr;
    auto key = [&](const std::pair<int32_t, BeamProbs>& p) {
      double s = log_add(p.second.pb, p.second.pnb);
      if (fin) s += lm_weight * wf_final_bonus(p.first);
      return s;
    };
    std::sort(out.begin(), out.end(),
              [&](const std::pair<int32_t, BeamProbs>& a,
                  const std::pair<int32_t, BeamProbs>& b) { return key(a) > key(b); });
    if (out.size() > static_cast<size_t>(beam_width)) out.resize(beam_width);
    return out;
  }

  std::vector<int32_t> prefix_of(int32_t node) const {
    std::vector<int32_t> seq;
    for (int32_t n = node; n != 0; n = parent[n]) seq.push_back(token[n]);
    std::reverse(seq.begin(), seq.end());
    return seq;
  }
};

}  // namespace

extern "C" {

// ---- n-gram LM lifecycle (consumed by thunder_tpu_torch/text/lm.py) -------------

// Creates an empty stupid-backoff LM; populate with tn_lm_add + tn_lm_finalize.
void* tn_lm_create(int32_t order, double backoff, double oov_logp) {
  if (order < 1 || backoff <= 0.0) return nullptr;
  try {
    NGramLM* lm = new NGramLM();
    lm->order = order;
    lm->log_backoff = std::log(backoff);
    lm->oov_logp = oov_logp;
    return lm;
  } catch (...) {
    return nullptr;
  }
}

// Bulk-adds n n-grams of one length: grams is (n x gram_len) row-major,
// counts has n entries.  Duplicate grams accumulate.
int tn_lm_add(void* handle, const int32_t* grams, const int64_t* counts,
              int64_t n, int32_t gram_len) {
  NGramLM* lm = static_cast<NGramLM*>(handle);
  if (!lm || gram_len < 1 || gram_len > lm->order || n < 0) return -1;
  try {
    for (int64_t i = 0; i < n; ++i)
      lm->counts[NGramLM::key_of(grams + i * gram_len, gram_len)] += counts[i];
    return 0;
  } catch (...) {
    return -2;
  }
}

// Rebuilds context totals + the unigram denominator from the loaded counts
// (mirror of NGramLM.fit's from-scratch rebuild, lm.py:54-58).
int tn_lm_finalize(void* handle) {
  NGramLM* lm = static_cast<NGramLM*>(handle);
  if (!lm) return -1;
  try {
    lm->context_totals.clear();
    lm->total_unigrams = 0;
    for (const auto& kv : lm->counts) {
      const int32_t glen = (int32_t)(kv.first.size() / sizeof(int32_t));
      if (glen == 1) {
        lm->total_unigrams += kv.second;
      } else {
        lm->context_totals[kv.first.substr(0, kv.first.size() - sizeof(int32_t))] +=
            kv.second;
      }
    }
    return 0;
  } catch (...) {
    return -2;
  }
}

// Creates an empty Katz-backoff (ARPA-mode) LM; populate with tn_lm_add_arpa.
// No finalize step is needed (entries carry explicit probabilities).
void* tn_lm_create_arpa(int32_t order, double unk_logp, int32_t unk_id) {
  if (order < 1) return nullptr;
  try {
    NGramLM* lm = new NGramLM();
    lm->mode = NGramLM::kArpa;
    lm->order = order;
    lm->oov_logp = unk_logp;
    lm->unk_id = unk_id;
    return lm;
  } catch (...) {
    return nullptr;
  }
}

// Bulk-adds n ARPA entries of one length: grams is (n x gram_len) row-major,
// logps/bows have n entries each (natural log).
int tn_lm_add_arpa(void* handle, const int32_t* grams, const double* logps,
                   const double* bows, int64_t n, int32_t gram_len) {
  NGramLM* lm = static_cast<NGramLM*>(handle);
  if (!lm || lm->mode != NGramLM::kArpa || gram_len < 1 || gram_len > lm->order ||
      n < 0)
    return -1;
  try {
    for (int64_t i = 0; i < n; ++i)
      lm->arpa[NGramLM::key_of(grams + i * gram_len, gram_len)] =
          NGramLM::ArpaEntry{logps[i], bows[i]};
    return 0;
  } catch (...) {
    return -2;
  }
}

void tn_lm_free(void* handle) { delete static_cast<NGramLM*>(handle); }

// Word-fusion config around an (optional) word-level LM handle (tn_lm_*).
// pieces_blob/piece_offsets: n_tokens+1 offsets into the UTF-8 blob mapping
// each acoustic-vocab token id to its text ("" for specials/blank).
// words_blob/word_offsets: the word LM's vocabulary in id order (word i ->
// LM id i; empty when word_lm is null).  hotwords_blob/hotword_offsets/
// hotword_boosts: per-word extra bonuses (n_hotwords entries).  word_score
// is a flat bonus per completed word (insertion knob).  The fusion handle
// does NOT own word_lm — the caller keeps it alive (Python side holds a
// reference).
void* tn_wfusion_create(void* word_lm, int32_t style, int32_t space_id,
                        int32_t bos_id, int32_t unk_id, double word_score,
                        const char* pieces_blob, const int64_t* piece_offsets,
                        int32_t n_tokens, const char* words_blob,
                        const int64_t* word_offsets, int32_t n_words,
                        const char* hotwords_blob, const int64_t* hotword_offsets,
                        const double* hotword_boosts, int32_t n_hotwords) {
  NGramLM* wlm = static_cast<NGramLM*>(word_lm);
  if (wlm && wlm->magic != kLmMagic) return nullptr;
  if (style != 0 && style != 1) return nullptr;
  if (style == 0 && space_id < 0) return nullptr;
  try {
    WordFusion* wfp = new WordFusion();
    wfp->wlm = wlm;
    wfp->style = style;
    wfp->space_id = space_id;
    wfp->bos_id = bos_id;
    wfp->unk_id = unk_id;
    wfp->word_score = word_score;
    wfp->pieces.reserve(n_tokens);
    for (int32_t i = 0; i < n_tokens; ++i)
      wfp->pieces.emplace_back(pieces_blob + piece_offsets[i],
                               (size_t)(piece_offsets[i + 1] - piece_offsets[i]));
    wfp->word_ids.reserve((size_t)n_words * 2);
    for (int32_t i = 0; i < n_words; ++i)
      wfp->word_ids.emplace(
          std::string(words_blob + word_offsets[i],
                      (size_t)(word_offsets[i + 1] - word_offsets[i])),
          i);
    for (int32_t i = 0; i < n_hotwords; ++i)
      wfp->hotwords.emplace(
          std::string(hotwords_blob + hotword_offsets[i],
                      (size_t)(hotword_offsets[i + 1] - hotword_offsets[i])),
          hotword_boosts[i]);
    return wfp;
  } catch (...) {
    return nullptr;
  }
}

void tn_wfusion_free(void* handle) { delete static_cast<WordFusion*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// SentencePiece unigram Viterbi encode (hot loop of the text pipeline)
//
// The native mirror of thunder_tpu_torch/text/sentencepiece_model.py's
// _encode_unigram_py —
// exact same DP (char positions, strict-improvement tie-break, known pieces
// before the unknown single-char fallback), ~20x the Python loop.  Operates
// on the ALREADY-NORMALIZED UTF-8 text (normalization stays in Python) and
// returns piece boundaries as byte offsets, so unknown characters keep their
// surface exactly like the Python backtrack.
// ---------------------------------------------------------------------------

namespace {

struct SpmEncoder {
  std::unordered_map<std::string, int32_t> index;  // piece -> slot
  std::vector<double> scores;                      // per slot
  int32_t max_piece_chars = 1;
  double unk_score = -10.0;
};

}  // namespace

extern "C" {

// pieces_blob/offsets: n indexable pieces (NORMAL/USER_DEFINED, UTF-8);
// scores aligned per piece.  unk_score = min(all model scores) - 10.
void* tn_spm_create(const char* pieces_blob, const int64_t* offsets,
                    const double* scores, int32_t n, double unk_score) {
  try {
    SpmEncoder* enc = new SpmEncoder();
    enc->unk_score = unk_score;
    enc->index.reserve((size_t)n * 2);
    enc->scores.assign(scores, scores + n);
    for (int32_t i = 0; i < n; ++i) {
      std::string piece(pieces_blob + offsets[i], (size_t)(offsets[i + 1] - offsets[i]));
      int32_t chars = 0;
      for (char c : piece)
        if ((c & 0xC0) != 0x80) ++chars;  // count UTF-8 lead bytes
      if (chars > enc->max_piece_chars) enc->max_piece_chars = chars;
      enc->index.emplace(std::move(piece), i);
    }
    return enc;
  } catch (...) {
    return nullptr;
  }
}

void tn_spm_free(void* handle) { delete static_cast<SpmEncoder*>(handle); }

// Viterbi-segments `text` (normalized UTF-8, len bytes).  Writes piece byte
// spans into out_starts/out_ends (capacity cap) and returns the piece count,
// or -1 on error/overflow.
int64_t tn_spm_encode(void* handle, const char* text, int64_t len,
                      int32_t* out_starts, int32_t* out_ends, int64_t cap) {
  SpmEncoder* enc = static_cast<SpmEncoder*>(handle);
  if (!enc || len < 0) return -1;
  if (len == 0) return 0;
  try {
    // char-boundary byte offsets
    std::vector<int32_t> off;
    off.reserve(len + 1);
    for (int64_t b = 0; b < len; ++b)
      if ((text[b] & 0xC0) != 0x80) off.push_back((int32_t)b);
    off.push_back((int32_t)len);
    const int32_t n = (int32_t)off.size() - 1;  // chars

    constexpr double kNeg = -1e18;
    std::vector<double> best(n + 1, kNeg);
    std::vector<int32_t> back(n + 1, -1);  // char index the best piece starts at
    best[0] = 0.0;
    std::string sub;
    for (int32_t i = 0; i < n; ++i) {
      if (best[i] <= kNeg / 2) continue;
      const double base = best[i];
      const int32_t upper = std::min(n, i + enc->max_piece_chars);
      for (int32_t j = i + 1; j <= upper; ++j) {
        sub.assign(text + off[i], (size_t)(off[j] - off[i]));
        auto it = enc->index.find(sub);
        if (it != enc->index.end()) {
          const double cand = base + enc->scores[it->second];
          if (cand > best[j]) {
            best[j] = cand;
            back[j] = i;
          }
        }
      }
      // unknown single-char fallback (after known pieces — mirror the
      // Python loop's strict-improvement ordering)
      const double cand = base + enc->unk_score;
      if (cand > best[i + 1]) {
        best[i + 1] = cand;
        back[i + 1] = i;
      }
    }
    // count + emit spans in order (backtrack, then reverse)
    std::vector<int32_t> bounds;
    for (int32_t j = n; j > 0;) {
      const int32_t i = back[j];
      if (i < 0) return -1;  // unreachable (cannot happen: unk always links)
      bounds.push_back(j);
      j = i;
    }
    const int64_t count = (int64_t)bounds.size();
    if (count > cap) return -1;
    int32_t start = 0;
    for (int64_t k = count - 1, o = 0; k >= 0; --k, ++o) {
      out_starts[o] = off[start];
      out_ends[o] = off[bounds[(size_t)k]];
      start = bounds[(size_t)k];
    }
    return count;
  } catch (...) {
    return -1;
  }
}

double tn_lm_score(void* handle, const int32_t* ctx, int32_t ctx_len, int32_t token) {
  NGramLM* lm = static_cast<NGramLM*>(handle);
  if (!lm) return 0.0;
  return lm->score(ctx, ctx_len, token);
}

// logp: (T x V) row-major log-softmax (float32).  Writes the best label
// sequence into out (capacity out_cap) and its total log-prob into
// *out_score; returns the sequence length, or -1 on error / truncation.
// lm (nullable, from tn_lm_create) fuses lm_weight * score per extension.
int64_t tn_ctc_beam_search_lm(const float* logp, int64_t T, int64_t V,
                              int32_t blank, int32_t beam_width,
                              float prune_logp, int32_t max_tokens_per_step,
                              const void* lm, double lm_weight,
                              int32_t* out, int64_t out_cap,
                              double* out_score) {
  try {
    if (T < 0 || V <= 0 || blank < 0 || blank >= V || beam_width <= 0) return -1;
    BeamSearch bs(V, blank, beam_width, prune_logp, max_tokens_per_step);
    bs.set_scorer(lm, lm_weight);
    if (bs.wf && (int64_t)bs.wf->pieces.size() < V) return -1;
    bs.seed_root();
    bs.run(logp, T);
    auto ranked = bs.ranked_beams(/*finalize=*/true);
    if (ranked.empty()) {
      if (out_score) *out_score = kNegInf;
      return 0;
    }
    if (out_score)
      *out_score = log_add(ranked[0].second.pb, ranked[0].second.pnb);
    auto seq = bs.prefix_of(ranked[0].first);
    if (static_cast<int64_t>(seq.size()) > out_cap) return -1;
    std::copy(seq.begin(), seq.end(), out);
    return static_cast<int64_t>(seq.size());
  } catch (...) {
    return -1;
  }
}

int64_t tn_ctc_beam_search(const float* logp, int64_t T, int64_t V,
                           int32_t blank, int32_t beam_width,
                           float prune_logp, int32_t max_tokens_per_step,
                           int32_t* out, int64_t out_cap,
                           double* out_score) {
  return tn_ctc_beam_search_lm(logp, T, V, blank, beam_width, prune_logp,
                               max_tokens_per_step, nullptr, 0.0, out, out_cap,
                               out_score);
}

// Streaming variant: seeds the search with n_in carried beams (row-major
// prefixes, stride in_stride, lengths in_lens, blank/non-blank log-probs
// in_pb/in_pnb; n_in == 0 seeds the root) and, after running the window's T
// frames, writes up to beam_width surviving beams into the out arrays
// (stride out_stride).  Returns the number of beams written, or -1 on error
// (including any surviving prefix longer than out_stride).
// lm (nullable) fuses lm_weight * score per extension, seeing the FULL
// carried prefix as context — continuous shallow fusion across windows.
int64_t tn_ctc_beam_search_stream_lm(
    const float* logp, int64_t T, int64_t V, int32_t blank,
    int32_t beam_width, float prune_logp, int32_t max_tokens_per_step,
    const void* lm, double lm_weight,
    const int32_t* in_prefixes, const int32_t* in_lens,
    const double* in_pb, const double* in_pnb, int32_t n_in, int64_t in_stride,
    int32_t* out_prefixes, int32_t* out_lens, double* out_pb, double* out_pnb,
    int64_t out_stride) {
  try {
    if (T < 0 || V <= 0 || blank < 0 || blank >= V || beam_width <= 0) return -1;
    BeamSearch bs(V, blank, beam_width, prune_logp, max_tokens_per_step);
    bs.set_scorer(lm, lm_weight);
    if (bs.wf && (int64_t)bs.wf->pieces.size() < V) return -1;
    if (n_in <= 0) {
      bs.seed_root();
    } else {
      for (int32_t i = 0; i < n_in; ++i) {
        const int32_t len = in_lens[i];
        if (len < 0 || len > in_stride) return -1;
        if (!bs.seed_prefix(in_prefixes + i * in_stride, len, in_pb[i], in_pnb[i]))
          return -1;
      }
    }
    bs.run(logp, T);
    auto ranked = bs.ranked_beams();
    for (size_t i = 0; i < ranked.size(); ++i) {
      auto seq = bs.prefix_of(ranked[i].first);
      if (static_cast<int64_t>(seq.size()) > out_stride) return -1;
      std::copy(seq.begin(), seq.end(), out_prefixes + i * out_stride);
      out_lens[i] = static_cast<int32_t>(seq.size());
      out_pb[i] = ranked[i].second.pb;
      out_pnb[i] = ranked[i].second.pnb;
    }
    return static_cast<int64_t>(ranked.size());
  } catch (...) {
    return -1;
  }
}

int64_t tn_ctc_beam_search_stream(
    const float* logp, int64_t T, int64_t V, int32_t blank,
    int32_t beam_width, float prune_logp, int32_t max_tokens_per_step,
    const int32_t* in_prefixes, const int32_t* in_lens,
    const double* in_pb, const double* in_pnb, int32_t n_in, int64_t in_stride,
    int32_t* out_prefixes, int32_t* out_lens, double* out_pb, double* out_pnb,
    int64_t out_stride) {
  return tn_ctc_beam_search_stream_lm(
      logp, T, V, blank, beam_width, prune_logp, max_tokens_per_step, nullptr,
      0.0, in_prefixes, in_lens, in_pb, in_pnb, n_in, in_stride, out_prefixes,
      out_lens, out_pb, out_pnb, out_stride);
}

// Batched beam search over (B x T x V) row-major log-softmax, threaded over
// samples (the per-sample searches are independent; the LM is read-only) —
// keeps host-side beam decode off the serving critical path on many-core TPU
// host VMs.  lengths[b] gives each sample's valid frames.  Best sequences go
// to out (stride out_stride per sample), their lengths to out_lens (-1 marks
// a truncated/failed sample).  n_threads <= 0 uses hardware concurrency.
// Returns 0, or -1 on invalid arguments.
int64_t tn_ctc_beam_search_batch(
    const float* logp, int64_t B, int64_t T, int64_t V,
    const int64_t* lengths, int32_t blank, int32_t beam_width,
    float prune_logp, int32_t max_tokens_per_step,
    const void* lm, double lm_weight,
    int32_t* out, int64_t out_stride, int64_t* out_lens,
    int32_t n_threads) {
  if (B < 0 || T < 0 || V <= 0 || blank < 0 || blank >= V || beam_width <= 0)
    return -1;
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? (int32_t)hw : 1;
  }
  if ((int64_t)n_threads > B) n_threads = (int32_t)(B ? B : 1);

  std::atomic<int64_t> cursor{0};
  auto worker = [&]() {
    while (true) {
      const int64_t b = cursor.fetch_add(1);
      if (b >= B) break;
      try {
        const int64_t Tb = lengths ? lengths[b] : T;
        if (Tb < 0 || Tb > T) { out_lens[b] = -1; continue; }
        BeamSearch bs(V, blank, beam_width, prune_logp, max_tokens_per_step);
        bs.set_scorer(lm, lm_weight);
        if (bs.wf && (int64_t)bs.wf->pieces.size() < V) { out_lens[b] = -1; continue; }
        bs.seed_root();
        bs.run(logp + b * T * V, Tb);
        auto ranked = bs.ranked_beams(/*finalize=*/true);
        if (ranked.empty()) { out_lens[b] = 0; continue; }
        auto seq = bs.prefix_of(ranked[0].first);
        if ((int64_t)seq.size() > out_stride) { out_lens[b] = -1; continue; }
        std::copy(seq.begin(), seq.end(), out + b * out_stride);
        out_lens[b] = (int64_t)seq.size();
      } catch (...) {
        out_lens[b] = -1;
      }
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int32_t i = 0; i < n_threads; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FLAC decoder (subset: everything LibriSpeech-style files use)
//
// Implements the public FLAC bitstream format from the specification:
// STREAMINFO parsing, frames with fixed or variable blocking, independent /
// left-side / right-side / mid-side channel decorrelation, CONSTANT /
// VERBATIM / FIXED(0-4) / LPC subframes, rice and rice2 residual coding with
// partitions and escape codes, wasted bits. CRCs are skipped (not verified).
// ---------------------------------------------------------------------------

namespace flac {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // bits consumed in current byte
  bool error = false;

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte_pos >= size) { error = true; return 0; }
      int avail = 8 - bit_pos;
      int take = n < avail ? n : avail;
      int shift = avail - take;
      uint32_t bits = (data[byte_pos] >> shift) & ((1u << take) - 1);
      v = (v << take) | bits;
      bit_pos += take;
      n -= take;
      if (bit_pos == 8) { bit_pos = 0; ++byte_pos; }
    }
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n > 0 && (v >> (n - 1)) & 1) v |= ~((1ull << n) - 1);  // sign extend
    return (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!error && read_bits(1) == 0) {
      ++q;
      if (q > 1u << 24) { error = true; break; }
    }
    return q;
  }

  void align_byte() { if (bit_pos) { bit_pos = 0; ++byte_pos; } }
};

static int64_t rice_decode(BitReader& br, int k) {
  uint32_t q = br.read_unary();
  uint64_t r = k ? br.read_bits(k) : 0;
  uint64_t v = ((uint64_t)q << k) | r;
  return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);  // zigzag
}

// variable-length coded frame number (UTF-8 style, up to 7 bytes)
static int read_utf8_number(BitReader& br, uint64_t* out) {
  uint32_t b = (uint32_t)br.read_bits(8);
  int extra = 0;
  uint64_t v = 0;
  if ((b & 0x80) == 0) { v = b; }
  else if ((b & 0xE0) == 0xC0) { v = b & 0x1F; extra = 1; }
  else if ((b & 0xF0) == 0xE0) { v = b & 0x0F; extra = 2; }
  else if ((b & 0xF8) == 0xF0) { v = b & 0x07; extra = 3; }
  else if ((b & 0xFC) == 0xF8) { v = b & 0x03; extra = 4; }
  else if ((b & 0xFE) == 0xFC) { v = b & 0x01; extra = 5; }
  else if (b == 0xFE) { v = 0; extra = 6; }
  else return -1;
  for (int i = 0; i < extra; ++i) {
    uint32_t c = (uint32_t)br.read_bits(8);
    if ((c & 0xC0) != 0x80) return -1;
    v = (v << 6) | (c & 0x3F);
  }
  *out = v;
  return 0;
}

static int decode_residual(BitReader& br, int blocksize, int order, int64_t* out) {
  int method = (int)br.read_bits(2);
  if (method > 1) return -1;
  int plen = method == 0 ? 4 : 5;
  int escape = method == 0 ? 0xF : 0x1F;
  int porder = (int)br.read_bits(4);
  int partitions = 1 << porder;
  int idx = 0;
  for (int p = 0; p < partitions; ++p) {
    int count = blocksize >> porder;
    if (p == 0) count -= order;
    if (count < 0) return -1;
    int k = (int)br.read_bits(plen);
    if (k == escape) {
      int bits = (int)br.read_bits(5);
      for (int i = 0; i < count; ++i) out[idx++] = bits ? br.read_signed(bits) : 0;
    } else {
      for (int i = 0; i < count; ++i) out[idx++] = rice_decode(br, k);
    }
    if (br.error) return -1;
  }
  return 0;
}

static const int FIXED_COEFFS[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1},
};

static int decode_subframe(BitReader& br, int blocksize, int bps, int64_t* out) {
  if (br.read_bits(1) != 0) return -1;  // padding bit
  int type = (int)br.read_bits(6);
  int wasted = 0;
  if (br.read_bits(1)) {  // wasted bits: unary count - 1
    wasted = 1 + (int)br.read_unary();
  }
  if (wasted >= bps) return -1;  // corrupt header; avoids UB shifts below
  int ebps = bps - wasted;

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(ebps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) out[i] = br.read_signed(ebps);
  } else if (type >= 8 && type <= 12) {  // FIXED order 0..4
    int order = type - 8;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(ebps);
    std::vector<int64_t> res(blocksize);
    if (decode_residual(br, blocksize, order, res.data())) return -1;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += (int64_t)FIXED_COEFFS[order][j] * out[i - 1 - j];
      out[i] = pred + res[i - order];
    }
  } else if (type >= 32) {  // LPC, order = (type & 31) + 1
    int order = (type & 31) + 1;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(ebps);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return -1;  // invalid code 0b1111
    int shift = (int)br.read_signed(5);
    if (shift < 0) return -1;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
    std::vector<int64_t> res(blocksize);
    if (decode_residual(br, blocksize, order, res.data())) return -1;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * out[i - 1 - j];
      out[i] = (pred >> shift) + res[i - order];
    }
  } else {
    return -1;
  }
  if (wasted) {
    for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
  }
  return br.error ? -1 : 0;
}

}  // namespace flac

static int tn_load_flac_impl(const char* path, TnAudio* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize <= 0) { fclose(f); return -2; }
  std::vector<uint8_t> buf(fsize);
  if (fread(buf.data(), 1, fsize, f) != (size_t)fsize) { fclose(f); return -2; }
  fclose(f);
  if (fsize < 42 || memcmp(buf.data(), "fLaC", 4)) return -3;

  flac::BitReader br{buf.data(), (size_t)fsize};
  br.byte_pos = 4;

  // metadata blocks; STREAMINFO must be first
  uint32_t sample_rate = 0, channels = 0, bps = 0;
  uint64_t total_samples = 0;
  bool last = false, first = true;
  while (!last) {
    last = br.read_bits(1);
    uint32_t type = (uint32_t)br.read_bits(7);
    uint32_t len = (uint32_t)br.read_bits(24);
    if (first) {
      if (type != 0 || len < 34) return -4;
      br.read_bits(16);  // min blocksize
      br.read_bits(16);  // max blocksize
      br.read_bits(24);  // min framesize
      br.read_bits(24);  // max framesize
      sample_rate = (uint32_t)br.read_bits(20);
      channels = (uint32_t)br.read_bits(3) + 1;
      bps = (uint32_t)br.read_bits(5) + 1;
      total_samples = br.read_bits(36);
      br.byte_pos += 16;  // md5
      br.byte_pos += len - 34;  // tolerate oversized STREAMINFO blocks
      first = false;
    } else {
      br.byte_pos += len;
    }
    if (br.error || br.byte_pos > (size_t)fsize) return -5;
  }
  if (channels < 1 || channels > 8 || bps < 4 || bps > 32) return -6;

  std::vector<std::vector<int64_t>> pcm(channels);
  // decoded samples can never exceed ~8 per compressed byte; cap the hint so
  // a corrupt 36-bit total_samples cannot demand absurd allocations
  uint64_t reserve = total_samples ? total_samples : (uint64_t)fsize;
  uint64_t cap = (uint64_t)fsize * 8ull / (channels ? channels : 1);
  if (reserve > cap) reserve = cap;
  for (auto& ch : pcm) ch.reserve(reserve);

  static const uint32_t RATE_CODE[12] = {0, 88200, 176400, 192000, 8000, 16000,
                                         22050, 24000, 32000, 44100, 48000, 96000};
  // frames
  while (br.byte_pos < (size_t)fsize - 1) {
    uint32_t sync = (uint32_t)br.read_bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) return -7;
    br.read_bits(1);  // reserved
    br.read_bits(1);  // blocking strategy
    uint32_t bs_code = (uint32_t)br.read_bits(4);
    uint32_t sr_code = (uint32_t)br.read_bits(4);
    uint32_t ch_code = (uint32_t)br.read_bits(4);
    uint32_t ss_code = (uint32_t)br.read_bits(3);
    br.read_bits(1);  // reserved
    uint64_t frame_no;
    if (flac::read_utf8_number(br, &frame_no)) return -8;
    uint32_t blocksize;
    if (bs_code == 1) blocksize = 192;
    else if (bs_code >= 2 && bs_code <= 5) blocksize = 576u << (bs_code - 2);
    else if (bs_code == 6) blocksize = (uint32_t)br.read_bits(8) + 1;
    else if (bs_code == 7) blocksize = (uint32_t)br.read_bits(16) + 1;
    else if (bs_code >= 8) blocksize = 256u << (bs_code - 8);
    else return -9;
    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    else if (sr_code == 15) return -10;
    else if (sr_code != 0 && sr_code < 12 && sample_rate == 0) sample_rate = RATE_CODE[sr_code];
    uint32_t fbps = bps;
    static const uint32_t SS_CODE[8] = {0, 8, 12, 0, 16, 20, 24, 32};
    if (ss_code != 0 && ss_code != 3) fbps = SS_CODE[ss_code];
    br.read_bits(8);  // header crc8

    uint32_t nch = channels;
    int mode = 0;  // 0 independent, 1 left/side, 2 right/side, 3 mid/side
    if (ch_code <= 7) { nch = ch_code + 1; mode = 0; }
    else if (ch_code == 8) { nch = 2; mode = 1; }
    else if (ch_code == 9) { nch = 2; mode = 2; }
    else if (ch_code == 10) { nch = 2; mode = 3; }
    else return -11;
    if (nch != channels) return -12;

    std::vector<std::vector<int64_t>> sub(nch, std::vector<int64_t>(blocksize));
    for (uint32_t c = 0; c < nch; ++c) {
      uint32_t sbps = fbps;
      // side channels carry one extra bit
      if ((mode == 1 && c == 1) || (mode == 2 && c == 0) || (mode == 3 && c == 1)) sbps += 1;
      if (flac::decode_subframe(br, (int)blocksize, (int)sbps, sub[c].data())) return -13;
    }
    br.align_byte();
    br.byte_pos += 2;  // frame crc16
    if (br.byte_pos > (size_t)fsize) return -14;

    // stereo decorrelation
    if (mode == 1) {  // left/side: right = left - side
      for (uint32_t i = 0; i < blocksize; ++i) {
        int64_t l = sub[0][i], s = sub[1][i];
        sub[1][i] = l - s;
      }
    } else if (mode == 2) {  // right/side: left = right + side
      for (uint32_t i = 0; i < blocksize; ++i) {
        int64_t s = sub[0][i], r = sub[1][i];
        sub[0][i] = r + s;
      }
    } else if (mode == 3) {  // mid/side
      for (uint32_t i = 0; i < blocksize; ++i) {
        int64_t mid = sub[0][i], side = sub[1][i];
        mid = (mid << 1) | (side & 1);
        sub[0][i] = (mid + side) >> 1;
        sub[1][i] = (mid - side) >> 1;
      }
    }
    for (uint32_t c = 0; c < nch; ++c) {
      pcm[c].insert(pcm[c].end(), sub[c].begin(), sub[c].end());
    }
    if (total_samples && pcm[0].size() >= total_samples) break;
  }

  uint64_t frames = total_samples ? total_samples : pcm[0].size();
  if (frames > pcm[0].size()) frames = pcm[0].size();
  // a sample past the stream's bit depth comes only from a corrupt frame (the
  // CRCs are not checked): refuse it, so integer PCM stays in [-1, 1]
  const int64_t lo = -(1ll << (bps - 1)), hi = (1ll << (bps - 1)) - 1;
  for (uint32_t c = 0; c < channels; ++c)
    for (uint64_t i = 0; i < frames; ++i)
      if (pcm[c][i] < lo || pcm[c][i] > hi) return -16;
  float* data = (float*)malloc(sizeof(float) * frames * channels);
  if (!data) return -15;
  const double scale = 1.0 / (double)(1ll << (bps - 1));
  for (uint32_t c = 0; c < channels; ++c) {
    for (uint64_t i = 0; i < frames; ++i) {
      data[(uint64_t)c * frames + i] = (float)(pcm[c][i] * scale);
    }
  }
  out->data = data;
  out->channels = (int32_t)channels;
  out->frames = (int64_t)frames;
  out->sample_rate = (int32_t)sample_rate;
  return 0;
}

extern "C" int tn_load_flac(const char* path, TnAudio* out) {
  // exceptions must not cross the C ABI into ctypes (std::terminate)
  try {
    return tn_load_flac_impl(path, out);
  } catch (...) {
    return -20;
  }
}
