// No-LM CTC prefix-beam block advance: the hot loop of
// lcasr_torch/decoding/beam_search.py:BeamSearch.advance in C++ (the port's
// copy of lcasr_tpu/native/beam_native.cpp, behind a plain C interface
// instead of the CPython one).
//
// The semantics are the Python path's exactly: the same double-precision
// logsumexp in the same order, the Python dict's insertion order for
// merges, the stable ranking of `sorted(key=-score)`, the pad filter, and
// beams carried unchanged over a frame with no candidate.  The Python path
// is the parity oracle (tests/test_torch_port_beam.py) and the LM-fused path.
//
// Interface: flat arrays in, a result handle out (a size-then-fill pair):
//   h = beam_advance(n_beams, tokens, token_offsets, p_b, p_nb, frames,
//                    frame_offsets, log_probs, T, C, t0, blank, pad,
//                    threshold, width, prune_less_than, has_prune);
//   beam_result_sizes(h, &n_beams, &n_tokens, &n_frames);
//   beam_result_fill(h, tokens, token_offsets, p_b, p_nb, frames,
//                    frame_offsets);  // buffers of those sizes (+1 offsets)
//   beam_result_free(h);
// Beam i's prefix is tokens[token_offsets[i] .. token_offsets[i+1]), its
// emission frames frames[frame_offsets[i] .. frame_offsets[i+1]).
// `log_probs` is a C-contiguous float32 (T, C) buffer; pad -1 = no pad
// filter.  beam_advance returns null only if it runs out of memory.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC (lcasr_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <memory>
#include <new>
#include <unordered_map>
#include <vector>

namespace {

constexpr double LOG0 = -1e30;

// exactly beam_search._logsumexp (math.log / math.exp are the platform libm
// double routines, as std::log / std::exp are here)
inline double lse(double a, double b) {
  if (a <= LOG0 / 2) return b;
  if (b <= LOG0 / 2) return a;
  double m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

// prefix trie: a node id names a prefix; id 0 is the empty prefix
struct TrieNode {
  int parent;
  int token;
  int depth;
};

// immutable cons list of per-token emission frames: copies are pointer
// copies, made into arrays only for the returned beams
struct FNode {
  std::shared_ptr<const FNode> parent;
  int t;
};
using FPtr = std::shared_ptr<const FNode>;

inline FPtr fcons(const FPtr& parent, int t) {
  auto n = std::make_shared<FNode>();
  n->parent = parent;
  n->t = t;
  return FPtr(n);
}

struct BeamState {
  int node;     // trie id of the prefix
  double p_b;   // log mass ending in blank
  double p_nb;  // log mass ending in the last token
  FPtr frames;  // emission frame of each token
};

struct NewBeam {
  int node;
  double p_b;
  double p_nb;
  double best_contrib;
  FPtr frames;
};

struct Trie {
  std::vector<TrieNode> nodes;
  std::unordered_map<uint64_t, int> children;

  Trie() { nodes.push_back({-1, -1, 0}); }

  int child(int parent, int token) {
    uint64_t key = (static_cast<uint64_t>(static_cast<uint32_t>(parent)) << 32) |
                   static_cast<uint32_t>(token);
    auto it = children.find(key);
    if (it != children.end()) return it->second;
    int id = static_cast<int>(nodes.size());
    nodes.push_back({parent, token, nodes[parent].depth + 1});
    children.emplace(key, id);
    return id;
  }
};

struct Result {
  std::vector<int> tokens;
  std::vector<int64_t> token_offsets;
  std::vector<double> p_b;
  std::vector<double> p_nb;
  std::vector<int> frames;
  std::vector<int64_t> frame_offsets;
};

Result* advance(int64_t n_in, const int* in_tokens, const int64_t* in_token_off,
                const double* in_pb, const double* in_pnb, const int* in_frames,
                const int64_t* in_frame_off, const float* lp, int64_t T, int64_t C,
                int64_t t0, int blank, int pad, double threshold, int width,
                double prune_val, bool has_prune) {
  // ---- intern the incoming beams ----
  Trie trie;
  std::vector<BeamState> beams;
  beams.reserve(n_in);
  for (int64_t i = 0; i < n_in; i++) {
    int node = 0;
    for (int64_t k = in_token_off[i]; k < in_token_off[i + 1]; k++)
      node = trie.child(node, in_tokens[k]);
    FPtr fr;
    for (int64_t k = in_frame_off[i]; k < in_frame_off[i + 1]; k++)
      fr = fcons(fr, in_frames[k]);
    beams.push_back({node, in_pb[i], in_pnb[i], fr});
  }

  // ---- the frame loop ----
  std::vector<int> keep;
  std::vector<NewBeam> nb;
  std::unordered_map<int, int> slot;  // trie node -> index into nb
  std::vector<int> order;             // stable-sort scratch

  // upd(): merge a contribution into the new-beam set with the Python
  // dict's semantics (the first insertion fixes the position) and the
  // frames-follow-the-strongest-contribution rule
  auto upd = [&](int node, const FPtr& frames, double p_blank, double p_non_blank) {
    auto it = slot.find(node);
    int idx;
    if (it == slot.end()) {
      idx = static_cast<int>(nb.size());
      slot.emplace(node, idx);
      nb.push_back({node, LOG0, LOG0, LOG0, frames});
    } else {
      idx = it->second;
    }
    NewBeam& b = nb[idx];
    b.p_b = lse(b.p_b, p_blank);
    b.p_nb = lse(b.p_nb, p_non_blank);
    double contrib = lse(p_blank, p_non_blank);
    if (contrib > b.best_contrib) {
      b.best_contrib = contrib;
      b.frames = frames;
    }
  };

  for (int64_t tl = 0; tl < T; tl++) {
    const float* frame = lp + tl * C;
    const int t = static_cast<int>(t0 + tl);
    float maxv = frame[0];
    for (int64_t c = 1; c < C; c++)
      if (frame[c] > maxv) maxv = frame[c];
    // numpy: float32 scalar + Python float promotes weakly -> float32
    const float thr = maxv + static_cast<float>(threshold);
    keep.clear();
    for (int64_t c = 0; c < C; c++)
      if (frame[c] > thr && static_cast<int>(c) != pad) keep.push_back(static_cast<int>(c));
    // no candidate survived: carry the beams unchanged (the Python guard)
    if (keep.empty()) continue;

    nb.clear();
    slot.clear();
    for (const BeamState& beam : beams) {
      const int last = beam.node == 0 ? -1 : trie.nodes[beam.node].token;
      const double am = lse(beam.p_b, beam.p_nb);
      for (int c : keep) {
        const double p = static_cast<double>(frame[c]);
        if (c == blank) {
          upd(beam.node, beam.frames, am + p, LOG0);
        } else if (c == last) {
          // a repeat collapses into the same prefix...
          upd(beam.node, beam.frames, LOG0, beam.p_nb + p);
          // ...or extends it after an explicit blank
          upd(trie.child(beam.node, c), fcons(beam.frames, t), LOG0, beam.p_b + p);
        } else {
          upd(trie.child(beam.node, c), fcons(beam.frames, t), LOG0, am + p);
        }
      }
    }

    // rank: stable sort by score, descending == Python sorted(key=-score)
    order.resize(nb.size());
    for (size_t i = 0; i < order.size(); i++) order[i] = static_cast<int>(i);
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
      return lse(nb[a].p_b, nb[a].p_nb) > lse(nb[b].p_b, nb[b].p_nb);
    });
    size_t n_keep = std::min(order.size(), static_cast<size_t>(width));
    beams.clear();
    double cut = LOG0;
    if (has_prune && n_keep > 0) {
      const NewBeam& top = nb[order[0]];
      cut = lse(top.p_b, top.p_nb) - prune_val;
    }
    for (size_t k = 0; k < n_keep; k++) {
      const NewBeam& b = nb[order[k]];
      // Python filters the whole truncated list (not a cut at the first
      // miss): equal scores at the boundary make the filter the exact form
      if (has_prune && !(lse(b.p_b, b.p_nb) >= cut)) continue;
      beams.push_back({b.node, b.p_b, b.p_nb, b.frames});
    }
  }

  // ---- the surviving beams, as flat arrays ----
  Result* out = new Result;
  out->token_offsets.push_back(0);
  out->frame_offsets.push_back(0);
  std::vector<int> toks, frs;
  for (const BeamState& b : beams) {
    toks.clear();
    for (int node = b.node; node != 0; node = trie.nodes[node].parent)
      toks.push_back(trie.nodes[node].token);
    std::reverse(toks.begin(), toks.end());
    frs.clear();
    for (const FNode* f = b.frames.get(); f; f = f->parent.get()) frs.push_back(f->t);
    std::reverse(frs.begin(), frs.end());
    out->tokens.insert(out->tokens.end(), toks.begin(), toks.end());
    out->token_offsets.push_back(static_cast<int64_t>(out->tokens.size()));
    out->frames.insert(out->frames.end(), frs.begin(), frs.end());
    out->frame_offsets.push_back(static_cast<int64_t>(out->frames.size()));
    out->p_b.push_back(b.p_b);
    out->p_nb.push_back(b.p_nb);
  }
  return out;
}

}  // namespace

extern "C" {

void* beam_advance(int64_t n_beams, const int* tokens, const int64_t* token_offsets,
                   const double* p_b, const double* p_nb, const int* frames,
                   const int64_t* frame_offsets, const float* log_probs, int64_t T,
                   int64_t C, int64_t t0, int blank, int pad, double threshold, int width,
                   double prune_less_than, int has_prune) {
  try {
    return advance(n_beams, tokens, token_offsets, p_b, p_nb, frames, frame_offsets,
                   log_probs, T, C, t0, blank, pad, threshold, width, prune_less_than,
                   has_prune != 0);
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

void beam_result_sizes(const void* handle, int64_t* n_beams, int64_t* n_tokens,
                       int64_t* n_frames) {
  const Result* r = static_cast<const Result*>(handle);
  *n_beams = static_cast<int64_t>(r->p_b.size());
  *n_tokens = static_cast<int64_t>(r->tokens.size());
  *n_frames = static_cast<int64_t>(r->frames.size());
}

void beam_result_fill(const void* handle, int* tokens, int64_t* token_offsets, double* p_b,
                      double* p_nb, int* frames, int64_t* frame_offsets) {
  const Result* r = static_cast<const Result*>(handle);
  std::copy(r->tokens.begin(), r->tokens.end(), tokens);
  std::copy(r->token_offsets.begin(), r->token_offsets.end(), token_offsets);
  std::copy(r->p_b.begin(), r->p_b.end(), p_b);
  std::copy(r->p_nb.begin(), r->p_nb.end(), p_nb);
  std::copy(r->frames.begin(), r->frames.end(), frames);
  std::copy(r->frame_offsets.begin(), r->frame_offsets.end(), frame_offsets);
}

void beam_result_free(void* handle) { delete static_cast<Result*>(handle); }

}  // extern "C"
