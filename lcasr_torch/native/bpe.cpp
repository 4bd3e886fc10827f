// The BPE merge loop of lcasr_torch/data/tokenizer.py behind a plain C API
// (the port's copy of lcasr_tpu/native/bpe_native.cpp, which is a CPython
// extension): greedy best-score merging over a doubly linked symbol list
// with a lazy heap agenda, ties broken by position as the Python loop's
// heap of (-score, left, right) breaks them.  The ids equal the Python
// loop's on every input (tests/test_torch_port_host.py).
//
// Built by lcasr_torch/native/__init__.py with g++ -O2 -shared -fPIC.

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  // pieces matchable from text (not CONTROL / UNUSED), and every piece for
  // the per-character fallback; a surface listed twice maps to its last id,
  // as a Python dict built in order does
  std::unordered_map<std::string, int> match;
  std::unordered_map<std::string, int> all;
  std::vector<double> scores;
  int unk_id;
};

struct Candidate {
  double neg_score;
  int left, right;
  std::string merged;
  bool operator>(const Candidate& o) const {
    if (neg_score != o.neg_score) return neg_score > o.neg_score;
    if (left != o.left) return left > o.left;
    if (right != o.right) return right > o.right;
    return merged > o.merged;
  }
};

// UTF-8 code points (a malformed tail byte stands alone)
std::vector<std::string> utf8_chars(const char* s, int64_t n) {
  std::vector<std::string> out;
  int64_t i = 0;
  while (i < n) {
    const unsigned char c = static_cast<unsigned char>(s[i]);
    int len = 1;
    if ((c & 0xE0) == 0xC0) len = 2;
    else if ((c & 0xF0) == 0xE0) len = 3;
    else if ((c & 0xF8) == 0xF0) len = 4;
    if (i + len > n) len = 1;
    out.emplace_back(s + i, len);
    i += len;
  }
  return out;
}

// Ids of one normalised text (spaces already U+2581), appended to `ids`.
void encode(const Tokenizer& tok, const char* text, int64_t len, std::vector<int32_t>& ids) {
  std::vector<std::string> sym = utf8_chars(text, len);
  const int n = static_cast<int>(sym.size());
  if (n == 0) return;
  std::vector<int> nxt(n), prv(n);
  std::vector<char> alive(n, 1);
  for (int i = 0; i < n; ++i) {
    nxt[i] = i + 1 < n ? i + 1 : -1;
    prv[i] = i - 1;
  }
  std::priority_queue<Candidate, std::vector<Candidate>, std::greater<>> heap;
  auto push = [&](int i) {
    if (i < 0) return;
    const int j = nxt[i];
    if (j < 0) return;
    std::string merged = sym[i] + sym[j];
    auto it = tok.match.find(merged);
    if (it != tok.match.end()) heap.push({-tok.scores[it->second], i, j, std::move(merged)});
  };
  for (int i = 0; i + 1 < n; ++i) push(i);
  while (!heap.empty()) {
    Candidate c = heap.top();
    heap.pop();
    const int i = c.left, j = c.right;
    if (!alive[i] || !alive[j] || nxt[i] != j) continue;
    if (sym[i].size() + sym[j].size() != c.merged.size() ||
        c.merged.compare(0, sym[i].size(), sym[i]) != 0 ||
        c.merged.compare(sym[i].size(), sym[j].size(), sym[j]) != 0)
      continue;  // stale agenda entry
    sym[i] = std::move(c.merged);
    alive[j] = 0;
    nxt[i] = nxt[j];
    if (nxt[j] >= 0) prv[nxt[j]] = i;
    push(prv[i] >= 0 && alive[prv[i]] ? prv[i] : -1);
    push(i);
  }
  for (int i = 0; i != -1; i = nxt[i]) {
    if (!alive[i]) continue;
    auto it = tok.match.find(sym[i]);
    if (it != tok.match.end()) {
      ids.push_back(it->second);
      continue;
    }
    for (const std::string& ch : utf8_chars(sym[i].data(), sym[i].size())) {
      auto ct = tok.all.find(ch);
      ids.push_back(ct != tok.all.end() ? ct->second : tok.unk_id);
    }
  }
}

int64_t copy_out(const std::vector<int32_t>& ids, int32_t* out, int64_t cap) {
  const int64_t n = static_cast<int64_t>(ids.size());
  if (n <= cap) std::memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

}  // namespace

extern "C" {

// n pieces: piece i is buf[offsets[i] : offsets[i + 1]] (UTF-8), its score
// scores[i], matchable[i] != 0 unless it is a CONTROL or UNUSED piece.
void* bpe_init(const char* buf, const int64_t* offsets, int n, const double* scores,
               const uint8_t* matchable, int unk_id) {
  auto* tok = new Tokenizer();
  tok->scores.assign(scores, scores + n);
  tok->unk_id = unk_id;
  for (int i = 0; i < n; ++i) {
    std::string piece(buf + offsets[i], offsets[i + 1] - offsets[i]);
    if (matchable[i]) tok->match[piece] = i;
    tok->all[piece] = i;
  }
  return tok;
}

// Ids of one text into out[0 : cap]; returns their count, which is the
// capacity needed when it is larger than cap (nothing is written then).
int64_t bpe_encode(void* handle, const char* text, int64_t len, int32_t* out, int64_t cap) {
  std::vector<int32_t> ids;
  encode(*static_cast<Tokenizer*>(handle), text, len, ids);
  return copy_out(ids, out, cap);
}

// n texts, text i at buf[offsets[i] : offsets[i + 1]]: their ids one after
// the other into out[0 : cap] and the count of each into counts[i];
// returns the total (the capacity needed; the ids are not written when it
// is larger than cap).  A text's ids are at most its code points, so a
// capacity of offsets[n] always suffices.
int64_t bpe_encode_batch(void* handle, const char* buf, const int64_t* offsets, int n,
                         int32_t* out, int64_t cap, int64_t* counts) {
  const auto& tok = *static_cast<Tokenizer*>(handle);
  std::vector<int32_t> ids;
  for (int i = 0; i < n; ++i) {
    const size_t before = ids.size();
    encode(tok, buf + offsets[i], offsets[i + 1] - offsets[i], ids);
    counts[i] = static_cast<int64_t>(ids.size() - before);
  }
  return copy_out(ids, out, cap);
}

void bpe_free(void* handle) { delete static_cast<Tokenizer*>(handle); }

}  // extern "C"
