// Native fuzzy caption-token matcher for the offline data-prep pipeline.
//
// The reference encodes captions by matching each caption entity/fact token
// against every context name with joined-decimal substring containment
// (geo-aware/create_input_files.py:226-249,
//  knowledge-aware/create_input_files.py:300-328) — a quadratic host loop
// that dominates create_input_files wall-time on real datasets.  This
// translation unit implements the same containment semantics (including the
// '^'-joined decimal-string quirks) over the packed 50-char name arrays.
//
// Exposed via a C ABI for ctypes; built by icek_torch/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kNameWidth = 50;

// Build the reference's comparison key: decimal char codes joined with '^',
// skipping the pad code.
std::string joined_key(const int32_t* chars, int width, int32_t pad) {
  std::string out;
  out.reserve(width * 4);
  bool first = true;
  for (int i = 0; i < width; ++i) {
    if (chars[i] == pad) continue;
    if (!first) out.push_back('^');
    out += std::to_string(chars[i]);
    first = false;
  }
  return out;
}

bool contains(const std::string& hay, const std::string& needle) {
  return hay.find(needle) != std::string::npos;
}

}  // namespace

extern "C" {

// Returns the key-array row of the longest fuzzy match, or -1.
//
//   query:     kNameWidth char codes for the caption token
//   keys:      n_keys x kNameWidth packed name chars (dedup'd context names)
//   allowed:   optional n_keys 0/1 mask (nullptr = all allowed)
//   pad:       pad char code (124)
//
// Match rule: key matches iff key_str is a substring of query_str or vice
// versa; the longest key_str wins; the FIRST row achieving the maximum wins
// ties (dict iteration order in the reference).
int64_t icek_fuzzy_lookup(const int32_t* query,
                          const int32_t* keys,
                          const uint8_t* allowed,
                          int64_t n_keys,
                          int32_t pad) {
  const std::string q = joined_key(query, kNameWidth, pad);
  int64_t best = -1;
  size_t best_len = 0;
  for (int64_t k = 0; k < n_keys; ++k) {
    if (allowed != nullptr && !allowed[k]) continue;
    const std::string key = joined_key(keys + k * kNameWidth, kNameWidth, pad);
    if (!(contains(q, key) || contains(key, q))) continue;
    if (key.size() > best_len) {
      best_len = key.size();
      best = k;
    }
  }
  return best;
}

// Batch variant: match m queries against the same key set, writing results
// into out (m int64s).  allowed may be nullptr or m x n_keys row-major.
void icek_fuzzy_lookup_batch(const int32_t* queries,
                             int64_t n_queries,
                             const int32_t* keys,
                             const uint8_t* allowed,
                             int64_t n_keys,
                             int32_t pad,
                             int64_t* out) {
  // Pre-join the keys once — the inner loop is then pure substring search.
  std::vector<std::string> key_strs(n_keys);
  for (int64_t k = 0; k < n_keys; ++k) {
    key_strs[k] = joined_key(keys + k * kNameWidth, kNameWidth, pad);
  }
  for (int64_t qi = 0; qi < n_queries; ++qi) {
    const std::string q =
        joined_key(queries + qi * kNameWidth, kNameWidth, pad);
    const uint8_t* row_allowed =
        allowed == nullptr ? nullptr : allowed + qi * n_keys;
    int64_t best = -1;
    size_t best_len = 0;
    for (int64_t k = 0; k < n_keys; ++k) {
      if (row_allowed != nullptr && !row_allowed[k]) continue;
      const std::string& key = key_strs[k];
      if (!(contains(q, key) || contains(key, q))) continue;
      if (key.size() > best_len) {
        best_len = key.size();
        best = k;
      }
    }
    out[qi] = best;
  }
}

}  // extern "C"
