// Native syndrome-table enumeration.
//
// Code construction enumerates all C(n,w) error patterns by increasing
// weight w, computing each pattern's syndrome, until either a collision is
// found (unique-decoding threshold semantics — reference: css_code.py:715-735)
// or a weight cap is reached (minimum-weight decoder tables for degenerate
// codes). The loop is exponential in the distance and pure host work, so it
// is the framework's one genuinely native-code component: an incremental-XOR
// depth-first enumeration over bit-packed column syndromes, ~100x the
// Python/numpy batch path for large tables.
//
// Exposed through ctypes (no pybind11 dependency); syndromes are packed into
// at most 128 bits (r <= 128 checks), which covers surface codes to d >= 15.
//
// Build: g++ -O3 -march=native -shared -fPIC syndrome_table.cc -o libqcss.so

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct U128 {
  uint64_t lo, hi;
  bool operator==(const U128& o) const { return lo == o.lo && hi == o.hi; }
};

struct U128Hash {
  size_t operator()(const U128& v) const {
    // splitmix-style combine
    uint64_t x = v.lo ^ (v.hi * 0x9E3779B97F4A7C15ull);
    x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ull;
    x ^= x >> 27; x *= 0x94D049BB133111EBull;
    x ^= x >> 31;
    return static_cast<size_t>(x);
  }
};

struct Entry {
  U128 syndrome;
  std::vector<int32_t> support;
};

// Enumerate weight-w supports in lexicographic order, XOR-accumulating
// column syndromes. Visitor returns false to abort the whole enumeration.
template <typename Visit>
bool for_each_weight_w(const std::vector<U128>& cols, int n, int w, Visit&& visit) {
  std::vector<int32_t> idx(w);
  std::vector<U128> acc(w + 1);
  acc[0] = {0, 0};
  if (w == 0) return visit(acc[0], idx.data(), 0);
  int depth = 0;
  idx[0] = 0;
  while (depth >= 0) {
    if (idx[depth] > n - (w - depth)) {  // exhausted this level
      --depth;
      if (depth >= 0) ++idx[depth];
      continue;
    }
    const U128& c = cols[idx[depth]];
    acc[depth + 1] = {acc[depth].lo ^ c.lo, acc[depth].hi ^ c.hi};
    if (depth + 1 == w) {
      if (!visit(acc[w], idx.data(), w)) return false;
      ++idx[depth];
    } else {
      ++depth;
      idx[depth] = idx[depth - 1] + 1;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Enumerate the syndrome table of an r x n binary parity check.
//
// parity_check: row-major r*n bytes (0/1). If stop_on_collision != 0,
// enumeration halts at the first weight w where a syndrome repeats and the
// table as of weight w-1 is returned with *t_out = w - 1 (the reference's
// unique-decoding semantics). Otherwise enumeration covers all weights
// <= max_weight keeping the first (minimum-weight) error per syndrome, and
// *t_out = max_weight.
//
// Output: out_syndromes[i] (low 64 bits; out_syndromes_hi[i] high bits) and
// out_errors[i*n .. i*n+n) as a 0/1 row. cap bounds the entry count;
// returns 0 on success, -1 if cap exceeded, -2 if r > 128.
int32_t qcss_syndrome_table(
    const uint8_t* parity_check, int32_t r, int32_t n,
    int32_t max_weight, int32_t stop_on_collision,
    uint64_t* out_syndromes, uint64_t* out_syndromes_hi,
    uint8_t* out_errors, int64_t cap,
    int64_t* n_entries_out, int32_t* t_out) {
  if (r > 128) return -2;

  // Column syndromes, big-endian bit order to match the Python host path
  // (bit 0 of the syndrome integer is check row r-1).
  std::vector<U128> cols(n, U128{0, 0});
  for (int j = 0; j < n; ++j) {
    for (int i = 0; i < r; ++i) {
      if (parity_check[i * n + j] & 1) {
        int bit = r - 1 - i;  // big-endian
        if (bit < 64) cols[j].lo ^= (1ull << bit);
        else cols[j].hi ^= (1ull << (bit - 64));
      }
    }
  }

  std::unordered_map<U128, int64_t, U128Hash> table;   // committed weights
  std::vector<Entry> entries;
  int32_t t = max_weight;
  bool overflow = false;

  for (int w = 0; w <= max_weight; ++w) {
    std::unordered_map<U128, int64_t, U128Hash> w_table;
    size_t entries_before = entries.size();
    bool collided = false;

    for_each_weight_w(cols, n, w, [&](const U128& syn, const int32_t* sup, int len) {
      bool seen = table.count(syn) || w_table.count(syn);
      if (seen) {
        if (stop_on_collision) {
          collided = true;
          return false;  // abort enumeration
        }
        return true;  // keep first (minimum-weight) entry
      }
      if (static_cast<int64_t>(entries.size()) >= cap) {
        overflow = true;
        return false;
      }
      w_table.emplace(syn, static_cast<int64_t>(entries.size()));
      Entry e;
      e.syndrome = syn;
      e.support.assign(sup, sup + len);
      entries.push_back(std::move(e));
      return true;
    });

    if (overflow) return -1;
    if (collided) {
      entries.resize(entries_before);  // discard the partial weight-w layer
      t = w - 1;
      break;
    }
    for (auto& kv : w_table) table.emplace(kv.first, kv.second);
  }

  for (size_t i = 0; i < entries.size(); ++i) {
    out_syndromes[i] = entries[i].syndrome.lo;
    out_syndromes_hi[i] = entries[i].syndrome.hi;
    uint8_t* row = out_errors + static_cast<int64_t>(i) * n;
    std::memset(row, 0, n);
    for (int32_t q : entries[i].support) row[q] = 1;
  }
  *n_entries_out = static_cast<int64_t>(entries.size());
  *t_out = t;
  return 0;
}

// GF(2) reduced row echelon form of an m x n 0/1 matrix, in place.
// Bit-packed words internally; matches the canonical form of the
// Python host path (reference: bin_matrix.py:8-34). Returns the rank.
int32_t qcss_rref(uint8_t* mat, int32_t m, int32_t n) {
  const int W = (n + 63) / 64;
  std::vector<uint64_t> rows(static_cast<size_t>(m) * W, 0);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j)
      if (mat[i * n + j] & 1) rows[i * W + j / 64] |= (1ull << (j % 64));

  int rank = 0;
  for (int c = 0; c < n && rank < m; ++c) {
    const int wc = c / 64;
    const uint64_t bc = 1ull << (c % 64);
    int pivot = -1;
    for (int i = rank; i < m; ++i) {
      if (rows[i * W + wc] & bc) { pivot = i; break; }
    }
    if (pivot < 0) continue;
    if (!(rows[rank * W + wc] & bc)) {
      for (int k = 0; k < W; ++k) rows[rank * W + k] ^= rows[pivot * W + k];
    }
    for (int i = 0; i < m; ++i) {
      if (i != rank && (rows[i * W + wc] & bc)) {
        for (int k = 0; k < W; ++k) rows[i * W + k] ^= rows[rank * W + k];
      }
    }
    ++rank;
  }

  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j)
      mat[i * n + j] = (rows[i * W + j / 64] >> (j % 64)) & 1;
  return rank;
}

}  // extern "C"
