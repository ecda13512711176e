// Batched OSD-0 (order-0 ordered-statistics) post-processor for the BP
// decoder's unconverged tail, host-native. The reference has no
// soft-decision decoding of any kind (its decoder is the emitted
// syndrome-table scan, reference: css_code.py:649-685); this kernel is the
// fast form of qcss_tpu/decode/bp.py::BPDecoder._osd0 and must stay
// BIT-IDENTICAL to it: sort columns most-suspect-first (ascending final
// LLR, ties broken by column index — a stable sort), GF(2)-eliminate the
// column-permuted augmented system to the first independent column set,
// read the solution off the syndrome column with every non-pivot variable
// at zero, and undo the permutation.
//
// The Python loop costs minutes per thousand shots on circuit-level Tanner
// graphs (n ~ 10^4 variables); this runs the same elimination on packed
// 64-bit rows in C++, threaded across shots.
//
// Layout: h [r, n] uint8 row-major (shared across the batch), synd [B, r]
// uint8, soft [B, n] float32 (BP's final LLR totals), out [B, n] uint8.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

namespace {

struct OsdProblem {
  const uint8_t* h;      // [r, n]
  const uint8_t* synd;   // [B, r]
  const float* soft;     // [B, n]
  uint8_t* out;          // [B, n]
  int32_t r, n;
  int64_t batch;
  // OSD-E (combination sweep): consider flipping subsets of the most
  // suspect non-pivot columns and keep the least-soft-weight solution.
  // osd_order 0 = plain OSD-0; 1 = single flips among the first
  // `lam1` non-pivot columns; 2 = additionally all pairs among the
  // first `lam2`.
  int32_t osd_order = 0;
  int32_t lam1 = 0;
  int32_t lam2 = 0;
};

void decode_range(const OsdProblem& p, int64_t lo, int64_t hi) {
  const int32_t r = p.r, n = p.n;
  const int32_t words = (n + 1 + 63) / 64;  // + syndrome column
  std::vector<int32_t> order(n);
  std::vector<uint64_t> aug;             // [r, words]
  std::vector<int32_t> piv_rows, piv_cols;
  piv_rows.reserve(r);
  piv_cols.reserve(r);

  for (int64_t bi = lo; bi < hi; ++bi) {
    const float* soft = p.soft + bi * n;
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int32_t a, int32_t b) { return soft[a] < soft[b]; });

    // pack h[:, order] | synd into little-endian 64-bit words per row
    aug.assign((size_t)r * words, 0);
    for (int32_t row = 0; row < r; ++row) {
      const uint8_t* hrow = p.h + (size_t)row * n;
      uint64_t* arow = aug.data() + (size_t)row * words;
      for (int32_t c = 0; c < n; ++c) {
        if (hrow[order[c]]) arow[c >> 6] |= 1ull << (c & 63);
      }
      if (p.synd[bi * r + row]) arow[n >> 6] |= 1ull << (n & 63);
    }

    piv_rows.clear();
    piv_cols.clear();
    int32_t row = 0;
    for (int32_t c = 0; c < n && row < r; ++c) {
      const int32_t w = c >> 6;
      const uint64_t bit = 1ull << (c & 63);
      int32_t pr = -1;
      for (int32_t i = row; i < r; ++i) {
        if (aug[(size_t)i * words + w] & bit) {
          pr = i;
          break;
        }
      }
      if (pr < 0) continue;
      if (pr != row) {
        std::swap_ranges(aug.begin() + (size_t)row * words,
                         aug.begin() + (size_t)(row + 1) * words,
                         aug.begin() + (size_t)pr * words);
      }
      const uint64_t* prow = aug.data() + (size_t)row * words;
      for (int32_t i = 0; i < r; ++i) {
        if (i == row) continue;
        uint64_t* irow = aug.data() + (size_t)i * words;
        if (irow[w] & bit) {
          for (int32_t k = 0; k < words; ++k) irow[k] ^= prow[k];
        }
      }
      piv_rows.push_back(row);
      piv_cols.push_back(c);
      ++row;
    }

    uint8_t* out = p.out + bi * n;
    std::memset(out, 0, n);
    const int32_t sw = n >> 6;
    const uint64_t sbit = 1ull << (n & 63);
    const int32_t rank = (int32_t)piv_rows.size();
    if (p.osd_order <= 0 || rank == 0) {
      for (int32_t i = 0; i < rank; ++i) {
        if (aug[(size_t)piv_rows[i] * words + sw] & sbit) {
          out[order[piv_cols[i]]] = 1;
        }
      }
      continue;
    }

    // ---- OSD-E combination sweep -------------------------------------
    // After RREF, ANY assignment of the non-pivot (free) columns F has
    // the unique completion pivot_i = s~_i XOR (XOR_{c in F} aug[i, c]).
    // Candidates: the empty set (OSD-0), single flips among the lam1
    // most suspect free columns, and (order >= 2) pairs among the first
    // lam2. Keep the least SOFT-WEIGHT solution — sum of |soft| over the
    // support (the reliability metric OSD orders by); strict < keeps
    // OSD-0 on ties.
    std::vector<int32_t> free_cols;   // permuted free cols, ascending LLR
    {
      std::vector<uint8_t> is_piv(n, 0);
      for (int32_t c : piv_cols) is_piv[c] = 1;
      const int32_t lam_max = std::max(p.lam1, p.lam2);
      for (int32_t c = 0; c < n && (int32_t)free_cols.size() < lam_max; ++c)
        if (!is_piv[c]) free_cols.push_back(c);
    }
    // pivot-row weights and free-column bit masks over pivot rows
    std::vector<float> w_piv(rank);
    for (int32_t i = 0; i < rank; ++i)
      w_piv[i] = std::abs(soft[order[piv_cols[i]]]);
    const int32_t pwords = (rank + 63) / 64;
    std::vector<uint64_t> sv(pwords, 0), col_bits;
    for (int32_t i = 0; i < rank; ++i)
      if (aug[(size_t)piv_rows[i] * words + sw] & sbit)
        sv[i >> 6] |= 1ull << (i & 63);
    col_bits.assign(free_cols.size() * pwords, 0);
    for (size_t f = 0; f < free_cols.size(); ++f) {
      const int32_t c = free_cols[f], w = c >> 6;
      const uint64_t bit = 1ull << (c & 63);
      for (int32_t i = 0; i < rank; ++i)
        if (aug[(size_t)piv_rows[i] * words + w] & bit)
          col_bits[f * pwords + (i >> 6)] |= 1ull << (i & 63);
    }
    auto piv_weight = [&](const uint64_t* bits) {
      float w = 0.0f;
      for (int32_t wd = 0; wd < pwords; ++wd) {
        uint64_t x = bits[wd];
        while (x) {
          const int32_t b = __builtin_ctzll(x);
          w += w_piv[(wd << 6) + b];
          x &= x - 1;
        }
      }
      return w;
    };
    float best = piv_weight(sv.data());
    int32_t best_f1 = -1, best_f2 = -1;
    std::vector<uint64_t> tmp(pwords);
    auto try_flip = [&](int32_t f1, int32_t f2) {
      float w = std::abs(soft[order[free_cols[f1]]]);
      if (f2 >= 0) w += std::abs(soft[order[free_cols[f2]]]);
      if (w >= best) return;  // flips alone already heavier
      for (int32_t wd = 0; wd < pwords; ++wd) {
        tmp[wd] = sv[wd] ^ col_bits[f1 * pwords + wd];
        if (f2 >= 0) tmp[wd] ^= col_bits[f2 * pwords + wd];
      }
      w += piv_weight(tmp.data());
      if (w < best) { best = w; best_f1 = f1; best_f2 = f2; }
    };
    const int32_t n_free = (int32_t)free_cols.size();
    for (int32_t f = 0; f < std::min(p.lam1, n_free); ++f)
      try_flip(f, -1);
    if (p.osd_order >= 2)
      for (int32_t f1 = 0; f1 < std::min(p.lam2, n_free); ++f1)
        for (int32_t f2 = f1 + 1; f2 < std::min(p.lam2, n_free); ++f2)
          try_flip(f1, f2);
    for (int32_t wd = 0; wd < pwords; ++wd) {
      tmp[wd] = sv[wd];
      if (best_f1 >= 0) tmp[wd] ^= col_bits[best_f1 * pwords + wd];
      if (best_f2 >= 0) tmp[wd] ^= col_bits[best_f2 * pwords + wd];
    }
    for (int32_t i = 0; i < rank; ++i)
      if (tmp[i >> 6] & (1ull << (i & 63))) out[order[piv_cols[i]]] = 1;
    if (best_f1 >= 0) out[order[free_cols[best_f1]]] = 1;
    if (best_f2 >= 0) out[order[free_cols[best_f2]]] = 1;
  }
}

}  // namespace

namespace {

int32_t run_batch(OsdProblem& p, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || p.batch <= 1) {
    decode_range(p, 0, p.batch);
    return 0;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (p.batch + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(p.batch, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([&p, lo, hi] { decode_range(p, lo, hi); });
  }
  for (auto& th : ts) th.join();
  return 0;
}

}  // namespace

// Order-E ordered statistics (combination sweep over the most suspect
// free columns); osd_order=0 degrades to exactly qcss_osd0_batch.
extern "C" int32_t qcss_osde_batch(const uint8_t* h, int32_t r, int32_t n,
                                   const uint8_t* synd, const float* soft,
                                   int64_t batch, uint8_t* out,
                                   int32_t n_threads, int32_t osd_order,
                                   int32_t lam1, int32_t lam2) {
  if (r <= 0 || n <= 0 || batch < 0) return 1;
  OsdProblem p{h, synd, soft, out, r, n, batch, osd_order, lam1, lam2};
  return run_batch(p, n_threads);
}

extern "C" int32_t qcss_osd0_batch(const uint8_t* h, int32_t r, int32_t n,
                                   const uint8_t* synd, const float* soft,
                                   int64_t batch, uint8_t* out,
                                   int32_t n_threads) {
  if (r <= 0 || n <= 0 || batch < 0) return 1;
  OsdProblem p{h, synd, soft, out, r, n, batch};
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || batch <= 1) {
    decode_range(p, 0, batch);
    return 0;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (batch + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(batch, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([&p, lo, hi] { decode_range(p, lo, hi); });
  }
  for (auto& th : ts) th.join();
  return 0;
}
