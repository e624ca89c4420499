// Host-side Smith-Waterman runtime: maximum selection, CIGAR backtrack walk
// and a full scalar aligner used as the long-sequence fallback.
//
// Semantics re-derived from the reference kernel (PairWiseSW.h:65-451); the
// device kernel (ops/sw.py) produces the packed backtrack matrix and
// boundary score rows, this code finishes the O(n+m) sequential part —
// the TPU-native split of GKL's getCIGAR (device DP + host walk).
//
// Built as a plain shared library; called through ctypes.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kMatch = 0;
constexpr int kInsert = 1;
constexpr int kDelete = 2;
constexpr int kInsertExt = 4;
constexpr int kDeleteExt = 8;
constexpr int kSoftclip = 9;
constexpr int kIndel = 10;
constexpr int kLeadingIndel = 11;
constexpr int kIgnore = 12;
constexpr int32_t kMinCutoff = -100000000;
constexpr int32_t kLowInit = INT32_MIN / 2;

struct MaxSel {
  int32_t score;
  int32_t max_i;
  int32_t max_j;
};

// Anti-diagonal-ordered maximum selection with diagonal-proximity tie-breaks.
MaxSel select_max(const int32_t* lastrow, const int32_t* lastcol, int n, int m,
                  int strategy) {
  MaxSel s{INT32_MIN, 0, 0};
  const bool track_lastrow = strategy == kSoftclip || strategy == kIgnore;
  for (int d = 1; d <= n + m; ++d) {
    if (d >= n + 1 && track_lastrow) {
      int j0 = d - n;
      if (j0 >= 1 && j0 <= m) {
        int32_t sc = lastrow[j0 - 1];
        int di = n - j0;
        if (s.score < sc ||
            (s.score == sc && (di < 0 ? -di : di) < (s.max_i - s.max_j < 0
                                                         ? s.max_j - s.max_i
                                                         : s.max_i - s.max_j))) {
          s.score = sc;
          s.max_i = n;
          s.max_j = j0;
        }
      }
    }
    if (d >= m + 1) {
      int i0 = d - m;
      if (i0 >= 1 && i0 <= n) {
        int32_t sc = lastcol[i0 - 1];
        int di = i0 - m;
        int cur = s.max_i - s.max_j;
        if (s.score < sc ||
            (s.score == sc &&
             (s.max_j == m || (di < 0 ? -di : di) <= (cur < 0 ? -cur : cur)))) {
          s.score = sc;
          s.max_i = i0;
          s.max_j = m;
        }
      }
    }
  }
  return s;
}

// Backtrack walk + run-length encoding + overhang tails.  `bt` is row-major
// with `stride` BYTES per (packed) row.  Unpacked: cell (i, j) at
// bt[(i-1)*stride + (j-1)].  Packed (`packed` != 0): two 4-bit codes per
// byte along ROWS — row i-1 lives in packed row (i-1)/2, low nibble for
// even row index, high nibble for odd.
int walk_cigar(const uint8_t* bt, int n, int m, long stride, int packed,
               int max_i, int max_j, int strategy, char* cigar_out,
               int cigar_cap, int32_t* offset_out) {
  auto code_at = [&](int i, int j) -> int {
    if (!packed) return bt[(size_t)(i - 1) * (size_t)stride + (j - 1)];
    uint8_t b = bt[(size_t)((i - 1) >> 1) * (size_t)stride + (j - 1)];
    return ((i - 1) & 1) ? (b >> 4) : (b & 0xF);
  };
  std::vector<int32_t> ops;
  ops.reserve(2 * (n + m) + 4);
  auto push = [&](int op, int cnt) {
    ops.push_back(op);
    ops.push_back(cnt);
  };

  int i, j;
  if (strategy == kIndel) {
    i = n;
    j = m;
  } else if (strategy == kLeadingIndel) {
    i = max_i;
    j = m;
  } else {
    i = max_i;
    j = max_j;
  }

  if (j < m) push(kSoftclip, m - j);

  int state = 0;
  while (i > 0 && j > 0) {
    int btr = code_at(i, j);
    if (state == kInsertExt) {
      --j;
      ops.back() += 1;
      state = btr & kInsertExt;
    } else if (state == kDeleteExt) {
      --i;
      ops.back() += 1;
      state = btr & kDeleteExt;
    } else {
      switch (btr & 3) {
        case kMatch:
          --i;
          --j;
          push(kMatch, 1);
          state = 0;
          break;
        case kInsert:
          --j;
          push(kInsert, 1);
          state = btr & kInsertExt;
          break;
        default:
          --i;
          push(kDelete, 1);
          state = btr & kDeleteExt;
          break;
      }
    }
  }

  int32_t offset = 0;
  if (strategy == kSoftclip) {
    if (j > 0) push(kSoftclip, j);
    offset = i;
  } else if (strategy == kIgnore) {
    if (j > 0) push(ops.empty() ? kMatch : ops[ops.size() - 2], j);
    offset = i - j;
  } else {
    if (i > 0)
      push(kDelete, i);
    else if (j > 0)
      push(kInsert, j);
    offset = 0;
  }
  *offset_out = offset;

  // merge adjacent equal ops, then emit reversed
  int out = 0;
  int prev_op = -1;
  long prev_cnt = 0;
  std::vector<long> merged;  // op, cnt pairs in walk order
  for (size_t k = 0; k + 1 < ops.size(); k += 2) {
    int op = ops[k];
    long cnt = ops[k + 1];
    if (op == prev_op) {
      prev_cnt += cnt;
      merged[merged.size() - 1] = prev_cnt;
    } else {
      merged.push_back(op);
      merged.push_back(cnt);
      prev_op = op;
      prev_cnt = cnt;
    }
  }
  for (long k = (long)merged.size() - 2; k >= 0; k -= 2) {
    long op = merged[k];
    long cnt = merged[k + 1];
    if (cnt <= 0) continue;
    char state_c;
    switch (op) {
      case kMatch:
        state_c = 'M';
        break;
      case kInsert:
        state_c = 'I';
        break;
      case kDelete:
        state_c = 'D';
        break;
      case kSoftclip:
        state_c = 'S';
        break;
      default:
        state_c = 'R';
        break;
    }
    int written = snprintf(cigar_out + out, (size_t)(cigar_cap - out), "%ld%c",
                           cnt, state_c);
    if (written < 0 || out + written >= cigar_cap) break;
    out += written;
  }
  cigar_out[out < cigar_cap ? out : cigar_cap - 1] = '\0';
  return out;
}

}  // namespace

extern "C" {

// Finish a device-computed alignment: pick the maximum and walk the CIGAR.
int sw_postprocess(const uint8_t* bt, int n, int m, const int32_t* lastrow,
                   const int32_t* lastcol, int strategy, char* cigar_out,
                   int cigar_cap, int32_t* offset_out, int32_t* score_out) {
  MaxSel s = select_max(lastrow, lastcol, n, m, strategy);
  *score_out = s.score;
  return walk_cigar(bt, n, m, m, /*packed=*/0, s.max_i, s.max_j, strategy,
                    cigar_out, cigar_cap, offset_out);
}

// Same, for a row-pair 4-bit-packed backtrack with `stride` bytes per
// packed row (the device's padded column bucket).
int sw_postprocess_packed(const uint8_t* bt, int n, int m, long stride,
                          const int32_t* lastrow, const int32_t* lastcol,
                          int strategy, char* cigar_out, int cigar_cap,
                          int32_t* offset_out, int32_t* score_out) {
  MaxSel s = select_max(lastrow, lastcol, n, m, strategy);
  *score_out = s.score;
  return walk_cigar(bt, n, m, stride, /*packed=*/1, s.max_i, s.max_j, strategy,
                    cigar_out, cigar_cap, offset_out);
}

// Full scalar aligner (host fallback for sequences beyond device buckets).
// Rolling-row int32 DP identical in semantics to the device kernel.
int sw_align_scalar(const uint8_t* ref, int n, const uint8_t* alt, int m,
                    int match, int mismatch, int open_, int extend,
                    int strategy, char* cigar_out, int cigar_cap,
                    int32_t* offset_out, int32_t* score_out) {
  const bool indel_boundary = strategy == kIndel || strategy == kLeadingIndel;
  std::vector<uint8_t> bt((size_t)n * m);
  std::vector<int32_t> h_prev(m + 1), h_cur(m + 1), e_row(m + 1), f_prev(m + 1),
      f_cur(m + 1), lastrow(m), lastcol(n);

  for (int j = 0; j <= m; ++j) {
    h_prev[j] = (indel_boundary && j >= 1) ? open_ + (j - 1) * extend : 0;
    f_prev[j] = kLowInit;
  }
  for (int i = 1; i <= n; ++i) {
    h_cur[0] = indel_boundary ? open_ + (i - 1) * extend : 0;
    e_row[0] = kLowInit;
    for (int j = 1; j <= m; ++j) {
      int32_t open_h = h_cur[j - 1] + open_;
      int32_t ext_h = e_row[j - 1] + extend;
      e_row[j] = open_h > ext_h ? open_h : ext_h;
      int iext = open_h > ext_h ? 0 : kInsertExt;

      int32_t open_v = h_prev[j] + open_;
      int32_t ext_v = f_prev[j] + extend;
      f_cur[j] = open_v > ext_v ? open_v : ext_v;
      int dext = open_v > ext_v ? 0 : kDeleteExt;

      int32_t mval = h_prev[j - 1] + (ref[i - 1] == alt[j - 1] ? match : mismatch);
      int32_t h = mval > kMinCutoff ? mval : kMinCutoff;
      int code = kMatch;
      if (e_row[j] > h) {
        code = kInsert;
        h = e_row[j];
      }
      if (f_cur[j] > h) {
        code = kDelete;
        h = f_cur[j];
      }
      bt[(size_t)(i - 1) * m + (j - 1)] = (uint8_t)(code | iext | dext);
      h_cur[j] = h;
    }
    lastcol[i - 1] = h_cur[m];
    if (i == n)
      for (int j = 1; j <= m; ++j) lastrow[j - 1] = h_cur[j];
    std::swap(h_prev, h_cur);
    std::swap(f_prev, f_cur);
  }

  return sw_postprocess(bt.data(), n, m, lastrow.data(), lastcol.data(),
                        strategy, cigar_out, cigar_cap, offset_out, score_out);
}

// Batch scalar alignment over a std::thread pool — the OpenMP-over-pairs
// analogue for beyond-device-bucket pairs (the reference parallelizes its
// per-pair kernel the same way; a serial Python loop over 32k-length pairs
// is ~1e9 scalar cells per core per pair).  Sequences are packed into
// concatenated buffers with per-pair offsets; cigars land at fixed strides.
void sw_align_scalar_batch(const uint8_t* refs, const int64_t* ref_off,
                           const int32_t* ref_len, const uint8_t* alts,
                           const int64_t* alt_off, const int32_t* alt_len,
                           int n_pairs, int match, int mismatch, int open_,
                           int extend, int strategy, char* cigars,
                           int64_t cigar_stride, int32_t* offsets,
                           int32_t* scores, int n_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int k = next.fetch_add(1);
      if (k >= n_pairs) return;
      sw_align_scalar(refs + ref_off[k], ref_len[k], alts + alt_off[k],
                      alt_len[k], match, mismatch, open_, extend, strategy,
                      cigars + (int64_t)k * cigar_stride, (int)cigar_stride,
                      offsets + k, scores + k);
    }
  };
  if (n_threads <= 1 || n_pairs <= 1) {
    worker();
    return;
  }
  int nt = n_threads < n_pairs ? n_threads : n_pairs;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"
