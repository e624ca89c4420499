// Native batch PDHMM oracle: exact f64 serial DP with gradual underflow.
//
// Deep-underflow lanes (raw probability under ~1e-283) need IEEE gradual
// underflow to reproduce the reference's subnormal-range results
// (pdhmm-serial.cc relies on it); device backends flush subnormals, so
// those lanes rerun here.  Semantics re-derived from ops/pdhmm_ref.py (the
// Python oracle, itself re-derived from pdhmm-serial.cc:279-412): PairHMM
// plus three branch matrices and the NORMAL/INSIDE_DEL/AFTER_DEL jump-state
// machine.  All probability tables (transitions, priors) are precomputed by
// the Python layer and passed in — this file is pure DP, so its arithmetic
// matches the Python tables bit-for-bit.  A std::thread pool parallelizes
// over lanes (one adversarial deep batch previously stalled seconds per
// lane in Python).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kSNP = 1;
constexpr int kDelStart = 2;
constexpr int kDelEnd = 4;
constexpr int kNormal = 0;
constexpr int kInsideDel = 1;
constexpr int kAfterDel = 2;

inline int base_bit(int b) {
  switch (b) {
    case 'A': case 'a': return 8;
    case 'C': case 'c': return 16;
    case 'G': case 'g': return 32;
    case 'T': case 't': return 64;
    default: return 0;
  }
}

// One (hap, read) pair; `trans` is 7 doubles per read row:
// {t_mm, t_mi, t_md, t_im, t_dd, p_match, p_mis}.
double pdhmm_pair(const uint8_t* hap, const uint8_t* pd, int Hl,
                  const uint8_t* read, const double* trans, int Rl,
                  double ic) {
  const size_t W = (size_t)Hl + 1;
  std::vector<double> buf(12 * W, 0.0);
  double* Mp = buf.data();        // previous row
  double* Ip = Mp + W;
  double* Dp = Ip + W;
  double* BMp = Dp + W;
  double* BIp = BMp + W;
  double* BDp = BIp + W;
  double* Mc = BDp + W;           // current row
  double* Ic_ = Mc + W;
  double* Dc = Ic_ + W;
  double* BMc = Dc + W;
  double* BIc = BMc + W;
  double* BDc = BIc + W;
  for (int j = 0; j <= Hl; ++j) Dp[j] = ic;  // D[0, :] = ic

  for (int r = 1; r <= Rl; ++r) {
    const double t_mm = trans[7 * (r - 1) + 0];
    const double t_mi = trans[7 * (r - 1) + 1];
    const double t_md = trans[7 * (r - 1) + 2];
    const double t_im = trans[7 * (r - 1) + 3];
    const double t_dd = trans[7 * (r - 1) + 4];
    const double p_match = trans[7 * (r - 1) + 5];
    const double p_mis = trans[7 * (r - 1) + 6];
    const int x = read[r - 1];
    const int xbit = base_bit(x);
    const bool x_is_n = x == 'N';
    // row 1 diag reads D[0][0] = ic; deeper rows read column 0 = 0
    Mc[0] = Ic_[0] = Dc[0] = BMc[0] = BIc[0] = BDc[0] = 0.0;
    int state = kNormal;
    for (int j = 1; j <= Hl; ++j) {
      const int y = hap[j - 1];
      const int p = pd[j - 1];
      const bool pd_match = (p & kSNP) && (p & xbit);
      const bool match = x == y || x_is_n || y == 'N' || pd_match;
      const double prior = match ? p_match : p_mis;

      double m_diag = Mp[j - 1], i_diag = Ip[j - 1], d_diag = Dp[j - 1];
      double m_left = Mc[j - 1], d_left = Dc[j - 1];

      if (state == kNormal) {
        BMc[j] = m_left;
        BDc[j] = d_left;
        BIc[j] = Ic_[j - 1];
      } else if (state == kInsideDel) {
        BMc[j] = BMc[j - 1];
        BDc[j] = BDc[j - 1];
        BIc[j] = BIc[j - 1];
      } else {  // AFTER_DEL
        const double bm_left = BMc[j - 1], bd_left = BDc[j - 1];
        BMc[j] = bm_left > m_left ? bm_left : m_left;
        BDc[j] = bd_left > d_left ? bd_left : d_left;
        BIc[j] = BIc[j - 1] > Ic_[j - 1] ? BIc[j - 1] : Ic_[j - 1];
        if (BMp[j - 1] > m_diag) m_diag = BMp[j - 1];
        if (BIp[j - 1] > i_diag) i_diag = BIp[j - 1];
        if (BDp[j - 1] > d_diag) d_diag = BDp[j - 1];
        if (bm_left > m_left) m_left = bm_left;
        if (bd_left > d_left) d_left = bd_left;
      }

      Mc[j] = prior * (m_diag * t_mm + i_diag * t_im + d_diag * t_im);
      Dc[j] = m_left * t_md + d_left * t_dd;

      if (p & kDelEnd) {
        const double mt = BMp[j] > Mp[j] ? BMp[j] : Mp[j];
        const double it = BIp[j] > Ip[j] ? BIp[j] : Ip[j];
        Ic_[j] = mt * t_mi + it * t_dd;  // t_ii == t_dd
      } else {
        Ic_[j] = Mp[j] * t_mi + Ip[j] * t_dd;
      }

      if (state == kAfterDel) state = kNormal;
      if (p & kDelStart) state = kInsideDel;
      if (p & kDelEnd) state = kAfterDel;
    }
    std::swap(Mp, Mc);
    std::swap(Ip, Ic_);
    std::swap(Dp, Dc);
    std::swap(BMp, BMc);
    std::swap(BIp, BIc);
    std::swap(BDp, BDc);
  }

  double total = 0.0;
  for (int j = 1; j <= Hl; ++j) total += Mp[j] + Ip[j];
  return total;
}

}  // namespace

extern "C" {

// Batch oracle over a thread pool.  Sequences/pd bytes/transitions are
// packed into concatenated buffers with per-pair offsets (trans offset =
// read_off * 7).  Writes the RAW forward probability per pair (the Python
// layer applies log10 and the initial-condition shift).
void gkl_pdhmm_oracle_batch(const uint8_t* haps, const int64_t* hap_off,
                            const int32_t* hap_len, const uint8_t* pds,
                            const uint8_t* reads, const int64_t* read_off,
                            const int32_t* read_len, const double* trans,
                            const double* ic, int n_pairs, double* out,
                            int n_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int k = next.fetch_add(1);
      if (k >= n_pairs) return;
      out[k] = pdhmm_pair(haps + hap_off[k], pds + hap_off[k], hap_len[k],
                          reads + read_off[k], trans + 7 * read_off[k],
                          read_len[k], ic[k]);
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
