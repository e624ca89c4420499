// Native batch PairHMM oracle: exact f64 serial forward DP with gradual
// underflow.
//
// The reference rescues ONLY the underflowed pair in double
// (pairhmm/IntelPairHmm.cc:157-165) through its sequential double kernel.
// This is that engine's TPU-framework equivalent: flagged deep lanes are
// compacted into a minimal batch by the Python layer and recomputed here —
// rescue cost scales with the number of deep lanes, not the packed group.
// Semantics re-derived from ops/pairhmm.py (the jnp engine, itself from
// avx-pairhmm-template.h:208-223,334-371):
//
//   M[r][c] = prior * (pMM*M[r-1][c-1] + pGAPM*(X[r-1][c-1] + Y[r-1][c-1]))
//   X[r][c] = pMX*M[r-1][c] + pXX*X[r-1][c]
//   Y[r][c] = pMY*M[r][c-1] + pYY*Y[r][c-1]
//
// with row 0 at M = X = 0, Y = INITIAL_CONSTANT / haplen, column 0 zero for
// r >= 1, and result = sum_c M[R][c] + X[R][c].  All probability tables are
// precomputed by the Python layer (the same context tables the jnp engine
// gathers from) and passed as 8 doubles per read row, so this file is pure
// DP and bit-identical to the Python per-pair oracle in ops/pairhmm_ref.py.
// A std::thread pool parallelizes over lanes.

#include <atomic>
#include <cstdint>
#include <thread>
#include <utility>
#include <vector>

namespace {

// One (hap, read) pair; `trans` is 8 doubles per read row:
// {p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, distm_match, distm_mis}.
double pairhmm_pair(const uint8_t* hap, int Hl, const uint8_t* read,
                    const double* trans, int Rl, double init_y) {
  const size_t W = (size_t)Hl + 1;
  std::vector<double> buf(6 * W, 0.0);
  double* Mp = buf.data();  // previous row
  double* Xp = Mp + W;
  double* Yp = Xp + W;
  double* Mc = Yp + W;  // current row
  double* Xc = Mc + W;
  double* Yc = Xc + W;
  for (int j = 0; j <= Hl; ++j) Yp[j] = init_y;  // Y[0][:] = IC / haplen

  for (int r = 1; r <= Rl; ++r) {
    const double* t = trans + 8 * (r - 1);
    const double p_mm = t[0], p_gapm = t[1], p_mx = t[2], p_xx = t[3];
    const double p_my = t[4], p_yy = t[5], dmatch = t[6], dmis = t[7];
    const int x = read[r - 1];
    const bool x_is_n = x == 'N';
    Mc[0] = Xc[0] = Yc[0] = 0.0;
    for (int j = 1; j <= Hl; ++j) {
      const int y = hap[j - 1];
      const bool match = x == y || x_is_n || y == 'N';
      const double prior = match ? dmatch : dmis;
      Mc[j] = prior * (p_mm * Mp[j - 1] + p_gapm * (Xp[j - 1] + Yp[j - 1]));
      Xc[j] = p_mx * Mp[j] + p_xx * Xp[j];
      Yc[j] = p_my * Mc[j - 1] + p_yy * Yc[j - 1];
    }
    std::swap(Mp, Mc);
    std::swap(Xp, Xc);
    std::swap(Yp, Yc);
  }

  double total = 0.0;
  for (int j = 1; j <= Hl; ++j) total += Mp[j] + Xp[j];
  return total;
}

}  // namespace

extern "C" {

// Batch oracle over a thread pool.  Sequences and transition rows are packed
// into concatenated buffers with per-pair offsets (trans offset =
// read_off * 8).  Writes the RAW forward probability per pair (the Python
// layer applies log10 and the initial-constant shift).
void gkl_pairhmm_oracle_batch(const uint8_t* haps, const int64_t* hap_off,
                              const int32_t* hap_len, const uint8_t* reads,
                              const int64_t* read_off, const int32_t* read_len,
                              const double* trans, const double* init_y,
                              int n_pairs, double* out, int n_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int k = next.fetch_add(1);
      if (k >= n_pairs) return;
      out[k] = pairhmm_pair(haps + hap_off[k], hap_len[k],
                            reads + read_off[k], trans + 8 * read_off[k],
                            read_len[k], init_y[k]);
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
