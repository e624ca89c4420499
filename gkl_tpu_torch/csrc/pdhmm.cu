// PDHMM forward likelihood in f32 for Hopper (sm_90a), bound through a
// plain C interface (ctypes): a warp per lane, on an anti-diagonal
// wavefront.
//
// Replaces both PDHMM kernels of the JAX package:
// gkl_tpu/ops/pdhmm_pallas.py::_kernel (reads within its VMEM budget) and
// ::_chunk_kernel (longer reads, in <=512-row chunks with six boundary
// planes carried between calls), together with their prologue _host_prep
// / chunked_prep and the indexed lane expansion of api_pdhmm.py's
// _pdhmm_indexed_jit.  Those splits exist because the TPU kernel keeps its
// state in 16 MB of VMEM; here a lane's rows go in passes inside the
// kernel, and one launch covers any read length.
//
// What it computes, per lane (pair), for read rows r and haplotype columns
// j (the serial f64 oracle native/pdhmm_oracle.cc:43-140, itself
// pdhmm-serial.cc:279-412):
//   M[r][j] = prior * (M'*t_mm + I'*t_im + D'*t_im)   ' = diagonal (r-1, j-1)
//   D[r][j] = M[r][j-1]*t_md + D[r][j-1]*t_dd
//   I[r][j] = M[r-1][j]*t_mi + I[r-1][j]*t_dd        (DEL_END columns take
//             max(BM, M) and max(BI, I) of row r-1)
// and the branch matrices BM/BI/BD, which copy the left values in the
// NORMAL state, freeze in INSIDE_DEL and max-merge with them (and the
// diagonal and left operands with the branch) in AFTER_DEL.  The state is
// a per-column machine over the PD bytes, row-invariant.  The virtual row
// 0 holds D = 2^120 / haplen at every column and 0 elsewhere; column -1 is
// 0 in every matrix and row, save D of row 0.  The result is the sum of
// M + I over the last row's columns, in column order, before the log.
//
// Design: a warp per lane.  A pass covers 32 * kRC read rows; thread t
// owns rows t*kRC .. t*kRC+kRC-1 of the pass, holds their transition
// probabilities and their six values at the previous column (the left
// operands) in registers, and runs down its rows with the row above in
// registers.  The strips form an anti-diagonal wavefront: at step s thread
// t computes column j = s - t for its rows, top to bottom.  Its row above
// at column j comes from thread t-1 by __shfl_up_sync: the six values of
// that thread's last row, computed at step s-1; the diagonal (the row above
// at column j-1) is what it received one step earlier.  Inside a strip the
// row above is the thread's own row, just computed, and the diagonal that
// row's left operands.
//
// The jump state rides with the haplotype byte: thread 0 steps the machine
// one column a step and packs (hap byte, PD byte, state) into one int,
// which goes down the warp beside the six values.  Threads of a warp sit at
// different columns and so in different states: the three cases are
// selects and fmaxf, not branches, and fmaxf is exact.  Thread 0 takes its
// row above from the pass boundary: the virtual row 0 on the first pass,
// else the previous pass's last row, which thread 31 stores into six
// lane-major (P, H) f32 planes.  The warp fetches the hap and PD bytes and
// the boundary row 32 columns ahead, one column a thread, and thread 0
// takes its column by __shfl_sync.  A pass reads and writes the planes in
// place: a column is fetched (at step j-32 or before) ahead of its new
// value's store (step j+31, which depends on the fetched value through the
// shuffles).  A pass takes haplen + 31 steps (fewer on a last pass whose
// rows end early).  Only lanes whose read passes one pass touch the
// planes, and the wrapper allocates them only for such read buckets.
//
// Each thread reads its rows' transitions once a pass from the exact
// context.pdhmm_context("float32") tables (q2e, 255 entries;
// match-to-match, 32,640) through the read-only cache; nothing sits in
// shared memory, so registers alone set the occupancy.  kRC is 2, 4 or 8
// (gkl_tpu_torch/ops/pdhmm_cuda.py::pdhmm_geometry picks it from the read
// bucket R: the smallest whose one pass holds R, else 8).  Control is
// warp-uniform: the loop bounds and exits depend only on the lane, and
// threads whose column lies outside [0, haplen), or whose rows lie past
// rslen, take part in every shuffle and store nothing.  A malformed lane
// gets NaN from thread 0 of its warp.
//
// What bounds it on this card: per cell, 12 f32 products and sums, plus
// about 20 maximums, selects and integer tests of the match and the state;
// per step, thirteen shuffles and the loop's control, spread over kRC rows.
// Bytes: per column and pass, 24 B of boundary row and two bytes of hap and
// PD, about 26/(32*kRC) B a cell.  With thousands of lanes (the corpus) it
// is bound by instruction throughput; with a few hundred (a warp or two an SM),
// by the latency of a step: the shuffles, then the I chain down kRC rows (a
// maximum, two products and a sum a row; M, D and the branch values of all
// rows are independent of it).  The one-thread sweep this design replaced
// was bound by latency: a lane's rslen x haplen cells were one thread's
// chain, with the previous row's six values (48 B a cell) in device memory
// and its tables in 131 KB of shared memory, one block an SM.
//
// Numerics: built with -ftz=true (subnormals flush, as in XLA and the plain
// twin) and -fmad=false (each product and sum rounds alone).  Every cell
// does the one-thread sweep's products and sums in its order, and the
// result is summed in column order by the thread that owns row rslen, so
// neither the strip height nor the passes change a bit of the result.
// Lanes whose result is below MIN_ACCEPTED are recomputed on the host
// oracle by the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kWarp = 0xffffffffu;
constexpr int kSNP = 1;
constexpr int kDelStart = 2;
constexpr int kDelEnd = 4;
constexpr int kNormal = 0;
constexpr int kInsideDel = 1;
constexpr int kAfterDel = 2;
constexpr int kNCode = 78;  // 'N'
constexpr int kMaxQual = 254;
constexpr float kInitialCondition = 0x1p120f;

__device__ __forceinline__ int base_bit(int b) {
  switch (b) {
    case 'A': case 'a': return 8;
    case 'C': case 'c': return 16;
    case 'G': case 'g': return 32;
    case 'T': case 't': return 64;
    default: return 0;
  }
}

// One haplotype column as a thread fetches it ahead of the wavefront: the
// hap byte and PD byte (hap | pd << 8) and the boundary row above the pass.
struct Column {
  int hp;
  float m, i, d, bm, bi, bd;
};

template <int kRC>
__global__ void pdhmm_kernel(
    const uint8_t* __restrict__ hap_u, const uint8_t* __restrict__ happd_u,
    int H, int nu_h,
    const uint8_t* __restrict__ readq_u, int R, int nu_r,
    const int32_t* __restrict__ ridx, const int32_t* __restrict__ hidx,
    const int32_t* __restrict__ haplen, const int32_t* __restrict__ rslen,
    int P, const float* __restrict__ q2e, const float* __restrict__ m2m,
    float* planes, float* __restrict__ out) {
  constexpr int kPass = 32 * kRC;  // read rows of one pass

  const int t = threadIdx.x & 31;  // the strip of each pass this thread owns
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp: p is the warp's lane
  const int ri = ridx[p], hi = hidx[p], hl = haplen[p], rl = rslen[p];
  if (ri < 0 || ri >= nu_r || hi < 0 || hi >= nu_h || hl < 1 || hl > H ||
      rl < 1 || rl > R) {
    if (t == 0) out[p] = __int_as_float(0x7fc00000);  // malformed lane: NaN
    return;
  }

  const size_t plane = (size_t)R * nu_r;
  const size_t HP = (size_t)H * P;
  const uint8_t* hap = hap_u + hi;
  const uint8_t* pdb = happd_u + hi;
  // the pass boundary: six lane-major (P, H) planes M, I, D, BM, BI, BD
  float* sm = planes + (size_t)p * H;
  float* si = sm + HP;
  float* sd = sm + 2 * HP;
  float* sbm = sm + 3 * HP;
  float* sbi = sm + 4 * HP;
  float* sbd = sm + 5 * HP;
  const float ic = kInitialCondition / (float)hl;
  const int npasses = (rl + kPass - 1) / kPass;
  float acc = 0.f;

  for (int c = 0; c < npasses; ++c) {
    const bool first = c == 0;
    const int r0 = c * kPass + t * kRC;  // this thread's first row, 0-based
    // the strip's per-row values; rows past rslen are all zero (they feed
    // neither the result nor a later pass)
    float t_mm[kRC], t_mi[kRC], t_md[kRC], t_im[kRC], t_dd[kRC], p_match[kRC], p_mis[kRC];
    int rx[kRC], rbit[kRC];
#pragma unroll
    for (int k = 0; k < kRC; ++k) {
      const int r = r0 + k;
      if (r < rl) {
        const size_t ro = (size_t)r * nu_r + ri;
        const int x = readq_u[ro];
        const int qv = min((int)readq_u[plane + ro], kMaxQual);
        const int iqv = min((int)readq_u[2 * plane + ro], kMaxQual);
        const int dqv = min((int)readq_u[3 * plane + ro], kMaxQual);
        const int gv = min((int)readq_u[4 * plane + ro], kMaxQual);
        const int qmax = max(iqv, dqv), qmin = min(iqv, dqv);
        t_mm[k] = __ldg(m2m + ((qmax * (qmax + 1)) >> 1) + qmin);
        t_mi[k] = __ldg(q2e + iqv);
        t_md[k] = __ldg(q2e + dqv);
        const float g = __ldg(q2e + gv);
        t_im[k] = 1.f - g;
        t_dd[k] = g;
        const float err = __ldg(q2e + qv);
        p_match[k] = 1.f - err;
        p_mis[k] = err / 3.f;
        rx[k] = x == kNCode ? -2 : x;  // an 'N' read base matches anything
        rbit[k] = base_bit(x);
      } else {
        t_mm[k] = t_mi[k] = t_md[k] = t_im[k] = t_dd[k] = p_match[k] = p_mis[k] = 0.f;
        rx[k] = -1;
        rbit[k] = 0;
      }
    }
    // each row's six values at the previous column: column -1 is zero
    float M[kRC], I[kRC], D[kRC], BM[kRC], BI[kRC], BD[kRC];
#pragma unroll
    for (int k = 0; k < kRC; ++k) M[k] = I[k] = D[k] = BM[k] = BI[k] = BD[k] = 0.f;
    const int k_last = rl - 1 - r0;  // row rslen, when in this strip
    // the pass ends when the thread holding its last row below rslen has
    // done column haplen-1; a pass with a successor runs all 32 threads,
    // and thread 31 writes the boundary row
    const int t_end = min(31, (rl - 1 - c * kPass) / kRC);
    const int nsteps = hl + t_end;
    const bool write_boundary = c + 1 < npasses && t == 31;

    // the row above the strip at column j-1 (the diagonal operands): at
    // column -1 only D of the virtual row 0 is nonzero
    float dg_m = 0.f, dg_i = 0.f, dg_d = first && t == 0 ? ic : 0.f;
    float dg_bm = 0.f, dg_bi = 0.f, dg_bd = 0.f;
    // the strip's last row at its last column, for thread t+1
    float lo_m = 0.f, lo_i = 0.f, lo_d = 0.f, lo_bm = 0.f, lo_bi = 0.f, lo_bd = 0.f;
    int word = 0;      // hap | pd << 8 | state << 16 of this thread's column
    int st = kNormal;  // thread 0: the jump state at its column

    auto fetch = [&](int col) {
      Column v{0, 0.f, 0.f, ic, 0.f, 0.f, 0.f};  // the virtual row 0
      if (col < hl) {
        v.hp = __ldg(hap + (size_t)col * nu_h) | __ldg(pdb + (size_t)col * nu_h) << 8;
        if (!first) {
          v.m = sm[col];
          v.i = si[col];
          v.d = sd[col];
          v.bm = sbm[col];
          v.bi = sbi[col];
          v.bd = sbd[col];
        }
      }
      return v;
    };
    // column base+t of the current 32-column window and of the next one
    Column next = fetch(t), cur = next;

    for (int s = 0; s < nsteps; ++s) {
      const int w = s & 31;
      if (w == 0) {
        cur = next;
        next = fetch(s + 32 + t);
      }
      // the row above at column j = s - t: thread t-1's last row from the
      // step before, or for thread 0 the boundary row at column s
      float up_m = __shfl_up_sync(kWarp, lo_m, 1);
      float up_i = __shfl_up_sync(kWarp, lo_i, 1);
      float up_d = __shfl_up_sync(kWarp, lo_d, 1);
      float up_bm = __shfl_up_sync(kWarp, lo_bm, 1);
      float up_bi = __shfl_up_sync(kWarp, lo_bi, 1);
      float up_bd = __shfl_up_sync(kWarp, lo_bd, 1);
      const int word_up = __shfl_up_sync(kWarp, word, 1);
      const int hp0 = __shfl_sync(kWarp, cur.hp, w);
      float b_m = 0.f, b_i = 0.f, b_d = ic, b_bm = 0.f, b_bi = 0.f, b_bd = 0.f;
      if (!first) {
        b_m = __shfl_sync(kWarp, cur.m, w);
        b_i = __shfl_sync(kWarp, cur.i, w);
        b_d = __shfl_sync(kWarp, cur.d, w);
        b_bm = __shfl_sync(kWarp, cur.bm, w);
        b_bi = __shfl_sync(kWarp, cur.bi, w);
        b_bd = __shfl_sync(kWarp, cur.bd, w);
      }
      if (t == 0) {
        up_m = b_m;
        up_i = b_i;
        up_d = b_d;
        up_bm = b_bm;
        up_bi = b_bi;
        up_bd = b_bd;
        // the state at column s, then the machine steps over its PD byte
        // (pdhmm-serial.cc:370-385): AFTER_DEL resets, DEL_START enters
        // INSIDE_DEL, DEL_END overrides it with AFTER_DEL
        word = hp0 | st << 16;
        const int pd = hp0 >> 8;
        st = st == kAfterDel ? kNormal : st;
        st = (pd & kDelStart) ? kInsideDel : st;
        st = (pd & kDelEnd) ? kAfterDel : st;
      } else {
        word = word_up;
      }

      const int j = s - t;
      if (j >= 0 && j < hl) {
        const int y = word & 0xff, pd = (word >> 8) & 0xff, state = word >> 16;
        const bool after = state == kAfterDel, inside = state == kInsideDel;
        const bool del_end = pd & kDelEnd;
        const bool y_is_n = y == kNCode;
        const int snp_bits = pd & kSNP ? pd : 0;
        // diagonal operands of row k (row k-1 at column j-1) and the row
        // above (row k-1 at column j)
        float dm = dg_m, di = dg_i, dd = dg_d, dbm = dg_bm, dbi = dg_bi, dbd = dg_bd;
        float um = up_m, ui = up_i, ubm = up_bm, ubi = up_bi;
#pragma unroll
        for (int k = 0; k < kRC; ++k) {
          const float ml = M[k], il = I[k], dl = D[k], bml = BM[k], bil = BI[k], bdl = BD[k];
          const bool match = rx[k] == y || rx[k] == -2 || y_is_n || (snp_bits & rbit[k]);
          const float prior = match ? p_match[k] : p_mis[k];
          // the branch values of this column, and in AFTER_DEL the merged
          // diagonal and left operands (fmaxf is exact and commutative on
          // these non-negative values)
          const float mx_m = fmaxf(bml, ml), mx_d = fmaxf(bdl, dl), mx_i = fmaxf(bil, il);
          const float bm = after ? mx_m : inside ? bml : ml;
          const float bd = after ? mx_d : inside ? bdl : dl;
          const float bi = after ? mx_i : inside ? bil : il;
          const float m_dg = after ? fmaxf(dm, dbm) : dm;
          const float i_dg = after ? fmaxf(di, dbi) : di;
          const float d_dg = after ? fmaxf(dd, dbd) : dd;
          const float m_le = after ? mx_m : ml;
          const float d_le = after ? mx_d : dl;
          const float m = prior * (m_dg * t_mm[k] + i_dg * t_im[k] + d_dg * t_im[k]);
          const float d = m_le * t_md[k] + d_le * t_dd[k];
          const float m_up = del_end ? fmaxf(ubm, um) : um;
          const float i_up = del_end ? fmaxf(ubi, ui) : ui;
          const float i = m_up * t_mi[k] + i_up * t_dd[k];
          if (k == k_last) acc += m + i;
          dm = ml;
          di = il;
          dd = dl;
          dbm = bml;
          dbi = bil;
          dbd = bdl;
          M[k] = um = m;
          I[k] = ui = i;
          D[k] = d;
          BM[k] = ubm = bm;
          BI[k] = ubi = bi;
          BD[k] = bd;
        }
        lo_m = M[kRC - 1];
        lo_i = I[kRC - 1];
        lo_d = D[kRC - 1];
        lo_bm = BM[kRC - 1];
        lo_bi = BI[kRC - 1];
        lo_bd = BD[kRC - 1];
        if (write_boundary) {
          sm[j] = lo_m;
          si[j] = lo_i;
          sd[j] = lo_d;
          sbm[j] = lo_bm;
          sbi[j] = lo_bi;
          sbd[j] = lo_bd;
        }
      }
      dg_m = up_m;
      dg_i = up_i;
      dg_d = up_d;
      dg_bm = up_bm;
      dg_bi = up_bi;
      dg_bd = up_bd;
    }
    __syncwarp();  // the boundary row's stores before the next pass's fetches
  }
  if (t == ((rl - 1) % kPass) / kRC) out[p] = acc;
}

// A few warps a block, each a lane; with fewer lanes than the card has
// SMs x 2, smaller blocks spread them over more SMs.
inline int warps_for(int P) {
  int warps = 4;
  while (warps > 1 && (P + warps - 1) / warps < 264) warps >>= 1;
  return warps;
}

template <int kRC>
void launch(const void* hap_u, const void* happd_u, int H, int nu_h, const void* readq_u,
            int R, int nu_r, const void* ridx, const void* hidx, const void* haplen,
            const void* rslen, int P, const void* q2e, const void* m2m, void* planes,
            void* out, cudaStream_t stream) {
  const int warps = warps_for(P);
  const int grid = (P + warps - 1) / warps;
  pdhmm_kernel<kRC><<<grid, 32 * warps, 0, stream>>>(
      static_cast<const uint8_t*>(hap_u), static_cast<const uint8_t*>(happd_u), H, nu_h,
      static_cast<const uint8_t*>(readq_u), R, nu_r,
      static_cast<const int32_t*>(ridx), static_cast<const int32_t*>(hidx),
      static_cast<const int32_t*>(haplen), static_cast<const int32_t*>(rslen),
      P, static_cast<const float*>(q2e), static_cast<const float*>(m2m),
      static_cast<float*>(planes), static_cast<float*>(out));
}

}  // namespace

extern "C" int gkl_pdhmm(
    const void* hap_u, const void* happd_u, int H, int nu_h,
    const void* readq_u, int R, int nu_r,
    const void* ridx, const void* hidx, const void* haplen, const void* rslen,
    int P, const void* q2e, const void* m2m, void* planes, int rows_per_thread,
    void* out, void* stream) {
  if (P <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread) {
    case 2:
      launch<2>(hap_u, happd_u, H, nu_h, readq_u, R, nu_r, ridx, hidx, haplen, rslen, P,
                q2e, m2m, planes, out, s);
      break;
    case 4:
      launch<4>(hap_u, happd_u, H, nu_h, readq_u, R, nu_r, ridx, hidx, haplen, rslen, P,
                q2e, m2m, planes, out, s);
      break;
    case 8:
      launch<8>(hap_u, happd_u, H, nu_h, readq_u, R, nu_r, ridx, hidx, haplen, rslen, P,
                q2e, m2m, planes, out, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
