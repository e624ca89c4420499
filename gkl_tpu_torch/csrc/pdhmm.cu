// PDHMM forward likelihood for Hopper (sm_90a), bound through a plain C
// interface (ctypes): a warp per lane, on an anti-diagonal wavefront.  One
// body, templated on the scalar type: the f32 instances (gkl_pdhmm) score
// every lane, the f64 ones (gkl_pdhmm_f64) recompute the lanes whose f32
// result falls below MIN_ACCEPTED.
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
// 0 holds D = INITIAL_CONDITION / haplen (2^120 in f32, 2^1020 in f64) at
// every column and 0 elsewhere; column -1 is
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
// selects and maximums, not branches, and a maximum is exact.  Thread 0
// takes its row above from the pass boundary: the virtual row 0 on the
// first pass, else the previous pass's last row, which thread 31 stores
// into six lane-major (P, H) planes of the scalar type.  The warp fetches
// the hap and PD bytes and the boundary row 32 columns ahead, one column a
// thread, and thread 0 takes its column by __shfl_sync.  A pass reads and
// writes the planes in place: a column is fetched (at step j-32 or before)
// ahead of its new value's store (step j+31, which depends on the fetched
// value through the shuffles).  A pass takes haplen + 31 steps (fewer on a last pass whose
// rows end early).  Only lanes whose read passes one pass touch the
// planes, and the wrapper allocates them only for such read buckets.
//
// The f64 instances add a relay: a block is one lane of lane_warps warps,
// and warp w runs passes w, w + lane_warps, ...  Pass c fetches a window
// of the boundary row once pass c-1 has marked those columns written (its
// thread 31 marks every 32 columns in shared memory, after a block fence),
// so the passes run side by side, each ~100 steps behind the one before,
// and a lane of 40 passes takes about 5 passes' steps on 8 warps.  Each
// slot of the planes is still written by pass c-1, read by pass c, then
// written by pass c, in that order: pass c + 1 reads it only after pass c's
// mark, and no pass waits on a later one, so the relay cannot deadlock.
// The f32 instances keep a warp a lane, several lanes a block.
//
// Each thread reads its rows' transitions once a pass from the exact
// context.pdhmm_context tables of its scalar type (q2e, 255 entries;
// match-to-match, 32,640) through the read-only cache; nothing sits in
// shared memory, so registers alone set the occupancy.  kRC is 2, 4 or 8
// in f32 and 2 or 4 in f64, whose state takes twice the registers
// (gkl_tpu_torch/ops/pdhmm_cuda.py::pdhmm_geometry picks it from the read
// bucket R: the smallest whose one pass holds R, else the largest).
// Control is warp-uniform: the loop bounds and exits depend only on the lane, and
// threads whose column lies outside [0, haplen), or whose rows lie past
// rslen, take part in every shuffle and store nothing.  A malformed lane
// gets NaN from thread 0 of its warp.
//
// What bounds it on this card: per cell, 12 products and sums, plus about
// 20 maximums, selects and integer tests of the match and the state; per
// step, thirteen shuffles (f64 values take two each) and the loop's
// control, spread over kRC rows.  Bytes: per column and pass, six values of
// boundary row (24 B in f32, 48 in f64) and two bytes of hap and PD, about
// 26/(32*kRC) B a cell in f32.  With thousands of lanes (the corpus) it
// is bound by instruction throughput; with a few hundred (a warp or two an SM),
// by the latency of a step: the shuffles, then the I chain down kRC rows (a
// maximum, two products and a sum a row; M, D and the branch values of all
// rows are independent of it).  The f64 rescue runs a few dozen long lanes
// (reads of thousands of rows), a warp an SM, so it is latency-bound: its
// passes of haplen + 31 steps follow one another.  The one-thread sweep this design replaced
// was bound by latency: a lane's rslen x haplen cells were one thread's
// chain, with the previous row's six values (48 B a cell) in device memory
// and its tables in 131 KB of shared memory, one block an SM.
//
// Numerics: built with -ftz=true (f32 subnormals flush, as in XLA and the
// plain twin; f64 keeps gradual underflow, which -ftz does not touch) and
// -fmad=false (each product and sum rounds alone).  Every cell does the
// one-thread sweep's products and sums in its order, and the result is
// summed in column order by the thread that owns row rslen, so neither
// the strip height nor the passes change a bit of the result.  The caller
// recomputes the lanes whose f32 result is below MIN_ACCEPTED with the
// f64 instance, whose 2^1020 start and subnormals reach the oracle's
// range (native/pdhmm_oracle.cc, the same recurrence in f64).

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

// What the body needs of its scalar type: the initial condition, an exact
// maximum and the NaN of a malformed lane.
template <typename T>
struct Num;

template <>
struct Num<float> {
  static constexpr float kInitialCondition = 0x1p120f;
  __device__ static float max(float a, float b) { return fmaxf(a, b); }
  __device__ static float nan() { return __int_as_float(0x7fc00000); }
};

template <>
struct Num<double> {
  static constexpr double kInitialCondition = 0x1p1020;
  __device__ static double max(double a, double b) { return fmax(a, b); }
  __device__ static double nan() { return __longlong_as_double(0x7ff8000000000000ll); }
};

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
template <typename T>
struct Column {
  int hp;
  T m, i, d, bm, bi, bd;
};

// kRelay: a lane takes lane_warps warps of a block, and warp w of the lane
// runs its passes w, w + lane_warps, ...: pass c starts as soon as pass c-1
// has written the first columns of its boundary row, and trails it
// through the columns (the relay, above).  Without it a warp runs all of
// its lane's passes, and a block holds several lanes.
template <typename T, int kRC, bool kRelay>
__global__ void pdhmm_kernel(
    const uint8_t* __restrict__ hap_u, const uint8_t* __restrict__ happd_u,
    int H, int nu_h,
    const uint8_t* __restrict__ readq_u, int R, int nu_r,
    const int32_t* __restrict__ ridx, const int32_t* __restrict__ hidx,
    const int32_t* __restrict__ haplen, const int32_t* __restrict__ rslen,
    int P, const T* __restrict__ q2e, const T* __restrict__ m2m,
    T* planes, T* __restrict__ out, int lane_warps) {
  using N = Num<T>;
  constexpr int kPass = 32 * kRC;  // read rows of one pass

  const int t = threadIdx.x & 31;  // the strip of each pass this thread owns
  const int warp = threadIdx.x >> 5;
  const int lw = kRelay ? lane_warps : 1;
  const int wl = warp % lw;  // the warp's first pass
  // the relay's mark of each warp's progress: c * (haplen + 1) + the
  // columns of pass c's boundary row written, growing through the passes
  __shared__ volatile int published[32];
  if (kRelay) {
    if (t == 0) published[warp] = 0;
    __syncthreads();
  }
  const int p = blockIdx.x * ((blockDim.x >> 5) / lw) + warp / lw;
  if (p >= P) return;  // the lane's warps together
  const int ri = ridx[p], hi = hidx[p], hl = haplen[p], rl = rslen[p];
  if (ri < 0 || ri >= nu_r || hi < 0 || hi >= nu_h || hl < 1 || hl > H ||
      rl < 1 || rl > R) {
    if (t == 0) out[p] = N::nan();  // malformed lane
    return;
  }

  const size_t plane = (size_t)R * nu_r;
  const size_t HP = (size_t)H * P;
  const uint8_t* hap = hap_u + hi;
  const uint8_t* pdb = happd_u + hi;
  // the pass boundary: six lane-major (P, H) planes M, I, D, BM, BI, BD
  T* sm = planes + (size_t)p * H;
  T* si = sm + HP;
  T* sd = sm + 2 * HP;
  T* sbm = sm + 3 * HP;
  T* sbi = sm + 4 * HP;
  T* sbd = sm + 5 * HP;
  const T ic = N::kInitialCondition / (T)hl;
  const int npasses = (rl + kPass - 1) / kPass;
  T acc = 0;

  for (int c = wl; c < npasses; c += lw) {
    const bool first = c == 0;
    const int r0 = c * kPass + t * kRC;  // this thread's first row, 0-based
    // the strip's per-row values; rows past rslen are all zero (they feed
    // neither the result nor a later pass)
    T t_mm[kRC], t_mi[kRC], t_md[kRC], t_im[kRC], t_dd[kRC], p_match[kRC], p_mis[kRC];
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
        const T g = __ldg(q2e + gv);
        t_im[k] = T(1) - g;
        t_dd[k] = g;
        const T err = __ldg(q2e + qv);
        p_match[k] = T(1) - err;
        p_mis[k] = err / T(3);
        rx[k] = x == kNCode ? -2 : x;  // an 'N' read base matches anything
        rbit[k] = base_bit(x);
      } else {
        t_mm[k] = t_mi[k] = t_md[k] = t_im[k] = t_dd[k] = p_match[k] = p_mis[k] = 0;
        rx[k] = -1;
        rbit[k] = 0;
      }
    }
    // each row's six values at the previous column: column -1 is zero
    T M[kRC], I[kRC], D[kRC], BM[kRC], BI[kRC], BD[kRC];
#pragma unroll
    for (int k = 0; k < kRC; ++k) M[k] = I[k] = D[k] = BM[k] = BI[k] = BD[k] = 0;
    const int k_last = rl - 1 - r0;  // row rslen, when in this strip
    // the pass ends when the thread holding its last row below rslen has
    // done column haplen-1; a pass with a successor runs all 32 threads,
    // and thread 31 writes the boundary row
    const int t_end = min(31, (rl - 1 - c * kPass) / kRC);
    const int nsteps = hl + t_end;
    const bool write_boundary = c + 1 < npasses && t == 31;

    // the row above the strip at column j-1 (the diagonal operands): at
    // column -1 only D of the virtual row 0 is nonzero
    T dg_m = 0, dg_i = 0, dg_d = first && t == 0 ? ic : T(0);
    T dg_bm = 0, dg_bi = 0, dg_bd = 0;
    // the strip's last row at its last column, for thread t+1
    T lo_m = 0, lo_i = 0, lo_d = 0, lo_bm = 0, lo_bi = 0, lo_bd = 0;
    int word = 0;      // hap | pd << 8 | state << 16 of this thread's column
    int st = kNormal;  // thread 0: the jump state at its column

    // relay: wait until pass c-1 has written its boundary row's columns
    // below `cols` (its warp's stores, then its mark; a fence each side)
    auto await_columns = [&](int cols) {
      if (kRelay && !first) {
        const int from = warp - wl + (c - 1) % lw;
        const int want = (c - 1) * (hl + 1) + min(cols, hl);
        while (published[from] < want) __nanosleep(64);
        __syncwarp();
        __threadfence_block();
      }
    };
    auto fetch = [&](int col) {
      Column<T> v{0, 0, 0, ic, 0, 0, 0};  // the virtual row 0
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
    await_columns(32);
    Column<T> next = fetch(t), cur = next;

    for (int s = 0; s < nsteps; ++s) {
      const int w = s & 31;
      if (w == 0) {
        cur = next;
        await_columns(s + 64);
        next = fetch(s + 32 + t);
      }
      // the row above at column j = s - t: thread t-1's last row from the
      // step before, or for thread 0 the boundary row at column s
      T up_m = __shfl_up_sync(kWarp, lo_m, 1);
      T up_i = __shfl_up_sync(kWarp, lo_i, 1);
      T up_d = __shfl_up_sync(kWarp, lo_d, 1);
      T up_bm = __shfl_up_sync(kWarp, lo_bm, 1);
      T up_bi = __shfl_up_sync(kWarp, lo_bi, 1);
      T up_bd = __shfl_up_sync(kWarp, lo_bd, 1);
      const int word_up = __shfl_up_sync(kWarp, word, 1);
      const int hp0 = __shfl_sync(kWarp, cur.hp, w);
      T b_m = 0, b_i = 0, b_d = ic, b_bm = 0, b_bi = 0, b_bd = 0;
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
        T dm = dg_m, di = dg_i, dd = dg_d, dbm = dg_bm, dbi = dg_bi, dbd = dg_bd;
        T um = up_m, ui = up_i, ubm = up_bm, ubi = up_bi;
#pragma unroll
        for (int k = 0; k < kRC; ++k) {
          const T ml = M[k], il = I[k], dl = D[k], bml = BM[k], bil = BI[k], bdl = BD[k];
          const bool match = rx[k] == y || rx[k] == -2 || y_is_n || (snp_bits & rbit[k]);
          const T prior = match ? p_match[k] : p_mis[k];
          // the branch values of this column, and in AFTER_DEL the merged
          // diagonal and left operands (the maximum is exact and
          // commutative on these non-negative values)
          const T mx_m = N::max(bml, ml), mx_d = N::max(bdl, dl), mx_i = N::max(bil, il);
          const T bm = after ? mx_m : inside ? bml : ml;
          const T bd = after ? mx_d : inside ? bdl : dl;
          const T bi = after ? mx_i : inside ? bil : il;
          const T m_dg = after ? N::max(dm, dbm) : dm;
          const T i_dg = after ? N::max(di, dbi) : di;
          const T d_dg = after ? N::max(dd, dbd) : dd;
          const T m_le = after ? mx_m : ml;
          const T d_le = after ? mx_d : dl;
          const T m = prior * (m_dg * t_mm[k] + i_dg * t_im[k] + d_dg * t_im[k]);
          const T d = m_le * t_md[k] + d_le * t_dd[k];
          const T m_up = del_end ? N::max(ubm, um) : um;
          const T i_up = del_end ? N::max(ubi, ui) : ui;
          const T i = m_up * t_mi[k] + i_up * t_dd[k];
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
          // relay: mark each 32 columns written, and the last
          if (kRelay && ((j & 31) == 31 || j == hl - 1)) {
            __threadfence_block();
            published[warp] = c * (hl + 1) + j + 1;
          }
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
  // the warp of the last pass, the thread of row rslen
  if ((npasses - 1) % lw == wl && t == ((rl - 1) % kPass) / kRC) out[p] = acc;
}

// A few warps a block, each a lane; with fewer lanes than the card has
// SMs x 2, smaller blocks spread them over more SMs.
inline int warps_for(int P) {
  int warps = 4;
  while (warps > 1 && (P + warps - 1) / warps < 264) warps >>= 1;
  return warps;
}

template <typename T, int kRC, bool kRelay>
void launch(const void* hap_u, const void* happd_u, int H, int nu_h, const void* readq_u,
            int R, int nu_r, const void* ridx, const void* hidx, const void* haplen,
            const void* rslen, int P, const void* q2e, const void* m2m, void* planes,
            void* out, int lane_warps, cudaStream_t stream) {
  // the relay: a lane a block of lane_warps warps; else warps_for lanes a block
  const int warps = kRelay ? lane_warps : warps_for(P);
  const int grid = kRelay ? P : (P + warps - 1) / warps;
  pdhmm_kernel<T, kRC, kRelay><<<grid, 32 * warps, 0, stream>>>(
      static_cast<const uint8_t*>(hap_u), static_cast<const uint8_t*>(happd_u), H, nu_h,
      static_cast<const uint8_t*>(readq_u), R, nu_r,
      static_cast<const int32_t*>(ridx), static_cast<const int32_t*>(hidx),
      static_cast<const int32_t*>(haplen), static_cast<const int32_t*>(rslen),
      P, static_cast<const T*>(q2e), static_cast<const T*>(m2m),
      static_cast<T*>(planes), static_cast<T*>(out), lane_warps);
}

}  // namespace

// The f32 instances (tables, boundary planes and out in f32; warps_for
// lanes a block) and the f64 ones (all three in f64; a lane a block of
// lane_warps warps in relay), by rows a thread.
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
      launch<float, 2, false>(hap_u, happd_u, H, nu_h, readq_u, R, nu_r, ridx, hidx,
                              haplen, rslen, P, q2e, m2m, planes, out, 1, s);
      break;
    case 4:
      launch<float, 4, false>(hap_u, happd_u, H, nu_h, readq_u, R, nu_r, ridx, hidx,
                              haplen, rslen, P, q2e, m2m, planes, out, 1, s);
      break;
    case 8:
      launch<float, 8, false>(hap_u, happd_u, H, nu_h, readq_u, R, nu_r, ridx, hidx,
                              haplen, rslen, P, q2e, m2m, planes, out, 1, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gkl_pdhmm_f64(
    const void* hap_u, const void* happd_u, int H, int nu_h,
    const void* readq_u, int R, int nu_r,
    const void* ridx, const void* hidx, const void* haplen, const void* rslen,
    int P, const void* q2e, const void* m2m, void* planes, int rows_per_thread,
    int lane_warps, void* out, void* stream) {
  if (P <= 0) return 0;
  if (lane_warps < 1 || lane_warps > 32) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread) {
    case 2:
      launch<double, 2, true>(hap_u, happd_u, H, nu_h, readq_u, R, nu_r, ridx, hidx,
                               haplen, rslen, P, q2e, m2m, planes, out, lane_warps, s);
      break;
    case 4:
      launch<double, 4, true>(hap_u, happd_u, H, nu_h, readq_u, R, nu_r, ridx, hidx,
                               haplen, rslen, P, q2e, m2m, planes, out, lane_warps, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
