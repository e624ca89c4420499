// Plain-f32 PairHMM forward by haplotype columns for Hopper (sm_90a), bound
// through a plain C interface (ctypes): a warp per lane, on an anti-diagonal
// wavefront.
//
// Replaces both column-sweep kernels of the JAX package:
// gkl_tpu/ops/pairhmm_pallas_cols.py::_kernel (reads up to 128 rows, the
// haplotype streamed in chunks) and ::_kernel_relay (any read length, in
// read chunks with the boundary row's M/X/Y carried between calls as three
// (H, P) planes).  The TPU split them because its state tiles live in
// VMEM; here one launch computes the forward of any (H, R), and the read
// passes are a loop inside the kernel.
//
// What it computes, per lane (pair), for read rows r and hap columns j (the
// same recurrence as pairhmm_scaled.cu, without rescaling):
//   M[r][j] = prior * (pMM*M[r-1][j-1] + pGAPM*(X[r-1][j-1] + Y[r-1][j-1]))
//   X[r][j] = pMX*M[r-1][j] + pXX*X[r-1][j]
//   Y[r][j] = pMY*M[r][j-1] + pYY*Y[r][j-1]
// with quals masked & 127, 'N' (78) matching anything, the virtual row 0
// holding M = X = 0 and Y = 2^120 / haplen at every column, and the result
// the sum of M+X over the columns j < haplen of row rslen-1, in column
// order.  Malformed lanes (lengths or indices out of range) get NaN.
//
// Design: a warp per lane.  A pass covers 32 * kRC read rows; thread t of
// the warp owns the strip of kRC consecutive rows t*kRC .. t*kRC+kRC-1 of
// the pass, holds their per-row transition probabilities and their M/X/Y
// at its last column in registers, and runs down its rows with X carried
// in a register.  The strips form an anti-diagonal wavefront: at step s
// thread t computes column j = s - t.  Its operands from the row above
// come from thread t-1 by __shfl_up_sync: that thread's last-row M/X/Y at
// column j, computed at step s-1, and at column j-1, received one step
// earlier and kept.  The hap byte rides down the warp the same way, so
// only thread 0's column is loaded; thread 0 takes its row above from the
// pass boundary (the virtual row 0 on the first pass).  The lane's warp
// fetches the hap bytes and boundary row 32 columns ahead, one column a
// thread, and thread 0 takes its column by __shfl_sync.  A pass takes
// haplen + 31 steps (fewer on a last pass whose rows end early); its last
// row goes into three lane-minor (H, P) f32 planes that the next pass's
// thread 0 reads, in place: a column is fetched before its new value
// exists (the write depends, through the shuffles, on the fetched value).
// Control is warp-uniform: the loop bounds and the exits depend only on
// the lane, and threads whose column lies outside [0, haplen), or whose
// rows lie past rslen, take part in every shuffle and store nothing.
//
// It takes the deduplicated batch of the row kernel (pairhmm_scaled.cu):
// unique hap and read planes, per-lane indices ridx/hidx, and the gap quals
// as planes or as constants; a lane gathers its own columns.  kRC is 4, 8
// or 16 (gkl_tpu_torch/ops/pairhmm_cols.py::cols_geometry picks it from
// the read bucket): 4 holds reads of up to 128 rows in one pass with every
// thread busy, 16 covers 512 rows a pass for long reads.
//
// What bounds it on this card: per cell, the operations (11 f32 products
// and sums; 2 more a column on row rslen-1, the result's sum); per column
// and pass, 24 B of boundary traffic and a hap byte, about 24/(32*kRC) B a
// cell.  The one-thread sweep this design replaced was bound by latency:
// a lane's rslen x haplen cells were one thread's dependent chain, and a
// launch of a few long lanes used a few threads of the card.  Here a
// lane's chain is haplen + 31 steps a pass, each kRC rows deep (the X
// carry: a product and a sum a row), and 32 threads work on it at once;
// launches with many lanes have a warp for each.
//
// Numerics: built with -ftz=true (subnormals flush, as in XLA and the plain
// twin) and -fmad=false (each product and sum rounds alone).  Every cell
// does the products and sums of the one-thread sweep in the same order,
// and the result is summed in column order by the thread that owns row
// rslen-1, so neither the strip height nor the passes change a bit of the
// result: the boundary planes and the shuffles carry the same f32 values
// that registers would.

#include <cstdint>
#include <cuda_runtime.h>

#include "pairhmm_common.cuh"

namespace {

using namespace pairhmm;

constexpr unsigned kWarp = 0xffffffffu;

// One haplotype column as a thread fetches it ahead of the wavefront: the
// hap byte and the boundary row above the pass (M, X, Y).
struct Column {
  int hb;
  float m, x, y;
};

template <int kRC>
__global__ void pairhmm_cols_kernel(
    const uint8_t* __restrict__ hap_u, int H, int nu_h,
    const uint8_t* __restrict__ readq_u, int R, int nu_r,
    const uint8_t* __restrict__ quals_u, int c_iq, int c_dq, int c_gcp,
    const int32_t* __restrict__ ridx, const int32_t* __restrict__ hidx,
    const int32_t* __restrict__ haplen, const int32_t* __restrict__ rslen,
    int P,
    const float* __restrict__ ph2pr_g, const float* __restrict__ m2m_g,
    float* bm, float* bx, float* by,
    float* __restrict__ out) {
  constexpr int kPass = 32 * kRC;  // read rows of one pass
  __shared__ Tables tables;
  tables.load(ph2pr_g, m2m_g);

  const int t = threadIdx.x & 31;  // the strip of each pass this thread owns
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp: p is the warp's lane
  const int ri = ridx[p], hi = hidx[p], hl = haplen[p], rl = rslen[p];
  if (ri < 0 || ri >= nu_r || hi < 0 || hi >= nu_h || hl < 1 || hl > H ||
      rl < 1 || rl > R) {
    if (t == 0) out[p] = __int_as_float(0x7fc00000);
    return;
  }

  const size_t plane = (size_t)R * nu_r;
  const uint8_t* hap = hap_u + hi;
  const float inity = kInitialConstant / (float)hl;
  const int npasses = (rl + kPass - 1) / kPass;
  float acc = 0.f;

  for (int c = 0; c < npasses; ++c) {
    const bool first = c == 0;
    const int r0 = c * kPass + t * kRC;  // this thread's first row
    // the strip's per-row values; rows past rslen are all zero (they feed
    // neither the result nor a later pass)
    float pmm[kRC], pgapm[kRC], pmx[kRC], pmy[kRC], pc[kRC], dmatch[kRC], dmis[kRC];
    int rb[kRC];
#pragma unroll
    for (int k = 0; k < kRC; ++k) {
      const int r = r0 + k;
      if (r < rl) {
        const size_t ro = (size_t)r * nu_r + ri;
        const Row w = row_of(tables, readq_u, quals_u, c_iq, c_dq, c_gcp, plane, ro);
        pmm[k] = w.pmm;
        pgapm[k] = w.pgapm;
        pmx[k] = w.pmx;
        pmy[k] = w.pmy;
        pc[k] = w.pc;
        dmatch[k] = w.dmatch;
        dmis[k] = w.dmis;
        rb[k] = readq_u[ro];
      } else {
        pmm[k] = pc[k] = pgapm[k] = pmx[k] = pmy[k] = dmatch[k] = dmis[k] = 0.f;
        rb[k] = -1;
      }
    }
    // the strip's M/X/Y at its previous column: the virtual column 0 is zero
    float M[kRC], X[kRC], Y[kRC];
#pragma unroll
    for (int k = 0; k < kRC; ++k) M[k] = X[k] = Y[k] = 0.f;
    const int k_last = rl - 1 - r0;  // the result row, when in this strip
    // the pass ends when the thread holding its last row below rslen has
    // done column haplen-1; a pass with a successor runs all 32 threads,
    // and thread 31 writes the boundary row
    const int t_end = min(31, (rl - 1 - c * kPass) / kRC);
    const int nsteps = hl + t_end;
    const bool write_boundary = c + 1 < npasses && t == 31;

    // the row above the strip at column j-1 (the diagonal operands): at
    // the virtual column 0 only the virtual row 0 holds a value
    float dg_m = 0.f, dg_x = 0.f, dg_y = first && t == 0 ? inity : 0.f;
    // the strip's last row at its last column, for thread t+1
    float lo_m = 0.f, lo_x = 0.f, lo_y = 0.f;
    int hb = 0;  // the hap byte of this thread's column

    auto fetch = [&](int col) {
      Column v{0, 0.f, 0.f, inity};  // the virtual row 0 on the first pass
      if (col < hl) {
        v.hb = __ldg(hap + (size_t)col * nu_h);
        if (!first) {
          const size_t idx = (size_t)col * P + p;
          v.m = bm[idx];
          v.x = bx[idx];
          v.y = by[idx];
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
      float up_x = __shfl_up_sync(kWarp, lo_x, 1);
      float up_y = __shfl_up_sync(kWarp, lo_y, 1);
      const int hb_up = __shfl_up_sync(kWarp, hb, 1);
      const int hb0 = __shfl_sync(kWarp, cur.hb, w);
      float b_m = 0.f, b_x = 0.f, b_y = inity;
      if (!first) {
        b_m = __shfl_sync(kWarp, cur.m, w);
        b_x = __shfl_sync(kWarp, cur.x, w);
        b_y = __shfl_sync(kWarp, cur.y, w);
      }
      if (t == 0) {
        up_m = b_m;
        up_x = b_x;
        up_y = b_y;
      }
      hb = t == 0 ? hb0 : hb_up;

      const int j = s - t;
      if (j >= 0 && j < hl) {
        const bool hap_n = hb == kNCode;
        float m_dg = dg_m, xy_dg = dg_x + dg_y;  // diagonal operands of row k
        float m_up = up_m, x_up = up_x;          // row k-1 of this column
#pragma unroll
        for (int k = 0; k < kRC; ++k) {
          const bool match = hb == rb[k] || hap_n || rb[k] == kNCode;
          const float prior = match ? dmatch[k] : dmis[k];
          const float mn = prior * (pmm[k] * m_dg + pgapm[k] * xy_dg);
          const float xn = pmx[k] * m_up + pc[k] * x_up;
          const float yn = pmy[k] * M[k] + pc[k] * Y[k];
          m_dg = M[k];
          xy_dg = X[k] + Y[k];
          M[k] = mn;
          X[k] = xn;
          Y[k] = yn;
          m_up = mn;
          x_up = xn;
          if (k == k_last) acc += mn + xn;
        }
        lo_m = M[kRC - 1];
        lo_x = X[kRC - 1];
        lo_y = Y[kRC - 1];
        if (write_boundary) {
          const size_t idx = (size_t)j * P + p;
          bm[idx] = lo_m;
          bx[idx] = lo_x;
          by[idx] = lo_y;
        }
      }
      dg_m = up_m;
      dg_x = up_x;
      dg_y = up_y;
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
void launch(const void* hap_u, int H, int nu_h, const void* readq_u, int R, int nu_r,
            const void* quals_u, int c_iq, int c_dq, int c_gcp, const void* ridx,
            const void* hidx, const void* haplen, const void* rslen, int P,
            const void* ph2pr, const void* m2m, void* bm, void* bx, void* by, void* out,
            cudaStream_t stream) {
  const int warps = warps_for(P);
  const int grid = (P + warps - 1) / warps;
  pairhmm_cols_kernel<kRC><<<grid, 32 * warps, 0, stream>>>(
      static_cast<const uint8_t*>(hap_u), H, nu_h,
      static_cast<const uint8_t*>(readq_u), R, nu_r,
      static_cast<const uint8_t*>(quals_u), c_iq, c_dq, c_gcp,
      static_cast<const int32_t*>(ridx), static_cast<const int32_t*>(hidx),
      static_cast<const int32_t*>(haplen), static_cast<const int32_t*>(rslen),
      P, static_cast<const float*>(ph2pr), static_cast<const float*>(m2m),
      static_cast<float*>(bm), static_cast<float*>(bx), static_cast<float*>(by),
      static_cast<float*>(out));
}

}  // namespace

extern "C" int gkl_pairhmm_cols(
    const void* hap_u, int H, int nu_h,
    const void* readq_u, int R, int nu_r,
    const void* quals_u, int c_iq, int c_dq, int c_gcp,
    const void* ridx, const void* hidx, const void* haplen, const void* rslen,
    int P,
    const void* ph2pr, const void* m2m,
    void* bm, void* bx, void* by,
    int rows_per_thread,
    void* out, void* stream) {
  if (P <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread) {
    case 4:
      launch<4>(hap_u, H, nu_h, readq_u, R, nu_r, quals_u, c_iq, c_dq, c_gcp, ridx, hidx,
                haplen, rslen, P, ph2pr, m2m, bm, bx, by, out, s);
      break;
    case 8:
      launch<8>(hap_u, H, nu_h, readq_u, R, nu_r, quals_u, c_iq, c_dq, c_gcp, ridx, hidx,
                haplen, rslen, P, ph2pr, m2m, bm, bx, by, out, s);
      break;
    case 16:
      launch<16>(hap_u, H, nu_h, readq_u, R, nu_r, quals_u, c_iq, c_dq, c_gcp, ridx, hidx,
                 haplen, rslen, P, ph2pr, m2m, bm, bx, by, out, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
