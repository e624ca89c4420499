// Plain-f32 PairHMM forward by haplotype columns for Hopper (sm_90a), bound
// through a plain C interface (ctypes).
//
// Replaces both column-sweep kernels of the JAX package:
// gkl_tpu/ops/pairhmm_pallas_cols.py::_kernel (reads up to 128 rows, the
// haplotype streamed in chunks) and ::_kernel_relay (any read length, in
// read chunks with the boundary row's M/X/Y carried between calls as three
// (H, P) planes).  The TPU split them because its state tiles live in
// VMEM; here one launch computes the forward of any (H, R), and the read
// chunks are a loop inside the kernel: the JAX package's two regimes are
// one kernel with no switch between them.
//
// What it computes, per lane (pair), for read rows r and hap columns j (the
// same recurrence as pairhmm_scaled.cu, without rescaling):
//   M[r][j] = prior * (pMM*M[r-1][j-1] + pGAPM*(X[r-1][j-1] + Y[r-1][j-1]))
//   X[r][j] = pMX*M[r-1][j] + pXX*X[r-1][j]
//   Y[r][j] = pMY*M[r][j-1] + pYY*Y[r][j-1]
// with quals masked & 127, 'N' (78) matching anything, the virtual row 0
// holding M = X = 0 and Y = 2^120 / haplen at every column, and the result
// the sum of M+X over the columns j < haplen of row rslen-1, in column
// order.  Malformed lanes (lengths out of range) get NaN.
//
// Design (simple first): one thread per lane.  The outer loop runs over
// read chunks of kRC rows, the loop inside it over the columns j < haplen,
// and the innermost loop over the chunk's rows, unrolled.  The previous
// column's M/X/Y of the chunk's rows live in registers (the TPU kept them
// in VMEM tiles); X is carried down the rows in a register, which replaces
// the TPU kernel's within-column Hillis-Steele scan, and each row's
// diagonal is the previous column's value of the row above.  The chunk's
// first row takes its diagonal and its X seed from the boundary row r0-1,
// which sits in three lane-minor (H, P) f32 planes in device memory (a
// warp's 32 lanes touch 32 neighbouring words); the chunk writes its own
// last row into the same planes for the next chunk, in place, since each
// thread reads column j's boundary before it overwrites it.  The first
// chunk synthesises the virtual row 0 instead, so the planes need no
// initialisation.  A chunk's per-row transition probabilities are computed
// once, from the exact ph2pr and match-to-match tables in shared memory,
// and held in registers for its whole column sweep.
//
// It takes the deduplicated batch of the row kernel (pairhmm_scaled.cu):
// unique hap and read planes, per-lane indices ridx/hidx, and the gap quals
// as planes or as constants; a lane gathers its own columns.
//
// What bounds it on this card: per cell, the operations (11 f32 products
// and sums; 2 more a column on row rslen-1, the result's sum); per column
// and chunk, 24 B of boundary traffic (M, X, Y read and written) plus the
// haplotype byte, about 24/kRC = 1.5 B a cell.  At the lane counts of a
// region (10^2-10^4 pairs) it is the latency of one thread's serial sweep:
// the X carry is a chain of a product and a sum per row.
//
// Why it exists beside the row kernel (pairhmm_scaled.cu's plain
// instance): that one keeps a lane's state along the haplotype, H values
// of M/X/Y in (H, P) scratch read and written every row, 24 B a cell; for
// H >> R this one keeps R rows of state, kRC of them in registers at a
// time, and moves 24/kRC B a cell.
//
// Numerics: built with -ftz=true (subnormals flush, as in XLA and the plain
// twin) and -fmad=false (each product and sum rounds alone).  The chunk
// height does not change the result: the arithmetic runs row by row, and
// the boundary planes hold the same f32 values the registers would.

#include <cstdint>
#include <cuda_runtime.h>

#include "pairhmm_common.cuh"

namespace {

using namespace pairhmm;

constexpr int kRC = 16;  // read rows a thread holds in registers

__global__ void pairhmm_cols_kernel(
    const uint8_t* __restrict__ hap_u, int H, int nu_h,
    const uint8_t* __restrict__ readq_u, int R, int nu_r,
    const uint8_t* __restrict__ quals_u, int c_iq, int c_dq, int c_gcp,
    const int32_t* __restrict__ ridx, const int32_t* __restrict__ hidx,
    const int32_t* __restrict__ haplen, const int32_t* __restrict__ rslen,
    int P,
    const float* __restrict__ ph2pr_g, const float* __restrict__ m2m_g,
    float* __restrict__ bm, float* __restrict__ bx, float* __restrict__ by,
    float* __restrict__ out) {
  __shared__ Tables tables;
  tables.load(ph2pr_g, m2m_g);

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int ri = ridx[p], hi = hidx[p], hl = haplen[p], rl = rslen[p];
  if (ri < 0 || ri >= nu_r || hi < 0 || hi >= nu_h || hl < 1 || hl > H ||
      rl < 1 || rl > R) {
    out[p] = __int_as_float(0x7fc00000);
    return;
  }

  const size_t plane = (size_t)R * nu_r;
  const uint8_t* hap = hap_u + hi;
  const float inity = kInitialConstant / (float)hl;
  const int nchunks = (rl + kRC - 1) / kRC;
  float acc = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int r0 = c * kRC;
    // the chunk's per-row values; rows past rslen are all zero (they feed
    // neither the result nor a later chunk)
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
    // the previous column's M/X/Y of rows r0 .. r0+kRC-1: the virtual
    // column 0 is zero
    float M[kRC], X[kRC], Y[kRC];
#pragma unroll
    for (int k = 0; k < kRC; ++k) M[k] = X[k] = Y[k] = 0.f;
    // boundary row r0-1 at the previous column: at the virtual column 0
    // only the virtual row 0 holds a value, Y = inity
    float pbm = 0.f, pbx = 0.f, pby = c == 0 ? inity : 0.f;
    const int k_last = rl - 1 - r0;  // the result row, when in this chunk
    const bool write_boundary = c + 1 < nchunks;

    // column j+1's hap byte and boundary row load while column j computes
    // (the compiler does not move them above column j's boundary stores)
    int hb_next = __ldg(hap);
    float nbm = 0.f, nbx = 0.f, nby = inity;
    if (c > 0) {
      nbm = bm[p];
      nbx = bx[p];
      nby = by[p];
    }
    for (int j = 0; j < hl; ++j) {
      const size_t idx = (size_t)j * P + p;
      const float cbm = nbm, cbx = nbx, cby = nby;  // boundary row r0-1 at column j
      const int hb = hb_next;
      if (j + 1 < hl) {
        hb_next = __ldg(hap + (size_t)(j + 1) * nu_h);
        if (c > 0) {
          nbm = bm[idx + P];
          nbx = bx[idx + P];
          nby = by[idx + P];
        }
      }
      const bool hap_n = hb == kNCode;
      float m_dg = pbm, xy_dg = pbx + pby;  // diagonal operands of row k
      float m_up = cbm, x_up = cbx;         // row k-1 of this column
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
      pbm = cbm;
      pbx = cbx;
      pby = cby;
      if (write_boundary) {
        bm[idx] = M[kRC - 1];
        bx[idx] = X[kRC - 1];
        by[idx] = Y[kRC - 1];
      }
    }
  }
  out[p] = acc;
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
    void* out, void* stream) {
  if (P <= 0) return 0;
  const int block = block_for(P);
  const int grid = (P + block - 1) / block;
  pairhmm_cols_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(hap_u), H, nu_h,
      static_cast<const uint8_t*>(readq_u), R, nu_r,
      static_cast<const uint8_t*>(quals_u), c_iq, c_dq, c_gcp,
      static_cast<const int32_t*>(ridx), static_cast<const int32_t*>(hidx),
      static_cast<const int32_t*>(haplen), static_cast<const int32_t*>(rslen),
      P, static_cast<const float*>(ph2pr), static_cast<const float*>(m2m),
      static_cast<float*>(bm), static_cast<float*>(bx), static_cast<float*>(by),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
