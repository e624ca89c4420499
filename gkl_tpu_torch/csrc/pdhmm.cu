// PDHMM forward likelihood in f32 for Hopper (sm_90a), bound through a
// plain C interface (ctypes).
//
// Replaces both PDHMM kernels of the JAX package:
// gkl_tpu/ops/pdhmm_pallas.py::_kernel (reads within its VMEM budget) and
// ::_chunk_kernel (longer reads, in <=512-row chunks with six boundary
// planes carried between calls), together with their prologue _host_prep
// / chunked_prep and the indexed lane expansion of api_pdhmm.py's
// _pdhmm_indexed_jit.  Those splits exist because the TPU kernel keeps
// its state in 16 MB of VMEM; here the state lies on the haplotype axis in
// device memory, so any read length runs in one launch.
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
// diagonal and left operands above with the branch) in AFTER_DEL.  The
// state is a per-column machine over the PD bytes, row-invariant, and is
// run on the fly here.  D[0][*] = 2^120 / haplen; the result is the sum of
// M + I over the last row's columns, before the log.
//
// Design (simple first): one thread per lane, rows in the outer loop and
// columns in the inner loop, as the oracle.  The previous row's M, I, D,
// BM, BI, BD live in six (H, P) f32 device planes, lane-minor, so a warp's
// 32 lanes touch 32 neighbouring words; the left and diagonal operands
// ride in registers.  Columns go in tiles of kTile whose plane loads are
// issued together.  The transition tables are the exact
// context.pdhmm_context("float32") ones (q2e, 255 entries; match-to-match,
// 32,640) in shared memory, read once per row; the lane gather of the
// unique read and haplotype columns happens in the kernel, so only the
// deduplicated planes go to the card.
//
// What bounds it on this card: plane traffic, 48 B per cell (six f32 read
// and written), and at region lane counts (10^3-10^4 pairs) the few warps
// in flight; the 130 KB of tables allow one block per SM.  Later designs
// keep the state in registers along anti-diagonals.
//
// Numerics: built with -ftz=true (subnormals flush, as in XLA and the
// plain twin) and -fmad=false (each product and sum rounds alone, in the
// oracle's order).  Lanes whose result is below MIN_ACCEPTED are
// recomputed on the host oracle by the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSNP = 1;
constexpr int kDelStart = 2;
constexpr int kDelEnd = 4;
constexpr int kNormal = 0;
constexpr int kInsideDel = 1;
constexpr int kAfterDel = 2;
constexpr int kNCode = 78;  // 'N'
constexpr int kMaxQual = 254;
constexpr int kQ2E = kMaxQual + 1;
constexpr int kTri = (kMaxQual + 1) * (kMaxQual + 2) / 2;
constexpr int kSmemFloats = 256 + kTri;
constexpr float kInitialCondition = 0x1p120f;
constexpr int kTile = 4;
constexpr int kMaxBlock = 512;

__device__ __forceinline__ int base_bit(int b) {
  switch (b) {
    case 'A': case 'a': return 8;
    case 'C': case 'c': return 16;
    case 'G': case 'g': return 32;
    case 'T': case 't': return 64;
    default: return 0;
  }
}

__global__ void __launch_bounds__(kMaxBlock) pdhmm_kernel(
    const uint8_t* __restrict__ hap_u, const uint8_t* __restrict__ happd_u,
    int H, int nu_h,
    const uint8_t* __restrict__ readq_u, int R, int nu_r,
    const int32_t* __restrict__ ridx, const int32_t* __restrict__ hidx,
    const int32_t* __restrict__ haplen, const int32_t* __restrict__ rslen,
    int P, const float* __restrict__ q2e_g, const float* __restrict__ m2m_g,
    float* __restrict__ state, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* q2e = smem;
  float* m2m = smem + 256;
  for (int i = threadIdx.x; i < kQ2E; i += blockDim.x) q2e[i] = q2e_g[i];
  for (int i = threadIdx.x; i < kTri; i += blockDim.x) m2m[i] = m2m_g[i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int ri = ridx[p], hi = hidx[p], hl = haplen[p], rl = rslen[p];
  if (ri < 0 || ri >= nu_r || hi < 0 || hi >= nu_h || hl < 1 || hl > H ||
      rl < 1 || rl > R) {
    out[p] = __int_as_float(0x7fc00000);  // malformed lane: NaN
    return;
  }

  const size_t Ps = (size_t)P, HP = (size_t)H * P;
  float* Mp = state;
  float* Ip = state + HP;
  float* Dp = state + 2 * HP;
  float* BMp = state + 3 * HP;
  float* BIp = state + 4 * HP;
  float* BDp = state + 5 * HP;
  const float ic = kInitialCondition / (float)hl;
  for (int j = 0; j < hl; ++j) {  // row 0: D = ic, the rest 0
    const size_t idx = j * Ps + p;
    Mp[idx] = Ip[idx] = BMp[idx] = BIp[idx] = BDp[idx] = 0.f;
    Dp[idx] = ic;
  }

  const size_t plane = (size_t)R * nu_r;
  const uint8_t* hap = hap_u + hi;
  const uint8_t* pdb = happd_u + hi;
  for (int r = 1; r <= rl; ++r) {
    const size_t ro = (size_t)(r - 1) * nu_r + ri;
    const int x = readq_u[ro];
    const int qv = min((int)readq_u[plane + ro], kMaxQual);
    const int iqv = min((int)readq_u[2 * plane + ro], kMaxQual);
    const int dqv = min((int)readq_u[3 * plane + ro], kMaxQual);
    const int gv = min((int)readq_u[4 * plane + ro], kMaxQual);
    const int qmax = max(iqv, dqv), qmin = min(iqv, dqv);
    const float t_mm = m2m[((qmax * (qmax + 1)) >> 1) + qmin];
    const float t_mi = q2e[iqv];
    const float t_md = q2e[dqv];
    const float t_im = 1.f - q2e[gv];
    const float t_dd = q2e[gv];
    const float err = q2e[qv];
    const float p_match = 1.f - err;
    const float p_mis = err / 3.f;
    const int xbit = base_bit(x);
    const bool x_is_n = x == kNCode;

    // diagonal operands (row r-1, column j-1): column 0 is 0, except D on
    // row 1, which reads D[0][0] = ic; left operands (row r, column j-1)
    float md = 0.f, id = 0.f, dd = r == 1 ? ic : 0.f, bmd = 0.f, bid = 0.f, bdd = 0.f;
    float ml = 0.f, il = 0.f, dl = 0.f, bml = 0.f, bil = 0.f, bdl = 0.f;
    int st = kNormal;
    for (int j0 = 0; j0 < hl; j0 += kTile) {
      float mt[kTile], it[kTile], dt[kTile], bmt[kTile], bit[kTile], bdt[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const size_t idx = (j0 + t) * Ps + p;
        if (j0 + t < hl) {
          mt[t] = Mp[idx];
          it[t] = Ip[idx];
          dt[t] = Dp[idx];
          bmt[t] = BMp[idx];
          bit[t] = BIp[idx];
          bdt[t] = BDp[idx];
        }
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int j = j0 + t;
        if (j < hl) {
          const int y = hap[(size_t)j * nu_h];
          const int pd = pdb[(size_t)j * nu_h];
          const bool pd_match = (pd & kSNP) && (pd & xbit);
          const bool match = x == y || x_is_n || y == kNCode || pd_match;
          const float prior = match ? p_match : p_mis;

          float bm, bi, bd;
          float m_dg = md, i_dg = id, d_dg = dd, m_le = ml, d_le = dl;
          if (st == kNormal) {
            bm = ml;
            bd = dl;
            bi = il;
          } else if (st == kInsideDel) {
            bm = bml;
            bd = bdl;
            bi = bil;
          } else {  // AFTER_DEL
            bm = fmaxf(bml, ml);
            bd = fmaxf(bdl, dl);
            bi = fmaxf(bil, il);
            m_dg = fmaxf(md, bmd);
            i_dg = fmaxf(id, bid);
            d_dg = fmaxf(dd, bdd);
            m_le = fmaxf(ml, bml);
            d_le = fmaxf(dl, bdl);
          }
          const float m = prior * (m_dg * t_mm + i_dg * t_im + d_dg * t_im);
          const float d = m_le * t_md + d_le * t_dd;
          const float i = (pd & kDelEnd)
                              ? fmaxf(bmt[t], mt[t]) * t_mi + fmaxf(bit[t], it[t]) * t_dd
                              : mt[t] * t_mi + it[t] * t_dd;
          if (st == kAfterDel) st = kNormal;
          if (pd & kDelStart) st = kInsideDel;
          if (pd & kDelEnd) st = kAfterDel;

          md = mt[t];
          id = it[t];
          dd = dt[t];
          bmd = bmt[t];
          bid = bit[t];
          bdd = bdt[t];
          ml = mt[t] = m;
          il = it[t] = i;
          dl = dt[t] = d;
          bml = bmt[t] = bm;
          bil = bit[t] = bi;
          bdl = bdt[t] = bd;
        }
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const size_t idx = (j0 + t) * Ps + p;
        if (j0 + t < hl) {
          Mp[idx] = mt[t];
          Ip[idx] = it[t];
          Dp[idx] = dt[t];
          BMp[idx] = bmt[t];
          BIp[idx] = bit[t];
          BDp[idx] = bdt[t];
        }
      }
    }
  }

  float total = 0.f;
  for (int j = 0; j < hl; ++j) total += Mp[j * Ps + p] + Ip[j * Ps + p];
  out[p] = total;
}

}  // namespace

extern "C" int gkl_pdhmm(
    const void* hap_u, const void* happd_u, int H, int nu_h,
    const void* readq_u, int R, int nu_r,
    const void* ridx, const void* hidx, const void* haplen, const void* rslen,
    int P, const void* q2e, const void* m2m, void* state, void* out,
    void* stream) {
  if (P <= 0) return 0;
  const int smem = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pdhmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the tables allow one block per SM: spread the lanes over every SM
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int block = (P + sms - 1) / sms;
  block = ((block + 31) / 32) * 32;
  block = block < 32 ? 32 : (block > kMaxBlock ? kMaxBlock : block);
  const int grid = (P + block - 1) / block;
  pdhmm_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(hap_u), static_cast<const uint8_t*>(happd_u),
      H, nu_h, static_cast<const uint8_t*>(readq_u), R, nu_r,
      static_cast<const int32_t*>(ridx), static_cast<const int32_t*>(hidx),
      static_cast<const int32_t*>(haplen), static_cast<const int32_t*>(rslen),
      P, static_cast<const float*>(q2e), static_cast<const float*>(m2m),
      static_cast<float*>(state), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
