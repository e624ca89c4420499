// PairHMM forward by read rows for Hopper (sm_90a), in two instances of one
// template, bound through a plain C interface (ctypes).
//
// The scaled instance (gkl_pairhmm_scaled) replaces
// gkl_tpu/ops/pairhmm_pallas.py::_scaled_kernel together with its
// on-device prologue: the lane gather of expand_indexed_planes and the
// transition prep (_ph2pr_arith, _m2m_arith64).  One launch takes the
// deduplicated batch (unique hap and read planes plus per-lane indices) and
// returns, per lane, the forward probability as mantissa * 2^exp2 and a
// window flag.
//
// The plain instance (gkl_pairhmm_rows, kScaled = false) replaces
// gkl_tpu/ops/pairhmm_pallas.py::_kernel, the f32 forward without
// rescaling: it drops the renormalisation, the flag and the exponent
// accumulator, stops at row rslen-1, and writes the raw f32 result per
// lane (what the scaled instance computes for a lane whose values stay in
// the f32 range).  A dense batch reaches it with ridx = hidx = 0..P-1.
//
// What it computes, per lane (pair), for read rows r and hap columns j:
//   M[r][j] = prior * (pMM*M[r-1][j-1] + pGAPM*(X[r-1][j-1] + Y[r-1][j-1]))
//   X[r][j] = pMX*M[r-1][j] + pXX*X[r-1][j]
//   Y[r][j] = pMY*M[r][j-1] + pYY*Y[r][j-1]
// with quals masked & 127, 'N' (78) matching anything, Y[-1][*] =
// 2^120 / haplen entering on row 0 only, and the result the sum of M+X
// over the valid columns of row rslen-1.  Every 8 rows the lane's state is
// renormalised to about 2^90 by exact power-of-two factors, and the
// accumulator keeps its own exponent.  The flag marks a lane where a
// valid column was alive at the previous renormalisation (or at its row-3
// sample) and is zero at this one, in a chunk that starts before rslen: a
// path died against the f32 window, and the caller rescues the lane in
// f64 if its result is deep.
//
// Design (simple first): one thread per lane; rows in the outer loop,
// columns in the inner loop.  The previous row's M/X/Y live in device
// scratch of shape (H, P), lane-minor, so a warp's 32 lanes touch 32
// neighbouring words; Y is carried in a register along the column loop,
// which replaces the TPU kernel's Hillis-Steele scan.  Transition
// probabilities come from the exact context tables (128-entry ph2pr and the
// 8256-entry triangular match-to-match cache for quals <= 127) held in
// shared memory.  Only columns < haplen and rows < 8*ceil(rslen/8) (plain
// instance: rslen) are visited: columns past haplen never feed valid ones,
// and later rows feed neither the result nor the (rslen-gated) flag.
//
// What bounds it on this card: scratch traffic, about 24 B per cell
// (read and write M, X, Y in f32) plus one hap byte, against 11 f32
// products and sums a cell (and 2 a column on row rslen-1, the result's
// sum); at small lane counts the few warps in flight.
// Later work keeps the state in shared memory or registers (warp-per-lane
// anti-diagonals, as in gpuPairHMM).
//
// Numerics: built with -ftz=true, so f32 subnormals flush to zero as on
// the TPU the 2^90 window and the flag were tuned on: a column "dies"
// where it died there.  Built with -fmad=false, so products and sums
// round one by one as in the plain version.

#include <cstdint>
#include <cuda_runtime.h>

#include "pairhmm_common.cuh"

namespace {

using namespace pairhmm;

constexpr float kUp = 0x1p90f;           // renormalisation target

__device__ __forceinline__ int exponent_of(float v) {
  const int e = ((__float_as_int(v) >> 23) & 0xFF) - 127;
  return min(max(e, -126), 126);
}

// 2^e for e in [-126, 127]
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

// 2^d for d <= 0 as the product of two exact factors (flushes below 2^-126)
__device__ __forceinline__ float pow2m(int d) {
  const int d1 = max(d, -126);
  const int d2 = min(max(d - d1, -126), 0);
  return pow2(d1) * pow2(d2);
}

template <bool kScaled>
__global__ void pairhmm_kernel(
    const uint8_t* __restrict__ hap_u, int H, int nu_h,
    const uint8_t* __restrict__ readq_u, int R, int nu_r,
    const uint8_t* __restrict__ quals_u, int c_iq, int c_dq, int c_gcp,
    const int32_t* __restrict__ ridx, const int32_t* __restrict__ hidx,
    const int32_t* __restrict__ haplen, const int32_t* __restrict__ rslen,
    int P,
    const float* __restrict__ ph2pr_g, const float* __restrict__ m2m_g,
    float* __restrict__ Ms, float* __restrict__ Xs, float* __restrict__ Ys,
    uint8_t* __restrict__ live,
    int32_t* __restrict__ out) {
  __shared__ Tables tables;
  tables.load(ph2pr_g, m2m_g);

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int ri = ridx[p], hi = hidx[p], hl = haplen[p], rl = rslen[p];
  if (ri < 0 || ri >= nu_r || hi < 0 || hi >= nu_h || hl < 1 || hl > H ||
      rl < 1 || rl > R) {
    // malformed lane: no result (NaN mantissa) and flag -1
    out[p] = 0x7fc00000;
    if constexpr (kScaled) {
      out[P + p] = 0;
      out[2 * P + p] = -1;
    }
    return;
  }

  const size_t plane = (size_t)R * nu_r;
  const uint8_t* hap = hap_u + hi;
  const float inity = kInitialConstant / (float)hl;
  const int nchunks = (rl + 7) >> 3;

  float acc_m = 0.f;  // result mantissa, exponent e_acc
  int e_acc = 0;
  int e_state = 0;    // state values are v * 2^e_state
  int flag = 0;
  float sf = 1.f;     // pending renormalisation (v * sf) * kUp, applied on read

  for (int c = 0; c < nchunks; ++c) {
    float acc_chunk = 0.f;
    float mx = 0.f;
    int lost = 0;
    for (int k = 0; k < 8; ++k) {
      const int r = 8 * c + k;
      if (!kScaled && r >= rl) break;
      const size_t ro = (size_t)r * nu_r + ri;
      const int rb = readq_u[ro];
      const Row w = row_of(tables, readq_u, quals_u, c_iq, c_dq, c_gcp, plane, ro);
      const bool read_n = rb == kNCode;
      const bool last_row = r + 1 == rl;
      const bool first_row = r == 0;
      const bool rescale = kScaled && k == 0 && c > 0;

      // t carries pMM*M + pGAPM*(X + Y) of the previous row's column j-1;
      // for column 0 that is pGAPM * Y[r-1][-1] (inity on row 0 only)
      float t = first_row ? w.pgapm * inity : 0.f;
      float m_left = 0.f, y_left = 0.f, row_sum = 0.f;
      for (int j = 0; j < hl; ++j) {
        const size_t idx = (size_t)j * P + p;
        float mp, xp, yp;
        if (first_row) {
          mp = 0.f;
          xp = 0.f;
          yp = inity;
        } else {
          mp = Ms[idx];
          xp = Xs[idx];
          yp = Ys[idx];
          if (rescale) {
            mp = (mp * sf) * kUp;
            xp = (xp * sf) * kUp;
            yp = (yp * sf) * kUp;
          }
        }
        const int hb = hap[(size_t)j * nu_h];
        const bool match = hb == rb || hb == kNCode || read_n;
        const float prior = match ? w.dmatch : w.dmis;
        const float mn = prior * t;
        const float xn = w.pmx * mp + w.pc * xp;
        const float yn = w.pc * y_left + w.pmy * m_left;
        t = w.pmm * mp + w.pgapm * (xp + yp);
        Ms[idx] = mn;
        Xs[idx] = xn;
        Ys[idx] = yn;
        m_left = mn;
        y_left = yn;
        if (last_row) row_sum += mn + xn;
        if constexpr (kScaled) {
          const int alive = (mn != 0.f) | (xn != 0.f) | (yn != 0.f);
          if (k == 3) {
            // bit 0: alive at the last renormalisation; bit 1: row-3 sample
            const int before = c == 0 ? 1 : (live[idx] & 1);
            live[idx] = (uint8_t)(before | (alive << 1));
          } else if (k == 7) {
            const int b = live[idx];
            lost |= (b & 1) & ~((b >> 1) & alive);
            live[idx] = (uint8_t)alive;
            mx = fmaxf(mx, fmaxf(mn, fmaxf(xn, yn)));
          }
        }
      }
      if (last_row) acc_chunk += row_sum;
    }

    if constexpr (!kScaled) {
      acc_m += acc_chunk;  // nonzero only in the chunk that holds row rslen-1
      continue;
    }
    // fold the chunk into the accumulator by value exponents
    const bool has_acc = acc_m > 0.f, has_chunk = acc_chunk > 0.f;
    const int chunk_e = e_state + exponent_of(acc_chunk);
    const int e_new = (has_acc && has_chunk) ? max(e_acc, chunk_e)
                                             : (has_acc ? e_acc : chunk_e);
    const int d_acc = has_acc ? e_acc - e_new : 0;
    const int d_chunk = has_chunk ? e_state - e_new : 0;
    acc_m = acc_m * pow2m(d_acc) + acc_chunk * pow2m(d_chunk);
    const int ea = acc_m > 0.f ? exponent_of(acc_m) : 0;
    acc_m = acc_m * pow2(-ea);
    e_acc = acc_m > 0.f ? e_new + ea : e_state;

    flag |= lost;  // this chunk starts before rslen by construction
    const int e = exponent_of(mx);
    sf = pow2(-e);
    e_state += e - 90;
  }
  out[p] = __float_as_int(acc_m);
  if constexpr (kScaled) {
    out[P + p] = e_acc;
    out[2 * P + p] = flag;
  }
}

}  // namespace

extern "C" int gkl_pairhmm_scaled(
    const void* hap_u, int H, int nu_h,
    const void* readq_u, int R, int nu_r,
    const void* quals_u, int c_iq, int c_dq, int c_gcp,
    const void* ridx, const void* hidx, const void* haplen, const void* rslen,
    int P,
    const void* ph2pr, const void* m2m,
    void* Ms, void* Xs, void* Ys, void* live,
    void* out, void* stream) {
  if (P <= 0) return 0;
  const int block = block_for(P);
  const int grid = (P + block - 1) / block;
  pairhmm_kernel<true><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(hap_u), H, nu_h,
      static_cast<const uint8_t*>(readq_u), R, nu_r,
      static_cast<const uint8_t*>(quals_u), c_iq, c_dq, c_gcp,
      static_cast<const int32_t*>(ridx), static_cast<const int32_t*>(hidx),
      static_cast<const int32_t*>(haplen), static_cast<const int32_t*>(rslen),
      P, static_cast<const float*>(ph2pr), static_cast<const float*>(m2m),
      static_cast<float*>(Ms), static_cast<float*>(Xs), static_cast<float*>(Ys),
      static_cast<uint8_t*>(live), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gkl_pairhmm_rows(
    const void* hap_u, int H, int nu_h,
    const void* readq_u, int R, int nu_r,
    const void* quals_u, int c_iq, int c_dq, int c_gcp,
    const void* ridx, const void* hidx, const void* haplen, const void* rslen,
    int P,
    const void* ph2pr, const void* m2m,
    void* Ms, void* Xs, void* Ys,
    void* out, void* stream) {
  if (P <= 0) return 0;
  const int block = block_for(P);
  const int grid = (P + block - 1) / block;
  pairhmm_kernel<false><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(hap_u), H, nu_h,
      static_cast<const uint8_t*>(readq_u), R, nu_r,
      static_cast<const uint8_t*>(quals_u), c_iq, c_dq, c_gcp,
      static_cast<const int32_t*>(ridx), static_cast<const int32_t*>(hidx),
      static_cast<const int32_t*>(haplen), static_cast<const int32_t*>(rslen),
      P, static_cast<const float*>(ph2pr), static_cast<const float*>(m2m),
      static_cast<float*>(Ms), static_cast<float*>(Xs), static_cast<float*>(Ys),
      nullptr, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
