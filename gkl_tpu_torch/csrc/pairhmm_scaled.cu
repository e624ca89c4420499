// PairHMM forward by read rows for Hopper (sm_90a), in two instances of one
// template, bound through a plain C interface (ctypes): eight threads a
// lane on an 8-row band wavefront.
//
// The scaled instance (gkl_pairhmm_scaled) replaces
// gkl_tpu/ops/pairhmm_pallas.py::_scaled_kernel (line 69) together with its
// on-device prologue: the lane gather of expand_indexed_planes and the
// transition prep (_ph2pr_arith, _m2m_arith64).  One launch takes the
// deduplicated batch (unique hap and read planes plus per-lane indices) and
// returns, per lane, the forward probability as mantissa * 2^exp2 and a
// window flag.
//
// The plain instance (gkl_pairhmm_rows, kScaled = false) replaces
// gkl_tpu/ops/pairhmm_pallas.py::_kernel (line 268), the f32 forward
// without rescaling: it drops the renormalisation, the flag and the
// exponent accumulator, stops at row rslen-1, and writes the raw f32 result
// per lane (what the scaled instance computes for a lane whose values stay
// in the f32 range).  A dense batch reaches it with ridx = hidx = 0..P-1.
//
// What it computes, per lane (pair), for read rows r and hap columns j:
//   M[r][j] = prior * (pMM*M[r-1][j-1] + pGAPM*(X[r-1][j-1] + Y[r-1][j-1]))
//   X[r][j] = pMX*M[r-1][j] + pXX*X[r-1][j]
//   Y[r][j] = pMY*M[r][j-1] + pYY*Y[r][j-1]
// with quals masked & 127, 'N' (78) matching anything, Y[-1][*] =
// 2^120 / haplen entering on row 0 only, and the result the sum of M+X
// over the valid columns of row rslen-1, in column order.  The rows go in
// bands of 8; at the end of band c the lane's state is renormalised to
// about 2^90 by exact power-of-two factors taken from the maximum over all
// columns of row 8c+7, applied when row 8c+8 reads its row above, and the
// accumulator keeps its own exponent.  The flag marks a lane where a valid
// column was alive at the previous renormalisation (or at its row-3
// sample) and is zero at this one, in a band that starts before rslen: a
// path died against the f32 window, and the caller rescues the lane in
// f64 if its result is deep.
//
// Design: eight threads a lane, four lanes a warp.  Thread k of a lane's
// group owns row 8c+k of band c: it holds that row's transition
// probabilities, and its M, X and Y at its last column, in registers.  The
// group sweeps the band's haplen + 7 anti-diagonals: at step s thread k
// computes column j = s - k.  Its row above at column j is thread k-1's
// result of the step before, handed down by __shfl_up_sync of width 8, and
// the hap byte rides down the group beside it; the diagonal operand
// t = pMM*M + pGAPM*(X + Y) of column j-1 is carried as in a one-thread
// sweep, and Y is a serial carry along the columns.  Thread 0 takes its
// row above from the band's boundary row, the last row of the band before
// (the virtual row 0 on band 0), scaled by the pending power of two on
// read; the group fetches the boundary row and the hap bytes 16 to 23
// columns ahead, one column a thread, and broadcasts each column to thread
// 0.  Thread 7 writes its row as the next band's boundary row into three
// lane-minor (H, P) f32 planes, in place: a column is fetched before its
// new value exists (the write depends, through the shuffles, on the fetched
// value), and a __syncwarp separates a band's stores from the next band's
// loads.  The renormalisation stays where the bands put it: thread 7 keeps
// the running maximum of its row, and at the band's end the group folds
// the band into the accumulator (the result row's sum comes from the
// thread that owns row rslen-1) and takes the new scale, with the integer
// and power-of-two steps of a one-thread sweep.
//
// The flag in the group: a bit word rides down with each column.  Thread 0
// sets bit 0, alive at the last renormalisation: 1 on band 0, else M, X or
// Y nonzero in the stored (unscaled) boundary row.  Thread 3 ORs in its
// row's liveness as bit 1.  Thread 7 sets lost where bit 0 is set and bit
// 1 or its own row's liveness is not; at the band's end the group ORs lost
// into the flag.
//
// Control is warp-uniform: a warp runs the most bands any of its lanes
// needs and, per band, the most steps (haplen + 7) any lane still in it
// needs; a lane past P, a malformed lane (index or length out of range: a
// NaN mantissa and flag -1), and a lane whose bands or columns end first
// take part in every shuffle and __syncwarp and store nothing.  The scaled
// instance visits every row below 8*ceil(rslen/8) (rows past rslen still
// feed the row-7 flag); the plain one stops at rslen.  Columns past haplen
// never feed valid ones and are not visited.
//
// What bounds it on this card: the operations, 11 f32 products and sums a
// cell (2 more a column on row rslen-1, the result's sum); the band
// barrier's idle steps, 7 of each haplen + 7 (a thread waits for the rows
// above it at the band's start and for the rows below at its end); and the
// boundary row, 12 B a column a band, about 1.5 B a cell, plus a hap byte a
// column a band.  The one-thread sweep this design replaced was bound by
// latency: a lane's 8*ceil(rslen/8) x haplen cells were one thread's
// dependent chain, each link waiting on (H, P) scratch holding every row.
// Here a lane's chain is ceil(rslen/8) x (haplen + 7) steps in registers,
// and a launch of P lanes fills P/4 warps.
//
// Numerics: built with -ftz=true, so f32 subnormals flush to zero as on
// the TPU the 2^90 window and the flag were tuned on: a column "dies"
// where it died there.  Built with -fmad=false, so products and sums round
// one by one.  Every cell does the one-thread sweep's products and sums in
// the same order, so the mantissa, exponent and flag (plain instance: the
// f32 result) are bit for bit those of that sweep and of the plain twin in
// the kernel's order (ops/pairhmm_cuda.py::pairhmm_raw_scaled_kernel_order).

#include <cstdint>
#include <cuda_runtime.h>

#include "pairhmm_common.cuh"

namespace {

using namespace pairhmm;

constexpr unsigned kWarp = 0xffffffffu;
constexpr int kBand = 8;                 // rows a band; threads a lane
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

// One column of the row above a band as the group fetches it ahead of the
// wavefront: the hap byte with the flag's bit 0 above it, and M, X, Y.
struct Column {
  int word;
  float m, x, y;
};

template <bool kScaled>
__global__ void pairhmm_kernel(
    const uint8_t* __restrict__ hap_u, int H, int nu_h,
    const uint8_t* __restrict__ readq_u, int R, int nu_r,
    const uint8_t* __restrict__ quals_u, int c_iq, int c_dq, int c_gcp,
    const int32_t* __restrict__ ridx, const int32_t* __restrict__ hidx,
    const int32_t* __restrict__ haplen, const int32_t* __restrict__ rslen,
    int P,
    const float* __restrict__ ph2pr_g, const float* __restrict__ m2m_g,
    float* Ms, float* Xs, float* Ys,
    int32_t* __restrict__ out) {
  __shared__ Tables tables;
  tables.load(ph2pr_g, m2m_g);

  const int k = threadIdx.x & (kBand - 1);  // the row of each band this thread owns
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) / kBand;
  int ri = 0, hi = 0, hl = 0, rl = 0;
  if (p < P) {
    ri = ridx[p];
    hi = hidx[p];
    hl = haplen[p];
    rl = rslen[p];
  }
  const bool ok = p < P && ri >= 0 && ri < nu_r && hi >= 0 && hi < nu_h && hl >= 1 &&
                  hl <= H && rl >= 1 && rl <= R;
  if (p < P && !ok && k == 0) {
    // malformed lane: no result (NaN mantissa) and flag -1
    out[p] = 0x7fc00000;
    if constexpr (kScaled) {
      out[P + p] = 0;
      out[2 * P + p] = -1;
    }
  }
  // the bands this lane runs (none past P or when malformed), and the warp's
  const int nbands = ok ? (rl + kBand - 1) / kBand : 0;
  const int warp_bands = __reduce_max_sync(kWarp, nbands);

  const size_t plane = (size_t)R * nu_r;
  const uint8_t* hap = hap_u + hi;
  const float inity = ok ? kInitialConstant / (float)hl : 0.f;

  float acc_m = 0.f;  // result mantissa, exponent e_acc
  int e_acc = 0;
  int e_state = 0;    // state values are v * 2^e_state
  int flag = 0;
  float sf = 1.f;     // pending renormalisation (v * sf) * kUp, applied on read

  for (int c = 0; c < warp_bands; ++c) {
    const bool active = c < nbands;
    const int r = kBand * c + k;
    const bool row_on = active && (kScaled || r < rl);
    Row w{};
    int rb = -1;
    if (row_on) {
      const size_t ro = (size_t)r * nu_r + ri;
      rb = readq_u[ro];
      w = row_of(tables, readq_u, quals_u, c_iq, c_dq, c_gcp, plane, ro);
    }
    const bool read_n = rb == kNCode;
    const bool last_row = row_on && r + 1 == rl;
    // t carries pMM*M + pGAPM*(X + Y) of the row above at column j-1; for
    // column 0 that is pGAPM * Y[r-1][-1] (inity on row 0 only)
    float t = row_on && r == 0 ? w.pgapm * inity : 0.f;
    float m_cur = 0.f, x_cur = 0.f, y_cur = 0.f;  // this row at its last column
    int word = 0;                                 // that column's hap byte and flag bits
    float row_sum = 0.f, mx = 0.f;
    int lost = 0;
    // the band ends when its last visited row has done column haplen-1
    const int last_k = kScaled ? kBand - 1 : min(kBand - 1, rl - 1 - kBand * c);
    const int nsteps = __reduce_max_sync(kWarp, active ? hl + last_k : 0);
    const bool write_boundary = k == kBand - 1 && active && c + 1 < nbands;

    auto fetch = [&](int col) {
      Column v{0, 0.f, 0.f, inity};  // the virtual row 0 on band 0
      if (active && col < hl) {
        const int hb = __ldg(hap + (size_t)col * nu_h);
        if (c == 0) {
          v.word = hb | (1 << 8);
        } else {
          const size_t idx = (size_t)col * P + p;
          const float m = Ms[idx], x = Xs[idx], y = Ys[idx];
          v.word = hb | (((m != 0.f) | (x != 0.f) | (y != 0.f)) << 8);
          if constexpr (kScaled) {
            v.m = (m * sf) * kUp;
            v.x = (x * sf) * kUp;
            v.y = (y * sf) * kUp;
          } else {
            v.m = m;
            v.x = x;
            v.y = y;
          }
        }
      }
      return v;
    };
    // columns base+k of the current 8-column window and of the two after it
    Column cur = fetch(k), next = fetch(kBand + k), after = fetch(2 * kBand + k);

    // eight steps a window, unrolled; steps past nsteps (up to 7) find no
    // cell in range: a cell (r, j) of a visited row lies on step j + k <
    // haplen + last_k <= nsteps
    for (int s0 = 0; s0 < nsteps; s0 += kBand) {
      if (s0 > 0) {
        cur = next;
        next = after;
        after = fetch(s0 + 2 * kBand + k);
      }
#pragma unroll
      for (int wi = 0; wi < kBand; ++wi) {
        // the row above at column j = s - k: thread k-1's row from the
        // step before, or for thread 0 the boundary row at column s
        float up_m = __shfl_up_sync(kWarp, m_cur, 1, kBand);
        float up_x = __shfl_up_sync(kWarp, x_cur, 1, kBand);
        float up_y = __shfl_up_sync(kWarp, y_cur, 1, kBand);
        int up_w = __shfl_up_sync(kWarp, word, 1, kBand);
        const int b_w = __shfl_sync(kWarp, cur.word, wi, kBand);
        float b_m = 0.f, b_x = 0.f, b_y = inity;
        if (c > 0) {
          b_m = __shfl_sync(kWarp, cur.m, wi, kBand);
          b_x = __shfl_sync(kWarp, cur.x, wi, kBand);
          b_y = __shfl_sync(kWarp, cur.y, wi, kBand);
        }
        if (k == 0) {
          up_m = b_m;
          up_x = b_x;
          up_y = b_y;
          up_w = b_w;
        }

        // every thread computes its cell; only a cell in range keeps it
        const int j = s0 + wi - k;
        const bool valid = row_on && (unsigned)j < (unsigned)hl;
        const int hb = up_w & 0xFF;
        int bits = up_w >> 8;
        const bool match = hb == rb || hb == kNCode || read_n;
        const float prior = match ? w.dmatch : w.dmis;
        const float mn = prior * t;
        const float xn = w.pmx * up_m + w.pc * up_x;
        const float yn = w.pc * y_cur + w.pmy * m_cur;
        const float tn = w.pmm * up_m + w.pgapm * (up_x + up_y);
        if constexpr (kScaled) {
          const int alive = (mn != 0.f) | (xn != 0.f) | (yn != 0.f);
          if (k == 3) bits |= alive << 1;  // bit 1: the row-3 sample
          if (valid && k == kBand - 1) {
            lost |= (bits & 1) & ~((bits >> 1) & alive);
            mx = fmaxf(mx, fmaxf(mn, fmaxf(xn, yn)));
          }
        }
        if (valid) {
          t = tn;
          m_cur = mn;
          x_cur = xn;
          y_cur = yn;
          word = hb | (bits << 8);
          if (last_row) row_sum += mn + xn;
          if (write_boundary) {
            const size_t idx = (size_t)j * P + p;
            Ms[idx] = mn;
            Xs[idx] = xn;
            Ys[idx] = yn;
          }
        }
      }
    }

    // the band's result-row sum (zero unless row rslen-1 lies in it)
    const float acc_chunk = __shfl_sync(kWarp, row_sum, (rl - 1) & (kBand - 1), kBand);
    if constexpr (kScaled) {
      const float band_max = __shfl_sync(kWarp, mx, kBand - 1, kBand);
      const int band_lost = __shfl_sync(kWarp, lost, kBand - 1, kBand);
      if (active) {
        // fold the band into the accumulator by value exponents
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

        flag |= band_lost;  // this band starts before rslen by construction
        const int e = exponent_of(band_max);
        sf = pow2(-e);
        e_state += e - 90;
      }
    } else if (active) {
      acc_m += acc_chunk;  // nonzero only in the band that holds row rslen-1
    }
    __syncwarp();  // the boundary row's stores before the next band's fetches
  }
  if (ok && k == 0) {
    out[p] = __float_as_int(acc_m);
    if constexpr (kScaled) {
      out[P + p] = e_acc;
      out[2 * P + p] = flag;
    }
  }
}

// Lanes a block, four to a warp: up to 8 warps; with fewer lanes than the
// card has SMs x 2 blocks, smaller blocks spread them over more SMs.
inline int lanes_per_block(int P) {
  int lanes = 32;
  while (lanes > 4 && (P + lanes - 1) / lanes < 264) lanes >>= 1;
  return lanes;
}

template <bool kScaled>
int launch(const void* hap_u, int H, int nu_h, const void* readq_u, int R, int nu_r,
           const void* quals_u, int c_iq, int c_dq, int c_gcp, const void* ridx,
           const void* hidx, const void* haplen, const void* rslen, int P,
           const void* ph2pr, const void* m2m, void* Ms, void* Xs, void* Ys, void* out,
           void* stream) {
  if (P <= 0) return 0;
  const int lanes = lanes_per_block(P);
  const int grid = (P + lanes - 1) / lanes;
  pairhmm_kernel<kScaled><<<grid, kBand * lanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(hap_u), H, nu_h,
      static_cast<const uint8_t*>(readq_u), R, nu_r,
      static_cast<const uint8_t*>(quals_u), c_iq, c_dq, c_gcp,
      static_cast<const int32_t*>(ridx), static_cast<const int32_t*>(hidx),
      static_cast<const int32_t*>(haplen), static_cast<const int32_t*>(rslen),
      P, static_cast<const float*>(ph2pr), static_cast<const float*>(m2m),
      static_cast<float*>(Ms), static_cast<float*>(Xs), static_cast<float*>(Ys),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gkl_pairhmm_scaled(
    const void* hap_u, int H, int nu_h,
    const void* readq_u, int R, int nu_r,
    const void* quals_u, int c_iq, int c_dq, int c_gcp,
    const void* ridx, const void* hidx, const void* haplen, const void* rslen,
    int P,
    const void* ph2pr, const void* m2m,
    void* Ms, void* Xs, void* Ys,
    void* out, void* stream) {
  return launch<true>(hap_u, H, nu_h, readq_u, R, nu_r, quals_u, c_iq, c_dq, c_gcp, ridx,
                      hidx, haplen, rslen, P, ph2pr, m2m, Ms, Xs, Ys, out, stream);
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
  return launch<false>(hap_u, H, nu_h, readq_u, R, nu_r, quals_u, c_iq, c_dq, c_gcp, ridx,
                       hidx, haplen, rslen, P, ph2pr, m2m, Ms, Xs, Ys, out, stream);
}
