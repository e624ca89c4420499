// What the PairHMM kernels share (pairhmm_scaled.cu's two instances and
// pairhmm_cols.cu): the constants of the recurrence, the exact context
// tables in shared memory and a lane's per-row transition probabilities.
#pragma once

#include <cstdint>

namespace pairhmm {

constexpr int kNCode = 78;              // 'N'
constexpr int kTri = 128 * 129 / 2;     // match-to-match entries, quals <= 127
constexpr float kInitialConstant = 0x1p120f;

// The 128-entry ph2pr table and the 8256-entry triangular match-to-match
// cache, copied into the block's shared memory.  The cache goes over in
// 16-byte words, four loads in flight a thread: a block of one warp waits
// on 17 rounds of loads, not 258.
struct alignas(16) Tables {
  float ph2pr[128];
  float m2m[kTri];

  __device__ void load(const float* __restrict__ ph2pr_g, const float* __restrict__ m2m_g) {
    for (int i = threadIdx.x; i < 128; i += blockDim.x) ph2pr[i] = ph2pr_g[i];
    const float4* src = reinterpret_cast<const float4*>(m2m_g);
    float4* dst = reinterpret_cast<float4*>(m2m);
#pragma unroll 4
    for (int i = threadIdx.x; i < kTri / 4; i += blockDim.x) dst[i] = __ldg(src + i);
    __syncthreads();
  }
};

// One read row's transition and emission probabilities (pXX == pYY == pc).
struct Row {
  float pmm, pgapm, pmx, pmy, pc, dmatch, dmis;
};

// Row r of the lane whose unique read column is ri: the base qual from
// readq_u's second plane, the gap quals from quals_u (3, R, nu_r) or, when
// it is null, the constants; every qual masked & 127.
__device__ __forceinline__ Row row_of(const Tables& t, const uint8_t* __restrict__ readq_u,
                                      const uint8_t* __restrict__ quals_u, int c_iq, int c_dq,
                                      int c_gcp, size_t plane, size_t ro) {
  const int qv = readq_u[plane + ro] & 127;
  int iqv, dqv, gv;
  if (quals_u != nullptr) {
    iqv = quals_u[ro] & 127;
    dqv = quals_u[plane + ro] & 127;
    gv = quals_u[2 * plane + ro] & 127;
  } else {
    iqv = c_iq & 127;
    dqv = c_dq & 127;
    gv = c_gcp & 127;
  }
  const int qmax = max(iqv, dqv), qmin = min(iqv, dqv);
  Row w;
  w.pmm = t.m2m[((qmax * (qmax + 1)) >> 1) + qmin];
  w.pc = t.ph2pr[gv];
  w.pgapm = 1.f - w.pc;
  w.pmx = t.ph2pr[iqv];
  w.pmy = t.ph2pr[dqv];
  const float distm = t.ph2pr[qv];
  w.dmatch = 1.f - distm;
  w.dmis = distm / 3.f;
  return w;
}

}  // namespace pairhmm
