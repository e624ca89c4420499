// Affine-gap Smith-Waterman score and backtrack DP for Hopper (sm_90a),
// bound through a plain C interface (ctypes).
//
// Replaces both Smith-Waterman kernels of the JAX package:
// gkl_tpu/ops/sw_pallas.py::_kernel (the tall kernel and, with relay=True,
// its 2048-row segments) and ::_kernel_m (64-column alt slabs with carried
// edge planes).  Those splits exist because the TPU kernel keeps its state
// in 16 MB of VMEM; here the carried state lives in device memory, so one
// launch covers any N, M <= 32767.
//
// What it computes, per lane (pair), for reference rows i and alt columns j
// (semantics of PairWiseSW.h:65-263, taken from the serial aligner
// native/sw_runtime.cc:238-290):
//   E(i,j) = max(H(i,j-1)+open, E(i,j-1)+extend)   INSERT_EXT when ext >= open
//   F(i,j) = max(H(i-1,j)+open, F(i-1,j)+extend)   DELETE_EXT when ext >= open
//   H(i,j) = max(max(cutoff, H(i-1,j-1)+s), E, F)  E, then F, win only when
//                                                  strictly greater
// with H(0,j), H(i,0) = open+(k-1)*extend for the INDEL strategies (else
// 0) and E(i,0) = F(0,j) = INT32_MIN/2.  The TPU kernel solved the E row
// with a tropical scan; integer max is exact, so the sequential form here
// is bit-identical to it.
//
// Outputs, lane-minor (the wrapper permutes bt and lastcol on the device
// to the JAX contract's lane-major layout before the copy to the host):
//   bt      (N/2, M, P) u8: codes of rows 2k / 2k+1 in the low / high
//           nibble;
//   lastrow (M, P) i32: H(reflen, j);  lastcol (N, P) i32: H(i, altlen).
// Each lane stops at its own reflen and altlen: only bt cells of rows <
// reflen and columns < altlen, lastrow[:altlen] and lastcol[:reflen] are
// written, which is all the host walk (sw_postprocess_packed) reads.
//
// Design (simple first): one thread per lane, sweeping reference rows.
// The previous row's H and F live in (M, P) i32 device scratch, lane-minor,
// so a warp's 32 lanes touch 32 neighbouring words; E and H(i, j-1) ride
// in registers along the row.  Columns go in tiles of kTile: a tile's
// scratch loads are issued together, so one memory latency covers kTile
// cells of a long row.
//
// What bounds it on this card: about 17 B of traffic per cell (H and F
// read and written, the alt byte, half a bt byte plus its read-back on odd
// rows), and at the lane counts of a region (10^3-10^4 pairs) the few
// warps in flight: memory latency, not bandwidth.  A later design keeps
// the row in shared memory or runs a warp per lane along anti-diagonals.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMatch = 0;
constexpr int kInsert = 1;
constexpr int kDelete = 2;
constexpr int kInsertExt = 4;
constexpr int kDeleteExt = 8;
constexpr int32_t kMinCutoff = -100000000;
constexpr int32_t kLowInit = INT_MIN / 2;
constexpr int kTile = 8;

__global__ void sw_forward_kernel(
    const uint8_t* __restrict__ ref, int N,
    const uint8_t* __restrict__ alt, int M,
    const int32_t* __restrict__ reflen, const int32_t* __restrict__ altlen,
    int P, int w_match, int w_mismatch, int w_open, int w_extend, int indel,
    int32_t* __restrict__ Hs, int32_t* __restrict__ Fs,
    uint8_t* __restrict__ bt, int32_t* __restrict__ lastrow,
    int32_t* __restrict__ lastcol) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int n = reflen[p], m = altlen[p];
  if (n < 1 || n > N || m < 1 || m > M) return;  // nothing to align
  const size_t Ps = (size_t)P;

  for (int j = 0; j < m; ++j) {  // row 0
    Hs[j * Ps + p] = indel ? w_open + j * w_extend : 0;
    Fs[j * Ps + p] = kLowInit;
  }
  for (int i = 1; i <= n; ++i) {
    const int rb = ref[(i - 1) * Ps + p];
    int32_t h_left = indel ? w_open + (i - 1) * w_extend : 0;            // H(i, 0)
    int32_t h_diag = (indel && i > 1) ? w_open + (i - 2) * w_extend : 0;  // H(i-1, 0)
    int32_t e = kLowInit;                                                 // E(i, 0)
    const bool high = (i - 1) & 1;
    uint8_t* bt_row = bt + (size_t)((i - 1) >> 1) * M * Ps + p;
    for (int j0 = 0; j0 < m; j0 += kTile) {
      int32_t hp[kTile], fp[kTile];
      int ab[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int j = j0 + t;
        if (j < m) {
          hp[t] = Hs[j * Ps + p];
          fp[t] = Fs[j * Ps + p];
          ab[t] = alt[j * Ps + p];
        }
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int j = j0 + t;
        if (j < m) {
          const int32_t open_h = h_left + w_open, ext_h = e + w_extend;
          e = open_h > ext_h ? open_h : ext_h;
          const int iext = open_h > ext_h ? 0 : kInsertExt;
          const int32_t open_v = hp[t] + w_open, ext_v = fp[t] + w_extend;
          const int32_t f = open_v > ext_v ? open_v : ext_v;
          const int dext = open_v > ext_v ? 0 : kDeleteExt;
          const int32_t mv = h_diag + (rb == ab[t] ? w_match : w_mismatch);
          int32_t h = mv > kMinCutoff ? mv : kMinCutoff;
          int code = kMatch;
          if (e > h) {
            code = kInsert;
            h = e;
          }
          if (f > h) {
            code = kDelete;
            h = f;
          }
          h_diag = hp[t];
          h_left = h;
          hp[t] = h;
          fp[t] = f;
          const int c = code | iext | dext;
          uint8_t* cell = bt_row + (size_t)j * Ps;
          *cell = high ? (uint8_t)(*cell | (c << 4)) : (uint8_t)c;
          if (i == n) lastrow[j * Ps + p] = h;
        }
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int j = j0 + t;
        if (j < m) {
          Hs[j * Ps + p] = hp[t];
          Fs[j * Ps + p] = fp[t];
        }
      }
    }
    lastcol[(i - 1) * Ps + p] = h_left;  // H(i, altlen)
  }
}

}  // namespace

extern "C" int gkl_sw_forward(
    const void* ref, int N, const void* alt, int M,
    const void* reflen, const void* altlen, int P,
    int w_match, int w_mismatch, int w_open, int w_extend, int indel,
    void* Hs, void* Fs, void* bt, void* lastrow, void* lastcol,
    void* stream) {
  if (P <= 0) return 0;
  // fewer lanes than the card has SMs x 2 blocks: smaller blocks, more SMs
  int block = 128;
  while (block > 32 && (P + block - 1) / block < 264) block >>= 1;
  const int grid = (P + block - 1) / block;
  sw_forward_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ref), N, static_cast<const uint8_t*>(alt), M,
      static_cast<const int32_t*>(reflen), static_cast<const int32_t*>(altlen),
      P, w_match, w_mismatch, w_open, w_extend, indel,
      static_cast<int32_t*>(Hs), static_cast<int32_t*>(Fs),
      static_cast<uint8_t*>(bt), static_cast<int32_t*>(lastrow),
      static_cast<int32_t*>(lastcol));
  return static_cast<int>(cudaGetLastError());
}
