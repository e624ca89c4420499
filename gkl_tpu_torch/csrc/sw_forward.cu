// Affine-gap Smith-Waterman score and backtrack DP for Hopper (sm_90a),
// bound through a plain C interface (ctypes): a warp per lane, on an
// anti-diagonal wavefront.
//
// Replaces both Smith-Waterman kernels of the JAX package:
// gkl_tpu/ops/sw_pallas.py::_kernel (the tall kernel and, with relay=True,
// its 2048-row segments) and ::_kernel_m (64-column alt slabs with carried
// edge planes).  Those splits exist because the TPU kernel keeps its state
// in 16 MB of VMEM; here a lane's rows go in passes inside the kernel, and
// one launch covers any N, M <= 32767.
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
// with a tropical scan; integer max is exact, so the cell-by-cell form here
// is bit-identical to it in any order.
//
// Layouts: ref (P, N) and alt (P, M) u8, lane-major (the wrapper transposes
// the JAX contract's (N, P) and (M, P) planes on the device), so that a
// warp's fetches are contiguous.  Outputs in the JAX contract's layout,
// which the host walk (sw_postprocess_packed) reads as it is:
//   bt      (P, N/2, M) u8: codes of rows 2k / 2k+1 in the low / high
//           nibble;
//   lastrow (M, P) i32: H(reflen, j);  lastcol (P, N) i32: H(i, altlen).
// Each lane stops at its own reflen and altlen.  Only the bt words (8
// columns of a row pair) that hold a cell of a row < reflen and a column <
// altlen are written, with 0 for the codes past reflen and altlen in them;
// lastrow[:altlen] and lastcol[:reflen]; that is all the host walk reads.
//
// Design: a warp per lane.  A pass covers 32 * kRC reference rows; thread t
// owns rows t*kRC .. t*kRC+kRC-1 of the pass and keeps each row's H and E
// at its previous column in registers (E runs along the row).  The strips
// form an anti-diagonal wavefront: at step s thread t computes alt column
// j = s - t for its rows, top to bottom, with F and H carried down the
// column in registers.  Its row above comes from thread t-1 by
// __shfl_up_sync: that thread's last row's H and F at column j, computed
// at step s-1; H at column j-1 (the diagonal) is the value received one
// step earlier.  The alt byte rides down the warp the same way.  Thread 0
// takes its row above from the pass boundary: row 0 on the first pass,
// else the previous pass's last row, which thread 31 stores into two
// lane-major (P, M) i32 planes.  The warp fetches the alt bytes and the
// boundary row 32 columns ahead, a column a thread, and thread 0 takes its
// column by __shfl_sync.  A pass reads and writes the planes in place: a
// column is fetched (at step j-32 or before) ahead of its new value's store
// (step j+31, which depends on the fetched value through the shuffles).  A
// pass takes altlen + 31 steps (fewer on a last pass whose rows end early).
//
// The backtrack: kRC is even, so a thread owns whole row pairs and so whole
// bt bytes.  For each of its kRC/2 pairs it shifts each column's byte into
// a 64-bit word (two byte permutes) and stores the word, 8 columns at once,
// at a column j with j % 8 == 7 and at altlen-1.  Every rung of the length
// ladder is a multiple of 8, so the word is aligned (the wrapper refuses
// other M).
//
// A cell's maximums come from Hopper's DPX instruction __vibmax_s32, which
// gives the maximum and the comparison that sets a code bit at once; the
// code bits are those of the plain comparisons, ties included.
//
// Control is warp-uniform: the loop bounds and the exits depend only on the
// lane, and threads whose column lies outside [0, altlen), or whose rows
// lie past reflen, take part in every shuffle and store nothing.  kRC is
// 2, 4 or 8 (gkl_tpu_torch/ops/sw_cuda.py::sw_geometry picks it from the
// ref bucket N: the smallest whose one pass holds N, else 8).
//
// What bounds it on this card: per cell, 13 int32 operations (sums,
// maximums, comparisons, ORs) plus the packing of its code; per step, six
// shuffles and the loop's control, spread over kRC rows.  Bytes: half a bt
// byte a cell, and per column and pass 8 B of boundary row and an alt byte,
// about 9/(32*kRC) B a cell.  With thousands of lanes (realignment batches)
// it is bound by int32 issue; with a few hundred (a warp or two an SM), by
// the latency of a step's chain: the shuffles, then F -> H -> the next
// row's F, kRC rows deep.  The one-thread sweep this design replaced was
// bound by latency in both cases: a lane's reflen x altlen cells were one
// thread's dependent chain, with the previous row's H and F (about 17 B a
// cell) in device memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kWarp = 0xffffffffu;
constexpr int kMatch = 0;
constexpr int kInsert = 1;
constexpr int kDelete = 2;
constexpr int kInsertExt = 4;
constexpr int kDeleteExt = 8;
constexpr int32_t kMinCutoff = -100000000;
constexpr int32_t kLowInit = INT_MIN / 2;

// One alt column as a thread fetches it ahead of the wavefront: the alt
// byte and the boundary row above the pass (H and F).
struct Column {
  int ab;
  int32_t h, f;
};

template <int kRC>
__global__ void sw_forward_kernel(
    const uint8_t* __restrict__ ref, int N,
    const uint8_t* __restrict__ alt, int M,
    const int32_t* __restrict__ reflen, const int32_t* __restrict__ altlen,
    int P, int w_match, int w_mismatch, int w_open, int w_extend, int indel,
    int32_t* hs_all, int32_t* fs_all,
    uint8_t* __restrict__ bt, int32_t* __restrict__ lastrow,
    int32_t* __restrict__ lastcol) {
  static_assert(kRC % 2 == 0, "a thread owns whole row pairs");
  constexpr int kPass = 32 * kRC;  // reference rows of one pass
  constexpr int kPairs = kRC / 2;

  const int t = threadIdx.x & 31;  // the strip of each pass this thread owns
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp: p is the warp's lane
  const int n = reflen[p], m = altlen[p];
  if (n < 1 || n > N || m < 1 || m > M) return;  // nothing to align

  const uint8_t* ref_p = ref + (size_t)p * N;
  const uint8_t* alt_p = alt + (size_t)p * M;
  int32_t* hs = hs_all + (size_t)p * M;
  int32_t* fs = fs_all + (size_t)p * M;
  uint8_t* bt_p = bt + (size_t)p * (N / 2) * M;
  int32_t* lastcol_p = lastcol + (size_t)p * N;
  // H(i, 0) of the 1-based row i: the left boundary column
  auto left = [&](int i) -> int32_t { return indel && i > 0 ? w_open + (i - 1) * w_extend : 0; };
  const int npasses = (n + kPass - 1) / kPass;

  for (int c = 0; c < npasses; ++c) {
    const bool first = c == 0;
    const int r0 = c * kPass + t * kRC;  // this thread's first row, 0-based
    int rb[kRC];
    int32_t hl[kRC], e[kRC];  // each row's H and E at the previous column
#pragma unroll
    for (int k = 0; k < kRC; ++k) {
      const int r = r0 + k;
      rb[k] = r < n ? ref_p[r] : -1;  // rows past reflen match nothing
      hl[k] = left(r + 1);
      e[k] = kLowInit;
    }
    // each row pair's bt bytes of the last 8 columns, newest in the top byte
    uint32_t wlo[kPairs], whi[kPairs];
#pragma unroll
    for (int q = 0; q < kPairs; ++q) wlo[q] = whi[q] = 0;
    const int k_last = n - 1 - r0;  // row reflen-1, when in this strip
    // the pass ends when the thread holding its last row below reflen has
    // done column altlen-1; a pass with a successor runs all 32 threads,
    // and thread 31 writes the boundary row
    const int t_end = min(31, (n - 1 - c * kPass) / kRC);
    const int nsteps = m + t_end;
    const bool write_boundary = c + 1 < npasses && t == 31;

    // H of the row above the strip at column j-1 (the diagonal operand)
    int32_t dg = left(r0);
    // the strip's last row (H, F) at its column, for thread t+1; before
    // its first column, H is the left boundary that thread t+1's diagonal
    // needs there
    int32_t lo_h = hl[kRC - 1], lo_f = kLowInit;
    int ab = 0;  // the alt byte of this thread's column

    auto fetch = [&](int col) {
      Column v{0, 0, kLowInit};
      if (col < m) {
        v.ab = __ldg(alt_p + col);
        if (first) {
          v.h = indel ? w_open + col * w_extend : 0;  // row 0
        } else {
          v.h = hs[col];
          v.f = fs[col];
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
      int32_t up_h = __shfl_up_sync(kWarp, lo_h, 1);
      int32_t up_f = __shfl_up_sync(kWarp, lo_f, 1);
      const int ab_up = __shfl_up_sync(kWarp, ab, 1);
      const int ab0 = __shfl_sync(kWarp, cur.ab, w);
      const int32_t b_h = __shfl_sync(kWarp, cur.h, w);
      const int32_t b_f = __shfl_sync(kWarp, cur.f, w);
      if (t == 0) {
        up_h = b_h;
        up_f = b_f;
      }
      ab = t == 0 ? ab0 : ab_up;

      const int j = s - t;
      if (j >= 0 && j < m) {
        int32_t diag = dg, h_up = up_h, f_up = up_f, h_last = 0;
        uint32_t pair = 0;
#pragma unroll
        for (int k = 0; k < kRC; ++k) {
          // __vibmax_s32(a, b, &p) (DPX): max(a, b), and p = a >= b.  Off
          // the column's chain: E, and H before F; the candidate already
          // held wins a tie ("strictly greater")
          const int32_t open_h = hl[k] + w_open, ext_h = e[k] + w_extend;
          bool iext, keep_m, dext, keep_e;
          e[k] = __vibmax_s32(ext_h, open_h, &iext);
          const int32_t hd = max(diag + (rb[k] == ab ? w_match : w_mismatch), kMinCutoff);
          const int32_t he = __vibmax_s32(hd, e[k], &keep_m);
          const bool ins = !keep_m;
          // the chain down the column: F, then H, then the next row's F
          const int32_t open_v = h_up + w_open, ext_v = f_up + w_extend;
          const int32_t f = __vibmax_s32(ext_v, open_v, &dext);
          const int32_t h = __vibmax_s32(he, f, &keep_e);
          const bool del = !keep_e;
          const uint32_t code = (del ? kDelete : ins ? kInsert : kMatch) |
                                (iext ? kInsertExt : 0) | (dext ? kDeleteExt : 0);
          if (k == k_last) h_last = h;
          diag = hl[k];
          hl[k] = h;
          h_up = h;
          f_up = f;
          if (k & 1) {
            pair |= code << 4;
            wlo[k / 2] = __byte_perm(wlo[k / 2], whi[k / 2], 0x4321);
            whi[k / 2] = __byte_perm(whi[k / 2], pair, 0x4321);
          } else {
            pair = code;
          }
        }
        if (0 <= k_last && k_last < kRC) lastrow[(size_t)j * P + p] = h_last;  // H(reflen, j)
        lo_h = hl[kRC - 1];
        lo_f = f_up;
        if (write_boundary) {
          hs[j] = lo_h;
          fs[j] = lo_f;
        }
        const int g = j & 7;
        if (g == 7 || j == m - 1) {
          // the word of columns j-g .. j: its older bytes shift out
          const int shift = 8 * (7 - g);
#pragma unroll
          for (int q = 0; q < kPairs; ++q) {
            const int rp = (r0 >> 1) + q;  // the row pair
            if (2 * rp < n) {
              uint64_t word = ((uint64_t)whi[q] << 32 | wlo[q]) >> shift;
              if (2 * rp + 1 == n) word &= 0x0F0F0F0F0F0F0F0Full;  // row reflen: 0
              *reinterpret_cast<uint64_t*>(bt_p + (size_t)rp * M + (j - g)) = word;
            }
          }
        }
        if (j == m - 1) {
#pragma unroll
          for (int k = 0; k < kRC; ++k) {
            if (k <= k_last) lastcol_p[r0 + k] = hl[k];  // H(i, altlen)
          }
        }
      }
      dg = up_h;
    }
    __syncwarp();  // the boundary row's stores before the next pass's fetches
  }
}

// A few warps a block, each a lane; with fewer lanes than the card has
// SMs x 2, smaller blocks spread them over more SMs.
inline int warps_for(int P) {
  int warps = 4;
  while (warps > 1 && (P + warps - 1) / warps < 264) warps >>= 1;
  return warps;
}

template <int kRC>
void launch(const void* ref, int N, const void* alt, int M, const void* reflen,
            const void* altlen, int P, int w_match, int w_mismatch, int w_open,
            int w_extend, int indel, void* Hs, void* Fs, void* bt, void* lastrow,
            void* lastcol, cudaStream_t stream) {
  const int warps = warps_for(P);
  const int grid = (P + warps - 1) / warps;
  sw_forward_kernel<kRC><<<grid, 32 * warps, 0, stream>>>(
      static_cast<const uint8_t*>(ref), N, static_cast<const uint8_t*>(alt), M,
      static_cast<const int32_t*>(reflen), static_cast<const int32_t*>(altlen),
      P, w_match, w_mismatch, w_open, w_extend, indel,
      static_cast<int32_t*>(Hs), static_cast<int32_t*>(Fs),
      static_cast<uint8_t*>(bt), static_cast<int32_t*>(lastrow),
      static_cast<int32_t*>(lastcol));
}

}  // namespace

extern "C" int gkl_sw_forward(
    const void* ref, int N, const void* alt, int M,
    const void* reflen, const void* altlen, int P,
    int w_match, int w_mismatch, int w_open, int w_extend, int indel,
    void* Hs, void* Fs, void* bt, void* lastrow, void* lastcol,
    int rows_per_thread, void* stream) {
  if (P <= 0) return 0;
  if (M % 8 || N % 2) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread) {
    case 2:
      launch<2>(ref, N, alt, M, reflen, altlen, P, w_match, w_mismatch, w_open, w_extend,
                indel, Hs, Fs, bt, lastrow, lastcol, s);
      break;
    case 4:
      launch<4>(ref, N, alt, M, reflen, altlen, P, w_match, w_mismatch, w_open, w_extend,
                indel, Hs, Fs, bt, lastrow, lastcol, s);
      break;
    case 8:
      launch<8>(ref, N, alt, M, reflen, altlen, P, w_match, w_mismatch, w_open, w_extend,
                indel, Hs, Fs, bt, lastrow, lastcol, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
