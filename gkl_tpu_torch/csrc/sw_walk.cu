// Smith-Waterman maximum selection and CIGAR walk for Hopper (sm_90a),
// bound through a plain C interface (ctypes): one thread per lane, reading
// the backtrack where sw_forward.cu wrote it.
//
// Replaces no TPU kernel: the JAX package walks each lane on the host
// (gkl_tpu/native/sw_runtime.cc::sw_postprocess_packed, after the whole
// backtrack came back from the device).  Here the walk runs on the card
// right after the forward kernel, on the same stream, and only the walked
// runs come back.
//
// What it computes, per lane, exactly as native/sw_runtime.cc does:
//   select_max: the anti-diagonal visit of lastrow (SOFTCLIP and IGNORE
//     only) then lastcol on each diagonal, a later cell winning on a higher
//     score or on a tie by the two rules of the runtime (a lastrow cell
//     strictly nearer the main diagonal; a lastcol cell when the held one
//     is in the last column or no farther from the diagonal);
//   walk_cigar: the start cell of the strategy (INDEL: (n, m);
//     LEADING_INDEL: (max_i, m); else the maximum), a leading soft clip of
//     the columns past it, the walk through the packed codes with the
//     kInsertExt / kDeleteExt states, and the strategy's tail (SOFTCLIP: a
//     soft clip, offset i; IGNORE: the last op repeated, or M when there is
//     none, offset i - j; else a D or I run, offset 0);
//   the merge of adjacent equal ops.  The runtime merges after the walk;
//   here a run is held open while its op repeats, which gives the same runs
//   (an extension step adds to the last op pushed, which is the open run).
//
// Layouts: bt (P, N/2, M) u8, lastrow (M, P) i32, lastcol (P, N) i32, as
// sw_forward.cu writes them.  Output (2 + cap, P) i32, lane-minor: row 0
// the lane's run count, row 1 its offset, row 2 + k its k-th run in CIGAR
// order as count << 4 | op (op: 0 M, 1 I, 2 D, 9 S).  A lane holds at most
// n + m + 2 runs (one a step, a leading clip and a tail); the wrapper
// sizes cap = N + M + 4.  Rows past a lane's count are left as they were.
// A lane with a length out of range gets count 0 and offset 0.
//
// What bounds it on this card: per lane, max(n, m) independent loads of
// lastrow and lastcol, then one dependent load of a bt byte a step, n + m
// steps at most (about m for a read soft-clipped against a haplotype): a
// chain of L2 or DRAM latencies, not bytes or operations.  The design
// keeps every lane's chain in flight at once, one thread each, in blocks
// of one warp spread over the SMs; the maximum's loads go out kBatch
// diagonals at a time, so that its part of the chain is max(n, m) / kBatch
// latencies; the lanes of a warp read lastrow coalesced, and the runs are
// written lane-minor so that the rows the host copies are contiguous.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMatch = 0;
constexpr int kInsert = 1;
constexpr int kDelete = 2;
constexpr int kInsertExt = 4;
constexpr int kDeleteExt = 8;
constexpr int kSoftclip = 9;
constexpr int kIndel = 10;
constexpr int kLeadingIndel = 11;
constexpr int kIgnore = 12;
constexpr int kBatch = 8;  // anti-diagonals whose lastrow and lastcol loads go out together

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }

__global__ void sw_walk_kernel(
    const uint8_t* __restrict__ bt, int N, int M,
    const int32_t* __restrict__ lastrow, const int32_t* __restrict__ lastcol,
    const int32_t* __restrict__ reflen, const int32_t* __restrict__ altlen,
    int P, int strategy, int cap, int32_t* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int n = reflen[p], m = altlen[p];
  if (n < 1 || n > N || m < 1 || m > M) {
    out[p] = 0;
    out[P + p] = 0;
    return;
  }

  // select_max: nothing lies on the diagonals d <= min(n, m).  The loads of
  // a batch of diagonals go out together (they do not depend on the held
  // cell), then the batch is folded in order.
  int32_t score = INT_MIN;
  int max_i = 0, max_j = 0;
  const bool track_lastrow = strategy == kSoftclip || strategy == kIgnore;
  const int32_t* lastcol_p = lastcol + (size_t)p * N;
  const int d_end = n + m;
  for (int d0 = min(n, m) + 1; d0 <= d_end; d0 += kBatch) {
    int32_t row_sc[kBatch], col_sc[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int d = d0 + k;
      row_sc[k] = track_lastrow && d > n && d <= d_end
                      ? __ldg(lastrow + (size_t)(d - n - 1) * P + p) : 0;
      col_sc[k] = d > m && d <= d_end ? __ldg(lastcol_p + (d - m - 1)) : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int d = d0 + k;
      if (d > d_end) break;
      if (track_lastrow && d > n) {
        const int j0 = d - n;
        const int32_t sc = row_sc[k];
        if (score < sc || (score == sc && iabs(n - j0) < iabs(max_i - max_j))) {
          score = sc;
          max_i = n;
          max_j = j0;
        }
      }
      if (d > m) {
        const int i0 = d - m;
        const int32_t sc = col_sc[k];
        if (score < sc ||
            (score == sc && (max_j == m || iabs(i0 - m) <= iabs(max_i - max_j)))) {
          score = sc;
          max_i = i0;
          max_j = m;
        }
      }
    }
  }

  int i, j;
  if (strategy == kIndel) {
    i = n;
    j = m;
  } else if (strategy == kLeadingIndel) {
    i = max_i;
    j = m;
  } else {
    i = max_i;
    j = max_j;
  }

  // runs in walk order; the open run is (op, cnt), op -1 before the first
  int32_t* runs = out + 2 * (size_t)P + p;
  int nr = 0, op = -1, cnt = 0;
  auto push = [&](int o, int c) {
    if (o == op) {
      cnt += c;
      return;
    }
    if (op >= 0 && nr < cap) runs[(size_t)nr++ * P] = cnt << 4 | op;
    op = o;
    cnt = c;
  };

  if (j < m) push(kSoftclip, m - j);
  const uint8_t* bt_p = bt + (size_t)p * (N / 2) * M;
  int state = 0;
  while (i > 0 && j > 0) {
    const uint8_t b = __ldg(bt_p + (size_t)((i - 1) >> 1) * M + (j - 1));
    const int code = ((i - 1) & 1) ? (b >> 4) : (b & 0xF);
    if (state == kInsertExt) {
      --j;
      ++cnt;
      state = code & kInsertExt;
    } else if (state == kDeleteExt) {
      --i;
      ++cnt;
      state = code & kDeleteExt;
    } else {
      switch (code & 3) {
        case kMatch:
          --i;
          --j;
          push(kMatch, 1);
          state = 0;
          break;
        case kInsert:
          --j;
          push(kInsert, 1);
          state = code & kInsertExt;
          break;
        default:
          --i;
          push(kDelete, 1);
          state = code & kDeleteExt;
          break;
      }
    }
  }

  int offset = 0;
  if (strategy == kSoftclip) {
    if (j > 0) push(kSoftclip, j);
    offset = i;
  } else if (strategy == kIgnore) {
    if (j > 0) push(op < 0 ? kMatch : op, j);
    offset = i - j;
  } else {
    if (i > 0)
      push(kDelete, i);
    else if (j > 0)
      push(kInsert, j);
  }
  if (op >= 0 && nr < cap) runs[(size_t)nr++ * P] = cnt << 4 | op;

  // CIGAR order: the walk's runs reversed
  for (int a = 0, b = nr - 1; a < b; ++a, --b) {
    const int32_t t = runs[(size_t)a * P];
    runs[(size_t)a * P] = runs[(size_t)b * P];
    runs[(size_t)b * P] = t;
  }
  out[p] = nr;
  out[P + p] = offset;
}

}  // namespace

extern "C" int gkl_sw_walk(const void* bt, int N, int M, const void* lastrow,
                           const void* lastcol, const void* reflen, const void* altlen,
                           int P, int strategy, int cap, void* out, void* stream) {
  if (P <= 0) return 0;
  if (N % 2 || cap < 2) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 32;  // a warp a block: the lanes spread over every SM
  sw_walk_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bt), N, M, static_cast<const int32_t*>(lastrow),
      static_cast<const int32_t*>(lastcol), static_cast<const int32_t*>(reflen),
      static_cast<const int32_t*>(altlen), P, strategy, cap, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
