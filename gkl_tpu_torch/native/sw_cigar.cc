// CIGAR strings of a lane chunk from the runs the device walk left
// (csrc/sw_walk.cu, or its plain twin ops/sw.py::sw_walk): one call a
// chunk in place of one walk a lane.
//
// The port's own source, with no counterpart in the JAX package (which
// walks each lane on the host, native/sw_runtime.cc::walk_cigar).  The
// text is walk_cigar's: each run as its decimal count and its letter (M,
// I, D, S; R for any other code), runs of count 0 or less left out.
//
// Built into the gkl_sw_runtime library beside sw_runtime.cc; called
// through ctypes.

#include <cstdint>
#include <cstdio>

extern "C" {

// Lane c's runs lie at runs[k * stride + c] for k < counts[c] <= rows,
// each count << 4 | op in CIGAR order.  Writes every lane's CIGAR followed
// by a NUL, lane after lane, into out; returns the bytes written, -1 if cap
// is too small, or -2 if a lane counts more runs than the rows hold.
long sw_format_runs(const int32_t* runs, long stride, long rows, const int32_t* counts,
                    int lanes, char* out, long cap) {
  long pos = 0;
  for (int c = 0; c < lanes; ++c) {
    if (counts[c] > rows) return -2;
    for (int k = 0; k < counts[c]; ++k) {
      const int32_t v = runs[(long)k * stride + c];
      const int32_t cnt = v >> 4;
      if (cnt <= 0) continue;
      char op;
      switch (v & 15) {
        case 0:
          op = 'M';
          break;
        case 1:
          op = 'I';
          break;
        case 2:
          op = 'D';
          break;
        case 9:
          op = 'S';
          break;
        default:
          op = 'R';
          break;
      }
      const int written = snprintf(out + pos, (size_t)(cap - pos), "%d%c", cnt, op);
      if (written < 0 || pos + written >= cap) return -1;
      pos += written;
    }
    if (pos >= cap) return -1;
    out[pos++] = '\0';
  }
  return pos;
}

}  // extern "C"
