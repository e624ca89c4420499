// Native BAM record scanner — the data-loader stage in C++.
//
// The reference delegates record decoding to htsjdk (JVM); here the
// decompressed BAM payload is scanned natively: record boundaries, fixed
// fields, and the 4-bit-packed sequences unpack in one pass into flat
// arrays the Python layer wraps as numpy views.  Two-phase contract:
// gkl_bam_count sizes the output buffers, gkl_bam_scan fills them.

#include <cstdint>
#include <cstring>

namespace {

inline int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

const char kSeqNibble[16] = {'=', 'A', 'C', 'M', 'G', 'R', 'S', 'V',
                             'T', 'W', 'Y', 'H', 'K', 'D', 'B', 'N'};

}  // namespace

extern "C" {

// First pass: count records and total sequence/name bytes from `offset`.
// Returns 0 on success, -1 on a truncated/corrupt payload.
int gkl_bam_count(const uint8_t* payload, int64_t len, int64_t offset,
                  int64_t max_records, int64_t* n_records_out,
                  int64_t* seq_bytes_out, int64_t* name_bytes_out) {
  int64_t n = 0, seq_bytes = 0, name_bytes = 0;
  while (offset + 4 <= len && (max_records <= 0 || n < max_records)) {
    int32_t block_size = rd_i32(payload + offset);
    int64_t start = offset + 4;
    if (block_size < 32 || start + block_size > len) return -1;
    const uint8_t* r = payload + start;
    uint8_t l_read_name = r[8];
    int32_t l_seq = rd_i32(r + 16);
    uint16_t n_cig = rd_u16(r + 12);
    // The variable-length sections must fit inside block_size, or a
    // corrupt/truncated record (oversized l_seq / n_cigar_op) would drive
    // the unpack loops past the record and potentially past the payload.
    if (l_seq < 0 || l_read_name < 1 ||
        32 + (int64_t)l_read_name + 4 * (int64_t)n_cig +
                ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq >
            (int64_t)block_size)
      return -1;
    seq_bytes += l_seq;
    name_bytes += l_read_name;  // includes the NUL
    offset = start + block_size;
    ++n;
  }
  *n_records_out = n;
  *seq_bytes_out = seq_bytes;
  *name_bytes_out = name_bytes;
  return 0;
}

// Second pass: fill flat arrays.  Sequences unpack to ASCII bases, quals
// copy raw; cigars stay as (offset, count) into the payload for lazy
// decode.  Returns the number of records written, or -1 on error.
int64_t gkl_bam_scan(const uint8_t* payload, int64_t len, int64_t offset,
                     int64_t max_records,
                     int32_t* ref_id, int32_t* pos, int32_t* flag,
                     int32_t* mapq, int32_t* l_seq_arr,
                     int64_t* seq_off, uint8_t* seq_buf,
                     int64_t* qual_off, uint8_t* qual_buf,
                     int64_t* name_off, int32_t* name_len, uint8_t* name_buf,
                     int64_t* cigar_off, int32_t* n_cigar) {
  int64_t n = 0, sq = 0, nb = 0;
  while (offset + 4 <= len && (max_records <= 0 || n < max_records)) {
    int32_t block_size = rd_i32(payload + offset);
    int64_t start = offset + 4;
    if (block_size < 32 || start + block_size > len) return -1;
    const uint8_t* r = payload + start;
    ref_id[n] = rd_i32(r);
    pos[n] = rd_i32(r + 4);
    uint8_t l_read_name = r[8];
    mapq[n] = r[9];
    uint16_t n_cig = rd_u16(r + 12);
    flag[n] = rd_u16(r + 14);
    int32_t ls = rd_i32(r + 16);
    // same bounds check as gkl_bam_count (the two passes may see different
    // payloads if the caller mutates between calls)
    if (ls < 0 || l_read_name < 1 ||
        32 + (int64_t)l_read_name + 4 * (int64_t)n_cig +
                ((int64_t)ls + 1) / 2 + (int64_t)ls >
            (int64_t)block_size)
      return -1;
    l_seq_arr[n] = ls;

    const uint8_t* p = r + 32;
    name_off[n] = nb;
    name_len[n] = l_read_name > 0 ? l_read_name - 1 : 0;
    std::memcpy(name_buf + nb, p, l_read_name);
    nb += l_read_name;
    p += l_read_name;

    cigar_off[n] = (int64_t)(p - payload);
    n_cigar[n] = n_cig;
    p += 4 * (int64_t)n_cig;

    seq_off[n] = sq;
    qual_off[n] = sq;
    const uint8_t* packed = p;
    for (int32_t i = 0; i < ls; ++i) {
      uint8_t byte = packed[i >> 1];
      uint8_t code = (i & 1) ? (byte & 0xF) : (byte >> 4);
      seq_buf[sq + i] = (uint8_t)kSeqNibble[code];
    }
    p += (ls + 1) / 2;
    std::memcpy(qual_buf + sq, p, (size_t)ls);
    sq += ls;

    offset = start + block_size;
    ++n;
  }
  return n;
}

}  // extern "C"
