// Fast one-shot raw-DEFLATE decoding for the BAM-read direction.
//
// The reference's Inflater is ISA-L-only (compression/IntelInflater.cc) —
// inflate is the hot codec direction for the HaplotypeCaller flow (BGZF
// blocks are read far more often than written).  This is an original
// table-driven decoder tuned for that shape: whole raw-DEFLATE streams of
// <= 64 KiB (BGZF blocks) decoded in one shot.
//
// Design:
//  * 64-bit bit accumulator refilled 8 bytes at a time (branchless
//    whole-byte refill; byte-at-a-time fallback near the input tail with
//    bounded zero padding, so no overread is possible);
//  * two-level canonical Huffman tables: a root table indexed by the low
//    ROOT bits of the accumulator (DEFLATE codes are stored MSB-first in
//    LSB-first bytes, so table indices are bit-reversed codes) with
//    appended sub-tables for codes longer than ROOT (roots 9/8: small
//    enough to stay cache-resident against the streaming output, and
//    genomic lit/len/dist codes still mostly resolve in one load);
//  * root-level literal QUADS: runs of up to four short literal codes fused
//    into one 64-bit table entry (genomic alphabets give 2-3-bit literal
//    codes, so one root-9 load emits 3-4 output bytes);
//  * match extras extracted from a SAVED accumulator copy so the live
//    accumulator sees one fused code+extra shift per code;
//  * match copies as overlap-safe 16-byte chunks whenever len <= dist
//    (one predictable branch; the <= 15-byte overrun stays inside the
//    hot-loop margin), short periods seed once then double the window;
//  * MULTI-STREAM INTERLEAVING (gkl_fast_inflate_n, up to 4-way):
//    independent BGZF blocks decode in one loop, one symbol-step each per
//    iteration, so the serial acc→load→shift dependency chains overlap in
//    the out-of-order window (match decode is ~3 dependent L1 loads, so a
//    single chain leaves most load/ALU slots idle) — the batch API feeds
//    each worker gangs of 4 blocks.
//
// Contract: gkl_fast_inflate(in, n, out, out_cap) returns bytes written,
// -1 on malformed input or insufficient out_cap (the caller falls back to
// zlib, which is the error-compatibility oracle).

#include <cstdint>
#include <cstring>

namespace {

// entry: bits(31..24) | extra(23..18) | type(17..16) | val(15..0)
// type: 0 literal (val = byte, or two bytes when extra == 2), 1 len/dist
// value (val = base, extra-bit count in 'extra'), 2 end-of-block, 3
// sub-table link (val = offset from table start, extra = sub index bits)
using Entry = uint32_t;

inline Entry make_entry(unsigned bits, unsigned type, unsigned extra,
                        unsigned val) {
  return (bits << 24) | (extra << 18) | (type << 16) | val;
}
inline unsigned e_bits(Entry e) { return e >> 24; }
inline unsigned e_type(Entry e) { return (e >> 16) & 3u; }
inline unsigned e_extra(Entry e) { return (e >> 18) & 63u; }
inline unsigned e_val(Entry e) { return e & 0xFFFFu; }

constexpr Entry kInvalid = 0;  // bits == 0 marks an unreachable index

constexpr int kRootLit = 9;
constexpr int kRootDist = 8;
constexpr int kMaxRoot = 12;  // build_table scratch sizing bound
// zlib's ENOUGH analysis bounds two-level tables at 852 (root 9) / 592
// (root 6) entries; these capacities are comfortably past the equivalents
// for the roots used here.
constexpr int kLitCap = (1 << kRootLit) + 1024;
constexpr int kDistCap = (1 << kRootDist) + 768;

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                               15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,    9,
                                13,   17,   25,   33,   49,   65,   97,
                                129,  193,  257,  385,  513,  769,  1025,
                                1537, 2049, 3073, 4097, 6145, 8193, 12289,
                                16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,  4,  4,  5,
                                5, 6, 6, 7, 7, 8, 8,  9,  9,  10, 10, 11, 11,
                                12, 12, 13, 13};
const uint8_t kClPerm[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                             11, 4, 12, 3, 13, 2, 14, 1, 15};

// byte-reverse LUT: rev of the low 8 bits
struct RevTab {
  uint8_t t[256];
  constexpr RevTab() : t() {
    for (int i = 0; i < 256; ++i) {
      int r = 0, c = i;
      for (int b = 0; b < 8; ++b) { r = (r << 1) | (c & 1); c >>= 1; }
      t[i] = (uint8_t)r;
    }
  }
};
constexpr RevTab kRev;

inline uint32_t bitrev(uint32_t code, int len) {
  uint32_t r = ((uint32_t)kRev.t[code & 0xFF] << 8) | kRev.t[(code >> 8) & 0xFF];
  return r >> (16 - len);
}

enum TableKind { kKindCl, kKindLitLen, kKindDist };

// Build a two-level decode table from canonical code lengths.  Returns the
// total entry count used, or -1 for an oversubscribed (invalid) code.
// Incomplete codes leave unreachable indices as kInvalid (errors at decode
// time), matching the spec's tolerance for e.g. single-distance streams.
int build_table(const uint8_t* lens, int nsym, int root, Entry* table,
                int cap, TableKind kind) {
  int count[16] = {0};
  for (int s = 0; s < nsym; ++s) count[lens[s]]++;
  if (count[0] == nsym) {
    // no codes at all: legal for distances (literal-only stream) — any
    // match decode then hits kInvalid
    if (kind != kKindDist) return -1;
    for (int i = 0; i < (1 << root); ++i) table[i] = kInvalid;
    return 1 << root;
  }
  // canonical first codes + oversubscription check
  int code = 0, left = 1;
  int first[16] = {0};
  for (int l = 1; l <= 15; ++l) {
    left <<= 1;
    left -= count[l];
    if (left < 0) return -1;
    first[l] = code;
    code = (code + count[l]) << 1;
  }
  int root_size = 1 << root;
  bool complete = (left == 0);
  if (!complete) {
    // zlib's acceptance set (inftrees.c): an incomplete code is an error
    // unless it has exactly ONE 1-bit symbol — and never for the
    // code-lengths code.  Matching zlib exactly keeps "fast accepts what
    // zlib rejects" impossible at header level (the invariant the
    // mutation fuzz pins); decode-time kInvalid covers the allowed case.
    int max = 15;
    while (max > 0 && count[max] == 0) --max;
    if (kind == kKindCl || max != 1) return -1;
    std::memset(table, 0, sizeof(Entry) * (size_t)root_size);
  }

  // per-root-slot max length for sub-table sizing
  uint8_t slot_max[1 << kMaxRoot];
  std::memset(slot_max, 0, (size_t)root_size);
  int next_code[16];
  std::memcpy(next_code, first, sizeof(first));
  bool has_long = false;
  for (int s = 0; s < nsym; ++s) {
    int l = lens[s];
    if (l == 0 || l <= root) {
      if (l) next_code[l]++;
      continue;
    }
    has_long = true;
    uint32_t rc = bitrev((uint32_t)next_code[l]++, l);
    int slot = (int)(rc & (uint32_t)(root_size - 1));
    if (l - root > slot_max[slot]) slot_max[slot] = (uint8_t)(l - root);
  }
  int next_free = root_size;
  int sub_off[1 << kMaxRoot];
  if (has_long) {
    for (int i = 0; i < root_size; ++i) {
      if (!slot_max[i]) continue;
      int size = 1 << slot_max[i];
      if (next_free + size > cap) return -1;
      sub_off[i] = next_free;
      table[i] = make_entry(0, 3, slot_max[i], (unsigned)next_free);
      for (int k = 0; k < size; ++k) table[next_free + k] = kInvalid;
      next_free += size;
    }
  }

  std::memcpy(next_code, first, sizeof(first));
  int min_lit = 16;
  for (int s = 0; s < nsym; ++s) {
    int l = lens[s];
    if (l == 0) continue;
    uint32_t rc = bitrev((uint32_t)next_code[l]++, l);
    if (kind == kKindLitLen && s < 256 && l < min_lit) min_lit = l;
    Entry e;
    if (kind == kKindCl) {
      e = make_entry(l, 0, 0, (unsigned)s);
    } else if (kind == kKindLitLen) {
      if (s < 256) e = make_entry(l, 0, 1, (unsigned)s);
      else if (s == 256) e = make_entry(l, 2, 0, 0);
      else if (s <= 285) e = make_entry(l, 1, kLenExtra[s - 257], kLenBase[s - 257]);
      // 286/287 reserved: WRITE an invalid entry (zlib's op-64 marker) so
      // a complete code — the STATIC table counts them — leaves no
      // uninitialized slots; referencing one errors at decode time
      else e = kInvalid;
    } else {
      if (s < 30) e = make_entry(l, 1, kDistExtra[s], kDistBase[s]);
      else e = kInvalid;  // 30/31 reserved: as above (static dist table)
    }
    if (l <= root) {
      int step = 1 << l;
      for (int i = (int)rc; i < root_size; i += step) table[i] = e;
    } else {
      int slot = (int)(rc & (uint32_t)(root_size - 1));
      int sub_bits = slot_max[slot];
      int step = 1 << (l - root);
      int size = 1 << sub_bits;
      for (int i = (int)(rc >> root); i < size; i += step)
        table[sub_off[slot] + i] = e;
    }
  }
  (void)min_lit;
  return next_free;
}

// 64-bit decode entry for the hot loops (litlen AND dist tables):
//   bits(63..56) | extra(55..50) | type(49..48) | total(47..32) | val(31..0)
// type 0: literal BURST — extra = byte count 1..4, val = the bytes LE.
// type 1: len/dist value — ``total`` precomputes bits + extra so the hot
// path's fused code+extra consume needs no add on the load→shift critical
// chain.  Other types mirror the 32-bit layout (val fits 32 bits).
using LitEntry = uint64_t;
inline LitEntry make_lit_entry(unsigned bits, unsigned type, unsigned extra,
                               uint32_t val) {
  unsigned total = bits + (type == 1 ? extra : 0);
  return ((uint64_t)bits << 56) | ((uint64_t)extra << 50) |
         ((uint64_t)type << 48) | ((uint64_t)total << 32) | val;
}
inline unsigned le_bits(LitEntry e) { return (unsigned)(e >> 56); }
inline unsigned le_type(LitEntry e) { return (unsigned)(e >> 48) & 3u; }
inline unsigned le_extra(LitEntry e) { return (unsigned)(e >> 50) & 63u; }
inline unsigned le_total(LitEntry e) { return (unsigned)(e >> 32) & 0xFFFFu; }
inline uint32_t le_val(LitEntry e) { return (uint32_t)e; }

// Widen a freshly built 32-bit table to 64-bit entries; for litlen roots
// (fuse=true) additionally fuse runs of up to FOUR short literal codes into
// single root entries (val = bytes LE, extra = count).  Genomic alphabets
// give 2-3-bit literal codes, so a root-9 lookup then emits 3-4 bytes per
// table load (the pair fusion's successor).  Chaining reads only the
// pristine 32-bit singles, so the in-place 64-bit writes cannot feed a
// fused entry back into a chain.
void widen_table(const Entry* t32, int used, LitEntry* t64, int root,
                 bool fuse) {
  for (int i = 0; i < used; ++i) {
    Entry e = t32[i];
    t64[i] = make_lit_entry(e_bits(e), e_type(e), e_extra(e), e_val(e));
  }
  if (!fuse) return;
  int root_size = 1 << root;
  for (int i = 0; i < root_size; ++i) {
    Entry e1 = t32[i];
    if (e_bits(e1) == 0 || e_type(e1) != 0) continue;
    unsigned total = e_bits(e1);
    uint32_t val = e_val(e1) & 0xFFu;
    unsigned n = 1;
    while (n < 4) {
      Entry e2 = t32[i >> total];
      if (e_bits(e2) == 0 || e_type(e2) != 0) break;
      unsigned l2 = e_bits(e2);
      if (total + l2 > (unsigned)root) break;
      val |= (e_val(e2) & 0xFFu) << (8 * n);
      total += l2;
      ++n;
    }
    if (n > 1) t64[i] = make_lit_entry(total, 0, n, val);
  }
}

struct BitReader {
  const uint8_t* in;
  int n;
  int pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  int pad = 0;  // virtual zero bytes appended past the input tail

  inline void refill() {
    if (nbits >= 56) return;
    if (pos + 8 <= n) {
      uint64_t w;
      std::memcpy(&w, in + pos, 8);
      acc |= w << nbits;
      pos += (63 - nbits) >> 3;
      nbits |= 56;
      return;
    }
    while (nbits <= 56) {
      if (pos < n) {
        acc |= (uint64_t)in[pos++] << nbits;
      } else {
        ++pad;  // zero padding; bounded by the caller's pad check
      }
      nbits += 8;
    }
  }

  inline uint32_t get(int k) {
    uint32_t v = (uint32_t)(acc & ((k ? (1ull << k) : 1ull) - 1ull));
    acc >>= k;
    nbits -= k;
    return v;
  }

  // True once CONSUMED bits extend past the real input: bits fed into the
  // accumulator are 8*(pos + pad), of which nbits are still unconsumed.
  // (pad alone is the wrong test — padding bytes that were appended but
  // never consumed are legal, and short tail symbols can push pad past any
  // fixed bound while consuming only real bits.)
  // 64-bit arithmetic: the generic Inflater path feeds whole streams, so n
  // can exceed 256 MiB where 8*n overflows int.
  inline bool overrun() const {
    return 8 * ((int64_t)pos + pad) - nbits > 8 * (int64_t)n;
  }

  inline void drop(int k) {
    acc >>= k;
    nbits -= k;
  }
};

struct Tables {
  LitEntry lit[kLitCap];
  LitEntry dist[kDistCap];
};

// Build litlen singles into 32-bit scratch, then widen+fuse into the 64-bit
// decode table.  Returns the scratch entry count (< 0 on invalid code).
int build_lit_table(const uint8_t* lens, int nsym, LitEntry* t64) {
  Entry scratch[kLitCap];
  int used = build_table(lens, nsym, kRootLit, scratch, kLitCap, kKindLitLen);
  if (used > 0) widen_table(scratch, used, t64, kRootLit, true);
  return used;
}

// Same for the distance table (no fusion; the widening buys the
// precomputed bits+extra ``total``).
int build_dist_table(const uint8_t* lens, int nsym, LitEntry* t64) {
  Entry scratch[kDistCap];
  int used = build_table(lens, nsym, kRootDist, scratch, kDistCap, kKindDist);
  if (used > 0) widen_table(scratch, used, t64, kRootDist, false);
  return used;
}

// static (btype==1) tables, built once
struct StaticTables {
  Tables t;
  bool ok;
  StaticTables() {
    uint8_t lens[288];
    for (int i = 0; i < 144; ++i) lens[i] = 8;
    for (int i = 144; i < 256; ++i) lens[i] = 9;
    for (int i = 256; i < 280; ++i) lens[i] = 7;
    for (int i = 280; i < 288; ++i) lens[i] = 8;
    ok = build_lit_table(lens, 288, t.lit) > 0;
    uint8_t dl[32];
    for (int i = 0; i < 32; ++i) dl[i] = 5;
    ok = ok && build_dist_table(dl, 32, t.dist) > 0;
  }
};

const StaticTables& static_tables() {
  static const StaticTables t;
  return t;
}

inline int decode_sym(BitReader& br, const Entry* table, int root,
                      Entry* out_e) {
  Entry e = table[br.acc & ((1u << root) - 1u)];
  if (e_type(e) == 3) {
    unsigned sub_bits = e_extra(e);
    e = table[e_val(e) + ((br.acc >> root) & ((1u << sub_bits) - 1u))];
  }
  unsigned bits = e_bits(e);
  if (bits == 0) return -1;
  br.drop((int)bits);
  *out_e = e;
  return 0;
}

inline int decode_sym64(BitReader& br, const LitEntry* table, int root,
                        LitEntry* out_e) {
  LitEntry e = table[br.acc & ((1u << root) - 1u)];
  if (le_type(e) == 3) {
    unsigned sub_bits = le_extra(e);
    e = table[le_val(e) + ((br.acc >> root) & ((1u << sub_bits) - 1u))];
  }
  unsigned bits = le_bits(e);
  if (bits == 0) return -1;
  br.drop((int)bits);
  *out_e = e;
  return 0;
}

// decoder states
enum {
  ST_HEADER = 0,  // next bits are a block header (or first block)
  ST_HUFF = 1,    // inside a huffman block, lit/dist set
  ST_DONE = 2,
  ST_ERR = -1,
};

struct Ctx {
  BitReader br;
  Tables dyn;
  const LitEntry* lit = nullptr;
  const LitEntry* dist = nullptr;
  uint8_t* out = nullptr;
  int op = 0;
  int out_cap = 0;
  uint32_t bfinal = 0;
  int state = ST_HEADER;
};

// Process block headers (and whole stored blocks) until entering a huffman
// block, finishing, or erroring.  Leaves state ST_HUFF / ST_DONE / ST_ERR.
void enter_block(Ctx& c) {
  BitReader& br = c.br;
  const uint8_t* in = br.in;
  const int n = br.n;
  for (;;) {
    br.refill();
    if (br.overrun()) { c.state = ST_ERR; return; }
    c.bfinal = br.get(1);
    uint32_t btype = br.get(2);
    if (btype == 0) {
      // stored block: align, LEN/NLEN, bulk copy.  The refill may have
      // padded past the input tail (legal when this is the last block);
      // only the REAL bits (nbits - 8*pad) may be consumed as data.
      br.drop(br.nbits & 7);
      br.refill();
      if (br.nbits - 8 * br.pad < 32) { c.state = ST_ERR; return; }
      uint32_t len = br.get(16);
      uint32_t nlen = br.get(16);
      if ((len ^ nlen) != 0xFFFFu) { c.state = ST_ERR; return; }
      if (c.op + (int)len > c.out_cap) { c.state = ST_ERR; return; }
      // drain REAL bytes still in the accumulator, then memcpy the rest
      while (len && br.nbits - 8 * br.pad >= 8) {
        c.out[c.op++] = (uint8_t)(br.acc & 0xFF);
        br.drop(8);
        --len;
      }
      if (len) {
        if (br.pos + (int)len > n) { c.state = ST_ERR; return; }
        std::memcpy(c.out + c.op, in + br.pos, len);
        br.pos += (int)len;
        c.op += (int)len;
      }
      // the bulk copy advanced pos past bytes whose stale images still sit
      // in the accumulator's unaccounted top bits — clear them so the next
      // refill's OR sees zeros there
      br.acc &= br.nbits ? ((1ull << br.nbits) - 1ull) : 0ull;
      if (c.bfinal) { c.state = ST_DONE; return; }
      continue;
    }
    if (btype == 3) { c.state = ST_ERR; return; }
    if (btype == 1) {
      c.lit = static_tables().t.lit;
      c.dist = static_tables().t.dist;
      c.state = ST_HUFF;
      return;
    }
    // dynamic header
    br.refill();
    int hlit = (int)br.get(5) + 257;
    int hdist = (int)br.get(5) + 1;
    int hclen = (int)br.get(4) + 4;
    // RFC 1951 3.2.7: litlen symbols 286/287 and dist symbols 30/31 are
    // reserved and must not participate in the code.  Rejecting the counts
    // here (zlib: "too many length or distance symbols") keeps build_table's
    // reserved-skip branches unreachable, so a "complete" code can never
    // leave stale root slots pointing at a previous block's entries.
    if (hlit > 286 || hdist > 30) { c.state = ST_ERR; return; }
    uint8_t cl_lens[19] = {0};
    for (int i = 0; i < hclen; ++i) {
      if (br.nbits < 3) br.refill();
      cl_lens[kClPerm[i]] = (uint8_t)br.get(3);
    }
    Entry cl_table[1 << 7];
    if (build_table(cl_lens, 19, 7, cl_table, 1 << 7, kKindCl) < 0) {
      c.state = ST_ERR;
      return;
    }
    uint8_t lens[288 + 32] = {0};
    int total = hlit + hdist;
    int i = 0;
    while (i < total) {
      br.refill();
      if (br.overrun()) { c.state = ST_ERR; return; }
      Entry e;
      if (decode_sym(br, cl_table, 7, &e)) { c.state = ST_ERR; return; }
      unsigned sym = e_val(e);
      if (sym < 16) {
        lens[i++] = (uint8_t)sym;
      } else if (sym == 16) {
        if (i == 0) { c.state = ST_ERR; return; }
        int rep = 3 + (int)br.get(2);
        if (i + rep > total) { c.state = ST_ERR; return; }
        uint8_t prev = lens[i - 1];
        while (rep--) lens[i++] = prev;
      } else if (sym == 17) {
        int rep = 3 + (int)br.get(3);
        if (i + rep > total) { c.state = ST_ERR; return; }
        i += rep;  // already zero
      } else {
        int rep = 11 + (int)br.get(7);
        if (i + rep > total) { c.state = ST_ERR; return; }
        i += rep;
      }
    }
    if (lens[256] == 0) { c.state = ST_ERR; return; }  // no end-of-block
    if (build_lit_table(lens, hlit, c.dyn.lit) < 0 ||
        build_dist_table(lens + hlit, hdist, c.dyn.dist) < 0) {
      c.state = ST_ERR;
      return;
    }
    c.lit = c.dyn.lit;
    c.dist = c.dyn.dist;
    c.state = ST_HUFF;
    return;
  }
}

// Register-resident hot state for the fast loops (synced from/to Ctx).
struct Hot {
  uint64_t acc;
  int nbits;
  const uint8_t* p;       // next input byte (in + pos)
  uint8_t* o;             // next output byte (out + op)
  const LitEntry* lit;
  const LitEntry* dist;
  const uint8_t* p_fast;  // p must stay <= p_fast for unchecked refills
  uint8_t* o_fast;        // o must stay <= o_fast for unchecked writes
  uint8_t* out0;          // output base (match-distance bound check)
};

inline void hot_load(Hot& h, const Ctx& c) {
  h.acc = c.br.acc;
  h.nbits = c.br.nbits;
  h.p = c.br.in + c.br.pos;
  h.o = c.out + c.op;
  h.lit = c.lit;
  h.dist = c.dist;
  h.p_fast = c.br.in + (c.br.n - 8);
  h.o_fast = c.out + (c.out_cap - 258 - 16);
  h.out0 = c.out;
}

inline void hot_store(const Hot& h, Ctx& c) {
  c.br.acc = h.acc;
  c.br.nbits = h.nbits;
  c.br.pos = (int)(h.p - c.br.in);
  c.op = (int)(h.o - c.out);
}

#define GKL_HOT_REFILL(h)                                                   \
  do {                                                                      \
    if ((h).nbits < 48) {                                                   \
      uint64_t w_;                                                          \
      std::memcpy(&w_, (h).p, 8);                                \
      (h).acc |= w_ << (h).nbits;                                           \
      (h).p += (63 - (h).nbits) >> 3;                                     \
      (h).nbits |= 56;                                                      \
    }                                                                       \
  } while (0)

// One hot-loop step: decode one symbol (a literal group with its burst, or
// one match).  Returns 0 = keep going (``e`` holds the next carried entry),
// 1 = end of block, -1 = error, 2 = tail handoff to the careful loop (the
// step completed but the next refill would cross the input margin).
//
// Software-pipelined: the next litlen entry is loaded BEFORE the current
// match copy executes, so the table-load latency overlaps the copy; the
// top-of-step refill only ORs new bytes into the accumulator's HIGH bits,
// so a carried entry (loaded when >= kRootLit bits were valid) stays
// correct across it.
__attribute__((always_inline)) inline int hot_step(Hot& h, LitEntry& e) {
  constexpr uint32_t lmask = (1u << kRootLit) - 1u;
  constexpr uint32_t dmask = (1u << kRootDist) - 1u;
  unsigned bits, ex, t;
  int len;
  uint64_t saved;
  // budget for the worst-case symbol (lit/len code 15 + len extra 5 +
  // dist code 15-via-subtable + dist extra 13 = 48); the carried entry's
  // index bits are already valid, the refill only appends above them
  GKL_HOT_REFILL(h);
  if (__builtin_expect(le_type(e) == 3, 0))
    e = h.lit[le_val(e) + ((h.acc >> kRootLit) & ((1u << le_extra(e)) - 1u))];
  bits = le_bits(e);
  if (bits == 0) return -1;
  t = le_type(e);
  if (t == 1) goto match;  // matches dominate genomic blocks
  h.acc >>= bits;
  h.nbits -= (int)bits;
  if (t == 2) return 1;
  {
    uint32_t v = le_val(e);
    std::memcpy(h.o, &v, 4);           // unconditional quad store; the
    h.o += (int)le_extra(e);           // margin covers the dead bytes
    // burst: more literal groups from the same refill window (each
    // costs one table load; carried non-literals skip the reload).
    // Fused quads of short genomic codes run 8-9 bits per group, so up
    // to 5 groups (20 bytes) fit one 48-bit window
    for (int k = 0; k < 7 && h.nbits >= 15; ++k) {
      e = h.lit[h.acc & lmask];
      bits = le_bits(e);
      if (le_type(e) != 0) {
        // lit -> match transition without bouncing through the outer
        // loop: top the window back up (margin-checked) and fall into
        // the match body directly
        if (le_type(e) == 1 && bits != 0) {
          // the burst advanced o, so the step-entry output margin no
          // longer covers a worst-case 258+15-byte match store — recheck
          // before falling through (else: carried; careful loop)
          if (h.o > h.o_fast) return 0;
          if (h.nbits < 48) {
            if (h.p > h.p_fast) return 0;  // carried; careful loop
            GKL_HOT_REFILL(h);
          }
          goto match;
        }
        return 0;  // carried entry (eob / subtable / invalid)
      }
      if (bits == 0) return 0;
      h.acc >>= bits;
      h.nbits -= (int)bits;
      v = le_val(e);
      std::memcpy(h.o, &v, 4);
      h.o += (int)le_extra(e);
    }
    // the top refill can have advanced pos to n-1, so re-check before
    // refilling again; past the margin the caller exits to the careful
    // loop at this (consistent) symbol boundary
    if (h.p <= h.p_fast) {
      GKL_HOT_REFILL(h);
      e = h.lit[h.acc & lmask];
    }
    return 0;
  }
match:
  // length + distance, extras from a SAVED accumulator copy: ONE fused
  // code+extra shift per code on the live accumulator (the len code's
  // consume is folded in here too, off the dependency chain)
  ex = le_extra(e);
  saved = h.acc >> bits;
  h.acc >>= le_total(e);  // bits + ex, precomputed off the critical chain
  h.nbits -= (int)le_total(e);
  len = (int)le_val(e) + (int)(saved & ((1u << ex) - 1u));
  LitEntry de = h.dist[h.acc & dmask];
  if (__builtin_expect(le_type(de) == 3, 0))
    de = h.dist[le_val(de) +
                ((h.acc >> kRootDist) & ((1u << le_extra(de)) - 1u))];
  bits = le_bits(de);
  if (bits == 0 || le_type(de) != 1) return -1;
  ex = le_extra(de);
  saved = h.acc >> bits;
  h.acc >>= le_total(de);
  h.nbits -= (int)le_total(de);
  int dist = (int)le_val(de) + (int)(saved & ((1u << ex) - 1u));
  if (__builtin_expect(dist > (int)(h.o - h.out0), 0)) return -1;
  // preload the next entry before the copy; top up first if the match
  // consumed into the root-index bits (rare: only 43-bit symbols).  If
  // the refill would read past the tail margin, run the copy and hand
  // the stream to the careful loop at this symbol boundary instead.
  bool tail = false;
  if (__builtin_expect(h.nbits < kRootLit, 0)) {
    if (__builtin_expect(h.p > h.p_fast, 0))
      tail = true;
    else
      GKL_HOT_REFILL(h);
  }
  if (!tail) e = h.lit[h.acc & lmask];
  uint8_t* dst = h.o;
  const uint8_t* src = dst - dist;
  h.o += len;
  if (__builtin_expect(len <= dist, 1)) {
    // non-self-overlapping: 16-byte chunks regardless of distance.  The
    // up-to-15-byte overrun writes scratch into [dst+len, dst+len+15)
    // (inside the hot-loop margin, overwritten by subsequent output) and
    // its reads stay within already-produced output — so ONE predictable
    // branch replaces the distance-class dispatch.  Load-then-store via a
    // local keeps the chunk defined when dist < 16 (the regions then
    // overlap; this compiles to one 16B load + 16B store).
    do {
      uint8_t tmp16[16];
      std::memcpy(tmp16, src, 16);
      std::memcpy(dst, tmp16, 16);
      dst += 16;
      src += 16;
      len -= 16;
    } while (len > 0);
  } else if (dist >= 8) {
    do {
      std::memcpy(dst, src, 8);
      dst += 8;
      src += 8;
      len -= 8;
    } while (len > 0);
  } else {
    // short period: seed one period, then double the window
    for (int k = 0; k < dist; ++k) dst[k] = src[k];
    int have = dist;
    while (have < len) {
      int c2 = have < len - have ? have : len - have;
      std::memcpy(dst + have, dst, (size_t)c2);
      have += c2;
    }
  }
  return tail ? 2 : 0;
}

// Fast loop for one stream; leaves state ST_HEADER/ST_DONE on block end,
// ST_HUFF when margins force the careful loop, ST_ERR on error.
void hot_loop(Ctx& c) {
  constexpr uint32_t lmask = (1u << kRootLit) - 1u;
  Hot h;
  hot_load(h, c);
  int r = 0;
  // every GKL_HOT_REFILL memcpys 8 bytes at pos, so each one must see
  // p <= p_fast (= in+n-8); near the tail the careful loop takes over
  if (h.p > h.p_fast || h.o > h.o_fast) {
    hot_store(h, c);
    return;  // state stays ST_HUFF -> careful_loop
  }
  GKL_HOT_REFILL(h);
  LitEntry e = h.lit[h.acc & lmask];
  while (h.p <= h.p_fast && h.o <= h.o_fast) {
    r = hot_step(h, e);
    if (r) break;
  }
  hot_store(h, c);
  if (r < 0)
    c.state = ST_ERR;
  else if (r == 1)
    c.state = c.bfinal ? ST_DONE : ST_HEADER;
  // r == 0 / 2: margins exhausted, state stays ST_HUFF -> careful loop
}

// True when the stream can enter the unchecked hot loop (same margins as
// hot_load: 8-byte refills and 258+16-byte match/pair stores must stay in
// bounds without per-access checks).
inline bool hot_margins(const Ctx& c) {
  return c.br.pos <= c.br.n - 8 && c.op <= c.out_cap - 258 - 16;
}

// Interleaved fast loop over N independent streams: one hot step each per
// iteration, so the N serial acc -> table-load -> shift dependency chains
// overlap in the out-of-order window (match-heavy genomic blocks are
// latency-bound on that chain: ~3 dependent L1 loads per match).  Two
// streams measured ~1.6x one stream's per-stream rate; four overlaps
// deeper at the cost of spilling the colder Hot fields (store-forwarded,
// off the critical path).  Exits as soon as ANY stream leaves the hot
// regime; the master loop drains that stream and re-forms the gang.
template <int N>
void hot_gang(Ctx* const* cs) {
  constexpr uint32_t lmask = (1u << kRootLit) - 1u;
  Hot h[N];
  LitEntry e[N];
  int r[N];
  for (int j = 0; j < N; ++j) {
    hot_load(h[j], *cs[j]);
    r[j] = 0;
    GKL_HOT_REFILL(h[j]);
    e[j] = h[j].lit[h[j].acc & lmask];
  }
  bool stop = false;
  while (!stop) {
#pragma GCC unroll 4
    for (int j = 0; j < N; ++j) {
      if (h[j].p > h[j].p_fast || h[j].o > h[j].o_fast) {
        stop = true;
        break;
      }
      r[j] = hot_step(h[j], e[j]);
      if (r[j]) {
        stop = true;
        break;
      }
    }
  }
  for (int j = 0; j < N; ++j) {
    hot_store(h[j], *cs[j]);
    if (r[j] < 0)
      cs[j]->state = ST_ERR;
    else if (r[j] == 1)
      cs[j]->state = cs[j]->bfinal ? ST_DONE : ST_HEADER;
    // r == 0 / 2: still ST_HUFF; the master loop careful_loops the tail
  }
}

constexpr int kMaxWay = 4;

// Careful per-symbol loop to the end of the current huffman block.
void careful_loop(Ctx& c) {
  BitReader& br = c.br;
  for (;;) {
    br.refill();
    if (br.overrun()) { c.state = ST_ERR; return; }
    LitEntry e;
    if (decode_sym64(br, c.lit, kRootLit, &e)) { c.state = ST_ERR; return; }
    unsigned t = le_type(e);
    if (t == 0) {
      uint32_t v = le_val(e);
      for (unsigned k = 0; k < le_extra(e); ++k) {
        if (c.op >= c.out_cap) { c.state = ST_ERR; return; }
        c.out[c.op++] = (uint8_t)(v >> (8 * k));
      }
      continue;
    }
    if (t == 2) break;  // end of block
    int len = (int)le_val(e) + (int)br.get((int)le_extra(e));
    br.refill();
    LitEntry de;
    if (decode_sym64(br, c.dist, kRootDist, &de)) { c.state = ST_ERR; return; }
    if (le_type(de) != 1) { c.state = ST_ERR; return; }
    int dist = (int)le_val(de) + (int)br.get((int)le_extra(de));
    if (dist > c.op) { c.state = ST_ERR; return; }  // before output start
    if (c.op + len > c.out_cap) { c.state = ST_ERR; return; }
    uint8_t* dst = c.out + c.op;
    const uint8_t* src = dst - dist;
    for (int k = 0; k < len; ++k) dst[k] = src[k];
    c.op += len;
  }
  c.state = c.bfinal ? ST_DONE : ST_HEADER;
}

int init_ctx(Ctx& c, const uint8_t* in, int n, uint8_t* out, int out_cap) {
  if (n <= 0 || !static_tables().ok) return -1;
  c.br.in = in;
  c.br.n = n;
  c.out = out;
  c.out_cap = out_cap;
  return 0;
}

int finish(Ctx& c) {
  if (c.state != ST_DONE) return -1;
  // consumed bits must not extend past the real input
  if (c.br.pad * 8 > c.br.nbits) return -1;
  return c.op;
}

// Drive one stream to completion from its current state.
void drive(Ctx& c) {
  for (;;) {
    if (c.state == ST_HEADER) enter_block(c);
    if (c.state == ST_HUFF) {
      hot_loop(c);
      if (c.state == ST_HUFF) careful_loop(c);
    }
    if (c.state == ST_DONE || c.state == ST_ERR) return;
  }
}

// Master loop for up to kMaxWay streams: advance headers, drain streams
// whose margins force the careful loop, then run the interleaved gang over
// every stream still in the hot regime.  Each pass strictly advances at
// least one stream, so the loop terminates.
void drive_n(Ctx** cs, int n) {
  for (;;) {
    bool any = false;
    for (int j = 0; j < n; ++j)
      if (cs[j]->state == ST_HEADER) {
        enter_block(*cs[j]);
        any = true;
      }
    for (int j = 0; j < n; ++j)
      if (cs[j]->state == ST_HUFF && !hot_margins(*cs[j])) {
        careful_loop(*cs[j]);  // tail symbols to block end: cheap
        any = true;
      }
    Ctx* gang[kMaxWay];
    int m = 0;
    for (int j = 0; j < n; ++j)
      if (cs[j]->state == ST_HUFF) gang[m++] = cs[j];
    if (m >= 2) {
      switch (m) {
        case 2: hot_gang<2>(gang); break;
        case 3: hot_gang<3>(gang); break;
        default: hot_gang<4>(gang); break;
      }
    } else if (m == 1) {
      drive(*gang[0]);
    } else if (!any) {
      return;  // every stream ST_DONE / ST_ERR
    }
  }
}

}  // namespace

extern "C" int gkl_fast_inflate(const uint8_t* in, int n, uint8_t* out,
                                int out_cap) {
  Ctx c;
  if (init_ctx(c, in, n, out, out_cap)) return -1;
  drive(c);
  return finish(c);
}

// N-stream entry (n <= 4): independent blocks decode with their hot steps
// interleaved (hot_gang) so the serial acc/table-load chains of the
// streams overlap.  Headers and block tails (careful loop) run per stream
// between interleaved bursts; as streams finish or error the gang shrinks
// and the remainder drive to completion.  rs[i] = bytes written or -1
// (malformed input OR undersized cap; the caller's zlib fallback is the
// error-compatibility oracle).
extern "C" void gkl_fast_inflate_n(const uint8_t* const* ins,
                                   const int32_t* ns, uint8_t* const* outs,
                                   const int32_t* caps, int32_t* rs, int n) {
  // wider-than-gang calls decode in kMaxWay groups (every rs[] is written)
  for (; n > kMaxWay; n -= kMaxWay, ins += kMaxWay, ns += kMaxWay,
                      outs += kMaxWay, caps += kMaxWay, rs += kMaxWay)
    gkl_fast_inflate_n(ins, ns, outs, caps, rs, kMaxWay);
  Ctx c[kMaxWay];
  Ctx* live[kMaxWay];
  int idx[kMaxWay];
  int m = 0;
  for (int j = 0; j < n; ++j) {
    if (init_ctx(c[m], ins[j], ns[j], outs[j], caps[j])) {
      rs[j] = -1;
      continue;
    }
    live[m] = &c[m];
    idx[m] = j;
    ++m;
  }
  if (m) drive_n(live, m);
  for (int j = 0; j < m; ++j) rs[idx[j]] = finish(*live[j]);
}

// Two-stream entry kept for ABI continuity; forwards to the gang driver.
extern "C" void gkl_fast_inflate2(const uint8_t* in1, int n1, uint8_t* out1,
                                  int cap1, const uint8_t* in2, int n2,
                                  uint8_t* out2, int cap2, int* r1, int* r2) {
  const uint8_t* ins[2] = {in1, in2};
  const int32_t ns[2] = {n1, n2};
  uint8_t* outs[2] = {out1, out2};
  const int32_t caps[2] = {cap1, cap2};
  int32_t rs[2];
  gkl_fast_inflate_n(ins, ns, outs, caps, rs, 2);
  *r1 = rs[0];
  *r2 = rs[1];
}
