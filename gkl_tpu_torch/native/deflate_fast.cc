// One-shot DEFLATE encoder: igzip-class greedy levels 1-2, plus a lazy
// hash-chain engine for levels 3-9.
//
// The reference routes levels 1-2 to ISA-L's isal_deflate_stateless
// (compression/IntelDeflater.cc:184-275) and levels 3-9 to an Intel-patched
// zlib (IntelDeflater.cc:276-361, otc_zlib/deflate_quick.c /
// deflate_medium.c).  This file is an original implementation of both
// strategies:
//
//   1. tokenize:
//        levels 1-2 — greedy LZ77 over a packed two-slot 4-byte-hash bucket
//        (level 2 additionally inserts every position inside matches);
//        levels 3-9 — lazy matching over 6-byte-hash chains (a prev ring
//        recovers older candidates) with zlib-style good/lazy/nice/chain
//        tuning per level, plus the 4-byte bucket for short matches;
//   2. histogram the literal/length and distance symbols;
//   3. build length-limited canonical Huffman codes (15-bit cap via the
//      standard bl_count overflow adjustment);
//   4. cost-aware refinement: re-price every match against the actual code
//      lengths and DEMOTE matches that cost more bits than coding their
//      bytes as literals (on low-entropy payloads such as 2-bit DNA a short
//      match at a long distance is a net loss), then rebuild the code once;
//   5. emit ONE block choosing the cheapest of {dynamic, fixed, stored}
//      from exact bit counts.
//
// Match-finder state persists across calls per thread with a global offset
// base instead of clearing ~640 KB of tables per block: stale entries decode
// to out-of-range candidates and are rejected by the same bounds check that
// enforces the 32 KB window, and any in-range alias is verified byte-for-
// byte before use, so correctness never depends on table freshness.
//
// Output is standard RFC 1951 DEFLATE — byte identity with ISA-L/zlib is
// not a contract; round-trip and cross-implementation compatibility are.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// bit writer (LSB-first per RFC 1951)
// ---------------------------------------------------------------------------
struct BitWriter {
  uint8_t* out;
  int cap;
  int pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  // accumulate only; callers group puts (<= 57 bits) between flushes
  inline void put_nf(uint32_t bits, int n) {
    acc |= (uint64_t)bits << nbits;
    nbits += n;
  }
  // spill whole bytes with one 8-byte store (cap check once per flush)
  inline void flush() {
    if (pos + 8 > cap) {
      flush_slow();
      return;
    }
    std::memcpy(out + pos, &acc, 8);
    int bytes = nbits >> 3;
    pos += bytes;
    acc >>= bytes * 8;
    nbits &= 7;
  }
  void flush_slow() {
    while (nbits >= 8) {
      if (pos >= cap) {
        overflow = true;
        nbits = 0;
        return;
      }
      out[pos++] = (uint8_t)acc;
      acc >>= 8;
      nbits -= 8;
    }
  }
  inline void put(uint32_t bits, int n) {
    put_nf(bits, n);
    if (nbits >= 48) flush();
  }
  void align_byte() {
    flush_slow();
    if (nbits > 0) {
      if (pos >= cap) {
        overflow = true;
        return;
      }
      out[pos++] = (uint8_t)acc;
      acc = 0;
      nbits = 0;
    }
  }
  int finish() {
    align_byte();
    return overflow ? -1 : pos;
  }
};

inline uint32_t bit_reverse(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r |= ((v >> i) & 1u) << (n - 1 - i);
  return r;
}

// ---------------------------------------------------------------------------
// static symbol tables (RFC 1951 §3.2.5)
// ---------------------------------------------------------------------------
struct SymTables {
  uint16_t len_sym[259];       // match length -> litlen symbol 257..285
  uint8_t len_extra_bits[259];
  uint16_t len_extra_val[259];
  uint16_t dist_base[30];
  uint8_t dist_extra_bits[30];

  SymTables() {
    static const int lbase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                                  15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                  67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const int lext[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    for (int c = 0; c < 29; ++c) {
      int hi = (c == 28) ? 258 : lbase[c + 1] - 1;
      for (int L = lbase[c]; L <= hi && L <= 258; ++L) {
        len_sym[L] = (uint16_t)(257 + c);
        len_extra_bits[L] = (uint8_t)lext[c];
        len_extra_val[L] = (uint16_t)(L - lbase[c]);
      }
    }
    static const int dbase[30] = {1,    2,    3,    4,    5,     7,    9,
                                  13,   17,   25,   33,   49,    65,   97,
                                  129,  193,  257,  385,  513,   769,  1025,
                                  1537, 2049, 3073, 4097, 6145,  8193, 12289,
                                  16385, 24577};
    static const int dext[30] = {0, 0, 0,  0,  1,  1,  2,  2,  3,  3,
                                 4, 4, 5,  5,  6,  6,  7,  7,  8,  8,
                                 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    for (int c = 0; c < 30; ++c) {
      dist_base[c] = (uint16_t)dbase[c];
      dist_extra_bits[c] = (uint8_t)dext[c];
    }
    auto bucket_of = [&](int d) {
      int c = 29;
      while (dbase[c] > d) --c;
      return (uint8_t)c;
    };
    for (int d = 1; d <= 256; ++d) dbuck_lo[d] = bucket_of(d);
    dbuck_lo[0] = 0;
    for (int k = 0; k < 256; ++k) dbuck_hi[k] = bucket_of((k << 7) + 1);
  }

  uint8_t dbuck_lo[257];   // d in [1, 256]
  uint8_t dbuck_hi[256];   // d in (256, 32768]: index (d - 1) >> 7

  inline int dist_bucket(int d) const {
    return d <= 256 ? dbuck_lo[d] : dbuck_hi[(d - 1) >> 7];
  }
};

const SymTables kSym;

// ---------------------------------------------------------------------------
// length-limited canonical Huffman construction
// ---------------------------------------------------------------------------

// Optimal Huffman depths via the two-queue merge, then the zlib-style
// bl_count overflow adjustment to cap at `maxlen`, reassigning lengths to
// symbols by ascending frequency (deepest codes to rarest symbols).
void build_lengths(const uint32_t* freq, int n, int maxlen, uint8_t* lens) {
  std::memset(lens, 0, (size_t)n);
  int order[320];
  int nu = 0;
  for (int i = 0; i < n; ++i)
    if (freq[i]) order[nu++] = i;
  if (nu == 0) return;
  if (nu == 1) {
    lens[order[0]] = 1;
    return;
  }
  std::sort(order, order + nu, [&](int a, int b) {
    return freq[a] != freq[b] ? freq[a] < freq[b] : a < b;
  });

  // nodes: [0, nu) leaves in ascending-frequency order, internals appended
  uint64_t nf[640];
  int parent[640];
  uint8_t depth[640];
  for (int k = 0; k < nu; ++k) nf[k] = freq[order[k]];
  int li = 0;        // next unmerged leaf
  int ii = nu;       // next unmerged internal
  int ic = nu;       // next internal slot
  auto take = [&]() {
    int idx;
    if (li < nu && (ii >= ic || nf[li] <= nf[ii])) idx = li++;
    else idx = ii++;
    return idx;
  };
  while ((nu - li) + (ic - ii) >= 2) {
    int a = take();
    int b = take();
    nf[ic] = nf[a] + nf[b];
    parent[a] = ic;
    parent[b] = ic;
    ++ic;
  }
  int root = ic - 1;
  if (root < 0) return;  // unreachable (nu >= 2); silences -Wstringop-overflow
  depth[root] = 0;
  for (int k = root - 1; k >= 0; --k) depth[k] = (uint8_t)(depth[parent[k]] + 1);

  int bl_count[16];
  std::memset(bl_count, 0, sizeof(bl_count));
  // zlib's gen_bitlen invariant: `overflow` counts ALL nodes (leaves and
  // internals) beyond maxlen — each adjustment iteration then repairs
  // exactly two of them, ending with a complete (Kraft == 1) code.
  // Counting only leaves under-subscribes the code, which inflaters
  // reject ("invalid literal/lengths set").
  int overflow = 0;
  for (int k = 0; k < root; ++k)
    if (depth[k] > maxlen) ++overflow;
  for (int k = 0; k < nu; ++k) {
    int d = depth[k];
    if (d > maxlen) d = maxlen;
    bl_count[d]++;
  }
  while (overflow > 0) {
    int bits = maxlen - 1;
    while (bl_count[bits] == 0) --bits;
    bl_count[bits]--;
    bl_count[bits + 1] += 2;
    bl_count[maxlen]--;
    overflow -= 2;
  }
  // rarest symbols get the longest codes: walk lengths long -> short over
  // the ascending-frequency order
  int k = 0;
  for (int bits = maxlen; bits >= 1; --bits)
    for (int c = 0; c < bl_count[bits]; ++c) lens[order[k++]] = (uint8_t)bits;
}

// canonical (RFC 1951 §3.2.2) codes from lengths, bit-reversed for the
// LSB-first writer
void build_codes(const uint8_t* lens, int n, uint16_t* codes) {
  int bl_count[16];
  std::memset(bl_count, 0, sizeof(bl_count));
  for (int i = 0; i < n; ++i) bl_count[lens[i]]++;
  bl_count[0] = 0;
  uint32_t next_code[16];
  uint32_t code = 0;
  for (int bits = 1; bits <= 15; ++bits) {
    code = (code + bl_count[bits - 1]) << 1;
    next_code[bits] = code;
  }
  for (int i = 0; i < n; ++i)
    codes[i] = lens[i] ? (uint16_t)bit_reverse(next_code[lens[i]]++, lens[i]) : 0;
}

// ---------------------------------------------------------------------------
// code-length-sequence RLE (header, RFC 1951 §3.2.7); runs may cross the
// litlen/dist boundary, so the caller passes the concatenated sequence
// ---------------------------------------------------------------------------
struct ClToken {
  uint8_t sym;
  uint8_t extra_bits;
  uint8_t extra_val;
};

void rle_code_lengths(const uint8_t* seq, int n, std::vector<ClToken>& out) {
  int i = 0;
  while (i < n) {
    uint8_t v = seq[i];
    int run = 1;
    while (i + run < n && seq[i + run] == v) ++run;
    i += run;
    if (v == 0) {
      while (run >= 3) {
        if (run >= 11) {
          int take = run > 138 ? 138 : run;
          out.push_back({18, 7, (uint8_t)(take - 11)});
          run -= take;
        } else {
          out.push_back({17, 3, (uint8_t)(run - 3)});
          run = 0;
        }
      }
      for (; run > 0; --run) out.push_back({0, 0, 0});
    } else {
      out.push_back({v, 0, 0});
      --run;
      while (run >= 3) {
        int take = run > 6 ? 6 : run;
        out.push_back({16, 2, (uint8_t)(take - 3)});
        run -= take;
      }
      for (; run > 0; --run) out.push_back({v, 0, 0});
    }
  }
}

constexpr uint8_t kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                  11, 4,  12, 3, 13, 2, 14, 1, 15};

// ---------------------------------------------------------------------------
// match finder
// ---------------------------------------------------------------------------
inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t hash4(uint32_t v) { return (v * 2654435761u) >> 17; }  // 15-bit
inline uint32_t hash6(uint64_t v) {  // low 6 bytes -> 16-bit
  return (uint32_t)(((v & 0xFFFFFFFFFFFFull) * 0x9E3779B185EBCA87ull) >> 48);
}

constexpr int kHashSize = 1 << 15;
constexpr int kHash6Size = 1 << 16;
constexpr int kRingSize = 1 << 15;  // one entry per window position
constexpr int kWindow = 32768;

// Persistent per-thread tables.  Positions are stored as 32-bit GLOBAL
// offsets (base + local pos); `base` advances past each input so entries
// from earlier calls decode to candidates outside [0, pos) and fail the
// window/bounds check — no per-call clears.  Any in-window alias (a stale
// slot that happens to decode into range) is harmless: every candidate is
// verified byte-for-byte against the current buffer before use.
struct MatchState {
  std::vector<uint64_t> pair;    // hash4 -> two newest gpos (packed)
  std::vector<uint32_t> head6;   // hash6 -> newest gpos
  std::vector<uint32_t> ring;    // gpos & (kRingSize-1) -> previous in chain
  uint64_t base = 1 << 16;
  bool ready = false;

  void prepare(int n) {
    if (!ready) {
      pair.assign(kHashSize, 0);
      head6.assign(kHash6Size, 0);
      ring.assign(kRingSize, 0);
      ready = true;
    }
    if (base + (uint64_t)n + 1024 > 0xFFFFFFFFull) {
      std::fill(pair.begin(), pair.end(), 0);
      std::fill(head6.begin(), head6.end(), 0);
      std::fill(ring.begin(), ring.end(), 0);
      base = 1 << 16;
    }
  }
};

thread_local MatchState g_ms;

// zlib-style per-level search tuning: reduce the chain budget once the
// current match reaches `good`, stop lazy lookahead at `lazy`, stop the
// chain walk at `nice`, cap the walk at `chain` probes.
struct LevelCfg {
  int16_t good, lazy, nice, chain;
};
constexpr LevelCfg kCfg[10] = {
    {0, 0, 0, 0},  {0, 0, 0, 0},   {0, 0, 0, 0},   // 0-2: greedy path
    {8, 0, 24, 8},      {8, 8, 32, 16},   {8, 16, 64, 32},     // 3, 4, 5
    {16, 32, 128, 128}, {16, 64, 192, 256},                    // 6, 7
    {32, 128, 258, 1024}, {32, 258, 258, 4096},                // 8, 9
};

}  // namespace

extern "C" {

// One-shot raw-DEFLATE compress with per-block dynamic Huffman; returns
// bytes written, or -1 when `cap` is too small (callers fall back to zlib).
// Levels 1-2: greedy (ISA-L-class).  Levels 3-9: lazy hash-chain
// (otc_zlib-class).  All levels get the cost-aware demotion pass.
int gkl_fast_deflate_dyn(const uint8_t* in, int n, uint8_t* out, int cap,
                         int level) {
  if (level < 1) level = 1;
  if (level > 9) level = 9;
  MatchState& ms = g_ms;
  ms.prepare(n);
  const uint64_t base = ms.base;
  uint64_t* const hp4 = ms.pair.data();
  uint32_t* const hd6 = ms.head6.data();
  uint32_t* const ring = ms.ring.data();

  static thread_local std::vector<uint32_t> tokens;
  if ((int)tokens.size() < n + 16) tokens.resize((size_t)n + 16);
  uint32_t* tp = tokens.data();  // cursor: no per-token capacity branch

  uint32_t lit_freq[286];
  uint32_t dist_freq[30];
  uint32_t len_hist[259];  // raw match lengths; folded into symbols below
  std::memset(lit_freq, 0, sizeof(lit_freq));
  std::memset(dist_freq, 0, sizeof(dist_freq));
  std::memset(len_hist, 0, sizeof(len_hist));

  const SymTables& T = kSym;
  const int limit4 = n - 4;  // hash4 usable while pos <= limit4
  const int limit8 = n - 8;  // hash6 usable while pos <= limit8 (8-byte load)

  // full-prefix extension (hash6 candidates are unverified)
  auto extend_from = [&](int c, int p, int start, int maxl) {
    int L = start;
    while (L + 8 <= maxl) {
      uint64_t x = read64(in + c + L) ^ read64(in + p + L);
      if (x) return L + (__builtin_ctzll(x) >> 3);
      L += 8;
    }
    while (L < maxl && in[c + L] == in[p + L]) ++L;
    return L;
  };

  // token: [31]=match, [30]=demoted (set by the refinement pass),
  // [27:20]=len-3, [19:15]=dist bucket, [14:0]=dist-1
  auto push_match = [&](int len, int dist) {
    int dc = T.dist_bucket(dist);
    *tp++ = (1u << 31) | ((uint32_t)(len - 3) << 20) | ((uint32_t)dc << 15) |
            (uint32_t)(dist - 1);
    len_hist[len]++;
    dist_freq[dc]++;
  };

  bool force_lit = false;  // set by the level-1 sample probe below
  if (level <= 2) {
    // ---- greedy packed-pair tokenizer (levels 1-2) ----
    int pos = 0;
    // miss-run skip acceleration (the igzip/LZ4 heuristic): in regions
    // where matches keep missing (high-entropy quality bytes inside BAM
    // records), probe the dictionary at a growing stride instead of every
    // byte.  Level 2 keeps the dense every-byte probe.
    int miss_run = 0;
    const int accel_shift = level >= 2 ? 30 : 5;  // stride = 1 + run/32 (L1)
    // Level-1 sample probe: after tokenizing the first 8 KB, price that
    // window both ways (its LZ parse vs a pure order-0 literal code).  On
    // ~2-bit payloads (genomic bases) literals win by >2x, and tokenizing
    // the rest of the block is pure waste — commit to the literal stream
    // and skip it.  The 10% margin keeps borderline blocks on the full
    // parse (which still gets the exact-cost literal fallback later), so
    // a wrong commit needs the tail to differ wildly from the head.
    const int probe_at = (level == 1 && n >= 16384) ? 8192 : n + 1;
    bool probed = false;
    while (pos < n) {
      if (pos >= probe_at && !probed) {
        probed = true;
        uint32_t sfreq[257];
        std::memset(sfreq, 0, sizeof(sfreq));
        for (int i = 0; i < pos; ++i) sfreq[in[i]]++;
        sfreq[256] = 1;
        uint8_t slens[257];
        build_lengths(sfreq, 257, 15, slens);
        long long lit_bits = 0;
        for (int c = 0; c < 257; ++c)
          lit_bits += (long long)sfreq[c] * slens[c];
        uint32_t pfreq[286];
        std::memcpy(pfreq, lit_freq, sizeof(pfreq));
        pfreq[256] += 1;
        long long parse_extra = 0;
        for (int L = 3; L <= 258; ++L)
          if (len_hist[L]) {
            pfreq[T.len_sym[L]] += len_hist[L];
            parse_extra += (long long)len_hist[L] * T.len_extra_bits[L];
          }
        uint8_t plens[288], pdlens[30];
        build_lengths(pfreq, 286, 15, plens);
        build_lengths(dist_freq, 30, 15, pdlens);
        long long parse_bits = parse_extra;
        for (int c = 0; c < 286; ++c)
          parse_bits += (long long)pfreq[c] * plens[c];
        for (int c = 0; c < 30; ++c)
          parse_bits += (long long)dist_freq[c]
                        * (pdlens[c] + T.dist_extra_bits[c]);
        if (lit_bits + lit_bits / 10 < parse_bits) {
          // commit: discard the sample parse; emit the whole block as a
          // literal stream (frequencies recounted over the full input)
          tp = tokens.data();
          std::memset(lit_freq, 0, sizeof(lit_freq));
          std::memset(dist_freq, 0, sizeof(dist_freq));
          std::memset(len_hist, 0, sizeof(len_hist));
          force_lit = true;
          // the skipped tail still ages in via ms.base below; no inserts
          break;
        }
      }
      int best_len = 0, best_dist = 0;
      if (pos <= limit4) {
        uint32_t v = read32(in + pos);
        uint32_t h = hash4(v);
        uint64_t pr = hp4[h];
        hp4[h] = (pr << 32) | (uint32_t)(base + pos);
        const int maxl = n - pos < 258 ? n - pos : 258;
        int64_t cand = (int64_t)(uint32_t)pr - (int64_t)base;
        int64_t cand2 = (int64_t)(uint32_t)(pr >> 32) - (int64_t)base;
        if (cand >= 0 && pos - cand <= kWindow && read32(in + cand) == v) {
          best_len = extend_from((int)cand, pos, 4, maxl);
          best_dist = pos - (int)cand;
        }
        // only pay the second extend when it could beat the first: the
        // byte at best_len must match (best_len < 4 reduces to read32)
        if (cand2 >= 0 && pos - cand2 <= kWindow && best_len < maxl &&
            read32(in + cand2) == v &&
            in[cand2 + best_len] == in[pos + best_len]) {
          int L2 = extend_from((int)cand2, pos, 4, maxl);
          if (L2 > best_len) {
            best_len = L2;
            best_dist = pos - (int)cand2;
          }
        }
      }
      if (best_len >= 4) {
        push_match(best_len, best_dist);
        if (level >= 2) {
          // denser dictionary: insert every position inside the match
          int stop = pos + best_len < limit4 + 1 ? pos + best_len : limit4 + 1;
          for (int q = pos + 1; q < stop; ++q) {
            uint32_t hq = hash4(read32(in + q));
            hp4[hq] = (hp4[hq] << 32) | (uint32_t)(base + q);
          }
        }
        pos += best_len;
        miss_run = 0;
      } else {
        int step = 1 + (miss_run >> accel_shift);
        if (step > 16) step = 16;  // cap: re-sync quickly after entropy runs
        if (step > n - pos) step = n - pos;
        for (int k = 0; k < step; ++k) {
          uint8_t c = in[pos + k];
          *tp++ = c;
          lit_freq[c]++;
        }
        pos += step;
        miss_run += step;
      }
    }
  } else {
    // ---- lazy hash-chain tokenizer (levels 3-9) ----
    const LevelCfg cfg = kCfg[level];

    auto insert_pos = [&](int q) {
      uint32_t g = (uint32_t)(base + q);
      if (q <= limit8) {
        uint32_t h = hash6(read64(in + q));
        ring[g & (kRingSize - 1)] = hd6[h];
        hd6[h] = g;
      }
      if (q <= limit4) {
        uint32_t h = hash4(read32(in + q));
        hp4[h] = (hp4[h] << 32) | g;
      }
    };

    // best match strictly longer than floor_len, or 0; sets out_dist
    auto search = [&](int pos, int floor_len, int depth, int& out_dist) {
      const int maxl = n - pos < 258 ? n - pos : 258;
      if (pos > limit4 || floor_len >= maxl) return 0;
      int best = floor_len;
      int bdist = 0;
      const uint32_t v = read32(in + pos);
      const uint64_t pr = hp4[hash4(v)];
      for (int slot = 0; slot < 2; ++slot) {
        int64_t c =
            (int64_t)(uint32_t)(slot == 0 ? pr : pr >> 32) - (int64_t)base;
        if (c < 0 || pos - c > kWindow) continue;
        if (in[c + best] != in[pos + best]) continue;
        if (read32(in + c) != v) continue;
        int L = extend_from((int)c, pos, 4, maxl);
        if (L > best) {
          best = L;
          bdist = pos - (int)c;
          if (best >= maxl) break;
        }
      }
      if (pos <= limit8 && best < maxl && best < cfg.nice) {
        const uint64_t gmin =
            base + (uint64_t)(pos > kWindow ? pos - kWindow : 0);
        uint64_t cg = hd6[hash6(read64(in + pos))];
        while (cg >= gmin && depth-- > 0) {
          int c = (int)(cg - base);
          if (c >= pos) {  // stale alias from an earlier buffer epoch
            break;
          }
          if (in[c + best] == in[pos + best]) {
            int L = extend_from(c, pos, 0, maxl);
            if (L > best) {
              best = L;
              bdist = pos - c;
              if (best >= cfg.nice || best >= maxl) break;
            }
          }
          uint64_t nx = ring[cg & (kRingSize - 1)];
          if (nx >= cg) break;  // ring slot reused by a newer position
          cg = nx;
        }
      }
      if (bdist == 0) return 0;
      out_dist = bdist;
      return best;
    };

    int pos = 0;
    while (pos < n) {
      int d1 = 0;
      int l1 = search(pos, 3, cfg.chain, d1);
      insert_pos(pos);
      if (l1 == 0) {
        uint8_t c = in[pos];
        *tp++ = c;
        lit_freq[c]++;
        ++pos;
        continue;
      }
      // lazy lookahead: a strictly longer match one byte later wins; the
      // current byte becomes a literal (deflate_medium's 1-ahead deferral)
      while (l1 < cfg.lazy && pos + 1 < n) {
        int depth = l1 >= cfg.good ? cfg.chain >> 2 : cfg.chain;
        int d2 = 0;
        int l2 = search(pos + 1, l1, depth, d2);
        if (l2 == 0) break;
        uint8_t c = in[pos];
        *tp++ = c;
        lit_freq[c]++;
        ++pos;
        insert_pos(pos);
        l1 = l2;
        d1 = d2;
      }
      push_match(l1, d1);
      for (int q = pos + 1; q < pos + l1; ++q) insert_pos(q);
      pos += l1;
    }
  }
  ms.base += (uint64_t)n + 8;  // age out this buffer's entries

  uint32_t* tokens_end = tp;
  lit_freq[256]++;  // end of block
  long long len_extra_total = 0;  // identical cost under dynamic AND fixed
  for (int L = 3; L <= 258; ++L)
    if (len_hist[L]) {
      lit_freq[T.len_sym[L]] += len_hist[L];
      len_extra_total += (long long)len_hist[L] * T.len_extra_bits[L];
    }

  // ---- dynamic code + exact bit costs (rebuilt after demotion) ----
  uint8_t dyn_lit_lens[288], dyn_dist_lens[30];
  uint16_t dyn_lit_codes[288], dyn_dist_codes[30];
  int nlit = 257, ndist = 1, ncl = 4;
  std::vector<ClToken> cl;
  cl.reserve(64);
  uint8_t cl_lens[19];
  uint16_t cl_codes[19];
  long long dyn_bits = 0, fixed_bits = 0;
  auto fixed_lit_len = [](int s) {
    return s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
  };

  auto build_all = [&]() {
    build_lengths(lit_freq, 286, 15, dyn_lit_lens);
    dyn_lit_lens[286] = dyn_lit_lens[287] = 0;
    build_lengths(dist_freq, 30, 15, dyn_dist_lens);
    bool any_dist = false;
    for (int i = 0; i < 30; ++i) any_dist |= dyn_dist_lens[i] != 0;
    if (!any_dist) dyn_dist_lens[0] = 1;  // RFC: single 1-bit (unused) code
    build_codes(dyn_lit_lens, 288, dyn_lit_codes);
    build_codes(dyn_dist_lens, 30, dyn_dist_codes);

    nlit = 286;
    while (nlit > 257 && dyn_lit_lens[nlit - 1] == 0) --nlit;
    ndist = 30;
    while (ndist > 1 && dyn_dist_lens[ndist - 1] == 0) --ndist;

    uint8_t clseq[288 + 30];
    std::memcpy(clseq, dyn_lit_lens, (size_t)nlit);
    std::memcpy(clseq + nlit, dyn_dist_lens, (size_t)ndist);
    cl.clear();
    rle_code_lengths(clseq, nlit + ndist, cl);

    uint32_t cl_freq[19];
    std::memset(cl_freq, 0, sizeof(cl_freq));
    for (const ClToken& t : cl) cl_freq[t.sym]++;
    build_lengths(cl_freq, 19, 7, cl_lens);
    build_codes(cl_lens, 19, cl_codes);
    ncl = 19;
    while (ncl > 4 && cl_lens[kClOrder[ncl - 1]] == 0) --ncl;

    long long header_bits = 5 + 5 + 4 + 3LL * ncl;
    for (const ClToken& t : cl) header_bits += cl_lens[t.sym] + t.extra_bits;

    dyn_bits = header_bits;
    fixed_bits = 0;
    for (int s = 0; s < 286; ++s)
      if (lit_freq[s]) {
        dyn_bits += (long long)lit_freq[s] * dyn_lit_lens[s];
        fixed_bits += (long long)lit_freq[s] * fixed_lit_len(s);
      }
    for (int s = 0; s < 30; ++s)
      if (dist_freq[s]) {
        long long ex = (long long)dist_freq[s] * T.dist_extra_bits[s];
        dyn_bits += (long long)dist_freq[s] * dyn_dist_lens[s] + ex;
        fixed_bits += (long long)dist_freq[s] * 5 + ex;
      }
    // length extra bits are identical for both (accumulated at tokenize)
    dyn_bits += len_extra_total;
    fixed_bits += len_extra_total;
  };
  build_all();

  // ---- cost-aware demotion: a match that codes to more bits than its
  // bytes would as literals is a net loss (common on low-entropy payloads
  // where literals cost ~2-3 bits); strip it and rebuild the code.
  //
  // Pricing literals with the CURRENT code is a trap: in a match-heavy
  // stream literals are rare, so their codes are long and no match ever
  // looks like a loser.  The first round therefore prices literals with a
  // hypothetical code built from the RAW input byte histogram (the
  // self-consistent cost in the demoted regime); a second round verifies
  // against the actual rebuilt code (it can only demote more).  If the
  // final exact cost did not improve, everything reverts — demotion never
  // worsens a block. ----
  auto demote_pass = [&](const uint8_t* lit_cost) {
    bool changed = false;
    int p2 = 0;
    for (uint32_t* tk = tokens.data(); tk != tokens_end; ++tk) {
      uint32_t tok = *tk;
      if (!(tok >> 31)) {
        ++p2;
        continue;
      }
      int len = (int)((tok >> 20) & 0xFF) + 3;
      if (tok & (1u << 30)) {
        p2 += len;
        continue;
      }
      int ls = T.len_sym[len];
      int dc = (int)(tok >> 15) & 31;
      int mbits = dyn_lit_lens[ls] + T.len_extra_bits[len] +
                  dyn_dist_lens[dc] + T.dist_extra_bits[dc];
      const uint8_t* p = in + p2;
      int lbits = 0;
      for (int k = 0; k < len; ++k) {
        int c = lit_cost[p[k]];
        lbits += c ? c : 14;  // unseen byte: pessimistic long code
        if (lbits > mbits) break;
      }
      if (lbits <= mbits) {
        *tk = tok | (1u << 30);
        lit_freq[ls]--;
        dist_freq[dc]--;
        len_extra_total -= T.len_extra_bits[len];
        for (int k = 0; k < len; ++k) lit_freq[p[k]]++;
        changed = true;
      }
      p2 += len;
    }
    return changed;
  };
  bool lit_only = false;  // emit straight from `in`, ignoring the parse
  if (tokens_end != tokens.data() || force_lit) {
    uint32_t raw_freq[257];
    std::memset(raw_freq, 0, sizeof(raw_freq));
    for (int i = 0; i < n; ++i) raw_freq[in[i]]++;
    raw_freq[256] = 1;
    uint8_t est_lens[257];
    build_lengths(raw_freq, 257, 15, est_lens);

    if (level <= 2) {
      // fast levels: all-or-nothing.  The exact body cost of a pure
      // order-0 literal stream is one dot product; when it beats the LZ
      // parse (it does on ~2-bit/byte payloads), drop the parse entirely
      // and emit literals in a dedicated tight loop — no per-match walk.
      long long lo_body = 0;
      for (int c = 0; c < 257; ++c)
        lo_body += (long long)raw_freq[c] * est_lens[c];
      if (force_lit || lo_body + 64 < std::min(dyn_bits, fixed_bits)) {
        std::memcpy(lit_freq, raw_freq, 256 * sizeof(uint32_t));
        lit_freq[256] = 1;
        for (int s = 257; s < 286; ++s) lit_freq[s] = 0;
        std::memset(dist_freq, 0, sizeof(dist_freq));
        len_extra_total = 0;
        lit_only = true;
        build_all();
      }
    } else {
      // thorough levels: per-match refinement with global revert
      const long long bits_orig = std::min(dyn_bits, fixed_bits);
      uint32_t save_lit[286], save_dist[30];
      std::memcpy(save_lit, lit_freq, sizeof(save_lit));
      std::memcpy(save_dist, dist_freq, sizeof(save_dist));
      const long long save_let = len_extra_total;
      if (demote_pass(est_lens)) {
        build_all();
        if (demote_pass(dyn_lit_lens)) build_all();
        if (std::min(dyn_bits, fixed_bits) >= bits_orig) {
          // no win: restore the original parse exactly
          std::memcpy(lit_freq, save_lit, sizeof(save_lit));
          std::memcpy(dist_freq, save_dist, sizeof(save_dist));
          len_extra_total = save_let;
          for (uint32_t* tk = tokens.data(); tk != tokens_end; ++tk)
            *tk &= ~(1u << 30);  // literal tokens never carry bit 30
          build_all();
        }
      }
    }
  }

  long long stored_bits = 8LL * (n + 5LL * (n ? (n + 65534) / 65535 : 1));

  BitWriter bw{out, cap};

  if (stored_bits <= dyn_bits + 3 && stored_bits <= fixed_bits + 3) {
    // ---- stored block(s) ----
    int off = 0;
    do {
      int take = n - off > 65535 ? 65535 : n - off;
      bw.put(off + take >= n ? 1u : 0u, 1);  // BFINAL on the last piece
      bw.put(0, 2);                          // BTYPE=00
      bw.align_byte();
      if (bw.pos + 4 + take > cap) return -1;
      out[bw.pos++] = (uint8_t)take;
      out[bw.pos++] = (uint8_t)(take >> 8);
      out[bw.pos++] = (uint8_t)(~take);
      out[bw.pos++] = (uint8_t)(~take >> 8);
      std::memcpy(out + bw.pos, in + off, (size_t)take);
      bw.pos += take;
      off += take;
    } while (off < n);
    return bw.finish();
  }

  const uint8_t* lit_lens = dyn_lit_lens;
  const uint16_t* lit_codes = dyn_lit_codes;
  const uint8_t* dist_lens = dyn_dist_lens;
  const uint16_t* dist_codes = dyn_dist_codes;
  uint8_t fx_lit_lens[288], fx_dist_lens[30];
  uint16_t fx_lit_codes[288], fx_dist_codes[30];
  bool use_fixed = fixed_bits < dyn_bits;
  if (use_fixed) {
    for (int s = 0; s < 288; ++s) fx_lit_lens[s] = (uint8_t)fixed_lit_len(s);
    for (int s = 0; s < 30; ++s) fx_dist_lens[s] = 5;
    build_codes(fx_lit_lens, 288, fx_lit_codes);
    build_codes(fx_dist_lens, 30, fx_dist_codes);
    lit_lens = fx_lit_lens;
    lit_codes = fx_lit_codes;
    dist_lens = fx_dist_lens;
    dist_codes = fx_dist_codes;
  }

  bw.put(1, 1);                    // BFINAL
  bw.put(use_fixed ? 1u : 2u, 2);  // BTYPE
  if (!use_fixed) {
    bw.put((uint32_t)(nlit - 257), 5);
    bw.put((uint32_t)(ndist - 1), 5);
    bw.put((uint32_t)(ncl - 4), 4);
    for (int i = 0; i < ncl; ++i) bw.put(cl_lens[kClOrder[i]], 3);
    for (const ClToken& t : cl) {
      bw.put(cl_codes[t.sym], cl_lens[t.sym]);
      if (t.extra_bits) bw.put(t.extra_val, t.extra_bits);
    }
  }
  // merged per-block emit tables: ONE load + ONE accumulate per symbol.
  // lit_emit: code | bits<<16.  len_emit (match length 3..258): Huffman
  // code with the extra-bits value fused above it (<= 20 bits total),
  // total width in the high byte.  dist: bucketed code | bits<<24; the
  // extra value is fused at emit (it depends on d, not just the bucket).
  uint32_t lit_emit[257];
  for (int s = 0; s < 257; ++s)
    lit_emit[s] = (uint32_t)lit_codes[s] | ((uint32_t)lit_lens[s] << 16);
  uint32_t len_emit[259];
  for (int L = 3; L <= 258; ++L) {
    int ls = T.len_sym[L];
    len_emit[L] = ((uint32_t)lit_codes[ls] |
                   ((uint32_t)T.len_extra_val[L] << lit_lens[ls])) |
                  ((uint32_t)(lit_lens[ls] + T.len_extra_bits[L]) << 24);
  }
  uint32_t dist_emit[30];
  for (int dc = 0; dc < 30; ++dc)
    dist_emit[dc] = (uint32_t)dist_codes[dc] | ((uint32_t)dist_lens[dc] << 24);
  if (lit_only) {
    // pure literal stream: one load + one accumulate per input byte
    for (int i = 0; i < n; ++i) {
      if (bw.nbits > 48) bw.flush();
      uint32_t e = lit_emit[in[i]];
      bw.put_nf(e & 0xFFFF, (int)(e >> 16));
      if (bw.overflow) return -1;
    }
    bw.flush();
    bw.put(lit_codes[256], lit_lens[256]);  // EOB
    return bw.finish();
  }
  int epos = 0;  // input cursor (demoted matches emit their bytes)
  for (const uint32_t* tk = tokens.data(); tk != tokens_end; ++tk) {
    uint32_t tok = *tk;
    if (tok >> 31) {
      int len = (int)((tok >> 20) & 0xFF) + 3;
      if (tok & (1u << 30)) {
        // demoted match: its bytes go out as literals
        for (int k = 0; k < len; ++k) {
          if (bw.nbits > 48) bw.flush();
          uint32_t e = lit_emit[in[epos + k]];
          bw.put_nf(e & 0xFFFF, (int)(e >> 16));
        }
      } else {
        // max 15+5+15+13 = 48 bits per match token; a flush leaves < 8
        // pending, so ONE flush up front keeps the accumulator <= 55 bits —
        // the literal path's pre-put flush (<= 63 invariant) absorbs the
        // carry-over, so no trailing flush per match
        bw.flush();
        uint32_t le = len_emit[len];
        bw.put_nf(le & 0xFFFFFF, (int)(le >> 24));
        int d = (int)(tok & 0x7FFF) + 1;
        int dc = (int)(tok >> 15) & 31;
        uint32_t de = dist_emit[dc];
        int db = (int)(de >> 24);
        bw.put_nf((de & 0xFFFFFF) | ((uint32_t)(d - T.dist_base[dc]) << db),
                  db + T.dist_extra_bits[dc]);
      }
      epos += len;
    } else {
      // flush BEFORE accumulating: nbits <= 48 here keeps nbits + 15 < 64
      if (bw.nbits > 48) bw.flush();
      uint32_t e = lit_emit[tok & 0xFF];
      bw.put_nf(e & 0xFFFF, (int)(e >> 16));
      ++epos;
    }
    if (bw.overflow) return -1;
  }
  bw.flush();  // up to 63 bits may be pending after the token loop
  bw.put(lit_codes[256], lit_lens[256]);  // EOB
  return bw.finish();
}

}  // extern "C"
