// Host-side DEFLATE codec stage.
//
// The reference accelerates BAM block compression with ISA-L (levels 1-2)
// and a patched zlib (levels 0,3-9) behind JNI single-shot calls
// (compression/IntelDeflater.cc:164-362, IntelInflater.cc).  The TPU-native
// equivalent is a host codec stage that feeds the device pipeline: the same
// single-shot block semantics on top of system zlib, plus a multi-threaded
// batch API sized for BGZF block streams (std::thread workers; ctypes calls
// release the GIL so the pool runs truly parallel).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

extern "C" int gkl_fast_deflate_dyn(const uint8_t* in, int n, uint8_t* out,
                                    int cap, int level);
extern "C" int gkl_fast_inflate(const uint8_t* in, int n, uint8_t* out,
                                int out_cap);
extern "C" void gkl_fast_inflate_n(const uint8_t* const* ins,
                                   const int32_t* ns, uint8_t* const* outs,
                                   const int32_t* caps, int32_t* rs, int n);

namespace {

bool fast_deflate_enabled() {
  static const bool v = [] {
    const char* e = std::getenv("GKL_TPU_FAST_DEFLATE");
    return e == nullptr || e[0] != '0';
  }();
  return v;
}

bool fast_inflate_enabled() {
  static const bool v = [] {
    const char* e = std::getenv("GKL_TPU_FAST_INFLATE");
    return e == nullptr || e[0] != '0';
  }();
  return v;
}

// Interleave width for the batch inflate gangs.  2 measures fastest on the
// current hosts (3/4 spill enough hot state to lose their extra chain
// overlap); GKL_TPU_INFLATE_WAYS=1..4 overrides per host.
int inflate_ways() {
  static const int v = [] {
    const char* e = std::getenv("GKL_TPU_INFLATE_WAYS");
    int w = e != nullptr ? std::atoi(e) : 2;
    return w < 1 ? 1 : (w > 4 ? 4 : w);
  }();
  return v;
}

int do_deflate(const uint8_t* in, int in_len, uint8_t* out, int out_cap,
               int level, int nowrap) {
  // Levels 1-9 default to the one-shot fast encoder (deflate_fast.cc):
  // greedy for 1-2 where the reference routes to ISA-L
  // (IntelDeflater.cc:184-275), lazy hash-chain for 3-9 where it routes to
  // its patched zlib (IntelDeflater.cc:276-361).  Wrapped (zlib-header)
  // streams are the raw stream plus the 2-byte header and big-endian
  // adler32 trailer (RFC 1950).  GKL_TPU_FAST_DEFLATE=0 restores zlib.
  if (level >= 1 && level <= 9 && in != nullptr && fast_deflate_enabled()) {
    if (nowrap) {
      int r = gkl_fast_deflate_dyn(in, in_len, out, out_cap, level);
      if (r >= 0) return r;
    } else if (out_cap >= 6) {
      int r = gkl_fast_deflate_dyn(in, in_len, out + 2, out_cap - 6, level);
      if (r >= 0) {
        out[0] = 0x78;                         // CMF: deflate, 32 KB window
        out[1] = level >= 7 ? 0xDA : 0x9C;     // FLG: FCHECK valid for both
        uint32_t ad = (uint32_t)adler32(adler32(0L, nullptr, 0), in,
                                        (uInt)in_len);
        uint8_t* t = out + 2 + r;
        t[0] = (uint8_t)(ad >> 24);
        t[1] = (uint8_t)(ad >> 16);
        t[2] = (uint8_t)(ad >> 8);
        t[3] = (uint8_t)ad;
        return r + 6;
      }
    }
    // fall through to zlib when the stream would not fit out_cap
  }
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  int window = nowrap ? -MAX_WBITS : MAX_WBITS;
  if (deflateInit2(&zs, level, Z_DEFLATED, window, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return -1;
  zs.next_in = const_cast<Bytef*>(in);
  zs.avail_in = (uInt)in_len;
  zs.next_out = out;
  zs.avail_out = (uInt)out_cap;
  int ret = deflate(&zs, Z_FINISH);
  int written = (int)(out_cap - zs.avail_out);
  deflateEnd(&zs);
  if (ret != Z_STREAM_END) return -1;  // output buffer too small or error
  return written;
}

int do_inflate(const uint8_t* in, int in_len, uint8_t* out, int out_cap,
               int nowrap) {
  // Raw streams (the BGZF hot path) go through the table-driven fast
  // decoder (inflate_fast.cc) — the reference's inflate is ISA-L-only
  // (IntelInflater.cc).  Errors (malformed input OR undersized out_cap)
  // fall back to zlib so failure semantics stay zlib-compatible;
  // GKL_TPU_FAST_INFLATE=0 disables.
  if (nowrap && in != nullptr && fast_inflate_enabled()) {
    int r = gkl_fast_inflate(in, in_len, out, out_cap);
    if (r >= 0) return r;
  }
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  int window = nowrap ? -MAX_WBITS : MAX_WBITS;
  if (inflateInit2(&zs, window) != Z_OK) return -1;
  zs.next_in = const_cast<Bytef*>(in);
  zs.avail_in = (uInt)in_len;
  zs.next_out = out;
  zs.avail_out = (uInt)out_cap;
  int ret = inflate(&zs, Z_FINISH);
  int written = (int)(out_cap - zs.avail_out);
  inflateEnd(&zs);
  if (ret != Z_STREAM_END) return -1;
  return written;
}

}  // namespace

extern "C" {

// Single-shot block compress; returns bytes written or -1.
int gkl_deflate(const uint8_t* in, int in_len, uint8_t* out, int out_cap,
                int level, int nowrap) {
  return do_deflate(in, in_len, out, out_cap, level, nowrap);
}

// Single-shot block decompress (raw DEFLATE when nowrap, zlib otherwise).
int gkl_inflate(const uint8_t* in, int in_len, uint8_t* out, int out_cap,
                int nowrap) {
  return do_inflate(in, in_len, out, out_cap, nowrap);
}

// Upper bound on the compressed size of a block (covers both the zlib path
// and the fixed-Huffman fast path, whose worst case is 9 bits/byte).
int gkl_deflate_bound(int in_len) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  deflateInit2(&zs, 6, Z_DEFLATED, -MAX_WBITS, 8, Z_DEFAULT_STRATEGY);
  int b = (int)deflateBound(&zs, (uLong)in_len);
  deflateEnd(&zs);
  int fixed_bound = in_len + (in_len >> 3) + 64;
  return (b > fixed_bound ? b : fixed_bound) + 32;
}

uint32_t gkl_crc32(uint32_t crc, const uint8_t* data, int len) {
  return (uint32_t)crc32((uLong)crc, data, (uInt)len);
}

// Parallel batch compress: n blocks at offsets in a packed input buffer.
// Outputs are written at fixed per-block capacity strides; out_lens[i]
// receives the compressed size (or -1 on failure).
void gkl_deflate_batch(const uint8_t* in, const int64_t* in_offsets,
                       const int32_t* in_lens, int n, uint8_t* out,
                       int64_t out_stride, int32_t* out_lens, int level,
                       int nowrap, int n_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      out_lens[i] = do_deflate(in + in_offsets[i], in_lens[i],
                               out + (int64_t)i * out_stride, (int)out_stride,
                               level, nowrap);
    }
  };
  if (n_threads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Parallel batch decompress with the same packing scheme.
void gkl_inflate_batch(const uint8_t* in, const int64_t* in_offsets,
                       const int32_t* in_lens, int n, uint8_t* out,
                       int64_t out_stride, int32_t* out_lens, int nowrap,
                       int n_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    // Raw blocks are independent: each worker grabs gangs (GKL_TPU_INFLATE_WAYS, default 2) and runs
    // the interleaved decoder so the serial decode chains overlap in the
    // out-of-order window (match decode is latency-bound: ~3 dependent L1
    // loads per match).  A -1 from the fast gang (malformed OR undersized
    // out_stride) falls back per block to do_inflate, whose zlib path is
    // the error oracle.
    const int ways = inflate_ways();
    for (;;) {
      int i = next.fetch_add(ways);
      if (i >= n) return;
      int m = n - i < ways ? n - i : ways;
      if (nowrap && fast_inflate_enabled()) {
        const uint8_t* ins[4];
        uint8_t* outs[4];
        int32_t ns[4], caps[4], rs[4];
        for (int k = 0; k < m; ++k) {
          ins[k] = in + in_offsets[i + k];
          ns[k] = in_lens[i + k];
          outs[k] = out + (int64_t)(i + k) * out_stride;
          caps[k] = (int32_t)out_stride;
        }
        gkl_fast_inflate_n(ins, ns, outs, caps, rs, m);
        for (int k = 0; k < m; ++k)
          out_lens[i + k] = rs[k] >= 0 ? rs[k]
                                       : do_inflate(ins[k], ns[k], outs[k],
                                                    caps[k], nowrap);
        continue;
      }
      for (int k = i; k < i + m; ++k)
        out_lens[k] = do_inflate(in + in_offsets[k], in_lens[k],
                                 out + (int64_t)k * out_stride,
                                 (int)out_stride, nowrap);
    }
  };
  if (n_threads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Pointer-array batch decompress: like gkl_inflate_batch but each block is
// addressed directly (no host-side join into one packed buffer), and the
// workers optionally compute each decoded block's CRC32 (out_crcs != null)
// while the output is still cache-hot — the BGZF reader then verifies
// without another full pass over the payload.
void gkl_inflate_batch2(const uint8_t* const* ins, const int32_t* in_lens,
                        int n, uint8_t* out, int64_t out_stride,
                        int32_t* out_lens, uint32_t* out_crcs, int nowrap,
                        int n_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    const int ways = inflate_ways();
    for (;;) {
      int i = next.fetch_add(ways);
      if (i >= n) return;
      int m = n - i < ways ? n - i : ways;
      if (nowrap && fast_inflate_enabled()) {
        const uint8_t* gi[4];
        uint8_t* go[4];
        int32_t ns[4], caps[4], rs[4];
        for (int k = 0; k < m; ++k) {
          gi[k] = ins[i + k];
          ns[k] = in_lens[i + k];
          go[k] = out + (int64_t)(i + k) * out_stride;
          caps[k] = (int32_t)out_stride;
        }
        gkl_fast_inflate_n(gi, ns, go, caps, rs, m);
        for (int k = 0; k < m; ++k)
          out_lens[i + k] = rs[k] >= 0 ? rs[k]
                                       : do_inflate(gi[k], ns[k], go[k],
                                                    caps[k], nowrap);
      } else {
        for (int k = i; k < i + m; ++k)
          out_lens[k] = do_inflate(ins[k], in_lens[k],
                                   out + (int64_t)k * out_stride,
                                   (int)out_stride, nowrap);
      }
      if (out_crcs != nullptr) {
        for (int k = i; k < i + m; ++k)
          if (out_lens[k] >= 0)
            out_crcs[k] = (uint32_t)crc32(
                0L, out + (int64_t)k * out_stride, (uInt)out_lens[k]);
      }
    }
  };
  if (n_threads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"
