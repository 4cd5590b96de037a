// A zstd frame decoder (RFC 8878), for the zarr chunks and the OCDBT nodes
// of Orbax checkpoints (models/orbax_store.py). No dictionaries: a frame
// that names one is refused. Built with g++ at first use (utils/zstd.py)
// and called through ctypes; plain C interface, no dependency beyond the
// C++ standard library.
//
//   hbpe_zstd_decompress(src, n, dst, cap, err, errlen)
//       decodes every frame of src[0, n) (skippable frames are skipped)
//       into dst, one after the other; returns the number of bytes
//       written, or -1 with the reason in err.
//   hbpe_zstd_decompress_alloc(src, n, &dst, err, errlen)
//       the same into a buffer it allocates (for frames that do not
//       declare their size), released with hbpe_zstd_free(dst).
//   hbpe_zstd_content_size(src, n, err, errlen)
//       the sum of the frames' declared content sizes, -2 when a frame
//       does not declare it, -1 on a malformed input.
//
// A content checksum, when present, is verified (XXH64, low 32 bits).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) {
  return p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
}
inline uint32_t rd32(const uint8_t* p) {
  return p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}
inline uint64_t rd64(const uint8_t* p) {
  return rd32(p) | (uint64_t(rd32(p + 4)) << 32);
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ------------------------------------------------------------------ XXH64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xxmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xxround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xxround(v1, rd64(p));
      v2 = xxround(v2, rd64(p + 8));
      v3 = xxround(v3, rd64(p + 16));
      v4 = xxround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxmerge(xxmerge(xxmerge(xxmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xxround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------ bitstreams

// Forward, least significant bit first (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n, pos = 0;  // pos in bits
  ForwardBits(const uint8_t* src, size_t size) : p(src), n(size) {}
  uint32_t peek(int nb) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 8 && byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((1ULL << nb) - 1));
  }
  void skip(int nb) {
    pos += nb;
    if (pos > n * 8) fail("FSE table description: truncated");
  }
  uint32_t read(int nb) {
    uint32_t v = peek(nb);
    skip(nb);
    return v;
  }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// Backward: read from the end of the stream towards its start, the most
// significant bits first; the last byte's highest set bit marks the end.
// Bits before the start read as zero (pos < 0 then).
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;  // bits still to read
  void init(const uint8_t* src, size_t size, const char* what) {
    if (size == 0) fail(std::string(what) + ": empty bitstream");
    if (src[size - 1] == 0) fail(std::string(what) + ": bitstream lacks its end mark");
    p = src;
    n = size;
    pos = int64_t(size - 1) * 8 + highbit(src[size - 1]);
  }
  // bits [at, at + nb), nb <= 56
  uint64_t get(int64_t at, int nb) const {
    if (nb == 0) return 0;
    if (at < 0) {
      if (at + nb <= 0) return 0;
      return get(0, int(nb + at)) << (-at);
    }
    size_t byte = size_t(at) >> 3;
    uint64_t v;
    if (byte + 8 <= n) {
      std::memcpy(&v, p + byte, 8);
    } else {
      v = 0;
      for (size_t i = 0; byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    }
    return (v >> (at & 7)) & ((1ULL << nb) - 1);
  }
  uint64_t read(int nb) {
    pos -= nb;
    return get(pos, nb);
  }
  uint64_t peek(int nb) const { return get(pos - nb, nb); }
};

// ------------------------------------------------------------------- FSE

struct FSEEntry {
  uint8_t symbol, nb_bits;
  uint16_t baseline;
};

struct FSETable {
  int log = -1;  // accuracy log; -1: no table yet
  std::vector<FSEEntry> e;
};

// Decoding table of a normalized distribution (RFC 8878 4.1.1).
void build_fse(FSETable& t, const int16_t* norm, int nsym, int log) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.e.assign(size, FSEEntry{0, 0, 0});
  std::vector<uint32_t> next(nsym);
  int64_t high = int64_t(size) - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.e[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask;
      while (int64_t(pos) > high);
    }
  }
  if (pos != 0) fail("FSE table: distribution does not fill the table");
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t st = next[t.e[u].symbol]++;
    int nb = log - highbit(st);
    t.e[u].nb_bits = uint8_t(nb);
    t.e[u].baseline = uint16_t((st << nb) - size);
  }
}

void build_rle(FSETable& t, uint8_t symbol) {
  t.log = 0;
  t.e.assign(1, FSEEntry{symbol, 0, 0});
}

// Reads a table description (RFC 8878 4.1.1); returns the bytes used.
size_t read_fse(FSETable& t, const uint8_t* src, size_t n, int max_log,
                int max_symbol) {
  ForwardBits br(src, n);
  int log = int(br.read(4)) + 5;
  if (log > max_log) fail("FSE table description: accuracy log too large");
  int16_t norm[256] = {0};
  int32_t remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1) {
    if (prev0) {
      for (;;) {
        uint32_t r = br.read(2);
        sym += int(r);
        if (r != 3) break;
      }
    }
    if (sym > max_symbol) fail("FSE table description: too many symbols");
    int32_t max = (2 * threshold - 1) - remaining, count;
    uint32_t low = br.peek(nb - 1);
    if (int32_t(low) < max) {
      count = int32_t(low);
      br.skip(nb - 1);
    } else {
      count = int32_t(br.peek(nb));
      if (count >= threshold) count -= max;
      br.skip(nb);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    if (remaining <= 1) break;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE table description: probabilities do not sum up");
  build_fse(t, norm, sym, log);
  return br.bytes();
}

// --------------------------------------------------------------- Huffman

struct HufTable {
  int max_bits = 0;  // 0: no table yet
  std::vector<uint16_t> e;  // symbol | nb_bits << 8
};

// Reads a Huffman tree description (RFC 8878 4.2.1); returns the bytes used.
size_t read_huffman(HufTable& h, const uint8_t* src, size_t n) {
  if (n < 1) fail("Huffman tree description: truncated");
  uint8_t w[256] = {0};
  int nw = 0;
  size_t used;
  uint32_t hb = src[0];
  if (hb < 128) {  // FSE-compressed weights
    used = 1 + hb;
    if (used > n || hb == 0) fail("Huffman tree description: truncated");
    FSETable t;
    size_t d = read_fse(t, src + 1, hb, 6, 255);
    if (d >= hb) fail("Huffman weights: no bitstream");
    BackBits br;
    br.init(src + 1 + d, hb - d, "Huffman weights");
    uint32_t s1 = uint32_t(br.read(t.log)), s2 = uint32_t(br.read(t.log));
    for (;;) {
      if (nw >= 254) fail("Huffman weights: too many");
      const FSEEntry& a = t.e[s1];
      w[nw++] = a.symbol;
      s1 = a.baseline + uint32_t(br.read(a.nb_bits));
      if (br.pos < 0) {
        w[nw++] = t.e[s2].symbol;
        break;
      }
      const FSEEntry& b = t.e[s2];
      w[nw++] = b.symbol;
      s2 = b.baseline + uint32_t(br.read(b.nb_bits));
      if (br.pos < 0) {
        w[nw++] = t.e[s1].symbol;
        break;
      }
    }
  } else {  // 4 bits a weight
    nw = int(hb) - 127;
    used = 1 + (nw + 1) / 2;
    if (used > n) fail("Huffman tree description: truncated");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) fail("Huffman weights: weight above 11");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("Huffman weights: all zero");
  int max_bits = highbit(total) + 1;
  uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("Huffman weights: the last weight is not a power of 2");
  if (max_bits > 11) fail("Huffman weights: code longer than 11 bits");
  w[nw++] = uint8_t(highbit(left) + 1);
  uint32_t rank[13] = {0};
  for (int i = 0; i < nw; ++i) rank[w[i]]++;
  uint32_t start[13] = {0}, next = 0;
  for (int k = 1; k <= max_bits; ++k) {
    start[k] = next;
    next += rank[k] << (k - 1);
  }
  h.max_bits = max_bits;
  h.e.assign(size_t(1) << max_bits, 0);
  for (int s = 0; s < nw; ++s) {
    if (!w[s]) continue;
    uint32_t len = 1u << (w[s] - 1);
    uint16_t v = uint16_t(s | ((max_bits + 1 - w[s]) << 8));
    for (uint32_t i = 0; i < len; ++i) h.e[start[w[s]] + i] = v;
    start[w[s]] += len;
  }
  return used;
}

void decode_stream(const HufTable& h, const uint8_t* src, size_t n,
                   uint8_t* out, size_t count) {
  BackBits br;
  br.init(src, n, "Huffman literals");
  const int mb = h.max_bits;
  for (size_t i = 0; i < count; ++i) {
    uint16_t v = h.e[br.peek(mb)];
    out[i] = uint8_t(v);
    br.pos -= v >> 8;
  }
  if (br.pos != 0) fail("Huffman literals: stream not consumed exactly");
}

// ------------------------------------------------------------- sequences

const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,
                              10, 11, 12,  13,  14,  15,   16,   18,   20,   22,
                              24, 28, 32,  40,  48,  64,   128,  256,  512,  1024,
                              2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,   33,   34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Defaults {
  FSETable ll, ml, of;
  Defaults() {
    build_fse(ll, LL_DEFAULT, 36, 6);
    build_fse(ml, ML_DEFAULT, 53, 6);
    build_fse(of, OF_DEFAULT, 29, 5);
  }
};

const Defaults& defaults() {
  static const Defaults d;
  return d;
}

// What a frame carries from block to block.
struct FrameState {
  HufTable huf;
  FSETable ll, ml, of;
  uint32_t rep[3] = {1, 4, 8};
};

// Reads one table of the sequences section in `mode`; returns bytes used.
size_t read_table(FSETable& t, int mode, const FSETable& dflt, const uint8_t* src,
                  size_t n, int max_log, int max_symbol, const char* what) {
  switch (mode) {
    case 0:
      t = dflt;
      return 0;
    case 1:
      if (n < 1) fail(std::string(what) + ": truncated RLE table");
      if (src[0] > max_symbol) fail(std::string(what) + ": RLE symbol out of range");
      build_rle(t, src[0]);
      return 1;
    case 2:
      return read_fse(t, src, n, max_log, max_symbol);
    default:
      if (t.log < 0) fail(std::string(what) + ": repeat mode without a previous table");
      return 0;
  }
}

// The output: the caller's buffer, or (`grow` set) a vector that grows.
struct Out {
  uint8_t* base;
  size_t cap, pos;
  size_t frame_start;
  std::vector<uint8_t>* grow = nullptr;
  void need(size_t k) {
    if (k <= cap - pos) return;
    if (!grow) fail("output larger than the buffer given");
    grow->resize(std::max(pos + k, 2 * grow->size()));
    base = grow->data();
    cap = grow->size();
  }
};

void decode_compressed_block(FrameState& fs, const uint8_t* src, size_t n, Out& out,
                             std::vector<uint8_t>& litbuf) {
  // literals section
  if (n < 1) fail("compressed block: empty");
  const int ltype = src[0] & 3, sf = (src[0] >> 2) & 3;
  size_t regen, hdr;
  const uint8_t* lits;
  size_t used;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      regen = src[0] >> 3;
      hdr = 1;
    } else if (sf == 1) {
      if (n < 2) fail("literals header: truncated");
      regen = (src[0] >> 4) + (uint32_t(src[1]) << 4);
      hdr = 2;
    } else {
      if (n < 3) fail("literals header: truncated");
      regen = (src[0] >> 4) + (uint32_t(src[1]) << 4) + (uint32_t(src[2]) << 12);
      hdr = 3;
    }
    if (regen > (1u << 17)) fail("literals: more than 128 KiB");
    if (ltype == 0) {
      if (hdr + regen > n) fail("raw literals: truncated");
      lits = src + hdr;
      used = hdr + regen;
    } else {
      if (hdr + 1 > n) fail("RLE literals: truncated");
      litbuf.assign(regen, src[hdr]);
      lits = litbuf.data();
      used = hdr + 1;
    }
  } else {
    size_t comp;
    int streams = sf == 0 ? 1 : 4;
    if (sf < 2) {
      if (n < 3) fail("literals header: truncated");
      uint32_t h = rd24(src);
      regen = (h >> 4) & 0x3FF;
      comp = (h >> 14) & 0x3FF;
      hdr = 3;
    } else if (sf == 2) {
      if (n < 4) fail("literals header: truncated");
      uint32_t h = rd32(src);
      regen = (h >> 4) & 0x3FFF;
      comp = h >> 18;
      hdr = 4;
    } else {
      if (n < 5) fail("literals header: truncated");
      uint64_t h = rd32(src) | (uint64_t(src[4]) << 32);
      regen = (h >> 4) & 0x3FFFF;
      comp = (h >> 22) & 0x3FFFF;
      hdr = 5;
    }
    if (regen > (1u << 17)) fail("literals: more than 128 KiB");
    if (hdr + comp > n) fail("compressed literals: truncated");
    const uint8_t* p = src + hdr;
    size_t left = comp;
    if (ltype == 2) {
      size_t t = read_huffman(fs.huf, p, left);
      p += t;
      left -= t;
    } else if (fs.huf.max_bits == 0) {
      fail("treeless literals without a previous Huffman table");
    }
    litbuf.resize(regen);
    if (streams == 1) {
      decode_stream(fs.huf, p, left, litbuf.data(), regen);
    } else {
      if (left < 6) fail("literals jump table: truncated");
      size_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
      p += 6;
      left -= 6;
      if (s1 + s2 + s3 > left) fail("literals jump table: streams larger than the section");
      size_t s4 = left - s1 - s2 - s3, seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("literals: too few for four streams");
      uint8_t* o = litbuf.data();
      decode_stream(fs.huf, p, s1, o, seg);
      decode_stream(fs.huf, p + s1, s2, o + seg, seg);
      decode_stream(fs.huf, p + s1 + s2, s3, o + 2 * seg, seg);
      decode_stream(fs.huf, p + s1 + s2 + s3, s4, o + 3 * seg, regen - 3 * seg);
    }
    lits = litbuf.data();
    used = hdr + comp;
  }
  src += used;
  n -= used;

  // sequences section
  if (n < 1) fail("sequences section: missing");
  size_t nseq;
  if (src[0] < 128) {
    nseq = src[0];
    src += 1;
    n -= 1;
  } else if (src[0] < 255) {
    if (n < 2) fail("sequences header: truncated");
    nseq = ((src[0] - 128u) << 8) + src[1];
    src += 2;
    n -= 2;
  } else {
    if (n < 3) fail("sequences header: truncated");
    nseq = src[1] + (uint32_t(src[2]) << 8) + 0x7F00;
    src += 3;
    n -= 3;
  }
  size_t lit_left = regen;
  if (nseq == 0) {
    if (n != 0) fail("block: bytes after the literals of a block without sequences");
    out.need(lit_left);
    std::memcpy(out.base + out.pos, lits, lit_left);
    out.pos += lit_left;
    return;
  }
  if (n < 1) fail("sequences header: missing modes");
  const int modes = src[0];
  if (modes & 3) fail("sequences header: reserved bits set");
  src += 1;
  n -= 1;
  const Defaults& d = defaults();
  size_t t;
  t = read_table(fs.ll, modes >> 6, d.ll, src, n, 9, 35, "literal lengths");
  src += t;
  n -= t;
  t = read_table(fs.of, (modes >> 4) & 3, d.of, src, n, 8, 31, "offsets");
  src += t;
  n -= t;
  t = read_table(fs.ml, (modes >> 2) & 3, d.ml, src, n, 9, 52, "match lengths");
  src += t;
  n -= t;

  BackBits br;
  br.init(src, n, "sequences");
  uint32_t sll = uint32_t(br.read(fs.ll.log)), sof = uint32_t(br.read(fs.of.log)),
           sml = uint32_t(br.read(fs.ml.log));
  uint32_t* rep = fs.rep;
  for (size_t i = 0; i < nseq; ++i) {
    const FSEEntry& ell = fs.ll.e[sll];
    const FSEEntry& eof = fs.of.e[sof];
    const FSEEntry& eml = fs.ml.e[sml];
    const int ofc = eof.symbol;
    if (ofc > 31) fail("sequences: offset code above 31");
    uint32_t ofv = (1u << ofc) + uint32_t(br.read(ofc));
    size_t ml = ML_BASE[eml.symbol] + br.read(ML_BITS[eml.symbol]);
    size_t ll = LL_BASE[ell.symbol] + br.read(LL_BITS[ell.symbol]);
    uint32_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      uint32_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll = ell.baseline + uint32_t(br.read(ell.nb_bits));
      sml = eml.baseline + uint32_t(br.read(eml.nb_bits));
      sof = eof.baseline + uint32_t(br.read(eof.nb_bits));
    }
    if (ll > lit_left) fail("sequences: literal length past the literals");
    out.need(ll + ml);
    uint8_t* o = out.base + out.pos;
    std::memcpy(o, lits, ll);
    lits += ll;
    lit_left -= ll;
    o += ll;
    out.pos += ll;
    if (offset == 0 || offset > out.pos - out.frame_start)
      fail("sequences: match offset before the start of the frame");
    const uint8_t* m = o - offset;
    if (offset >= ml) {
      std::memcpy(o, m, ml);
    } else {
      for (size_t k = 0; k < ml; ++k) o[k] = m[k];
    }
    out.pos += ml;
  }
  if (br.pos != 0) fail("sequences: bitstream not consumed exactly");
  out.need(lit_left);
  std::memcpy(out.base + out.pos, lits, lit_left);
  out.pos += lit_left;
}

struct FrameHeader {
  size_t header_bytes;
  bool has_size, checksum, single_segment;
  uint64_t content_size, window;
};

FrameHeader read_frame_header(const uint8_t* p, size_t n) {
  FrameHeader h{};
  if (n < 5) fail("frame header: truncated");
  const uint8_t fhd = p[4];
  const int fcs_flag = fhd >> 6, dict_flag = fhd & 3;
  h.single_segment = (fhd >> 5) & 1;
  h.checksum = (fhd >> 2) & 1;
  if (fhd & 8) fail("frame header: reserved bit set");
  size_t at = 5;
  if (!h.single_segment) {
    if (n < at + 1) fail("frame header: truncated");
    const uint8_t wd = p[at++];
    const uint64_t base = 1ULL << (10 + (wd >> 3));
    h.window = base + (base / 8) * (wd & 7);
  }
  static const int dict_bytes[4] = {0, 1, 2, 4};
  const int db = dict_bytes[dict_flag];
  if (n < at + db) fail("frame header: truncated");
  uint32_t dict_id = 0;
  for (int i = 0; i < db; ++i) dict_id |= uint32_t(p[at + i]) << (8 * i);
  if (dict_id != 0) fail("frame needs a dictionary (id " + std::to_string(dict_id) +
                         "): dictionaries are not supported");
  at += db;
  static const int fcs_bytes[4] = {0, 2, 4, 8};
  const int fb = (fcs_flag == 0 && h.single_segment) ? 1 : fcs_bytes[fcs_flag];
  if (n < at + fb) fail("frame header: truncated");
  h.has_size = fb > 0;
  if (fb == 1) h.content_size = p[at];
  if (fb == 2) h.content_size = rd16(p + at) + 256;
  if (fb == 4) h.content_size = rd32(p + at);
  if (fb == 8) h.content_size = rd64(p + at);
  at += fb;
  if (h.single_segment) h.window = h.content_size;
  h.header_bytes = at;
  return h;
}

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }
constexpr uint32_t MAGIC = 0xFD2FB528u;

// Decodes the frames of src[0, n) into out.
void decompress(const uint8_t* src, size_t n, Out& out) {
  std::vector<uint8_t> litbuf;
  litbuf.reserve(1 << 17);
  size_t at = 0;
  if (n == 0) fail("no frame: the input is empty");
  while (at < n) {
    if (n - at < 4) fail("trailing bytes after the last frame");
    const uint32_t magic = rd32(src + at);
    if (skippable(magic)) {
      if (n - at < 8) fail("skippable frame: truncated");
      const uint64_t len = rd32(src + at + 4);
      if (len > n - at - 8) fail("skippable frame: truncated");
      at += 8 + len;
      continue;
    }
    if (magic != MAGIC) fail("not a zstd frame (bad magic number)");
    FrameHeader h = read_frame_header(src + at, n - at);
    at += h.header_bytes;
    FrameState fs;
    out.frame_start = out.pos;
    for (bool last = false; !last;) {
      if (n - at < 3) fail("block header: truncated");
      const uint32_t bh = rd24(src + at);
      at += 3;
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (size > (1u << 17)) fail("block larger than 128 KiB");
      if (type == 0) {
        if (size > n - at) fail("raw block: truncated");
        out.need(size);
        std::memcpy(out.base + out.pos, src + at, size);
        out.pos += size;
        at += size;
      } else if (type == 1) {
        if (n - at < 1) fail("RLE block: truncated");
        out.need(size);
        std::memset(out.base + out.pos, src[at], size);
        out.pos += size;
        at += 1;
      } else if (type == 2) {
        if (size > n - at) fail("compressed block: truncated");
        decode_compressed_block(fs, src + at, size, out, litbuf);
        at += size;
      } else {
        fail("block of the reserved type");
      }
    }
    const size_t got = out.pos - out.frame_start;
    if (h.has_size && got != h.content_size)
      fail("frame decoded to " + std::to_string(got) + " bytes, its header says " +
           std::to_string(h.content_size));
    if (h.checksum) {
      if (n - at < 4) fail("content checksum: truncated");
      const uint32_t want = rd32(src + at);
      at += 4;
      if (uint32_t(xxh64(out.base + out.frame_start, got)) != want)
        fail("content checksum mismatch");
    }
  }
}

int64_t content_size(const uint8_t* src, size_t n) {
  size_t at = 0;
  uint64_t total = 0;
  if (n == 0) fail("no frame: the input is empty");
  while (at < n) {
    if (n - at < 4) fail("trailing bytes after the last frame");
    const uint32_t magic = rd32(src + at);
    if (skippable(magic)) {
      if (n - at < 8) fail("skippable frame: truncated");
      at += 8 + uint64_t(rd32(src + at + 4));
      continue;
    }
    if (magic != MAGIC) fail("not a zstd frame (bad magic number)");
    FrameHeader h = read_frame_header(src + at, n - at);
    if (!h.has_size) return -2;
    total += h.content_size;
    at += h.header_bytes;
    for (bool last = false; !last;) {
      if (n - at < 3) fail("block header: truncated");
      const uint32_t bh = rd24(src + at);
      at += 3;
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      at += type == 1 ? 1 : (bh >> 3);
      if (at > n) fail("block: truncated");
    }
    if (h.checksum) at += 4;
  }
  if (at != n) fail("frame: truncated");
  return int64_t(total);
}

void set_error(char* err, size_t errlen, const char* msg) {
  if (err && errlen) std::snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

int64_t hbpe_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                             char* err, size_t errlen) {
  try {
    Out out{dst, cap, 0, 0};
    decompress(src, n, out);
    return int64_t(out.pos);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

int64_t hbpe_zstd_decompress_alloc(const uint8_t* src, size_t n, uint8_t** dst,
                                   char* err, size_t errlen) {
  try {
    std::vector<uint8_t> buf(std::max<size_t>(n, 1024));
    Out out{buf.data(), buf.size(), 0, 0, &buf};
    decompress(src, n, out);
    *dst = static_cast<uint8_t*>(std::malloc(std::max<size_t>(out.pos, 1)));
    if (!*dst) fail("out of memory");
    std::memcpy(*dst, out.base, out.pos);
    return int64_t(out.pos);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

void hbpe_zstd_free(uint8_t* p) { std::free(p); }

int64_t hbpe_zstd_content_size(const uint8_t* src, size_t n, char* err,
                               size_t errlen) {
  try {
    return content_size(src, n);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
