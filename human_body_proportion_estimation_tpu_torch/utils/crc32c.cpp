// CRC32C (Castagnoli, reflected polynomial 0x82F63B78), the checksum of
// Orbax's OCDBT files (models/orbax_store.py) and of TensorFlow's
// TensorBundle blocks and tensors (models/tf_bundle.py). Built with g++ at
// first use (utils/crc32c.py) and called through ctypes.
//
//   hbpe_crc32c_extend(crc, p, n)
//       the CRC32C of the bytes whose CRC32C is `crc`, followed by
//       p[0, n); crc = 0 starts a new one.
//
// Where the compiler targets SSE4.2 (__SSE4_2__ defined at build time) the
// loop is the CPU's crc32 instruction, 8 bytes at a time; otherwise it is
// slicing-by-8 over eight 256-entry tables. Which one is fixed when the
// library is built: there is no switch at run time.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

#if defined(__SSE4_2__)

uint32_t update(uint32_t c, const uint8_t* p, size_t n) {
  uint64_t c64 = c;
  for (; n >= 8; p += 8, n -= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    c64 = _mm_crc32_u64(c64, w);
  }
  c = uint32_t(c64);
  for (; n; ++p, --n) c = _mm_crc32_u8(c, *p);
  return c;
}

#else

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Tables kTables;

uint32_t update(uint32_t c, const uint8_t* p, size_t n) {
  const auto& t = kTables.t;
  for (; n >= 8; p += 8, n -= 8) {
    uint32_t lo, hi;  // little-endian words, as the tables assume
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
        t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
  for (; n; ++p, --n) c = t[0][(c ^ *p) & 0xFF] ^ (c >> 8);
  return c;
}

#endif

}  // namespace

extern "C" {

uint32_t hbpe_crc32c_extend(uint32_t crc, const uint8_t* p, size_t n) {
  return ~update(~crc, p, n);
}

}  // extern "C"
