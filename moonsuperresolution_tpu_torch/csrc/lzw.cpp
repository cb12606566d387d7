// TIFF-variant LZW codec for the port's GeoTIFF I/O (geo/lzw.py).
//
// Host code: the port's own copy of the JAX package's native/lzw.cpp, built
// with g++ at first use by build.py (build_host) into _build/liblzw.so.  The
// reference delegates raster compression to GDAL/libtiff
// (process_full_tiles.py:701, COMPRESS=LZW); there is no GDAL here.  TIFF
// LZW: MSB-first bit order, 9->12 bit codes with the early-change
// convention, ClearCode 256, EOI 257.
//
// Exposed via a tiny C ABI for ctypes:
//   lzw_decode(src, src_len, dst, dst_cap) -> bytes written, or -1 on error
//   lzw_encode(src, src_len, dst, dst_cap) -> bytes written, or -1 on error

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kMaxCode = 4096;

struct BitReader {
  const uint8_t* data;
  int64_t len;
  int64_t bitpos = 0;
  int get(int nbits) {
    if ((bitpos + nbits + 7) / 8 > len) return -1;
    int64_t byte = bitpos >> 3;
    uint32_t chunk = 0;
    for (int i = 0; i < 4; ++i)
      chunk = (chunk << 8) | (byte + i < len ? data[byte + i] : 0);
    int shift = 32 - nbits - static_cast<int>(bitpos & 7);
    bitpos += nbits;
    return static_cast<int>((chunk >> shift) & ((1u << nbits) - 1));
  }
};

struct BitWriter {
  uint8_t* dst;
  int64_t cap;
  int64_t bytepos = 0;
  uint64_t acc = 0;
  int accbits = 0;
  bool ok = true;
  void put(int code, int nbits) {
    acc = (acc << nbits) | static_cast<uint64_t>(code);
    accbits += nbits;
    while (accbits >= 8) {
      accbits -= 8;
      if (bytepos >= cap) { ok = false; return; }
      dst[bytepos++] = static_cast<uint8_t>((acc >> accbits) & 0xFF);
    }
  }
  void flush() {
    if (accbits) {
      if (bytepos >= cap) { ok = false; return; }
      dst[bytepos++] = static_cast<uint8_t>((acc << (8 - accbits)) & 0xFF);
      accbits = 0;
    }
  }
};

}  // namespace

extern "C" int64_t lzw_decode(const char* src, int64_t src_len, char* dst,
                              int64_t dst_cap) {
  // Decode table: per code store (prefix code, first byte, suffix byte, len).
  std::vector<int> prefix(kMaxCode, -1);
  std::vector<uint8_t> suffix(kMaxCode, 0);
  std::vector<uint8_t> first(kMaxCode, 0);
  std::vector<int> length(kMaxCode, 0);

  auto reset = [&]() {
    for (int i = 0; i < 256; ++i) {
      prefix[i] = -1;
      suffix[i] = static_cast<uint8_t>(i);
      first[i] = static_cast<uint8_t>(i);
      length[i] = 1;
    }
  };
  reset();

  BitReader br{reinterpret_cast<const uint8_t*>(src), src_len};
  uint8_t* out = reinterpret_cast<uint8_t*>(dst);
  int64_t written = 0;
  int next_code = 258;
  int nbits = 9;
  int prev = -1;

  auto emit = [&](int code) -> bool {
    int n = length[code];
    if (written + n > dst_cap) return false;
    int64_t pos = written + n;
    int c = code;
    while (c >= 0) {
      out[--pos] = suffix[c];
      c = prefix[c];
    }
    written += n;
    return true;
  };

  while (true) {
    int code = br.get(nbits);
    if (code < 0 || code == kEoi) break;
    if (code == kClear) {
      reset();
      next_code = 258;
      nbits = 9;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code >= 256) return -1;
      if (!emit(code)) break;
      prev = code;
      continue;
    }
    int entry;
    if (code < next_code) {
      entry = code;
    } else if (code == next_code) {
      entry = -1;  // KwKwK case
    } else {
      return -1;
    }
    if (next_code < kMaxCode) {
      prefix[next_code] = prev;
      suffix[next_code] = (entry >= 0) ? first[entry] : first[prev];
      first[next_code] = first[prev];
      length[next_code] = length[prev] + 1;
      if (entry < 0) entry = next_code;
      ++next_code;
    } else if (entry < 0) {
      return -1;
    }
    if (!emit(entry)) break;
    prev = entry;
    if (next_code + 1 >= (1 << nbits) && nbits < 12) ++nbits;
    if (written >= dst_cap) break;
  }
  return written;
}

extern "C" int64_t lzw_encode(const char* src, int64_t src_len, char* dst,
                              int64_t dst_cap) {
  // Hash-table string table: key = (prefix code << 8) | next byte.
  constexpr int kHashBits = 15;
  constexpr int kHashSize = 1 << kHashBits;
  std::vector<int32_t> hash_key(kHashSize);
  std::vector<int16_t> hash_code(kHashSize);

  auto clear_table = [&]() {
    std::memset(hash_key.data(), 0xFF, kHashSize * sizeof(int32_t));
  };

  BitWriter bw{reinterpret_cast<uint8_t*>(dst), dst_cap};
  clear_table();
  int next_code = 258;
  int nbits = 9;
  bw.put(kClear, nbits);

  const uint8_t* in = reinterpret_cast<const uint8_t*>(src);
  if (src_len == 0) {
    bw.put(kEoi, nbits);
    bw.flush();
    return bw.ok ? bw.bytepos : -1;
  }

  int w = in[0];
  for (int64_t i = 1; i < src_len; ++i) {
    int c = in[i];
    int32_t key = (w << 8) | c;
    uint32_t h = (static_cast<uint32_t>(key) * 2654435761u) >> (32 - kHashBits);
    int code = -1;
    while (hash_key[h] != -1) {
      if (hash_key[h] == key) { code = hash_code[h]; break; }
      h = (h + 1) & (kHashSize - 1);
    }
    if (code >= 0) {
      w = code;
      continue;
    }
    bw.put(w, nbits);
    if (!bw.ok) return -1;
    hash_key[h] = key;
    hash_code[h] = static_cast<int16_t>(next_code);
    ++next_code;
    if (next_code + 1 > (1 << nbits)) {
      if (nbits < 12) {
        ++nbits;
      } else {
        bw.put(kClear, nbits);
        clear_table();
        next_code = 258;
        nbits = 9;
      }
    }
    w = c;
  }
  bw.put(w, nbits);
  bw.put(kEoi, nbits);
  bw.flush();
  return bw.ok ? bw.bytepos : -1;
}
