// Zstandard (RFC 8878) decoder and a Raw-block frame writer, for the
// orbax checkpoint reader (train/orbax.py): every OCDBT node, manifest
// and zarr chunk of an orbax checkpoint is a zstd frame. Built with g++
// into build/ at first use and called through ctypes (storage/zstd.py).
//
// Decodes: frames with or without a content size and with or without a
// checksum (XXH64, verified), skippable frames, several frames back to
// back, Raw / RLE / Compressed blocks, Raw / RLE / Huffman (1 or 4
// streams) / treeless literals, predefined / RLE / FSE / repeat sequence
// tables, the three repeat offsets. Refuses frames that name a
// dictionary. Every read and write is bounds-checked; corrupt input
// returns an error, never reads or writes outside the buffers. Where a
// corrupt Huffman table or stream leaves libzstd 1.5.7 a choice, this
// decoder makes libzstd's: the checks of HUF_readStats, and its fast
// 4-stream loop, which reads a stream on into the bytes before it and
// does not check where the stream's bits end (huf4_fast).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <vector>

namespace {

struct Error {
  int code;  // -1 corrupt, -2 output too small, -3 unsupported
  const char* msg;
};

[[noreturn]] void corrupt(const char* msg) { throw Error{-1, msg}; }

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint64_t kBlockMax = 128 * 1024;

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) { return rd16(p) | (rd16(p + 2) << 16); }
inline uint64_t rd64(const uint8_t* p) {
  return rd32(p) | (uint64_t(rd32(p + 4)) << 32);
}
inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }  // v > 0

// ---- XXH64 ----------------------------------------------------------------
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, uint64_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1); h = xmerge(h, v2); h = xmerge(h, v3); h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

// ---- bit readers ----------------------------------------------------------
// Forward, little-endian bit order: FSE table descriptions.
struct FwdBits {
  const uint8_t* p;
  uint64_t nbits, pos = 0;
  FwdBits(const uint8_t* src, uint64_t n) : p(src), nbits(n * 8) {}
  uint32_t read(int n) {
    if (pos + n > nbits) corrupt("FSE table description runs past its block");
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++pos)
      v |= uint32_t((p[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  }
  uint64_t bytes() const { return (pos + 7) >> 3; }
};

// Backward: Huffman and FSE streams are read from the end. `pos` is the
// number of bits not yet read; reads past the start give zero bits and
// drive `pos` negative, which the callers check (RFC 8878 4.1).
struct BackBits {
  const uint8_t* p;
  int64_t len;
  int64_t pos;
  BackBits(const uint8_t* src, uint64_t n) : p(src), len(int64_t(n)) {
    if (n == 0) corrupt("empty bitstream");
    uint8_t last = src[n - 1];
    if (last == 0) corrupt("bitstream without its end mark");
    pos = int64_t(n) * 8 - (8 - highbit(last));
  }
  uint64_t load(int64_t byte) const {
    if (byte + 8 <= len) return rd64(p + byte);
    uint64_t w = 0;
    for (int64_t i = byte; i < len; ++i) w |= uint64_t(p[i]) << (8 * (i - byte));
    return w;
  }
  uint64_t read(int n) {  // n <= 56
    if (n == 0) return 0;
    pos -= n;
    if (pos >= 0) return (load(pos >> 3) >> (pos & 7)) & ((1ULL << n) - 1);
    int64_t avail = n + pos;
    if (avail <= 0) return 0;
    return (load(0) & ((1ULL << avail) - 1)) << (-pos);
  }
};

// ---- FSE ------------------------------------------------------------------
struct FSETable {
  int log = 0;
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> base;
};

void fse_build(FSETable& t, const int16_t* norm, int nsym, int log) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  uint16_t next[256];
  uint32_t high = size;
  for (int s = 0; s < nsym; ++s)
    if (norm[s] == -1) {
      t.sym[--high] = uint8_t(s);
      next[s] = 1;
    }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.sym[pos] = uint8_t(s);
      do pos = (pos + step) & mask; while (pos >= high);
    }
  }
  if (pos != 0) corrupt("FSE distribution does not fill its table");
  for (uint32_t i = 0; i < size; ++i) {
    uint16_t d = next[t.sym[i]]++;
    int nb = log - highbit(d);
    t.nbits[i] = uint8_t(nb);
    t.base[i] = uint16_t((uint32_t(d) << nb) - size);
  }
}

// Reads an FSE table description (RFC 8878 4.1.1); returns bytes used.
uint64_t fse_read(FSETable& t, const uint8_t* src, uint64_t n, int max_log,
                  int max_sym) {
  FwdBits br(src, n);
  int log = int(br.read(4)) + 5;
  if (log > max_log) corrupt("FSE accuracy log too large");
  int32_t remaining = 1 << log;
  int16_t norm[256];
  int s = 0;
  while (remaining > 0) {
    if (s > max_sym) corrupt("FSE table has too many symbols");
    int bits = highbit(uint64_t(remaining) + 1) + 1;
    uint32_t v = br.read(bits);
    uint32_t low = (1u << (bits - 1)) - 1;
    uint32_t thresh = (1u << bits) - 1 - (uint32_t(remaining) + 1);
    if ((v & low) < thresh) {
      br.pos -= 1;
      v &= low;
    } else if (v > low) {
      v -= thresh;
    }
    int proba = int(v) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[s++] = int16_t(proba);
    if (proba == 0) {
      int rep = int(br.read(2));
      for (;;) {
        for (int i = 0; i < rep; ++i) {
          if (s > max_sym) corrupt("FSE table has too many symbols");
          norm[s++] = 0;
        }
        if (rep != 3) break;
        rep = int(br.read(2));
      }
    }
  }
  if (remaining != 0) corrupt("FSE probabilities exceed the table");
  fse_build(t, norm, s, log);
  return br.bytes();
}

void fse_rle(FSETable& t, uint8_t symbol) {
  t.log = 0;
  t.sym.assign(1, symbol);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
}

// ---- Huffman --------------------------------------------------------------
struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> sym, nbits;
  // libzstd's double-symbol table (HUF_readDTableX2), when its decoder
  // chose it: each `log`-bit index gives one symbol, or two whose codes
  // both fit (HUF_DEltX2: sequence, bits, length)
  bool x2 = false;
  int log = 0;
  std::vector<uint8_t> s1, s2, bits2, len2;
};

// Huffman tree description (RFC 8878 4.2.1); returns bytes used.
uint64_t huf_read(HufTable& h, const uint8_t* src, uint64_t n) {
  if (n < 1) corrupt("missing Huffman tree description");
  uint8_t w[256];
  int nw = 0;
  uint32_t hb = src[0];
  uint64_t used;
  if (hb >= 128) {
    nw = int(hb) - 127;
    used = 1 + (uint64_t(nw) + 1) / 2;
    if (used > n) corrupt("Huffman weights run past the literals");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {
    used = 1 + uint64_t(hb);
    if (hb == 0 || used > n) corrupt("bad Huffman weight stream size");
    FSETable t;
    uint64_t hdr = fse_read(t, src + 1, hb, 6, 255);
    if (hdr >= hb) corrupt("Huffman weight stream is empty");
    BackBits br(src + 1 + hdr, hb - hdr);
    uint32_t s1 = uint32_t(br.read(t.log)), s2 = uint32_t(br.read(t.log));
    for (;;) {
      if (nw > 253) corrupt("too many Huffman weights");
      w[nw++] = t.sym[s1];
      s1 = t.base[s1] + uint32_t(br.read(t.nbits[s1]));
      if (br.pos < 0) { w[nw++] = t.sym[s2]; break; }
      if (nw > 253) corrupt("too many Huffman weights");
      w[nw++] = t.sym[s2];
      s2 = t.base[s2] + uint32_t(br.read(t.nbits[s2]));
      if (br.pos < 0) { w[nw++] = t.sym[s1]; break; }
    }
  }
  if (nw > 255) corrupt("too many Huffman weights");
  // HUF_readStats: weights and codes up to 12 (HUF_TABLELOG_MAX), and an
  // even count, at least 2, of the longest codes
  uint64_t sum = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 12) corrupt("Huffman weight above 12");
    if (w[i]) sum += 1ULL << (w[i] - 1);
  }
  if (sum == 0) corrupt("Huffman weights are all zero");
  int max_bits = highbit(sum) + 1;
  if (max_bits > 12) corrupt("Huffman code longer than 12 bits");
  uint64_t left = (1ULL << max_bits) - sum;
  if (left & (left - 1)) corrupt("Huffman weights do not sum to a power of two");
  w[nw++] = uint8_t(highbit(left) + 1);
  int longest = 0;
  for (int i = 0; i < nw; ++i) longest += w[i] == 1;
  if (longest < 2 || (longest & 1)) corrupt("Huffman tree has an odd leaf");
  uint8_t bits[256];
  uint32_t count[14] = {0};
  for (int i = 0; i < nw; ++i) {
    bits[i] = w[i] ? uint8_t(max_bits + 1 - w[i]) : 0;
    count[bits[i]]++;
  }
  const uint32_t size = 1u << max_bits;
  h.max_bits = max_bits;
  h.x2 = false;
  h.sym.assign(size, 0);
  h.nbits.assign(size, 0);
  uint32_t start[14];
  start[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    start[b - 1] = start[b] + count[b] * (1u << (max_bits - b));
    if (start[b - 1] > size) corrupt("Huffman code overflows its table");
    memset(&h.nbits[start[b]], b, start[b - 1] - start[b]);
  }
  if (start[0] != size) corrupt("Huffman code does not fill its table");
  for (int i = 0; i < nw; ++i) {
    if (!bits[i]) continue;
    uint32_t len = 1u << (max_bits - bits[i]);
    memset(&h.sym[start[bits[i]]], i, len);
    start[bits[i]] += len;
  }
  return used;
}

void huf_stream(const HufTable& h, const uint8_t* src, uint64_t n,
                uint8_t* out, uint64_t count) {
  BackBits br(src, n);
  const uint32_t mask = (1u << h.max_bits) - 1;
  uint32_t state = uint32_t(br.read(h.max_bits));
  for (uint64_t i = 0; i < count; ++i) {
    out[i] = h.sym[state];
    int nb = h.nbits[state];
    state = ((state << nb) + uint32_t(br.read(nb))) & mask;
  }
  if (br.pos != -int64_t(h.max_bits))
    corrupt("Huffman stream size does not match its literals");
}

// libzstd's BIT_DStream_t over [start, ...): a 64-bit container read from
// `ptr`, `used` bits of it consumed from the top. Past `start` the
// container is not reloaded and a look wraps round it (BIT_lookBitsFast).
struct ZBits {
  const uint8_t* start;
  const uint8_t* ptr;
  uint64_t c;
  uint32_t used;
  enum { kUnfinished, kEndOfBuffer, kCompleted, kOverflow };
  int reload() {  // BIT_reloadDStream
    if (used > 64) return kOverflow;
    if (ptr >= start + 8) {
      ptr -= used >> 3;
      used &= 7;
      c = rd64(ptr);
      return kUnfinished;
    }
    if (ptr == start) return used < 64 ? kEndOfBuffer : kCompleted;
    uint32_t n = used >> 3;
    int r = kUnfinished;
    if (n > uint32_t(ptr - start)) {
      n = uint32_t(ptr - start);
      r = kEndOfBuffer;
    }
    ptr -= n;
    used -= n * 8;
    c = rd64(ptr);
    return r;
  }
  uint8_t symbol(const HufTable& h) {  // HUF_decodeSymbolX1 at dtLog 11
    uint32_t v = uint32_t((c << (used & 63)) >> 53) >> (11 - h.max_bits);
    used += h.nbits[v];
    return h.sym[v];
  }
};

// HUF_decodeStreamX1: fills [p, end) whatever the stream holds.
void zstream_x1(ZBits& b, const HufTable& h, uint8_t* p, uint8_t* end) {
  if (end - p > 3) {
    while ((b.reload() == ZBits::kUnfinished) & (p < end - 3))
      for (int i = 0; i < 4; ++i) *p++ = b.symbol(h);
  } else {
    b.reload();
  }
  while (p < end) *p++ = b.symbol(h);
}

// HUF_initFastDStream: the container at ip with a 1 below its last bit; a
// zero last byte is taken as it is.
uint64_t fast_bits(const uint8_t* ip) {
  uint8_t last = ip[7];
  int used = last ? 8 - highbit(last) : 0;
  return (rd64(ip) | 1) << used;
}

// libzstd's 4-stream single-symbol decoder when its fast loop applies
// (HUF_decompress4X1_usingDTable_internal_fast and its C loop): each
// stream at least 8 bytes, codes of at most 11 bits, a fourth segment that
// is not empty. Returns false where libzstd falls back to the checked
// decoder. The fast loop decodes 5 symbols a stream between reloads while
// the input and output bounds allow; each stream is then finished with
// HUF_decodeStreamX1 over everything from the jump table on, and fails
// only if its reads went more than 8 bytes past the stream's start.
bool huf4_fast(const HufTable& h, const uint8_t* src, uint64_t n,
               uint8_t* out, uint64_t dst) {
  if (h.max_bits > 11 || dst == 0) return false;
  if (n < 10) corrupt("4-stream literals too short");
  uint64_t l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  uint64_t l4 = n - (l1 + l2 + l3 + 6);  // wraps as libzstd's size_t does
  if (l1 < 8 || l2 < 8 || l3 < 8 || l4 < 8) return false;
  if (l4 > n) corrupt("bad literals jump table");
  const int64_t iend[4] = {6, int64_t(6 + l1), int64_t(6 + l1 + l2),
                           int64_t(6 + l1 + l2 + l3)};
  int64_t ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8, int64_t(n) - 8};
  const uint64_t seg = (dst + 3) / 4;
  uint64_t op[4] = {0, seg, 2 * seg, 3 * seg};
  if (op[3] >= dst) return false;
  uint64_t bits[4];
  for (int s = 0; s < 4; ++s) bits[s] = fast_bits(src + ip[s]);
  for (;;) {
    uint64_t oiters = (dst - op[3]) / 5, iiters = uint64_t(ip[0]) / 7;
    uint64_t olimit = op[3] + 5 * (oiters < iiters ? oiters : iiters);
    if (op[3] == olimit) break;
    if (ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
    do {
      for (int k = 0; k < 5; ++k)
        for (int s = 0; s < 4; ++s) {
          uint32_t v = uint32_t(bits[s] >> 53) >> (11 - h.max_bits);
          bits[s] <<= h.nbits[v];
          out[op[s] + k] = h.sym[v];
        }
      for (int s = 0; s < 4; ++s) {
        int ctz = __builtin_ctzll(bits[s]);
        op[s] += 5;
        ip[s] -= ctz >> 3;
        bits[s] = (rd64(src + ip[s]) | 1) << (ctz & 7);
      }
    } while (op[3] < olimit);
  }
  uint64_t seg_end = 0;
  for (int s = 0; s < 4; ++s) {
    seg_end = seg <= dst - seg_end ? seg_end + seg : dst;
    if (op[s] > seg_end || ip[s] < iend[s] - 8)
      corrupt("Huffman stream read past its start");
    ZBits b{src, src + ip[s], rd64(src + ip[s]),
            uint32_t(__builtin_ctzll(bits[s]))};
    zstream_x1(b, h, out + op[s], out + seg_end);
  }
  return true;
}

// HUF_selectDecoder: libzstd's choice of its double-symbol decoder for 4
// streams of `dst` literals coded in `src` bytes (its timing table).
bool huf_select_x2(uint64_t dst, uint64_t src) {
  static const uint16_t t[16][4] = {
      {0, 0, 1, 1}, {0, 0, 1, 1}, {150, 216, 381, 119}, {170, 205, 514, 112},
      {177, 199, 539, 110}, {197, 194, 644, 107}, {221, 192, 735, 107},
      {256, 189, 881, 106}, {359, 188, 1167, 109}, {582, 187, 1570, 114},
      {688, 187, 1712, 122}, {825, 186, 1965, 136}, {976, 185, 2131, 150},
      {1180, 186, 2070, 175}, {1377, 185, 1731, 202}, {1412, 185, 1695, 202}};
  const uint32_t q = src >= dst ? 15 : uint32_t(src * 16 / dst);
  const uint32_t d256 = uint32_t(dst >> 8);
  const uint32_t t0 = t[q][0] + t[q][1] * d256;
  uint32_t t1 = t[q][2] + t[q][3] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// HUF_readDTableX2 over the single-symbol code: at each index of `log`
// bits (11, or 12 for a 12-bit code) the first symbol, and the second
// where some code is short enough to fit the bits left and its own does.
void huf_build_x2(HufTable& h) {
  const int log = h.max_bits <= 11 ? 11 : 12, size = 1 << log;
  int shortest = h.max_bits;
  for (uint32_t i = 0; i < h.nbits.size(); ++i)
    if (h.nbits[i] && h.nbits[i] < shortest) shortest = h.nbits[i];
  h.x2 = true;
  h.log = log;
  h.s1.assign(size, 0); h.s2.assign(size, 0);
  h.bits2.assign(size, 0); h.len2.assign(size, 1);
  const int shift = log - h.max_bits;
  for (int i = 0; i < size; ++i) {
    const uint32_t a = uint32_t(i) >> shift;
    const int n1 = h.nbits[a], left = log - n1;
    h.s1[i] = h.sym[a];
    h.bits2[i] = uint8_t(n1);
    if (left < shortest) continue;
    const uint32_t b = (uint32_t(i << n1) & uint32_t(size - 1)) >> shift;
    if (h.nbits[b] <= left) {
      h.s2[i] = h.sym[b];
      h.bits2[i] = uint8_t(n1 + h.nbits[b]);
      h.len2[i] = 2;
    }
  }
}

// BIT_initDStream: a stream of n >= 1 bytes ending in its end mark.
ZBits zbits_init(const uint8_t* src, uint64_t n) {
  if (n == 0) corrupt("empty bitstream");
  const uint8_t last = src[n - 1];
  if (last == 0) corrupt("bitstream without its end mark");
  ZBits b{src, src, 0, uint32_t(8 - highbit(last))};
  if (n >= 8) {
    b.ptr = src + n - 8;
    b.c = rd64(b.ptr);
  } else {
    for (uint64_t i = 0; i < n; ++i) b.c |= uint64_t(src[i]) << (8 * i);
    b.used += uint32_t(8 - n) * 8;
  }
  return b;
}

// HUF_decodeSymbolX2: one index's symbols at p (two bytes written);
// returns how many count.
inline int x2_symbol(ZBits& b, const HufTable& h, uint8_t* p) {
  const uint32_t v = uint32_t((b.c << (b.used & 63)) >> ((64 - h.log) & 63));
  p[0] = h.s1[v];
  p[1] = h.s2[v];
  b.used += h.bits2[v];
  return h.len2[v];
}

// HUF_decodeStreamX2: fills [p, end); its last index gives one symbol,
// and skips all its bits up to the stream's end.
void zstream_x2(ZBits& b, const HufTable& h, uint8_t* p, uint8_t* end) {
  if (end - p >= 8) {
    const int margin = h.log <= 11 ? 9 : 7, run = h.log <= 11 ? 5 : 4;
    while ((b.reload() == ZBits::kUnfinished) & (p < end - margin))
      for (int k = 0; k < run; ++k) p += x2_symbol(b, h, p);
  } else {
    b.reload();
  }
  if (end - p >= 2) {
    while ((b.reload() == ZBits::kUnfinished) & (p <= end - 2))
      p += x2_symbol(b, h, p);
    while (p <= end - 2) p += x2_symbol(b, h, p);
  }
  if (p < end) {  // HUF_decodeLastSymbolX2
    const uint32_t v =
        uint32_t((b.c << (b.used & 63)) >> ((64 - h.log) & 63));
    *p = h.s1[v];
    if (h.len2[v] == 1) {
      b.used += h.bits2[v];
    } else if (b.used < 64) {
      b.used += h.bits2[v];
      if (b.used > 64) b.used = 64;
    }
  }
}

bool zbits_end(const ZBits& b) { return b.ptr == b.start && b.used == 64; }

// One stream decoded with the double-symbol table
// (HUF_decompress1X2_usingDTable_internal).
void huf1_x2(const HufTable& h, const uint8_t* src, uint64_t n,
             uint8_t* out, uint64_t count) {
  ZBits b = zbits_init(src, n);
  std::vector<uint8_t> tmp(count + 2);
  zstream_x2(b, h, tmp.data(), tmp.data() + count);
  memcpy(out, tmp.data(), count);
  if (!zbits_end(b)) corrupt("Huffman stream size does not match its literals");
}

// libzstd's 4-stream double-symbol decoder: its fast loop where it
// applies (HUF_decompress4X2_usingDTable_internal_fast and its C loop:
// 5 lookups a stream between reloads, each writing two bytes and
// counting one or two), else the checked body.
void huf4_x2(const HufTable& h, const uint8_t* src, uint64_t n,
             uint8_t* out0, uint64_t dst) {
  std::vector<uint8_t> buf(dst + 2);  // a two-byte write may end at dst
  uint8_t* out = buf.data();
  if (n < 10) corrupt("4-stream literals too short");
  uint64_t l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  uint64_t l4 = n - (l1 + l2 + l3 + 6);
  const uint64_t seg = (dst + 3) / 4;
  const bool fast = h.log == 11 && l1 >= 8 && l2 >= 8 && l3 >= 8 && l4 >= 8;
  if (fast && l4 > n) corrupt("bad literals jump table");
  if (fast && 3 * seg < dst) {
    const int64_t iend[4] = {6, int64_t(6 + l1), int64_t(6 + l1 + l2),
                             int64_t(6 + l1 + l2 + l3)};
    int64_t ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8, int64_t(n) - 8};
    uint64_t op[4] = {0, seg, 2 * seg, 3 * seg};
    const uint64_t oend[4] = {seg, 2 * seg, 3 * seg, dst};
    uint64_t bits[4];
    for (int s = 0; s < 4; ++s) bits[s] = fast_bits(src + ip[s]);
    for (;;) {
      uint64_t iters = uint64_t(ip[0]) / 7;
      for (int s = 0; s < 4; ++s) {
        uint64_t o = (oend[s] - op[s]) / 10;
        if (o < iters) iters = o;
      }
      const uint64_t olimit = op[3] + 5 * iters;
      if (op[3] == olimit) break;
      if (ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
      do {
        for (int s = 0; s < 4; ++s) {
          for (int k = 0; k < 5; ++k) {
            const uint32_t v = uint32_t(bits[s] >> 53);
            out[op[s]] = h.s1[v];
            out[op[s] + 1] = h.s2[v];
            bits[s] <<= h.bits2[v];
            op[s] += h.len2[v];
          }
          const int ctz = __builtin_ctzll(bits[s]);
          ip[s] -= ctz >> 3;
          bits[s] = (rd64(src + ip[s]) | 1) << (ctz & 7);
        }
      } while (op[3] < olimit);
    }
    uint64_t seg_end = 0;
    for (int s = 0; s < 4; ++s) {
      seg_end = seg <= dst - seg_end ? seg_end + seg : dst;
      if (op[s] > seg_end || ip[s] < iend[s] - 8)
        corrupt("Huffman stream read past its start");
      ZBits b{src, src + ip[s], rd64(src + ip[s]),
              uint32_t(__builtin_ctzll(bits[s]))};
      zstream_x2(b, h, out + op[s], out + seg_end);
    }
    memcpy(out0, out, dst);
    return;
  }
  // HUF_decompress4X2_usingDTable_internal_body
  if (l4 > n || 3 * seg > dst) corrupt("bad literals jump table");
  const uint8_t* q = src + 6;
  ZBits b[4] = {zbits_init(q, l1), zbits_init(q + l1, l2),
                zbits_init(q + l1 + l2, l3),
                zbits_init(q + l1 + l2 + l3, l4)};
  uint64_t op[4] = {0, seg, 2 * seg, 3 * seg};
  const uint64_t oend[4] = {seg, 2 * seg, 3 * seg, dst};
  if (dst - op[3] >= 8) {
    bool go = true;
    while (go & (op[3] < dst - 7)) {
      for (int s = 0; s < 4; ++s)
        for (int k = 0; k < 4; ++k) op[s] += x2_symbol(b[s], h, out + op[s]);
      for (int s = 0; s < 4; ++s)  // BIT_reloadDStreamFast
        go &= b[s].ptr >= b[s].start + 8 && b[s].reload() ==
              ZBits::kUnfinished;
    }
  }
  for (int s = 0; s < 3; ++s)
    if (op[s] > oend[s]) corrupt("Huffman stream overran its segment");
  for (int s = 0; s < 4; ++s) zstream_x2(b[s], h, out + op[s], out + oend[s]);
  for (int s = 0; s < 4; ++s)
    if (!zbits_end(b[s]))
      corrupt("Huffman stream size does not match its literals");
  memcpy(out0, out, dst);
}

// ---- sequences ------------------------------------------------------------
const uint32_t kLLBase[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22, 24,
    28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
    65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
    32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Predefined {
  FSETable ll, ml, of;
  Predefined() {
    fse_build(ll, kLLNorm, 36, 6);
    fse_build(ml, kMLNorm, 53, 6);
    fse_build(of, kOFNorm, 29, 5);
  }
};
const Predefined& predefined() {
  static const Predefined p;
  return p;
}

// Per-frame state that blocks inherit: the last Huffman table, the last
// sequence tables (repeat mode) and the repeat offsets.
struct Frame {
  HufTable huf;
  bool have_huf = false;
  FSETable ll, of, ml;
  bool have_seq = false;  // "repeat" may not come before a table
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;
};

struct Out {
  uint8_t* p;
  uint64_t cap, pos;
  void need(uint64_t n) const {
    if (n > cap - pos) throw Error{-2, "output buffer too small"};
  }
};

// Literals section (RFC 8878 3.1.1.3.1); returns bytes used and points
// `lit` at the block's literals.
uint64_t literals(Frame& f, const uint8_t* b, uint64_t n, uint64_t block_max,
                  const uint8_t** lit, uint64_t* nlit) {
  if (n < 1) corrupt("missing literals section");
  const int type = b[0] & 3, fmt = (b[0] >> 2) & 3;
  if (type < 2) {  // raw or RLE
    uint64_t hdr, size;
    if (fmt == 0 || fmt == 2) { hdr = 1; size = b[0] >> 3; }
    else if (fmt == 1) {
      hdr = 2;
      if (n < 2) corrupt("literals header truncated");
      size = (b[0] >> 4) + (uint64_t(b[1]) << 4);
    } else {
      hdr = 3;
      if (n < 3) corrupt("literals header truncated");
      size = (b[0] >> 4) + (uint64_t(b[1]) << 4) + (uint64_t(b[2]) << 12);
    }
    if (size > block_max) corrupt("literals larger than a block");
    if (type == 0) {
      if (size > n - hdr) corrupt("raw literals run past their block");
      *lit = b + hdr;
      *nlit = size;
      return hdr + size;
    }
    if (n < hdr + 1) corrupt("RLE literals truncated");
    f.lits.assign(size, b[hdr]);
    *lit = f.lits.data();
    *nlit = size;
    return hdr + 1;
  }
  uint64_t hdr, regen, comp;
  int streams = fmt == 0 ? 1 : 4;
  if (fmt < 2) {
    hdr = 3;
    if (n < 3) corrupt("literals header truncated");
    uint32_t c = rd24(b);
    regen = (c >> 4) & 0x3FF;
    comp = (c >> 14) & 0x3FF;
  } else if (fmt == 2) {
    hdr = 4;
    if (n < 4) corrupt("literals header truncated");
    uint32_t c = rd32(b);
    regen = (c >> 4) & 0x3FFF;
    comp = (c >> 18) & 0x3FFF;
  } else {
    hdr = 5;
    if (n < 5) corrupt("literals header truncated");
    uint64_t c = rd32(b) | (uint64_t(b[4]) << 32);
    regen = (c >> 4) & 0x3FFFF;
    comp = (c >> 22) & 0x3FFFF;
  }
  if (regen > block_max) corrupt("literals larger than a block");
  if (comp > n - hdr) corrupt("compressed literals run past their block");
  const uint8_t* s = b + hdr;
  uint64_t sn = comp;
  // ZSTD_decodeLiteralsBlock: 4 streams carry at least 6 literals
  if (streams == 4 && regen < 6) corrupt("4-stream literals too few");
  if (type == 2) {
    uint64_t used = huf_read(f.huf, s, sn);
    f.have_huf = true;
    s += used;
    sn -= used;
    // one stream takes the single-symbol table, four what
    // HUF_selectDecoder picks; a treeless block reuses the table
    if (streams == 4 && regen && huf_select_x2(regen, comp))
      huf_build_x2(f.huf);
  } else if (!f.have_huf) {
    corrupt("treeless literals without an earlier Huffman table");
  }
  f.lits.resize(regen);
  uint8_t* out = f.lits.data();
  if (f.huf.x2) {
    if (streams == 1) huf1_x2(f.huf, s, sn, out, regen);
    else huf4_x2(f.huf, s, sn, out, regen);
  } else if (streams == 1) {
    huf_stream(f.huf, s, sn, out, regen);
  } else {
    if (huf4_fast(f.huf, s, sn, out, regen)) {
      *lit = out;
      *nlit = regen;
      return hdr + comp;
    }
    if (sn < 10) corrupt("4-stream literals too short");
    uint64_t sz[4] = {rd16(s), rd16(s + 2), rd16(s + 4), 0};
    uint64_t rest = sn - 6;
    if (sz[0] + sz[1] + sz[2] >= rest) corrupt("bad literals jump table");
    sz[3] = rest - sz[0] - sz[1] - sz[2];
    uint64_t seg = (regen + 3) / 4;
    if (3 * seg > regen) corrupt("4-stream literals too few");
    const uint8_t* q = s + 6;
    for (int i = 0; i < 4; ++i) {
      uint64_t cnt = i < 3 ? seg : regen - 3 * seg;
      huf_stream(f.huf, q, sz[i], out + i * seg, cnt);
      q += sz[i];
    }
  }
  *lit = out;
  *nlit = regen;
  return hdr + comp;
}

uint64_t seq_table(FSETable& t, const FSETable& def, int mode,
                   const uint8_t* b, uint64_t n, int max_log, int max_sym,
                   bool have) {
  switch (mode) {
    case 0: t = def; return 0;
    case 1:
      if (n < 1) corrupt("RLE sequence table truncated");
      if (b[0] > max_sym) corrupt("RLE sequence symbol out of range");
      fse_rle(t, b[0]);
      return 1;
    case 2: return fse_read(t, b, n, max_log, max_sym);
    default:
      if (!have) corrupt("repeat sequence table without an earlier table");
      return 0;
  }
}

void copy_match(uint8_t* o, uint64_t off, uint64_t len) {
  const uint8_t* s = o - off;
  if (off >= len) { memcpy(o, s, len); return; }
  if (off == 1) { memset(o, *s, len); return; }
  while (len) {  // chunks of `off` bytes never overlap their source
    uint64_t c = len < off ? len : off;
    memcpy(o, s, c);
    o += c; s += c; len -= c;
  }
}

void compressed_block(Frame& f, const uint8_t* b, uint64_t n,
                      uint64_t block_max, Out& out, uint64_t frame_start) {
  const uint8_t* lit;
  uint64_t nlit;
  uint64_t p = literals(f, b, n, block_max, &lit, &nlit);
  if (p >= n) corrupt("missing sequences section");
  uint64_t nseq = b[p++];
  if (nseq >= 128) {
    if (nseq < 255) {
      if (p >= n) corrupt("sequence count truncated");
      nseq = ((nseq - 128) << 8) + b[p++];
    } else {
      if (n - p < 2) corrupt("sequence count truncated");
      nseq = rd16(b + p) + 0x7F00;
      p += 2;
    }
  }
  uint64_t produced = 0;
  if (nseq > 0) {
    if (p >= n) corrupt("sequence modes truncated");
    uint8_t modes = b[p++];
    if (modes & 3) corrupt("reserved sequence mode bits set");
    const Predefined& d = predefined();
    p += seq_table(f.ll, d.ll, modes >> 6, b + p, n - p, 9, 35, f.have_seq);
    p += seq_table(f.of, d.of, (modes >> 4) & 3, b + p, n - p, 8, 31,
                   f.have_seq);
    p += seq_table(f.ml, d.ml, (modes >> 2) & 3, b + p, n - p, 9, 52,
                   f.have_seq);
    f.have_seq = true;
    if (p >= n) corrupt("missing sequence bitstream");
    BackBits br(b + p, n - p);
    uint32_t sl = uint32_t(br.read(f.ll.log)), so = uint32_t(br.read(f.of.log)),
             sm = uint32_t(br.read(f.ml.log));
    uint64_t lpos = 0;
    for (uint64_t i = 0; i < nseq; ++i) {
      int oc = f.of.sym[so], mc = f.ml.sym[sm], lc = f.ll.sym[sl];
      if (oc > 31) corrupt("offset code out of range");
      if (mc > 52 || lc > 35) corrupt("length code out of range");
      uint64_t ov = (1ULL << oc) + br.read(oc);
      uint64_t ml = kMLBase[mc] + br.read(kMLBits[mc]);
      uint64_t ll = kLLBase[lc] + br.read(kLLBits[lc]);
      uint64_t off;
      if (ov > 3) {
        off = ov - 3;
        f.rep[2] = f.rep[1]; f.rep[1] = f.rep[0]; f.rep[0] = off;
      } else {
        uint64_t idx = ov - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          off = f.rep[0];
        } else {
          off = idx < 3 ? f.rep[idx] : f.rep[0] - 1;
          if (idx > 1) f.rep[2] = f.rep[1];
          f.rep[1] = f.rep[0];
          f.rep[0] = off;
        }
      }
      if (i + 1 < nseq) {
        sl = f.ll.base[sl] + uint32_t(br.read(f.ll.nbits[sl]));
        sm = f.ml.base[sm] + uint32_t(br.read(f.ml.nbits[sm]));
        so = f.of.base[so] + uint32_t(br.read(f.of.nbits[so]));
      }
      if (ll > nlit - lpos) corrupt("sequence takes more literals than decoded");
      if (ll + ml > block_max - produced) corrupt("block larger than its maximum");
      out.need(ll + ml);
      memcpy(out.p + out.pos, lit + lpos, ll);
      out.pos += ll;
      lpos += ll;
      if (off == 0 || off > out.pos - frame_start)
        corrupt("match offset before the frame's start");
      copy_match(out.p + out.pos, off, ml);
      out.pos += ml;
      produced += ll + ml;
    }
    if (br.pos != 0) corrupt("sequence bitstream not consumed exactly");
    lit += lpos;
    nlit -= lpos;
  } else if (p != n) {
    corrupt("bytes after an empty sequences section");
  }
  if (nlit > block_max - produced) corrupt("block larger than its maximum");
  out.need(nlit);
  memcpy(out.p + out.pos, lit, nlit);
  out.pos += nlit;
}

struct Header {
  uint64_t size;        // header bytes
  bool has_fcs, checksum;
  uint64_t fcs, window;
};

Header frame_header(const uint8_t* b, uint64_t n) {
  if (n < 5) corrupt("frame header truncated");
  uint8_t fhd = b[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
  if (fhd & 8) corrupt("reserved frame header bit set");
  Header h{};
  h.checksum = (fhd >> 2) & 1;
  uint64_t p = 5;
  if (!single) {
    if (p >= n) corrupt("frame header truncated");
    int exp = b[p] >> 3, mant = b[p] & 7;
    if (exp > 21) corrupt("window larger than 2 GiB");
    uint64_t base = 1ULL << (10 + exp);
    h.window = base + (base / 8) * mant;
    ++p;
  }
  static const int did_size[4] = {0, 1, 2, 4};
  uint64_t did = 0;
  if (n - p < uint64_t(did_size[did_flag])) corrupt("frame header truncated");
  for (int i = 0; i < did_size[did_flag]; ++i) did |= uint64_t(b[p + i]) << (8 * i);
  p += did_size[did_flag];
  if (did != 0) throw Error{-3, "zstd frame needs a dictionary (not supported)"};
  static const int fcs_size[4] = {0, 2, 4, 8};
  int fs = fcs_flag == 0 ? (single ? 1 : 0) : fcs_size[fcs_flag];
  if (n - p < uint64_t(fs)) corrupt("frame header truncated");
  h.has_fcs = fs > 0;
  if (fs == 1) h.fcs = b[p];
  else if (fs == 2) h.fcs = rd16(b + p) + 256;
  else if (fs == 4) h.fcs = rd32(b + p);
  else if (fs == 8) h.fcs = rd64(b + p);
  p += fs;
  if (single) h.window = h.fcs;
  h.size = p;
  return h;
}

// Decodes the frame at b; returns its size in the input.
uint64_t frame(const uint8_t* b, uint64_t n, Out& out) {
  Header h = frame_header(b, n);
  uint64_t p = h.size, start = out.pos;
  const uint64_t block_max = h.window < kBlockMax ? h.window : kBlockMax;
  Frame f;
  for (;;) {
    if (n - p < 3) corrupt("block header truncated");
    uint32_t bh = rd24(b + p);
    p += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    uint64_t size = bh >> 3;
    if (size > block_max) corrupt("block larger than its maximum");
    if (type == 0) {
      if (n - p < size) corrupt("raw block truncated");
      out.need(size);
      memcpy(out.p + out.pos, b + p, size);
      out.pos += size;
      p += size;
    } else if (type == 1) {
      if (n - p < 1) corrupt("RLE block truncated");
      out.need(size);
      memset(out.p + out.pos, b[p], size);
      out.pos += size;
      p += 1;
    } else if (type == 2) {
      if (n - p < size) corrupt("compressed block truncated");
      compressed_block(f, b + p, size, block_max, out, start);
      p += size;
    } else {
      corrupt("reserved block type");
    }
    if (last) break;
  }
  uint64_t got = out.pos - start;
  if (h.has_fcs && got != h.fcs) corrupt("frame content size does not match");
  if (h.checksum) {
    if (n - p < 4) corrupt("frame checksum truncated");
    if (uint32_t(xxh64(out.p + start, got, 0)) != rd32(b + p))
      corrupt("frame checksum mismatch");
    p += 4;
  }
  return p;
}

// The input size of the frame at b without decoding it, and its content
// size (or -1 when its header has none).
uint64_t frame_extent(const uint8_t* b, uint64_t n, int64_t* content) {
  Header h = frame_header(b, n);
  uint64_t p = h.size;
  for (;;) {
    if (n - p < 3) corrupt("block header truncated");
    uint32_t bh = rd24(b + p);
    p += 3;
    uint64_t size = ((bh >> 1) & 3) == 1 ? 1 : bh >> 3;
    if (n - p < size) corrupt("block truncated");
    p += size;
    if (bh & 1) break;
  }
  if (h.checksum) {
    if (n - p < 4) corrupt("frame checksum truncated");
    p += 4;
  }
  *content = h.has_fcs ? int64_t(h.fcs) : -1;
  return p;
}

// ZSTD_findFrameCompressedSize: the frame's extent in the input, or false
// where a block is reserved or the frame runs past the input.
bool frame_found(const uint8_t* b, uint64_t n, const Header& h,
                 uint64_t* extent) {
  uint64_t p = h.size;
  for (;;) {
    if (n - p < 3) return false;
    uint32_t bh = rd24(b + p);
    int type = (bh >> 1) & 3;
    if (type == 3) return false;
    uint64_t size = type == 1 ? 1 : bh >> 3;
    if (n - p - 3 < size) return false;
    p += 3 + size;
    if (bh & 1) break;
  }
  if (h.checksum) {
    if (n - p < 4) return false;
    p += 4;
  }
  *extent = p;
  return true;
}

// What libtiff's ZSTDDecode (tif_zstd.c) gets from ZSTD_decompressStream
// into a `cap`-byte buffer, called until the buffer is full, the frame ends
// or the input runs out: a frame whose content size fits the buffer and
// which lies whole in the input is decoded in one pass (libzstd's
// single-pass shortcut, every check made); any other is decoded block by
// block, and decoding stops at the first block that does not fit what is
// left of the buffer, so that later blocks, the content size and the
// checksum are never checked. Returns the bytes written.
uint64_t frame_stream(const uint8_t* b, uint64_t n, uint8_t* dst,
                      uint64_t cap) {
  Header h = frame_header(b, n);
  uint64_t extent;
  if (h.has_fcs && h.fcs <= cap && frame_found(b, n, h, &extent)) {
    Out out{dst, cap, 0};
    frame(b, extent, out);
    return out.pos;
  }
  const uint64_t window = h.window < 1024 ? 1024 : h.window;
  if (window > (1ULL << 27) + 1) corrupt("window larger than 128 MiB");
  const uint64_t block_max = h.window < kBlockMax ? h.window : kBlockMax;
  std::vector<uint8_t> buf;
  Frame f;
  uint64_t p = h.size, written = 0;
  Out out{nullptr, 0, 0};
  for (;;) {
    if (n - p < 3) return written;
    uint32_t bh = rd24(b + p);
    int last = bh & 1, type = (bh >> 1) & 3;
    uint64_t size = bh >> 3;
    if (type == 3) corrupt("reserved block type");
    if (size > block_max) corrupt("block larger than its maximum");
    p += 3;
    uint64_t start = out.pos;
    buf.resize(out.pos + block_max);
    out.p = buf.data();
    out.cap = buf.size();
    bool whole = true;
    if (type == 0) {  // libzstd copies a raw block as its input comes
      uint64_t got = n - p < size ? n - p : size;
      memcpy(out.p + out.pos, b + p, got);
      out.pos += got;
      p += got;
      whole = got == size;
    } else if (type == 1) {
      if (n - p < 1) return written;
      memset(out.p + out.pos, b[p], size);
      out.pos += size;
      p += 1;
    } else {
      if (n - p < size) return written;
      compressed_block(f, b + p, size, block_max, out, 0);
      p += size;
    }
    if (whole && last && h.has_fcs && out.pos != h.fcs)
      corrupt("frame content size does not match");
    uint64_t made = out.pos - start, room = cap - written;
    memcpy(dst + written, out.p + start, made < room ? made : room);
    written += made < room ? made : room;
    if (made > room || !whole) return written;
    if (last) {
      if (h.checksum && n - p >= 4 &&
          uint32_t(xxh64(out.p, out.pos, 0)) != rd32(b + p))
        corrupt("frame checksum mismatch");
      return written;
    }
  }
}

bool skippable(const uint8_t* b, uint64_t n, uint64_t* size) {
  uint32_t m = rd32(b);
  if ((m & 0xFFFFFFF0u) != 0x184D2A50u) return false;
  if (n < 8) corrupt("skippable frame truncated");
  uint64_t len = rd32(b + 4);
  if (n - 8 < len) corrupt("skippable frame truncated");
  *size = 8 + len;
  return true;
}

void report(const Error& e, char* err, uint64_t errcap) {
  if (err && errcap) snprintf(err, errcap, "%s", e.msg);
}

}  // namespace

extern "C" {

// Decodes every frame of src into dst. Returns the bytes written, or -1
// (corrupt input), -2 (dst too small), -3 (unsupported: a dictionary),
// with the reason in err.
int64_t zs_decompress(const uint8_t* src, uint64_t n, uint8_t* dst,
                      uint64_t cap, char* err, uint64_t errcap) {
  try {
    if (n == 0) corrupt("no zstd frame");
    Out out{dst, cap, 0};
    uint64_t p = 0;
    while (p < n) {
      if (n - p < 4) corrupt("trailing bytes after the last frame");
      uint64_t skip;
      if (skippable(src + p, n - p, &skip)) { p += skip; continue; }
      if (rd32(src + p) != kMagic) corrupt("not a zstd frame");
      p += frame(src + p, n - p, out);
    }
    return int64_t(out.pos);
  } catch (const Error& e) {
    report(e, err, errcap);
    return e.code;
  } catch (const std::bad_alloc&) {
    report(Error{-1, "out of memory"}, err, errcap);
    return -1;
  }
}

// libtiff's reading of one zstd strip into dst (frame_stream): returns the
// bytes written, which fill dst only where libtiff's read succeeds, or -1
// (corrupt input) with the reason in err.
int64_t zs_decompress_stream(const uint8_t* src, uint64_t n, uint8_t* dst,
                             uint64_t cap, char* err, uint64_t errcap) {
  try {
    if (n < 4) return 0;
    uint64_t skip;
    if (skippable(src, n, &skip)) return 0;  // its end ends libtiff's read
    if (rd32(src) != kMagic) corrupt("not a zstd frame");
    return int64_t(frame_stream(src, n, dst, cap));
  } catch (const Error& e) {
    report(e, err, errcap);
    return e.code;
  } catch (const std::bad_alloc&) {
    report(Error{-1, "out of memory"}, err, errcap);
    return -1;
  }
}

// The total content size that the frames of src declare, -1 when a frame
// declares none, or -2 with the reason in err when the frames are corrupt.
int64_t zs_content_size(const uint8_t* src, uint64_t n, char* err,
                        uint64_t errcap) {
  try {
    if (n == 0) corrupt("no zstd frame");
    uint64_t p = 0, total = 0;
    bool known = true;
    while (p < n) {
      if (n - p < 4) corrupt("trailing bytes after the last frame");
      uint64_t skip;
      if (skippable(src + p, n - p, &skip)) { p += skip; continue; }
      if (rd32(src + p) != kMagic) corrupt("not a zstd frame");
      int64_t c;
      p += frame_extent(src + p, n - p, &c);
      if (c < 0) known = false;
      else total += uint64_t(c);
    }
    return known ? int64_t(total) : -1;
  } catch (const Error& e) {
    report(e, err, errcap);
    return -2;
  }
}

uint64_t zs_raw_bound(uint64_t n) {
  return 4 + 1 + 8 + 3 * (n / kBlockMax + 1) + n + 4;
}

// One single-segment frame of Raw blocks holding src, with its content
// size and, when `checksum`, its XXH64 checksum. Returns the bytes
// written, or 0 when cap < zs_raw_bound(n).
uint64_t zs_encode_raw(const uint8_t* src, uint64_t n, uint8_t* dst,
                       uint64_t cap, int checksum) {
  if (cap < zs_raw_bound(n)) return 0;
  uint8_t* o = dst;
  for (int i = 0; i < 4; ++i) *o++ = uint8_t(kMagic >> (8 * i));
  int flag, fs;
  uint64_t v = n;
  if (n < 256) { flag = 0; fs = 1; }
  else if (n < 65536 + 256) { flag = 1; fs = 2; v = n - 256; }
  else if (n <= 0xFFFFFFFFull) { flag = 2; fs = 4; }
  else { flag = 3; fs = 8; }
  *o++ = uint8_t((flag << 6) | (1 << 5) | (checksum ? 4 : 0));
  for (int i = 0; i < fs; ++i) *o++ = uint8_t(v >> (8 * i));
  uint64_t p = 0;
  do {
    uint64_t size = n - p < kBlockMax ? n - p : kBlockMax;
    uint32_t bh = uint32_t(size << 3) | (p + size == n ? 1 : 0);
    *o++ = uint8_t(bh); *o++ = uint8_t(bh >> 8); *o++ = uint8_t(bh >> 16);
    if (size) memcpy(o, src + p, size);
    o += size;
    p += size;
  } while (p < n);
  if (checksum) {
    uint32_t c = uint32_t(xxh64(src, n, 0));
    for (int i = 0; i < 4; ++i) *o++ = uint8_t(c >> (8 * i));
  }
  return uint64_t(o - dst);
}

uint64_t zs_xxh64(const uint8_t* src, uint64_t n, uint64_t seed) {
  return xxh64(src, n, seed);
}

}  // extern "C"
