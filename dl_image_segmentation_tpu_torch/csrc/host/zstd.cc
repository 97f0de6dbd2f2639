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
// returns an error, never reads or writes outside the buffers.

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
  uint64_t sum = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) corrupt("Huffman weight above 11");
    if (w[i]) sum += 1ULL << (w[i] - 1);
  }
  if (sum == 0) corrupt("Huffman weights are all zero");
  int max_bits = highbit(sum) + 1;
  uint64_t left = (1ULL << max_bits) - sum;
  if (left & (left - 1)) corrupt("Huffman weights do not sum to a power of two");
  if (max_bits > 11) corrupt("Huffman code longer than 11 bits");
  w[nw++] = uint8_t(highbit(left) + 1);
  uint8_t bits[256];
  uint32_t count[13] = {0};
  for (int i = 0; i < nw; ++i) {
    bits[i] = w[i] ? uint8_t(max_bits + 1 - w[i]) : 0;
    count[bits[i]]++;
  }
  const uint32_t size = 1u << max_bits;
  h.max_bits = max_bits;
  h.sym.assign(size, 0);
  h.nbits.assign(size, 0);
  uint32_t start[13];
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
  if (type == 2) {
    uint64_t used = huf_read(f.huf, s, sn);
    f.have_huf = true;
    s += used;
    sn -= used;
  } else if (!f.have_huf) {
    corrupt("treeless literals without an earlier Huffman table");
  }
  f.lits.resize(regen);
  uint8_t* out = f.lits.data();
  if (streams == 1) {
    huf_stream(f.huf, s, sn, out, regen);
  } else {
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
