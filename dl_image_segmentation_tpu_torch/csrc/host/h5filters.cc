// HDF5 chunk filters that Python cannot run at a useful speed, for the
// port's HDF5 reader (raster/hdf5.py): LZF (h5py's filter 32000) and szip
// (filter 4, the CCSDS 121.0 adaptive entropy coder as libaec's szip
// interface writes it). Decode only. Every read and write is bounds
// checked: corrupt input returns -1 and never touches memory outside the
// buffers it was given. No exception leaves an entry point: a failed
// allocation returns -1 too.
//
// Built with g++ into build/ at first use and called through ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// LZF, after liblzf's lzf_d.c: literal runs (control byte < 32: 1-32 bytes
// follow) and back references (length in the top 3 bits, 7 meaning one more
// length byte; 13-bit distance).
// ---------------------------------------------------------------------------

int64_t lzf_decompress(const uint8_t* in, uint64_t in_len, uint8_t* out,
                       uint64_t out_cap) {
  const uint8_t* ip = in;
  const uint8_t* const in_end = in + in_len;
  uint64_t op = 0;
  while (ip < in_end) {
    unsigned ctrl = *ip++;
    if (ctrl < 32) {  // literal run of ctrl + 1 bytes
      uint64_t n = ctrl + 1;
      if (n > (uint64_t)(in_end - ip) || n > out_cap - op) return -1;
      std::memcpy(out + op, ip, n);
      ip += n;
      op += n;
      continue;
    }
    uint64_t len = ctrl >> 5;
    if (len == 7) {
      if (ip >= in_end) return -1;
      len += *ip++;
    }
    if (ip >= in_end) return -1;
    uint64_t back = ((uint64_t)(ctrl & 0x1f) << 8) + *ip++ + 1;
    len += 2;
    if (back > op || len > out_cap - op) return -1;
    // byte by byte: a reference may overlap the bytes it produces
    const uint8_t* ref = out + op - back;
    for (uint64_t k = 0; k < len; ++k) out[op + k] = ref[k];
    op += len;
  }
  return (int64_t)op;
}

// ---------------------------------------------------------------------------
// szip: CCSDS 121.0-B adaptive entropy decoding (libaec's decode.c and
// sz_compat.c). A stream of coded data sets of `block` samples; every
// `rsi` blocks a reference sample interval (not padded to a byte, as
// libaec's szip interface writes it). Per block an
// option ID: 0 low entropy (zero blocks or the second extension), all ones
// uncompressed, else split samples with k = ID - 1. With the nearest-
// neighbour preprocessor (szip's NN option) each interval starts with a
// raw reference sample and the rest are mapped prediction residuals.
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* p;
  uint64_t nbits;
  uint64_t pos = 0;

  bool get(int n, uint32_t* v) {
    if (n == 0) {
      *v = 0;
      return true;
    }
    if (pos + (uint64_t)n > nbits) return false;
    uint32_t out = 0;
    for (int i = 0; i < n; ++i, ++pos)
      out = (out << 1) | ((p[pos >> 3] >> (7 - (pos & 7))) & 1u);
    *v = out;
    return true;
  }

  // a fundamental-sequence code: the count of 0 bits before a 1
  bool fs(uint32_t* v, uint32_t limit) {
    uint32_t n = 0;
    for (;;) {
      if (pos >= nbits) return false;
      uint32_t bit = (p[pos >> 3] >> (7 - (pos & 7))) & 1u;
      ++pos;
      if (bit) break;
      if (++n > limit) return false;
    }
    *v = n;
    return true;
  }
};

const uint32_t kSzMsb = 16, kSzNn = 32;

// Decode `nsamples` samples of `bps` bits into `dst`, each as `sbytes`
// bytes (the most significant first if `msb`); returns false on a corrupt
// stream.
bool aec_decode(const uint8_t* in, uint64_t in_len, uint32_t bps,
                uint32_t block, uint32_t rsi, bool pp, uint8_t* dst,
                uint32_t sbytes, bool msb, uint64_t nsamples) {
  BitReader br{in, in_len * 8};
  const int id_len = bps > 16 ? 5 : bps > 8 ? 4 : 3;
  const uint32_t id_max = (1u << id_len) - 1;
  const uint64_t xmax = bps == 32 ? 0xFFFFFFFFull : ((1ull << bps) - 1);
  // the second extension's table: code m -> (beta, first m of that beta)
  std::vector<uint32_t> se_beta, se_first;
  for (uint32_t i = 0, k = 0; i < 13; ++i) {
    uint32_t ms = k;
    for (uint32_t j = 0; j <= i; ++j, ++k) {
      se_beta.push_back(i);
      se_first.push_back(ms);
    }
  }
  uint64_t done = 0;
  // the last interval may run past `nsamples`: the rest is dropped
  auto put = [&](uint32_t v) {
    if (done == nsamples) return;
    uint8_t* d = dst + done++ * sbytes;
    for (uint32_t j = 0; j < sbytes; ++j)
      d[j] = (uint8_t)(v >> (8 * (msb ? sbytes - 1 - j : j)));
  };
  std::vector<uint32_t> rs;  // one reference sample interval
  const uint64_t interval = (uint64_t)rsi * block;
  rs.reserve(interval < nsamples ? interval : nsamples);
  std::vector<uint32_t> fsv(block);
  while (done < nsamples) {
    rs.clear();
    for (uint32_t b = 0; b < rsi && done + rs.size() < nsamples;) {
      const uint32_t ref = (pp && b == 0) ? 1 : 0;
      uint32_t id, v;
      if (!br.get(id_len, &id)) return false;
      if (id == 0) {
        uint32_t ext;
        if (!br.get(1, &ext)) return false;
        if (ref) {
          if (!br.get(bps, &v)) return false;
          rs.push_back(v);
        }
        if (ext == 0) {  // zero blocks
          uint32_t z;
          if (!br.fs(&z, 64)) return false;
          z += 1;
          if (z == 5) {  // the remainder of the 64-block segment
            uint32_t left = rsi - b, seg = 64 - (b % 64);
            z = left < seg ? left : seg;
          } else if (z > 5) {
            z -= 1;
          }
          if (z > rsi - b) return false;
          rs.insert(rs.end(), (uint64_t)z * block - ref, 0u);
          b += z;
          continue;
        }
        // the second extension: pairs coded by one fundamental sequence
        for (uint32_t i = ref; i < block;) {
          uint32_t m;
          if (!br.fs(&m, 90)) return false;
          if (m >= se_beta.size()) return false;
          uint32_t d1 = m - se_first[m];
          if ((i & 1) == 0) {
            rs.push_back(se_beta[m] - d1);
            ++i;
          }
          rs.push_back(d1);
          ++i;
        }
      } else if (id == id_max) {  // uncompressed
        for (uint32_t i = 0; i < block; ++i) {
          if (!br.get(bps, &v)) return false;
          rs.push_back(v);
        }
      } else {  // split samples
        const int k = (int)id - 1;
        if (ref) {
          if (!br.get(bps, &v)) return false;
          rs.push_back(v);
        }
        for (uint32_t i = ref; i < block; ++i)
          if (!br.fs(&fsv[i], bps == 32 ? 0xFFFFFFFFu : (uint32_t)xmax))
            return false;
        for (uint32_t i = ref; i < block; ++i) {
          if (!br.get(k, &v)) return false;
          rs.push_back((uint32_t)(((uint64_t)fsv[i] << k) | v));
        }
      }
      ++b;
    }
    if (pp && !rs.empty()) {
      // undo the unit-delay predictor's residual mapping (unsigned data)
      uint64_t x = rs[0];
      put((uint32_t)x);
      for (size_t i = 1; i < rs.size(); ++i) {
        uint64_t d = rs[i];
        uint64_t th = x < xmax - x ? x : xmax - x;
        if (d <= 2 * th) {
          x = (d & 1) ? x - ((d + 1) >> 1) : x + (d >> 1);
        } else if (th == x) {  // nearer the minimum: only upward is long
          x = d;
        } else {
          x = xmax - d;
        }
        if (x > xmax) return false;
        put((uint32_t)x);
      }
    } else {
      for (uint32_t v : rs) put(v);
    }
    if (rs.empty()) return false;
  }
  return true;
}

// The szip entry point's work; the parameters are those of
// h5_szip_decompress.
int64_t szip_decompress(const uint8_t* in, uint64_t in_len, uint8_t* out,
                        uint64_t out_len, uint32_t options, uint32_t ppb,
                        uint32_t bpp, uint32_t scanline) {
  // libaec's ranges: a scanline of at least one block (as HDF5 sets it),
  // and at most 4,096 blocks to a reference sample interval (CCSDS 121.0-B)
  if (ppb == 0 || ppb > 64 || (ppb & 1) || bpp == 0 || bpp > 64 ||
      scanline < ppb || (bpp > 32 && bpp != 64) ||
      (scanline + (uint64_t)ppb - 1) / ppb > 4096)
    return -1;
  if (out_len == 0) return 0;
  // 32- and 64-bit words are coded as bytes, interleaved by significance;
  // then each scanline is padded to whole blocks (as libaec's szip
  // interface compresses: interleave first, pad second)
  const bool interleave = bpp == 32 || bpp == 64;
  const uint32_t bps = interleave ? 8 : bpp;
  const uint32_t sbytes = bps <= 8 ? 1 : bps <= 16 ? 2 : 4;
  const uint32_t rsi = (scanline + ppb - 1) / ppb;
  const uint32_t pad = scanline % ppb;
  if (out_len % sbytes || (interleave && out_len % (bpp / 8))) return -1;
  const uint64_t pixels = out_len / sbytes;
  const uint64_t lines = pad ? (pixels + scanline - 1) / scanline : 0;
  const uint64_t nsamples = pad ? lines * rsi * ppb : pixels;
  // a scanline holds at least one block, so its padding at most doubles
  // it; one interval past the end when a scanline outgrows the data
  if (nsamples > 2 * pixels + (uint64_t)rsi * ppb) return -1;
  const bool msb = (options & kSzMsb) != 0;
  const bool pp = (options & kSzNn) != 0;
  if (!pad && !interleave)
    return aec_decode(in, in_len, bps, ppb, rsi, pp, out, sbytes, msb,
                      nsamples) ? (int64_t)out_len : -1;
  std::vector<uint8_t> bytes(nsamples * sbytes);
  if (!aec_decode(in, in_len, bps, ppb, rsi, pp, bytes.data(), sbytes, msb,
                  nsamples))
    return -1;
  // drop each scanline's padding, into `out` or (to be de-interleaved) in
  // place: a line never moves to a later offset
  uint8_t* flat = interleave ? bytes.data() : out;
  if (pad) {
    const uint64_t line_in = (uint64_t)rsi * ppb * sbytes;
    const uint64_t line_out = (uint64_t)scanline * sbytes;
    for (uint64_t l = 0, o = 0; o < out_len; ++l) {
      uint64_t n = line_out < out_len - o ? line_out : out_len - o;
      std::memmove(flat + o, bytes.data() + l * line_in, n);
      o += n;
    }
  }
  if (interleave) {
    const uint32_t ws = bpp / 8;
    const uint64_t n = out_len / ws;
    for (uint64_t i = 0; i < n; ++i)
      for (uint32_t j = 0; j < ws; ++j) out[i * ws + j] = flat[j * n + i];
  }
  return (int64_t)out_len;
}

}  // namespace

extern "C" {

// LZF: decompress `in_len` bytes into `out` (capacity `out_cap`); returns
// the number of bytes written, or -1 if the stream is corrupt or too long.
int64_t h5_lzf_decompress(const uint8_t* in, uint64_t in_len, uint8_t* out,
                          uint64_t out_cap) {
  try {
    return lzf_decompress(in, in_len, out, out_cap);
  } catch (...) {
    return -1;
  }
}

// szip as HDF5's filter stores it (after its 4-byte size prefix): fill
// exactly `out_len` bytes of `out`; returns `out_len`, or -1 if the stream
// is corrupt or the parameters are out of range. `options` is szip's
// option mask (NN: preprocessed; MSB: big-endian samples). Besides
// `out`, it allocates at most about twice `out_len`.
int64_t h5_szip_decompress(const uint8_t* in, uint64_t in_len, uint8_t* out,
                           uint64_t out_len, uint32_t options, uint32_t ppb,
                           uint32_t bpp, uint32_t scanline) {
  try {
    return szip_decompress(in, in_len, out, out_len, options, ppb, bpp,
                           scanline);
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
