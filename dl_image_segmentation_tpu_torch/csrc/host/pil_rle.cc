// Run-length decoders of the port's PIL-format readers (raster/
// pil_formats.py), built with g++ into build/ at first use and called
// through ctypes. Each gives what PIL 12.1's decoder gives, step for
// step, including where it stops.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// PIL's expandrow / expandrow2 (SgiRleDecode.c): n counts chunks, not
// bytes; -1 is an overrun, 1 stops the decode (the n-th chunk is not a
// terminator), 0 the row's end.
int ExpandRow(uint8_t* dest, const uint8_t* buf, size_t pos, int64_t n, int z,
              int xsize, size_t last, int bpc) {
  int x = 0;
  for (; n > 0; n--) {
    uint8_t pixel;
    if (bpc == 1) {
      if (pos > last) return -1;
      pixel = buf[pos++];
    } else {
      if (pos + 1 > last) return -1;
      pixel = buf[pos + 1];
      pos += 2;
    }
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (pos + (size_t)count * bpc > last) return -1;
      while (count--) {
        memcpy(dest, buf + pos, bpc);
        pos += bpc;
        dest += z * bpc;
      }
    } else {
      if (pos + bpc > last + (bpc == 1 ? 1 : 0)) return -1;
      while (count--) {
        memcpy(dest, buf + pos, bpc);
        dest += z * bpc;
      }
      pos += bpc;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// PIL's Python QoiDecoder. out holds w * h * bands bytes. Returns 0, or
// 1 (a read past the end: PIL's IndexError "index out of range") or 2
// (a pixel of *got bytes: PIL's ValueError "not enough values to
// unpack (expected 4, got *got)").
int fc_qoi_decode(const uint8_t* data, size_t size, size_t pos, int64_t npix,
                  int bands, uint8_t* out, int32_t* got) {
  uint8_t seen[64][4];
  uint8_t seen_set[64];
  memset(seen_set, 0, sizeof(seen_set));
  uint8_t prev[4] = {0, 0, 0, 255};
  const int64_t dest = npix * bands;
  int64_t n = 0;
  auto emit = [&](const uint8_t* v) {
    for (int k = 0; k < bands && n < dest; ++k) out[n++] = v[k];
  };
  while (n < dest) {
    if (pos >= size) return 1;
    const uint8_t byte = data[pos++];
    uint8_t value[4];
    if (byte == 0xFE) {
      const size_t avail = size - pos < 3 ? size - pos : 3;
      if (avail < 3) {
        *got = (int32_t)avail + 1;
        return 2;
      }
      memcpy(value, data + pos, 3);
      value[3] = prev[3];
      pos += 3;
    } else if (byte == 0xFF) {
      const size_t avail = size - pos < 4 ? size - pos : 4;
      if (avail < 4) {
        *got = (int32_t)avail;
        return 2;
      }
      memcpy(value, data + pos, 4);
      pos += 4;
    } else {
      const int op = byte >> 6;
      if (op == 0) {
        const int idx = byte & 0x3F;
        if (seen_set[idx]) {
          memcpy(value, seen[idx], 4);
        } else {
          memset(value, 0, 4);
        }
      } else if (op == 1) {
        value[0] = (uint8_t)(prev[0] + ((byte & 0x30) >> 4) - 2);
        value[1] = (uint8_t)(prev[1] + ((byte & 0x0C) >> 2) - 2);
        value[2] = (uint8_t)(prev[2] + (byte & 0x03) - 2);
        value[3] = prev[3];
      } else if (op == 2) {
        if (pos >= size) return 1;
        const uint8_t second = data[pos++];
        const int dg = (byte & 0x3F) - 32;
        const int dr = ((second & 0xF0) >> 4) - 8;
        const int db = (second & 0x0F) - 8;
        value[0] = (uint8_t)(prev[0] + dg + dr);
        value[1] = (uint8_t)(prev[1] + dg);
        value[2] = (uint8_t)(prev[2] + dg + db);
        value[3] = prev[3];
      } else {
        const int run = (byte & 0x3F) + 1;
        for (int r = 0; r < run; ++r) emit(prev);
        continue;
      }
    }
    memcpy(prev, value, 4);
    const int h = (value[0] * 3 + value[1] * 5 + value[2] * 7 + value[3] * 11) % 64;
    memcpy(seen[h], value, 4);
    seen_set[h] = 1;
    emit(value);
  }
  return 0;
}

// PIL's PcxDecode into ysize line buffers of nbytes. Returns 0, 1 (the
// data ends first; *left = the bytes of the packet it could not take)
// or 2 (the image is whole but a run went past its line: PIL drops the
// rest of that run, goes on, and reports a buffer overrun at the end).
int fc_pcx_decode(const uint8_t* data, size_t size, size_t pos, int64_t nbytes,
                  int64_t ysize, uint8_t* out, int32_t* left) {
  int64_t x = 0, y = 0;
  int overrun = 0;
  uint8_t* line = out;
  while (true) {
    if (pos >= size) {
      *left = 0;
      return 1;
    }
    const uint8_t b = data[pos];
    if ((b & 0xC0) == 0xC0) {
      if (size - pos < 2) {
        *left = (int32_t)(size - pos);
        return 1;
      }
      int n = b & 0x3F;
      const uint8_t v = data[pos + 1];
      while (n > 0) {
        if (x >= nbytes) {
          overrun = 1;
          break;
        }
        line[x++] = v;
        n--;
      }
      pos += 2;
    } else {
      line[x++] = b;
      pos += 1;
    }
    if (x >= nbytes) {
      x = 0;
      if (++y >= ysize) return overrun ? 2 : 0;
      line += nbytes;
    }
  }
}

// PIL's SgiRleDecode over ``buf`` (the file after its 512-byte header):
// out holds ysize rows of xsize * zsize * bpc bytes, in file order
// (bottom-up), zero where the decode stopped early. Returns 0 or -1 (a
// buffer overrun).
int fc_sgi_rle_decode(const uint8_t* buf, size_t bufsize, int xsize, int ysize,
                      int zsize, int bpc, uint8_t* out) {
  const size_t tablen = (size_t)zsize * ysize;
  if (bufsize < 8 * tablen) return -1;
  std::vector<uint32_t> starts(tablen), lens(tablen);
  for (size_t i = 0; i < tablen; ++i) {
    const uint8_t* p = buf + 4 * i;
    const uint8_t* q = buf + 4 * (tablen + i);
    starts[i] = ((uint32_t)p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
    lens[i] = ((uint32_t)q[0] << 24) | (q[1] << 16) | (q[2] << 8) | q[3];
  }
  const size_t row_bytes = (size_t)xsize * zsize * bpc;
  std::vector<uint8_t> row((size_t)xsize * zsize * 2, 0);
  const size_t last = bufsize - 1;
  for (int r = 0; r < ysize; ++r) {
    for (int c = 0; c < zsize; ++c) {
      uint32_t off = starts[r + (size_t)c * ysize];
      const int64_t n = (int32_t)lens[r + (size_t)c * ysize];
      if (off < 512) return -1;
      off -= 512;
      const int status = ExpandRow(&row[(size_t)c * bpc], buf, off, n, zsize, xsize, last, bpc);
      if (status == -1) return -1;
      if (status == 1) return 0;
    }
    memcpy(out + (size_t)r * row_bytes, row.data(), row_bytes);
  }
  return 0;
}

}  // extern "C"
