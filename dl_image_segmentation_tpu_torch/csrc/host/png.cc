// PNG scanline reconstruction, built with g++ at first use and called
// through ctypes (raster/png.py), which releases the GIL for the feed's
// parse threads. Python parses the chunks and inflates the IDAT stream
// with stdlib zlib; this file undoes the five filters (None, Sub, Up,
// Average, Paeth) at bit depths 1/2/4/8/16 and places the seven Adam7
// passes of an interlaced image. The output is one sample per element:
// uint8 for depths up to 8 (palette indices and sub-byte values as
// stored), uint16 in native order for depth 16. Every read is bounded by
// the lengths passed in.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

// Unfilter `rows` rows of `stride` bytes (each preceded by its filter
// type byte) from src into dst (rows * stride bytes). bpp is the filter
// unit: bytes per complete pixel, at least 1. Returns 0, or -1 on an
// unknown filter type.
int unfilter(const uint8_t* src, uint8_t* dst, uint64_t rows,
             uint64_t stride, int bpp) {
    const uint8_t* prev = nullptr;
    for (uint64_t y = 0; y < rows; ++y) {
        int ft = src[0];
        const uint8_t* in = src + 1;
        uint8_t* out = dst;
        switch (ft) {
        case 0:
            memcpy(out, in, stride);
            break;
        case 1:
            for (uint64_t i = 0; i < stride; ++i)
                out[i] = uint8_t(in[i] + (i >= (uint64_t)bpp ? out[i - bpp] : 0));
            break;
        case 2:
            for (uint64_t i = 0; i < stride; ++i)
                out[i] = uint8_t(in[i] + (prev ? prev[i] : 0));
            break;
        case 3:
            for (uint64_t i = 0; i < stride; ++i) {
                int a = i >= (uint64_t)bpp ? out[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                out[i] = uint8_t(in[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (uint64_t i = 0; i < stride; ++i) {
                int a = i >= (uint64_t)bpp ? out[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                int c = (prev && i >= (uint64_t)bpp) ? prev[i - bpp] : 0;
                out[i] = uint8_t(in[i] + paeth(a, b, c));
            }
            break;
        default:
            return -1;
        }
        prev = out;
        src += stride + 1;
        dst += stride;
    }
    return 0;
}

// Sample x of a reconstructed row at the given bit depth.
inline unsigned sample(const uint8_t* row, uint64_t x, int depth) {
    switch (depth) {
    case 1: return (row[x >> 3] >> (7 - (x & 7))) & 1;
    case 2: return (row[x >> 2] >> (6 - 2 * (x & 3))) & 3;
    case 4: return (row[x >> 1] >> (4 - 4 * (x & 1))) & 15;
    case 8: return row[x];
    default: return (unsigned(row[2 * x]) << 8) | row[2 * x + 1];
    }
}

const int kX0[7] = {0, 4, 0, 2, 0, 1, 0};
const int kY0[7] = {0, 0, 4, 0, 2, 0, 1};
const int kDX[7] = {8, 8, 4, 4, 2, 2, 1};
const int kDY[7] = {8, 8, 8, 4, 4, 2, 2};

}  // namespace

extern "C" {

// Bytes of the filtered (inflated) stream that a width x height image
// needs: every row of every pass plus its filter byte.
uint64_t fc_png_raw_size(uint64_t width, uint64_t height, int depth,
                         int channels, int interlace) {
    uint64_t bits = uint64_t(depth) * channels;
    if (!interlace) return height * ((width * bits + 7) / 8 + 1);
    uint64_t total = 0;
    for (int p = 0; p < 7; ++p) {
        uint64_t pw = width > (uint64_t)kX0[p]
            ? (width - kX0[p] + kDX[p] - 1) / kDX[p] : 0;
        uint64_t ph = height > (uint64_t)kY0[p]
            ? (height - kY0[p] + kDY[p] - 1) / kDY[p] : 0;
        if (pw && ph) total += ph * ((pw * bits + 7) / 8 + 1);
    }
    return total;
}

// raw: the inflated stream (raw_len bytes); out: width*height*channels
// samples, uint8 for depth <= 8, native uint16 for depth 16. Returns 0,
// -1 for an unknown filter type, -2 when raw is shorter than the image
// needs, -3 for a bad argument.
int fc_png_unfilter(const uint8_t* raw, uint64_t raw_len, uint64_t width,
                    uint64_t height, int depth, int channels, int interlace,
                    void* out) {
    if (!(depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
          depth == 16) || channels < 1 || channels > 4 || !width || !height)
        return -3;
    if (raw_len < fc_png_raw_size(width, height, depth, channels, interlace))
        return -2;
    const uint64_t bits = uint64_t(depth) * channels;
    const int bpp = int(bits >= 8 ? bits / 8 : 1);
    uint8_t* out8 = static_cast<uint8_t*>(out);
    uint16_t* out16 = static_cast<uint16_t*>(out);
    const uint64_t stride_full = (width * bits + 7) / 8;
    if (depth == 8 && !interlace)  // rows are the samples already
        return unfilter(raw, out8, height, stride_full, bpp) ? -1 : 0;
    uint8_t* buf = static_cast<uint8_t*>(malloc(stride_full * height));
    if (!buf) return -3;
    int rc = 0;
    const uint8_t* src = raw;
    for (int p = 0; p < (interlace ? 7 : 1); ++p) {
        uint64_t x0 = interlace ? kX0[p] : 0, y0 = interlace ? kY0[p] : 0;
        uint64_t dx = interlace ? kDX[p] : 1, dy = interlace ? kDY[p] : 1;
        uint64_t pw = width > x0 ? (width - x0 + dx - 1) / dx : 0;
        uint64_t ph = height > y0 ? (height - y0 + dy - 1) / dy : 0;
        if (!pw || !ph) continue;
        uint64_t stride = (pw * bits + 7) / 8;
        if (unfilter(src, buf, ph, stride, bpp)) { rc = -1; break; }
        src += ph * (stride + 1);
        for (uint64_t y = 0; y < ph; ++y) {
            const uint8_t* row = buf + y * stride;
            uint64_t oy = y0 + y * dy;
            for (uint64_t x = 0; x < pw; ++x) {
                uint64_t o = ((oy * width) + x0 + x * dx) * channels;
                for (int c = 0; c < channels; ++c) {
                    unsigned v = sample(row, x * channels + c, depth);
                    if (depth == 16) out16[o + c] = uint16_t(v);
                    else out8[o + c] = uint8_t(v);
                }
            }
        }
    }
    free(buf);
    return rc;
}

}  // extern "C"
