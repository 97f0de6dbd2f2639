// Baseline JPEG decoder and encoder, built with g++ at first use and
// called through ctypes (raster/jpeg.py), which releases the GIL.
//
// Both follow libjpeg-turbo's default paths step for step, so that the
// decoder's pixels equal those of PIL's default decode (libjpeg-turbo:
// islow IDCT, fancy upsampling, integer YCbCr->RGB) bit for bit, and the
// encoder's bytes equal PIL's `save(format="JPEG", quality=q)`:
//
//   decode  markers as jdmarker.c reads them (fill bytes, APP0 JFIF and
//           APP14 Adobe detection, DRI/RSTn and jpeg_resync_to_restart),
//           Huffman decoding as jdhuff.c (standard tables for a missing
//           table 0/1, zeros after an early marker), jidctint.c's
//           jpeg_idct_islow with its range-limit table, the upsampler
//           jdsample.c:jinit_upsampler picks per component (h2v1, h1v2 and
//           h2v2 triangle filters, box replication) with jdmainct.c's
//           edge rows, jdcolor.c's tables, and the colour space guess of
//           jdapimin.c:default_decompress_parms.
//   encode  jcparam.c's quality scaling with force_baseline, jccolor.c's
//           RGB->YCbCr tables, jcsample.c's h2v2 downsampler with its
//           alternating bias and jcprepct.c's edge replication,
//           jfdctint.c's jpeg_fdct_islow, jcdctmgr.c's reciprocal
//           quantizer (16-bit DCTELEM, as libjpeg-turbo's SIMD builds),
//           jccoefct.c's dummy blocks, and jchuff.c's standard tables,
//           byte stuffing and 1-bit padding; markers in jcmarker.c's order.
//
// Scope of the decoder: SOF0/SOF1, 8-bit, 1 or 3 components, any
// sampling factors libjpeg-turbo accepts, one or several sequential
// scans. Progressive, arithmetic, lossless, hierarchical and 12-bit
// frames and 2 or 4 components return kUnsupported. Every read is
// bounded by the data length.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { kOk = 0, kTruncated = -1, kCorrupt = -2, kUnsupported = -3,
       kTooSmall = -4 };

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jstdhuff.c: bits[0] unused, bits[1..16] = codes of each length
const uint8_t kBitsDcLum[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kBitsDcChr[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kValDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsAcLum[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kValAcLum[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kBitsAcChr[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kValAcChr[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jcparam.c: the tables of the JPEG standard's Annex K, natural order
const unsigned kStdLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const unsigned kStdChrQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

typedef int64_t JLONG;  // `long` on the LP64 hosts libjpeg-turbo is built for

const int CONST_BITS = 13;
const int PASS1_BITS = 2;
const JLONG FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
            FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
            FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
            FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
            FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
            FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline JLONG descale(JLONG x, int n) { return (x + (JLONG(1) << (n - 1))) >> n; }

// jdmaster.c:prepare_range_limit_table, the post-IDCT part: index
// (x & 1023) for an IDCT output x before the +128 level shift
uint8_t g_idct_limit[1024];
// jdcolor.c / jccolor.c tables
int g_cr_r[256], g_cb_b[256];
JLONG g_cr_g[256], g_cb_g[256];
JLONG g_rgb_ycc[8 * 256];

inline JLONG FIX16(double x) { return JLONG(x * (1L << 16) + 0.5); }

void fill_tables() {
    for (int i = 0; i < 1024; ++i)
        g_idct_limit[i] = uint8_t(i < 128 ? i + 128 : i < 512 ? 255
                                  : i < 896 ? 0 : i - 896);
    const JLONG ONE_HALF = JLONG(1) << 15;
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
        g_cr_r[i] = int((FIX16(1.40200) * x + ONE_HALF) >> 16);
        g_cb_b[i] = int((FIX16(1.77200) * x + ONE_HALF) >> 16);
        g_cr_g[i] = (-FIX16(0.71414)) * x;
        g_cb_g[i] = (-FIX16(0.34414)) * x + ONE_HALF;
    }
    const JLONG CBCR_OFFSET = JLONG(128) << 16;
    for (int i = 0; i < 256; ++i) {
        g_rgb_ycc[i + 0 * 256] = FIX16(0.29900) * i;
        g_rgb_ycc[i + 1 * 256] = FIX16(0.58700) * i;
        g_rgb_ycc[i + 2 * 256] = FIX16(0.11400) * i + ONE_HALF;
        g_rgb_ycc[i + 3 * 256] = (-FIX16(0.16874)) * i;
        g_rgb_ycc[i + 4 * 256] = (-FIX16(0.33126)) * i;
        // B=>Cb and R=>Cr are the same table
        g_rgb_ycc[i + 5 * 256] = FIX16(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;
        g_rgb_ycc[i + 6 * 256] = (-FIX16(0.41869)) * i;
        g_rgb_ycc[i + 7 * 256] = (-FIX16(0.08131)) * i;
    }
}

// once per process; a function-local static is initialised once even
// when the feed's parse threads arrive together
void init_tables() {
    static const bool ready = (fill_tables(), true);
    (void)ready;
}

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---------------------------------------------------------------- decode

struct HuffTable {          // jdhuff.c d_derived_tbl
    bool defined = false;
    uint8_t bits[17] = {0};
    uint8_t huffval[256] = {0};
    JLONG maxcode[18];
    JLONG valoffset[18];
};

bool derive(HuffTable& t, bool is_dc) {
    int huffsize[257];
    unsigned huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
        for (int i = 0; i < t.bits[l]; ++i) {
            if (p >= 256) return false;
            huffsize[p++] = l;
        }
    huffsize[p] = 0;
    int numsymbols = p;
    unsigned code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) { huffcode[p++] = code; ++code; }
        if (JLONG(code) >= (JLONG(1) << si)) return false;
        code <<= 1;
        ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (t.bits[l]) {
            t.valoffset[l] = JLONG(p) - JLONG(huffcode[p]);
            p += t.bits[l];
            t.maxcode[l] = huffcode[p - 1];
        } else {
            t.maxcode[l] = -1;
        }
    }
    t.valoffset[17] = 0;
    t.maxcode[17] = 0xFFFFFL;
    if (is_dc)
        for (int i = 0; i < numsymbols; ++i)
            if (t.huffval[i] > 15) return false;
    return true;
}

void std_table(HuffTable& t, bool is_dc, int tbl) {
    const uint8_t* bits = is_dc ? (tbl ? kBitsDcChr : kBitsDcLum)
                                : (tbl ? kBitsAcChr : kBitsAcLum);
    const uint8_t* vals = is_dc ? kValDc : (tbl ? kValAcChr : kValAcLum);
    int n = 0;
    for (int l = 1; l <= 16; ++l) n += bits[l];
    memcpy(t.bits, bits, 17);
    memset(t.huffval, 0, 256);
    memcpy(t.huffval, vals, n);
    t.defined = true;
}

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int dc_tbl = 0, ac_tbl = 0;
    bool latched = false;
    int16_t quant[64];            // ISLOW_MULT_TYPE is a short
    int width_in_blocks = 0, height_in_blocks = 0;
    int bw = 0, bh = 0;           // allocated blocks (MCU-aligned)
    int dw = 0, dh = 0;           // downsampled width / height
    std::vector<int16_t> coef;    // bw * bh blocks of 64, natural order
    int last_dc = 0;
};

struct Decoder {
    const uint8_t* data;
    uint64_t n;
    uint64_t pos = 0;
    int unread_marker = 0;
    std::string err;

    bool saw_sof = false, saw_jfif = false, saw_adobe = false;
    int adobe_transform = 0;
    int precision = 8, width = 0, height = 0, ncomp = 0;
    int max_h = 1, max_v = 1;
    int mcus_per_row = 0, mcu_rows = 0;
    int restart_interval = 0;
    Component comp[4];
    uint16_t qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    HuffTable dc[4], ac[4];

    // bit reader
    uint64_t bitbuf = 0;
    int bits_left = 0;
    bool insufficient = false;

    int fail(int code, const char* msg) {
        if (err.empty()) err = msg;
        return code;
    }

    // jdmarker.c:next_marker: skip to the next marker code. false when
    // the data ends first.
    bool next_marker() {
        for (;;) {
            while (pos < n && data[pos] != 0xFF) ++pos;
            if (pos >= n) return false;
            while (pos < n && data[pos] == 0xFF) ++pos;
            if (pos >= n) return false;
            int c = data[pos++];
            if (c != 0) { unread_marker = c; return true; }
        }
    }

    bool read_u16(int& v) {
        if (pos + 2 > n) return false;
        v = (data[pos] << 8) | data[pos + 1];
        pos += 2;
        return true;
    }

    // ---- bit reader (jdhuff.c jpeg_fill_bit_buffer semantics)
    bool fill(int nbits) {
        while (bits_left < nbits) {
            int c = 0;
            if (unread_marker == 0) {
                if (pos >= n) return false;
                c = data[pos++];
                if (c == 0xFF) {
                    do {
                        if (pos >= n) return false;
                        c = data[pos++];
                    } while (c == 0xFF);
                    if (c == 0) {
                        c = 0xFF;
                    } else {
                        unread_marker = c;
                        continue;
                    }
                }
                bitbuf = (bitbuf << 8) | uint64_t(c);
                bits_left += 8;
            } else {
                // past a marker: fake zero bits, as libjpeg does
                insufficient = true;
                bitbuf <<= 8;
                bits_left += 8;
            }
        }
        return true;
    }

    inline bool get_bits(int nbits, int& v) {
        if (nbits == 0) { v = 0; return true; }
        if (bits_left < nbits && !fill(nbits)) return false;
        bits_left -= nbits;
        v = int((bitbuf >> bits_left) & ((uint64_t(1) << nbits) - 1));
        return true;
    }

    inline bool decode_sym(const HuffTable& t, int& sym) {
        int l = 1, code;
        if (!get_bits(1, code)) return false;
        while (l <= 16 && JLONG(code) > t.maxcode[l]) {
            int b;
            if (!get_bits(1, b)) return false;
            code = (code << 1) | b;
            ++l;
        }
        if (l > 16) { sym = 0; return true; }  // bad code: a zero, as libjpeg
        JLONG idx = JLONG(code) + t.valoffset[l];
        sym = (idx >= 0 && idx < 256) ? t.huffval[idx] : 0;
        return true;
    }

    static inline int extend(int v, int s) {
        return v < (1 << (s - 1)) ? v + 1 - (1 << s) : v;
    }

    bool decode_block(Component& c, int16_t* block) {
        const HuffTable& d = dc[c.dc_tbl];
        const HuffTable& a = ac[c.ac_tbl];
        int s, r;
        if (!decode_sym(d, s)) return false;
        if (s) {
            if (!get_bits(s, r)) return false;
            s = extend(r, s);
        }
        s = int(unsigned(s) + unsigned(c.last_dc));
        c.last_dc = s;
        block[0] = int16_t(s);
        for (int k = 1; k < 64; ++k) {
            if (!decode_sym(a, s)) return false;
            r = s >> 4;
            s &= 15;
            if (s) {
                k += r;
                int v;
                if (!get_bits(s, v)) return false;
                block[kNatural[k]] = int16_t(extend(v, s));
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
        return true;
    }

    // jdmarker.c:read_restart_marker + jpeg_resync_to_restart
    bool process_restart(int& next_restart) {
        bits_left = 0;
        if (unread_marker == 0 && !next_marker()) return false;
        if (unread_marker == 0xD0 + next_restart) {
            unread_marker = 0;
        } else {
            int desired = next_restart;
            for (;;) {
                int m = unread_marker, action;
                if (m < 0xC0) action = 2;
                else if (m < 0xD0 || m > 0xD7) action = 3;
                else if (m == 0xD0 + ((desired + 1) & 7) ||
                         m == 0xD0 + ((desired + 2) & 7)) action = 3;
                else if (m == 0xD0 + ((desired - 1) & 7) ||
                         m == 0xD0 + ((desired - 2) & 7)) action = 2;
                else action = 1;
                if (action == 1) { unread_marker = 0; break; }
                if (action == 3) break;
                if (!next_marker()) return false;
            }
        }
        next_restart = (next_restart + 1) & 7;
        if (unread_marker == 0) insufficient = false;
        return true;
    }

    int read_sof(int marker) {
        int length, c;
        if (!read_u16(length)) return fail(kTruncated, "truncated SOF");
        if (pos + 6 > n) return fail(kTruncated, "truncated SOF");
        precision = data[pos];
        height = (data[pos + 1] << 8) | data[pos + 2];
        width = (data[pos + 3] << 8) | data[pos + 4];
        ncomp = data[pos + 5];
        pos += 6;
        if (saw_sof) return fail(kCorrupt, "duplicate SOF marker");
        if (marker != 0xC0 && marker != 0xC1)
            return fail(kUnsupported, "not a baseline or extended sequential "
                        "Huffman frame (progressive, lossless, hierarchical "
                        "or arithmetic-coded)");
        if (precision != 8)
            return fail(kUnsupported, "a sample precision other than 8 bits");
        if (height <= 0 || width <= 0 || ncomp <= 0)
            return fail(kCorrupt, "empty JPEG image (DNL not supported)");
        if (length - 8 != ncomp * 3)
            return fail(kCorrupt, "bogus SOF marker length");
        if (ncomp != 1 && ncomp != 3)
            return fail(kUnsupported, ncomp == 4
                        ? "4-component (CMYK / YCCK) JPEG"
                        : "a JPEG of neither 1 nor 3 components");
        if (pos + 3 * uint64_t(ncomp) > n) return fail(kTruncated, "truncated SOF");
        for (int ci = 0; ci < ncomp; ++ci) {
            c = data[pos];
            // a repeated component id becomes max id + 1, as libjpeg-turbo
            for (int i = 0; i < ci; ++i)
                if (c == comp[i].id) {
                    c = comp[0].id;
                    for (int j = 1; j < ci; ++j)
                        if (comp[j].id > c) c = comp[j].id;
                    ++c;
                    break;
                }
            comp[ci].id = c;
            comp[ci].h = (data[pos + 1] >> 4) & 15;
            comp[ci].v = data[pos + 1] & 15;
            comp[ci].tq = data[pos + 2];
            pos += 3;
            if (comp[ci].h < 1 || comp[ci].h > 4 || comp[ci].v < 1 ||
                comp[ci].v > 4)
                return fail(kCorrupt, "bad sampling factors");
            if (comp[ci].tq > 3) return fail(kCorrupt, "bad quant table index");
        }
        saw_sof = true;
        return kOk;
    }

    int setup_frame() {
        if (width > 65500 || height > 65500)
            return fail(kCorrupt, "JPEG dimensions too large");
        max_h = max_v = 1;
        for (int ci = 0; ci < ncomp; ++ci) {
            if (comp[ci].h > max_h) max_h = comp[ci].h;
            if (comp[ci].v > max_v) max_v = comp[ci].v;
        }
        mcus_per_row = (width + 8 * max_h - 1) / (8 * max_h);
        mcu_rows = (height + 8 * max_v - 1) / (8 * max_v);
        for (int ci = 0; ci < ncomp; ++ci) {
            Component& c = comp[ci];
            c.width_in_blocks = int((JLONG(width) * c.h + 8 * max_h - 1) / (8 * max_h));
            c.height_in_blocks = int((JLONG(height) * c.v + 8 * max_v - 1) / (8 * max_v));
            c.dw = int((JLONG(width) * c.h + max_h - 1) / max_h);
            c.dh = int((JLONG(height) * c.v + max_v - 1) / max_v);
            c.bw = mcus_per_row * c.h;
            c.bh = mcu_rows * c.v;
        }
        return kOk;
    }

    int read_dht(int length) {
        uint64_t end = pos + length;
        if (end > n) return fail(kTruncated, "truncated DHT");
        while (pos + 17 <= end) {
            int index = data[pos];
            uint8_t bits[17];
            bits[0] = 0;
            int count = 0;
            for (int i = 1; i <= 16; ++i) { bits[i] = data[pos + i]; count += bits[i]; }
            pos += 17;
            if (count > 256 || pos + count > end)
                return fail(kCorrupt, "bogus Huffman table definition");
            bool is_ac = index & 0x10;
            index &= ~0x10;
            if (index < 0 || index > 3) return fail(kCorrupt, "bogus DHT index");
            HuffTable& t = is_ac ? ac[index] : dc[index];
            memcpy(t.bits, bits, 17);
            memset(t.huffval, 0, 256);
            memcpy(t.huffval, data + pos, count);
            pos += count;
            t.defined = true;
        }
        if (pos != end) return fail(kCorrupt, "bogus DHT marker length");
        return kOk;
    }

    int read_dqt(int length) {
        uint64_t end = pos + length;
        if (end > n) return fail(kTruncated, "truncated DQT");
        while (pos < end) {
            int index = data[pos++];
            int prec = index >> 4, t = index & 15;
            if (t > 3 || prec > 1) return fail(kCorrupt, "bogus DQT index");
            if (pos + 64 * uint64_t(prec + 1) > end)
                return fail(kCorrupt, "bogus DQT marker length");
            for (int i = 0; i < 64; ++i) {
                unsigned v = prec ? (data[pos] << 8) | data[pos + 1] : data[pos];
                pos += prec + 1;
                qt[t][kNatural[i]] = uint16_t(v);
            }
            qt_defined[t] = true;
        }
        return kOk;
    }

    // one scan: returns kOk with the marker that ended it in unread_marker
    int read_scan(int length) {
        if (!saw_sof) return fail(kCorrupt, "SOS before SOF");
        uint64_t end = pos + length;
        if (end > n) return fail(kTruncated, "truncated SOS");
        int ns = data[pos];
        if (length != ns * 2 + 4 || ns < 1 || ns > 4)
            return fail(kCorrupt, "bogus SOS marker length");
        Component* sc[4];
        int ids[4];
        for (int i = 0; i < ns; ++i) {
            int cc = data[pos + 1 + 2 * i], t = data[pos + 2 + 2 * i];
            for (int pi = 0; pi < i; ++pi)
                if (cc == ids[pi]) {
                    cc = ids[0];
                    for (int pj = 1; pj < i; ++pj) if (ids[pj] > cc) cc = ids[pj];
                    ++cc;
                    break;
                }
            ids[i] = cc;
            sc[i] = nullptr;
            for (int ci = 0; ci < ncomp; ++ci)
                if (comp[ci].id == cc) sc[i] = &comp[ci];
            if (!sc[i]) return fail(kCorrupt, "invalid component ID in SOS");
            sc[i]->dc_tbl = (t >> 4) & 15;
            sc[i]->ac_tbl = t & 15;
            if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3)
                return fail(kCorrupt, "bogus Huffman table index");
        }
        pos = end;  // Ss, Se, Ah/Al: a sequential scan reads all 64
        int blocks_in_mcu = 0;
        for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            blocks_in_mcu += ns == 1 ? 1 : c.h * c.v;
            if (c.coef.empty()) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
            if (!c.latched) {
                if (!qt_defined[c.tq]) return fail(kCorrupt, "quantization table not defined");
                for (int k = 0; k < 64; ++k) c.quant[k] = int16_t(qt[c.tq][k]);
                c.latched = true;
            }
            if (!dc[c.dc_tbl].defined) {
                if (c.dc_tbl > 1) return fail(kCorrupt, "Huffman table not defined");
                std_table(dc[c.dc_tbl], true, c.dc_tbl);
            }
            if (!ac[c.ac_tbl].defined) {
                if (c.ac_tbl > 1) return fail(kCorrupt, "Huffman table not defined");
                std_table(ac[c.ac_tbl], false, c.ac_tbl);
            }
            if (!derive(dc[c.dc_tbl], true) || !derive(ac[c.ac_tbl], false))
                return fail(kCorrupt, "bogus Huffman table definition");
            c.last_dc = 0;
        }
        if (blocks_in_mcu > 10) return fail(kCorrupt, "sampling factors too large");
        bits_left = 0;
        insufficient = false;
        int restarts_to_go = restart_interval, next_restart = 0;
        int rows, cols;
        if (ns == 1) {
            cols = sc[0]->width_in_blocks;
            rows = sc[0]->height_in_blocks;
        } else {
            cols = mcus_per_row;
            rows = mcu_rows;
        }
        for (int my = 0; my < rows; ++my)
            for (int mx = 0; mx < cols; ++mx) {
                if (restart_interval) {
                    if (restarts_to_go == 0) {
                        if (!process_restart(next_restart))
                            return fail(kTruncated, "image file is truncated");
                        for (int i = 0; i < ns; ++i) sc[i]->last_dc = 0;
                        restarts_to_go = restart_interval;
                    }
                }
                if (!insufficient) {
                    for (int i = 0; i < ns; ++i) {
                        Component& c = *sc[i];
                        int bh = ns == 1 ? 1 : c.v, bwn = ns == 1 ? 1 : c.h;
                        for (int y = 0; y < bh; ++y)
                            for (int x = 0; x < bwn; ++x) {
                                int by = ns == 1 ? my : my * c.v + y;
                                int bx = ns == 1 ? mx : mx * c.h + x;
                                int16_t* blk = &c.coef[(size_t(by) * c.bw + bx) * 64];
                                memset(blk, 0, 64 * sizeof(int16_t));
                                if (!decode_block(c, blk))
                                    return fail(kTruncated, "image file is truncated");
                            }
                    }
                }
                if (restart_interval) --restarts_to_go;
            }
        return kOk;
    }

    // jdmarker.c:read_markers up to the first SOS (header_only) or EOI
    int run(bool header_only) {
        if (n < 2 || data[0] != 0xFF || data[1] != 0xD8)
            return fail(kCorrupt, "not a JPEG file (no SOI)");
        pos = 2;
        bool saw_sos = false;
        for (;;) {
            if (unread_marker == 0 && !next_marker()) {
                if (saw_sos) return kOk;  // all scans read, no EOI
                return fail(kTruncated, "image file is truncated");
            }
            int m = unread_marker;
            unread_marker = 0;
            if (m == 0xD8) return fail(kCorrupt, "unexpected SOI marker");
            if (m == 0xD9) {
                if (!saw_sos) return fail(kCorrupt, "no image in the JPEG file");
                return kOk;
            }
            if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
            int length;
            if (!read_u16(length)) return fail(kTruncated, "image file is truncated");
            if (length < 2) return fail(kCorrupt, "bogus marker length");
            length -= 2;
            if (pos + length > n && m != 0xDA)
                return fail(kTruncated, "image file is truncated");
            int rc = kOk;
            if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
                pos -= 2;
                rc = read_sof(m);
                if (rc == kOk) rc = setup_frame();
            } else if (m == 0xC4) {
                rc = read_dht(length);
            } else if (m == 0xDB) {
                rc = read_dqt(length);
            } else if (m == 0xDD) {
                if (length != 2) return fail(kCorrupt, "bogus DRI marker length");
                restart_interval = (data[pos] << 8) | data[pos + 1];
                pos += 2;
            } else if (m == 0xDA) {
                if (header_only) return saw_sof ? kOk : fail(kCorrupt, "SOS before SOF");
                rc = read_scan(length);
                saw_sos = true;
            } else if (m == 0xE0) {
                if (length >= 14 && memcmp(data + pos, "JFIF\0", 5) == 0) saw_jfif = true;
                pos += length;
            } else if (m == 0xEE) {
                if (length >= 12 && memcmp(data + pos, "Adobe", 5) == 0) {
                    saw_adobe = true;
                    adobe_transform = data[pos + 11];
                }
                pos += length;
            } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC ||
                       m == 0xCC) {
                pos += length;  // APPn, COM, DNL, DAC
            } else {
                return fail(kCorrupt, "unsupported JPEG marker");
            }
            if (rc != kOk) return rc;
        }
    }

    // jidctint.c:jpeg_idct_islow of one block into out (stride)
    static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                           int stride) {
        int ws[64];
        for (int col = 0; col < 8; ++col) {
            const int16_t* ip = in + col;
            const int16_t* qp = q + col;
            int* wp = ws + col;
            if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
                ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
                int dcval = (int(ip[0]) * qp[0]) * (1 << PASS1_BITS);
                for (int k = 0; k < 8; ++k) wp[8 * k] = dcval;
                continue;
            }
            JLONG z2 = JLONG(int(ip[16]) * qp[16]);
            JLONG z3 = JLONG(int(ip[48]) * qp[48]);
            JLONG z1 = (z2 + z3) * FIX_0_541196100;
            JLONG tmp2 = z1 + z3 * (-FIX_1_847759065);
            JLONG tmp3 = z1 + z2 * FIX_0_765366865;
            z2 = JLONG(int(ip[0]) * qp[0]);
            z3 = JLONG(int(ip[32]) * qp[32]);
            JLONG tmp0 = (z2 + z3) * (JLONG(1) << CONST_BITS);
            JLONG tmp1 = (z2 - z3) * (JLONG(1) << CONST_BITS);
            JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            tmp0 = JLONG(int(ip[56]) * qp[56]);
            tmp1 = JLONG(int(ip[40]) * qp[40]);
            tmp2 = JLONG(int(ip[24]) * qp[24]);
            tmp3 = JLONG(int(ip[8]) * qp[8]);
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            JLONG z4 = tmp1 + tmp3;
            JLONG z5 = (z3 + z4) * FIX_1_175875602;
            tmp0 = tmp0 * FIX_0_298631336;
            tmp1 = tmp1 * FIX_2_053119869;
            tmp2 = tmp2 * FIX_3_072711026;
            tmp3 = tmp3 * FIX_1_501321110;
            z1 = z1 * (-FIX_0_899976223);
            z2 = z2 * (-FIX_2_562915447);
            z3 = z3 * (-FIX_1_961570560);
            z4 = z4 * (-FIX_0_390180644);
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            const int sh = CONST_BITS - PASS1_BITS;
            wp[0] = int(descale(tmp10 + tmp3, sh));
            wp[56] = int(descale(tmp10 - tmp3, sh));
            wp[8] = int(descale(tmp11 + tmp2, sh));
            wp[48] = int(descale(tmp11 - tmp2, sh));
            wp[16] = int(descale(tmp12 + tmp1, sh));
            wp[40] = int(descale(tmp12 - tmp1, sh));
            wp[24] = int(descale(tmp13 + tmp0, sh));
            wp[32] = int(descale(tmp13 - tmp0, sh));
        }
        for (int row = 0; row < 8; ++row) {
            const int* wp = ws + 8 * row;
            uint8_t* op = out + size_t(row) * stride;
            if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
                wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
                uint8_t v = g_idct_limit[int(descale(JLONG(wp[0]), PASS1_BITS + 3)) & 1023];
                for (int k = 0; k < 8; ++k) op[k] = v;
                continue;
            }
            JLONG z2 = wp[2], z3 = wp[6];
            JLONG z1 = (z2 + z3) * FIX_0_541196100;
            JLONG tmp2 = z1 + z3 * (-FIX_1_847759065);
            JLONG tmp3 = z1 + z2 * FIX_0_765366865;
            JLONG tmp0 = (JLONG(wp[0]) + JLONG(wp[4])) * (JLONG(1) << CONST_BITS);
            JLONG tmp1 = (JLONG(wp[0]) - JLONG(wp[4])) * (JLONG(1) << CONST_BITS);
            JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            tmp0 = wp[7];
            tmp1 = wp[5];
            tmp2 = wp[3];
            tmp3 = wp[1];
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            JLONG z4 = tmp1 + tmp3;
            JLONG z5 = (z3 + z4) * FIX_1_175875602;
            tmp0 = tmp0 * FIX_0_298631336;
            tmp1 = tmp1 * FIX_2_053119869;
            tmp2 = tmp2 * FIX_3_072711026;
            tmp3 = tmp3 * FIX_1_501321110;
            z1 = z1 * (-FIX_0_899976223);
            z2 = z2 * (-FIX_2_562915447);
            z3 = z3 * (-FIX_1_961570560);
            z4 = z4 * (-FIX_0_390180644);
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            const int sh = CONST_BITS + PASS1_BITS + 3;
            op[0] = g_idct_limit[int(descale(tmp10 + tmp3, sh)) & 1023];
            op[7] = g_idct_limit[int(descale(tmp10 - tmp3, sh)) & 1023];
            op[1] = g_idct_limit[int(descale(tmp11 + tmp2, sh)) & 1023];
            op[6] = g_idct_limit[int(descale(tmp11 - tmp2, sh)) & 1023];
            op[2] = g_idct_limit[int(descale(tmp12 + tmp1, sh)) & 1023];
            op[5] = g_idct_limit[int(descale(tmp12 - tmp1, sh)) & 1023];
            op[3] = g_idct_limit[int(descale(tmp13 + tmp0, sh)) & 1023];
            op[4] = g_idct_limit[int(descale(tmp13 - tmp0, sh)) & 1023];
        }
    }

    // one component's samples upsampled to the full grid (height x width)
    // by the method jdsample.c:jinit_upsampler picks for it
    int upsample(const Component& c, const uint8_t* plane, int ps,
                 uint8_t* full) const {
        const int W = width, H = height, dw = c.dw, dh = c.dh;
        auto P = [&](int y, int x) -> int {
            return plane[size_t(y) * ps + x];
        };
        if (c.h == max_h && c.v == max_v) {
            for (int y = 0; y < H; ++y) memcpy(full + size_t(y) * W, plane + size_t(y) * ps, W);
        } else if (c.h * 2 == max_h && c.v == max_v) {
            std::vector<uint8_t> row(2 * size_t(dw));
            for (int y = 0; y < H; ++y) {
                if (dw > 2) {  // h2v1_fancy_upsample
                    row[0] = uint8_t(P(y, 0));
                    row[1] = uint8_t((P(y, 0) * 3 + P(y, 1) + 2) >> 2);
                    for (int i = 1; i < dw - 1; ++i) {
                        int v = P(y, i) * 3;
                        row[2 * i] = uint8_t((v + P(y, i - 1) + 1) >> 2);
                        row[2 * i + 1] = uint8_t((v + P(y, i + 1) + 2) >> 2);
                    }
                    row[2 * (dw - 1)] = uint8_t((P(y, dw - 1) * 3 + P(y, dw - 2) + 1) >> 2);
                    row[2 * dw - 1] = uint8_t(P(y, dw - 1));
                } else {
                    for (int i = 0; i < dw; ++i) row[2 * i] = row[2 * i + 1] = uint8_t(P(y, i));
                }
                memcpy(full + size_t(y) * W, row.data(), W);
            }
        } else if (c.h == max_h && c.v * 2 == max_v) {  // h1v2_fancy_upsample
            for (int y = 0; y < H; ++y) {
                int r = y >> 1, v = y & 1;
                int nb = v == 0 ? (r > 0 ? r - 1 : 0) : (r + 1 < dh ? r + 1 : dh - 1);
                int bias = v == 0 ? 1 : 2;
                for (int x = 0; x < W; ++x)
                    full[size_t(y) * W + x] = uint8_t((P(r, x) * 3 + P(nb, x) + bias) >> 2);
            }
        } else if (c.h * 2 == max_h && c.v * 2 == max_v) {
            std::vector<int> cs(dw);
            std::vector<uint8_t> row(2 * size_t(dw));
            for (int y = 0; y < H; ++y) {
                int r = y >> 1, v = y & 1;
                if (dw > 2) {  // h2v2_fancy_upsample
                    int nb = v == 0 ? (r > 0 ? r - 1 : 0) : (r + 1 < dh ? r + 1 : dh - 1);
                    for (int i = 0; i < dw; ++i) cs[i] = P(r, i) * 3 + P(nb, i);
                    row[0] = uint8_t((cs[0] * 4 + 8) >> 4);
                    row[1] = uint8_t((cs[0] * 3 + cs[1] + 7) >> 4);
                    for (int i = 1; i < dw - 1; ++i) {
                        row[2 * i] = uint8_t((cs[i] * 3 + cs[i - 1] + 8) >> 4);
                        row[2 * i + 1] = uint8_t((cs[i] * 3 + cs[i + 1] + 7) >> 4);
                    }
                    row[2 * (dw - 1)] = uint8_t((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
                    row[2 * dw - 1] = uint8_t((cs[dw - 1] * 4 + 7) >> 4);
                } else {
                    for (int i = 0; i < dw; ++i) row[2 * i] = row[2 * i + 1] = uint8_t(P(r, i));
                }
                memcpy(full + size_t(y) * W, row.data(), W);
            }
        } else if (max_h % c.h == 0 && max_v % c.v == 0) {  // int_upsample
            int he = max_h / c.h, ve = max_v / c.v;
            for (int y = 0; y < H; ++y)
                for (int x = 0; x < W; ++x)
                    full[size_t(y) * W + x] = uint8_t(P(y / ve, x / he));
        } else {
            return -1;
        }
        return 0;
    }

    // samples of the frame into out (height x width x ncomp)
    int render(uint8_t* out) {
        init_tables();
        std::vector<std::vector<uint8_t>> fulls(ncomp);
        for (int ci = 0; ci < ncomp; ++ci) {
            Component& c = comp[ci];
            if (!c.latched)
                return fail(kCorrupt, "a component appears in no scan");
            int ps = c.width_in_blocks * 8;
            std::vector<uint8_t> plane(size_t(ps) * c.height_in_blocks * 8);
            for (int by = 0; by < c.height_in_blocks; ++by)
                for (int bx = 0; bx < c.width_in_blocks; ++bx)
                    idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant,
                               &plane[size_t(by) * 8 * ps + bx * 8], ps);
            fulls[ci].resize(size_t(width) * height);
            if (upsample(c, plane.data(), ps, fulls[ci].data()))
                return fail(kCorrupt, "fractional sampling factors are not "
                            "supported");
        }
        const size_t np = size_t(width) * height;
        if (ncomp == 1) {
            memcpy(out, fulls[0].data(), np);
            return kOk;
        }
        bool ycc;
        if (saw_jfif) ycc = true;
        else if (saw_adobe) ycc = adobe_transform != 0;
        else ycc = !(comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66);
        const uint8_t *y = fulls[0].data(), *cb = fulls[1].data(), *cr = fulls[2].data();
        for (size_t i = 0; i < np; ++i) {
            if (ycc) {
                int Y = y[i];
                out[3 * i] = clamp255(Y + g_cr_r[cr[i]]);
                out[3 * i + 1] = clamp255(Y + int((g_cb_g[cb[i]] + g_cr_g[cr[i]]) >> 16));
                out[3 * i + 2] = clamp255(Y + g_cb_b[cb[i]]);
            } else {
                out[3 * i] = y[i];
                out[3 * i + 1] = cb[i];
                out[3 * i + 2] = cr[i];
            }
        }
        return kOk;
    }
};

void copy_err(const std::string& e, char* buf, int len) {
    if (!buf || len <= 0) return;
    size_t k = e.size() < size_t(len - 1) ? e.size() : size_t(len - 1);
    memcpy(buf, e.data(), k);
    buf[k] = 0;
}

// ---------------------------------------------------------------- encode

struct BitWriter {
    uint8_t* out;
    uint64_t cap, pos = 0;
    uint64_t buf = 0;
    int bits = 0;
    bool overflow = false;
    void byte(uint8_t b) {
        if (pos < cap) out[pos++] = b; else overflow = true;
    }
    void put(unsigned code, int size) {
        buf = (buf << size) | (code & ((1u << size) - 1));
        bits += size;
        while (bits >= 8) {
            bits -= 8;
            uint8_t b = uint8_t(buf >> bits);
            byte(b);
            if (b == 0xFF) byte(0);
        }
    }
    void flush() {  // jchuff.c:flush_bits: pad with ones
        if (bits) put(0x7F, 7);
        bits = 0;
    }
};

struct HuffCode { unsigned code[256]; int size[256]; };

void make_codes(const uint8_t* bits, const uint8_t* vals, HuffCode& hc) {
    memset(hc.size, 0, sizeof(hc.size));
    memset(hc.code, 0, sizeof(hc.code));
    unsigned code = 0;
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < bits[l]; ++i) {
            hc.code[vals[p]] = code++;
            hc.size[vals[p]] = l;
            ++p;
        }
        code <<= 1;
    }
}

// jfdctint.c:jpeg_fdct_islow, in place, on samples minus 128
void fdct_islow(int* d) {
    for (int r = 0; r < 8; ++r) {
        int* p = d + 8 * r;
        JLONG tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
        JLONG tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
        JLONG tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
        JLONG tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
        JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = int((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4] = int((tmp10 - tmp11) * (1 << PASS1_BITS));
        JLONG z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[2] = int(descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS));
        p[6] = int(descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS));
        z1 = tmp4 + tmp7;
        JLONG z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        JLONG z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 *= FIX_0_298631336;
        tmp5 *= FIX_2_053119869;
        tmp6 *= FIX_3_072711026;
        tmp7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        p[7] = int(descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS));
        p[5] = int(descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS));
        p[3] = int(descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS));
        p[1] = int(descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS));
    }
    for (int c = 0; c < 8; ++c) {
        int* p = d + c;
        JLONG tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
        JLONG tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
        JLONG tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
        JLONG tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
        JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = int(descale(tmp10 + tmp11, PASS1_BITS));
        p[32] = int(descale(tmp10 - tmp11, PASS1_BITS));
        JLONG z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[16] = int(descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS));
        p[48] = int(descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS));
        z1 = tmp4 + tmp7;
        JLONG z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        JLONG z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 *= FIX_0_298631336;
        tmp5 *= FIX_2_053119869;
        tmp6 *= FIX_3_072711026;
        tmp7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        p[56] = int(descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS));
        p[40] = int(descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS));
        p[24] = int(descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS));
        p[8] = int(descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS));
    }
}

// jcdctmgr.c:compute_reciprocal with a 16-bit DCTELEM
struct Divisor { uint32_t recip, corr; int shift; };

Divisor reciprocal(unsigned divisor) {
    Divisor d;
    if (divisor == 1) { d.recip = 1; d.corr = 0; d.shift = 0; return d; }
    int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
    int r = 16 + b;
    uint64_t fq = (uint64_t(1) << r) / divisor;
    uint64_t fr = (uint64_t(1) << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) { fq >>= 1; --r; }
    else if (fr <= divisor / 2u) ++c;
    else ++fq;
    d.recip = uint32_t(fq & 0xFFFF);
    d.corr = c & 0xFFFF;
    d.shift = r;
    return d;
}

inline int quantize(int x, const Divisor& d) {
    if (d.recip == 1 && d.shift == 0) return x;
    uint32_t t = uint32_t(x < 0 ? -x : x);
    uint32_t q = uint32_t((uint64_t(t + d.corr) * d.recip) >> d.shift);
    return x < 0 ? -int(q) : int(q);
}

void put_marker(BitWriter& w, int m) { w.byte(0xFF); w.byte(uint8_t(m)); }
void put_u16(BitWriter& w, int v) { w.byte(uint8_t(v >> 8)); w.byte(uint8_t(v)); }

void put_dht(BitWriter& w, int index, const uint8_t* bits, const uint8_t* vals) {
    int n = 0;
    for (int l = 1; l <= 16; ++l) n += bits[l];
    put_marker(w, 0xC4);
    put_u16(w, 2 + 1 + 16 + n);
    w.byte(uint8_t(index));
    for (int l = 1; l <= 16; ++l) w.byte(bits[l]);
    for (int i = 0; i < n; ++i) w.byte(vals[i]);
}

}  // namespace

extern "C" {

// (height, width, components) of a JPEG from its markers up to the first
// SOS. Returns 0 or an error code (-1 truncated, -2 corrupt,
// -3 unsupported) with a message in err.
int fc_jpeg_header(const uint8_t* data, uint64_t n, int32_t* dims,
                   char* err, int errlen) {
    Decoder d;
    d.data = data;
    d.n = n;
    int rc = d.run(true);
    if (rc == kOk && !d.saw_sof) rc = d.fail(kCorrupt, "no SOF marker");
    if (rc != kOk) { copy_err(d.err, err, errlen); return rc; }
    dims[0] = d.height;
    dims[1] = d.width;
    dims[2] = d.ncomp;
    return kOk;
}

// Decode into out (height * width * components bytes, the size
// fc_jpeg_header gives). Returns 0 or an error code.
int fc_jpeg_decode(const uint8_t* data, uint64_t n, uint8_t* out,
                   uint64_t out_len, char* err, int errlen) {
    Decoder d;
    d.data = data;
    d.n = n;
    int rc = d.run(false);
    if (rc == kOk && uint64_t(d.width) * d.height * d.ncomp != out_len)
        rc = d.fail(kCorrupt, "output size does not match the frame");
    if (rc == kOk) rc = d.render(out);
    if (rc != kOk) copy_err(d.err, err, errlen);
    return rc;
}

// Encode height x width x nc (1 or 3) uint8 pixels as PIL's
// save(format="JPEG", quality=quality) does: grey, or YCbCr with 2x2
// luma and 1x1 chroma sampling (4:2:0). Returns the bytes written, or
// -4 when cap is too small, -2 for bad arguments.
int64_t fc_jpeg_encode(const uint8_t* pix, int height, int width, int nc,
                       int quality, uint8_t* out, uint64_t cap) {
    if ((nc != 1 && nc != 3) || height < 1 || width < 1 || height > 65500 ||
        width > 65500)
        return kCorrupt;
    init_tables();
    // jcparam.c: jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
    if (quality <= 0) quality = 1;
    if (quality > 100) quality = 100;
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    unsigned qt[2][64];
    for (int t = 0; t < 2; ++t)
        for (int i = 0; i < 64; ++i) {
            long v = (long(t ? kStdChrQuant[i] : kStdLumQuant[i]) * scale + 50L) / 100L;
            if (v <= 0) v = 1;
            if (v > 32767) v = 32767;
            if (v > 255) v = 255;
            qt[t][i] = unsigned(v);
        }
    const int hs[3] = {nc == 3 ? 2 : 1, 1, 1};
    const int* vs = hs;
    const int max_h = hs[0], max_v = vs[0];

    BitWriter w{out, cap};
    put_marker(w, 0xD8);
    // JFIF APP0: version 1.01, density unit 0, density 1:1, no thumbnail
    put_marker(w, 0xE0);
    put_u16(w, 16);
    const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    for (uint8_t b : jfif) w.byte(b);
    for (int t = 0; t < (nc == 3 ? 2 : 1); ++t) {
        put_marker(w, 0xDB);
        put_u16(w, 67);
        w.byte(uint8_t(t));
        for (int i = 0; i < 64; ++i) w.byte(uint8_t(qt[t][kNatural[i]]));
    }
    put_marker(w, 0xC0);
    put_u16(w, 8 + 3 * nc);
    w.byte(8);
    put_u16(w, height);
    put_u16(w, width);
    w.byte(uint8_t(nc));
    for (int c = 0; c < nc; ++c) {
        w.byte(uint8_t(c + 1));
        w.byte(uint8_t((hs[c] << 4) | vs[c]));
        w.byte(uint8_t(c ? 1 : 0));
    }
    put_dht(w, 0x00, kBitsDcLum, kValDc);
    put_dht(w, 0x10, kBitsAcLum, kValAcLum);
    if (nc == 3) {
        put_dht(w, 0x01, kBitsDcChr, kValDc);
        put_dht(w, 0x11, kBitsAcChr, kValAcChr);
    }
    put_marker(w, 0xDA);
    put_u16(w, 6 + 2 * nc);
    w.byte(uint8_t(nc));
    for (int c = 0; c < nc; ++c) {
        w.byte(uint8_t(c + 1));
        w.byte(uint8_t(c ? 0x11 : 0x00));
    }
    w.byte(0);
    w.byte(63);
    w.byte(0);

    // colour conversion (jccolor.c), full resolution, padded to a whole
    // number of row groups (max_v) and of downsampled blocks
    const int mcus_per_row = (width + 8 * max_h - 1) / (8 * max_h);
    const int mcu_rows = (height + 8 * max_v - 1) / (8 * max_v);
    std::vector<std::vector<uint8_t>> planes(nc);
    std::vector<int> pw(nc), ph(nc), wib(nc), hib(nc);
    const int frows = (height + max_v - 1) / max_v * max_v;
    for (int c = 0; c < nc; ++c) {
        wib[c] = int((long(width) * hs[c] + 8 * max_h - 1) / (8 * max_h));
        hib[c] = int((long(height) * vs[c] + 8 * max_v - 1) / (8 * max_v));
        int he = max_h / hs[c], ve = max_v / vs[c];
        int out_cols = wib[c] * 8;
        int fcols = out_cols * he;
        std::vector<uint8_t> full(size_t(frows) * fcols);
        for (int y = 0; y < frows; ++y) {
            int sy = y < height ? y : height - 1;
            for (int x = 0; x < fcols; ++x) {
                int sx = x < width ? x : width - 1;
                const uint8_t* p = pix + (size_t(sy) * width + sx) * nc;
                uint8_t v;
                if (nc == 1) {
                    v = p[0];
                } else {
                    int r = p[0], g = p[1], b = p[2];
                    const JLONG* t = g_rgb_ycc;
                    if (c == 0) v = uint8_t((t[r] + t[g + 256] + t[b + 512]) >> 16);
                    else if (c == 1) v = uint8_t((t[r + 768] + t[g + 1024] + t[b + 1280]) >> 16);
                    else v = uint8_t((t[r + 1280] + t[g + 1536] + t[b + 1792]) >> 16);
                }
                full[size_t(y) * fcols + x] = v;
            }
        }
        // jcsample.c downsampling (fullsize or h2v2) into rows of out_cols
        int drows = frows / ve;
        int prow = std::max(drows, mcu_rows * vs[c] * 8);
        std::vector<uint8_t> ds(size_t(prow) * out_cols);
        for (int oy = 0; oy < drows; ++oy)
            for (int ox = 0; ox < out_cols; ++ox) {
                const uint8_t* r0 = &full[size_t(oy * ve) * fcols + ox * he];
                int v = r0[0];
                if (he == 2) {  // bias 1, 2, 1, 2, ... along the row
                    const uint8_t* r1 = r0 + fcols;
                    v = (r0[0] + r0[1] + r1[0] + r1[1] + 1 + (ox & 1)) >> 2;
                }
                ds[size_t(oy) * out_cols + ox] = uint8_t(v);
            }
        for (int oy = drows; oy < prow; ++oy)  // jcprepct.c bottom edge
            memcpy(&ds[size_t(oy) * out_cols], &ds[size_t(drows - 1) * out_cols], out_cols);
        planes[c].swap(ds);
        pw[c] = out_cols;
        ph[c] = prow;
    }

    HuffCode dcc[2], acc[2];
    make_codes(kBitsDcLum, kValDc, dcc[0]);
    make_codes(kBitsAcLum, kValAcLum, acc[0]);
    make_codes(kBitsDcChr, kValDc, dcc[1]);
    make_codes(kBitsAcChr, kValAcChr, acc[1]);
    Divisor div[2][64];
    for (int t = 0; t < 2; ++t)
        for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(qt[t][i] << 3);

    int last_dc[3] = {0, 0, 0};
    auto encode_block = [&](int c, const int* q) {
        int t = c ? 1 : 0;
        int temp = q[0] - last_dc[c], temp2 = temp;
        last_dc[c] = q[0];
        if (temp < 0) { temp = -temp; --temp2; }
        int nbits = 0;
        while (temp) { ++nbits; temp >>= 1; }
        w.put(dcc[t].code[nbits], dcc[t].size[nbits]);
        if (nbits) w.put(unsigned(temp2), nbits);
        int r = 0;
        for (int k = 1; k < 64; ++k) {
            temp = q[kNatural[k]];
            if (temp == 0) { ++r; continue; }
            while (r > 15) { w.put(acc[t].code[0xF0], acc[t].size[0xF0]); r -= 16; }
            temp2 = temp;
            if (temp < 0) { temp = -temp; --temp2; }
            nbits = 1;
            while ((temp >>= 1)) ++nbits;
            int s = (r << 4) + nbits;
            w.put(acc[t].code[s], acc[t].size[s]);
            w.put(unsigned(temp2), nbits);
            r = 0;
        }
        if (r > 0) w.put(acc[t].code[0], acc[t].size[0]);
    };
    auto forward = [&](int c, int by, int bx, int* q) {
        int ws[64];
        const uint8_t* src = &planes[c][size_t(by) * 8 * pw[c] + bx * 8];
        for (int y = 0; y < 8; ++y)
            for (int x = 0; x < 8; ++x) ws[8 * y + x] = int(src[size_t(y) * pw[c] + x]) - 128;
        fdct_islow(ws);
        const Divisor* dv = div[c ? 1 : 0];
        for (int i = 0; i < 64; ++i) q[i] = quantize(ws[i], dv[i]);
    };

    int q[64], prev[64];
    if (nc == 1) {  // one component: a non-interleaved scan, no dummies
        for (int by = 0; by < hib[0]; ++by)
            for (int bx = 0; bx < wib[0]; ++bx) {
                forward(0, by, bx, q);
                encode_block(0, q);
            }
    } else {
        std::vector<int> mcu_dc(16);
        for (int my = 0; my < mcu_rows; ++my)
            for (int mx = 0; mx < mcus_per_row; ++mx)
                for (int c = 0; c < nc; ++c) {
                    int last_col = wib[c] % hs[c] ? wib[c] % hs[c] : hs[c];
                    int last_row = hib[c] % vs[c] ? hib[c] % vs[c] : vs[c];
                    int blockcnt = mx < mcus_per_row - 1 ? hs[c] : last_col;
                    // DC of the MCU's blocks, in order, for the dummies
                    int k = 0;
                    for (int y = 0; y < vs[c]; ++y) {
                        if (my < mcu_rows - 1 || y < last_row) {
                            for (int x = 0; x < blockcnt; ++x) {
                                forward(c, my * vs[c] + y, mx * hs[c] + x, q);
                                encode_block(c, q);
                                mcu_dc[k++] = q[0];
                            }
                            for (int x = blockcnt; x < hs[c]; ++x) {
                                memset(prev, 0, sizeof(prev));
                                prev[0] = mcu_dc[k - 1];
                                encode_block(c, prev);
                                mcu_dc[k++] = prev[0];
                            }
                        } else {
                            int dcv = mcu_dc[k - 1];
                            for (int x = 0; x < hs[c]; ++x) {
                                memset(prev, 0, sizeof(prev));
                                prev[0] = dcv;
                                encode_block(c, prev);
                                mcu_dc[k++] = dcv;
                            }
                        }
                    }
                }
    }
    w.flush();
    put_marker(w, 0xD9);
    if (w.overflow) return kTooSmall;
    return int64_t(w.pos);
}

}  // extern "C"
