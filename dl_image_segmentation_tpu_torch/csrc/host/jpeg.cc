// JPEG decoder and baseline encoder, built with g++ at first use and
// called through ctypes (raster/jpeg.py), which releases the GIL.
//
// Both follow libjpeg-turbo's default paths step for step, so that the
// decoder's pixels equal those of PIL's default decode (libjpeg-turbo 3:
// islow IDCT, fancy upsampling, integer YCbCr->RGB) bit for bit, and the
// encoder's bytes equal PIL's `save(format="JPEG", quality=q)`:
//
//   decode  markers as jdmarker.c reads them (fill bytes, APP0 JFIF and
//           APP14 Adobe detection, DRI/RSTn and jpeg_resync_to_restart,
//           DAC), Huffman decoding as jdhuff.c (its 57-bit read-ahead and
//           8-bit lookahead, standard tables for a missing table 0/1,
//           zeros after an early marker), progressive scans as jdphuff.c
//           (DC first and refine, AC first and refine with EOB runs),
//           arithmetic decoding as jdarith.c (T.81 Annex D's QM coder,
//           sequential and progressive, statistics reset at restarts),
//           lossless frames as jdlhuff.c, jddiffct.c and jdlossls.c
//           (predictors 1-7, point transform, restarts at MCU rows),
//           jidctint.c's jpeg_idct_islow with its range-limit table, the
//           upsampler jdsample.c:jinit_upsampler picks per component
//           (h2v1, h1v2 and h2v2 triangle filters, box replication; box
//           only for lossless frames) with jdmainct.c's edge rows,
//           jdcolor.c's tables (YCbCr->RGB, YCCK->CMYK), and the colour
//           space guess of jdapimin.c:default_decompress_parms.
//   encode  jcparam.c's quality scaling with force_baseline, jccolor.c's
//           RGB->YCbCr tables, jcsample.c's h2v2 downsampler with its
//           alternating bias and jcprepct.c's edge replication,
//           jfdctint.c's jpeg_fdct_islow, jcdctmgr.c's reciprocal
//           quantizer (16-bit DCTELEM, as libjpeg-turbo's SIMD builds),
//           jccoefct.c's dummy blocks, and jchuff.c's standard tables,
//           byte stuffing and 1-bit padding; markers in jcmarker.c's order.
//
// Scope of the decoder: what PIL opens, 8-bit frames of 1, 3 or 4
// components (SOF0-3, SOF9, SOF10), any sampling factors libjpeg-turbo
// accepts. Where PIL refuses a file, so does the decoder, with kCorrupt:
// other precisions, 2 or more than 4 components, hierarchical frames,
// arithmetic lossless, colour conversion of a lossless frame, and an
// arithmetic scan past the 64 KiB blocks PIL feeds libjpeg. A
// progressive file that libjpeg-turbo would block-smooth returns
// kUnsupported. Every read is bounded by the data length.

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

bool derive(HuffTable& t, bool is_dc, bool lossless = false) {
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
    if (is_dc)  // 0..15 in lossy frames, 0..16 in lossless ones
        for (int i = 0; i < numsymbols; ++i)
            if (t.huffval[i] > (lossless ? 16 : 15)) return false;
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
    int coef_bits[64];            // jdphuff.c: -1 until a scan sends it
    // lossless: bw * bh samples, and the undifferencer's state
    std::vector<uint8_t> samples;
    std::vector<uint16_t> undiff;  // the previous row (jddiffct.c undiff_buf)
    bool first_row = true;
    // arithmetic decoding state of this component in the current scan
    int dc_context = 0;
};

// jaricom.c: T.81 Table D.2, as (Qe << 16) | (Next_Index_MPS << 8) |
// (Switch_MPS << 7) | Next_Index_LPS; the last entry is the fixed 0.5
// estimate of T.851 that sign bits and refinements use
#define V(i, a, b, c, d) ((JLONG(a) << 16) | (JLONG(c) << 8) | (JLONG(d) << 7) | (b))
const JLONG kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),       V(1, 0x2586, 14, 2, 0),
    V(2, 0x1114, 16, 3, 0),      V(3, 0x080b, 18, 4, 0),
    V(4, 0x03d8, 20, 5, 0),      V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),      V(7, 0x006f, 28, 8, 0),
    V(8, 0x0036, 30, 9, 0),      V(9, 0x001a, 33, 10, 0),
    V(10, 0x000d, 35, 11, 0),    V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),    V(13, 0x0001, 12, 13, 0),
    V(14, 0x5a7f, 15, 15, 1),    V(15, 0x3f25, 36, 16, 0),
    V(16, 0x2cf2, 38, 17, 0),    V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),    V(19, 0x1182, 42, 20, 0),
    V(20, 0x0cef, 43, 21, 0),    V(21, 0x09a1, 45, 22, 0),
    V(22, 0x072f, 46, 23, 0),    V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),    V(25, 0x0303, 51, 26, 0),
    V(26, 0x0240, 52, 27, 0),    V(27, 0x01b1, 54, 28, 0),
    V(28, 0x0144, 56, 29, 0),    V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),    V(31, 0x008a, 60, 32, 0),
    V(32, 0x0068, 62, 33, 0),    V(33, 0x004e, 63, 34, 0),
    V(34, 0x003b, 32, 35, 0),    V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),    V(37, 0x484c, 64, 38, 0),
    V(38, 0x3a0d, 65, 39, 0),    V(39, 0x2ef1, 67, 40, 0),
    V(40, 0x261f, 68, 41, 0),    V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),    V(43, 0x1518, 72, 44, 0),
    V(44, 0x1177, 73, 45, 0),    V(45, 0x0e74, 74, 46, 0),
    V(46, 0x0bfb, 75, 47, 0),    V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),    V(49, 0x0706, 79, 50, 0),
    V(50, 0x05cd, 48, 51, 0),    V(51, 0x04de, 50, 52, 0),
    V(52, 0x040f, 50, 53, 0),    V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),    V(55, 0x025c, 53, 56, 0),
    V(56, 0x01f8, 54, 57, 0),    V(57, 0x01a4, 55, 58, 0),
    V(58, 0x0160, 56, 59, 0),    V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),    V(61, 0x00cb, 59, 62, 0),
    V(62, 0x00ab, 61, 63, 0),    V(63, 0x008f, 61, 32, 0),
    V(64, 0x5b12, 65, 65, 1),    V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),    V(67, 0x37d8, 82, 68, 0),
    V(68, 0x2fe8, 83, 69, 0),    V(69, 0x293c, 84, 70, 0),
    V(70, 0x2379, 86, 71, 0),    V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),    V(73, 0x174e, 72, 74, 0),
    V(74, 0x1424, 72, 75, 0),    V(75, 0x119c, 74, 76, 0),
    V(76, 0x0f6b, 74, 77, 0),    V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),    V(79, 0x0a40, 77, 48, 0),
    V(80, 0x5832, 80, 81, 1),    V(81, 0x4d1c, 88, 82, 0),
    V(82, 0x438e, 89, 83, 0),    V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),    V(85, 0x2eae, 92, 86, 0),
    V(86, 0x299a, 93, 87, 0),    V(87, 0x2516, 86, 71, 0),
    V(88, 0x5570, 88, 89, 1),    V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),    V(91, 0x3e22, 97, 92, 0),
    V(92, 0x3824, 99, 93, 0),    V(93, 0x32b4, 99, 94, 0),
    V(94, 0x2e17, 93, 86, 0),    V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),   V(97, 0x47e5, 102, 98, 0),
    V(98, 0x41cf, 103, 99, 0),   V(99, 0x3c3d, 104, 100, 0),
    V(100, 0x375e, 99, 93, 0),   V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0),
    V(104, 0x415e, 103, 99, 0),  V(105, 0x5627, 105, 106, 1),
    V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0),
    V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
    V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

// PIL feeds libjpeg 64 KiB at a time (ImageFile.MAXBLOCK), and libjpeg's
// arithmetic decoder cannot suspend (jdarith.c:get_byte): an arithmetic
// scan that needs a byte past the data PIL has handed over so far fails
// with "broken data stream". The port fails where PIL does.
const uint64_t kPilBlock = 65536;

enum Coding { kSeqHuff, kProgHuff, kLossless, kSeqArith, kProgArith };

struct Decoder {
    const uint8_t* data;
    uint64_t n;
    uint64_t pos = 0;
    int unread_marker = 0;
    std::string err;

    bool saw_sof = false, saw_jfif = false, saw_adobe = false;
    int adobe_transform = 0;
    int precision = 8, width = 0, height = 0, ncomp = 0;
    int coding = kSeqHuff;
    int unit = 8;                 // samples per block side (1: lossless)
    int max_h = 1, max_v = 1;
    int mcus_per_row = 0, mcu_rows = 0;
    int restart_interval = 0;
    Component comp[4];
    uint16_t qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    HuffTable dc[4], ac[4];
    // jdmarker.c: DAC conditioning, and its defaults
    uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
    int scans = 0;
    bool multi_scan = false;      // jdinput.c: has_multiple_scans

    // bit reader
    uint64_t bitbuf = 0;
    int bits_left = 0;
    bool insufficient = false;

    // arithmetic decoder (jdarith.c)
    JLONG ac_c = 0, ac_a = 0;
    int ac_ct = 0;
    uint8_t dc_stats[16][64], ac_stats[16][256];
    uint8_t fixed_bin[1] = {113};  // jdarith.c: the fixed 0.5 estimate
    uint64_t limit = kPilBlock;   // the bytes PIL has handed over
    bool arith_short = false;     // an arithmetic scan ran past them

    Decoder() {
        for (int i = 0; i < 16; ++i) {
            arith_dc_L[i] = 0;
            arith_dc_U[i] = 1;
            arith_ac_K[i] = 5;
        }
    }

    int fail(int code, const char* msg) {
        if (err.empty()) err = msg;
        return code;
    }

    // the marker reader suspends when PIL's data ends inside a marker
    // segment; PIL then hands over its next 64 KiB
    void touch(uint64_t end) {
        while (end > limit) limit += kPilBlock;
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

    // ---- bit reader (jdhuff.c jpeg_fill_bit_buffer semantics). A fill
    // reads ahead to 57 bits (MIN_GET_BITS of a 64-bit buffer) or to a
    // marker, and runs when a code needs more bits than are buffered or
    // fewer than 8 (HUFF_LOOKAHEAD) remain; where the data ends first,
    // libjpeg suspends and PIL, with nothing more to hand over, reports a
    // truncated file. Past a marker it reads zero bits.
    bool fill(int nbits) {
        if (unread_marker == 0) {
            while (bits_left < 57) {
                if (pos >= n) return false;
                int c = data[pos++];
                if (c == 0xFF) {
                    do {
                        if (pos >= n) return false;
                        c = data[pos++];
                    } while (c == 0xFF);
                    if (c == 0) {
                        c = 0xFF;
                    } else {
                        unread_marker = c;
                        break;
                    }
                }
                bitbuf = (bitbuf << 8) | uint64_t(c);
                bits_left += 8;
            }
            if (unread_marker == 0) return true;
        }
        if (nbits > bits_left) {
            insufficient = true;
            bitbuf <<= 57 - bits_left;
            bits_left = 57;
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

    // jdhuff.h HUFF_DECODE: an 8-bit lookahead, then jpeg_huff_decode
    inline bool decode_sym(const HuffTable& t, int& sym) {
        int l = 1;
        if (bits_left < 8) {
            if (!fill(0)) return false;
        }
        if (bits_left >= 8) {
            int look = int((bitbuf >> (bits_left - 8)) & 0xFF);
            for (; l <= 8; ++l)
                if (JLONG(look >> (8 - l)) <= t.maxcode[l]) break;
            if (l <= 8) {
                bits_left -= l;
                JLONG idx = JLONG(look >> (8 - l)) + t.valoffset[l];
                sym = (idx >= 0 && idx < 256) ? t.huffval[idx] : 0;
                return true;
            }
            l = 9;  // a longer code: jpeg_huff_decode from 9 bits
        }
        int code;
        if (!get_bits(l, code)) return false;
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

    // ---- progressive Huffman (jdphuff.c); kCorrupt on a DC overflow
    int Ss = 0, Se = 63, Ah = 0, Al = 0;
    unsigned eobrun = 0;

    int dc_first(Component& c, int16_t* block) {
        int s, r;
        if (!decode_sym(dc[c.dc_tbl], s)) return kTruncated;
        if (s) {
            if (!get_bits(s, r)) return kTruncated;
            s = extend(r, s);
        }
        if ((c.last_dc >= 0 && s > INT32_MAX - c.last_dc) ||
            (c.last_dc < 0 && s < INT32_MIN - c.last_dc))
            return fail(kCorrupt, "bogus DCT coefficient (DC overflow)");
        s += c.last_dc;
        c.last_dc = s;
        block[0] = int16_t(unsigned(s) << Al);
        return kOk;
    }

    bool dc_refine(int16_t* block) {
        int b;
        if (!get_bits(1, b)) return false;
        if (b) block[0] = int16_t(block[0] | (1 << Al));
        return true;
    }

    bool ac_first(const HuffTable& t, int16_t* block) {
        if (eobrun > 0) { --eobrun; return true; }
        for (int k = Ss; k <= Se; ++k) {
            int s, r;
            if (!decode_sym(t, s)) return false;
            r = s >> 4;
            s &= 15;
            if (s) {
                k += r;
                int v;
                if (!get_bits(s, v)) return false;
                block[kNatural[k]] = int16_t(unsigned(extend(v, s)) << Al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = 1u << r;
                if (r) {
                    if (!get_bits(r, r)) return false;
                    eobrun += r;
                }
                --eobrun;
                break;
            }
        }
        return true;
    }

    bool ac_refine(const HuffTable& t, int16_t* block) {
        const int p1 = 1 << Al, m1 = int(unsigned(-1) << Al);
        int k = Ss;
        auto correct = [&](int16_t& coef) -> bool {
            int b;
            if (!get_bits(1, b)) return false;
            if (b && (coef & p1) == 0)
                coef = int16_t(coef >= 0 ? coef + p1 : coef + m1);
            return true;
        };
        if (eobrun == 0) {
            for (; k <= Se; ++k) {
                int s, r;
                if (!decode_sym(t, s)) return false;
                r = s >> 4;
                s &= 15;
                if (s) {
                    int b;
                    if (!get_bits(1, b)) return false;
                    s = b ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1u << r;
                    if (r) {
                        if (!get_bits(r, r)) return false;
                        eobrun += r;
                    }
                    break;
                }
                do {
                    int16_t& coef = block[kNatural[k]];
                    if (coef != 0) {
                        if (!correct(coef)) return false;
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= Se);
                if (s) block[kNatural[k]] = int16_t(s);
            }
        }
        if (eobrun > 0) {
            for (; k <= Se; ++k) {
                int16_t& coef = block[kNatural[k]];
                if (coef != 0 && !correct(coef)) return false;
            }
            --eobrun;
        }
        return true;
    }

    // ---- arithmetic decoding (jdarith.c); an error sets ac_ct = -1
    int arith_byte() {
        if (pos >= limit || pos >= n) {
            arith_short = true;   // libjpeg: JERR_CANT_SUSPEND
            return 0;
        }
        return data[pos++];
    }

    int arith_decode(uint8_t* st) {
        while (ac_a < 0x8000L) {
            if (--ac_ct < 0) {
                int d;
                if (unread_marker) {
                    d = 0;
                } else {
                    d = arith_byte();
                    if (d == 0xFF) {
                        do d = arith_byte();
                        while (d == 0xFF && !arith_short);
                        if (d == 0) {
                            d = 0xFF;
                        } else {
                            unread_marker = d;
                            d = 0;
                        }
                    }
                }
                ac_c = (ac_c << 8) | d;
                if ((ac_ct += 8) < 0)
                    if (++ac_ct == 0) ac_a = 0x8000L;
            }
            ac_a <<= 1;
        }
        int sv = *st;
        JLONG qe = kAritab[sv & 0x7F];
        uint8_t nl = uint8_t(qe & 0xFF);
        qe >>= 8;
        uint8_t nm = uint8_t(qe & 0xFF);
        qe >>= 8;
        JLONG temp = ac_a - qe;
        ac_a = temp;
        temp <<= ac_ct;
        if (ac_c >= temp) {
            ac_c -= temp;
            if (ac_a < qe) {
                ac_a = qe;
                *st = uint8_t((sv & 0x80) ^ nm);
            } else {
                ac_a = qe;
                *st = uint8_t((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (ac_a < 0x8000L) {
            if (ac_a < qe) {
                *st = uint8_t((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = uint8_t((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }

    // Figures F.19-F.24: a DC difference with its conditioning; false on
    // a magnitude overflow
    bool arith_dc_diff(Component& c, int& v) {
        int tbl = c.dc_tbl;
        uint8_t* st = dc_stats[tbl] + c.dc_context;
        v = 0;
        if (arith_decode(st) == 0) {
            c.dc_context = 0;
            return true;
        }
        int sign = arith_decode(st + 1);
        st += 2 + sign;
        int m = arith_decode(st);
        if (m != 0) {
            st = dc_stats[tbl] + 20;
            while (arith_decode(st)) {
                if ((m <<= 1) == 0x8000) return false;
                st += 1;
            }
        }
        if (m < int((1L << arith_dc_L[tbl]) >> 1))
            c.dc_context = 0;
        else if (m > int((1L << arith_dc_U[tbl]) >> 1))
            c.dc_context = 12 + sign * 4;
        else
            c.dc_context = 4 + sign * 4;
        v = m;
        st += 14;
        while (m >>= 1)
            if (arith_decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        return true;
    }

    // AC coefficients Ss..Se of a first (or sequential) pass; false on
    // a spectral or magnitude overflow
    bool arith_ac(int tbl, int16_t* block, int from, int to, int shift) {
        for (int k = from; k <= to; ++k) {
            uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
            if (arith_decode(st)) break;
            while (arith_decode(st + 1) == 0) {
                st += 3;
                if (++k > to) return false;
            }
            int sign = arith_decode(fixed_bin);
            st += 2;
            int m = arith_decode(st);
            if (m != 0 && arith_decode(st)) {
                m <<= 1;
                st = ac_stats[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
                while (arith_decode(st)) {
                    if ((m <<= 1) == 0x8000) return false;
                    st += 1;
                }
            }
            int v = m;
            st += 14;
            while (m >>= 1)
                if (arith_decode(st)) v |= m;
            v += 1;
            if (sign) v = -v;
            block[kNatural[k]] = int16_t(unsigned(v) << shift);
        }
        return true;
    }

    bool arith_ac_refine(int tbl, int16_t* block) {
        const int p1 = 1 << Al, m1 = int(unsigned(-1) << Al);
        int kex;
        for (kex = Se; kex > 0; --kex)
            if (block[kNatural[kex]]) break;
        for (int k = Ss; k <= Se; ++k) {
            uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
            if (k > kex && arith_decode(st)) break;
            for (;;) {
                int16_t& coef = block[kNatural[k]];
                if (coef) {
                    if (arith_decode(st + 2))
                        coef = int16_t(coef < 0 ? coef + m1 : coef + p1);
                    break;
                }
                if (arith_decode(st + 1)) {
                    coef = int16_t(arith_decode(fixed_bin) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++k > Se) return false;
            }
        }
        return true;
    }

    void arith_reset(Component* const* sc, int ns) {
        for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            if (coding != kProgArith || (Ss == 0 && Ah == 0)) {
                memset(dc_stats[c.dc_tbl], 0, 64);
                c.last_dc = 0;
                c.dc_context = 0;
            }
            if (coding != kProgArith || Ss) memset(ac_stats[c.ac_tbl], 0, 256);
        }
        ac_c = 0;
        ac_a = 0;
        ac_ct = -16;
    }

    // jdmarker.c:read_restart_marker + jpeg_resync_to_restart
    bool process_restart(int& next_restart) {
        bits_left = 0;
        if (unread_marker == 0) {
            uint64_t from = pos;
            if (!next_marker()) return false;
            if (coding == kSeqArith || coding == kProgArith) {
                // inside an arithmetic scan PIL cannot hand over more data
                if (pos > limit) {
                    pos = from;
                    arith_short = true;
                    return false;
                }
            }
        }
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
        // PIL opens 8-bit frames of 1, 3 or 4 components, and libjpeg
        // decodes none of the hierarchical frames or arithmetic lossless
        if (precision != 8)
            return fail(kCorrupt, "a sample precision other than 8 bits "
                        "(PIL: cannot handle it)");
        if (ncomp != 1 && ncomp != 3 && ncomp != 4)
            return fail(kCorrupt, "a JPEG of neither 1, 3 nor 4 components "
                        "(PIL: cannot handle it)");
        switch (marker) {
            case 0xC0: case 0xC1: coding = kSeqHuff; break;
            case 0xC2: coding = kProgHuff; break;
            case 0xC3: coding = kLossless; break;
            case 0xC9: coding = kSeqArith; break;
            case 0xCA: coding = kProgArith; break;
            case 0xCB:
                return fail(kCorrupt, "arithmetic-coded lossless frame "
                            "(libjpeg: arithmetic coding is not implemented)");
            default:
                return fail(kCorrupt, "hierarchical (differential) frame "
                            "(libjpeg: unsupported marker type)");
        }
        unit = coding == kLossless ? 1 : 8;
        if (height <= 0 || width <= 0)
            return fail(kCorrupt, "empty JPEG image (DNL not supported)");
        if (length - 8 != ncomp * 3)
            return fail(kCorrupt, "bogus SOF marker length");
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
            for (int k = 0; k < 64; ++k) comp[ci].coef_bits[k] = -1;
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
        const int u = unit;
        mcus_per_row = (width + u * max_h - 1) / (u * max_h);
        mcu_rows = (height + u * max_v - 1) / (u * max_v);
        for (int ci = 0; ci < ncomp; ++ci) {
            Component& c = comp[ci];
            c.width_in_blocks = int((JLONG(width) * c.h + u * max_h - 1) / (u * max_h));
            c.height_in_blocks = int((JLONG(height) * c.v + u * max_v - 1) / (u * max_v));
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

    // jdmarker.c:get_dac
    int read_dac(int length) {
        uint64_t end = pos + length;
        while (pos + 2 <= end) {
            int index = data[pos], val = data[pos + 1];
            pos += 2;
            if (index >= 32) return fail(kCorrupt, "bogus DAC index");
            if (index >= 16) {
                arith_ac_K[index - 16] = uint8_t(val);
            } else {
                arith_dc_L[index] = uint8_t(val & 0x0F);
                arith_dc_U[index] = uint8_t(val >> 4);
                if (arith_dc_L[index] > arith_dc_U[index])
                    return fail(kCorrupt, "bogus DAC value");
            }
        }
        if (pos != end) return fail(kCorrupt, "bogus DAC marker length");
        return kOk;
    }

    int huff_table(bool is_dc, int tbl) {
        HuffTable& t = is_dc ? dc[tbl] : ac[tbl];
        if (!t.defined) {
            if (tbl > 1) return fail(kCorrupt, "Huffman table not defined");
            std_table(t, is_dc, tbl);
        }
        if (!derive(t, is_dc, is_dc && coding == kLossless))
            return fail(kCorrupt, "bogus Huffman table definition");
        return kOk;
    }

    // jdphuff.c / jdarith.c start_pass: the progression checks, and the
    // coefficient bits each scan leaves behind
    int progressive_pass(Component* const* sc, int ns) {
        bool bad = false;
        if (Ss == 0) {
            if (Se != 0) bad = true;
        } else {
            if (Ss > Se || Se > 63) bad = true;
            if (ns != 1) bad = true;
        }
        if (Ah != 0 && Al != Ah - 1) bad = true;
        if (Al > 13) bad = true;
        if (bad) return fail(kCorrupt, "invalid progressive parameters");
        for (int i = 0; i < ns; ++i)
            for (int k = Ss; k <= Se; ++k) sc[i]->coef_bits[k] = Al;
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
        const bool arith = coding == kSeqArith || coding == kProgArith;
        const bool progressive = coding == kProgHuff || coding == kProgArith;
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
            if (!arith && (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3))
                return fail(kCorrupt, "bogus Huffman table index");
        }
        // jdinput.c: a second scan in a file whose first one held every
        // component is an error (JERR_EOI_EXPECTED)
        if (scans > 0 && !multi_scan) return fail(kCorrupt, "EOI expected");
        Ss = data[pos + 1 + 2 * ns];
        Se = data[pos + 2 + 2 * ns];
        Ah = data[pos + 3 + 2 * ns] >> 4;
        Al = data[pos + 3 + 2 * ns] & 15;
        pos = end;
        if (scans++ == 0) multi_scan = ns < ncomp || progressive;
        int blocks_in_mcu = 0;
        for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            blocks_in_mcu += ns == 1 ? 1 : c.h * c.v;
            if (coding == kLossless) {
                if (c.samples.empty())
                    c.samples.assign(size_t(c.width_in_blocks) * c.height_in_blocks, 0);
            } else if (c.coef.empty()) {
                c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
            }
            if (!c.latched && coding != kLossless) {
                if (!qt_defined[c.tq]) return fail(kCorrupt, "quantization table not defined");
                for (int k = 0; k < 64; ++k) c.quant[k] = int16_t(qt[c.tq][k]);
            }
            c.latched = true;
            c.last_dc = 0;
            c.dc_context = 0;
        }
        if (blocks_in_mcu > 10) return fail(kCorrupt, "sampling factors too large");
        if (progressive) {
            int rc = progressive_pass(sc, ns);
            if (rc != kOk) return rc;
        }
        for (int i = 0; i < ns && !arith; ++i) {
            Component& c = *sc[i];
            int rc = kOk;
            if (coding == kSeqHuff) {
                rc = huff_table(true, c.dc_tbl);
                if (rc == kOk) rc = huff_table(false, c.ac_tbl);
            } else if (coding == kLossless) {
                rc = huff_table(true, c.dc_tbl);
            } else if (Ss == 0) {
                if (Ah == 0) rc = huff_table(true, c.dc_tbl);
            } else {
                rc = huff_table(false, c.ac_tbl);
            }
            if (rc != kOk) return rc;
        }
        bits_left = 0;
        insufficient = false;
        eobrun = 0;
        if (arith) arith_reset(sc, ns);
        if (coding == kLossless) return lossless_scan(sc, ns);
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
                if (restart_interval && restarts_to_go == 0) {
                    if (!process_restart(next_restart)) {
                        if (arith_short) return arith_broken();
                        return fail(kTruncated, "image file is truncated");
                    }
                    if (arith) arith_reset(sc, ns);
                    for (int i = 0; i < ns; ++i) sc[i]->last_dc = 0;
                    eobrun = 0;
                    restarts_to_go = restart_interval;
                }
                int rc = arith ? arith_mcu(sc, ns, my, mx) : huff_mcu(sc, ns, my, mx);
                if (rc != kOk) return rc;
                if (restart_interval) --restarts_to_go;
            }
        return kOk;
    }

    int16_t* block_at(Component& c, int ns, int my, int mx, int y, int x) {
        int by = ns == 1 ? my : my * c.v + y;
        int bx = ns == 1 ? mx : mx * c.h + x;
        return &c.coef[(size_t(by) * c.bw + bx) * 64];
    }

    int huff_mcu(Component* const* sc, int ns, int my, int mx) {
        // DC refinements read zeros past a marker and change nothing;
        // every other pass leaves the rest of the segment as it is
        if (insufficient && !(coding == kProgHuff && Ss == 0 && Ah != 0))
            return kOk;
        for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            int nv = ns == 1 ? 1 : c.v, nh = ns == 1 ? 1 : c.h;
            for (int y = 0; y < nv; ++y)
                for (int x = 0; x < nh; ++x) {
                    int16_t* blk = block_at(c, ns, my, mx, y, x);
                    bool ok = true;
                    if (coding == kSeqHuff) {
                        memset(blk, 0, 64 * sizeof(int16_t));
                        ok = decode_block(c, blk);
                    } else if (Ss == 0 && Ah == 0) {
                        int rc = dc_first(c, blk);
                        if (rc == kCorrupt) return rc;
                        ok = rc == kOk;
                    } else if (Ss == 0) {
                        ok = dc_refine(blk);
                    } else if (Ah == 0) {
                        ok = ac_first(ac[c.ac_tbl], blk);
                    } else {
                        ok = ac_refine(ac[c.ac_tbl], blk);
                    }
                    if (!ok) return fail(kTruncated, "image file is truncated");
                }
        }
        return kOk;
    }

    int arith_broken() {
        return fail(kCorrupt, "arithmetic-coded data past the end of the "
                    "data or of the 64 KiB blocks PIL hands libjpeg, which "
                    "cannot suspend there (PIL: broken data stream)");
    }

    int arith_mcu(Component* const* sc, int ns, int my, int mx) {
        if (ac_ct == -1) return kOk;  // after a decoding error: nothing
        const bool dc_refine_pass = coding == kProgArith && Ss == 0 && Ah != 0;
        for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            int nv = ns == 1 ? 1 : c.v, nh = ns == 1 ? 1 : c.h;
            for (int y = 0; y < nv; ++y)
                for (int x = 0; x < nh; ++x) {
                    int16_t* blk = block_at(c, ns, my, mx, y, x);
                    bool ok = true;
                    if (coding == kSeqArith) {
                        memset(blk, 0, 64 * sizeof(int16_t));
                        int v;
                        ok = arith_dc_diff(c, v);
                        if (ok) {
                            c.last_dc = (c.last_dc + v) & 0xffff;
                            blk[0] = int16_t(c.last_dc);
                            ok = arith_ac(c.ac_tbl, blk, 1, 63, 0);
                        }
                    } else if (Ss == 0 && Ah == 0) {
                        int v;
                        ok = arith_dc_diff(c, v);
                        if (ok) {
                            c.last_dc = (c.last_dc + v) & 0xffff;
                            blk[0] = int16_t(unsigned(c.last_dc) << Al);
                        }
                    } else if (dc_refine_pass) {
                        if (arith_decode(fixed_bin))
                            blk[0] = int16_t(blk[0] | (1 << Al));
                    } else if (Ah == 0) {
                        ok = arith_ac(c.ac_tbl, blk, Ss, Se, Al);
                    } else {
                        ok = arith_ac_refine(c.ac_tbl, blk);
                    }
                    if (arith_short) return arith_broken();
                    if (!ok) {
                        ac_ct = -1;
                        if (!dc_refine_pass) return kOk;
                    }
                }
        }
        return kOk;
    }

    // ---- lossless (jdlhuff.c, jddiffct.c, jdlossls.c)
    bool lossless_diff(const HuffTable& t, int& diff) {
        int s;
        if (!decode_sym(t, s)) return false;
        if (s == 16) {
            s = 32768;
        } else if (s) {
            int r;
            if (!get_bits(s, r)) return false;
            s = extend(r, s);
        }
        diff = s;
        return true;
    }

    // one row of a component: undifference (predictor psv, or the first
    // row's), then scale by the point transform into the sample plane
    void undifference(Component& c, const int* diff, int row, int psv) {
        const int w = c.width_in_blocks;
        uint16_t* prev = c.undiff.data();
        std::vector<uint16_t> cur(w);
        if (c.first_row || psv == 1) {
            int Ra = c.first_row ? 1 << (precision - Al - 1) : prev[0];
            Ra = (diff[0] + Ra) & 0xFFFF;
            cur[0] = uint16_t(Ra);
            for (int x = 1; x < w; ++x) {
                Ra = (diff[x] + Ra) & 0xFFFF;
                cur[x] = uint16_t(Ra);
            }
        } else {
            int Rb = prev[0];
            int Ra = (diff[0] + Rb) & 0xFFFF;
            cur[0] = uint16_t(Ra);
            for (int x = 1; x < w; ++x) {
                int Rc = Rb;
                Rb = prev[x];
                int p;
                switch (psv) {
                    case 2: p = Rb; break;
                    case 3: p = Rc; break;
                    case 4: p = Ra + Rb - Rc; break;
                    case 5: p = Ra + ((Rb - Rc) >> 1); break;
                    case 6: p = Rb + ((Ra - Rc) >> 1); break;
                    default: p = (Ra + Rb) >> 1; break;
                }
                Ra = (diff[x] + p) & 0xFFFF;
                cur[x] = uint16_t(Ra);
            }
        }
        c.first_row = false;
        memcpy(prev, cur.data(), size_t(w) * sizeof(uint16_t));
        uint8_t* out = &c.samples[size_t(row) * w];
        for (int x = 0; x < w; ++x) out[x] = uint8_t(unsigned(cur[x]) << Al);
    }

    int lossless_scan(Component* const* sc, int ns) {
        if (Ss < 1 || Ss > 7 || Se != 0 || Ah != 0 || Al >= precision)
            return fail(kCorrupt, "invalid lossless scan parameters");
        for (int i = 0; i < ncomp; ++i) comp[i].first_row = true;
        for (int i = 0; i < ns; ++i)
            sc[i]->undiff.assign(size_t(sc[i]->width_in_blocks), 0);
        const int cols = ns == 1 ? sc[0]->width_in_blocks : mcus_per_row;
        // one iMCU row: v sample rows of every component in the scan
        const int imcu_rows = ns == 1
            ? (sc[0]->height_in_blocks + sc[0]->v - 1) / sc[0]->v : mcu_rows;
        const int rows_per_restart = restart_interval / cols;
        int rows_to_go = rows_per_restart, next_restart = 0;
        std::vector<std::vector<int>> diffs(ns);
        for (int i = 0; i < ns; ++i)
            diffs[i].assign(size_t(sc[i]->v) * (ns == 1 ? cols : cols * sc[i]->h), 0);
        for (int im = 0; im < imcu_rows; ++im) {
            const bool last = im == imcu_rows - 1;
            int mcu_rows_here = 1;
            if (ns == 1) {
                Component& c = *sc[0];
                int lrh = c.height_in_blocks % c.v;
                mcu_rows_here = last ? (lrh ? lrh : c.v) : c.v;
            }
            for (int yo = 0; yo < mcu_rows_here; ++yo) {
                if (restart_interval && rows_to_go == 0) {
                    if (!process_restart(next_restart))
                        return fail(kTruncated, "image file is truncated");
                    for (int i = 0; i < ncomp; ++i) comp[i].first_row = true;
                    rows_to_go = rows_per_restart;
                }
                if (insufficient) {
                    // out of data: zero differences, and the predictors
                    // start over (the samples become the centre value)
                    for (int i = 0; i < ns; ++i) {
                        Component& c = *sc[i];
                        int stride = ns == 1 ? cols : cols * c.h;
                        int nrows = ns == 1 ? 1 : c.v;
                        for (int r = 0; r < nrows; ++r)
                            std::fill_n(&diffs[i][size_t(ns == 1 ? yo : r) * stride], stride, 0);
                    }
                    for (int i = 0; i < ncomp; ++i) comp[i].first_row = true;
                } else {
                    for (int mx = 0; mx < cols; ++mx)
                        for (int i = 0; i < ns; ++i) {
                            Component& c = *sc[i];
                            const HuffTable& t = dc[c.dc_tbl];
                            int nv = ns == 1 ? 1 : c.v, nh = ns == 1 ? 1 : c.h;
                            int stride = ns == 1 ? cols : cols * c.h;
                            for (int y = 0; y < nv; ++y)
                                for (int x = 0; x < nh; ++x) {
                                    int d;
                                    if (!lossless_diff(t, d))
                                        return fail(kTruncated, "image file is truncated");
                                    int row = ns == 1 ? yo : y;
                                    diffs[i][size_t(row) * stride + mx * nh + x] = d;
                                }
                        }
                }
                if (restart_interval) --rows_to_go;
            }
            for (int i = 0; i < ns; ++i) {
                Component& c = *sc[i];
                int stride = ns == 1 ? cols : cols * c.h;
                int lrh = c.height_in_blocks % c.v;
                int nrows = last ? (lrh ? lrh : c.v) : c.v;
                for (int r = 0; r < nrows; ++r)
                    undifference(c, &diffs[i][size_t(r) * stride], im * c.v + r, Ss);
            }
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
                // a file of several scans is read to its EOI before any
                // line is output (jdapistd.c), so PIL needs the EOI
                if (saw_sos && !multi_scan) return kOk;
                return fail(kTruncated, "image file is truncated");
            }
            int m = unread_marker;
            unread_marker = 0;
            touch(pos);
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
            touch(pos + length);
            int rc = kOk;
            if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
                pos -= 2;
                rc = read_sof(m);
                if (rc == kOk) rc = setup_frame();
            } else if (m == 0xC4) {
                rc = read_dht(length);
            } else if (m == 0xDB) {
                rc = read_dqt(length);
            } else if (m == 0xCC) {
                rc = read_dac(length);
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
            } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
                pos += length;  // APPn, COM, DNL
            } else {
                return fail(kCorrupt, "unsupported JPEG marker");
            }
            if (rc != kOk) return rc;
        }
    }

    // jdcoefct.c:smoothing_ok: libjpeg-turbo smooths the blocks of a
    // progressive file whose first coefficients are not all refined to
    // the last bit. The port does not; it refuses those files.
    bool smoothing_applies() const {
        if (coding != kProgHuff && coding != kProgArith) return false;
        static const int kSaved[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
        bool useful = false;
        for (int ci = 0; ci < ncomp; ++ci) {
            const Component& c = comp[ci];
            if (!c.latched) return false;
            for (int k : kSaved)
                if (c.quant[k] == 0) return false;
            if (c.coef_bits[0] < 0) return false;
            for (int k = 1; k < 10; ++k)
                if (c.coef_bits[k] != 0) useful = true;
        }
        return useful;
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
        const bool fancy = coding != kLossless;
        if (c.h == max_h && c.v == max_v) {
            for (int y = 0; y < H; ++y) memcpy(full + size_t(y) * W, plane + size_t(y) * ps, W);
        } else if (c.h * 2 == max_h && c.v == max_v && fancy) {
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
        } else if (c.h == max_h && c.v * 2 == max_v && fancy) {  // h1v2_fancy_upsample
            for (int y = 0; y < H; ++y) {
                int r = y >> 1, v = y & 1;
                int nb = v == 0 ? (r > 0 ? r - 1 : 0) : (r + 1 < dh ? r + 1 : dh - 1);
                int bias = v == 0 ? 1 : 2;
                for (int x = 0; x < W; ++x)
                    full[size_t(y) * W + x] = uint8_t((P(r, x) * 3 + P(nb, x) + bias) >> 2);
            }
        } else if (c.h * 2 == max_h && c.v * 2 == max_v && fancy) {
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
        if (smoothing_applies())
            return fail(kUnsupported, "a progressive JPEG whose first "
                        "coefficients are not all refined to the last bit, "
                        "which libjpeg-turbo decodes with block smoothing");
        std::vector<std::vector<uint8_t>> fulls(ncomp);
        for (int ci = 0; ci < ncomp; ++ci) {
            Component& c = comp[ci];
            if (!c.latched)
                return fail(kCorrupt, "a component appears in no scan");
            int ps;
            std::vector<uint8_t> plane;
            if (coding == kLossless) {
                ps = c.width_in_blocks;
                plane.swap(c.samples);
            } else {
                ps = c.width_in_blocks * 8;
                plane.resize(size_t(ps) * c.height_in_blocks * 8);
                for (int by = 0; by < c.height_in_blocks; ++by)
                    for (int bx = 0; bx < c.width_in_blocks; ++bx)
                        idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant,
                                   &plane[size_t(by) * 8 * ps + bx * 8], ps);
            }
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
        const uint8_t *y = fulls[0].data(), *cb = fulls[1].data(), *cr = fulls[2].data();
        if (coding == kLossless) {
            // jdapimin.c guesses RGB (CMYK) for a lossless frame without
            // markers, and libjpeg-turbo converts no colour there: YCbCr
            // (a JFIF marker with 3 components, or an Adobe transform other
            // than 0) or YCCK is an error
            if ((ncomp == 3 && saw_jfif) || (saw_adobe && adobe_transform != 0))
                return fail(kCorrupt, "colour conversion of a lossless frame "
                            "(libjpeg-turbo: unsupported color conversion)");
            for (size_t i = 0; i < np; ++i)
                for (int c = 0; c < ncomp; ++c)
                    out[ncomp * i + c] = ncomp == 4 ? uint8_t(255 - fulls[c][i])
                                                    : fulls[c][i];
            return kOk;
        }
        if (ncomp == 4) {
            // jdcolor.c: YCCK (Adobe transform other than 0) -> CMYK, or
            // CMYK as it is; PIL unpacks it inverted ("CMYK;I"), so YCC
            // becomes RGB and K its complement
            const uint8_t* k = fulls[3].data();
            const bool ycck = saw_adobe && adobe_transform != 0;
            for (size_t i = 0; i < np; ++i) {
                uint8_t* o = out + 4 * i;
                if (ycck) {
                    int Y = y[i];
                    o[0] = clamp255(Y + g_cr_r[cr[i]]);
                    o[1] = clamp255(Y + int((g_cb_g[cb[i]] + g_cr_g[cr[i]]) >> 16));
                    o[2] = clamp255(Y + g_cb_b[cb[i]]);
                } else {
                    o[0] = uint8_t(255 - y[i]);
                    o[1] = uint8_t(255 - cb[i]);
                    o[2] = uint8_t(255 - cr[i]);
                }
                o[3] = uint8_t(255 - k[i]);
            }
            return kOk;
        }
        bool ycc;
        if (saw_jfif) ycc = true;
        else if (saw_adobe) ycc = adobe_transform != 0;
        else ycc = !(comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66);
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

// (height, width, components, then each component's horizontal and
// vertical sampling factors: 11 values) of a JPEG from its markers up to
// the first SOS. Returns 0 or an error code (-1 truncated, -2 corrupt,
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
    for (int c = 0; c < 4; ++c) {
        dims[3 + 2 * c] = c < d.ncomp ? d.comp[c].h : 0;
        dims[4 + 2 * c] = c < d.ncomp ? d.comp[c].v : 0;
    }
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
