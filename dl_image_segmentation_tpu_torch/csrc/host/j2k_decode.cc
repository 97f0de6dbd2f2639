// JPEG 2000 Part-1 (ISO/IEC 15444-1) codestream decoder.
//
// Built with g++ into build/ at first use and called through ctypes by
// raster/jp2.py; it never calls back into Python, so a decode runs with
// the GIL released. Its output is what OpenJPEG 2.5 returns for a whole
// tile decoded through opj_decode_tile_data (the route PIL takes): the
// same packet parse, the same tier-1 reconstruction of partly decoded
// coefficients (one extra fractional bit, the half bit set at
// significance, a truncating division by 2 on the reversible path), the
// same float 9/7 lifting order and constants (opj_dwt_decode_tile_97 with
// its 2/K high-pass scale), the same float ICT, lrintf rounding, DC
// shift and clamp. Compile without -ffast-math and with
// -ffp-contract=off: contracted multiply-adds would part the 9/7 bits.
//
// Covered: SIZ, COD/COC, QCD/QCC, RGN, POC, PPM/PPT, SOT/SOD, SOP/EPH;
// PLT/PLM/TLM/CRG/COM/CAP are skipped. Several tiles and tile-parts, all
// five progression orders (RPCL, PCRL and CPRL walk precinct positions
// on the reference grid, Annex B.12), precincts, every code-block style
// flag (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM), derived and
// expounded quantisation, the 5/3 and 9/7 inverse DWT with odd start
// coordinates, RCT and ICT. Subsampled components (XRsiz/YRsiz > 1)
// decode at their own extent through fc_j2k_decode_planes.
//
// Every size read from a header is checked before it is allocated or
// indexed: request bodies are untrusted.
//
// C interface:
//   fc_j2k_info(cs, n, info, cap, err, errlen) -> 0 or < 0
//     info[0..2] = width, height, components; then per component
//     (precision, signed, dx, dy).
//   fc_j2k_decode(cs, n, out, elem_size, out_elems, err, errlen) -> 0
//     out is (height, width, components), each sample clamped to its
//     component's range and stored in elem_size bytes (1, 2 or 4).
//     Components must not be subsampled.
//   fc_j2k_decode_planes(cs, n, out, elem_size, out_elems, err, errlen)
//     -> 0: each component at its own extent (ceil(Xsiz / XRsiz) -
//     ceil(XOsiz / XRsiz) by the same in y), one plane after the other,
//     as above.

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <new>
#include <stdexcept>
#include <vector>

namespace {

struct J2KError {
    std::string msg;
    int code;
};

[[noreturn]] void fail(int code, const char* fmt, ...) {
    char buf[240];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof buf, fmt, ap);
    va_end(ap);
    throw J2KError{buf, code};
}

constexpr int kCorrupt = -1;
constexpr int kUnsupported = -3;
constexpr uint64_t kMaxSamples = uint64_t(1) << 31;  // image area x comps
constexpr uint32_t kMaxTiles = 65535;

inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, int b) {
    return (a + (int64_t(1) << b) - 1) >> b;
}
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// ---------------------------------------------------------------- header

struct StepSize {
    int expn = 0, mant = 0;
};

struct CompCoding {
    int precincts = 0;  // Scod/Scoc bit 0
    int nl = 0, xcb = 0, ycb = 0, cblksty = 0, qmfbid = 0;
    int ppx[33], ppy[33];
    CompCoding() {
        for (int i = 0; i < 33; ++i) ppx[i] = ppy[i] = 15;
    }
};

struct CompQuant {
    int qntsty = 0, guard = 0, nsteps = 0;
    StepSize steps[3 * 32 + 1];
};

struct Poc {
    int rs, cs, le, re, ce, prg;
};

struct Coding {
    bool cod_seen = false, qcd_seen = false;
    int csty = 0;  // SOP (2) / EPH (4)
    int prg = 0, nlayers = 1, mct = 0;
    std::vector<CompCoding> cc;
    std::vector<CompQuant> cq;
    std::vector<int> roishift;
    std::vector<char> coc_set, qcc_set;
    std::vector<Poc> pocs;
};

struct Comp {
    int prec, sgnd, dx, dy;
};

struct TileData {
    bool seen = false;
    Coding coding;
    std::vector<uint8_t> data;
    std::vector<uint8_t> ppt;  // PPT payloads (Zppt order)
    std::vector<std::pair<int, std::vector<uint8_t>>> ppt_parts;
    std::vector<uint8_t> ppm;  // this tile's share of the PPM headers
    bool packed = false;
    int parts = 0;
};

struct Reader {
    const uint8_t* p;
    size_t n, pos;
    Reader(const uint8_t* d, size_t len) : p(d), n(len), pos(0) {}
    void need(size_t k) const {
        if (pos + k > n || pos + k < pos)
            fail(kCorrupt, "truncated JPEG 2000 codestream at byte %zu", pos);
    }
    uint32_t u8() { need(1); return p[pos++]; }
    uint32_t u16() { need(2); uint32_t v = (p[pos] << 8) | p[pos + 1]; pos += 2; return v; }
    uint32_t u32() {
        need(4);
        uint32_t v = (uint32_t(p[pos]) << 24) | (p[pos + 1] << 16) |
                     (p[pos + 2] << 8) | p[pos + 3];
        pos += 4;
        return v;
    }
};

struct Image {
    uint32_t xsiz = 0, ysiz = 0, x0 = 0, y0 = 0;
    uint32_t tw = 0, th = 0, tx0 = 0, ty0 = 0;
    uint32_t ntx = 0, nty = 0;
    std::vector<Comp> comps;
};

// ---------------------------------------------------------- MQ decoder

struct QeEntry {
    uint32_t qe;
    uint8_t nmps, nlps, sw;
};

const QeEntry kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NCTX = 19 };

// the 94 (state, MPS) pairs: Qe and the next pair after an MPS and an LPS
struct MQState {
    uint32_t qe, nmps, nlps;
};

struct StateTable {
    MQState s[94];
    StateTable() {
        for (int i = 0; i < 47; ++i)
            for (int mps = 0; mps < 2; ++mps) {
                const QeEntry& q = kQe[i];
                s[2 * i + mps] = {q.qe, uint32_t(2 * q.nmps + mps),
                                  uint32_t(2 * q.nlps + (q.sw ? 1 - mps : mps))};
            }
    }
};
const StateTable kStateTable;
const MQState* const kStates = kStateTable.s;

// -------------------------------------------------------------- tier-1

enum : uint8_t { F_SIG = 1, F_VISIT = 2, F_REF = 4, F_NEG = 8 };

struct Seg {
    uint32_t len = 0;       // bytes received so far
    int numpasses = 0;      // passes received so far
    int maxpasses = 0;
    int numnewpasses = 0;   // of the packet being read
    uint32_t newlen = 0;
};

struct Cblk {
    int x0, y0, x1, y1;
    int numbps = 0, numlenbits = 0;
    std::vector<Seg> segs;
    std::vector<uint8_t> data;
    int numnewpasses = 0, first_new_seg = 0;
};

// zero-coding context from neighbour counts, per orientation
// (0 LL, 1 HL, 2 LH, 3 HH; HL swaps horizontal and vertical)
int zc_context(int orient, int h, int v, int d) {
    if (orient == 1) std::swap(h, v);
    if (orient != 3) {
        if (h == 0) {
            if (v == 0) return d == 0 ? 0 : (d == 1 ? 1 : 2);
            return v == 1 ? 3 : 4;
        }
        if (h == 1) {
            if (v == 0) return d == 0 ? 5 : 6;
            return 7;
        }
        return 8;
    }
    int hv = h + v;
    if (d == 0) return hv == 0 ? 0 : (hv == 1 ? 1 : 2);
    if (d == 1) return hv == 0 ? 3 : (hv == 1 ? 4 : 5);
    if (d == 2) return hv == 0 ? 6 : 7;
    return 8;
}

// A sample's state word: the significance of its 8 neighbours and the
// signs of the 4 direct ones (kept up to date as samples turn
// significant, so a pass reads one word, not eight), and its own flags.
enum : uint32_t {
    N_W = 1, N_E = 2, N_N = 4, N_S = 8, N_NW = 16, N_NE = 32, N_SW = 64, N_SE = 128,
    N_SIG = 0xFF, NEG_W = 256, NEG_E = 512, NEG_N = 1024, NEG_S = 2048,
    S_SIG = 1u << 16, S_VISIT = 1u << 17, S_REF = 1u << 18
};

struct Luts {
    uint8_t zc[4][256];
    uint8_t sc[256];  // context | xor bit << 7, by direct sig | signs << 4
    Luts() {
        for (int o = 0; o < 4; ++o)
            for (int n = 0; n < 256; ++n) {
                int h = !!(n & N_W) + !!(n & N_E), v = !!(n & N_N) + !!(n & N_S);
                int d = !!(n & N_NW) + !!(n & N_NE) + !!(n & N_SW) + !!(n & N_SE);
                zc[o][n] = uint8_t(CTX_ZC + zc_context(o, h, v, d));
            }
        for (int i = 0; i < 256; ++i) {
            auto c = [&](int bit) { return (i & bit) ? ((i & (bit << 4)) ? -1 : 1) : 0; };
            int hc = std::max(-1, std::min(1, c(1) + c(2)));
            int vc = std::max(-1, std::min(1, c(4) + c(8)));
            int xorbit = 0;
            if (hc < 0) {
                hc = -hc;
                vc = -vc;
                xorbit = 1;
            } else if (hc == 0 && vc < 0) {
                vc = -vc;
                xorbit = 1;
            }
            int ctx = hc == 1 ? (vc == 1 ? 13 : (vc == 0 ? 12 : 11)) : (vc == 1 ? 10 : 9);
            sc[i] = uint8_t(ctx | (xorbit << 7));
        }
    }
};
const Luts kLuts;

// The MQ coder's registers, held in locals for the length of a pass (a
// store to the sample arrays cannot then force them back to memory).
struct MQRegs {
    const uint8_t* bp;
    uint32_t a, c, ct;
    uint32_t* cx;  // per context: state index * 2 + MPS
    inline void bytein() {
        uint32_t next = bp[1];
        if (bp[0] == 0xFF) {
            if (next > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                ++bp;
                c += next << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += next << 8;
            ct = 8;
        }
    }
    inline void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            --ct;
        } while (a < 0x8000);
    }
    inline uint32_t decode(int ctxno) {
        uint32_t s = cx[ctxno];
        const MQState& q = kStates[s];
        uint32_t d;
        a -= q.qe;
        if ((c >> 16) < q.qe) {
            if (a < q.qe) {
                d = s & 1;
                cx[ctxno] = q.nmps;
            } else {
                d = (s & 1) ^ 1;
                cx[ctxno] = q.nlps;
            }
            a = q.qe;
            renorm();
        } else {
            c -= q.qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < q.qe) {
                    d = (s & 1) ^ 1;
                    cx[ctxno] = q.nlps;
                } else {
                    d = s & 1;
                    cx[ctxno] = q.nmps;
                }
                renorm();
            } else {
                d = s & 1;
            }
        }
        return d;
    }
    inline uint32_t raw_decode() {
        if (ct == 0) {
            if (c == 0xFF) {
                if (*bp > 0x8F) {
                    c = 0xFF;
                    ct = 8;
                } else {
                    c = *bp++;
                    ct = 7;
                }
            } else {
                c = *bp++;
                ct = 8;
            }
        }
        --ct;
        return (c >> ct) & 1;
    }
};

// The MQ decoder (ISO/IEC 15444-1 C.3) as OpenJPEG runs it: a segment
// must be followed by two 0xFF bytes (the artificial marker that stops
// byte-in at its end).
struct MQ {
    const uint8_t* bp;
    uint32_t a, c, ct;
    uint32_t cx[NCTX];

    void reset_states() {
        for (int i = 0; i < NCTX; ++i) cx[i] = 0;
        cx[CTX_UNI] = 2 * 46;
        cx[CTX_AGG] = 2 * 3;
        cx[CTX_ZC] = 2 * 4;
    }
    MQRegs regs() { return MQRegs{bp, a, c, ct, cx}; }
    void save(const MQRegs& m) {
        bp = m.bp;
        a = m.a;
        c = m.c;
        ct = m.ct;
    }
    void init(const uint8_t* d, size_t len) {
        MQRegs m{d, 0, len == 0 ? (0xFFu << 16) : (uint32_t(d[0]) << 16), 0, cx};
        m.bytein();
        m.c <<= 7;
        m.ct -= 7;
        m.a = 0x8000;
        save(m);
    }
    // raw (BYPASS) segments
    void raw_init(const uint8_t* d) {
        bp = d;
        c = 0;
        ct = 0;
    }
};

struct T1 {
    int w, h, stride, vsc;
    std::vector<int32_t> data;
    std::vector<uint32_t> st;  // (w + 2) x (h + 2) state words
    const uint8_t* zc_lut;
    MQ mq;

    void setup(int w_, int h_, int orient, int vsc_) {
        w = w_;
        h = h_;
        vsc = vsc_;
        stride = w + 2;
        data.assign(size_t(w) * h, 0);
        st.assign(size_t(w + 2) * (h + 2), 0);
        zc_lut = kLuts.zc[orient];
    }
    inline void set_sig(uint32_t* p, int32_t* d, int y, uint32_t neg, int32_t val) {
        *d = neg ? -val : val;
        *p |= S_SIG;
        p[-1] |= N_E | (neg ? NEG_E : 0);
        p[1] |= N_W | (neg ? NEG_W : 0);
        p[stride] |= N_N | (neg ? NEG_N : 0);
        p[stride - 1] |= N_NE;
        p[stride + 1] |= N_NW;
        // the row above belongs to the previous stripe when y % 4 == 0:
        // under VSC it does not see this stripe
        if (!(vsc && (y & 3) == 0)) {
            p[-stride] |= N_S | (neg ? NEG_S : 0);
            p[-stride - 1] |= N_SE;
            p[-stride + 1] |= N_SW;
        }
    }
    inline void sign_and_set(MQRegs& m, uint32_t* p, int32_t* d, int y, int32_t oneplushalf) {
        uint32_t n = *p;
        uint8_t l = kLuts.sc[(n & 0xF) | ((n >> 4) & 0xF0)];
        uint32_t v = m.decode(l & 0x7F) ^ (l >> 7);
        set_sig(p, d, y, v, oneplushalf);
    }

    void sigpass(int bpno, bool raw) {
        int32_t one = int32_t(1) << bpno, half = one >> 1, oneplushalf = one | half;
        MQRegs m = mq.regs();
        for (int k = 0; k < h; k += 4) {
            int rows = std::min(4, h - k);
            for (int x = 0; x < w; ++x) {
                uint32_t* p = &st[size_t(k + 1) * stride + x + 1];
                int32_t* d = &data[size_t(k) * w + x];
                for (int j = 0; j < rows; ++j, p += stride, d += w) {
                    uint32_t n = *p;
                    if ((n & (S_SIG | S_VISIT)) || !(n & N_SIG)) continue;
                    if (raw) {
                        if (m.raw_decode()) set_sig(p, d, k + j, m.raw_decode(), oneplushalf);
                    } else if (m.decode(zc_lut[n & N_SIG])) {
                        sign_and_set(m, p, d, k + j, oneplushalf);
                    }
                    *p |= S_VISIT;
                }
            }
        }
        mq.save(m);
    }
    void refpass(int bpno, bool raw) {
        int32_t one = int32_t(1) << bpno, poshalf = one >> 1;
        MQRegs m = mq.regs();
        for (int k = 0; k < h; k += 4) {
            int rows = std::min(4, h - k);
            for (int x = 0; x < w; ++x) {
                uint32_t* p = &st[size_t(k + 1) * stride + x + 1];
                int32_t* d = &data[size_t(k) * w + x];
                for (int j = 0; j < rows; ++j, p += stride, d += w) {
                    uint32_t n = *p;
                    if ((n & (S_SIG | S_VISIT)) != S_SIG) continue;
                    uint32_t v;
                    if (raw) v = m.raw_decode();
                    else v = m.decode((n & S_REF) ? CTX_MAG + 2 : ((n & N_SIG) ? CTX_MAG + 1 : CTX_MAG));
                    *d += (v ^ (*d < 0)) ? poshalf : -poshalf;
                    *p = n | S_REF;
                }
            }
        }
        mq.save(m);
    }
    void clnpass(int bpno, bool segsym) {
        int32_t one = int32_t(1) << bpno, half = one >> 1, oneplushalf = one | half;
        MQRegs m = mq.regs();
        for (int k = 0; k < h; k += 4) {
            int rows = std::min(4, h - k);
            for (int x = 0; x < w; ++x) {
                uint32_t* p0 = &st[size_t(k + 1) * stride + x + 1];
                int32_t* d0 = &data[size_t(k) * w + x];
                int j = 0, partial = -1;
                if (rows == 4 && !((p0[0] | p0[stride] | p0[2 * stride] | p0[3 * stride]) &
                                   (S_SIG | S_VISIT | N_SIG))) {
                    if (!m.decode(CTX_AGG)) continue;
                    uint32_t runlen = m.decode(CTX_UNI);
                    runlen = (runlen << 1) | m.decode(CTX_UNI);
                    j = partial = int(runlen);
                }
                uint32_t* p = p0 + size_t(j) * stride;
                int32_t* d = d0 + size_t(j) * w;
                for (; j < rows; ++j, p += stride, d += w) {
                    if (j != partial) {
                        uint32_t n = *p;
                        if (n & (S_SIG | S_VISIT)) continue;
                        if (!m.decode(zc_lut[n & N_SIG])) continue;
                    }
                    sign_and_set(m, p, d, k + j, oneplushalf);
                }
                p = p0;
                for (j = 0; j < rows; ++j, p += stride) *p &= ~S_VISIT;
            }
        }
        if (segsym) {
            for (int i = 0; i < 4; ++i) m.decode(CTX_UNI);
        }
        mq.save(m);
    }
};

enum { CBLK_LAZY = 1, CBLK_RESET = 2, CBLK_TERMALL = 4, CBLK_VSC = 8,
       CBLK_PTERM = 16, CBLK_SEGSYM = 32 };

// Decode one code-block into t1.data (values carry one extra fractional
// bit, as OpenJPEG keeps them before its final scaling).
void decode_cblk(T1& t1, Cblk& cb, int orient, int roishift, int cblksty) {
    int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
    t1.setup(w, h, orient, (cblksty & CBLK_VSC) ? 1 : 0);
    if (cb.segs.empty()) return;
    int bpno_plus_one = roishift + cb.numbps;
    if (bpno_plus_one >= 31)
        fail(kCorrupt, "code-block has %d bit-planes", bpno_plus_one);
    int passtype = 2;
    t1.mq.reset_states();
    std::vector<uint8_t> buf;
    size_t off = 0;
    for (Seg& seg : cb.segs) {
        if (seg.numpasses == 0) break;
        if (off + seg.len > cb.data.size()) fail(kCorrupt, "code-block segment overruns its data");
        buf.assign(cb.data.begin() + off, cb.data.begin() + off + seg.len);
        buf.push_back(0xFF);
        buf.push_back(0xFF);
        off += seg.len;
        bool raw = bpno_plus_one <= cb.numbps - 4 && passtype < 2 && (cblksty & CBLK_LAZY);
        if (raw) t1.mq.raw_init(buf.data());
        else t1.mq.init(buf.data(), seg.len);
        for (int p = 0; p < seg.numpasses && bpno_plus_one >= 1; ++p) {
            switch (passtype) {
                case 0: t1.sigpass(bpno_plus_one, raw); break;
                case 1: t1.refpass(bpno_plus_one, raw); break;
                case 2: t1.clnpass(bpno_plus_one, (cblksty & CBLK_SEGSYM) != 0); break;
            }
            if ((cblksty & CBLK_RESET) && !raw) t1.mq.reset_states();
            if (++passtype == 3) {
                passtype = 0;
                --bpno_plus_one;
            }
        }
    }
    if (roishift) {
        int32_t thresh = int32_t(1) << roishift;
        for (int32_t& v : t1.data) {
            int32_t mag = v < 0 ? -v : v;
            if (mag >= thresh) {
                mag >>= roishift;
                v = v < 0 ? -mag : mag;
            }
        }
    }
}

// ------------------------------------------------------------ tag trees

struct TagTree {
    struct Node {
        int parent;
        int value, low;
    };
    std::vector<Node> nodes;
    int nleafs = 0;

    void build(int w, int h) {
        nodes.clear();
        nleafs = w * h;
        if (nleafs == 0) return;
        std::vector<int> lw, lh;
        int cw = w, ch = h;
        int total = 0;
        while (true) {
            lw.push_back(cw);
            lh.push_back(ch);
            total += cw * ch;
            if (cw * ch == 1) break;
            cw = (cw + 1) / 2;
            ch = (ch + 1) / 2;
        }
        nodes.assign(total, Node{-1, 999, 0});
        int base = 0;
        for (size_t l = 0; l + 1 < lw.size(); ++l) {
            int nb = base + lw[l] * lh[l];
            for (int j = 0; j < lh[l]; ++j)
                for (int i = 0; i < lw[l]; ++i)
                    nodes[base + j * lw[l] + i].parent = nb + (j / 2) * lw[l + 1] + i / 2;
            base = nb;
        }
    }
};

struct Bio {
    const uint8_t *start, *bp, *end;
    uint32_t buf;
    int ct;
    bool overrun;
    void init(const uint8_t* p, size_t n) {
        start = bp = p;
        end = p + n;
        buf = 0;
        ct = 0;
        overrun = false;
    }
    void bytein() {
        buf = (buf << 8) & 0xFFFF;
        ct = buf == 0xFF00 ? 7 : 8;
        if (bp < end) buf |= *bp++;
        else overrun = true;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        --ct;
        return (buf >> ct) & 1;
    }
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = n - 1; i >= 0; --i) v |= bit() << i;
        return v;
    }
    void inalign() {
        if ((buf & 0xFF) == 0xFF) bytein();
        ct = 0;
    }
    size_t numbytes() const { return size_t(bp - start); }
};

int tgt_decode(Bio& bio, TagTree& t, int leaf, int threshold) {
    int stk[40];
    int sp = 0;
    int node = leaf;
    while (t.nodes[node].parent >= 0) {
        stk[sp++] = node;
        node = t.nodes[node].parent;
    }
    int low = 0;
    for (;;) {
        TagTree::Node& nd = t.nodes[node];
        if (low > nd.low) nd.low = low;
        else low = nd.low;
        while (low < threshold && low < nd.value) {
            if (bio.bit()) nd.value = low;
            else ++low;
        }
        nd.low = low;
        if (sp == 0) break;
        node = stk[--sp];
    }
    return t.nodes[node].value < threshold ? 1 : 0;
}

// ---------------------------------------------------------- tile layout

struct PrecBand {
    int cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    int orient;  // 0 LL, 1 HL, 2 LH, 3 HH
    int64_t x0, y0, x1, y1;
    int numbps;
    float stepsize;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
    int64_t x0, y0, x1, y1;
    int pdx, pdy, pw, ph;
    int nbands;
    Band bands[3];
    std::vector<PrecBand> prec;  // pw * ph * nbands
};

struct TileComp {
    int64_t x0, y0, x1, y1;
    std::vector<Res> res;
};

int floorlog2(uint32_t v) {
    int l = 0;
    while (v > 1) {
        v >>= 1;
        ++l;
    }
    return l;
}

struct Decoder {
    const uint8_t* cs;
    size_t n;
    Image img;
    Coding main;
    std::vector<TileData> tiles;
    std::vector<uint8_t> ppm_all;
    std::vector<std::pair<int, std::vector<uint8_t>>> ppm_parts;
    bool have_ppm = false;
    size_t ppm_pos = 0;

    int comp_index(Reader& r) {
        int c = img.comps.size() < 257 ? r.u8() : r.u16();
        if (c >= int(img.comps.size())) fail(kCorrupt, "marker names component %d of %zu", c, img.comps.size());
        return c;
    }

    void read_siz(Reader& r) {
        uint32_t lsiz = r.u16();
        size_t end = r.pos + lsiz - 2;
        r.u16();  // Rsiz
        img.xsiz = r.u32();
        img.ysiz = r.u32();
        img.x0 = r.u32();
        img.y0 = r.u32();
        img.tw = r.u32();
        img.th = r.u32();
        img.tx0 = r.u32();
        img.ty0 = r.u32();
        uint32_t csiz = r.u16();
        if (csiz == 0 || csiz > 16384) fail(kCorrupt, "SIZ has %u components", csiz);
        if (lsiz != 38 + 3 * csiz) fail(kCorrupt, "SIZ length %u does not fit %u components", lsiz, csiz);
        if (img.xsiz <= img.x0 || img.ysiz <= img.y0) fail(kCorrupt, "empty image area in SIZ");
        if (img.tw == 0 || img.th == 0) fail(kCorrupt, "zero tile size in SIZ");
        if (img.tx0 > img.x0 || img.ty0 > img.y0 || uint64_t(img.tx0) + img.tw <= img.x0 ||
            uint64_t(img.ty0) + img.th <= img.y0)
            fail(kCorrupt, "tile grid does not cover the image origin");
        img.ntx = uint32_t(ceildiv(int64_t(img.xsiz) - img.tx0, img.tw));
        img.nty = uint32_t(ceildiv(int64_t(img.ysiz) - img.ty0, img.th));
        if (uint64_t(img.ntx) * img.nty > kMaxTiles)
            fail(kCorrupt, "%u x %u tiles exceed the codestream limit", img.ntx, img.nty);
        uint64_t area = uint64_t(img.xsiz - img.x0) * (img.ysiz - img.y0);
        if (area * csiz > kMaxSamples)
            fail(kCorrupt, "image of %llu samples exceeds the decoder limit",
                 (unsigned long long)(area * csiz));
        for (uint32_t i = 0; i < csiz; ++i) {
            uint32_t s = r.u8();
            Comp c;
            c.prec = int(s & 0x7F) + 1;
            c.sgnd = (s >> 7) & 1;
            c.dx = int(r.u8());
            c.dy = int(r.u8());
            if (c.prec > 31) fail(kCorrupt, "component precision %d", c.prec);
            if (c.dx == 0 || c.dy == 0) fail(kCorrupt, "zero component subsampling");
            img.comps.push_back(c);
        }
        r.pos = end;
        main.cc.assign(csiz, CompCoding());
        main.cq.assign(csiz, CompQuant());
        main.roishift.assign(csiz, 0);
        main.coc_set.assign(csiz, 0);
        main.qcc_set.assign(csiz, 0);
        tiles.assign(size_t(img.ntx) * img.nty, TileData());
    }

    void read_spcod(Reader& r, size_t end, CompCoding& c, int precincts) {
        c.nl = int(r.u8());
        c.xcb = int(r.u8()) + 2;
        c.ycb = int(r.u8()) + 2;
        c.cblksty = int(r.u8());
        c.qmfbid = int(r.u8());
        if (c.nl > 32) fail(kCorrupt, "%d decomposition levels", c.nl);
        if (c.xcb > 10 || c.ycb > 10 || c.xcb + c.ycb > 12)
            fail(kCorrupt, "code-block size 2^%d x 2^%d", c.xcb, c.ycb);
        if (c.cblksty & 0xC0) fail(kUnsupported, "code-block style 0x%02x (HTJ2K or Part 2)", c.cblksty);
        if (c.qmfbid > 1) fail(kUnsupported, "wavelet transform %d (Part 2)", c.qmfbid);
        c.precincts = precincts;
        for (int i = 0; i <= c.nl; ++i) {
            if (precincts) {
                uint32_t v = r.u8();
                c.ppx[i] = int(v & 15);
                c.ppy[i] = int(v >> 4);
                if (i > 0 && (c.ppx[i] == 0 || c.ppy[i] == 0))
                    fail(kCorrupt, "precinct size 2^0 above resolution 0");
            } else {
                c.ppx[i] = c.ppy[i] = 15;
            }
        }
        if (r.pos > end) fail(kCorrupt, "coding style segment too short");
    }

    void read_cod(Reader& r, Coding& cd) {
        uint32_t len = r.u16();
        size_t end = r.pos + len - 2;
        int scod = int(r.u8());
        cd.csty = scod & 6;
        cd.prg = int(r.u8());
        cd.nlayers = int(r.u16());
        cd.mct = int(r.u8());
        if (cd.prg > 4) fail(kCorrupt, "progression order %d", cd.prg);
        if (cd.nlayers == 0) fail(kCorrupt, "zero quality layers");
        if (cd.mct > 1) fail(kUnsupported, "multiple component transform %d (Part 2)", cd.mct);
        CompCoding c;
        read_spcod(r, end, c, scod & 1);
        for (size_t i = 0; i < cd.cc.size(); ++i)
            if (!cd.coc_set[i]) cd.cc[i] = c;
        cd.cod_seen = true;
        r.pos = end;
    }

    void read_coc(Reader& r, Coding& cd) {
        uint32_t len = r.u16();
        size_t end = r.pos + len - 2;
        int c = comp_index(r);
        int scoc = int(r.u8());
        read_spcod(r, end, cd.cc[c], scoc & 1);
        cd.coc_set[c] = 1;
        r.pos = end;
    }

    void read_sqcd(Reader& r, size_t end, CompQuant& q) {
        int s = int(r.u8());
        q.qntsty = s & 0x1F;
        q.guard = s >> 5;
        if (q.qntsty > 2) fail(kCorrupt, "quantisation style %d", q.qntsty);
        int k = 0;
        if (q.qntsty == 0) {
            while (r.pos < end && k < 3 * 32 + 1) {
                q.steps[k].expn = int(r.u8()) >> 3;
                q.steps[k].mant = 0;
                ++k;
            }
        } else {
            while (r.pos + 1 < end + 1 && r.pos + 2 <= end && k < 3 * 32 + 1) {
                uint32_t v = r.u16();
                q.steps[k].expn = int(v >> 11);
                q.steps[k].mant = int(v & 0x7FF);
                ++k;
                if (q.qntsty == 1) break;
            }
        }
        if (k == 0) fail(kCorrupt, "quantisation segment without step sizes");
        q.nsteps = k;
        if (q.qntsty == 1) {
            for (int b = 1; b < 3 * 32 + 1; ++b) {
                int e = q.steps[0].expn - (b - 1) / 3;
                q.steps[b].expn = e > 0 ? e : 0;
                q.steps[b].mant = q.steps[0].mant;
            }
            q.nsteps = 3 * 32 + 1;
        }
    }

    void read_qcd(Reader& r, Coding& cd) {
        uint32_t len = r.u16();
        size_t end = r.pos + len - 2;
        r.need(len - 2);
        CompQuant q;
        read_sqcd(r, end, q);
        for (size_t i = 0; i < cd.cq.size(); ++i)
            if (!cd.qcc_set[i]) cd.cq[i] = q;
        cd.qcd_seen = true;
        r.pos = end;
    }

    void read_qcc(Reader& r, Coding& cd) {
        uint32_t len = r.u16();
        size_t end = r.pos + len - 2;
        r.need(len - 2);
        int c = comp_index(r);
        read_sqcd(r, end, cd.cq[c]);
        cd.qcc_set[c] = 1;
        r.pos = end;
    }

    void read_rgn(Reader& r, Coding& cd) {
        uint32_t len = r.u16();
        size_t end = r.pos + len - 2;
        int c = comp_index(r);
        int srgn = int(r.u8());
        if (srgn != 0) fail(kCorrupt, "ROI style %d", srgn);
        cd.roishift[c] = int(r.u8());
        r.pos = end;
    }

    void read_poc(Reader& r, Coding& cd) {
        uint32_t len = r.u16();
        size_t end = r.pos + len - 2;
        int csz = img.comps.size() < 257 ? 1 : 2;
        size_t entry = 5 + 2 * csz;
        if ((len - 2) % entry != 0 || len < 2 + entry) fail(kCorrupt, "POC length %u", len);
        while (r.pos < end) {
            Poc p;
            p.rs = int(r.u8());
            p.cs = csz == 1 ? int(r.u8()) : int(r.u16());
            p.le = int(r.u16());
            p.re = int(r.u8());
            p.ce = csz == 1 ? int(r.u8()) : int(r.u16());
            if (p.ce == 0) p.ce = 256;
            p.prg = int(r.u8());
            if (p.prg > 4) fail(kCorrupt, "POC progression order %d", p.prg);
            p.le = std::min(p.le, cd.nlayers);
            p.ce = std::min(p.ce, int(img.comps.size()));
            p.re = std::min(p.re, 33);
            cd.pocs.push_back(p);
        }
        r.pos = end;
    }

    void skip_segment(Reader& r) {
        uint32_t len = r.u16();
        if (len < 2) fail(kCorrupt, "marker segment length %u", len);
        r.need(len - 2);
        r.pos += len - 2;
    }

    void parse() {
        Reader r(cs, n);
        if (r.u16() != 0xFF4F) fail(kCorrupt, "no SOC marker");
        if (r.u16() != 0xFF51) fail(kCorrupt, "SIZ does not follow SOC");
        read_siz(r);
        // main header
        for (;;) {
            uint32_t m = r.u16();
            if (m == 0xFF90) break;
            switch (m) {
                case 0xFF52: read_cod(r, main); break;
                case 0xFF53: read_coc(r, main); break;
                case 0xFF5C: read_qcd(r, main); break;
                case 0xFF5D: read_qcc(r, main); break;
                case 0xFF5E: read_rgn(r, main); break;
                case 0xFF5F: read_poc(r, main); break;
                case 0xFF60: {  // PPM
                    uint32_t len = r.u16();
                    if (len < 3) fail(kCorrupt, "PPM length %u", len);
                    r.need(len - 2);
                    int z = int(r.u8());
                    ppm_parts.emplace_back(z, std::vector<uint8_t>(r.p + r.pos, r.p + r.pos + len - 3));
                    r.pos += len - 3;
                    have_ppm = true;
                    break;
                }
                case 0xFFD9: fail(kCorrupt, "codestream ends in its main header");
                default:
                    if ((m >> 8) != 0xFF) fail(kCorrupt, "expected a marker, found 0x%04x", m);
                    skip_segment(r);
            }
        }
        if (!main.cod_seen || !main.qcd_seen) fail(kCorrupt, "main header lacks COD or QCD");
        if (have_ppm) {
            std::stable_sort(ppm_parts.begin(), ppm_parts.end(),
                             [](const auto& a, const auto& b) { return a.first < b.first; });
            for (auto& p : ppm_parts) ppm_all.insert(ppm_all.end(), p.second.begin(), p.second.end());
        }
        // tile-parts; r.pos is just past an SOT marker
        for (;;) {
            size_t sot = r.pos - 2;
            uint32_t lsot = r.u16();
            if (lsot != 10) fail(kCorrupt, "SOT length %u", lsot);
            uint32_t isot = r.u16();
            uint32_t psot = r.u32();
            r.u8();  // TPsot
            r.u8();  // TNsot
            if (isot >= tiles.size()) fail(kCorrupt, "tile index %u of %zu", isot, tiles.size());
            size_t part_end = psot == 0 ? n : sot + psot;
            if (psot != 0 && (psot < 14 || part_end > n))
                fail(kCorrupt, "tile-part length %u overruns the codestream", psot);
            TileData& t = tiles[isot];
            if (!t.seen) {
                t.seen = true;
                t.coding = main;
                t.coding.pocs = main.pocs;
                std::fill(t.coding.coc_set.begin(), t.coding.coc_set.end(), 0);
                std::fill(t.coding.qcc_set.begin(), t.coding.qcc_set.end(), 0);
            }
            bool tile_poc = false;
            for (;;) {
                uint32_t m = r.u16();
                if (m == 0xFF93) break;
                switch (m) {
                    case 0xFF52: read_cod(r, t.coding); break;
                    case 0xFF53: read_coc(r, t.coding); break;
                    case 0xFF5C: read_qcd(r, t.coding); break;
                    case 0xFF5D: read_qcc(r, t.coding); break;
                    case 0xFF5E: read_rgn(r, t.coding); break;
                    case 0xFF5F:
                        if (!tile_poc && t.parts == 0) t.coding.pocs.clear();
                        tile_poc = true;
                        read_poc(r, t.coding);
                        break;
                    case 0xFF61: {  // PPT
                        uint32_t len = r.u16();
                        if (len < 3) fail(kCorrupt, "PPT length %u", len);
                        r.need(len - 2);
                        int z = int(r.u8());
                        t.ppt_parts.emplace_back(z, std::vector<uint8_t>(r.p + r.pos, r.p + r.pos + len - 3));
                        r.pos += len - 3;
                        t.packed = true;
                        break;
                    }
                    case 0xFFD9: fail(kCorrupt, "codestream ends in a tile-part header");
                    default:
                        if ((m >> 8) != 0xFF) fail(kCorrupt, "expected a marker, found 0x%04x", m);
                        skip_segment(r);
                }
                if (r.pos > part_end) fail(kCorrupt, "tile-part header overruns its tile-part");
            }
            if (have_ppm) {
                if (ppm_pos + 4 > ppm_all.size()) fail(kCorrupt, "PPM headers end before tile-part %d", t.parts);
                uint32_t nppm = (uint32_t(ppm_all[ppm_pos]) << 24) | (ppm_all[ppm_pos + 1] << 16) |
                                (ppm_all[ppm_pos + 2] << 8) | ppm_all[ppm_pos + 3];
                ppm_pos += 4;
                if (ppm_pos + nppm > ppm_all.size()) fail(kCorrupt, "PPM headers overrun");
                t.ppm.insert(t.ppm.end(), ppm_all.begin() + ppm_pos, ppm_all.begin() + ppm_pos + nppm);
                ppm_pos += nppm;
                t.packed = true;
            }
            if (part_end < r.pos) fail(kCorrupt, "tile-part ends before its data");
            size_t data_end = part_end;
            if (psot == 0) {
                // to the EOC marker
                if (n >= r.pos + 2 && cs[n - 2] == 0xFF && cs[n - 1] == 0xD9) data_end = n - 2;
            }
            t.data.insert(t.data.end(), cs + r.pos, cs + data_end);
            ++t.parts;
            r.pos = part_end;
            if (psot == 0) break;  // the tile-part ran to the EOC
            // opj_j2k_decode_tile reads the marker after a tile's data:
            // fewer than 2 bytes there is "Stream too short", and a marker
            // other than SOT or EOC is tolerated only as the last 2 bytes
            if (r.pos + 2 > n) fail(kCorrupt, "Stream too short (no EOC after the last tile-part)");
            uint32_t m = r.u16();
            if (m == 0xFFD9) break;
            if (m != 0xFF90) {
                if (r.pos == n) break;  // "Stream does not end with EOC", a warning
                fail(kCorrupt, "expected SOT or EOC, found 0x%04x", m);
            }
        }
        for (TileData& t : tiles) {
            if (!t.ppt_parts.empty()) {
                std::stable_sort(t.ppt_parts.begin(), t.ppt_parts.end(),
                                 [](const auto& a, const auto& b) { return a.first < b.first; });
                for (auto& p : t.ppt_parts) t.ppt.insert(t.ppt.end(), p.second.begin(), p.second.end());
                t.ppt_parts.clear();
            }
        }
    }

    // ------------------------------------------------------------ tile

    void layout(int tileno, std::vector<TileComp>& tcs, int64_t& tx0, int64_t& ty0, int64_t& tx1,
                int64_t& ty1) {
        const Coding& cd = tiles[tileno].coding;
        int p = tileno % img.ntx, q = tileno / img.ntx;
        tx0 = std::max<int64_t>(int64_t(img.tx0) + int64_t(p) * img.tw, img.x0);
        ty0 = std::max<int64_t>(int64_t(img.ty0) + int64_t(q) * img.th, img.y0);
        tx1 = std::min<int64_t>(int64_t(img.tx0) + int64_t(p + 1) * img.tw, img.xsiz);
        ty1 = std::min<int64_t>(int64_t(img.ty0) + int64_t(q + 1) * img.th, img.ysiz);
        tcs.resize(img.comps.size());
        uint64_t total_cblks = 0, total_precincts = 0;
        for (size_t c = 0; c < img.comps.size(); ++c) {
            const Comp& cp = img.comps[c];
            const CompCoding& cc = cd.cc[c];
            const CompQuant& cq = cd.cq[c];
            TileComp& tc = tcs[c];
            tc.x0 = ceildiv(tx0, cp.dx);
            tc.y0 = ceildiv(ty0, cp.dy);
            tc.x1 = ceildiv(tx1, cp.dx);
            tc.y1 = ceildiv(ty1, cp.dy);
            int numres = cc.nl + 1;
            if (cq.qntsty != 1 && cq.nsteps < 3 * cc.nl + 1)
                fail(kCorrupt, "component %zu has %d step sizes for %d levels", c, cq.nsteps, cc.nl);
            tc.res.assign(numres, Res());
            for (int r = 0; r < numres; ++r) {
                Res& rs = tc.res[r];
                int levelno = numres - 1 - r;
                rs.x0 = ceildivpow2(tc.x0, levelno);
                rs.y0 = ceildivpow2(tc.y0, levelno);
                rs.x1 = ceildivpow2(tc.x1, levelno);
                rs.y1 = ceildivpow2(tc.y1, levelno);
                rs.pdx = cc.ppx[r];
                rs.pdy = cc.ppy[r];
                int64_t px0 = floordivpow2(rs.x0, rs.pdx) << rs.pdx;
                int64_t py0 = floordivpow2(rs.y0, rs.pdy) << rs.pdy;
                int64_t px1 = ceildivpow2(rs.x1, rs.pdx) << rs.pdx;
                int64_t py1 = ceildivpow2(rs.y1, rs.pdy) << rs.pdy;
                rs.pw = rs.x0 == rs.x1 ? 0 : int((px1 - px0) >> rs.pdx);
                rs.ph = rs.y0 == rs.y1 ? 0 : int((py1 - py0) >> rs.pdy);
                total_precincts += uint64_t(rs.pw) * rs.ph;
                if (total_precincts > (uint64_t(1) << 21))
                    fail(kCorrupt, "%d x %d precincts", rs.pw, rs.ph);
                int64_t cbgx0, cbgy0;
                int cbgw, cbgh, cbw, cbh;
                if (r == 0) {
                    cbgx0 = px0;
                    cbgy0 = py0;
                    cbgw = rs.pdx;
                    cbgh = rs.pdy;
                } else {
                    cbgx0 = ceildivpow2(px0, 1);
                    cbgy0 = ceildivpow2(py0, 1);
                    cbgw = rs.pdx - 1;
                    cbgh = rs.pdy - 1;
                }
                cbw = std::min(cc.xcb, cbgw);
                cbh = std::min(cc.ycb, cbgh);
                rs.nbands = r == 0 ? 1 : 3;
                for (int b = 0; b < rs.nbands; ++b) {
                    Band& bd = rs.bands[b];
                    int bandno = r == 0 ? 0 : b + 1;
                    bd.orient = bandno;
                    if (r == 0) {
                        bd.x0 = rs.x0;
                        bd.y0 = rs.y0;
                        bd.x1 = rs.x1;
                        bd.y1 = rs.y1;
                    } else {
                        int64_t xob = bandno & 1, yob = (bandno >> 1) & 1;
                        bd.x0 = ceildivpow2(tc.x0 - (xob << levelno), levelno + 1);
                        bd.y0 = ceildivpow2(tc.y0 - (yob << levelno), levelno + 1);
                        bd.x1 = ceildivpow2(tc.x1 - (xob << levelno), levelno + 1);
                        bd.y1 = ceildivpow2(tc.y1 - (yob << levelno), levelno + 1);
                    }
                    const StepSize& ss = cq.steps[r == 0 ? 0 : 3 * (r - 1) + b + 1];
                    bd.numbps = ss.expn + cq.guard - 1;
                    // the decoder's irreversible step (OpenJPEG: no
                    // sub-band gain here, balanced by its 2/K in the DWT)
                    int rb = cp.prec + ((cc.qmfbid == 0) ? 0 : (bandno == 0 ? 0 : (bandno == 3 ? 2 : 1)));
                    bd.stepsize = float((1.0 + ss.mant / 2048.0) * std::pow(2.0, double(rb - ss.expn)));
                }
                rs.prec.assign(size_t(rs.pw) * rs.ph * rs.nbands, PrecBand());
                for (int pno = 0; pno < rs.pw * rs.ph; ++pno) {
                    int64_t gx0 = cbgx0 + int64_t(pno % rs.pw) * (int64_t(1) << cbgw);
                    int64_t gy0 = cbgy0 + int64_t(pno / rs.pw) * (int64_t(1) << cbgh);
                    int64_t gx1 = gx0 + (int64_t(1) << cbgw);
                    int64_t gy1 = gy0 + (int64_t(1) << cbgh);
                    for (int b = 0; b < rs.nbands; ++b) {
                        Band& bd = rs.bands[b];
                        PrecBand& pb = rs.prec[size_t(pno) * rs.nbands + b];
                        int64_t x0 = std::max(gx0, bd.x0), y0 = std::max(gy0, bd.y0);
                        int64_t x1 = std::min(gx1, bd.x1), y1 = std::min(gy1, bd.y1);
                        int64_t cx0 = floordivpow2(x0, cbw) << cbw;
                        int64_t cy0 = floordivpow2(y0, cbh) << cbh;
                        int64_t cx1 = ceildivpow2(x1, cbw) << cbw;
                        int64_t cy1 = ceildivpow2(y1, cbh) << cbh;
                        pb.cw = int(std::max<int64_t>(0, (cx1 - cx0) >> cbw));
                        pb.ch = int(std::max<int64_t>(0, (cy1 - cy0) >> cbh));
                        if (bd.empty()) pb.cw = pb.ch = 0;
                        total_cblks += uint64_t(pb.cw) * pb.ch;
                        if (total_cblks > (uint64_t(1) << 21)) fail(kCorrupt, "too many code-blocks");
                        pb.cblks.resize(size_t(pb.cw) * pb.ch);
                        for (int j = 0; j < pb.ch; ++j)
                            for (int i = 0; i < pb.cw; ++i) {
                                Cblk& cb = pb.cblks[size_t(j) * pb.cw + i];
                                int64_t bx0 = cx0 + (int64_t(i) << cbw), by0 = cy0 + (int64_t(j) << cbh);
                                cb.x0 = int(std::max(bx0, x0));
                                cb.y0 = int(std::max(by0, y0));
                                cb.x1 = int(std::min(bx0 + (int64_t(1) << cbw), x1));
                                cb.y1 = int(std::min(by0 + (int64_t(1) << cbh), y1));
                            }
                        pb.incl.build(pb.cw, pb.ch);
                        pb.imsb.build(pb.cw, pb.ch);
                    }
                }
            }
        }
    }

    // --------------------------------------------------------- tier-2

    struct Stream {
        const std::vector<uint8_t>* data;
        size_t pos;
        const std::vector<uint8_t>* hdr;  // packed headers or null
        size_t hpos;
    };

    static int numpasses(Bio& b) {
        if (!b.bit()) return 1;
        if (!b.bit()) return 2;
        uint32_t n = b.read(2);
        if (n != 3) return 3 + int(n);
        n = b.read(5);
        if (n != 31) return 6 + int(n);
        return 37 + int(b.read(7));
    }

    static void init_seg(Cblk& cb, int cblksty, bool first) {
        Seg s;
        if (cblksty & CBLK_TERMALL) s.maxpasses = 1;
        else if (cblksty & CBLK_LAZY) {
            if (first) s.maxpasses = 10;
            else {
                int prev = cb.segs.back().maxpasses;
                s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
            }
        } else {
            s.maxpasses = 109;
        }
        cb.segs.push_back(s);
    }

    void read_packet(Stream& st, const Coding& cd, TileComp& tc, int r, int pno, int layer, int cblksty) {
        const std::vector<uint8_t>& data = *st.data;
        if ((cd.csty & 2) && st.pos + 6 <= data.size() && data[st.pos] == 0xFF && data[st.pos + 1] == 0x91)
            st.pos += 6;
        const std::vector<uint8_t>& hsrc = st.hdr ? *st.hdr : data;
        size_t& hp = st.hdr ? st.hpos : st.pos;
        if (hp > hsrc.size()) fail(kCorrupt, "packet header past the end of its data");
        Res& rs = tc.res[r];
        Bio bio;
        bio.init(hsrc.data() + hp, hsrc.size() - hp);
        bool present = bio.bit();
        if (present) {
            for (int b = 0; b < rs.nbands; ++b) {
                Band& bd = rs.bands[b];
                if (bd.empty()) continue;
                PrecBand& pb = rs.prec[size_t(pno) * rs.nbands + b];
                for (size_t k = 0; k < pb.cblks.size(); ++k) {
                    Cblk& cb = pb.cblks[k];
                    int included;
                    if (cb.segs.empty()) included = tgt_decode(bio, pb.incl, int(k), layer + 1);
                    else included = bio.bit();
                    if (!included) {
                        cb.numnewpasses = 0;
                        continue;
                    }
                    if (cb.segs.empty()) {
                        int i = 0;
                        while (!tgt_decode(bio, pb.imsb, int(k), i)) {
                            if (++i > 74 || bio.overrun) fail(kCorrupt, "zero bit-plane tag tree does not end");
                        }
                        cb.numbps = bd.numbps + 1 - i;
                        cb.numlenbits = 3;
                    }
                    cb.numnewpasses = numpasses(bio);
                    int incr = 0;
                    while (bio.bit()) {
                        if (++incr > 32 || bio.overrun) fail(kCorrupt, "Lblock increment does not end");
                    }
                    cb.numlenbits += incr;
                    int segno;
                    if (cb.segs.empty()) {
                        init_seg(cb, cblksty, true);
                        segno = 0;
                    } else {
                        segno = int(cb.segs.size()) - 1;
                        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                            init_seg(cb, cblksty, false);
                            ++segno;
                        }
                    }
                    cb.first_new_seg = segno;
                    int left = cb.numnewpasses;
                    for (;;) {
                        Seg& s = cb.segs[segno];
                        s.numnewpasses = std::min(s.maxpasses - s.numpasses, left);
                        int bits = cb.numlenbits + floorlog2(uint32_t(s.numnewpasses));
                        if (bits > 32) fail(kCorrupt, "segment length of %d bits", bits);
                        s.newlen = bits == 32 ? bio.read(32) : bio.read(bits);
                        left -= s.numnewpasses;
                        if (left <= 0) break;
                        init_seg(cb, cblksty, false);
                        ++segno;
                        if (cb.segs.size() > 400) fail(kCorrupt, "too many code-block segments");
                    }
                    if (bio.overrun) fail(kCorrupt, "packet header overruns its data");
                }
            }
        }
        bio.inalign();
        if (bio.overrun) fail(kCorrupt, "packet header overruns its data");
        hp += bio.numbytes();
        if ((cd.csty & 4) && hp + 2 <= hsrc.size() && hsrc[hp] == 0xFF && hsrc[hp + 1] == 0x92) hp += 2;
        if (!present) return;
        for (int b = 0; b < rs.nbands; ++b) {
            Band& bd = rs.bands[b];
            if (bd.empty()) continue;
            PrecBand& pb = rs.prec[size_t(pno) * rs.nbands + b];
            for (Cblk& cb : pb.cblks) {
                if (!cb.numnewpasses) continue;
                int left = cb.numnewpasses;
                for (int segno = cb.first_new_seg; left > 0; ++segno) {
                    Seg& s = cb.segs[segno];
                    if (s.newlen > data.size() - st.pos)
                        fail(kCorrupt, "code-block data overruns the tile (%u bytes)", s.newlen);
                    cb.data.insert(cb.data.end(), data.begin() + st.pos, data.begin() + st.pos + s.newlen);
                    st.pos += s.newlen;
                    s.len += s.newlen;
                    s.numpasses += s.numnewpasses;
                    left -= s.numnewpasses;
                    if (cb.data.size() > (size_t(1) << 28)) fail(kCorrupt, "code-block data too large");
                }
                cb.numnewpasses = 0;
            }
        }
    }

    // packet order (Annex B.12)
    template <class F>
    void progression(const Coding& cd, std::vector<TileComp>& tcs, int64_t tx0, int64_t ty0, int64_t tx1,
                     int64_t ty1, F&& packet) {
        int ncomp = int(img.comps.size());
        int maxres = 0;
        for (int c = 0; c < ncomp; ++c) maxres = std::max(maxres, cd.cc[c].nl + 1);
        std::vector<Poc> pocs = cd.pocs;
        if (pocs.empty()) pocs.push_back(Poc{0, 0, cd.nlayers, maxres, ncomp, cd.prg});
        // a (res, comp, precinct) meets its layers in increasing order in
        // every progression, so the packets read so far are a prefix of
        // its layers: one counter each marks a packet read once
        std::vector<std::vector<std::vector<int>>> next_layer(maxres);
        for (int r = 0; r < maxres; ++r) {
            next_layer[r].resize(ncomp);
            for (int c = 0; c < ncomp; ++c)
                if (r < int(tcs[c].res.size()))
                    next_layer[r][c].assign(size_t(tcs[c].res[r].pw) * tcs[c].res[r].ph, 0);
        }
        auto emit = [&](int l, int r, int c, int p) {
            int& next = next_layer[r][c][p];
            if (l < next) return;
            next = l + 1;
            packet(l, r, c, p);
        };
        // the position step for the precinct-driven orders
        auto steps = [&](int c0, int c1, uint64_t& dx, uint64_t& dy) {
            dx = dy = 0;
            for (int c = c0; c < c1; ++c) {
                const Comp& cp = img.comps[c];
                int numres = int(tcs[c].res.size());
                for (int r = 0; r < numres; ++r) {
                    const Res& rs = tcs[c].res[r];
                    int ex = rs.pdx + numres - 1 - r, ey = rs.pdy + numres - 1 - r;
                    if (ex < 32) {
                        uint64_t v = uint64_t(cp.dx) << ex;
                        if (v <= 0xFFFFFFFFull) dx = dx ? std::min(dx, v) : v;
                    }
                    if (ey < 32) {
                        uint64_t v = uint64_t(cp.dy) << ey;
                        if (v <= 0xFFFFFFFFull) dy = dy ? std::min(dy, v) : v;
                    }
                }
            }
            if (dx == 0 || dy == 0) fail(kCorrupt, "no precinct step for the progression");
        };
        // the precinct of (c, r) that starts at reference-grid (x, y), or -1
        auto precinct_at = [&](int c, int r, uint64_t x, uint64_t y) -> int {
            const Comp& cp = img.comps[c];
            int numres = int(tcs[c].res.size());
            if (r >= numres) return -1;
            const Res& rs = tcs[c].res[r];
            int levelno = numres - 1 - r;
            if (levelno >= 32) return -1;
            uint64_t cdx = uint64_t(cp.dx) << levelno, cdy = uint64_t(cp.dy) << levelno;
            if (cdx > 0x7FFFFFFF || cdy > 0x7FFFFFFF) return -1;
            uint64_t trx0 = ceildiv(tx0, cdx), try0 = ceildiv(ty0, cdy);
            uint64_t trx1 = ceildiv(tx1, cdx), try1 = ceildiv(ty1, cdy);
            int rpx = rs.pdx + levelno, rpy = rs.pdy + levelno;
            if (rpx >= 31 || rpy >= 31) return -1;
            if (!((y % (uint64_t(cp.dy) << rpy) == 0) ||
                  (y == uint64_t(ty0) && ((try0 << levelno) % (uint64_t(1) << rpy)))))
                return -1;
            if (!((x % (uint64_t(cp.dx) << rpx) == 0) ||
                  (x == uint64_t(tx0) && ((trx0 << levelno) % (uint64_t(1) << rpx)))))
                return -1;
            if (rs.pw == 0 || rs.ph == 0) return -1;
            if (trx0 == trx1 || try0 == try1) return -1;
            uint64_t prci = (ceildiv(x, cdx) >> rs.pdx) - (trx0 >> rs.pdx);
            uint64_t prcj = (ceildiv(y, cdy) >> rs.pdy) - (try0 >> rs.pdy);
            uint64_t p = prci + prcj * uint64_t(rs.pw);
            if (p >= uint64_t(rs.pw) * rs.ph) fail(kCorrupt, "precinct index out of range");
            return int(p);
        };
        for (const Poc& poc : pocs) {
            int l1 = std::min(poc.le, cd.nlayers), c0 = poc.cs, c1 = std::min(poc.ce, ncomp);
            int r0 = poc.rs, r1 = poc.re;
            if (c0 >= ncomp) fail(kCorrupt, "POC starts at component %d", c0);
            switch (poc.prg) {
                case 0:  // LRCP
                    for (int l = 0; l < l1; ++l)
                        for (int r = r0; r < r1; ++r)
                            for (int c = c0; c < c1; ++c) {
                                if (r >= int(tcs[c].res.size())) continue;
                                const Res& rs = tcs[c].res[r];
                                for (int p = 0; p < rs.pw * rs.ph; ++p) emit(l, r, c, p);
                            }
                    break;
                case 1:  // RLCP
                    for (int r = r0; r < r1; ++r)
                        for (int l = 0; l < l1; ++l)
                            for (int c = c0; c < c1; ++c) {
                                if (r >= int(tcs[c].res.size())) continue;
                                const Res& rs = tcs[c].res[r];
                                for (int p = 0; p < rs.pw * rs.ph; ++p) emit(l, r, c, p);
                            }
                    break;
                case 2: {  // RPCL
                    uint64_t dx, dy;
                    steps(0, ncomp, dx, dy);
                    for (int r = r0; r < r1; ++r)
                        for (uint64_t y = ty0; y < uint64_t(ty1); y += dy - (y % dy))
                            for (uint64_t x = tx0; x < uint64_t(tx1); x += dx - (x % dx))
                                for (int c = c0; c < c1; ++c) {
                                    int p = precinct_at(c, r, x, y);
                                    if (p < 0) continue;
                                    for (int l = 0; l < l1; ++l) emit(l, r, c, p);
                                }
                    break;
                }
                case 3: {  // PCRL
                    uint64_t dx, dy;
                    steps(0, ncomp, dx, dy);
                    for (uint64_t y = ty0; y < uint64_t(ty1); y += dy - (y % dy))
                        for (uint64_t x = tx0; x < uint64_t(tx1); x += dx - (x % dx))
                            for (int c = c0; c < c1; ++c) {
                                int rmax = std::min(r1, int(tcs[c].res.size()));
                                for (int r = r0; r < rmax; ++r) {
                                    int p = precinct_at(c, r, x, y);
                                    if (p < 0) continue;
                                    for (int l = 0; l < l1; ++l) emit(l, r, c, p);
                                }
                            }
                    break;
                }
                case 4: {  // CPRL
                    for (int c = c0; c < c1; ++c) {
                        uint64_t dx, dy;
                        steps(c, c + 1, dx, dy);
                        int rmax = std::min(r1, int(tcs[c].res.size()));
                        for (uint64_t y = ty0; y < uint64_t(ty1); y += dy - (y % dy))
                            for (uint64_t x = tx0; x < uint64_t(tx1); x += dx - (x % dx))
                                for (int r = r0; r < rmax; ++r) {
                                    int p = precinct_at(c, r, x, y);
                                    if (p < 0) continue;
                                    for (int l = 0; l < l1; ++l) emit(l, r, c, p);
                                }
                    }
                    break;
                }
            }
        }
    }

    // ----------------------------------------------------------- DWT

    static void idwt53_1d(int32_t* x, int n, int cas) {
        if (n == 1) {
            if (cas) x[0] /= 2;
            return;
        }
        auto at = [&](int i) -> int64_t {
            if (i < 0) i = -i;
            if (i >= n) i = 2 * (n - 1) - i;
            return x[i];
        };
        // even (low-pass) samples first, then odd; parity is global
        for (int i = cas ? 1 : 0; i < n; i += 2)
            x[i] = int32_t(uint32_t(int64_t(x[i]) - ((at(i - 1) + at(i + 1) + 2) >> 2)));
        for (int i = cas ? 0 : 1; i < n; i += 2)
            x[i] = int32_t(uint32_t(int64_t(x[i]) + ((at(i - 1) + at(i + 1)) >> 1)));
    }

    // OpenJPEG's opj_v8dwt_decode, one lane
    static void step2(float* l, float* w, int end, int m, float c) {
        int imax = std::min(end, m);
        float tmp1 = l[0];
        float* vw = w;
        for (int i = 0; i < imax; ++i) {
            float tmp2 = vw[-1], tmp3 = vw[0];
            vw[-1] = tmp2 + ((tmp1 + tmp3) * c);
            tmp1 = tmp3;
            vw += 2;
        }
        if (m < end) {
            float c2 = c + c;
            c2 = c2 * vw[-2];
            vw[-1] = vw[-1] + c2;
        }
    }

    static void idwt97_1d(float* x, int sn, int dn, int cas) {
        const float alpha = -1.586134342f, beta = -0.052980118f, gamma = 0.882911075f,
                    delta = 0.443506852f, K = 1.230174105f, two_invK = 1.625732422f;
        int a, b;
        if (cas == 0) {
            if (!(dn > 0 || sn > 1)) return;
            a = 0;
            b = 1;
        } else {
            if (!(sn > 0 || dn > 1)) return;
            a = 1;
            b = 0;
        }
        for (int i = 0; i < sn; ++i) x[a + 2 * i] = x[a + 2 * i] * K;
        for (int i = 0; i < dn; ++i) x[b + 2 * i] = x[b + 2 * i] * two_invK;
        step2(x + b, x + a + 1, sn, std::min(sn, dn - a), -delta);
        step2(x + a, x + b + 1, dn, std::min(dn, sn - b), -gamma);
        step2(x + b, x + a + 1, sn, std::min(sn, dn - a), -beta);
        step2(x + a, x + b + 1, dn, std::min(dn, sn - b), -alpha);
    }

    template <class T, class F>
    static void idwt2d(T* data, int w, const TileComp& tc, F&& one_d) {
        int numres = int(tc.res.size());
        std::vector<T> buf;
        for (int r = 1; r < numres; ++r) {
            const Res& lo = tc.res[r - 1];
            const Res& hi = tc.res[r];
            int sn = int(lo.x1 - lo.x0), rw = int(hi.x1 - hi.x0);
            int snv = int(lo.y1 - lo.y0), rh = int(hi.y1 - hi.y0);
            int cas = int(hi.x0 & 1), casv = int(hi.y0 & 1);
            // padded by 2 so the 9/7 lanes may read one past either end
            buf.assign(size_t(std::max(rw, rh)) + 4, T(0));
            T* b = buf.data() + 2;
            for (int y = 0; y < rh; ++y) {
                T* row = data + size_t(y) * w;
                for (int i = 0; i < sn; ++i) b[cas + 2 * i] = row[i];
                for (int i = 0; i < rw - sn; ++i) b[1 - cas + 2 * i] = row[sn + i];
                one_d(b, sn, rw - sn, cas);
                for (int i = 0; i < rw; ++i) row[i] = b[i];
            }
            for (int x = 0; x < rw; ++x) {
                T* col = data + x;
                for (int i = 0; i < snv; ++i) b[casv + 2 * i] = col[size_t(i) * w];
                for (int i = 0; i < rh - snv; ++i) b[1 - casv + 2 * i] = col[size_t(snv + i) * w];
                one_d(b, snv, rh - snv, casv);
                for (int i = 0; i < rh; ++i) col[size_t(i) * w] = b[i];
            }
        }
    }

    // --------------------------------------------------------- decode

    void decode_tile(int tileno, uint8_t* out, int es, bool planar = false) {
        TileData& td = tiles[tileno];
        if (!td.seen) fail(kCorrupt, "tile %d has no tile-part", tileno);
        const Coding& cd = td.coding;
        int ncomp = int(img.comps.size());
        std::vector<TileComp> tcs;
        int64_t tx0, ty0, tx1, ty1;
        layout(tileno, tcs, tx0, ty0, tx1, ty1);
        Stream st{&td.data, 0, nullptr, 0};
        if (td.packed) st.hdr = td.ppm.empty() ? &td.ppt : &td.ppm;
        progression(cd, tcs, tx0, ty0, tx1, ty1, [&](int l, int r, int c, int p) {
            read_packet(st, cd, tcs[c], r, p, l, cd.cc[c].cblksty);
        });
        // tier-1 and reconstruction per component
        std::vector<std::vector<int32_t>> idata(ncomp);
        std::vector<std::vector<float>> fdata(ncomp);
        T1 t1;
        for (int c = 0; c < ncomp; ++c) {
            const CompCoding& cc = cd.cc[c];
            TileComp& tc = tcs[c];
            int w = int(tc.x1 - tc.x0), h = int(tc.y1 - tc.y0);
            bool rev = cc.qmfbid == 1;
            if (rev) idata[c].assign(size_t(w) * h, 0);
            else fdata[c].assign(size_t(w) * h, 0.0f);
            for (size_t r = 0; r < tc.res.size(); ++r) {
                Res& rs = tc.res[r];
                for (int b = 0; b < rs.nbands; ++b) {
                    Band& bd = rs.bands[b];
                    if (bd.empty()) continue;
                    int64_t xoff = 0, yoff = 0;
                    if (r > 0) {
                        const Res& pr = tc.res[r - 1];
                        if (bd.orient & 1) xoff = pr.x1 - pr.x0;
                        if (bd.orient & 2) yoff = pr.y1 - pr.y0;
                    }
                    for (int pno = 0; pno < rs.pw * rs.ph; ++pno) {
                        PrecBand& pb = rs.prec[size_t(pno) * rs.nbands + b];
                        for (Cblk& cb : pb.cblks) {
                            int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
                            if (cw <= 0 || ch <= 0 || cb.segs.empty()) continue;
                            decode_cblk(t1, cb, bd.orient, cd.roishift[c], cc.cblksty);
                            int64_t ox = cb.x0 - bd.x0 + xoff, oy = cb.y0 - bd.y0 + yoff;
                            for (int j = 0; j < ch; ++j) {
                                const int32_t* src = &t1.data[size_t(j) * cw];
                                if (rev) {
                                    int32_t* dst = &idata[c][size_t(oy + j) * w + ox];
                                    for (int i = 0; i < cw; ++i) dst[i] = src[i] / 2;
                                } else {
                                    const float step = 0.5f * bd.stepsize;
                                    float* dst = &fdata[c][size_t(oy + j) * w + ox];
                                    for (int i = 0; i < cw; ++i) dst[i] = float(src[i]) * step;
                                }
                            }
                            std::vector<uint8_t>().swap(cb.data);
                        }
                    }
                }
            }
            if (rev)
                idwt2d(idata[c].data(), w, tc, [](int32_t* x, int sn, int dn, int cas) {
                    idwt53_1d(x, sn + dn, cas);
                });
            else
                idwt2d(fdata[c].data(), w, tc, [](float* x, int sn, int dn, int cas) {
                    idwt97_1d(x, sn, dn, cas);
                });
        }
        // inverse component transform
        if (cd.mct == 1 && ncomp >= 3) {
            size_t n0 = idata[0].size() + fdata[0].size();
            bool same = true;
            for (int c = 1; c < 3; ++c)
                if (idata[c].size() + fdata[c].size() != n0 ||
                    tcs[c].x1 - tcs[c].x0 != tcs[0].x1 - tcs[0].x0)
                    same = false;
            // opj_tcd_mct_decode refuses components of other sizes
            if (!same) fail(kCorrupt, "Tiles don't all have the same dimension (component transform)");
            {
                bool rev = cd.cc[0].qmfbid == 1;
                for (int c = 1; c < 3; ++c)
                    if ((cd.cc[c].qmfbid == 1) != rev)
                        fail(kUnsupported, "component transform over mixed wavelets");
                if (rev) {
                    int32_t *c0 = idata[0].data(), *c1 = idata[1].data(), *c2 = idata[2].data();
                    for (size_t i = 0; i < n0; ++i) {
                        int32_t y = c0[i], u = c1[i], v = c2[i];
                        int32_t g = y - ((u + v) >> 2);
                        c0[i] = v + g;
                        c1[i] = g;
                        c2[i] = u + g;
                    }
                } else {
                    float *c0 = fdata[0].data(), *c1 = fdata[1].data(), *c2 = fdata[2].data();
                    for (size_t i = 0; i < n0; ++i) {
                        float y = c0[i], u = c1[i], v = c2[i];
                        float r = y + (v * 1.402f);
                        float g = y - (u * 0.34413f) - (v * (0.71414f));
                        float b = y + (u * 1.772f);
                        c0[i] = r;
                        c1[i] = g;
                        c2[i] = b;
                    }
                }
            }
        }
        // DC level shift, clamp, store
        int W = int(img.xsiz - img.x0);
        size_t plane_off = 0;
        for (int c = 0; c < ncomp; ++c) {
            const Comp& cp = img.comps[c];
            TileComp& tc = tcs[c];
            const int64_t cx0 = ceildiv(img.x0, cp.dx), cy0 = ceildiv(img.y0, cp.dy);
            const int64_t cw = ceildiv(img.xsiz, cp.dx) - cx0, ch = ceildiv(img.ysiz, cp.dy) - cy0;
            int w = int(tc.x1 - tc.x0), h = int(tc.y1 - tc.y0);
            int64_t lo, hi, shift;
            if (cp.sgnd) {
                lo = -(int64_t(1) << (cp.prec - 1));
                hi = (int64_t(1) << (cp.prec - 1)) - 1;
                shift = 0;
            } else {
                lo = 0;
                hi = (int64_t(1) << cp.prec) - 1;
                shift = int64_t(1) << (cp.prec - 1);
            }
            bool rev = cd.cc[c].qmfbid == 1;
            for (int y = 0; y < h; ++y) {
                size_t orow = planar ? plane_off + size_t(tc.y0 - cy0 + y) * cw + size_t(tc.x0 - cx0)
                                     : size_t(tc.y0 - img.y0 + y) * W + size_t(tc.x0 - img.x0);
                for (int x = 0; x < w; ++x) {
                    int64_t v;
                    if (rev) {
                        v = int64_t(idata[c][size_t(y) * w + x]) + shift;
                    } else {
                        float f = fdata[c][size_t(y) * w + x];
                        if (f > float(INT32_MAX)) v = hi;
                        else if (f < float(INT32_MIN)) v = lo;
                        else v = int64_t(std::lrint(f)) + shift;
                    }
                    v = std::max(lo, std::min(hi, v));
                    size_t oi = planar ? orow + x : (orow + x) * ncomp + c;
                    if (es == 1) out[oi] = uint8_t(v);
                    else if (es == 2) {
                        uint16_t s = uint16_t(v);
                        memcpy(out + oi * 2, &s, 2);
                    } else {
                        uint32_t s = uint32_t(v);
                        memcpy(out + oi * 4, &s, 4);
                    }
                }
            }
            plane_off += size_t(cw) * size_t(ch);
        }
    }

    void check_decodable() {
        for (const Comp& c : img.comps)
            if (c.dx != 1 || c.dy != 1)
                fail(kUnsupported, "subsampled components (XRsiz/YRsiz %d/%d)", c.dx, c.dy);
    }
};

int report(const J2KError& e, char* err, int errlen) {
    if (err && errlen > 0) {
        snprintf(err, size_t(errlen), "%s", e.msg.c_str());
    }
    return e.code;
}

}  // namespace

extern "C" {

int fc_j2k_info(const uint8_t* cs, uint64_t n, int64_t* info, int cap, char* err, int errlen) {
    try {
        Decoder d;
        d.cs = cs;
        d.n = size_t(n);
        Reader r(cs, size_t(n));
        if (r.u16() != 0xFF4F) fail(kCorrupt, "no SOC marker");
        if (r.u16() != 0xFF51) fail(kCorrupt, "SIZ does not follow SOC");
        d.read_siz(r);
        int nc = int(d.img.comps.size());
        if (cap < 3 + 4 * nc) fail(kUnsupported, "%d components", nc);
        info[0] = d.img.xsiz - d.img.x0;
        info[1] = d.img.ysiz - d.img.y0;
        info[2] = nc;
        for (int c = 0; c < nc; ++c) {
            info[3 + 4 * c] = d.img.comps[c].prec;
            info[4 + 4 * c] = d.img.comps[c].sgnd;
            info[5 + 4 * c] = d.img.comps[c].dx;
            info[6 + 4 * c] = d.img.comps[c].dy;
        }
        return 0;
    } catch (const J2KError& e) {
        return report(e, err, errlen);
    } catch (const std::bad_alloc&) {
        return report(J2KError{"out of memory", kCorrupt}, err, errlen);
    }
}

int fc_j2k_decode(const uint8_t* cs, uint64_t n, void* out, int elem_size, uint64_t out_elems, char* err,
                  int errlen) {
    try {
        Decoder d;
        d.cs = cs;
        d.n = size_t(n);
        d.parse();
        d.check_decodable();
        uint64_t need = uint64_t(d.img.xsiz - d.img.x0) * (d.img.ysiz - d.img.y0) * d.img.comps.size();
        if (out_elems != need) fail(kCorrupt, "output holds %llu samples, image %llu",
                                    (unsigned long long)out_elems, (unsigned long long)need);
        if (elem_size != 1 && elem_size != 2 && elem_size != 4) fail(kCorrupt, "element size %d", elem_size);
        for (size_t t = 0; t < d.tiles.size(); ++t) d.decode_tile(int(t), static_cast<uint8_t*>(out), elem_size);
        return 0;
    } catch (const J2KError& e) {
        return report(e, err, errlen);
    } catch (const std::bad_alloc&) {
        return report(J2KError{"out of memory", kCorrupt}, err, errlen);
    } catch (const std::length_error&) {
        return report(J2KError{"size out of range", kCorrupt}, err, errlen);
    }
}

// Each component at its own extent, one plane after the other (the
// samples fc_j2k_decode gives, for subsampled files too).
int fc_j2k_decode_planes(const uint8_t* cs, uint64_t n, void* out, int elem_size, uint64_t out_elems,
                         char* err, int errlen) {
    try {
        Decoder d;
        d.cs = cs;
        d.n = size_t(n);
        d.parse();
        uint64_t need = 0;
        for (const Comp& c : d.img.comps)
            need += uint64_t(ceildiv(d.img.xsiz, c.dx) - ceildiv(d.img.x0, c.dx)) *
                    uint64_t(ceildiv(d.img.ysiz, c.dy) - ceildiv(d.img.y0, c.dy));
        if (out_elems != need) fail(kCorrupt, "output holds %llu samples, image %llu",
                                    (unsigned long long)out_elems, (unsigned long long)need);
        if (elem_size != 1 && elem_size != 2 && elem_size != 4) fail(kCorrupt, "element size %d", elem_size);
        for (size_t t = 0; t < d.tiles.size(); ++t)
            d.decode_tile(int(t), static_cast<uint8_t*>(out), elem_size, true);
        return 0;
    } catch (const J2KError& e) {
        return report(e, err, errlen);
    } catch (const std::bad_alloc&) {
        return report(J2KError{"out of memory", kCorrupt}, err, errlen);
    } catch (const std::length_error&) {
        return report(J2KError{"size out of range", kCorrupt}, err, errlen);
    }
}

}  // extern "C"
