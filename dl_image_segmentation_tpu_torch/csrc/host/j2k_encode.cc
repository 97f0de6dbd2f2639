// Lossless JPEG 2000 Part-1 encoder: the codestream that encode_jp2
// (raster/jp2.py) wraps in JP2 boxes.
//
// By default it writes what PIL asks OpenJPEG for with
// irreversible=False: the reversible 5/3 wavelet, one tile, one quality
// layer, LRCP, 64x64 code-blocks, no precincts, two guard bits, no
// quantisation, and min(6, floor(log2(min(width, height))) + 1)
// resolutions (the rule OpenJPEG's output shows for small images). Every
// coefficient is coded to its last bit-plane, so the file decodes to its
// input exactly; its bytes need not equal OpenJPEG's.
//
// `options` turns on codestream features PIL's encoder cannot write, so
// that tests can hold the decoder (and this encoder) to OpenJPEG on them:
//   bits 0-5   code-block style: BYPASS 1, RESET 2, TERMALL 4, VSC 8,
//              PTERM 16 (flagged; terminated as usual), SEGSYM 32
//   bit 8 SOP, bit 9 EPH markers; bit 10 packet headers in PPT, bit 11
//   in PPM; bit 12 a POC marker (RLCP over resolutions 0-2, then CPRL);
//   bit 13 the reversible colour transform (3 or more components; PIL's
//   default writes none); bits 16-20 an RGN max-shift of that many
//   bit-planes (every coefficient is region of interest)
//
// C interface:
//   fc_j2k_encode(pixels, h, w, nc, prec, options, out, cap)
//     pixels: (h, w, nc) uint8 (prec <= 8) or uint16 samples.
//     Returns the codestream length, or < 0 (-1 bad arguments, -2 the
//     output buffer is too small).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

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
enum { CBLK_LAZY = 1, CBLK_RESET = 2, CBLK_TERMALL = 4, CBLK_VSC = 8, CBLK_PTERM = 16,
       CBLK_SEGSYM = 32 };
enum { OPT_SOP = 1 << 8, OPT_EPH = 1 << 9, OPT_PPT = 1 << 10, OPT_PPM = 1 << 11,
       OPT_POC = 1 << 12, OPT_MCT = 1 << 13 };

// MQ encoder (ISO/IEC 15444-1 Annex C.2) and the raw (BYPASS) coder
struct MQEnc {
    std::vector<uint8_t> out;  // out[0] is the dummy byte before the data
    uint32_t a, c, ct;
    uint32_t st[NCTX], mps[NCTX];  // not char: stores to them alias nothing

    void reset_states() {
        for (int i = 0; i < NCTX; ++i) st[i] = 0, mps[i] = 0;
        st[CTX_UNI] = 46;
        st[CTX_AGG] = 3;
        st[CTX_ZC] = 4;
    }
    void init() {  // INITENC: the contexts are kept
        out.assign(1, 0);
        a = 0x8000;
        c = 0;
        ct = 12;
    }
    void byteout() {
        uint8_t& b = out.back();
        if (b == 0xFF) {
            out.push_back(uint8_t(c >> 20));
            c &= 0xFFFFF;
            ct = 7;
        } else if (c < 0x8000000) {
            out.push_back(uint8_t(c >> 19));
            c &= 0x7FFFF;
            ct = 8;
        } else {
            ++b;
            if (b == 0xFF) {
                c &= 0x7FFFFFF;
                out.push_back(uint8_t(c >> 20));
                c &= 0xFFFFF;
                ct = 7;
            } else {
                out.push_back(uint8_t(c >> 19));
                c &= 0x7FFFF;
                ct = 8;
            }
        }
    }
    void renorm() {
        do {
            a <<= 1;
            c <<= 1;
            if (--ct == 0) byteout();
        } while (a < 0x8000);
    }
    void encode(int cx, int d) {
        const QeEntry& q = kQe[st[cx]];
        a -= q.qe;
        if (uint32_t(d) == mps[cx]) {
            if ((a & 0x8000) == 0) {
                if (a < q.qe) a = q.qe;
                else c += q.qe;
                st[cx] = q.nmps;
                renorm();
            } else {
                c += q.qe;
            }
        } else {
            if (a < q.qe) c += q.qe;
            else a = q.qe;
            if (q.sw) mps[cx] = 1 - mps[cx];
            st[cx] = q.nlps;
            renorm();
        }
    }
    // FLUSH; appends the segment's bytes (without the dummy byte)
    void flush(std::vector<uint8_t>& seg) {
        uint32_t tempc = c + a;
        c |= 0xFFFF;
        if (c >= tempc) c -= 0x8000;
        c <<= ct;
        byteout();
        c <<= ct;
        byteout();
        size_t n = out.size();
        if (out.back() == 0xFF) --n;  // a final 0xFF is not emitted
        seg.insert(seg.end(), out.begin() + 1, out.begin() + n);
    }
    // raw coder: bits MSB first, 7 bits in the byte after a 0xFF
    void raw_init() {
        out.clear();
        c = 0;
        ct = 8;
    }
    void raw_encode(int d) {
        --ct;
        c |= uint32_t(d) << ct;
        if (ct == 0) {
            out.push_back(uint8_t(c));
            ct = c == 0xFF ? 7 : 8;
            c = 0;
        }
    }
    void raw_flush(std::vector<uint8_t>& seg) {
        if (ct < (out.empty() || out.back() != 0xFF ? 8u : 7u)) out.push_back(uint8_t(c));
        size_t n = out.size();
        // a final 0xFF reads back as the 0xFF 0xFF marker's ones
        if (n && out.back() == 0xFF) --n;
        seg.insert(seg.end(), out.begin(), out.begin() + n);
    }
};

enum : uint32_t { F_SIG = 1, F_VISIT = 2, F_REF = 4, F_NEG = 8 };

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

struct Segment {
    std::vector<uint8_t> data;
    int passes = 0;
};

struct T1Enc {
    int w, h, stride, vsc;
    const int32_t* src;  // w x h coefficients, row stride `sstride`
    int sstride;
    std::vector<uint32_t> mag;
    std::vector<uint32_t> flags;
    uint8_t zc_lut[3 * 3 * 5];
    MQEnc mq;
    bool raw = false;

    inline uint32_t* fp(int x, int y) { return &flags[size_t(y + 1) * stride + x + 1]; }
    // under VSC a stripe's last row does not see the next stripe
    inline bool below_hidden(int y) const { return vsc && (y & 3) == 3; }
    inline int zc(int x, int y) {
        const uint32_t* f = fp(x, y);
        int hh = (f[-1] & F_SIG) + (f[1] & F_SIG);
        int vv = f[-stride] & F_SIG;
        int dd = (f[-stride - 1] & F_SIG) + (f[-stride + 1] & F_SIG);
        if (!below_hidden(y)) {
            vv += f[stride] & F_SIG;
            dd += (f[stride - 1] & F_SIG) + (f[stride + 1] & F_SIG);
        }
        return CTX_ZC + zc_lut[(hh * 3 + vv) * 5 + dd];
    }
    inline bool any_neighbour(int x, int y) {
        const uint32_t* f = fp(x, y);
        int s = (f[-1] | f[1] | f[-stride] | f[-stride - 1] | f[-stride + 1]) & F_SIG;
        if (!below_hidden(y)) s |= (f[stride] | f[stride - 1] | f[stride + 1]) & F_SIG;
        return s != 0;
    }
    static inline int contrib(uint32_t f) { return (f & F_SIG) ? ((f & F_NEG) ? -1 : 1) : 0; }
    inline void code_sign(int x, int y) {
        const uint32_t* f = fp(x, y);
        int neg = src[size_t(y) * sstride + x] < 0;
        if (raw) {
            mq.raw_encode(neg);
        } else {
            int hc = std::max(-1, std::min(1, contrib(f[-1]) + contrib(f[1])));
            int vc = std::max(-1, std::min(1, contrib(f[-stride]) +
                                                  (below_hidden(y) ? 0 : contrib(f[stride]))));
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
            mq.encode(ctx, neg ^ xorbit);
        }
        *fp(x, y) |= F_SIG | (neg ? F_NEG : 0);
    }
    inline int bit(int x, int y, int p) { return (mag[size_t(y) * w + x] >> p) & 1; }

    void sigpass(int p) {
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x)
                for (int y = k; y < std::min(k + 4, h); ++y) {
                    uint32_t* f = fp(x, y);
                    if ((*f & (F_SIG | F_VISIT)) || !any_neighbour(x, y)) continue;
                    int b = bit(x, y, p);
                    if (raw) mq.raw_encode(b);
                    else mq.encode(zc(x, y), b);
                    if (b) code_sign(x, y);
                    *fp(x, y) |= F_VISIT;
                }
    }
    void refpass(int p) {
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x)
                for (int y = k; y < std::min(k + 4, h); ++y) {
                    uint32_t* f = fp(x, y);
                    if ((*f & (F_SIG | F_VISIT)) != F_SIG) continue;
                    if (raw) {
                        mq.raw_encode(bit(x, y, p));
                    } else {
                        int ctx = (*f & F_REF) ? CTX_MAG + 2
                                               : (any_neighbour(x, y) ? CTX_MAG + 1 : CTX_MAG);
                        mq.encode(ctx, bit(x, y, p));
                    }
                    *f |= F_REF;
                }
    }
    void clnpass(int p, bool segsym) {
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x) {
                int ystart = k, yend = std::min(k + 4, h), partial_y = -1;
                if (k + 3 < h) {
                    bool all_zero = true;
                    for (int y = k; y < k + 4 && all_zero; ++y)
                        if ((*fp(x, y) & (F_SIG | F_VISIT)) || any_neighbour(x, y)) all_zero = false;
                    if (all_zero) {
                        int first = -1;
                        for (int y = k; y < k + 4; ++y)
                            if (bit(x, y, p)) {
                                first = y - k;
                                break;
                            }
                        if (first < 0) {
                            mq.encode(CTX_AGG, 0);
                            continue;
                        }
                        mq.encode(CTX_AGG, 1);
                        mq.encode(CTX_UNI, first >> 1);
                        mq.encode(CTX_UNI, first & 1);
                        ystart = k + first;
                        partial_y = ystart;
                    }
                }
                for (int y = ystart; y < yend; ++y) {
                    uint32_t* f = fp(x, y);
                    if (y != partial_y) {
                        if (*f & (F_SIG | F_VISIT)) continue;
                        int b = bit(x, y, p);
                        mq.encode(zc(x, y), b);
                        if (!b) continue;
                    }
                    code_sign(x, y);
                }
                for (int y = k; y < yend; ++y) *fp(x, y) &= ~uint32_t(F_VISIT);
            }
        if (segsym) {
            mq.encode(CTX_UNI, 1);
            mq.encode(CTX_UNI, 0);
            mq.encode(CTX_UNI, 1);
            mq.encode(CTX_UNI, 0);
        }
    }

    // Codes the block, each coefficient shifted up by `roi` planes, into
    // segments that end where the decoder's segment rule (OpenJPEG's
    // opj_t2_init_seg) ends them. Returns the coded bit-planes, less roi.
    int encode(const int32_t* s, int ss, int w_, int h_, int orient, int cblksty, int roi,
               std::vector<Segment>& segs) {
        src = s;
        sstride = ss;
        w = w_;
        h = h_;
        stride = w + 2;
        vsc = (cblksty & CBLK_VSC) ? 1 : 0;
        mag.assign(size_t(w) * h, 0);
        flags.assign(size_t(w + 2) * (h + 2), 0);
        uint32_t mx = 0;
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
                int32_t v = s[size_t(y) * ss + x];
                uint32_t m = (v < 0 ? uint32_t(-int64_t(v)) : uint32_t(v)) << roi;
                mag[size_t(y) * w + x] = m;
                mx = std::max(mx, m);
            }
        int planes = 0;
        while (planes < 32 && (mx >> planes)) ++planes;
        segs.clear();
        if (planes == 0) return 0;
        for (int hh = 0; hh < 3; ++hh)
            for (int vv = 0; vv < 3; ++vv)
                for (int dd = 0; dd < 5; ++dd)
                    zc_lut[(hh * 3 + vv) * 5 + dd] = uint8_t(zc_context(orient, hh, vv, dd));
        int numbps = planes - roi;  // what the packet header signals
        mq.reset_states();
        // passes in decoder order: (type 0 sig, 1 ref, 2 cln, plane)
        struct Pass {
            int type, plane;
        };
        std::vector<Pass> passes;
        for (int p = planes - 1; p >= 0; --p) {
            if (p != planes - 1) {
                passes.push_back({0, p});
                passes.push_back({1, p});
            }
            passes.push_back({2, p});
        }
        // segment lengths in passes, as the decoder's maxpasses rule
        size_t i = 0;
        int maxpasses = 0;
        bool first = true;
        while (i < passes.size()) {
            if (cblksty & CBLK_TERMALL) maxpasses = 1;
            else if (cblksty & CBLK_LAZY)
                maxpasses = first ? 10 : ((maxpasses == 1 || maxpasses == 10) ? 2 : 1);
            else maxpasses = 109;
            first = false;
            size_t end = std::min(passes.size(), i + size_t(maxpasses));
            // the segment's type is decided by its first pass
            int bpno_plus_one = passes[i].plane + 1;
            raw = (cblksty & CBLK_LAZY) && bpno_plus_one <= numbps - 4 && passes[i].type < 2;
            if (raw) mq.raw_init();
            else mq.init();
            Segment seg;
            for (; i < end; ++i) {
                switch (passes[i].type) {
                    case 0: sigpass(passes[i].plane); break;
                    case 1: refpass(passes[i].plane); break;
                    case 2: clnpass(passes[i].plane, (cblksty & CBLK_SEGSYM) != 0); break;
                }
                if ((cblksty & CBLK_RESET) && !raw) mq.reset_states();
                ++seg.passes;
            }
            if (raw) mq.raw_flush(seg.data);
            else mq.flush(seg.data);
            segs.push_back(std::move(seg));
        }
        return numbps;
    }
};

// forward 5/3 on an interleaved line starting at an even coordinate
void fdwt53_1d(int32_t* x, int n, std::vector<int32_t>& tmp) {
    if (n == 1) return;
    auto at = [&](int i) -> int64_t {
        if (i < 0) i = -i;
        if (i >= n) i = 2 * (n - 1) - i;
        return x[i];
    };
    for (int i = 1; i < n; i += 2) x[i] = int32_t(x[i] - ((at(i - 1) + at(i + 1)) >> 1));
    for (int i = 0; i < n; i += 2) x[i] = int32_t(x[i] + ((at(i - 1) + at(i + 1) + 2) >> 2));
    tmp.resize(n);
    int sn = (n + 1) / 2;
    for (int i = 0; i < sn; ++i) tmp[i] = x[2 * i];
    for (int i = 0; i < n - sn; ++i) tmp[sn + i] = x[2 * i + 1];
    std::copy(tmp.begin(), tmp.begin() + n, x);
}

struct Bits {
    std::vector<uint8_t> out;
    uint32_t buf = 0;
    int ct = 8;
    void byteout() {
        buf = (buf << 8) & 0xFFFF;
        ct = buf == 0xFF00 ? 7 : 8;
        out.push_back(uint8_t(buf >> 8));
    }
    void put(uint32_t b) {
        if (ct == 0) byteout();
        --ct;
        buf |= b << ct;
    }
    void write(uint32_t v, int n) {
        for (int i = n - 1; i >= 0; --i) put((v >> i) & 1);
    }
    void flush() {
        byteout();
        if (ct == 7) byteout();
    }
};

struct TagTreeEnc {
    struct Node {
        int parent, value, low, known;
    };
    std::vector<Node> nodes;
    void build(int w, int h, const std::vector<int>& leaves) {
        nodes.clear();
        if (w * h == 0) return;
        std::vector<int> lw, lh;
        int cw = w, ch = h, total = 0;
        while (true) {
            lw.push_back(cw);
            lh.push_back(ch);
            total += cw * ch;
            if (cw * ch == 1) break;
            cw = (cw + 1) / 2;
            ch = (ch + 1) / 2;
        }
        nodes.assign(total, Node{-1, 999, 0, 0});
        int base = 0;
        for (size_t l = 0; l + 1 < lw.size(); ++l) {
            int nb = base + lw[l] * lh[l];
            for (int j = 0; j < lh[l]; ++j)
                for (int i = 0; i < lw[l]; ++i)
                    nodes[base + j * lw[l] + i].parent = nb + (j / 2) * lw[l + 1] + i / 2;
            base = nb;
        }
        for (int i = 0; i < w * h; ++i) {
            int nd = i;
            int v = leaves[i];
            nodes[nd].value = v;
            while (nodes[nd].parent >= 0) {
                nd = nodes[nd].parent;
                if (nodes[nd].value <= v) break;
                nodes[nd].value = v;
            }
        }
    }
    void encode(Bits& bio, int leaf, int threshold) {
        int stk[40], sp = 0, node = leaf;
        while (nodes[node].parent >= 0) {
            stk[sp++] = node;
            node = nodes[node].parent;
        }
        int low = 0;
        for (;;) {
            Node& nd = nodes[node];
            if (low > nd.low) nd.low = low;
            else low = nd.low;
            while (low < threshold) {
                if (low >= nd.value) {
                    if (!nd.known) {
                        bio.put(1);
                        nd.known = 1;
                    }
                    break;
                }
                bio.put(0);
                ++low;
            }
            nd.low = low;
            if (sp == 0) break;
            node = stk[--sp];
        }
    }
};

int floorlog2(uint32_t v) {
    int l = 0;
    while (v > 1) {
        v >>= 1;
        ++l;
    }
    return l;
}

int bitlen(uint32_t v) {
    int n = 0;
    while (n < 32 && (v >> n)) ++n;
    return n;
}

void put16(std::vector<uint8_t>& o, uint32_t v) {
    o.push_back(uint8_t(v >> 8));
    o.push_back(uint8_t(v));
}
void put32(std::vector<uint8_t>& o, uint32_t v) {
    put16(o, v >> 16);
    put16(o, v & 0xFFFF);
}

struct CblkOut {
    int zbp = 0, npasses = 0;
    std::vector<Segment> segs;
};

struct BandGeom {
    int orient;
    int x0, y0, x1, y1;  // band coordinates
    int xoff, yoff;      // its origin in the coefficient buffer
    int expn;
};

// marker segments of `payload` split into pieces of at most 65535 - 3
// bytes, each `marker`, length, index byte, piece
void put_split(std::vector<uint8_t>& o, uint32_t marker, const std::vector<uint8_t>& payload) {
    const size_t piece = 65535 - 3;
    size_t n = (payload.size() + piece - 1) / piece;
    for (size_t k = 0; k < std::max<size_t>(n, 1); ++k) {
        size_t a = k * piece, b = std::min(payload.size(), a + piece);
        put16(o, marker);
        put16(o, uint32_t(3 + (b - a)));
        o.push_back(uint8_t(k));
        o.insert(o.end(), payload.begin() + a, payload.begin() + b);
    }
}

}  // namespace

extern "C" int64_t fc_j2k_encode(const void* pixels, int h, int w, int nc, int prec, int options,
                                 uint8_t* out, uint64_t cap) {
    if (h <= 0 || w <= 0 || nc < 1 || nc > 4 || prec < 1 || prec > 16) return -1;
    const int cblksty = options & 63;
    const int roi = (options >> 16) & 31;
    try {
        int numres = 1;
        while (numres < 6 && (1 << numres) <= std::min(w, h)) ++numres;
        int nl = numres - 1;
        const int guard = 2;
        // DC shift, colour transform
        std::vector<std::vector<int32_t>> comp(nc, std::vector<int32_t>(size_t(w) * h));
        int32_t shift = int32_t(1) << (prec - 1);
        for (size_t i = 0; i < size_t(w) * h; ++i)
            for (int c = 0; c < nc; ++c) {
                int32_t v = prec <= 8 ? static_cast<const uint8_t*>(pixels)[i * nc + c]
                                      : static_cast<const uint16_t*>(pixels)[i * nc + c];
                comp[c][i] = v - shift;
            }
        bool use_mct = (options & OPT_MCT) && nc >= 3;
        if (use_mct) {
            for (size_t i = 0; i < size_t(w) * h; ++i) {
                int32_t r = comp[0][i], g = comp[1][i], b = comp[2][i];
                comp[0][i] = (r + (g * 2) + b) >> 2;
                comp[1][i] = b - g;
                comp[2][i] = r - g;
            }
        }
        // resolution sizes (tile at the origin: every start is even)
        std::vector<int> rw(numres), rh(numres);
        for (int r = 0; r < numres; ++r) {
            int lev = nl - r;
            rw[r] = int((int64_t(w) + (int64_t(1) << lev) - 1) >> lev);
            rh[r] = int((int64_t(h) + (int64_t(1) << lev) - 1) >> lev);
        }
        std::vector<int32_t> line, tmp;
        for (int c = 0; c < nc; ++c) {
            int32_t* d = comp[c].data();
            for (int r = nl; r >= 1; --r) {
                int cw = rw[r], ch = rh[r];
                line.resize(std::max(cw, ch));
                for (int x = 0; x < cw; ++x) {  // vertical first
                    for (int y = 0; y < ch; ++y) line[y] = d[size_t(y) * w + x];
                    fdwt53_1d(line.data(), ch, tmp);
                    for (int y = 0; y < ch; ++y) d[size_t(y) * w + x] = line[y];
                }
                for (int y = 0; y < ch; ++y) fdwt53_1d(d + size_t(y) * w, cw, tmp);
            }
        }
        // bands of each resolution, in packet order
        std::vector<std::vector<BandGeom>> bands(numres);
        for (int r = 0; r < numres; ++r) {
            if (r == 0) {
                bands[0].push_back(BandGeom{0, 0, 0, rw[0], rh[0], 0, 0, prec});
                continue;
            }
            int lw = rw[r - 1], lh = rh[r - 1];
            // HL, LH, HH
            bands[r].push_back(BandGeom{1, 0, 0, rw[r] - lw, lh, lw, 0, prec + 1});
            bands[r].push_back(BandGeom{2, 0, 0, lw, rh[r] - lh, 0, lh, prec + 1});
            bands[r].push_back(BandGeom{3, 0, 0, rw[r] - lw, rh[r] - lh, lw, lh, prec + 2});
        }
        // packets: one layer, one precinct per resolution (the 2^15
        // precincts cover any image this encoder takes), in the order
        // of the progression (LRCP, or the POC's two parts)
        std::vector<std::pair<int, int>> order;  // (resolution, component)
        if (options & OPT_POC) {
            for (int r = 0; r < std::min(3, numres); ++r)
                for (int c = 0; c < nc; ++c) order.push_back({r, c});
            for (int c = 0; c < nc; ++c)
                for (int r = 3; r < numres; ++r) order.push_back({r, c});
        } else {
            for (int r = 0; r < numres; ++r)
                for (int c = 0; c < nc; ++c) order.push_back({r, c});
        }
        T1Enc t1;
        std::vector<uint8_t> headers, body;  // packed headers, tile data
        int seq = 0;
        for (auto [r, c] : order) {
            Bits bio;
            std::vector<uint8_t> pbody;
            bool any = false;
            struct Pb {
                int cw, ch;
                std::vector<CblkOut> cb;
            };
            std::vector<Pb> pbs;
            for (const BandGeom& b : bands[r]) {
                Pb pb;
                int bw = b.x1 - b.x0, bh = b.y1 - b.y0;
                pb.cw = (bw + 63) / 64;
                pb.ch = (bh + 63) / 64;
                if (bw == 0 || bh == 0) pb.cw = pb.ch = 0;
                pb.cb.resize(size_t(pb.cw) * pb.ch);
                for (int j = 0; j < pb.ch; ++j)
                    for (int i = 0; i < pb.cw; ++i) {
                        int x0 = i * 64, y0 = j * 64;
                        int x1 = std::min(x0 + 64, bw), y1 = std::min(y0 + 64, bh);
                        CblkOut& co = pb.cb[size_t(j) * pb.cw + i];
                        const int32_t* s = comp[c].data() + size_t(b.yoff + y0) * w + (b.xoff + x0);
                        int nb = t1.encode(s, w, x1 - x0, y1 - y0, b.orient, cblksty, roi, co.segs);
                        int mb = b.expn + guard - 1;
                        if (nb > mb) return -1;
                        co.zbp = mb - nb;
                        for (const Segment& sg : co.segs) co.npasses += sg.passes;
                        if (co.npasses) any = true;
                    }
                pbs.push_back(std::move(pb));
            }
            bio.put(any ? 1 : 0);
            if (any) {
                for (Pb& pb : pbs) {
                    if (pb.cb.empty()) continue;
                    std::vector<int> incl(pb.cb.size()), zbp(pb.cb.size());
                    for (size_t k = 0; k < pb.cb.size(); ++k) {
                        incl[k] = pb.cb[k].npasses ? 0 : 999;
                        zbp[k] = pb.cb[k].zbp;
                    }
                    TagTreeEnc ti, tz;
                    ti.build(pb.cw, pb.ch, incl);
                    tz.build(pb.cw, pb.ch, zbp);
                    for (size_t k = 0; k < pb.cb.size(); ++k) {
                        CblkOut& co = pb.cb[k];
                        ti.encode(bio, int(k), 1);
                        if (!co.npasses) continue;
                        tz.encode(bio, int(k), 999);
                        int n = co.npasses;  // pass-count codeword
                        if (n == 1) bio.write(0, 1);
                        else if (n == 2) bio.write(2, 2);
                        else if (n <= 5) bio.write(0xC | (n - 3), 4);
                        else if (n <= 36) bio.write((0x1E0 | (n - 6)), 9);
                        else bio.write((0xFF80 | (n - 37)), 16);
                        // one Lblock for every segment's length
                        int incr = 0;
                        for (const Segment& sg : co.segs)
                            incr = std::max(incr, bitlen(uint32_t(sg.data.size())) -
                                                      floorlog2(uint32_t(sg.passes)) - 3);
                        for (int i = 0; i < incr; ++i) bio.put(1);
                        bio.put(0);
                        for (const Segment& sg : co.segs) {
                            bio.write(uint32_t(sg.data.size()), 3 + incr + floorlog2(uint32_t(sg.passes)));
                            pbody.insert(pbody.end(), sg.data.begin(), sg.data.end());
                        }
                    }
                }
            }
            bio.flush();
            if (options & OPT_EPH) {
                bio.out.push_back(0xFF);
                bio.out.push_back(0x92);
            }
            if (options & OPT_SOP) {
                put16(body, 0xFF91);
                put16(body, 4);
                put16(body, uint32_t(seq & 0xFFFF));
            }
            ++seq;
            if (options & (OPT_PPT | OPT_PPM)) {
                headers.insert(headers.end(), bio.out.begin(), bio.out.end());
            } else {
                body.insert(body.end(), bio.out.begin(), bio.out.end());
            }
            body.insert(body.end(), pbody.begin(), pbody.end());
        }
        // main header
        std::vector<uint8_t> o;
        put16(o, 0xFF4F);
        put16(o, 0xFF51);
        put16(o, uint32_t(38 + 3 * nc));
        put16(o, 0);
        put32(o, uint32_t(w));
        put32(o, uint32_t(h));
        put32(o, 0);
        put32(o, 0);
        put32(o, uint32_t(w));
        put32(o, uint32_t(h));
        put32(o, 0);
        put32(o, 0);
        put16(o, uint32_t(nc));
        for (int c = 0; c < nc; ++c) {
            o.push_back(uint8_t(prec - 1));
            o.push_back(1);
            o.push_back(1);
        }
        put16(o, 0xFF52);
        put16(o, 12);
        o.push_back(uint8_t(((options & OPT_SOP) ? 2 : 0) | ((options & OPT_EPH) ? 4 : 0)));
        o.push_back(0);  // LRCP
        put16(o, 1);     // one layer
        o.push_back(use_mct ? 1 : 0);
        o.push_back(uint8_t(nl));
        o.push_back(4);  // 64 x 64 code-blocks
        o.push_back(4);
        o.push_back(uint8_t(cblksty));
        o.push_back(1);  // 5/3 reversible
        put16(o, 0xFF5C);
        put16(o, uint32_t(3 + 3 * nl + 1));
        o.push_back(uint8_t(guard << 5));
        for (int r = 0; r < numres; ++r)
            for (const BandGeom& b : bands[r]) o.push_back(uint8_t(b.expn << 3));
        if (roi) {
            for (int c = 0; c < nc; ++c) {
                put16(o, 0xFF5E);
                put16(o, 5);
                o.push_back(uint8_t(c));
                o.push_back(0);
                o.push_back(uint8_t(roi));
            }
        }
        if (options & OPT_POC) {
            put16(o, 0xFF5F);
            put16(o, 2 + 7 * 2);
            const int entries[2][6] = {{0, 0, 1, std::min(3, numres), nc, 1},  // RLCP
                                       {3, 0, 1, numres, nc, 4}};              // CPRL
            for (const auto& e : entries) {
                o.push_back(uint8_t(e[0]));
                o.push_back(uint8_t(e[1]));
                put16(o, uint32_t(e[2]));
                o.push_back(uint8_t(e[3]));
                o.push_back(uint8_t(e[4]));
                o.push_back(uint8_t(e[5]));
            }
        }
        if (options & OPT_PPM) {
            std::vector<uint8_t> ippm;
            put32(ippm, uint32_t(headers.size()));
            ippm.insert(ippm.end(), headers.begin(), headers.end());
            put_split(o, 0xFF60, ippm);
        }
        size_t sot = o.size();
        put16(o, 0xFF90);
        put16(o, 10);
        put16(o, 0);
        put32(o, 0);  // Psot, patched below
        o.push_back(0);
        o.push_back(1);
        if (options & OPT_PPT) put_split(o, 0xFF61, headers);
        put16(o, 0xFF93);
        o.insert(o.end(), body.begin(), body.end());
        uint32_t psot = uint32_t(o.size() - sot);
        o[sot + 6] = uint8_t(psot >> 24);
        o[sot + 7] = uint8_t(psot >> 16);
        o[sot + 8] = uint8_t(psot >> 8);
        o[sot + 9] = uint8_t(psot);
        put16(o, 0xFFD9);
        if (o.size() > cap) return -2;
        memcpy(out, o.data(), o.size());
        return int64_t(o.size());
    } catch (const std::bad_alloc&) {
        return -1;
    }
}
