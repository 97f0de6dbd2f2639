// TIFF-variant LZW codec for GeoTIFF chips, built with g++ at first use
// and called through ctypes (raster/lzw.py). The encoder is a copy of the
// JAX package's native one (_native/fastcodec.cc, fc_lzw_encode): the
// port keeps its own copy so that it imports nothing of that package.
// The decoder is a plain version of the same stream rules, for the
// GeoTIFF reader. Pure Python LZW cannot carry full-width chips (a
// 260 px x 13-band float32 median chip is ~3.5 MB).
//
// MSB-first bit packing, 9->12 bit codes, ClearCode=256, EOI=257, code
// width bumps one code early ("early change"), table reset at 4094.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

#define LZW_CLEAR 256
#define LZW_EOI   257
#define LZW_FIRST 258
#define LZW_RESET 4094

struct BitWriter {
    uint8_t* out;
    uint64_t cap;
    uint64_t pos;
    uint64_t bitbuf;
    int bitcnt;
    bool overflow;
};

static inline void bw_put(BitWriter* bw, uint32_t code, int bits) {
    bw->bitbuf = (bw->bitbuf << bits) | code;
    bw->bitcnt += bits;
    while (bw->bitcnt >= 8) {
        bw->bitcnt -= 8;
        if (bw->pos >= bw->cap) { bw->overflow = true; return; }
        bw->out[bw->pos++] = (uint8_t)(bw->bitbuf >> bw->bitcnt);
    }
}

// Per-thread LZW scratch tables, freed at thread exit via the C++
// thread_local destructor (__cxa_thread_atexit). Bare thread_local
// mallocs would leak at every worker-thread exit, and the export
// spawns fresh worker threads per attempt. Lazy accessor so the
// TLS-init wrapper runs once per use site; callers immediately copy
// the raw pointers into locals.
struct FcTls {
    uint32_t* enc_child = nullptr;  // encoder: 4096x256 children
    uint32_t enc_epoch = 0;
    ~FcTls() {
        free(enc_child);
    }
};

static FcTls& fc_tls() {
    static thread_local FcTls tls;
    return tls;
}

// Encode: direct-mapped children table child[code][byte] -> next code,
// epoch-stamped so table resets cost nothing (no 2 MB memset per Clear
// -- random-ish data resets every ~4-6 KB of input).
// Returns compressed size, or 0 on output overflow (caller grows buffer).
uint64_t fc_lzw_encode(const uint8_t* src, uint64_t n,
                       uint8_t* dst, uint64_t cap) {
    // entry = (epoch << 16) | code; entry valid iff its epoch matches.
    // Tables live in the RAII per-thread bundle (freed at thread exit;
    // a bare thread_local malloc would leak 4 MB per exited worker).
    FcTls& tls = fc_tls();
    uint32_t*& child = tls.enc_child;
    uint32_t& epoch = tls.enc_epoch;
    if (!child) {
        child = (uint32_t*)malloc(4096 * 256 * sizeof(uint32_t));
        if (!child) return 0;  // OOM: the caller raises
        memset(child, 0, 4096 * 256 * sizeof(uint32_t));
        epoch = 0;
    }
    if (epoch >= 0xFFFEu) {  // epoch wrap: one real reset per ~65k clears
        memset(child, 0, 4096 * 256 * sizeof(uint32_t));
        epoch = 0;
    }
    epoch++;

    BitWriter bw = {dst, cap, 0, 0, 0, false};
    int bits = 9;
    int next_code = LZW_FIRST;
    bw_put(&bw, LZW_CLEAR, bits);

    if (n == 0) {
        bw_put(&bw, LZW_EOI, bits);
        if (bw.bitcnt) {
            if (bw.pos >= bw.cap) return 0;
            bw.out[bw.pos++] = (uint8_t)(bw.bitbuf << (8 - bw.bitcnt));
        }
        return bw.overflow ? 0 : bw.pos;
    }

    int w = src[0];
    for (uint64_t i = 1; i < n; i++) {
        uint8_t k = src[i];
        uint32_t e = child[((uint32_t)w << 8) | k];
        if ((e >> 16) == epoch) { w = (int)(e & 0xFFFF); continue; }
        bw_put(&bw, (uint32_t)w, bits);
        if (bw.overflow) return 0;
        child[((uint32_t)w << 8) | k] = (epoch << 16) | (uint32_t)next_code;
        next_code++;
        w = k;
        if (next_code >= LZW_RESET) {
            bw_put(&bw, LZW_CLEAR, bits);
            epoch++;
            if (epoch >= 0xFFFFu) {  // 16-bit stamp wrap mid-stream
                memset(child, 0, 4096 * 256 * sizeof(uint32_t));
                epoch = 1;
            }
            next_code = LZW_FIRST;
            bits = 9;
        } else if (next_code == (1 << bits) && bits < 12) {
            bits++;
        }
    }
    bw_put(&bw, (uint32_t)w, bits);
    bw_put(&bw, LZW_EOI, bits);
    if (bw.overflow) return 0;
    if (bw.bitcnt) {
        if (bw.pos >= bw.cap) return 0;
        bw.out[bw.pos++] = (uint8_t)(bw.bitbuf << (8 - bw.bitcnt));
    }
    return bw.pos;
}

// Decode: each code's string is a run of bytes already written to dst,
// kept as (start, length); a new entry is the previous string plus the
// first byte of the current one, which dst holds right after it.
// Same rules as raster/lzw.py:lzw_decode: running out of input ends the
// stream like EOI; stop_at > 0 stops once that many bytes are out.
// Returns the bytes written, (uint64_t)-1 for a corrupt stream, or
// (uint64_t)-2 when dst is too small (the caller grows it).
uint64_t fc_lzw_decode(const uint8_t* src, uint64_t n,
                       uint8_t* dst, uint64_t cap, uint64_t stop_at) {
    static thread_local uint64_t start[4096];
    static thread_local uint32_t len[4096];
    uint64_t pos = 0, bitbuf = 0, out = 0;
    int bitcnt = 0, bits = 9, next_code = LZW_FIRST;
    bool have_old = false;
    uint64_t old_start = 0;
    uint32_t old_len = 0;
    for (;;) {
        while (bitcnt < bits && pos < n) {
            bitbuf = (bitbuf << 8) | src[pos++];
            bitcnt += 8;
        }
        if (bitcnt < bits) break;  // input ran out: as EOI
        bitcnt -= bits;
        uint32_t code = (uint32_t)(bitbuf >> bitcnt) & ((1u << bits) - 1);
        if (code == LZW_EOI) break;
        if (code == LZW_CLEAR) {
            bits = 9;
            next_code = LZW_FIRST;
            have_old = false;
            continue;
        }
        uint64_t s;
        uint32_t l;
        if (code < 256) {
            if (out + 1 > cap) return (uint64_t)-2;
            dst[out] = (uint8_t)code;
            s = out;
            l = 1;
        } else if ((int)code < next_code && code >= LZW_FIRST) {
            l = len[code];
            if (out + l > cap) return (uint64_t)-2;
            memmove(dst + out, dst + start[code], l);
            s = out;
        } else if ((int)code == next_code && have_old) {
            // KwKwK: the previous string and its own first byte
            l = old_len + 1;
            if (out + l > cap) return (uint64_t)-2;
            memmove(dst + out, dst + old_start, old_len);
            dst[out + old_len] = dst[old_start];
            s = out;
        } else {
            return (uint64_t)-1;
        }
        out += l;
        if (have_old && next_code < 4096) {
            start[next_code] = old_start;
            len[next_code] = old_len + 1;
            next_code++;
            if (next_code == (1 << bits) - 1 && bits < 12) bits++;
        }
        have_old = true;
        old_start = s;
        old_len = l;
        if (stop_at && out >= stop_at) break;
    }
    return stop_at && out > stop_at ? stop_at : out;
}

}  // extern "C"
