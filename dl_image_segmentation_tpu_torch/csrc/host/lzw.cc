// TIFF-variant LZW encoder for GeoTIFF chips, built with g++ at first use
// and called through ctypes (raster/lzw.py). A copy of the encoder in the
// JAX package's native codec (_native/fastcodec.cc, fc_lzw_encode): the
// port keeps its own copy so that it imports nothing of that package.
// Pure Python LZW cannot carry full-width chips (a 260 px x 13-band
// float32 median chip is ~3.5 MB).
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

}  // extern "C"
