// CRC32C (Castagnoli) for TFRecord framing, built with g++ at first use and
// called through ctypes (records/crc32c.py). A copy of the slicing-by-8
// table path of the JAX package's native codec (_native/fastcodec.cc,
// fc_crc32c without its SSE4.2 branch): the port keeps its own copy so that
// it imports nothing of that package. The pure-Python version in
// records/crc32c.py is the reference it is tested against; a tifarr record
// of a 256 px RGB chip is ~1 MB, which that loop takes about 0.2 s to sum.

#include <cstdint>
#include <cstring>

extern "C" {

static uint32_t crc32c_table[8][256];

static void crc32c_init() {
    const uint32_t poly = 0x82F63B78u;
    for (int i = 0; i < 256; i++) {
        uint32_t crc = (uint32_t)i;
        for (int j = 0; j < 8; j++)
            crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
        crc32c_table[0][i] = crc;
    }
    for (int k = 1; k < 8; k++)
        for (int i = 0; i < 256; i++)
            crc32c_table[k][i] = (crc32c_table[k - 1][i] >> 8)
                ^ crc32c_table[0][crc32c_table[k - 1][i] & 0xFF];
}

// load-time init: a lazy flag checked from several writer threads would be
// a data race
static const bool crc32c_init_at_load = [] {
    crc32c_init();
    return true;
}();

uint32_t fc_crc32c(const uint8_t* data, uint64_t n, uint32_t initial) {
    uint32_t crc = ~initial;
    while (n && ((uintptr_t)data & 7)) {
        crc = (crc >> 8) ^ crc32c_table[0][(crc ^ *data++) & 0xFF];
        n--;
    }
    while (n >= 8) {
        uint64_t v;
        memcpy(&v, data, 8);
        v ^= crc;
        crc = crc32c_table[7][v & 0xFF]
            ^ crc32c_table[6][(v >> 8) & 0xFF]
            ^ crc32c_table[5][(v >> 16) & 0xFF]
            ^ crc32c_table[4][(v >> 24) & 0xFF]
            ^ crc32c_table[3][(v >> 32) & 0xFF]
            ^ crc32c_table[2][(v >> 40) & 0xFF]
            ^ crc32c_table[1][(v >> 48) & 0xFF]
            ^ crc32c_table[0][(v >> 56) & 0xFF];
        data += 8;
        n -= 8;
    }
    while (n--) crc = (crc >> 8) ^ crc32c_table[0][(crc ^ *data++) & 0xFF];
    return ~crc;
}

}  // extern "C"
