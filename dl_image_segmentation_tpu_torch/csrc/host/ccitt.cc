// CCITT bilevel decoders of the port's TIFF reader (raster/pil_tiff.py):
// Modified Huffman (TIFF compression 2, and 32771 word-aligned), T.4
// Group 3 1-D and 2-D (compression 3) and T.6 Group 4 (compression 4),
// decoding one strip or tile as libtiff 4.7's tif_fax3.c does, step for
// step: the same run tables, the same zero padding at the end of the
// data, the same repair of a row whose runs do not add up, the same
// retry without EOLs when a Group 3 strip has none where one is due, and
// the same success or failure at a premature end. Built with g++ into
// build/ at first use and called through ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum State {
  S_Null = 0, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext,
  S_TermW, S_TermB, S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct TabEnt {
  uint8_t state;
  uint8_t width;
  uint32_t param;
};

// A code as its bits in stream order, and what it stands for.
struct Code {
  const char* bits;
  uint32_t param;
};

const Code kTermW[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4},
    {"1100", 5}, {"1110", 6}, {"1111", 7}, {"10011", 8}, {"10100", 9},
    {"00111", 10}, {"01000", 11}, {"001000", 12}, {"000011", 13},
    {"110100", 14}, {"110101", 15}, {"101010", 16}, {"101011", 17},
    {"0100111", 18}, {"0001100", 19}, {"0001000", 20}, {"0010111", 21},
    {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25},
    {"0010011", 26}, {"0100100", 27}, {"0011000", 28}, {"00000010", 29},
    {"00000011", 30}, {"00011010", 31}, {"00011011", 32}, {"00010010", 33},
    {"00010011", 34}, {"00010100", 35}, {"00010101", 36}, {"00010110", 37},
    {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45},
    {"00000101", 46}, {"00001010", 47}, {"00001011", 48}, {"01010010", 49},
    {"01010011", 50}, {"01010100", 51}, {"01010101", 52}, {"00100100", 53},
    {"00100101", 54}, {"01011000", 55}, {"01011001", 56}, {"01011010", 57},
    {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63}};
const Code kTermB[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4},
    {"0011", 5}, {"0010", 6}, {"00011", 7}, {"000101", 8}, {"000100", 9},
    {"0000100", 10}, {"0000101", 11}, {"0000111", 12}, {"00000100", 13},
    {"00000111", 14}, {"000011000", 15}, {"0000010111", 16},
    {"0000011000", 17}, {"0000001000", 18}, {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22},
    {"00000101000", 23}, {"00000010111", 24}, {"00000011000", 25},
    {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28},
    {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34},
    {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37},
    {"000011010110", 38}, {"000011010111", 39}, {"000001101100", 40},
    {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46},
    {"000001010111", 47}, {"000001100100", 48}, {"000001100101", 49},
    {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52},
    {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58},
    {"000000101011", 59}, {"000000101100", 60}, {"000001011010", 61},
    {"000001100110", 62}, {"000001100111", 63}};
const Code kMakeUpW[] = {
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256},
    {"00110110", 320}, {"00110111", 384}, {"01100100", 448},
    {"01100101", 512}, {"01101000", 576}, {"01100111", 640},
    {"011001100", 704}, {"011001101", 768}, {"011010010", 832},
    {"011010011", 896}, {"011010100", 960}, {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216},
    {"011011001", 1280}, {"011011010", 1344}, {"011011011", 1408},
    {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664}, {"010011011", 1728}};
const Code kMakeUpB[] = {
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192},
    {"000001011011", 256}, {"000000110011", 320}, {"000000110100", 384},
    {"000000110101", 448}, {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960},
    {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472},
    {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}};
// the extended make-up codes, shared by both colours
const Code kMakeUp[] = {
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
// the mode codes of T.4 2-D and T.6; seven zeros are libtiff's EOL here,
// eleven in the run tables
const Code kPass[] = {{"0001", 0}};
const Code kHoriz[] = {{"001", 0}};
const Code kV0[] = {{"1", 0}};
const Code kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}};
const Code kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}};
const Code kExt[] = {{"0000001", 0}};
const Code kEOLV[] = {{"0000000", 0}};
const Code kEOLH[] = {{"00000000000", 0}};

// libtiff's mkg3states FillTable: the table is indexed by the next
// ``size`` bits read least significant first, so a code fills every
// index whose low bits are the code's bits in stream order.
template <size_t N>
void Fill(std::vector<TabEnt>& t, int size, const Code (&codes)[N],
          State state) {
  for (const Code& c : codes) {
    int width = static_cast<int>(strlen(c.bits));
    uint32_t code = 0;
    for (int i = 0; i < width; i++)
      if (c.bits[i] == '1') code |= 1u << i;
    for (uint32_t k = code; k < (1u << size); k += 1u << width) {
      t[k].state = static_cast<uint8_t>(state);
      t[k].width = static_cast<uint8_t>(width);
      t[k].param = c.param;
    }
  }
}

struct Tables {
  std::vector<TabEnt> main, white, black;
  Tables() : main(1 << 7), white(1 << 12), black(1 << 13) {
    Fill(main, 7, kPass, S_Pass);
    Fill(main, 7, kHoriz, S_Horiz);
    Fill(main, 7, kV0, S_V0);
    Fill(main, 7, kVR, S_VR);
    Fill(main, 7, kVL, S_VL);
    Fill(main, 7, kExt, S_Ext);
    Fill(main, 7, kEOLV, S_EOL);
    Fill(white, 12, kMakeUpW, S_MakeUpW);
    Fill(white, 12, kMakeUp, S_MakeUp);
    Fill(white, 12, kTermW, S_TermW);
    Fill(white, 12, kEOLH, S_EOL);
    Fill(black, 13, kMakeUpB, S_MakeUpB);
    Fill(black, 13, kMakeUp, S_MakeUp);
    Fill(black, 13, kTermB, S_TermB);
    Fill(black, 13, kEOLH, S_EOL);
  }
};

const Tables& GetTables() {
  static const Tables t;
  return t;
}

uint8_t kRev[256];

void InitRev() {
  for (int i = 0; i < 256; i++) {
    int r = 0;
    for (int b = 0; b < 8; b++)
      if (i & (1 << b)) r |= 0x80 >> b;
    kRev[i] = static_cast<uint8_t>(r);
  }
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them; a run
// past the row's end is cut there, in the run array too (the next row
// reads it as its reference).
void FillRuns(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int k = 0; k < 2; k++) {
      uint32_t run = runs[k];
      if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
      for (uint32_t i = x; i < x + run; i++) {
        if (k)
          buf[i >> 3] |= static_cast<uint8_t>(0x80 >> (i & 7));
        else
          buf[i >> 3] &= static_cast<uint8_t>(~(0x80 >> (i & 7)));
      }
      x += run;
    }
  }
}

}  // namespace

// The decoder's state as tif_fax3.h names it, and its macros.
#define EndOfData() (cp >= ep)
#define NeedBits8(n, eoflab)                                   \
  do {                                                         \
    if (BitsAvail < (n)) {                                     \
      if (EndOfData()) {                                       \
        if (BitsAvail == 0) goto eoflab;                       \
        BitsAvail = (n);                                       \
      } else {                                                 \
        BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail; \
        BitsAvail += 8;                                        \
      }                                                        \
    }                                                          \
  } while (0)
#define NeedBits16(n, eoflab)                                  \
  do {                                                         \
    if (BitsAvail < (n)) {                                     \
      if (EndOfData()) {                                       \
        if (BitsAvail == 0) goto eoflab;                       \
        BitsAvail = (n);                                       \
      } else {                                                 \
        BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail; \
        if ((BitsAvail += 8) < (n)) {                          \
          if (EndOfData()) {                                   \
            BitsAvail = (n);                                   \
          } else {                                             \
            BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail; \
            BitsAvail += 8;                                    \
          }                                                    \
        }                                                      \
      }                                                        \
    }                                                          \
  } while (0)
#define GetBits(n) (BitAcc & ((1u << (n)) - 1))
#define ClrBits(n)       \
  do {                   \
    BitsAvail -= (n);    \
    BitAcc >>= (n);      \
  } while (0)
#define LOOKUP8(wid, tab, eoflab)   \
  do {                              \
    NeedBits8(wid, eoflab);         \
    te = &(tab)[GetBits(wid)];      \
    ClrBits(te->width);             \
  } while (0)
#define LOOKUP16(wid, tab, eoflab)  \
  do {                              \
    NeedBits16(wid, eoflab);        \
    te = &(tab)[GetBits(wid)];      \
    ClrBits(te->width);             \
  } while (0)
#define SETVALUE(x)                                          \
  do {                                                       \
    if (pa >= thisrun + nruns) return -1;                    \
    *pa++ = static_cast<uint32_t>(RunLength + (x));          \
    a0 += (x);                                               \
    RunLength = 0;                                           \
  } while (0)
#define CLEANUP_RUNS()                                                   \
  do {                                                                   \
    if (RunLength) SETVALUE(0);                                          \
    if (a0 != lastx) {                                                   \
      while (a0 > lastx && pa > thisrun)                                 \
        a0 = static_cast<int32_t>(static_cast<uint32_t>(a0) - *--pa);    \
      if (a0 < lastx) {                                                  \
        if (a0 < 0) a0 = 0;                                              \
        if ((pa - thisrun) & 1) SETVALUE(0);                             \
        SETVALUE(lastx - a0);                                            \
      } else if (a0 > lastx) {                                           \
        SETVALUE(lastx);                                                 \
        SETVALUE(0);                                                     \
      }                                                                  \
    }                                                                    \
  } while (0)
#define EXPAND1D(eoflab)                                      \
  do {                                                        \
    for (;;) {                                                \
      for (;;) {                                              \
        LOOKUP16(12, white, eof1d_##eoflab);                  \
        switch (te->state) {                                  \
          case S_EOL:                                         \
            EOLcnt = 1;                                       \
            goto done1d_##eoflab;                             \
          case S_TermW:                                       \
            SETVALUE(static_cast<int32_t>(te->param));        \
            goto doneWhite1d_##eoflab;                        \
          case S_MakeUpW:                                     \
          case S_MakeUp:                                      \
            a0 += te->param;                                  \
            RunLength += te->param;                           \
            break;                                            \
          default:                                            \
            goto done1d_##eoflab;                             \
        }                                                     \
      }                                                       \
    doneWhite1d_##eoflab:                                     \
      if (a0 >= lastx) goto done1d_##eoflab;                  \
      for (;;) {                                              \
        LOOKUP16(13, black, eof1d_##eoflab);                  \
        switch (te->state) {                                  \
          case S_EOL:                                         \
            EOLcnt = 1;                                       \
            goto done1d_##eoflab;                             \
          case S_TermB:                                       \
            SETVALUE(static_cast<int32_t>(te->param));        \
            goto doneBlack1d_##eoflab;                        \
          case S_MakeUpB:                                     \
          case S_MakeUp:                                      \
            a0 += te->param;                                  \
            RunLength += te->param;                           \
            break;                                            \
          default:                                            \
            goto done1d_##eoflab;                             \
        }                                                     \
      }                                                       \
    doneBlack1d_##eoflab:                                     \
      if (a0 >= lastx) goto done1d_##eoflab;                  \
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;          \
    }                                                         \
  eof1d_##eoflab:                                             \
    CLEANUP_RUNS();                                           \
    goto eoflab;                                              \
  done1d_##eoflab:                                            \
    CLEANUP_RUNS();                                           \
  } while (0)
#define CHECK_b1                                                  \
  do {                                                            \
    if (pa != thisrun)                                            \
      while (b1 <= a0 && b1 < lastx) {                            \
        if (pb + 1 >= refruns + nruns) return -1;                 \
        b1 += pb[0] + pb[1];                                      \
        pb += 2;                                                  \
      }                                                           \
  } while (0)
#define EXPAND2D(eoflab)                                              \
  do {                                                                \
    while (a0 < lastx) {                                              \
      if (pa >= thisrun + nruns) return -1;                           \
      LOOKUP8(7, main, eof2d_##eoflab);                               \
      switch (te->state) {                                            \
        case S_Pass:                                                  \
          CHECK_b1;                                                   \
          if (pb + 1 >= refruns + nruns) return -1;                   \
          b1 += *pb++;                                                \
          RunLength += b1 - a0;                                       \
          a0 = b1;                                                    \
          b1 += *pb++;                                                \
          break;                                                      \
        case S_Horiz:                                                 \
          if ((pa - thisrun) & 1) {                                   \
            for (;;) {                                                \
              LOOKUP16(13, black, eof2d_##eoflab);                    \
              switch (te->state) {                                    \
                case S_TermB:                                         \
                  SETVALUE(static_cast<int32_t>(te->param));          \
                  goto doneWhite2da_##eoflab;                         \
                case S_MakeUpB:                                       \
                case S_MakeUp:                                        \
                  a0 += te->param;                                    \
                  RunLength += te->param;                             \
                  break;                                              \
                default:                                              \
                  goto eol2d_##eoflab;                                \
              }                                                       \
            }                                                         \
          doneWhite2da_##eoflab:;                                     \
            for (;;) {                                                \
              LOOKUP16(12, white, eof2d_##eoflab);                    \
              switch (te->state) {                                    \
                case S_TermW:                                         \
                  SETVALUE(static_cast<int32_t>(te->param));          \
                  goto doneBlack2da_##eoflab;                         \
                case S_MakeUpW:                                       \
                case S_MakeUp:                                        \
                  a0 += te->param;                                    \
                  RunLength += te->param;                             \
                  break;                                              \
                default:                                              \
                  goto eol2d_##eoflab;                                \
              }                                                       \
            }                                                         \
          doneBlack2da_##eoflab:;                                     \
          } else {                                                    \
            for (;;) {                                                \
              LOOKUP16(12, white, eof2d_##eoflab);                    \
              switch (te->state) {                                    \
                case S_TermW:                                         \
                  SETVALUE(static_cast<int32_t>(te->param));          \
                  goto doneWhite2db_##eoflab;                         \
                case S_MakeUpW:                                       \
                case S_MakeUp:                                        \
                  a0 += te->param;                                    \
                  RunLength += te->param;                             \
                  break;                                              \
                default:                                              \
                  goto eol2d_##eoflab;                                \
              }                                                       \
            }                                                         \
          doneWhite2db_##eoflab:;                                     \
            for (;;) {                                                \
              LOOKUP16(13, black, eof2d_##eoflab);                    \
              switch (te->state) {                                    \
                case S_TermB:                                         \
                  SETVALUE(static_cast<int32_t>(te->param));          \
                  goto doneBlack2db_##eoflab;                         \
                case S_MakeUpB:                                       \
                case S_MakeUp:                                        \
                  a0 += te->param;                                    \
                  RunLength += te->param;                             \
                  break;                                              \
                default:                                              \
                  goto eol2d_##eoflab;                                \
              }                                                       \
            }                                                         \
          doneBlack2db_##eoflab:;                                     \
          }                                                           \
          CHECK_b1;                                                   \
          break;                                                      \
        case S_V0:                                                    \
          CHECK_b1;                                                   \
          SETVALUE(b1 - a0);                                          \
          if (pb >= refruns + nruns) return -1;                       \
          b1 += *pb++;                                                \
          break;                                                      \
        case S_VR:                                                    \
          CHECK_b1;                                                   \
          SETVALUE(b1 - a0 + static_cast<int32_t>(te->param));        \
          if (pb >= refruns + nruns) return -1;                       \
          b1 += *pb++;                                                \
          break;                                                      \
        case S_VL:                                                    \
          CHECK_b1;                                                   \
          if (b1 < static_cast<int32_t>(a0 + te->param))              \
            goto eol2d_##eoflab;                                      \
          SETVALUE(b1 - a0 - static_cast<int32_t>(te->param));        \
          b1 -= *--pb;                                                \
          break;                                                      \
        case S_Ext:                                                   \
          *pa++ = static_cast<uint32_t>(lastx - a0);                  \
          goto eol2d_##eoflab;                                        \
        case S_EOL:                                                   \
          *pa++ = static_cast<uint32_t>(lastx - a0);                  \
          NeedBits8(4, eof2d_##eoflab);                               \
          ClrBits(4);                                                 \
          EOLcnt = 1;                                                 \
          goto eol2d_##eoflab;                                        \
        default:                                                      \
          goto eol2d_##eoflab;                                        \
      }                                                               \
    }                                                                 \
    if (RunLength) {                                                  \
      if (RunLength + a0 < lastx) {                                   \
        NeedBits8(1, eof2d_##eoflab);                                 \
        if (!GetBits(1)) goto eol2d_##eoflab;                         \
        ClrBits(1);                                                   \
      }                                                               \
      SETVALUE(0);                                                    \
    }                                                                 \
    goto eol2d_##eoflab;                                              \
  eof2d_##eoflab:                                                     \
    CLEANUP_RUNS();                                                   \
    goto eoflab;                                                      \
  eol2d_##eoflab:                                                     \
    CLEANUP_RUNS();                                                   \
  } while (0)

namespace {

struct Strip {
  const uint8_t* data;
  size_t size;
  int scheme;      // 2, 32771, 3 or 4 (TIFF compression)
  uint32_t options;  // T4Options (3) or T6Options (4)
  int msb_first;   // FillOrder 1
  int32_t lastx;   // pixels in a row
  size_t rowbytes;
  size_t rows;
  size_t base;     // the strip's offset in the file (word alignment)
};

// One strip or tile into ``buf`` (rows * rowbytes). Returns libtiff's
// decode result: 1, or -1 (the read fails). ``noeol`` is the codec's
// FAXMODE_NOEOL, kept across the strips of an image.
int Decode(const Strip& s, uint8_t* buf, int* noeol) {
  static const Tables& t = GetTables();
  const TabEnt* main = t.main.data();
  const TabEnt* white = t.white.data();
  const TabEnt* black = t.black.data();
  const uint8_t* bitmap = kRev;
  static uint8_t identity[256];
  if (!s.msb_first) {
    for (int i = 0; i < 256; i++) identity[i] = static_cast<uint8_t>(i);
    bitmap = identity;
  }
  const bool two_d = s.scheme == 4 || (s.scheme == 3 && (s.options & 1));
  const int32_t lastx = s.lastx;
  // Fax3SetupState's run arrays: the current row's and the reference's
  uint32_t nruns = ((static_cast<uint32_t>(lastx) + 1 + 31) / 32) * 32;
  if (two_d) nruns *= 2;
  std::vector<uint32_t> runs(2 * static_cast<size_t>(nruns) + 1, 0);
  uint32_t* curruns = runs.data();
  uint32_t* refruns = two_d ? runs.data() + nruns : nullptr;
  if (refruns) {  // Fax3PreDecode: the reference line is white
    refruns[0] = static_cast<uint32_t>(lastx);
    refruns[1] = 0;
  }
  const uint8_t* const start = s.data;
  const uint8_t* cp = start;
  const uint8_t* ep = start + s.size;
  uint32_t BitAcc = 0;
  int BitsAvail = 0;
  int EOLcnt = 0;
  int32_t a0 = 0;
  int32_t RunLength = 0;
  uint32_t* pa = nullptr;
  uint32_t* thisrun = curruns;
  uint32_t* pb = nullptr;
  int32_t b1 = 0;
  const TabEnt* te = nullptr;
  size_t line = 0;

  if (s.scheme == 2 || s.scheme == 32771) {
    // Fax3DecodeRLE: no EOLs; each row starts on a byte (word) boundary
    while (line < s.rows) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun;
      EXPAND1D(EOFRLE);
      FillRuns(buf + line * s.rowbytes, thisrun, pa, lastx);
      if (s.scheme == 2) {
        int n = BitsAvail - (BitsAvail & ~7);
        ClrBits(n);
      } else {
        int n = BitsAvail - (BitsAvail & ~15);
        ClrBits(n);
        if (BitsAvail == 0 && ((s.base + (cp - start)) & 1)) cp++;
      }
      ++line;
      continue;
    EOFRLE:
      FillRuns(buf + line * s.rowbytes, thisrun, pa, lastx);
      return -1;
    }
    return 1;
  }

  if (s.scheme == 4) {
    // Fax4Decode: no EOLs; an EOL (EOFB) or the data's end stops the
    // strip, which succeeds if a row came before
    while (line < s.rows) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun = curruns;
      pb = refruns;
      b1 = static_cast<int32_t>(*pb++);
      EXPAND2D(EOFG4);
      if (EOLcnt) goto EOFG4;
      FillRuns(buf + line * s.rowbytes, thisrun, pa, lastx);
      SETVALUE(0);
      {
        uint32_t* tmp = curruns;
        curruns = refruns;
        refruns = tmp;
      }
      ++line;
      continue;
    EOFG4:
      FillRuns(buf + line * s.rowbytes, thisrun, pa, lastx);
      return line ? 1 : -1;
    }
    return 1;
  }

  // Group 3: each row after an EOL (SYNC_EOL); when the data ends where
  // an EOL is due, libtiff takes the strip for one without EOLs and
  // decodes it again from its start (FAXMODE_NOEOL), rows on from where
  // it was
RETRY:
  cp = start;
  BitAcc = 0;
  BitsAvail = 0;
  EOLcnt = 0;
  thisrun = curruns;
  while (line < s.rows) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    if (!*noeol) {
      if (EOLcnt == 0) {
        for (;;) {
          NeedBits16(11, EOF2D);
          if (GetBits(11) == 0) break;
          ClrBits(1);
        }
      }
      for (;;) {
        NeedBits8(8, noEOLFound);
        if (GetBits(8)) break;
        ClrBits(8);
      }
      while (GetBits(1) == 0) ClrBits(1);
      ClrBits(1);
      EOLcnt = 0;
      goto synced;
    noEOLFound:
      *noeol = 1;
      goto RETRY;
    }
  synced:
    if (two_d) {
      NeedBits8(1, EOF2D);
      {
        int is1D = GetBits(1);
        ClrBits(1);
        pb = refruns;
        b1 = static_cast<int32_t>(*pb++);
        if (is1D)
          EXPAND1D(EOF2Da);
        else
          EXPAND2D(EOF2Da);
      }
      FillRuns(buf + line * s.rowbytes, thisrun, pa, lastx);
      if (pa < thisrun + nruns) SETVALUE(0);
      {
        uint32_t* tmp = curruns;
        curruns = refruns;
        refruns = tmp;
      }
    } else {
      EXPAND1D(EOF1Da);
      FillRuns(buf + line * s.rowbytes, thisrun, pa, lastx);
    }
    ++line;
    continue;
  EOF2D:
    CLEANUP_RUNS();
  EOF1Da:
  EOF2Da:
    FillRuns(buf + line * s.rowbytes, thisrun, pa, lastx);
    return -1;
  }
  return 1;
}

}  // namespace

extern "C" {

// Decode one CCITT strip or tile of ``rows`` rows of ``width`` pixels,
// ``rowbytes`` apart, into ``out`` (MSB first, 1 = a black run, as
// libtiff leaves them), which keeps what it held where no row is
// written. ``base`` is the strip's file offset (Modified Huffman's word
// alignment follows the address). ``noeol`` carries Group 3's no-EOL
// mode from strip to strip. Returns 1 (libtiff succeeds) or -1 (it
// fails).
int cc_decode(const uint8_t* data, size_t size, int scheme, uint32_t options,
              int msb_first, int width, size_t rowbytes, size_t rows,
              size_t base, uint8_t* out, int* noeol) {
  static bool ready = false;
  if (!ready) {
    InitRev();
    ready = true;
  }
  Strip s{data, size, scheme, options, msb_first, width, rowbytes, rows,
          base};
  return Decode(s, out, noeol);
}

}  // extern "C"
