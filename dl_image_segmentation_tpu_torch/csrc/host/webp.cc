// WebP decoder of the port, written to give what PIL 12.1 gives through
// libwebp 1.6's WebPAnimDecoder (MODE_RGBA, default options): the RIFF
// container as WebPDemux validates it, the first frame on a canvas of
// transparent black, and
//  * VP8L lossless: transforms (predictor, cross colour, subtract
//    green, colour indexing), colour cache, meta prefix codes;
//  * VP8 lossy key frames: the boolean decoder, segment / filter /
//    quantizer headers, coefficient tokens, intra prediction (16x16,
//    4x4, chroma), inverse WHT and DCT, the simple and normal loop
//    filters; then libwebp's "fancy" upsampling and its fixed-point
//    YUV -> RGB (no dithering);
//  * ALPH: raw or VP8L-coded alpha, with its horizontal, vertical and
//    gradient filters.
// Built with g++ into build/ at first use and called through ctypes
// (raster/webp.py). The tables below are those of the VP8 (RFC 6386) and
// VP8L specifications.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

// Tables of the VP8 (RFC 6386) and VP8L bitstream specifications.
static const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
static const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
static const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ------------------------------------------------------------- helpers

namespace {

enum { kOk = 0, kOpenFail = 1, kDecodeFail = 2 };

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
inline int clip(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }
inline int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// ============================================================ VP8 lossy

// libwebp's boolean decoder (bit_reader), one byte at a time: the same
// bits, and the same end-of-data flag, as its 56-bit loads.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;  // range - 1
  int bits = -8;
  int eof = 0;

  void init(const uint8_t* start, size_t size) {
    buf = start;
    end = start + size;
    value = 0;
    range = 254;
    bits = -8;
    eof = 0;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (uint64_t)(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  uint32_t get_value(int nbits) {
    uint32_t v = 0;
    while (nbits-- > 0) v |= (uint32_t)get_bit(0x80) << nbits;
    return v;
  }
  int get_signed_value(int nbits) {
    const int v = (int)get_value(nbits);
    return get_bit(0x80) ? -v : v;
  }
};

enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
  TM_PRED = B_TM_PRED,
  B_DC_PRED_NOTOP = 4, B_DC_PRED_NOLEFT = 5, B_DC_PRED_NOTOPLEFT = 6
};

const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

struct QuantMatrix { int y1[2], y2[2], uv[2]; };
struct FInfo { int limit, ilevel, inner, hev; };
struct MBInfo {
  int segment, skip, is_i4x4, uvmode;
  uint8_t imodes[16];
  uint32_t non_zero_y, non_zero_uv;
  int16_t coeffs[384];
};

struct VP8Frame {
  int width, height, mb_w, mb_h;
  std::vector<uint8_t> y, u, v;  // mb-aligned planes
  int y_stride, uv_stride;
};

int GetLargeValue(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.get_bit(p[3])) {
    if (!br.get_bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br.get_bit(p[5]);
    }
  } else {
    if (!br.get_bit(p[6])) {
      if (!br.get_bit(p[7])) {
        v = 5 + br.get_bit(159);
      } else {
        v = 7 + 2 * br.get_bit(165);
        v += br.get_bit(145);
      }
    } else {
      const int bit1 = br.get_bit(p[8]);
      const int bit0 = br.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

int GetCoeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx,
              const int* dq, int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;
    while (!br.get_bit(p[1])) {
      ++n;
      p = bands[kBands[n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = GetLargeValue(br, p);
      p = p_ctx[2];
    }
    const int s = br.get_bit(0x80) ? -v : v;
    out[kZigzag[n]] = (int16_t)(s * dq[n > 0]);
  }
  return 16;
}

void TransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

inline int MUL1(int a) { return ((a * 20091) >> 16) + a; }
inline int MUL2(int a) { return (a * 35468) >> 16; }

void TransformOne(const int16_t* in, uint8_t* dst, int stride) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = MUL2(in[4]) - MUL1(in[12]);
    const int d = MUL1(in[4]) + MUL2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = MUL2(tmp[4]) - MUL1(tmp[12]);
    const int d = MUL1(tmp[4]) + MUL2(tmp[12]);
    dst[0] = (uint8_t)clip8(dst[0] + ((a + d) >> 3));
    dst[1] = (uint8_t)clip8(dst[1] + ((b + c) >> 3));
    dst[2] = (uint8_t)clip8(dst[2] + ((b - c) >> 3));
    dst[3] = (uint8_t)clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += stride;
  }
}

inline bool any_nonzero(const int16_t* c) {
  for (int i = 0; i < 16; ++i) if (c[i]) return true;
  return false;
}

// ---- intra prediction on a work block with borders (libwebp's yuv_b_)
const int BPS = 32;

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void TrueMotion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = (uint8_t)clip8(top[x] + l - tl);
    dst += BPS;
  }
}

void Pred4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, (int)dc, 4);
      break;
    }
    case B_TM_PRED: TrueMotion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {AVG3(top[-1], top[0], top[1]), AVG3(top[0], top[1], top[2]),
                               AVG3(top[1], top[2], top[3]), AVG3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS];
      const int D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, AVG3(A, B, C), 4);
      memset(dst + 1 * BPS, AVG3(B, C, D), 4);
      memset(dst + 2 * BPS, AVG3(C, D, E), 4);
      memset(dst + 3 * BPS, AVG3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS];
      const int K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS];
      const int C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
      const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS];
      const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS];
      const int C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
      const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS];
      const int K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(X, I, J);
      DST(1, 2) = DST(3, 3) = AVG3(I, J, K);
      DST(1, 3) = AVG3(J, K, L);
      break;
    }
    case B_HU_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS];
      const int K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
      break;
    }
  }
}

// 16x16 luma (size 16) and 8x8 chroma (size 8)
void PredBlock(int mode, uint8_t* dst, int size) {
  const int shift = size == 16 ? 5 : 4;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      const int v = dc >> shift;
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
      break;
    }
    case B_DC_PRED_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      const int v = dc >> (shift - 1);
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      const int v = dc >> (shift - 1);
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
      break;
    }
    case B_DC_PRED_NOTOPLEFT:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, 0x80, size);
      break;
    case TM_PRED: TrueMotion(dst, size); break;
    case V_PRED:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
  }
}

int CheckMode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return (mb_y == 0) ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
    return (mb_y == 0) ? B_DC_PRED_NOTOP : B_DC_PRED;
  }
  return mode;
}

// ---- loop filter
inline int sclip1(int v) { return clip(v, -128, 127); }
inline int sclip2(int v) { return clip(v, -16, 15); }
inline int abs0(int v) { return v < 0 ? -v : v; }

inline void DoFilter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = (uint8_t)clip8(p0 + a2);
  p[0] = (uint8_t)clip8(q0 - a1);
}
inline void DoFilter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = (uint8_t)clip8(p1 + a3);
  p[-step] = (uint8_t)clip8(p0 + a2);
  p[0] = (uint8_t)clip8(q0 - a1);
  p[step] = (uint8_t)clip8(q1 - a3);
}
inline void DoFilter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = (uint8_t)clip8(p2 + a3);
  p[-2 * step] = (uint8_t)clip8(p1 + a2);
  p[-step] = (uint8_t)clip8(p0 + a1);
  p[0] = (uint8_t)clip8(q0 - a1);
  p[step] = (uint8_t)clip8(q1 - a2);
  p[2 * step] = (uint8_t)clip8(q2 - a3);
}
inline int Hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (abs0(p1 - p0) > thresh) || (abs0(q1 - q0) > thresh);
}
inline int NeedsFilter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * abs0(p0 - q0) + abs0(p1 - q1)) <= t;
}
inline int NeedsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * abs0(p0 - q0) + abs0(p1 - q1)) > t) return 0;
  return abs0(p3 - p2) <= it && abs0(p2 - p1) <= it && abs0(p1 - p0) <= it &&
         abs0(q3 - q2) <= it && abs0(q2 - q1) <= it && abs0(q1 - q0) <= it;
}
void SimpleFilter(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i) {
    if (NeedsFilter(p + i * vstride, hstride, thresh2)) DoFilter2(p + i * vstride, hstride);
  }
}
void FilterLoop26(uint8_t* p, int hstride, int vstride, int size, int thresh,
                  int ithresh, int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (NeedsFilter2(p, hstride, thresh2, ithresh)) {
      if (Hev(p, hstride, hev_thresh)) DoFilter2(p, hstride);
      else DoFilter6(p, hstride);
    }
    p += vstride;
  }
}
void FilterLoop24(uint8_t* p, int hstride, int vstride, int size, int thresh,
                  int ithresh, int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (NeedsFilter2(p, hstride, thresh2, ithresh)) {
      if (Hev(p, hstride, hev_thresh)) DoFilter2(p, hstride);
      else DoFilter4(p, hstride);
    }
    p += vstride;
  }
}

// Decodes a VP8 key frame into mb-aligned Y, U, V planes (with the loop
// filter applied). Returns kOk, kOpenFail (header) or kDecodeFail.
int DecodeVP8(const uint8_t* data, size_t size, VP8Frame& f) {
  if (size < 10) return kOpenFail;
  const uint32_t bits = le24(data);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (!key_frame || profile > 3 || !show) return kOpenFail;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kOpenFail;
  const int width = le16(data + 6) & 0x3fff;
  const int height = le16(data + 8) & 0x3fff;
  if (width == 0 || height == 0) return kOpenFail;
  const uint8_t* buf = data + 10;
  size_t buf_size = size - 10;
  if (partition_length > buf_size) return kDecodeFail;
  f.width = width;
  f.height = height;
  f.mb_w = (width + 15) >> 4;
  f.mb_h = (height + 15) >> 4;

  BoolReader br;
  br.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  br.get_value(1);  // colorspace
  br.get_value(1);  // clamp type

  // segment header
  int use_segment = br.get_value(1), update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.get_value(1);
    if (br.get_value(1)) {
      absolute_delta = br.get_value(1);
      for (int s = 0; s < 4; ++s) quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
    }
    if (update_map) {
      for (int s = 0; s < 3; ++s) seg_proba[s] = br.get_value(1) ? (uint8_t)br.get_value(8) : 255;
    }
  } else {
    update_map = 0;
  }
  // filter header
  const int simple = br.get_value(1);
  const int level = br.get_value(6);
  const int sharpness = br.get_value(3);
  const int use_lf_delta = br.get_value(1);
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  if (use_lf_delta) {
    if (br.get_value(1)) {
      for (int i = 0; i < 4; ++i) if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
      for (int i = 0; i < 4; ++i) if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
    }
  }
  const int filter_type = (level == 0) ? 0 : simple ? 1 : 2;
  if (br.eof) return kDecodeFail;

  // partitions
  const int num_parts_minus_one = (1 << br.get_value(2)) - 1;
  std::vector<BoolReader> parts(num_parts_minus_one + 1);
  {
    const uint8_t* sz = buf;
    const uint8_t* buf_end = buf + buf_size;
    size_t size_left = buf_size;
    const int last_part = num_parts_minus_one;
    if (buf_size < (size_t)(3 * last_part)) return kDecodeFail;
    const uint8_t* part_start = buf + last_part * 3;
    size_left -= last_part * 3;
    for (int p = 0; p < last_part; ++p) {
      size_t psize = le24(sz);
      if (psize > size_left) psize = size_left;
      parts[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[last_part].init(part_start, size_left);
    if (!(part_start < buf_end)) return kDecodeFail;
  }

  // quantizers
  QuantMatrix dqm[4];
  {
    const int base_q0 = br.get_value(7);
    const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else {
        if (i > 0) {
          dqm[i] = dqm[0];
          continue;
        }
        q = base_q0;
      }
      QuantMatrix& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 0, 127)];
      m.y1[1] = kAcTable[clip(q + 0, 0, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 0, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 0, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 0, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 0, 127)];
    }
  }
  br.get_value(1);  // update_proba, ignored on a key frame

  // coefficient probabilities
  uint8_t bands[4][8][3][11];
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int idx = ((t * 8 + b) * 3 + c) * 11 + p;
          bands[t][b][c][p] = br.get_bit(kCoeffsUpdateProba[idx]) ? (uint8_t)br.get_value(8)
                                                                    : kCoeffsProba0[idx];
        }
  const int use_skip_proba = br.get_value(1);
  const int skip_p = use_skip_proba ? (int)br.get_value(8) : 0;

  // filter strengths
  FInfo fstrengths[4][2];
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment) {
      base_level = filter_strength[s];
      if (!absolute_delta) base_level += level;
    } else {
      base_level = level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = fstrengths[s][i4x4];
      int lv = base_level;
      if (use_lf_delta) {
        lv += ref_lf_delta[0];
        if (i4x4) lv += mode_lf_delta[0];
      }
      lv = (lv < 0) ? 0 : (lv > 63) ? 63 : lv;
      if (lv > 0) {
        int ilevel = lv;
        if (sharpness > 0) {
          if (sharpness > 4) ilevel >>= 2;
          else ilevel >>= 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * lv + ilevel;
        info.hev = (lv >= 40) ? 2 : (lv >= 15) ? 1 : 0;
      } else {
        info.limit = 0;
        info.ilevel = 0;
        info.hev = 0;
      }
      info.inner = i4x4;
    }
  }

  const int mb_w = f.mb_w, mb_h = f.mb_h;
  f.y_stride = mb_w * 16;
  f.uv_stride = mb_w * 8;
  f.y.assign((size_t)f.y_stride * mb_h * 16, 0);
  f.u.assign((size_t)f.uv_stride * mb_h * 8, 0);
  f.v.assign((size_t)f.uv_stride * mb_h * 8, 0);

  std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
  uint8_t intra_l[4];
  // non-zero contexts: top per mb, left
  std::vector<uint32_t> nz_top(mb_w, 0), nz_dc_top(mb_w, 0);
  uint32_t nz_left = 0, nz_dc_left = 0;
  std::vector<MBInfo> mbs(mb_w);
  std::vector<FInfo> finfo((size_t)mb_w * mb_h);
  // unfiltered top samples of each mb column
  std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
  // work blocks with borders (libwebp's yuv_b_)
  uint8_t ybuf[BPS * 21];
  uint8_t ubuf[BPS * 9], vbuf[BPS * 9];
  uint8_t* const Y = ybuf + BPS + 8;
  uint8_t* const U = ubuf + BPS + 8;
  uint8_t* const V = vbuf + BPS + 8;

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader& token_br = parts[mb_y & num_parts_minus_one];
    // intra modes of the row
    memset(intra_l, B_DC_PRED, 4);
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBInfo& block = mbs[mb_x];
      uint8_t* top = &intra_t[4 * mb_x];
      if (update_map) {
        block.segment = !br.get_bit(seg_proba[0]) ? br.get_bit(seg_proba[1])
                                                  : br.get_bit(seg_proba[2]) + 2;
      } else {
        block.segment = 0;
      }
      block.skip = use_skip_proba ? br.get_bit(skip_p) : 0;
      block.is_i4x4 = !br.get_bit(145);
      if (!block.is_i4x4) {
        const int ymode = br.get_bit(156) ? (br.get_bit(128) ? TM_PRED : H_PRED)
                                          : (br.get_bit(163) ? V_PRED : DC_PRED);
        block.imodes[0] = (uint8_t)ymode;
        memset(top, ymode, 4);
        memset(intra_l, ymode, 4);
      } else {
        uint8_t* modes = block.imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
            int i = kYModesIntra4[br.get_bit(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.get_bit(prob[i])];
            ymode = -i;
            top[x] = (uint8_t)ymode;
          }
          memcpy(modes, top, 4);
          modes += 4;
          intra_l[y] = (uint8_t)ymode;
        }
      }
      block.uvmode = !br.get_bit(142) ? DC_PRED : !br.get_bit(114) ? V_PRED
                                                  : br.get_bit(183) ? TM_PRED : H_PRED;
    }
    if (br.eof) return kDecodeFail;

    // residuals
    nz_left = 0;
    nz_dc_left = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBInfo& block = mbs[mb_x];
      int skip = use_skip_proba ? block.skip : 0;
      if (!skip) {
        const QuantMatrix& q = dqm[block.segment];
        int16_t* dst = block.coeffs;
        memset(dst, 0, sizeof(block.coeffs));
        uint32_t non_zero_y = 0, non_zero_uv = 0;
        int first;
        const uint8_t (*ac_proba)[3][11];
        if (!block.is_i4x4) {
          int16_t dc[16] = {0};
          const int ctx = nz_dc_top[mb_x] + nz_dc_left;
          const int nz = GetCoeffs(token_br, bands[1], ctx, q.y2, 0, dc);
          nz_dc_top[mb_x] = nz_dc_left = (nz > 0);
          if (nz > 1) {
            TransformWHT(dc, dst);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
          }
          first = 1;
          ac_proba = bands[0];
        } else {
          first = 0;
          ac_proba = bands[3];
        }
        uint32_t tnz = nz_top[mb_x] & 0x0f;
        uint32_t lnz = nz_left & 0x0f;
        for (int y = 0; y < 4; ++y) {
          int l = lnz & 1;
          uint32_t nz_coeffs = 0;
          for (int x = 0; x < 4; ++x) {
            const int ctx = l + (tnz & 1);
            const int nz = GetCoeffs(token_br, ac_proba, ctx, q.y1, first, dst);
            l = (nz > first);
            tnz = (tnz >> 1) | (l << 7);
            nz_coeffs = (nz_coeffs << 2) | ((nz > 3) ? 3 : (nz > 1) ? 2 : (dst[0] != 0));
            dst += 16;
          }
          tnz >>= 4;
          lnz = (lnz >> 1) | (l << 7);
          non_zero_y = (non_zero_y << 8) | nz_coeffs;
        }
        uint32_t out_t_nz = tnz;
        uint32_t out_l_nz = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          uint32_t nz_coeffs = 0;
          tnz = nz_top[mb_x] >> (4 + ch);
          lnz = nz_left >> (4 + ch);
          for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
              const int ctx = l + (tnz & 1);
              const int nz = GetCoeffs(token_br, bands[2], ctx, q.uv, 0, dst);
              l = (nz > 0);
              tnz = (tnz >> 1) | (l << 3);
              nz_coeffs = (nz_coeffs << 2) | ((nz > 3) ? 3 : (nz > 1) ? 2 : (dst[0] != 0));
              dst += 16;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (l << 5);
          }
          non_zero_uv |= nz_coeffs << (4 * ch);
          out_t_nz |= (tnz << 4) << ch;
          out_l_nz |= (lnz & 0xf0) << ch;
        }
        nz_top[mb_x] = out_t_nz;
        nz_left = out_l_nz;
        block.non_zero_y = non_zero_y;
        block.non_zero_uv = non_zero_uv;
        skip = !(non_zero_y | non_zero_uv);
      } else {
        nz_left = 0;
        nz_top[mb_x] = 0;
        if (!block.is_i4x4) {
          nz_dc_left = 0;
          nz_dc_top[mb_x] = 0;
        }
        block.non_zero_y = 0;
        block.non_zero_uv = 0;
        memset(block.coeffs, 0, sizeof(block.coeffs));
      }
      if (filter_type > 0) {
        FInfo fi = fstrengths[block.segment][block.is_i4x4];
        fi.inner |= !skip;
        finfo[(size_t)mb_y * mb_w + mb_x] = fi;
      }
      if (token_br.eof) return kDecodeFail;
    }

    // reconstruction of the row (libwebp's ReconstructRow)
    for (int j = 0; j < 16; ++j) Y[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      U[j * BPS - 1] = 129;
      V[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      Y[-1 - BPS] = U[-1 - BPS] = V[-1 - BPS] = 129;
    } else {
      memset(Y - BPS - 1, 127, 16 + 4 + 1);
      memset(U - BPS - 1, 127, 8 + 1);
      memset(V - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBInfo& block = mbs[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) memcpy(&Y[j * BPS - 4], &Y[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&U[j * BPS - 4], &U[j * BPS + 4], 4);
          memcpy(&V[j * BPS - 4], &V[j * BPS + 4], 4);
        }
      }
      if (mb_y > 0) {
        memcpy(Y - BPS, &top_y[16 * mb_x], 16);
        memcpy(U - BPS, &top_u[8 * mb_x], 8);
        memcpy(V - BPS, &top_v[8 * mb_x], 8);
      }
      const int16_t* coeffs = block.coeffs;
      if (block.is_i4x4) {
        uint8_t* top_right = Y - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) {
            memset(top_right, top_y[16 * mb_x + 15], 4);
          } else {
            memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
          }
        }
        memcpy(top_right + BPS * 4, top_right, 4);
        memcpy(top_right + BPS * 8, top_right, 4);
        memcpy(top_right + BPS * 12, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = Y + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          Pred4(block.imodes[n], dst);
          if (any_nonzero(coeffs + n * 16)) TransformOne(coeffs + n * 16, dst, BPS);
        }
      } else {
        PredBlock(CheckMode(mb_x, mb_y, block.imodes[0]), Y, 16);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = Y + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          if (any_nonzero(coeffs + n * 16)) TransformOne(coeffs + n * 16, dst, BPS);
        }
      }
      {
        const int mode = CheckMode(mb_x, mb_y, block.uvmode);
        PredBlock(mode, U, 8);
        PredBlock(mode, V, 8);
        for (int n = 0; n < 4; ++n) {
          const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
          if (any_nonzero(coeffs + 256 + n * 16)) TransformOne(coeffs + 256 + n * 16, U + off, BPS);
          if (any_nonzero(coeffs + 320 + n * 16)) TransformOne(coeffs + 320 + n * 16, V + off, BPS);
        }
      }
      // stash the unfiltered top samples for the next row
      if (mb_y < mb_h - 1) {
        memcpy(&top_y[16 * mb_x], Y + 15 * BPS, 16);
        memcpy(&top_u[8 * mb_x], U + 7 * BPS, 8);
        memcpy(&top_v[8 * mb_x], V + 7 * BPS, 8);
      }
      // copy to the frame
      for (int j = 0; j < 16; ++j)
        memcpy(&f.y[(size_t)(mb_y * 16 + j) * f.y_stride + mb_x * 16], Y + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(&f.u[(size_t)(mb_y * 8 + j) * f.uv_stride + mb_x * 8], U + j * BPS, 8);
        memcpy(&f.v[(size_t)(mb_y * 8 + j) * f.uv_stride + mb_x * 8], V + j * BPS, 8);
      }
    }
  }

  // loop filter, macroblocks in raster order
  if (filter_type > 0) {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& fi = finfo[(size_t)mb_y * mb_w + mb_x];
        const int limit = fi.limit, ilevel = fi.ilevel;
        if (limit == 0) continue;
        const int ys = f.y_stride, uvs = f.uv_stride;
        uint8_t* yd = &f.y[(size_t)mb_y * 16 * ys + mb_x * 16];
        if (filter_type == 1) {
          if (mb_x > 0) SimpleFilter(yd, 1, ys, 16, limit + 4);
          if (fi.inner) for (int k = 1; k <= 3; ++k) SimpleFilter(yd + 4 * k, 1, ys, 16, limit);
          if (mb_y > 0) SimpleFilter(yd, ys, 1, 16, limit + 4);
          if (fi.inner) for (int k = 1; k <= 3; ++k) SimpleFilter(yd + 4 * k * ys, ys, 1, 16, limit);
        } else {
          uint8_t* ud = &f.u[(size_t)mb_y * 8 * uvs + mb_x * 8];
          uint8_t* vd = &f.v[(size_t)mb_y * 8 * uvs + mb_x * 8];
          const int hev = fi.hev;
          if (mb_x > 0) {
            FilterLoop26(yd, 1, ys, 16, limit + 4, ilevel, hev);
            FilterLoop26(ud, 1, uvs, 8, limit + 4, ilevel, hev);
            FilterLoop26(vd, 1, uvs, 8, limit + 4, ilevel, hev);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k) FilterLoop24(yd + 4 * k, 1, ys, 16, limit, ilevel, hev);
            FilterLoop24(ud + 4, 1, uvs, 8, limit, ilevel, hev);
            FilterLoop24(vd + 4, 1, uvs, 8, limit, ilevel, hev);
          }
          if (mb_y > 0) {
            FilterLoop26(yd, ys, 1, 16, limit + 4, ilevel, hev);
            FilterLoop26(ud, uvs, 1, 8, limit + 4, ilevel, hev);
            FilterLoop26(vd, uvs, 1, 8, limit + 4, ilevel, hev);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k) FilterLoop24(yd + 4 * k * ys, ys, 1, 16, limit, ilevel, hev);
            FilterLoop24(ud + 4 * uvs, uvs, 1, 8, limit, ilevel, hev);
            FilterLoop24(vd + 4 * uvs, uvs, 1, 8, limit, ilevel, hev);
          }
        }
      }
    }
  }
  return kOk;
}

// ---- libwebp's fixed-point YUV -> RGB and its "fancy" upsampler
inline int MultHi(int v, int coeff) { return (v * coeff) >> 8; }
inline int YuvClip8(int v) {
  const int kMask = (256 << 6) - 1;
  return ((v & ~kMask) == 0) ? (v >> 6) : (v < 0) ? 0 : 255;
}
inline void YuvToRgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = (uint8_t)YuvClip8(MultHi(y, 19077) + MultHi(v, 26149) - 14234);
  rgba[1] = (uint8_t)YuvClip8(MultHi(y, 19077) - MultHi(u, 6419) - MultHi(v, 13320) + 8708);
  rgba[2] = (uint8_t)YuvClip8(MultHi(y, 19077) + MultHi(u, 33050) - 17685);
  rgba[3] = 0xff;
}

#define LOAD_UV(u, v) ((u) | ((v) << 16))

void UpsampleLinePair(const uint8_t* top_y, const uint8_t* bottom_y,
                      const uint8_t* top_u, const uint8_t* top_v,
                      const uint8_t* cur_u, const uint8_t* cur_v,
                      uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = LOAD_UV(top_u[0], top_v[0]);
  uint32_t l_uv = LOAD_UV(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    YuvToRgba(top_y[0], uv0 & 0xff, (uv0 >> 16), top_dst);
  }
  if (bottom_y != nullptr) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    YuvToRgba(bottom_y[0], uv0 & 0xff, (uv0 >> 16), bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = LOAD_UV(top_u[x], top_v[x]);
    const uint32_t uv = LOAD_UV(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      YuvToRgba(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16), top_dst + (2 * x - 1) * 4);
      YuvToRgba(top_y[2 * x - 0], uv1 & 0xff, (uv1 >> 16), top_dst + (2 * x - 0) * 4);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      YuvToRgba(bottom_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16), bottom_dst + (2 * x - 1) * 4);
      YuvToRgba(bottom_y[2 * x + 0], uv1 & 0xff, (uv1 >> 16), bottom_dst + (2 * x + 0) * 4);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      YuvToRgba(top_y[len - 1], uv0 & 0xff, (uv0 >> 16), top_dst + (len - 1) * 4);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      YuvToRgba(bottom_y[len - 1], uv0 & 0xff, (uv0 >> 16), bottom_dst + (len - 1) * 4);
    }
  }
}

// The picture (width x height) of a decoded frame as RGBA rows of
// ``stride`` bytes: EmitFancyRGB over the whole picture.
void EmitFancyRgba(const VP8Frame& f, uint8_t* dst, size_t stride) {
  const int w = f.width, h = f.height;
  const uint8_t* y = f.y.data();
  const uint8_t* u = f.u.data();
  const uint8_t* v = f.v.data();
  const int ys = f.y_stride, uvs = f.uv_stride;
  UpsampleLinePair(y, nullptr, u, v, u, v, dst, nullptr, w);
  int row = 0;
  for (; row + 2 < h; row += 2) {
    const uint8_t* top_u = u + (size_t)(row / 2) * uvs;
    const uint8_t* top_v = v + (size_t)(row / 2) * uvs;
    const uint8_t* cur_u = top_u + uvs;
    const uint8_t* cur_v = top_v + uvs;
    UpsampleLinePair(y + (size_t)(row + 1) * ys, y + (size_t)(row + 2) * ys, top_u, top_v,
                     cur_u, cur_v, dst + (row + 1) * stride, dst + (row + 2) * stride, w);
  }
  if (!(h & 1)) {
    const uint8_t* cur_u = u + (size_t)(h / 2 - 1) * uvs;
    const uint8_t* cur_v = v + (size_t)(h / 2 - 1) * uvs;
    UpsampleLinePair(y + (size_t)(h - 1) * ys, nullptr, cur_u, cur_v, cur_u, cur_v,
                     dst + (size_t)(h - 1) * stride, nullptr, w);
  }
}

// ========================================================== VP8L lossless

struct LBitReader {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;      // next byte
  uint64_t val = 0;
  int bits = 0;        // bits in val
  int eos = 0;

  LBitReader(const uint8_t* d, size_t n) : data(d), len(n) {}
  uint32_t read(int n) {
    while (bits < n) {
      if (pos < len) {
        val |= (uint64_t)data[pos++] << bits;
      } else {
        // reading past the end: libwebp flags the end of the stream
        eos = 1;
      }
      bits += 8;
    }
    const uint32_t v = (uint32_t)(val & ((n == 32) ? 0xffffffffull : ((1ull << n) - 1)));
    val >>= n;
    bits -= n;
    return v;
  }
};

// canonical prefix code, read as DEFLATE reads its codes
struct Huffman {
  std::vector<uint16_t> counts;   // per length 0..15
  std::vector<uint16_t> symbols;  // by code order
  int single = -1;                // only one symbol: no bits
  int max_len = 0;

  bool build(const int* lengths, int n) {
    counts.assign(16, 0);
    symbols.clear();
    int nonzero = 0, last = -1;
    for (int i = 0; i < n; ++i) {
      if (lengths[i] > 15 || lengths[i] < 0) return false;
      counts[lengths[i]]++;
      if (lengths[i]) {
        nonzero++;
        last = i;
      }
    }
    if (nonzero == 0) return false;
    if (nonzero == 1) {
      single = last;
      return true;
    }
    single = -1;
    // the code must be complete
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
      left <<= 1;
      left -= counts[len];
      if (left < 0) return false;
      if (counts[len]) max_len = len;
    }
    if (left != 0) return false;
    std::vector<int> offs(16, 0);
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + counts[len];
    symbols.assign(nonzero, 0);
    for (int i = 0; i < n; ++i)
      if (lengths[i]) symbols[offs[lengths[i]]++] = (uint16_t)i;
    counts[0] = 0;
    return true;
  }
  int read(LBitReader& br) const {
    if (single >= 0) return single;
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= max_len; ++len) {
      code |= (int)br.read(1);
      const int count = counts[len];
      if (code - count < first) return symbols[index + (code - first)];
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    return -1;
  }
};

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8,
                                      9, 10, 11, 12, 13, 14, 15};

bool ReadHuffmanCode(LBitReader& br, int alphabet_size, Huffman& h) {
  std::vector<int> code_lengths(alphabet_size, 0);
  const int simple_code = br.read(1);
  if (simple_code) {
    const int num_symbols = br.read(1) + 1;
    const int first_symbol_len_code = br.read(1);
    // a symbol past the alphabet is not counted (libwebp sizes its
    // length array for the largest alphabet and builds from the first
    // alphabet_size entries)
    int symbol = br.read((first_symbol_len_code == 0) ? 1 : 8);
    if (symbol < alphabet_size) code_lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = br.read(8);
      if (symbol < alphabet_size) code_lengths[symbol] = 1;
    }
  } else {
    int cl_lengths[19] = {0};
    const int num_codes = br.read(4) + 4;
    if (num_codes > 19) return false;
    for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
    Huffman cl;
    if (!cl.build(cl_lengths, 19)) return false;
    int max_symbol;
    if (br.read(1)) {
      const int length_nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(length_nbits);
      if (max_symbol > alphabet_size) return false;
    } else {
      max_symbol = alphabet_size;
    }
    int symbol = 0, prev_code_len = 8;
    while (symbol < alphabet_size) {
      if (max_symbol-- == 0) break;
      if (br.eos) return false;
      const int code_len = cl.read(br);
      if (code_len < 0) return false;
      if (code_len < 16) {
        code_lengths[symbol++] = code_len;
        if (code_len != 0) prev_code_len = code_len;
      } else {
        const int use_prev = (code_len == 16);
        const int slot = code_len - 16;
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int repeat = br.read(kExtra[slot]) + kOffset[slot];
        if (symbol + repeat > alphabet_size) return false;
        const int length = use_prev ? prev_code_len : 0;
        for (int r = 0; r < repeat; ++r) code_lengths[symbol++] = length;
      }
    }
  }
  if (br.eos) return false;
  return h.build(code_lengths.data(), alphabet_size);
}

inline int GetCopyDistance(int symbol, LBitReader& br) {
  if (symbol < 4) return symbol + 1;
  const int extra_bits = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra_bits;
  return offset + br.read(extra_bits) + 1;
}

inline int PlaneCodeToDistance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return (dist >= 1) ? dist : 1;
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

inline int DivRound(int num, int bits) { return (num + (1 << bits) - 1) >> bits; }

bool DecodeImageStream(int xsize, int ysize, bool is_level0, LBitReader& br,
                       std::vector<uint32_t>& out, int depth);

bool DecodeEntropyImage(int xsize, int ysize, LBitReader& br, std::vector<uint32_t>& out,
                        int depth) {
  return DecodeImageStream(xsize, ysize, false, br, out, depth + 1);
}

inline uint32_t Average2(uint32_t a0, uint32_t a1) {
  return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1);
}
inline int Sub3(int a, int b, int c) {
  const int pb = b - c;
  const int pa = a - c;
  return abs(pb) - abs(pa);
}
inline uint32_t Select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = Sub3((a >> 24), (b >> 24), (c >> 24)) +
                          Sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          Sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          Sub3((a) & 0xff, (b) & 0xff, (c) & 0xff);
  return (pa_minus_pb <= 0) ? a : b;
}
inline uint32_t Clip255(uint32_t a) {
  if (a < 256) return a;
  return ~a >> 24;
}
inline int AddSubtractComponentFull(int a, int b, int c) { return (int)Clip255((uint32_t)(a + b - c)); }
inline uint32_t ClampedAddSubtractFull(uint32_t c0, uint32_t c1, uint32_t c2) {
  const int a = AddSubtractComponentFull(c0 >> 24, c1 >> 24, c2 >> 24);
  const int r = AddSubtractComponentFull((c0 >> 16) & 0xff, (c1 >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = AddSubtractComponentFull((c0 >> 8) & 0xff, (c1 >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = AddSubtractComponentFull(c0 & 0xff, c1 & 0xff, c2 & 0xff);
  return ((uint32_t)a << 24) | (r << 16) | (g << 8) | b;
}
inline int AddSubtractComponentHalf(int a, int b) { return (int)Clip255((uint32_t)(a + (a - b) / 2)); }
inline uint32_t ClampedAddSubtractHalf(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = Average2(c0, c1);
  const int a = AddSubtractComponentHalf(ave >> 24, c2 >> 24);
  const int r = AddSubtractComponentHalf((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = AddSubtractComponentHalf((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = AddSubtractComponentHalf((ave >> 0) & 0xff, (c2 >> 0) & 0xff);
  return ((uint32_t)a << 24) | (r << 16) | (g << 8) | b;
}
inline uint32_t AddPixels(uint32_t a, uint32_t b) {
  const uint32_t alpha_and_green = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t red_and_blue = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (alpha_and_green & 0xff00ff00u) | (red_and_blue & 0x00ff00ffu);
}

uint32_t Predict(int mode, const uint32_t* cur, int x, int width) {
  const uint32_t L = cur[x - 1];
  const uint32_t* top = cur - width;
  const uint32_t T = top[x], TL = top[x - 1], TR = top[x + 1];
  switch (mode) {
    case 0: return 0xff000000u;
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return Average2(Average2(L, TR), T);
    case 6: return Average2(L, TL);
    case 7: return Average2(L, T);
    case 8: return Average2(TL, T);
    case 9: return Average2(T, TR);
    case 10: return Average2(Average2(L, TL), Average2(T, TR));
    case 11: return Select(T, L, TL);
    case 12: return ClampedAddSubtractFull(L, T, TL);
    case 13: return ClampedAddSubtractHalf(L, T, TL);
    default: return 0xff000000u;
  }
}

void InversePredictor(const Transform& t, std::vector<uint32_t>& px, int width, int height) {
  uint32_t* d = px.data();
  // first row: black, then left
  d[0] = AddPixels(d[0], 0xff000000u);
  for (int x = 1; x < width; ++x) d[x] = AddPixels(d[x], d[x - 1]);
  const int tiles_per_row = DivRound(width, t.bits);
  for (int y = 1; y < height; ++y) {
    uint32_t* cur = d + (size_t)y * width;
    const uint32_t* pred_row = t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
    cur[0] = AddPixels(cur[0], cur[-width]);
    for (int x = 1; x < width; ++x) {
      const int mode = (pred_row[x >> t.bits] >> 8) & 0xf;
      cur[x] = AddPixels(cur[x], Predict(mode, cur, x, width));
    }
  }
}

inline int ColorTransformDelta(int8_t color_pred, int8_t color) {
  return ((int)color_pred * color) >> 5;
}

void InverseCrossColor(const Transform& t, std::vector<uint32_t>& px, int width, int height) {
  const int tiles_per_row = DivRound(width, t.bits);
  for (int y = 0; y < height; ++y) {
    const uint32_t* pred_row = t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
    uint32_t* row = px.data() + (size_t)y * width;
    for (int x = 0; x < width; ++x) {
      const uint32_t code = pred_row[x >> t.bits];
      const int8_t g2r = (int8_t)(code & 0xff);
      const int8_t g2b = (int8_t)((code >> 8) & 0xff);
      const int8_t r2b = (int8_t)((code >> 16) & 0xff);
      const uint32_t argb = row[x];
      const int8_t green = (int8_t)(argb >> 8);
      const uint32_t red = argb >> 16;
      int new_red = red & 0xff;
      int new_blue = argb & 0xff;
      new_red += ColorTransformDelta(g2r, green);
      new_red &= 0xff;
      new_blue += ColorTransformDelta(g2b, green);
      new_blue += ColorTransformDelta(r2b, (int8_t)new_red);
      new_blue &= 0xff;
      row[x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | (uint32_t)new_blue;
    }
  }
}

void AddGreen(std::vector<uint32_t>& px) {
  for (auto& argb : px) {
    const uint32_t green = (argb >> 8) & 0xff;
    uint32_t red_blue = argb & 0x00ff00ffu;
    red_blue += (green << 16) | green;
    red_blue &= 0x00ff00ffu;
    argb = (argb & 0xff00ff00u) | red_blue;
  }
}

void InverseColorIndexing(const Transform& t, const std::vector<uint32_t>& packed,
                          std::vector<uint32_t>& out, int width, int height) {
  const int bits_per_pixel = 8 >> t.bits;
  const int count_mask = (1 << t.bits) - 1;
  const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
  const int packed_w = DivRound(width, t.bits);
  out.assign((size_t)width * height, 0);
  for (int y = 0; y < height; ++y) {
    const uint32_t* src = packed.data() + (size_t)y * packed_w;
    uint32_t* dst = out.data() + (size_t)y * width;
    if (t.bits == 0) {
      for (int x = 0; x < width; ++x) dst[x] = t.data[(src[x] >> 8) & 0xff];
    } else {
      uint32_t packed_pixels = 0;
      for (int x = 0; x < width; ++x) {
        if ((x & count_mask) == 0) packed_pixels = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed_pixels & bit_mask];
        packed_pixels >>= bits_per_pixel;
      }
    }
  }
}

bool DecodeImageStream(int xsize, int ysize, bool is_level0, LBitReader& br,
                       std::vector<uint32_t>& out, int depth) {
  if (depth > 4) return false;
  int transform_xsize = xsize;
  std::vector<Transform> transforms;
  if (is_level0) {
    uint32_t seen = 0;
    while (br.read(1)) {
      Transform t;
      t.type = br.read(2);
      if (seen & (1u << t.type)) return false;
      seen |= 1u << t.type;
      t.xsize = transform_xsize;
      t.ysize = ysize;
      t.bits = 0;
      switch (t.type) {
        case 0:
        case 1:
          t.bits = br.read(3) + 2;
          if (!DecodeEntropyImage(DivRound(t.xsize, t.bits), DivRound(t.ysize, t.bits), br,
                                  t.data, depth))
            return false;
          break;
        case 3: {
          const int num_colors = br.read(8) + 1;
          const int bits = (num_colors > 16) ? 0 : (num_colors > 4) ? 1 : (num_colors > 2) ? 2 : 3;
          t.bits = bits;
          std::vector<uint32_t> pal;
          if (!DecodeEntropyImage(num_colors, 1, br, pal, depth)) return false;
          const int final_num_colors = 1 << (8 >> bits);
          t.data.assign(final_num_colors, 0);
          t.data[0] = pal[0];
          for (int i = 1; i < num_colors && i < final_num_colors; ++i)
            t.data[i] = AddPixels(pal[i], t.data[i - 1]);
          transform_xsize = DivRound(transform_xsize, bits);
          break;
        }
        case 2:
          break;
      }
      if (br.eos) return false;
      transforms.push_back(std::move(t));
    }
  }
  // color cache
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  const int cache_size = cache_bits ? (1 << cache_bits) : 0;
  // meta prefix codes
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;
  int num_groups = 1;
  if (is_level0 && br.read(1)) {
    huffman_bits = br.read(3) + 2;
    huffman_xsize = DivRound(transform_xsize, huffman_bits);
    if (!DecodeEntropyImage(huffman_xsize, DivRound(ysize, huffman_bits), br, huffman_image,
                            depth))
      return false;
    for (auto& p : huffman_image) {
      p = (p >> 8) & 0xffff;
      if ((int)p + 1 > num_groups) num_groups = p + 1;
    }
  }
  if (br.eos) return false;
  const int alphabet[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  std::vector<Huffman> groups((size_t)num_groups * 5);
  for (int g = 0; g < num_groups; ++g)
    for (int k = 0; k < 5; ++k)
      if (!ReadHuffmanCode(br, alphabet[k], groups[(size_t)g * 5 + k])) return false;

  const int width = transform_xsize;
  const size_t total = (size_t)width * ysize;
  std::vector<uint32_t> data(total, 0);
  std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
  size_t pos = 0;
  size_t cached = 0;
  auto group_at = [&](int x, int y) -> const Huffman* {
    if (huffman_image.empty()) return &groups[0];
    const uint32_t g = huffman_image[(size_t)(y >> huffman_bits) * huffman_xsize + (x >> huffman_bits)];
    return &groups[(size_t)g * 5];
  };
  while (pos < total) {
    const int x = (int)(pos % width), y = (int)(pos / width);
    const Huffman* h = group_at(x, y);
    const int code = h[0].read(br);
    if (code < 0 || br.eos) return false;
    if (code < 256) {
      const int red = h[1].read(br);
      const int blue = h[2].read(br);
      const int alpha = h[3].read(br);
      if (red < 0 || blue < 0 || alpha < 0 || br.eos) return false;
      data[pos++] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) | (uint32_t)blue;
    } else if (code < 256 + 24) {
      const int length = GetCopyDistance(code - 256, br);
      const int dist_symbol = h[4].read(br);
      if (dist_symbol < 0) return false;
      const int dist_code = GetCopyDistance(dist_symbol, br);
      const int dist = PlaneCodeToDistance(width, dist_code);
      if (br.eos) return false;
      if (pos < (size_t)dist || total - pos < (size_t)length) return false;
      for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
    } else {
      const int key = code - 256 - 24;
      if (key >= cache_size) return false;
      while (cached < pos) {
        const uint32_t argb = data[cached++];
        cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
      }
      data[pos++] = cache[key];
    }
    if (cache_size) {
      while (cached < pos) {
        const uint32_t argb = data[cached++];
        cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
      }
    }
  }
  if (br.eos) return false;
  // inverse transforms, last read first
  for (int i = (int)transforms.size() - 1; i >= 0; --i) {
    const Transform& t = transforms[i];
    switch (t.type) {
      case 0: InversePredictor(t, data, t.xsize, t.ysize); break;
      case 1: InverseCrossColor(t, data, t.xsize, t.ysize); break;
      case 2: AddGreen(data); break;
      case 3: {
        std::vector<uint32_t> expanded;
        InverseColorIndexing(t, data, expanded, t.xsize, t.ysize);
        data.swap(expanded);
        break;
      }
    }
  }
  out.swap(data);
  return true;
}

// A VP8L bitstream with its 5-byte header -> ARGB pixels.
int DecodeVP8L(const uint8_t* data, size_t size, int* w, int* h, std::vector<uint32_t>& argb) {
  if (size < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) return kOpenFail;
  LBitReader br(data, size);
  br.read(8);
  *w = br.read(14) + 1;
  *h = br.read(14) + 1;
  br.read(1);
  if (br.read(3) != 0) return kOpenFail;
  if (!DecodeImageStream(*w, *h, true, br, argb, 0)) return kDecodeFail;
  return kOk;
}

// =============================================================== ALPH

bool DecodeAlpha(const uint8_t* data, size_t size, int width, int height,
                 std::vector<uint8_t>& alpha) {
  if (size <= 1) return false;
  const int method = data[0] & 0x03;
  const int filter = (data[0] >> 2) & 0x03;
  const int pre_processing = (data[0] >> 4) & 0x03;
  const int rsrv = (data[0] >> 6) & 0x03;
  if (method > 1 || pre_processing > 1 || rsrv != 0) return false;
  const size_t n = (size_t)width * height;
  std::vector<uint8_t> deltas(n);
  if (method == 0) {
    if (size - 1 < n) return false;
    memcpy(deltas.data(), data + 1, n);
  } else {
    LBitReader br(data + 1, size - 1);
    std::vector<uint32_t> argb;
    if (!DecodeImageStream(width, height, true, br, argb, 0)) return false;
    for (size_t i = 0; i < n; ++i) deltas[i] = (uint8_t)((argb[i] >> 8) & 0xff);
  }
  alpha.assign(n, 0);
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = deltas.data() + (size_t)y * width;
    uint8_t* out = alpha.data() + (size_t)y * width;
    const uint8_t* prev = y > 0 ? out - width : nullptr;
    switch (filter) {
      case 0: memcpy(out, in, width); break;
      case 1: {
        uint8_t pred = prev == nullptr ? 0 : prev[0];
        for (int i = 0; i < width; ++i) {
          out[i] = (uint8_t)(pred + in[i]);
          pred = out[i];
        }
        break;
      }
      case 2:
        if (prev == nullptr) {
          uint8_t pred = 0;
          for (int i = 0; i < width; ++i) {
            out[i] = (uint8_t)(pred + in[i]);
            pred = out[i];
          }
        } else {
          for (int i = 0; i < width; ++i) out[i] = (uint8_t)(prev[i] + in[i]);
        }
        break;
      case 3:
        if (prev == nullptr) {
          uint8_t pred = 0;
          for (int i = 0; i < width; ++i) {
            out[i] = (uint8_t)(pred + in[i]);
            pred = out[i];
          }
        } else {
          uint8_t top = prev[0], top_left = top, left = top;
          for (int i = 0; i < width; ++i) {
            top = prev[i];
            const int g = left + top - top_left;
            const int pred = ((g & ~0xff) == 0) ? g : (g < 0) ? 0 : 255;
            left = (uint8_t)(in[i] + pred);
            top_left = top;
            out[i] = left;
          }
        }
        break;
    }
  }
  return true;
}

// ========================================================== container

struct Frame {
  int x = 0, y = 0, w = 0, h = 0;
  const uint8_t* alph = nullptr;
  size_t alph_size = 0;
  const uint8_t* bits = nullptr;  // VP8 / VP8L payload
  size_t bits_size = 0;
  int lossless = 0;
};

struct Parsed {
  int canvas_w = 0, canvas_h = 0, has_alpha = 0;
  Frame frame;
};

// VP8 / VP8L payload -> its size and (VP8L) alpha bit; false when the
// header is not valid (WebPGetInfo's checks)
bool BitstreamInfo(const uint8_t* p, size_t n, int lossless, int* w, int* h, int* alpha) {
  if (lossless) {
    if (n < 5 || p[0] != 0x2f || (p[4] >> 5) != 0) return false;
    const uint32_t bits = le32(p + 1);
    *w = (bits & 0x3fff) + 1;
    *h = ((bits >> 14) & 0x3fff) + 1;
    *alpha = (bits >> 28) & 1;
    return true;
  }
  if (n < 10) return false;
  const uint32_t bits = le24(p);
  if (bits & 1) return false;
  if (((bits >> 1) & 7) > 3) return false;
  if (!((bits >> 4) & 1)) return false;
  if ((bits >> 5) >= n) return false;
  if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a) return false;
  *w = le16(p + 6) & 0x3fff;
  *h = le16(p + 8) & 0x3fff;
  *alpha = 0;
  return *w != 0 && *h != 0;
}

// The RIFF container as WebPDemux (whole data, no partial files) and
// WebPGetFeatures read it: the canvas, the alpha flag PIL's mode
// follows, and the first frame.
int ParseContainer(const uint8_t* data, size_t size, Parsed& out) {
  if (size < 12 || memcmp(data, "RIFF", 4) || memcmp(data + 8, "WEBP", 4)) return kOpenFail;
  const uint32_t riff_size = le32(data + 4);
  if (riff_size < 12 || riff_size > 0xfffffff6u) return kOpenFail;
  if ((size_t)riff_size + 8 > size) return kOpenFail;  // partial data
  const size_t end = (size_t)riff_size + 8;
  size_t pos = 12;
  auto chunk = [&](size_t at, char* tag, size_t* payload, size_t* psize) -> bool {
    if (at + 8 > end) return false;
    memcpy(tag, data + at, 4);
    const uint32_t sz = le32(data + at + 4);
    if (sz > 0xfffffff6u) return false;
    if (at + 8 + (size_t)sz + (sz & 1) > end) return false;  // padded
    *payload = at + 8;
    *psize = sz;
    return true;
  };
  char tag[4];
  size_t pl, ps;
  if (!chunk(pos, tag, &pl, &ps)) return kOpenFail;
  if (!memcmp(tag, "VP8 ", 4) || !memcmp(tag, "VP8L", 4)) {
    Frame& f = out.frame;
    f.lossless = !memcmp(tag, "VP8L", 4);
    f.bits = data + pl;
    // the decoder gets the chunk's padding byte too (WebPDemux's
    // fragment), as the last bits of the stream
    f.bits_size = ps + (ps & 1);
    int a;
    if (!BitstreamInfo(f.bits, f.bits_size, f.lossless, &f.w, &f.h, &a)) return kOpenFail;
    out.canvas_w = f.w;
    out.canvas_h = f.h;
    out.has_alpha = f.lossless ? a : 0;
    // WebPDemux reads the header of a chunk after the image: it must fit
    const size_t next = pl + ps + (ps & 1);
    if (next != end) {
      if (end - next < 8) return kOpenFail;
      const uint32_t s2 = le32(data + next + 4);
      if (s2 > 0xfffffff6u || next + 8 + (size_t)s2 + (s2 & 1) > end) return kOpenFail;
    }
    return kOk;
  }
  if (memcmp(tag, "VP8X", 4) || ps < 10) return kOpenFail;
  const uint32_t flags = data[pl];
  const int canvas_w = (int)le24(data + pl + 4) + 1;
  const int canvas_h = (int)le24(data + pl + 7) + 1;
  if ((uint64_t)canvas_w * canvas_h >= (1ull << 32)) return kOpenFail;
  if (flags & ~0x3eu) return kOpenFail;  // unknown feature flags
  const int animation = !!(flags & 0x02);
  bool anim_seen = false;
  out.canvas_w = canvas_w;
  out.canvas_h = canvas_h;
  out.has_alpha = !!(flags & 0x10);
  pos = pl + ps + (ps & 1);
  bool found = false;
  while (pos < end) {
    if (!chunk(pos, tag, &pl, &ps)) return kOpenFail;
    const size_t next = pl + ps + (ps & 1);
    if (!memcmp(tag, "ANIM", 4)) {
      anim_seen = true;
    } else if (!memcmp(tag, "ANMF", 4)) {
      if (!animation || !anim_seen || ps < 16) return kOpenFail;
      // WebPDemux checks every frame; the first is the one decoded
      Frame other;
      {
        Frame& f = found ? other : out.frame;
        f.x = 2 * (int)le24(data + pl);
        f.y = 2 * (int)le24(data + pl + 3);
        f.w = (int)le24(data + pl + 6) + 1;
        f.h = (int)le24(data + pl + 9) + 1;
        size_t sub = pl + 16;
        const size_t sub_end = pl + ps;
        bool got = false;
        while (sub + 8 <= sub_end) {
          char t2[4];
          memcpy(t2, data + sub, 4);
          const uint32_t s2 = le32(data + sub + 4);
          if (sub + 8 + (size_t)s2 > sub_end) return kOpenFail;
          if (!memcmp(t2, "ALPH", 4)) {
            if (!f.alph) {
              f.alph = data + sub + 8;
              f.alph_size = s2;
            }
          } else if (!memcmp(t2, "VP8 ", 4) || !memcmp(t2, "VP8L", 4)) {
            f.lossless = !memcmp(t2, "VP8L", 4);
            f.bits = data + sub + 8;
            f.bits_size = s2 + (s2 & 1);
            if (sub + 8 + f.bits_size > sub_end) f.bits_size = s2;
            got = true;
            break;
          }
          sub += 8 + s2 + (s2 & 1);
        }
        if (!got) return kOpenFail;
        // the demuxer checks the ANMF size's area, then takes the
        // bitstream's size for the frame
        if ((uint64_t)f.w * f.h >= (1ull << 32)) return kOpenFail;
        int a;
        if (!BitstreamInfo(f.bits, f.bits_size, f.lossless, &f.w, &f.h, &a)) return kOpenFail;
        if (f.lossless) f.alph = nullptr;
        if (f.x + f.w > canvas_w || f.y + f.h > canvas_h) return kOpenFail;
        found = true;
      }
    } else if (!memcmp(tag, "ALPH", 4)) {
      if (!animation && !found && !out.frame.alph) {
        out.frame.alph = data + pl;
        out.frame.alph_size = ps;
      }
    } else if (!memcmp(tag, "VP8 ", 4) || !memcmp(tag, "VP8L", 4)) {
      if (animation) return kOpenFail;
      if (found) return kOpenFail;  // a still image has one frame
      Frame& f = out.frame;
      f.lossless = !memcmp(tag, "VP8L", 4);
      f.bits = data + pl;
      f.bits_size = ps + (ps & 1);
      int a;
      if (!BitstreamInfo(f.bits, f.bits_size, f.lossless, &f.w, &f.h, &a)) return kOpenFail;
      if (f.w != canvas_w || f.h != canvas_h) return kOpenFail;
      if (f.lossless) {
        f.alph = nullptr;
        out.has_alpha = a;
      } else if (f.alph) {
        out.has_alpha = 1;
      }
      found = true;
    }
    pos = next;
  }
  if (!found) return kOpenFail;
  return kOk;
}

// One frame decoded as WebPDecode does in MODE_RGBA, into an RGBA
// buffer of ``stride`` bytes a row.
int DecodeFrame(const Frame& f, uint8_t* dst, size_t stride) {
  if (f.lossless) {
    int w, h;
    std::vector<uint32_t> argb;
    const int rc = DecodeVP8L(f.bits, f.bits_size, &w, &h, argb);
    if (rc != kOk) return kDecodeFail;
    for (int y = 0; y < h; ++y) {
      uint8_t* row = dst + (size_t)y * stride;
      for (int x = 0; x < w; ++x) {
        const uint32_t p = argb[(size_t)y * w + x];
        row[4 * x + 0] = (uint8_t)(p >> 16);
        row[4 * x + 1] = (uint8_t)(p >> 8);
        row[4 * x + 2] = (uint8_t)p;
        row[4 * x + 3] = (uint8_t)(p >> 24);
      }
    }
    return kOk;
  }
  VP8Frame vf;
  const int rc = DecodeVP8(f.bits, f.bits_size, vf);
  if (rc != kOk) return kDecodeFail;
  EmitFancyRgba(vf, dst, stride);
  if (f.alph) {
    std::vector<uint8_t> alpha;
    if (!DecodeAlpha(f.alph, f.alph_size, vf.width, vf.height, alpha)) return kDecodeFail;
    for (int y = 0; y < vf.height; ++y)
      for (int x = 0; x < vf.width; ++x)
        dst[(size_t)y * stride + 4 * x + 3] = alpha[(size_t)y * vf.width + x];
  }
  return kOk;
}

}  // namespace

extern "C" {

// info: canvas width, height, has_alpha. 0, or 1 when PIL's WebP
// decoder would not open the data.
int fc_webp_info(const uint8_t* data, size_t size, int32_t* info) {
  Parsed p;
  const int rc = ParseContainer(data, size, p);
  if (rc != kOk) return rc;
  info[0] = p.canvas_w;
  info[1] = p.canvas_h;
  info[2] = p.has_alpha;
  return kOk;
}

// The first frame on its canvas (transparent black around it), RGBA,
// canvas width x height x 4 bytes. 0, 1 (does not open) or 2 (does not
// decode).
int fc_webp_decode(const uint8_t* data, size_t size, uint8_t* rgba, int32_t width,
                   int32_t height) {
  Parsed p;
  int rc = ParseContainer(data, size, p);
  if (rc != kOk) return rc;
  if (p.canvas_w != width || p.canvas_h != height) return kOpenFail;
  const size_t stride = (size_t)width * 4;
  memset(rgba, 0, stride * height);
  const Frame& f = p.frame;
  return DecodeFrame(f, rgba + (size_t)f.y * stride + (size_t)f.x * 4, stride);
}

}  // extern "C"
