// WebP image data -> RGBA on the host, as libwebp decodes it for PIL
// (WebPAnimDecoder, MODE_RGBA: straight alpha, fancy upsampling).
//
// Plain C ABI, loaded with ctypes (utils/webp.py), which parses the RIFF
// container and places a frame on its canvas:
//
//   int crdr_webp_vp8(data, n, width, height, out, err, errlen)
//     data / n: a "VP8 " chunk's payload (a key frame);
//     out: a width * height * 4 RGBA buffer the caller owns (alpha 255).
//   int crdr_webp_vp8l(data, n, width, height, headerless, out, err, errlen)
//     data / n: a "VP8L" chunk's payload, or with headerless set the bare
//     image stream of an ALPH chunk; out as above.
//   int crdr_webp_alpha(data, n, width, height, out, err, errlen)
//     data / n: an "ALPH" chunk's payload; out: width * height alpha bytes.
//     -> 0, or -1 with the reason in err.
//
// VP8 (RFC 6386): the boolean decoder, segments, token probabilities, the
// intra predictors (16x16, 4x4, chroma) with libwebp's frame edges (127
// above, 129 to the left), the inverse DCT and WHT, the simple and normal
// loop filters, then libwebp's "fancy" chroma upsampling (the 9-3-3-1
// filter over row pairs) and its fixed-point YUV -> RGB.  VP8L: prefix
// codes with meta codes, the colour cache, LZ77 with the 120-code distance
// map, and the four transforms.  ALPH: raw or VP8L-coded, with the
// horizontal, vertical and gradient filters.  The probability and
// quantizer tables are RFC 6386's; the code is written from the format
// specifications, standard headers only.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

[[noreturn]] void fail(const std::string& why) {
  throw std::runtime_error(why);
}

// ---------------------------------------------------------------------------
// RFC 6386's tables
// ---------------------------------------------------------------------------

const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
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
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
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
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};
const uint8_t kBModesProba[10 * 10 * 9] = {
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
    112, 19, 12, 61, 195, 128, 48, 4, 24};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57,
    21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74,
    36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30, 102, 106, 34, 46,
    84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114,
    126, 97, 111, 80, 113, 127, 96, 112};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// the 4x4 intra mode tree (leaves are -mode)
const int8_t kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5,
                                  -4, -5, -6, 7, -7, 8, -8, -9};

enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
       DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// ---------------------------------------------------------------------------
// the boolean decoder (RFC 6386 section 7)
// ---------------------------------------------------------------------------

struct BoolDecoder {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint32_t value = 0, range = 255;
  int bit_count = 0;
  size_t past = 0;  // bytes read past the end (zeros)

  void init(const uint8_t* data, size_t len) {
    d = data;
    n = len;
    pos = 0;
    value = (uint32_t)(next() << 8);
    value |= next();
    range = 255;
    bit_count = 0;
  }
  int next() {
    if (pos < n) return d[pos++];
    past++;
    return 0;
  }
  int get(int prob) {
    uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    uint32_t big = split << 8;
    int bit;
    if (value >= big) {
      range -= split;
      value -= big;
      bit = 1;
    } else {
      range = split;
      bit = 0;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= (uint32_t)next();
      }
    }
    return bit;
  }
  int literal(int bits) {
    int v = 0;
    while (bits-- > 0) v = (v << 1) | get(128);
    return v;
  }
  int signed_value(int bits) {
    int v = literal(bits);
    return get(128) ? -v : v;
  }
  int optional_signed(int bits) { return get(128) ? signed_value(bits) : 0; }
};

// ---------------------------------------------------------------------------
// VP8 key frames
// ---------------------------------------------------------------------------

struct FilterInfo {
  int limit = 0, ilevel = 0, hev = 0, inner = 0;
};

struct MacroBlock {
  int segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
  uint8_t imodes[16];
  int16_t coeffs[384];
  bool nonzero_y[16], nonzero_uv[8];
  bool coded = false;  // any non-zero coefficient (the filter's inner edges)
};

struct Vp8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment and filter headers
  bool use_segment = false, update_map = false, absolute_delta = false;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segment_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  // quantizers: y1 dc / ac, y2 dc / ac, uv dc / ac per segment
  int dq[4][6];
  uint8_t coef_probs[4][8][3][11];
  bool use_skip = false;
  int skip_prob = 0;
  BoolDecoder br;
  std::vector<BoolDecoder> parts;
  std::vector<MacroBlock> mbs;
  FilterInfo fstrength[4][2];
  // reconstruction planes, whole macroblocks
  int ys = 0, uvs = 0;
  std::vector<uint8_t> Y, U, V;
};

void parse_header(Vp8& v, const uint8_t* d, size_t n) {
  if (n < 10) fail("truncated VP8 frame header");
  uint32_t bits = d[0] | (d[1] << 8) | (d[2] << 16);
  int key_frame = !(bits & 1);
  int profile = (bits >> 1) & 7;
  int show = (bits >> 4) & 1;
  uint32_t part0 = bits >> 5;
  if (!key_frame) fail("a VP8 inter frame (not a key frame)");
  if (profile > 3) fail("unknown VP8 profile " + std::to_string(profile));
  if (!show) fail("a VP8 frame that is not shown");
  if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a)
    fail("bad VP8 start code");
  v.width = (d[6] | (d[7] << 8)) & 0x3fff;
  v.height = (d[8] | (d[9] << 8)) & 0x3fff;
  if (v.width == 0 || v.height == 0) fail("a VP8 frame of zero size");
  v.mb_w = (v.width + 15) >> 4;
  v.mb_h = (v.height + 15) >> 4;
  d += 10;
  n -= 10;
  if (part0 > n) fail("truncated VP8 data (the first partition)");
  BoolDecoder& br = v.br;
  br.init(d, part0);
  br.get(128);  // colour space
  br.get(128);  // clamping type: libwebp always clamps
  v.use_segment = br.get(128);
  if (v.use_segment) {
    v.update_map = br.get(128);
    if (br.get(128)) {  // update data
      v.absolute_delta = br.get(128);
      for (int s = 0; s < 4; s++) v.quantizer[s] = br.optional_signed(7);
      for (int s = 0; s < 4; s++) v.filter_strength[s] = br.optional_signed(6);
    }
    if (v.update_map)
      for (int s = 0; s < 3; s++)
        v.segment_probs[s] = br.get(128) ? br.literal(8) : 255;
  }
  v.simple = br.get(128);
  v.level = br.literal(6);
  v.sharpness = br.literal(3);
  v.use_lf_delta = br.get(128);
  if (v.use_lf_delta && br.get(128)) {
    for (int i = 0; i < 4; i++)
      if (br.get(128)) v.ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; i++)
      if (br.get(128)) v.mode_lf_delta[i] = br.signed_value(6);
  }
  v.filter_type = v.level == 0 ? 0 : v.simple ? 1 : 2;
  // token partitions
  int nparts = 1 << br.literal(2);
  const uint8_t* sz = d + part0;
  size_t left = n - part0;
  if (left < 3 * (size_t)(nparts - 1))
    fail("truncated VP8 data (the partition sizes)");
  const uint8_t* start = sz + 3 * (nparts - 1);
  left -= 3 * (nparts - 1);
  v.parts.resize(nparts);
  for (int p = 0; p < nparts - 1; p++) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    v.parts[p].init(start, psize);
    start += psize;
    left -= psize;
    sz += 3;
  }
  v.parts[nparts - 1].init(start, left);
  // quantizers
  int base_q0 = br.literal(7);
  int dqy1_dc = br.optional_signed(4), dqy2_dc = br.optional_signed(4);
  int dqy2_ac = br.optional_signed(4), dquv_dc = br.optional_signed(4);
  int dquv_ac = br.optional_signed(4);
  auto clip = [](int q, int m) { return q < 0 ? 0 : q > m ? m : q; };
  for (int s = 0; s < 4; s++) {
    int q = base_q0;
    if (v.use_segment) {
      q = v.quantizer[s] + (v.absolute_delta ? 0 : base_q0);
    } else if (s > 0) {
      std::memcpy(v.dq[s], v.dq[0], sizeof(v.dq[0]));
      continue;
    }
    int* m = v.dq[s];
    m[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m[1] = kAcTable[clip(q, 127)];
    m[2] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m[3] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m[3] < 8) m[3] = 8;
    m[4] = kDcTable[clip(q + dquv_dc, 117)];
    m[5] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.get(128);  // refresh entropy probabilities (a key frame's own)
  for (int t = 0; t < 4; t++)
    for (int b = 0; b < 8; b++)
      for (int c = 0; c < 3; c++)
        for (int p = 0; p < 11; p++) {
          int i = ((t * 8 + b) * 3 + c) * 11 + p;
          v.coef_probs[t][b][c][p] =
              br.get(kCoeffsUpdateProba[i]) ? br.literal(8) : kCoeffsProba0[i];
        }
  v.use_skip = br.get(128);
  if (v.use_skip) v.skip_prob = br.literal(8);
}

void parse_modes(Vp8& v, MacroBlock& mb, uint8_t* top, uint8_t* left) {
  BoolDecoder& br = v.br;
  if (v.update_map)
    mb.segment = !br.get(v.segment_probs[0]) ? br.get(v.segment_probs[1])
                                             : 2 + br.get(v.segment_probs[2]);
  else
    mb.segment = 0;
  mb.skip = v.use_skip ? br.get(v.skip_prob) : 0;
  mb.is_i4x4 = !br.get(145);
  if (!mb.is_i4x4) {
    int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE)
                            : (br.get(163) ? B_VE : B_DC);
    mb.imodes[0] = (uint8_t)ymode;
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = mb.imodes;
    for (int y = 0; y < 4; y++) {
      int ymode = left[y];
      for (int x = 0; x < 4; x++) {
        const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
        int i = kYModesIntra4[br.get(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
        ymode = -i;
        top[x] = (uint8_t)ymode;
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  mb.uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE
                                  : br.get(183) ? B_TM : B_HE;
}

int large_value(BoolDecoder& br, const uint8_t* p) {
  int v;
  if (!br.get(p[3])) {
    v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
  } else if (!br.get(p[6])) {
    if (!br.get(p[7])) {
      v = 5 + br.get(159);
    } else {
      v = 7 + 2 * br.get(165);
      v += br.get(145);
    }
  } else {
    int bit1 = br.get(p[8]);
    int bit0 = br.get(p[9 + bit1]);
    int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// one block's tokens from position n; returns libwebp's "nz" (the index
// past the last token read)
int get_coeffs(BoolDecoder& br, const uint8_t (*bands)[3][11], int ctx,
               int dc_q, int ac_q, int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = bands[kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = bands[kBands[n + 1]][2];
    }
    int sv = br.get(128) ? -v : v;
    out[kZigzag[n]] = (int16_t)(sv * (n > 0 ? ac_q : dc_q));
  }
  return 16;
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[0 + i * 4] + 3;
    int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// ParseResiduals: tokens of one macroblock, with the non-zero contexts
// tnz (this column's, 4 y + 2 u + 2 v + dc) and lnz (the row's)
void parse_residuals(Vp8& v, MacroBlock& mb, BoolDecoder& br, uint8_t* tnz,
                     uint8_t* lnz) {
  const int* q = v.dq[mb.segment];
  int16_t* dst = mb.coeffs;
  std::memset(dst, 0, sizeof(mb.coeffs));
  int first;
  const uint8_t(*ac)[3][11];
  if (!mb.is_i4x4) {
    int16_t dc[16] = {0};
    int ctx = tnz[8] + lnz[8];
    int nz = get_coeffs(br, v.coef_probs[1], ctx, q[2], q[3], 0, dc);
    tnz[8] = lnz[8] = nz > 0;
    transform_wht(dc, dst);
    first = 1;
    ac = v.coef_probs[0];
  } else {
    first = 0;
    ac = v.coef_probs[3];
  }
  bool any = false;
  for (int y = 0; y < 4; y++)
    for (int x = 0; x < 4; x++) {
      int16_t* blk = dst + (y * 4 + x) * 16;
      int ctx = lnz[y] + tnz[x];
      int nz = get_coeffs(br, ac, ctx, q[0], q[1], first, blk);
      lnz[y] = tnz[x] = nz > first;
      bool nonzero = nz > 1 || blk[0] != 0;
      mb.nonzero_y[y * 4 + x] = nonzero;
      any |= nonzero;
    }
  for (int ch = 0; ch < 2; ch++)
    for (int y = 0; y < 2; y++)
      for (int x = 0; x < 2; x++) {
        int16_t* blk = dst + (16 + ch * 4 + y * 2 + x) * 16;
        int ctx = lnz[4 + ch * 2 + y] + tnz[4 + ch * 2 + x];
        int nz = get_coeffs(br, v.coef_probs[2], ctx, q[4], q[5], 0, blk);
        lnz[4 + ch * 2 + y] = tnz[4 + ch * 2 + x] = nz > 0;
        bool nonzero = nz > 1 || blk[0] != 0;
        mb.nonzero_uv[ch * 4 + y * 2 + x] = nonzero;
        any |= nonzero;
      }
  mb.coded = any;
}

// --- reconstruction ---------------------------------------------------------

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_add(const int16_t* in, uint8_t* dst, int bps) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {
    int a = in[0] + in[8], b = in[0] - in[8];
    int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[0] + 4;
    int a = dc + tmp[8], b = dc - tmp[8];
    int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    int vals[4] = {a + d, b + c, b - c, a - d};
    for (int x = 0; x < 4; x++) dst[x] = (uint8_t)clip255(dst[x] + (vals[x] >> 3));
    tmp++;
    dst += bps;
  }
}

inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int bps, int size) {
  const uint8_t* top = dst - bps;
  int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) dst[x] = (uint8_t)clip255(top[x] + dst[-1] - tl);
    dst += bps;
  }
}

void predict_square(uint8_t* dst, int bps, int size, int mode) {
  int shift = size == 16 ? 5 : 4;
  switch (mode) {
    case B_DC: case DC_NOTOP: case DC_NOLEFT: case DC_NOTOPLEFT: {
      int dc = 0x80;
      if (mode == B_DC) {
        int s = 0;
        for (int i = 0; i < size; i++) s += dst[i - bps] + dst[i * bps - 1];
        dc = (s + size) >> shift;
      } else if (mode == DC_NOTOP || mode == DC_NOLEFT) {
        int s = 0;
        for (int i = 0; i < size; i++)
          s += mode == DC_NOTOP ? dst[i * bps - 1] : dst[i - bps];
        dc = (s + (size >> 1)) >> (shift - 1);
      }
      for (int y = 0; y < size; y++) std::memset(dst + y * bps, dc, size);
      break;
    }
    case B_TM: true_motion(dst, bps, size); break;
    case B_VE:
      for (int y = 0; y < size; y++) std::memcpy(dst + y * bps, dst - bps, size);
      break;
    case B_HE:
      for (int y = 0; y < size; y++) std::memset(dst + y * bps, dst[y * bps - 1], size);
      break;
    default: fail("bad VP8 prediction mode");
  }
}

void predict4(uint8_t* dst, int bps, int mode) {
#define DST(x, y) dst[(x) + (y) * bps]
  const uint8_t* top = dst - bps;
  int I = dst[-1], J = dst[-1 + bps], K = dst[-1 + 2 * bps], L = dst[-1 + 3 * bps];
  int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; i++) dc += top[i] + dst[-1 + i * bps];
      dc >>= 3;
      for (int i = 0; i < 4; i++) std::memset(dst + i * bps, dc, 4);
      break;
    }
    case B_TM: true_motion(dst, bps, 4); break;
    case B_VE: {
      uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; i++) std::memcpy(dst + i * bps, vals, 4);
      break;
    }
    case B_HE: {
      int rows[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int i = 0; i < 4; i++) std::memset(dst + i * bps, rows[i], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default: fail("bad VP8 4x4 prediction mode");
  }
#undef DST
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : B_DC;
  }
  return mode;
}

// One macroblock into a work area of libwebp's layout (BPS 32: a row of
// context above, a column to the left), then into the planes.
constexpr int BPS = 32;

struct Work {
  uint8_t buf[BPS * 17 + BPS * 9 * 2 + 64];
  uint8_t* y() { return buf + BPS + 8; }
  uint8_t* u() { return buf + BPS * 18 + 8; }
  uint8_t* v() { return buf + BPS * 18 + 8 + 16; }
};

void reconstruct(Vp8& v) {
  std::vector<uint8_t> top_y(v.mb_w * 16), top_u(v.mb_w * 8), top_v(v.mb_w * 8);
  Work w;
  uint8_t* yd = w.y();
  uint8_t* ud = w.u();
  uint8_t* vd = w.v();
  for (int mb_y = 0; mb_y < v.mb_h; mb_y++) {
    for (int j = 0; j < 16; j++) yd[j * BPS - 1] = 129;
    for (int j = 0; j < 8; j++) ud[j * BPS - 1] = vd[j * BPS - 1] = 129;
    if (mb_y > 0) {
      yd[-1 - BPS] = ud[-1 - BPS] = vd[-1 - BPS] = 129;
    } else {
      std::memset(yd - BPS - 1, 127, 16 + 4 + 1);
      std::memset(ud - BPS - 1, 127, 8 + 1);
      std::memset(vd - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < v.mb_w; mb_x++) {
      MacroBlock& mb = v.mbs[mb_y * v.mb_w + mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; j++) std::memcpy(yd + j * BPS - 4, yd + j * BPS + 12, 4);
        for (int j = -1; j < 8; j++) {
          std::memcpy(ud + j * BPS - 4, ud + j * BPS + 4, 4);
          std::memcpy(vd + j * BPS - 4, vd + j * BPS + 4, 4);
        }
      }
      if (mb_y > 0) {
        std::memcpy(yd - BPS, &top_y[mb_x * 16], 16);
        std::memcpy(ud - BPS, &top_u[mb_x * 8], 8);
        std::memcpy(vd - BPS, &top_v[mb_x * 8], 8);
      }
      if (mb.is_i4x4) {
        uint8_t* top_right = yd - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= v.mb_w - 1)
            std::memset(top_right, top_y[mb_x * 16 + 15], 4);
          else
            std::memcpy(top_right, &top_y[(mb_x + 1) * 16], 4);
        }
        for (int r = 1; r < 4; r++) std::memcpy(top_right + r * 4 * BPS, top_right, 4);
        for (int n = 0; n < 16; n++) {
          uint8_t* dst = yd + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, BPS, mb.imodes[n]);
          if (mb.nonzero_y[n]) transform_add(mb.coeffs + n * 16, dst, BPS);
        }
      } else {
        predict_square(yd, BPS, 16, check_mode(mb_x, mb_y, mb.imodes[0]));
        for (int n = 0; n < 16; n++)
          if (mb.nonzero_y[n])
            transform_add(mb.coeffs + n * 16, yd + (n & 3) * 4 + (n >> 2) * 4 * BPS, BPS);
      }
      int uvmode = check_mode(mb_x, mb_y, mb.uvmode);
      predict_square(ud, BPS, 8, uvmode);
      predict_square(vd, BPS, 8, uvmode);
      for (int ch = 0; ch < 2; ch++)
        for (int n = 0; n < 4; n++)
          if (mb.nonzero_uv[ch * 4 + n])
            transform_add(mb.coeffs + (16 + ch * 4 + n) * 16,
                          (ch ? vd : ud) + (n & 1) * 4 + (n >> 1) * 4 * BPS, BPS);
      if (mb_y < v.mb_h - 1) {
        std::memcpy(&top_y[mb_x * 16], yd + 15 * BPS, 16);
        std::memcpy(&top_u[mb_x * 8], ud + 7 * BPS, 8);
        std::memcpy(&top_v[mb_x * 8], vd + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; j++)
        std::memcpy(&v.Y[(mb_y * 16 + j) * v.ys + mb_x * 16], yd + j * BPS, 16);
      for (int j = 0; j < 8; j++) {
        std::memcpy(&v.U[(mb_y * 8 + j) * v.uvs + mb_x * 8], ud + j * BPS, 8);
        std::memcpy(&v.V[(mb_y * 8 + j) * v.uvs + mb_x * 8], vd + j * BPS, 8);
      }
    }
  }
}

// --- the loop filter ----------------------------------------------------------

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = (uint8_t)clip255(p0 + a2);
  p[0] = (uint8_t)clip255(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0);
  int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  int a3 = (a1 + 1) >> 1;
  p[-2 * step] = (uint8_t)clip255(p1 + a3);
  p[-step] = (uint8_t)clip255(p0 + a2);
  p[0] = (uint8_t)clip255(q0 - a1);
  p[step] = (uint8_t)clip255(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = (uint8_t)clip255(p2 + a3);
  p[-2 * step] = (uint8_t)clip255(p1 + a2);
  p[-step] = (uint8_t)clip255(p0 + a1);
  p[0] = (uint8_t)clip255(q0 - a1);
  p[step] = (uint8_t)clip255(q1 - a2);
  p[2 * step] = (uint8_t)clip255(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int t) {
  return std::abs(p[-2 * step] - p[-step]) > t || std::abs(p[step] - p[0]) > t;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// hstride: across the edge; vstride: along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; i++, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_t, bool mb_edge) {
  int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; i++, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t))
      filter2(p, hstride);
    else if (mb_edge)
      filter6(p, hstride);
    else
      filter4(p, hstride);
  }
}

void loop_filter(Vp8& v) {
  if (v.filter_type == 0) return;
  for (int s = 0; s < 4; s++) {
    int base = v.level;
    if (v.use_segment) {
      base = v.filter_strength[s];
      if (!v.absolute_delta) base += v.level;
    }
    for (int i4 = 0; i4 <= 1; i4++) {
      FilterInfo& f = v.fstrength[s][i4];
      int level = base;
      if (v.use_lf_delta) {
        level += v.ref_lf_delta[0];
        if (i4) level += v.mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int il = level;
        if (v.sharpness > 0) {
          il >>= v.sharpness > 4 ? 2 : 1;
          if (il > 9 - v.sharpness) il = 9 - v.sharpness;
        }
        if (il < 1) il = 1;
        f.ilevel = il;
        f.limit = 2 * level + il;
        f.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        f.limit = 0;
      }
      f.inner = i4;
    }
  }
  for (int mb_y = 0; mb_y < v.mb_h; mb_y++)
    for (int mb_x = 0; mb_x < v.mb_w; mb_x++) {
      const MacroBlock& mb = v.mbs[mb_y * v.mb_w + mb_x];
      FilterInfo f = v.fstrength[mb.segment][mb.is_i4x4];
      f.inner |= mb.coded;
      int limit = f.limit;
      if (limit == 0) continue;
      uint8_t* y = &v.Y[mb_y * 16 * v.ys + mb_x * 16];
      int ys = v.ys;
      if (v.filter_type == 1) {
        if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
        if (f.inner)
          for (int k = 1; k < 4; k++) simple_edge(y + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
        if (f.inner)
          for (int k = 1; k < 4; k++) simple_edge(y + 4 * k * ys, ys, 1, limit);
      } else {
        int uvs = v.uvs, il = f.ilevel, ht = f.hev;
        uint8_t* u = &v.U[mb_y * 8 * uvs + mb_x * 8];
        uint8_t* vv = &v.V[mb_y * 8 * uvs + mb_x * 8];
        if (mb_x > 0) {
          normal_edge(y, 1, ys, 16, limit + 4, il, ht, true);
          normal_edge(u, 1, uvs, 8, limit + 4, il, ht, true);
          normal_edge(vv, 1, uvs, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 1; k < 4; k++) normal_edge(y + 4 * k, 1, ys, 16, limit, il, ht, false);
          normal_edge(u + 4, 1, uvs, 8, limit, il, ht, false);
          normal_edge(vv + 4, 1, uvs, 8, limit, il, ht, false);
        }
        if (mb_y > 0) {
          normal_edge(y, ys, 1, 16, limit + 4, il, ht, true);
          normal_edge(u, uvs, 1, 8, limit + 4, il, ht, true);
          normal_edge(vv, uvs, 1, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 1; k < 4; k++) normal_edge(y + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
          normal_edge(u + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
          normal_edge(vv + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
        }
      }
    }
}

// --- YUV -> RGB (libwebp's fancy upsampler and its fixed-point rows) ----------

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int clip8(int v) { return (v & ~16383) == 0 ? (v >> 6) : v < 0 ? 0 : 255; }

inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = (uint8_t)clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = (uint8_t)clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgba[2] = (uint8_t)clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  rgba[3] = 255;
}

// the chroma of one row of output (len pixels) from the chroma rows near
// (weight 3) and far (weight 1), as libwebp's UpsampleRgbaLinePair gives
// the top (near = top_u) or bottom (near = cur_u) row of a pair
void upsample_row(const uint8_t* y, const uint8_t* near_u, const uint8_t* near_v,
                  const uint8_t* far_u, const uint8_t* far_v, int len,
                  uint8_t* dst) {
  int last_pair = (len - 1) >> 1;
  int nu = near_u[0], nv = near_v[0], fu = far_u[0], fv = far_v[0];
  yuv_to_rgba(y[0], (3 * nu + fu + 2) >> 2, (3 * nv + fv + 2) >> 2, dst);
  for (int x = 1; x <= last_pair; ++x) {
    int nu1 = near_u[x], nv1 = near_v[x], fu1 = far_u[x], fv1 = far_v[x];
    // libwebp names, for the top row: tl = near[x-1], t = near[x],
    // l = far[x-1], uv = far[x]
    int au = nu + nu1 + fu + fu1 + 8, av = nv + nv1 + fv + fv1 + 8;
    int d12u = (au + 2 * (nu1 + fu)) >> 3, d03u = (au + 2 * (nu + fu1)) >> 3;
    int d12v = (av + 2 * (nv1 + fv)) >> 3, d03v = (av + 2 * (nv + fv1)) >> 3;
    yuv_to_rgba(y[2 * x - 1], (d12u + nu) >> 1, (d12v + nv) >> 1, dst + (2 * x - 1) * 4);
    yuv_to_rgba(y[2 * x], (d03u + nu1) >> 1, (d03v + nv1) >> 1, dst + 2 * x * 4);
    nu = nu1; nv = nv1; fu = fu1; fv = fv1;
  }
  if (!(len & 1))
    yuv_to_rgba(y[len - 1], (3 * nu + fu + 2) >> 2, (3 * nv + fv + 2) >> 2, dst + (len - 1) * 4);
}

void emit_rgba(const Vp8& v, uint8_t* out) {
  int w = v.width, h = v.height;
  const uint8_t* Y = v.Y.data();
  const uint8_t* U = v.U.data();
  const uint8_t* V = v.V.data();
  auto yrow = [&](int r) { return Y + (size_t)r * v.ys; };
  auto urow = [&](int r) { return U + (size_t)r * v.uvs; };
  auto vrow = [&](int r) { return V + (size_t)r * v.uvs; };
  for (int r = 0; r < h; r++) {
    uint8_t* dst = out + (size_t)r * w * 4;
    if (r == 0 || (r == h - 1 && !(h & 1))) {
      int c = r == 0 ? 0 : (h >> 1) - 1;
      upsample_row(yrow(r), urow(c), vrow(c), urow(c), vrow(c), w, dst);
    } else if (r & 1) {  // the top row of a pair: near (r - 1) / 2
      int k = (r + 1) >> 1;
      upsample_row(yrow(r), urow(k - 1), vrow(k - 1), urow(k), vrow(k), w, dst);
    } else {
      int k = r >> 1;
      upsample_row(yrow(r), urow(k), vrow(k), urow(k - 1), vrow(k - 1), w, dst);
    }
  }
}

void decode_vp8(const uint8_t* d, size_t n, int width, int height, uint8_t* out) {
  Vp8 v;
  parse_header(v, d, n);
  if (v.width != width || v.height != height)
    fail("VP8 frame of " + std::to_string(v.width) + "x" + std::to_string(v.height) +
         " in a " + std::to_string(width) + "x" + std::to_string(height) + " image");
  v.ys = v.mb_w * 16;
  v.uvs = v.mb_w * 8;
  v.Y.assign((size_t)v.ys * v.mb_h * 16, 0);
  v.U.assign((size_t)v.uvs * v.mb_h * 8, 0);
  v.V.assign((size_t)v.uvs * v.mb_h * 8, 0);
  v.mbs.resize((size_t)v.mb_w * v.mb_h);
  std::vector<uint8_t> intra_t(4 * v.mb_w, B_DC);
  std::vector<uint8_t> nz_t(9 * v.mb_w, 0);
  for (int mb_y = 0; mb_y < v.mb_h; mb_y++) {
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    uint8_t nz_l[9] = {0};
    BoolDecoder& tokens = v.parts[mb_y & (v.parts.size() - 1)];
    for (int mb_x = 0; mb_x < v.mb_w; mb_x++) {
      MacroBlock& mb = v.mbs[mb_y * v.mb_w + mb_x];
      parse_modes(v, mb, &intra_t[4 * mb_x], intra_l);
    }
    for (int mb_x = 0; mb_x < v.mb_w; mb_x++) {
      MacroBlock& mb = v.mbs[mb_y * v.mb_w + mb_x];
      uint8_t* tnz = &nz_t[9 * mb_x];
      if (!mb.skip) {
        parse_residuals(v, mb, tokens, tnz, nz_l);
      } else {
        std::memset(tnz, 0, 8);
        std::memset(nz_l, 0, 8);
        if (!mb.is_i4x4) tnz[8] = nz_l[8] = 0;
        std::memset(mb.nonzero_y, 0, sizeof(mb.nonzero_y));
        std::memset(mb.nonzero_uv, 0, sizeof(mb.nonzero_uv));
        mb.coded = false;
      }
      if (tokens.past > 2) fail("truncated VP8 data (a token partition)");
    }
    if (v.br.past > 2) fail("truncated VP8 data (the first partition)");
  }
  reconstruct(v);
  loop_filter(v);
  emit_rgba(v, out);
}

// ---------------------------------------------------------------------------
// VP8L (lossless)
// ---------------------------------------------------------------------------

struct BitReaderL {  // LSB first
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t buf = 0;
  int bits = 0;

  void fill() {
    while (bits <= 56) {
      uint64_t b = 0;
      if (pos < n) b = d[pos];
      else if (pos > n + 8) fail("truncated VP8L data");
      pos++;
      buf |= b << bits;
      bits += 8;
    }
  }
  uint32_t peek(int k) {
    if (bits < k) fill();
    return (uint32_t)(buf & ((1ull << k) - 1));
  }
  void skip(int k) {
    buf >>= k;
    bits -= k;
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  // bits consumed past the end of the data
  bool overrun() const { return pos * 8 - bits > n * 8; }
};

constexpr int kLookup = 8;

struct Huffman {
  // canonical code: symbols by (length, value); count of each length
  std::vector<uint16_t> sorted;
  int count[16] = {0};
  int single = -1;  // the one symbol of a one-symbol code (no bits)
  // first-level table over kLookup bits (reversed codes): len << 16 | sym
  std::vector<uint32_t> table;

  void build(const std::vector<int>& lengths) {
    int nsym = 0, last = -1;
    for (int i = 0; i < 16; i++) count[i] = 0;
    for (size_t s = 0; s < lengths.size(); s++)
      if (lengths[s]) {
        count[lengths[s]]++;
        nsym++;
        last = (int)s;
      }
    if (nsym == 0) fail("a VP8L prefix code without symbols");
    if (nsym == 1) {
      single = last;
      return;
    }
    int left = 1;
    for (int l = 1; l < 16; l++) {
      left <<= 1;
      left -= count[l];
      if (left < 0) fail("an over-subscribed VP8L prefix code");
    }
    if (left > 0) fail("an incomplete VP8L prefix code");
    int offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; l++) offs[l + 1] = offs[l] + count[l];
    sorted.assign(nsym, 0);
    for (size_t s = 0; s < lengths.size(); s++)
      if (lengths[s]) sorted[offs[lengths[s]]++] = (uint16_t)s;
    table.assign(1 << kLookup, 0);
    int code = 0, k = 0;
    for (int l = 1; l <= kLookup; l++) {
      for (int i = 0; i < count[l]; i++, k++, code++) {
        int rev = 0;
        for (int b = 0; b < l; b++) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int f = rev; f < (1 << kLookup); f += 1 << l)
          table[f] = (uint32_t)(l << 16) | sorted[k];
      }
      code <<= 1;
    }
  }
  int read(BitReaderL& br) const {
    if (single >= 0) return single;
    uint32_t e = table[br.peek(kLookup)];
    if (e >> 16) {
      br.skip(e >> 16);
      return e & 0xffff;
    }
    // longer codes: one bit at a time (zlib's puff)
    uint32_t bits = br.peek(15);
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= 15; l++) {
      code |= (bits >> (l - 1)) & 1;
      int c = count[l];
      if (code - c < first) {
        br.skip(l);
        return sorted[index + (code - first)];
      }
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    fail("corrupt VP8L data (no prefix code matches)");
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                  7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};

Huffman read_code(BitReaderL& br, int alphabet) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple code
    int nsym = br.read(1) + 1;
    int first_8bit = br.read(1);
    int s = br.read(first_8bit ? 8 : 1);
    if (s >= alphabet) fail("a VP8L prefix code symbol past its alphabet");
    lengths[s] = 1;
    if (nsym == 2) {
      s = br.read(8);
      if (s >= alphabet) fail("a VP8L prefix code symbol past its alphabet");
      lengths[s] = 1;
    }
  } else {
    std::vector<int> cl(19, 0);
    int ncodes = br.read(4) + 4;
    for (int i = 0; i < ncodes; i++) cl[kCodeLengthOrder[i]] = br.read(3);
    Huffman lc;
    lc.build(cl);
    int max_symbol = alphabet;
    if (br.read(1)) {
      int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > alphabet) fail("corrupt VP8L code lengths");
    }
    int sym = 0, prev = 8;
    while (sym < alphabet) {
      if (max_symbol-- == 0) break;
      int c = lc.read(br);
      if (c < 16) {
        lengths[sym++] = c;
        if (c) prev = c;
      } else {
        int slot = c - 16;
        static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        int repeat = br.read(extra[slot]) + offset[slot];
        if (sym + repeat > alphabet) fail("corrupt VP8L code lengths");
        int len = c == 16 ? prev : 0;
        while (repeat-- > 0) lengths[sym++] = len;
      }
    }
  }
  Huffman h;
  h.build(lengths);
  return h;
}

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline int copy_value(int sym, BitReaderL& br) {  // GetCopyDistance / Length
  if (sym < 4) return sym + 1;
  int extra = (sym - 2) >> 1;
  int offset = (2 + (sym & 1)) << extra;
  return offset + (int)br.read(extra) + 1;
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

std::vector<uint32_t> decode_stream(BitReaderL& br, int xsize, int ysize, bool level0);

std::vector<uint32_t> decode_pixels(BitReaderL& br, int xsize, int ysize, bool level0) {
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) fail("bad VP8L colour cache size");
  }
  int hbits = 0, hxsize = 1;
  std::vector<uint32_t> himage;
  int ngroups = 1;
  if (level0 && br.read(1)) {
    hbits = br.read(3) + 2;
    hxsize = sub_sample(xsize, hbits);
    himage = decode_stream(br, hxsize, sub_sample(ysize, hbits), false);
    for (auto& p : himage) {
      p = (p >> 8) & 0xffff;
      ngroups = std::max(ngroups, (int)p + 1);
    }
  }
  std::vector<Huffman> groups(5 * (size_t)ngroups);
  for (int g = 0; g < ngroups; g++)
    for (int j = 0; j < 5; j++) {
      int alphabet = kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
      groups[5 * g + j] = read_code(br, alphabet);
    }
  if (br.overrun()) fail("truncated VP8L data (the prefix codes)");
  size_t total = (size_t)xsize * ysize;
  std::vector<uint32_t> px(total);
  std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0, 0);
  size_t cached = 0;
  auto insert = [&](size_t upto) {
    for (; cached < upto; cached++)
      cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
  };
  size_t i = 0;
  int col = 0, row = 0;
  while (i < total) {
    const Huffman* h = &groups[0];
    if (hbits)
      h = &groups[5 * (size_t)himage[(row >> hbits) * hxsize + (col >> hbits)]];
    int code = h[0].read(br);
    if (code < 256) {
      int red = h[1].read(br);
      int blue = h[2].read(br);
      int alpha = h[3].read(br);
      px[i++] = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
      if (++col >= xsize) { col = 0; row++; }
    } else if (code < 256 + 24) {
      int length = copy_value(code - 256, br);
      int dist_code = copy_value(h[4].read(br), br);
      size_t dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        int dc = kCodeToPlane[dist_code - 1];
        long d = (long)(dc >> 4) * xsize + (8 - (dc & 0xf));
        dist = d >= 1 ? (size_t)d : 1;
      }
      if (dist > i || total - i < (size_t)length)
        fail("corrupt VP8L data (a backward reference out of the image)");
      for (int k = 0; k < length; k++, i++) px[i] = px[i - dist];
      col += length;
      while (col >= xsize) { col -= xsize; row++; }
    } else {
      int key = code - 256 - 24;
      if (!cache_bits) fail("corrupt VP8L data");
      insert(i);
      px[i++] = cache[key];
      if (++col >= xsize) { col = 0; row++; }
    }
    if (cache_bits) insert(i);
    if (br.overrun()) fail("truncated VP8L data");
  }
  return px;
}

inline uint32_t add_px(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline uint32_t clip255u(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int add_sub_full(int a, int b, int c) { return (int)clip255u((uint32_t)(a + b - c)); }
inline int add_sub_half(int a, int b) { return (int)clip255u((uint32_t)(a + (a - b) / 2)); }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: {
      uint32_t a = top[0], b = left, c = top[-1];
      int s = sub3(a >> 24, b >> 24, c >> 24) +
              sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
              sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
              sub3(a & 0xff, b & 0xff, c & 0xff);
      return s <= 0 ? a : b;
    }
    case 12: {
      uint32_t c0 = left, c1 = top[0], c2 = top[-1];
      return ((uint32_t)add_sub_full(c0 >> 24, c1 >> 24, c2 >> 24) << 24) |
             (add_sub_full((c0 >> 16) & 0xff, (c1 >> 16) & 0xff, (c2 >> 16) & 0xff) << 16) |
             (add_sub_full((c0 >> 8) & 0xff, (c1 >> 8) & 0xff, (c2 >> 8) & 0xff) << 8) |
             add_sub_full(c0 & 0xff, c1 & 0xff, c2 & 0xff);
    }
    case 13: {
      uint32_t ave = average2(left, top[0]), c2 = top[-1];
      return ((uint32_t)add_sub_half(ave >> 24, c2 >> 24) << 24) |
             (add_sub_half((ave >> 16) & 0xff, (c2 >> 16) & 0xff) << 16) |
             (add_sub_half((ave >> 8) & 0xff, (c2 >> 8) & 0xff) << 8) |
             add_sub_half(ave & 0xff, c2 & 0xff);
    }
    default: return 0xff000000u;  // 0, and 14 / 15 as libwebp pads them
  }
}

// in: the pixels of the transform's input (xsize of t, or the packed width
// of a colour-indexing transform); returns the transform's output
std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t> in) {
  int w = t.xsize, h = t.ysize;
  switch (t.type) {
    case 0: {  // predictor
      std::vector<uint32_t>& out = in;  // in place, row by row
      out[0] = add_px(out[0], 0xff000000u);
      for (int x = 1; x < w; x++) out[x] = add_px(out[x], out[x - 1]);
      int tiles = sub_sample(w, t.bits);
      for (int y = 1; y < h; y++) {
        uint32_t* row = &out[(size_t)y * w];
        const uint32_t* top = row - w;
        row[0] = add_px(row[0], top[0]);
        const uint32_t* modes = &t.data[(size_t)(y >> t.bits) * tiles];
        for (int x = 1; x < w; x++) {
          int mode = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add_px(row[x], predict(mode, row[x - 1], top + x));
        }
      }
      return out;
    }
    case 1: {  // cross colour
      int tiles = sub_sample(w, t.bits);
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          uint32_t m = t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
          int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff);
          int8_t r2b = (int8_t)((m >> 16) & 0xff);
          uint32_t argb = in[(size_t)y * w + x];
          int8_t green = (int8_t)(argb >> 8);
          int nr = (argb >> 16) & 0xff, nb = argb & 0xff;
          nr = (nr + (((int)g2r * green) >> 5)) & 0xff;
          nb += ((int)g2b * green) >> 5;
          nb += ((int)r2b * (int8_t)nr) >> 5;
          nb &= 0xff;
          in[(size_t)y * w + x] = (argb & 0xff00ff00u) | (nr << 16) | nb;
        }
      return in;
    }
    case 2:  // subtract green
      for (auto& p : in) {
        uint32_t g = (p >> 8) & 0xff;
        uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
      return in;
    default: {  // colour indexing
      int bits = t.bits, bpp = 8 >> bits, per = 1 << bits;
      int src_w = sub_sample(w, bits);
      uint32_t mask = (1u << bpp) - 1;
      std::vector<uint32_t> out((size_t)w * h);
      for (int y = 0; y < h; y++) {
        const uint32_t* src = &in[(size_t)y * src_w];
        uint32_t packed = 0;
        for (int x = 0; x < w; x++) {
          if ((x & (per - 1)) == 0) packed = (*src++ >> 8) & 0xff;
          out[(size_t)y * w + x] = t.data[packed & mask];
          packed >>= bpp;
        }
      }
      return out;
    }
  }
}

std::vector<uint32_t> decode_stream(BitReaderL& br, int xsize, int ysize, bool level0) {
  std::vector<Transform> transforms;
  int tx = xsize;
  unsigned seen = 0;
  if (level0) {
    while (br.read(1)) {
      Transform t;
      t.type = br.read(2);
      if (seen & (1u << t.type)) fail("a VP8L transform used twice");
      seen |= 1u << t.type;
      t.xsize = tx;
      t.ysize = ysize;
      t.bits = 0;
      if (t.type == 0 || t.type == 1) {
        t.bits = br.read(3) + 2;
        t.data = decode_stream(br, sub_sample(tx, t.bits), sub_sample(ysize, t.bits), false);
      } else if (t.type == 3) {
        int ncolors = br.read(8) + 1;
        t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
        std::vector<uint32_t> pal = decode_stream(br, ncolors, 1, false);
        t.data.assign((size_t)1 << (8 >> t.bits), 0);
        uint8_t* nd = (uint8_t*)t.data.data();
        const uint8_t* od = (const uint8_t*)pal.data();
        for (int i = 0; i < 4; i++) nd[i] = od[i];
        for (int i = 4; i < 4 * ncolors; i++) nd[i] = (uint8_t)(od[i] + nd[i - 4]);
        tx = sub_sample(tx, t.bits);
      }
      transforms.push_back(std::move(t));
    }
  }
  std::vector<uint32_t> px = decode_pixels(br, tx, ysize, level0);
  for (size_t k = transforms.size(); k-- > 0;) px = inverse(transforms[k], std::move(px));
  return px;
}

void decode_vp8l(const uint8_t* d, size_t n, int width, int height, bool headerless,
                 uint8_t* rgba) {
  BitReaderL br;
  br.d = d;
  br.n = n;
  if (!headerless) {
    if (n < 5 || d[0] != 0x2f) fail("bad VP8L signature");
    br.read(8);
    int w = br.read(14) + 1, h = br.read(14) + 1;
    br.read(1);  // alpha is used: a hint only
    if (br.read(3) != 0) fail("unknown VP8L version");
    if (w != width || h != height)
      fail("VP8L image of " + std::to_string(w) + "x" + std::to_string(h) +
           " in a " + std::to_string(width) + "x" + std::to_string(height) + " image");
  }
  std::vector<uint32_t> px = decode_stream(br, width, height, true);
  for (size_t i = 0; i < px.size(); i++) {
    uint32_t p = px[i];
    rgba[4 * i] = (uint8_t)(p >> 16);
    rgba[4 * i + 1] = (uint8_t)(p >> 8);
    rgba[4 * i + 2] = (uint8_t)p;
    rgba[4 * i + 3] = (uint8_t)(p >> 24);
  }
}

// ---------------------------------------------------------------------------
// ALPH
// ---------------------------------------------------------------------------

void decode_alpha(const uint8_t* d, size_t n, int width, int height, uint8_t* out) {
  if (n < 1) fail("empty ALPH chunk");
  int method = d[0] & 3, filter = (d[0] >> 2) & 3, pre = (d[0] >> 4) & 3;
  int rsrv = (d[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0)
    fail("bad ALPH header (compression " + std::to_string(method) + ", preprocessing " +
         std::to_string(pre) + ")");
  size_t total = (size_t)width * height;
  std::vector<uint8_t> a(total);
  if (method == 0) {
    if (n - 1 < total) fail("truncated ALPH data");
    std::memcpy(a.data(), d + 1, total);
  } else {
    std::vector<uint8_t> rgba(total * 4);
    decode_vp8l(d + 1, n - 1, width, height, true, rgba.data());
    for (size_t i = 0; i < total; i++) a[i] = rgba[4 * i + 1];
  }
  for (int y = 0; y < height; y++) {
    const uint8_t* in = &a[(size_t)y * width];
    uint8_t* o = out + (size_t)y * width;
    const uint8_t* prev = y ? o - width : nullptr;
    if (filter == 0) {
      std::memcpy(o, in, width);
    } else if (filter == 1 || !prev) {  // horizontal (and every first row)
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; x++) pred = o[x] = (uint8_t)(pred + in[x]);
    } else if (filter == 2) {  // vertical
      for (int x = 0; x < width; x++) o[x] = (uint8_t)(prev[x] + in[x]);
    } else {  // gradient
      int top = prev[0], top_left = top, left = top;
      for (int x = 0; x < width; x++) {
        top = prev[x];
        int g = left + top - top_left;
        g = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
        left = (uint8_t)(in[x] + g);
        top_left = top;
        o[x] = (uint8_t)left;
      }
    }
  }
}

}  // namespace

extern "C" {

int crdr_webp_vp8(const uint8_t* data, int64_t n, int width, int height,
                  uint8_t* out, char* err, int errlen) {
  try {
    decode_vp8(data, (size_t)n, width, height, out);
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}

int crdr_webp_vp8l(const uint8_t* data, int64_t n, int width, int height,
                   int headerless, uint8_t* out, char* err, int errlen) {
  try {
    decode_vp8l(data, (size_t)n, width, height, headerless != 0, out);
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}

int crdr_webp_alpha(const uint8_t* data, int64_t n, int width, int height,
                    uint8_t* out, char* err, int errlen) {
  try {
    decode_alpha(data, (size_t)n, width, height, out);
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}

}  // extern "C"
