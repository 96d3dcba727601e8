// WebP's two bitstreams in host C++, pixel for pixel what libwebp decodes
// (and through it OpenCV's WebP reader):
//
// VP8L (lossless), as the WebP Lossless Bitstream Specification (RFC 9649)
// defines it and libwebp's vp8l_dec.c reads it: the transforms (predictor
// with its 14 modes, cross-colour, subtract-green, colour indexing with
// pixel bundling, each at most once), the colour cache, the meta prefix
// image and its prefix-code groups, simple and normal prefix codes (a code
// that is not complete is an error unless it has one symbol, which then
// takes no bits), LZ77 copies with the 120-entry distance map.  Bits are
// read least significant first; a stream that needs bits past its end (a
// stream under 8 bytes reads zeros up to 8) is an error, as in libwebp.
// The same entry decodes an ALPH chunk's headerless stream.
//
// VP8 (lossy) key frames, as RFC 6386 defines them and libwebp's vp8_dec.c,
// tree_dec.c, quant_dec.c and frame_dec.c decode them: the boolean decoder
// (libwebp's 64-bit reader, an error once a partition is read past its end),
// segment, filter and quantiser headers, token probability updates, 1, 2, 4
// or 8 token partitions, intra 16x16 / 4x4 / chroma prediction with the
// 127 / 129 borders, the inverse WHT and DCT (libwebp's SSE2 one where it
// runs it: 16-bit lanes that wrap on a damaged stream), and the simple and
// normal loop filters with sharpness and the mode and reference deltas
// (none when the frame's level is 0).  Then YUV 4:2:0 -> RGB as libwebp's
// WebPDecodeBGR does it: "fancy" upsampling of the chroma (9-3-3-1
// weights, the first and an even last row mirrored) and the 14-bit fixed
// point VP8YUVToR/G/B.
//
// The probability, quantiser and distance tables are those of RFC 6386
// and RFC 9649.  Both readers take the data past their chunk, as libwebp
// reads it (the caller passes it).  Errors return -1 with a message.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

void set_message(char* msg, int64_t msg_len, const std::string& text) {
  if (msg != nullptr && msg_len > 0) {
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", text.c_str());
  }
}

struct Failure {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Failure{what}; }

// RFC 6386's tables
const uint8_t kCoeffsProba0[4][8][3][11] = {
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

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
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

const uint8_t kBModesProba[10][10][9] = {
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

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};


// --- VP8L ------------------------------------------------------------------------------

// Least-significant-bit-first reader.  `limit` is libwebp's end of stream:
// the stream's bits, or 64 when it is shorter than 8 bytes.
struct LBits {
  const uint8_t* p = nullptr;
  size_t n = 0, next = 0;
  uint64_t val = 0, consumed = 0, limit = 0;
  int nbits = 0;

  LBits(const uint8_t* data, size_t size) : p(data), n(size) {
    limit = 8 * static_cast<uint64_t>(std::max<size_t>(size, 8));
  }
  void fill() {
    while (nbits <= 56) {
      const uint64_t b = next < n ? p[next] : 0;
      ++next;
      val |= b << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int k) {
    if (nbits < k) fill();
    return static_cast<uint32_t>(val & ((uint64_t{1} << k) - 1));
  }
  void skip(int k) {
    val >>= k;
    nbits -= k;
    consumed += k;
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
  bool eos() const { return consumed > limit; }
};

constexpr int kRootBits = 8;

// A canonical prefix code: a root table on the next kRootBits bits
// (reversed codes), longer codes decoded bit by bit.
struct Prefix {
  int single = -1;  // the one symbol of a code with one symbol (no bits)
  std::vector<int32_t> root;  // (symbol << 8) | length, or -1 for a longer code
  std::vector<int> count, first, offset;
  std::vector<int> sorted;

  // Returns false where libwebp's BuildHuffmanTable fails.
  bool build(const std::vector<int>& lengths) {
    const int n = static_cast<int>(lengths.size());
    count.assign(16, 0);
    int used = 0, last = -1;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      if (lengths[s] > 0) {
        ++count[lengths[s]];
        ++used;
        last = s;
      }
    }
    if (used == 0) return false;
    if (used == 1) {
      single = last;
      return true;
    }
    int64_t open = 1;  // Kraft: the code must be complete
    for (int len = 1; len <= 15; ++len) {
      open = 2 * open - count[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    first.assign(16, 0);
    offset.assign(16, 0);
    int code = 0, off = 0;
    for (int len = 1; len <= 15; ++len) {
      first[len] = code;
      offset[len] = off;
      code = (code + count[len]) << 1;
      off += count[len];
    }
    sorted.assign(used, 0);
    std::vector<int> fill_at(offset);
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 0) sorted[fill_at[lengths[s]]++] = s;
    }
    root.assign(1 << kRootBits, -1);
    std::vector<int> next_code(first);
    for (int s = 0; s < n; ++s) {
      const int len = lengths[s];
      if (len == 0 || len > kRootBits) continue;
      const int c = next_code[len]++;
      int rev = 0;
      for (int i = 0; i < len; ++i) rev |= ((c >> i) & 1) << (len - 1 - i);
      for (int k = rev; k < (1 << kRootBits); k += 1 << len) root[k] = (s << 8) | len;
    }
    return true;
  }

  int decode(LBits& br) const {
    if (single >= 0) return single;
    const uint32_t window = br.peek(kRootBits);
    const int32_t e = root[window];
    if (e >= 0) {
      br.skip(e & 255);
      return e >> 8;
    }
    int code = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= static_cast<int>(br.read(1));
      const int idx = code - first[len];
      if (idx >= 0 && idx < count[len]) return sorted[offset[len] + idx];
      code <<= 1;
    }
    fail("VP8L: bad prefix code");  // not reached for a complete code
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};

Prefix read_code(LBits& br, int alphabet) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple code: one or two symbols of length 1
    const int num = static_cast<int>(br.read(1)) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    const int s0 = static_cast<int>(br.read(first_bits));
    if (s0 < alphabet) lengths[s0] = 1;  // a symbol past the alphabet is dropped
    if (num == 2) {
      const int s1 = static_cast<int>(br.read(8));
      if (s1 < alphabet) lengths[s1] = 1;
    }
  } else {
    std::vector<int> cl(19, 0);
    const int num_codes = static_cast<int>(br.read(4)) + 4;
    for (int i = 0; i < num_codes; ++i) cl[kCodeLengthOrder[i]] = static_cast<int>(br.read(3));
    Prefix lens;
    if (!lens.build(cl)) fail("VP8L: bad code length code");
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * static_cast<int>(br.read(3));
      max_symbol = 2 + static_cast<int>(br.read(nbits));
      if (max_symbol > alphabet) fail("VP8L: code lengths past the alphabet");
    }
    int prev = 8, s = 0;
    while (s < alphabet) {
      if (max_symbol-- == 0) break;
      const int c = lens.decode(br);
      if (c < 16) {
        lengths[s++] = c;
        if (c != 0) prev = c;
      } else {
        static const int extra[3] = {2, 3, 7}, base[3] = {3, 3, 11};
        int repeat = static_cast<int>(br.read(extra[c - 16])) + base[c - 16];
        if (s + repeat > alphabet) fail("VP8L: code length repeat past the alphabet");
        const int v = c == 16 ? prev : 0;
        while (repeat-- > 0) lengths[s++] = v;
      }
    }
  }
  if (br.eos()) fail("VP8L: stream ends inside a prefix code");
  Prefix code;
  if (!code.build(lengths)) fail("VP8L: prefix code is not complete");
  return code;
}

struct Group {
  Prefix code[5];
};

inline int sub_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

const uint8_t kCodeToPlane[120] = {
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

int copy_distance(LBits& br, int sym) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + static_cast<int>(br.read(extra)) + 1;
}

int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int d = kCodeToPlane[code - 1];
  const int dist = (d >> 4) * xsize + (8 - (d & 15));
  return dist >= 1 ? dist : 1;
}

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

std::vector<uint32_t> decode_stream(LBits& br, int xsize, int ysize, bool level0,
                                    std::vector<Transform>* transforms);

// The entropy-coded image of `xsize` x `ysize` pixels (after the transforms
// and the colour cache bits have been read).
std::vector<uint32_t> decode_pixels(LBits& br, int xsize, int ysize, int cache_bits,
                                    bool allow_meta) {
  int meta_bits = 0;
  std::vector<uint32_t> meta;
  int num_groups = 1;
  if (allow_meta && br.read(1)) {
    meta_bits = static_cast<int>(br.read(3)) + 2;
    meta = decode_stream(br, sub_size(xsize, meta_bits), sub_size(ysize, meta_bits), false,
                         nullptr);
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      num_groups = std::max<int>(num_groups, static_cast<int>(m) + 1);
    }
  }
  if (br.eos()) fail("VP8L: stream ends in the meta prefix image");
  std::vector<Group> groups(num_groups);
  const int cache_size = cache_bits > 0 ? 1 << cache_bits : 0;
  for (Group& g : groups) {
    for (int j = 0; j < 5; ++j) g.code[j] = read_code(br, kAlphabet[j] + (j == 0 ? cache_size : 0));
  }
  std::vector<uint32_t> cache(cache_size > 0 ? cache_size : 1, 0);
  const int cache_shift = 32 - cache_bits;
  const int64_t total = static_cast<int64_t>(xsize) * ysize;
  std::vector<uint32_t> out(static_cast<size_t>(total), 0);
  int64_t pos = 0, cached = 0;
  // the colour cache takes every pixel in order; filled when it is read
  auto insert_cache = [&]() {
    for (; cached < pos; ++cached) {
      const uint32_t argb = out[cached];
      cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
    }
  };
  const int meta_w = meta_bits ? sub_size(xsize, meta_bits) : 0;
  while (pos < total) {
    const int x = static_cast<int>(pos % xsize), y = static_cast<int>(pos / xsize);
    const Group& g = meta_bits
        ? groups[meta[static_cast<size_t>(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        : groups[0];
    const int code = g.code[0].decode(br);
    if (code < 256) {
      const uint32_t red = g.code[1].decode(br);
      const uint32_t blue = g.code[2].decode(br);
      const uint32_t alpha = g.code[3].decode(br);
      if (br.eos()) break;
      out[pos++] = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
    } else if (code < 256 + 24) {
      const int length = copy_distance(br, code - 256);
      const int dist_sym = g.code[4].decode(br);
      const int dist = plane_to_distance(xsize, copy_distance(br, dist_sym));
      if (br.eos()) break;
      if (pos < dist || total - pos < length) fail("VP8L: backward reference out of the image");
      for (int i = 0; i < length; ++i, ++pos) out[pos] = out[pos - dist];
    } else {  // a colour cache symbol (the alphabet has them only with a cache)
      if (br.eos()) break;
      insert_cache();
      out[pos] = cache[code - 280];
      ++pos;
    }
  }
  if (br.eos()) fail("VP8L: stream ends before the image does");
  return out;
}

std::vector<uint32_t> decode_stream(LBits& br, int xsize, int ysize, bool level0,
                                    std::vector<Transform>* transforms) {
  int tx = xsize;
  if (level0) {
    unsigned seen = 0;
    while (br.read(1)) {
      Transform t;
      t.type = static_cast<int>(br.read(2));
      if (seen & (1u << t.type)) fail("VP8L: a transform given twice");
      seen |= 1u << t.type;
      t.xsize = tx;
      t.ysize = ysize;
      if (t.type == 0 || t.type == 1) {
        t.bits = static_cast<int>(br.read(3)) + 2;
        t.data = decode_stream(br, sub_size(tx, t.bits), sub_size(ysize, t.bits), false, nullptr);
      } else if (t.type == 3) {
        const int num_colors = static_cast<int>(br.read(8)) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        tx = sub_size(t.xsize, t.bits);
        std::vector<uint32_t> pal = decode_stream(br, num_colors, 1, false, nullptr);
        t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
        t.data[0] = pal[0];
        for (int i = 1; i < num_colors; ++i) {  // deltas, byte by byte
          uint32_t v = 0;
          for (int k = 0; k < 32; k += 8) {
            v |= ((((pal[i] >> k) & 255) + ((t.data[i - 1] >> k) & 255)) & 255) << k;
          }
          t.data[i] = v;
        }
      }
      transforms->push_back(std::move(t));
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = static_cast<int>(br.read(4));
    if (cache_bits < 1 || cache_bits > 11) fail("VP8L: bad colour cache size");
  }
  if (br.eos()) fail("VP8L: stream ends in its header");
  return decode_pixels(br, tx, ysize, cache_bits, level0);
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
  int diff = 0;
  for (int k = 0; k < 32; k += 8) {
    const int a = (t >> k) & 255, b = (l >> k) & 255, c = (tl >> k) & 255;
    diff += std::abs(b - c) - std::abs(a - c);
  }
  return diff <= 0 ? t : l;
}
inline uint32_t clamp_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t v = 0;
  for (int k = 0; k < 32; k += 8) {
    v |= static_cast<uint32_t>(clip255(static_cast<int>((a >> k) & 255) +
                                       static_cast<int>((b >> k) & 255) -
                                       static_cast<int>((c >> k) & 255)))
         << k;
  }
  return v;
}
inline uint32_t clamp_half(uint32_t a, uint32_t b) {
  uint32_t v = 0;
  for (int k = 0; k < 32; k += 8) {
    const int x = (a >> k) & 255, y = (b >> k) & 255;
    v |= static_cast<uint32_t>(clip255(x + (x - y) / 2)) << k;
  }
  return v;
}

uint32_t predict(int mode, const uint32_t* cur, int64_t i, int w) {
  const uint32_t L = cur[i - 1], T = cur[i - w], TR = cur[i - w + 1], TL = cur[i - w - 1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamp_full(L, T, TL);
    case 13: return clamp_half(average2(L, T), TL);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

void inverse_transform(const Transform& t, std::vector<uint32_t>& px) {
  const int w = t.xsize, h = t.ysize;
  if (t.type == 2) {  // subtract green
    for (uint32_t& p : px) {
      const uint32_t g = (p >> 8) & 255;
      const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
      p = (p & 0xff00ff00u) | rb;
    }
  } else if (t.type == 0) {  // predictor
    const int bw = sub_size(w, t.bits);
    uint32_t* d = px.data();
    d[0] = add_pixels(d[0], 0xff000000u);
    for (int x = 1; x < w; ++x) d[x] = add_pixels(d[x], d[x - 1]);
    for (int y = 1; y < h; ++y) {
      const int64_t row = static_cast<int64_t>(y) * w;
      d[row] = add_pixels(d[row], d[row - w]);
      for (int x = 1; x < w; ++x) {
        const int mode = (t.data[static_cast<size_t>(y >> t.bits) * bw + (x >> t.bits)] >> 8) & 15;
        d[row + x] = add_pixels(d[row + x], predict(mode, d, row + x, w));
      }
    }
  } else if (t.type == 1) {  // cross colour
    const int bw = sub_size(w, t.bits);
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        const uint32_t m = t.data[static_cast<size_t>(y >> t.bits) * bw + (x >> t.bits)];
        const int8_t g2r = static_cast<int8_t>(m & 255), g2b = static_cast<int8_t>((m >> 8) & 255),
                     r2b = static_cast<int8_t>((m >> 16) & 255);
        uint32_t& p = px[static_cast<size_t>(y) * w + x];
        const int8_t green = static_cast<int8_t>((p >> 8) & 255);
        int red = (p >> 16) & 255, blue = p & 255;
        red = (red + ((g2r * green) >> 5)) & 255;
        blue += (g2b * green) >> 5;
        blue += (r2b * static_cast<int8_t>(red)) >> 5;
        blue &= 255;
        p = (p & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
      }
    }
  } else {  // colour indexing, `bits` > 0 bundling 2, 4 or 8 indices a pixel
    const int sw = sub_size(w, t.bits);
    std::vector<uint32_t> out(static_cast<size_t>(w) * h);
    const int per = 1 << t.bits, bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        const uint32_t packed = (px[static_cast<size_t>(y) * sw + (x >> t.bits)] >> 8) & 255;
        const int idx = (packed >> ((x & (per - 1)) * bpp)) & mask;
        out[static_cast<size_t>(y) * w + x] = t.data[idx];
      }
    }
    px.swap(out);
  }
}

}  // namespace

// Decodes the VP8L stream `src[0:n]` of a `width` x `height` image into
// `out` (ARGB words).  `header` 1: the stream starts with the 5-byte VP8L
// header (signature, sides, alpha hint, version 0), which must give these
// sides; 0: an ALPH chunk's headerless stream.  Returns 0, or -1 with a
// message.
extern "C" int64_t rcnn_webp_vp8l_decode(const uint8_t* src, int64_t n, int64_t width,
                                         int64_t height, int64_t header, uint32_t* out,
                                         char* msg, int64_t msg_len) {
  if (src == nullptr || out == nullptr || n < 0 || width < 1 || height < 1) return -1;
  try {
    LBits br(src, static_cast<size_t>(n));
    if (header) {
      if (n < 5 || src[0] != 0x2f) fail("VP8L: bad signature");
      br.read(8);
      const int64_t w = br.read(14) + 1, h = br.read(14) + 1;
      br.read(1);
      if (br.read(3) != 0) fail("VP8L: unknown version");
      if (w != width || h != height) fail("VP8L: sides differ from the header's");
    }
    std::vector<Transform> transforms;
    std::vector<uint32_t> px = decode_stream(br, static_cast<int>(width), static_cast<int>(height),
                                             true, &transforms);
    for (auto t = transforms.rbegin(); t != transforms.rend(); ++t) inverse_transform(*t, px);
    std::memcpy(out, px.data(), px.size() * sizeof(uint32_t));
    return 0;
  } catch (const Failure& f) {
    set_message(msg, msg_len, f.what);
  } catch (const std::bad_alloc&) {
    set_message(msg, msg_len, "VP8L: out of memory");
  }
  return -1;
}

// --- VP8 -------------------------------------------------------------------------------

namespace {

// The boolean decoder as libwebp's VP8BitReader runs it on a 64-bit host:
// a 64-bit window filled 7 bytes at a time while 8 remain, then byte by
// byte; `range` holds the range less one; reading a bit once every byte is
// in sets `eof` (a zero byte is shifted in), which fails the frame.  The
// widths and the fill pattern are libwebp's because a damaged stream (a
// first byte of 0xff, which no encoder writes) breaks the coder's
// invariant, and what follows then depends on them.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  const uint8_t* max = nullptr;  // the last position 8 bytes can be read at, plus one
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  bool eof = false;

  void init(const uint8_t* b, size_t n) {
    buf = b;
    end = b + n;
    max = n >= 8 ? b + n - 8 + 1 : b;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (buf < max) {  // 7 bytes, most significant first
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
      buf += 7;
      value = in | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = static_cast<uint64_t>(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    int b = 0;
    if (v > split) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << pos;
      b = 1;
    } else {
      r = split + 1;
    }
    int shift = 0;
    while ((r << shift) < 128) ++shift;
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  // libwebp's VP8GetSigned: a bit at probability 1/2 with the shift fixed
  // at 1 (the same as bit(0x80) while the invariant holds), -v or v
  int sign(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = static_cast<uint32_t>(value >> pos);
    const int32_t mask = static_cast<int32_t>(split - val) >> 31;  // -1 or 0
    bits -= 1;
    range += static_cast<uint32_t>(mask);
    range |= 1;
    value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t value_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= static_cast<uint32_t>(bit(0x80)) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = static_cast<int>(value_bits(n));
    return bit(0x80) ? -v : v;
  }
};

enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

// kYModesIntra4: the 4x4 mode tree, leaves as -mode
const int8_t kBModeTree[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                               -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

inline int clip(int v, int hi) { return v < 0 ? 0 : v > hi ? hi : v; }
inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct MB {
  int segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
  uint8_t imodes[16] = {0};
  int16_t coeffs[384];
  uint32_t nz_y = 0, nz_uv = 0;  // libwebp's non_zero_y_ / non_zero_uv_ codes
};

struct FilterInfo {  // what the loop filter needs of a macroblock
  uint8_t segment = 0, is_i4x4 = 0, inner = 0;
};

struct Vp8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  std::vector<BoolReader> parts;
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int seg_quant[4] = {0}, seg_filter[4] = {0};
  uint8_t seg_proba[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip = 0, skip_p = 0;
  // planes with the padding of whole macroblocks
  int ystride = 0, uvstride = 0;
  std::vector<uint8_t> Y, U, V;
  std::vector<MB> mbs;  // one row of macroblocks: modes and coefficients
  std::vector<FilterInfo> finfo;  // every macroblock

  void parse(const uint8_t* data, size_t size);
  void parse_modes(MB& mb, uint8_t* top, uint8_t* left);
  int parse_residuals(MB& mb, BoolReader& tbr, uint8_t& tnz_mb, uint8_t& lnz_mb,
                      uint8_t& tnz_dc, uint8_t& lnz_dc);
  int f_limit[4][2], f_ilevel[4][2], f_hev[4][2];  // per segment and 4x4-ness

  void reconstruct_row(int mb_y);
  void loop_filter();
};

// `p` walks bands_ptr_[type][n]: the probabilities of band kBands[n]
int get_large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  } else if (!br.bit(p[6])) {
    if (!br.bit(p[7])) {
      v = 5 + br.bit(159);
    } else {
      v = 7 + 2 * br.bit(165);
      v += br.bit(145);
    }
  } else {
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// libwebp's GetCoeffs: the position after the last coefficient read (0
// when the block ends at once), coefficients dequantised into `out`.
int get_coeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx, const int dq[2], int n,
               int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      ++n;
      p = bands[kBands[n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = bands[kBands[n + 1]][1];
    } else {
      v = get_large_value(br, p);
      p = bands[kBands[n + 1]][2];
    }
    out[kZigzag[n]] = static_cast<int16_t>(br.sign(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

void transform_wht(const int16_t* in, int16_t* out) {
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
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The inverse DCT of one 4x4 block, added to `dst`.
void transform_one(const int16_t* in, uint8_t* dst, int stride) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += stride;
  }
}

// libwebp's SSE2 inverse DCT (Transform_SSE2), which x86 builds run for
// blocks with coefficients past the third: the same sums in 16-bit lanes
// that wrap, the products as mulhi by 20091 and 35468 - 65536.  It equals
// transform_one while the coefficients stay within [-2048, 2047], as an
// encoder's do; past that (a damaged stream) the lanes wrap as here.
inline int16_t w16(int v) { return static_cast<int16_t>(v); }
inline int16_t mulhi(int16_t x, int k) { return static_cast<int16_t>((x * k) >> 16); }

void transform_simd(const int16_t* in, uint8_t* dst, int stride) {
  constexpr int k1 = 20091, k2 = -30068;
  int16_t v[4][4];  // v[r][c]: the vertical pass's output r for column c
  for (int c = 0; c < 4; ++c) {
    const int16_t i0 = in[c], i1 = in[4 + c], i2 = in[8 + c], i3 = in[12 + c];
    const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    const int16_t cc = w16(w16(i1 - i3) + w16(mulhi(i1, k2) - mulhi(i3, k1)));
    const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, k1) + mulhi(i3, k2)));
    v[0][c] = w16(a + d);
    v[1][c] = w16(b + cc);
    v[2][c] = w16(b - cc);
    v[3][c] = w16(a - d);
  }
  for (int r = 0; r < 4; ++r) {
    const int16_t* x = v[r];
    const int16_t dc = w16(x[0] + 4);
    const int16_t a = w16(dc + x[2]), b = w16(dc - x[2]);
    const int16_t cc = w16(w16(x[1] - x[3]) + w16(mulhi(x[1], k2) - mulhi(x[3], k1)));
    const int16_t d = w16(w16(x[1] + x[3]) + w16(mulhi(x[1], k1) + mulhi(x[3], k2)));
    const int16_t out[4] = {w16(a + d), w16(b + cc), w16(b - cc), w16(a - d)};
    for (int k = 0; k < 4; ++k) dst[k] = clip8(dst[k] + (out[k] >> 3));
    dst += stride;
  }
}

void Vp8::parse_modes(MB& mb, uint8_t* top, uint8_t* left) {
  if (update_map) {
    mb.segment = !br.bit(seg_proba[0]) ? br.bit(seg_proba[1]) : br.bit(seg_proba[2]) + 2;
  } else {
    mb.segment = 0;
  }
  if (use_skip) mb.skip = br.bit(skip_p);
  mb.is_i4x4 = !br.bit(145);
  if (!mb.is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE) : (br.bit(163) ? B_VE : B_DC);
    mb.imodes[0] = static_cast<uint8_t>(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = mb.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        int i = kBModeTree[br.bit(prob[0])];
        while (i > 0) i = kBModeTree[2 * i + br.bit(prob[i])];
        ymode = -i;
        top[x] = static_cast<uint8_t>(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = static_cast<uint8_t>(ymode);
    }
  }
  mb.uvmode = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE : br.bit(183) ? B_TM : B_HE;
}

// libwebp's ParseResiduals; returns 1 when no coefficient is non-zero.
int Vp8::parse_residuals(MB& mb, BoolReader& tbr, uint8_t& t_nz, uint8_t& l_nz, uint8_t& t_dc,
                         uint8_t& l_dc) {
  const Quant& q = dqm[mb.segment];
  int16_t* dst = mb.coeffs;
  std::memset(dst, 0, sizeof(mb.coeffs));
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first;
  const uint8_t(*ac_bands)[3][11];
  if (!mb.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = t_dc + l_dc;
    const int nz = get_coeffs(tbr, proba[1], ctx, q.y2, 0, dc);
    t_dc = l_dc = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac_bands = proba[0];
  } else {
    first = 0;
    ac_bands = proba[3];
  }
  uint8_t tnz = t_nz & 0x0f, lnz = l_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(tbr, ac_bands, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = static_cast<uint8_t>(t_nz >> (4 + ch));
    lnz = static_cast<uint8_t>(l_nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tbr, proba[2], ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= static_cast<uint32_t>(tnz << 4) << ch;
    out_l_nz |= static_cast<uint32_t>(lnz & 0xf0) << ch;
  }
  t_nz = static_cast<uint8_t>(out_t_nz);
  l_nz = static_cast<uint8_t>(out_l_nz);
  mb.nz_y = non_zero_y;
  mb.nz_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

void Vp8::parse(const uint8_t* data, size_t size) {
  if (size < 10) fail("VP8: truncated header");
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  if (bits & 1) fail("VP8: not a key frame");
  if (((bits >> 1) & 7) > 3) fail("VP8: bad profile");
  if (!((bits >> 4) & 1)) fail("VP8: frame not shown");
  const uint32_t part0 = bits >> 5;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) fail("VP8: bad start code");
  width = ((data[7] << 8) | data[6]) & 0x3fff;
  height = ((data[9] << 8) | data[8]) & 0x3fff;
  if (width == 0 || height == 0) fail("VP8: zero sides");
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  const uint8_t* buf = data + 10;
  size_t left = size - 10;
  if (part0 > left) fail("VP8: bad partition length");
  br.init(buf, part0);
  buf += part0;
  left -= part0;
  br.value_bits(1);  // colour space
  br.value_bits(1);  // clamping type
  use_segment = br.value_bits(1);
  if (use_segment) {
    update_map = br.value_bits(1);
    if (br.value_bits(1)) {  // update data
      absolute_delta = br.value_bits(1);
      for (int s = 0; s < 4; ++s) seg_quant[s] = br.value_bits(1) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) seg_filter[s] = br.value_bits(1) ? br.signed_value(6) : 0;
    }
    if (update_map) {
      for (int s = 0; s < 3; ++s) seg_proba[s] = br.value_bits(1) ? br.value_bits(8) : 255;
    }
  }
  if (br.eof) fail("VP8: cannot parse the segment header");
  simple = br.value_bits(1);
  level = br.value_bits(6);
  sharpness = br.value_bits(3);
  use_lf_delta = br.value_bits(1);
  if (use_lf_delta && br.value_bits(1)) {
    for (int i = 0; i < 4; ++i) {
      if (br.value_bits(1)) ref_lf_delta[i] = br.signed_value(6);
    }
    for (int i = 0; i < 4; ++i) {
      if (br.value_bits(1)) mode_lf_delta[i] = br.signed_value(6);
    }
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) fail("VP8: cannot parse the filter header");
  // partitions
  const int num_parts = 1 << br.value_bits(2);
  const size_t last = num_parts - 1;
  if (left < 3 * last) fail("VP8: cannot parse the partitions");
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + 3 * last;
  size_t size_left = left - 3 * last;
  parts.assign(num_parts, BoolReader());
  for (size_t p = 0; p < last; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts[last].init(part_start, size_left);
  if (part_start >= buf + left) fail("VP8: cannot parse the partitions");
  // quantisers
  const int base_q0 = br.value_bits(7);
  const int dqy1_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dqy2_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dqy2_ac = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dquv_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dquv_ac = br.value_bits(1) ? br.signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = seg_quant[i] + (absolute_delta ? 0 : base_q0);
    } else if (i > 0) {
      dqm[i] = dqm[0];
      continue;
    } else {
      q = base_q0;
    }
    Quant& m = dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.value_bits(1);  // refresh entropy probs: ignored for a single key frame
  for (int t = 0; t < 4; ++t) {
    for (int b = 0; b < 8; ++b) {
      for (int c = 0; c < 3; ++c) {
        for (int p = 0; p < 11; ++p) {
          proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[t][b][c][p])
                                  ? static_cast<uint8_t>(br.value_bits(8))
                                  : kCoeffsProba0[t][b][c][p];
        }
      }
    }
  }
  use_skip = br.value_bits(1);
  if (use_skip) skip_p = br.value_bits(8);

  // filter strengths per segment and 4x4-ness (PrecomputeFilterStrengths)
  for (int s = 0; s < 4; ++s) {
    int base = level;
    if (use_segment) base = seg_filter[s] + (absolute_delta ? 0 : level);
    for (int i4 = 0; i4 <= 1; ++i4) {
      int lv = base;
      if (use_lf_delta) {
        lv += ref_lf_delta[0];
        if (i4) lv += mode_lf_delta[0];
      }
      lv = clip(lv, 63);
      f_limit[s][i4] = 0;
      f_ilevel[s][i4] = 0;
      f_hev[s][i4] = 0;
      if (lv > 0) {
        int ilevel = lv;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        f_ilevel[s][i4] = ilevel;
        f_limit[s][i4] = 2 * lv + ilevel;
        f_hev[s][i4] = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
      }
    }
  }

  // modes and residuals, row by row, each row reconstructed once read
  ystride = mb_w * 16;
  uvstride = mb_w * 8;
  Y.assign(static_cast<size_t>(ystride) * mb_h * 16, 0);
  U.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
  V.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
  mbs.assign(mb_w, MB());
  finfo.assign(static_cast<size_t>(mb_w) * mb_h, FilterInfo());
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
  std::vector<uint8_t> t_nz(mb_w, 0), t_dc(mb_w, 0);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      parse_modes(mbs[mb_x], &intra_t[4 * mb_x], intra_l);
    }
    if (br.eof) fail("VP8: premature end of partition 0");
    BoolReader& tbr = parts[mb_y & (num_parts - 1)];
    uint8_t l_nz = 0, l_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MB& mb = mbs[mb_x];
      int skip = use_skip ? mb.skip : 0;
      if (!skip) {
        skip = parse_residuals(mb, tbr, t_nz[mb_x], l_nz, t_dc[mb_x], l_dc);
      } else {
        l_nz = t_nz[mb_x] = 0;
        if (!mb.is_i4x4) l_dc = t_dc[mb_x] = 0;
        mb.nz_y = mb.nz_uv = 0;
        std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
      }
      FilterInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
      f.segment = static_cast<uint8_t>(mb.segment);
      f.is_i4x4 = static_cast<uint8_t>(mb.is_i4x4);
      f.inner = static_cast<uint8_t>(mb.is_i4x4 | !skip);
      if (tbr.eof) fail("VP8: premature end of the token partition");
    }
    reconstruct_row(mb_y);
  }
}

}  // namespace

// --- VP8: prediction, reconstruction, loop filter, colour ------------------------------

namespace {

constexpr int BPS = 32;  // the work buffer's stride, as libwebp's

inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

// 16x16 luma or 8x8 chroma prediction; `mode` B_DC / B_TM / B_VE / B_HE,
// DC with the edges it lacks left out as libwebp's CheckMode picks them.
void predict_block(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  if (mode == B_DC) {
    int dc = 0;
    if (has_top && has_left) {
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, (dc + size) >> (shift + 1), size);
    } else if (has_left) {
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, (dc + (size >> 1)) >> shift, size);
    } else if (has_top) {
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, (dc + (size >> 1)) >> shift, size);
    } else {
      fill(dst, 0x80, size);
    }
  } else if (mode == B_TM) {
    true_motion(dst, size);
  } else if (mode == B_VE) {
    for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
  } else {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, dc, 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE:
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
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
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          static_cast<uint8_t>(L);
      break;
    default:  // B_HD
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
  }
}

#undef DST

// libwebp's DoTransform by a block's non-zero code: 3 (a coefficient past
// the third) the SIMD transform, 2 and 1 (the DC and at most two ACs) its C
// transforms, which transform_one equals, 0 none.
void transform_block(uint32_t code, const int16_t* in, uint8_t* dst) {
  if (code == 3) {
    transform_simd(in, dst, BPS);
  } else if (code) {
    transform_one(in, dst, BPS);
  }
}

// Reconstructs a row of macroblocks into the padded planes; the loop
// filter runs over the whole frame afterwards (intra prediction reads
// unfiltered samples).  Each block goes through a work buffer laid out as
// libwebp's: the row above (127 on the first row, with the 4 samples
// above-right), the column to the left (129 on the first column) and the
// corner.
void Vp8::reconstruct_row(int mb_y) {
  uint8_t work[3][17 * BPS + BPS];
  for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
    const MB& mb = mbs[mb_x];
    for (int plane = 0; plane < 3; ++plane) {
      const int size = plane == 0 ? 16 : 8;
      const int stride = plane == 0 ? ystride : uvstride;
      uint8_t* img = plane == 0 ? Y.data() : plane == 1 ? U.data() : V.data();
      uint8_t* dst = work[plane] + BPS + 1;  // (0, 0)
      const int x0 = mb_x * size, y0 = mb_y * size;
      const int extra = plane == 0 ? 4 : 0;
      if (mb_y == 0) {
        std::memset(dst - BPS - 1, 127, size + extra + 1);
      } else {
        const uint8_t* above = img + static_cast<size_t>(y0 - 1) * stride;
        dst[-BPS - 1] = mb_x == 0 ? 129 : above[x0 - 1];
        std::memcpy(dst - BPS, above + x0, size);
        if (extra) {
          for (int i = 0; i < 4; ++i) {
            dst[-BPS + 16 + i] = mb_x == mb_w - 1 ? above[x0 + 15] : above[x0 + 16 + i];
          }
        }
      }
      for (int j = 0; j < size; ++j) {
        dst[j * BPS - 1] = mb_x == 0 ? 129 : img[static_cast<size_t>(y0 + j) * stride + x0 - 1];
      }
      if (plane == 0) {
        if (mb.is_i4x4) {
          for (int k = 1; k < 4; ++k) std::memcpy(dst + (4 * k - 1) * BPS + 16, dst - BPS + 16, 4);
          uint32_t bits = mb.nz_y;
          for (int n = 0; n < 16; ++n, bits <<= 2) {
            uint8_t* b = dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            predict4(b, mb.imodes[n]);
            transform_block(bits >> 30, mb.coeffs + n * 16, b);
          }
        } else {
          predict_block(dst, 16, mb.imodes[0], mb_y > 0, mb_x > 0);
          uint32_t bits = mb.nz_y;
          for (int n = 0; n < 16; ++n, bits <<= 2) {
            transform_block(bits >> 30, mb.coeffs + n * 16, dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
          }
        }
      } else {
        predict_block(dst, 8, mb.uvmode, mb_y > 0, mb_x > 0);
        const uint32_t bits = mb.nz_uv >> (plane == 1 ? 0 : 8);
        if (bits & 0xff) {  // libwebp's DoUVTransform: SIMD if any AC coefficient
          const int16_t* c = mb.coeffs + (plane == 1 ? 16 : 20) * 16;
          for (int n = 0; n < 4; ++n) {
            uint8_t* b = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
            if (bits & 0xaa) {
              transform_simd(c + n * 16, b, BPS);
            } else {
              transform_one(c + n * 16, b, BPS);
            }
          }
        }
      }
      for (int j = 0; j < size; ++j) {
        std::memcpy(img + static_cast<size_t>(y0 + j) * stride + x0, dst + j * BPS, size);
      }
    }
  }
}

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `hstride` across the edge, `vstride` along it; `inner` picks the 4-tap
// filter of inner edges over the 6-tap one of macroblock edges.
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool inner) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else if (inner) {
        do_filter4(p, hstride);
      } else {
        do_filter6(p, hstride);
      }
    }
    p += vstride;
  }
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (needs_filter(p + i * vstride, hstride, thresh2)) do_filter2(p + i * vstride, hstride);
  }
}

// libwebp's DoFilter for one macroblock: its left edge, its inner vertical
// edges, its top edge and its inner horizontal edges, in that order.
void filter_mb(int type, uint8_t* y, uint8_t* u, uint8_t* v, int ys, int uvs, int mb_x, int mb_y,
               int limit, int ilevel, int hev_t, int inner) {
  if (type == 1) {
    if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
    if (inner) {
      for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k, 1, ys, limit);
    }
    if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
    if (inner) {
      for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k * ys, ys, 1, limit);
    }
    return;
  }
  if (mb_x > 0) {
    filter_loop(y, 1, ys, 16, limit + 4, ilevel, hev_t, false);
    filter_loop(u, 1, uvs, 8, limit + 4, ilevel, hev_t, false);
    filter_loop(v, 1, uvs, 8, limit + 4, ilevel, hev_t, false);
  }
  if (inner) {
    for (int k = 1; k < 4; ++k) filter_loop(y + 4 * k, 1, ys, 16, limit, ilevel, hev_t, true);
    filter_loop(u + 4, 1, uvs, 8, limit, ilevel, hev_t, true);
    filter_loop(v + 4, 1, uvs, 8, limit, ilevel, hev_t, true);
  }
  if (mb_y > 0) {
    filter_loop(y, ys, 1, 16, limit + 4, ilevel, hev_t, false);
    filter_loop(u, uvs, 1, 8, limit + 4, ilevel, hev_t, false);
    filter_loop(v, uvs, 1, 8, limit + 4, ilevel, hev_t, false);
  }
  if (inner) {
    for (int k = 1; k < 4; ++k) filter_loop(y + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t, true);
    filter_loop(u + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, true);
    filter_loop(v + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, true);
  }
}

void Vp8::loop_filter() {
  if (filter_type == 0) return;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const FilterInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
      const int limit = f_limit[f.segment][f.is_i4x4];
      if (limit == 0) continue;
      filter_mb(filter_type, &Y[static_cast<size_t>(mb_y) * 16 * ystride + mb_x * 16],
                &U[static_cast<size_t>(mb_y) * 8 * uvstride + mb_x * 8],
                &V[static_cast<size_t>(mb_y) * 8 * uvstride + mb_x * 8], ystride, uvstride, mb_x,
                mb_y, limit, f_ilevel[f.segment][f.is_i4x4], f_hev[f.segment][f.is_i4x4],
                f.inner);
    }
  }
}

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return static_cast<uint8_t>((v & ~16383) == 0 ? (v >> 6) : v < 0 ? 0 : 255);
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// libwebp's fancy upsampler for one output row: chroma rows `near` (weight
// 3) and `far` (weight 1), interpolated 3:1 across columns as well.
void upsample_row(const uint8_t* y, const uint8_t* near_u, const uint8_t* near_v,
                  const uint8_t* far_u, const uint8_t* far_v, uint8_t* out, int len) {
  auto load = [](const uint8_t* u, const uint8_t* v, int x) -> uint32_t {
    return u[x] | (static_cast<uint32_t>(v[x]) << 16);
  };
  // libwebp computes the top row of a pair from (tl, t) = its near row and
  // (l, cur) = its far row; both rows share the diagonals.
  uint32_t tl = load(near_u, near_v, 0), l = load(far_u, far_v, 0);
  uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
  yuv_to_rgb(y[0], uv0 & 0xff, uv0 >> 16, out);
  const int last_pair = (len - 1) >> 1;
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t = load(near_u, near_v, x), uv = load(far_u, far_v, x);
    const uint32_t avg = tl + t + l + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t + l)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl + uv)) >> 3;
    const uint32_t a = (diag_12 + tl) >> 1;
    const uint32_t b = (diag_03 + t) >> 1;
    yuv_to_rgb(y[2 * x - 1], a & 0xff, a >> 16, out + (2 * x - 1) * 3);
    yuv_to_rgb(y[2 * x], b & 0xff, b >> 16, out + 2 * x * 3);
    tl = t;
    l = uv;
  }
  if (!(len & 1)) {
    uv0 = (3 * tl + l + 0x00020002u) >> 2;
    yuv_to_rgb(y[len - 1], uv0 & 0xff, uv0 >> 16, out + (len - 1) * 3);
  }
}

}  // namespace

// Decodes the VP8 key frame `src[0:n]` (a "VP8 " chunk's payload) of a
// `width` x `height` image into `out` (RGB, `width * 3` bytes a row), as
// libwebp decodes it to BGR with fancy upsampling.  Returns 0, or -1 with a
// message.
extern "C" int64_t rcnn_webp_vp8_decode(const uint8_t* src, int64_t n, int64_t width,
                                        int64_t height, uint8_t* out, char* msg, int64_t msg_len) {
  if (src == nullptr || out == nullptr || n < 0) return -1;
  try {
    Vp8 dec;
    dec.parse(src, static_cast<size_t>(n));
    dec.loop_filter();
    if (dec.width != width || dec.height != height) fail("VP8: sides differ from the caller's");
    const int w = dec.width, h = dec.height;
    const int ys = dec.ystride, uvs = dec.uvstride;
    const uint8_t* Y = dec.Y.data();
    const uint8_t* U = dec.U.data();
    const uint8_t* V = dec.V.data();
    const int uv_h = (h + 1) / 2;
    for (int row = 0; row < h; ++row) {
      // row 2k - 1 takes chroma row k - 1 as its near one and k as its far
      // one, row 2k the reverse; the first row and an even last row mirror.
      int near_row, far_row;
      if (row == 0) {
        near_row = far_row = 0;
      } else if (row & 1) {
        near_row = (row - 1) >> 1;
        far_row = std::min((row + 1) >> 1, uv_h - 1);
      } else {
        near_row = row >> 1;
        far_row = (row >> 1) - 1;
      }
      upsample_row(Y + static_cast<size_t>(row) * ys, U + static_cast<size_t>(near_row) * uvs,
                   V + static_cast<size_t>(near_row) * uvs, U + static_cast<size_t>(far_row) * uvs,
                   V + static_cast<size_t>(far_row) * uvs, out + static_cast<size_t>(row) * w * 3, w);
    }
    return 0;
  } catch (const Failure& f) {
    set_message(msg, msg_len, f.what);
  } catch (const std::bad_alloc&) {
    set_message(msg, msg_len, "VP8: out of memory");
  }
  return -1;
}
