// VP8 decoder (RFC 6386) in host C++: what FFmpeg's native vp8 decoder
// gives cv2.VideoCapture, frame for frame.  VP8's reconstruction is exact
// integer arithmetic, so the rules below are FFmpeg's where it chooses
// between readings of the RFC:
//
//   * the loop filter type comes from the header's filter_type bit; the
//     version picks only the motion-compensation filter (0: six-tap, else
//     bilinear) and full-pel chroma (3);
//   * the key frame's upscaling bits are ignored: frames decode at the
//     coded size, cropped from the macroblock grid;
//   * motion compensation reads references edge-extended from the
//     macroblock-aligned planes; intra prediction reads the unfiltered
//     reconstruction (127 above the frame, 129 left of it), and a
//     subblock at the frame's right edge takes the pixel above the
//     macroblock's last column for its above-right;
//   * golden and altref copies take the references as they were before
//     this frame (sign_bias, copy_buffer_to_*), then this frame's refresh;
//   * a frame with show_frame = 0 updates the references and hands over
//     no picture; a frame FFmpeg refuses (a first partition past the end
//     of the data, an inter frame before any key frame, a bad start code)
//     is an error.
//
// Output: yuv420p planes at the header's size; io/vp8.py converts them with
// swscale's arithmetic (runtime/mpeg4.i420_to_bgr).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// RFC 6386 13.5: default token probabilities [block type][band][context][node]
const uint8_t kDefaultCoefProbs[4][8][3][11] = {
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

// RFC 6386 13.4: the probabilities that a token probability is updated
const uint8_t kCoefUpdateProbs[4][8][3][11] = {
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

// RFC 6386 11.5: key-frame subblock mode probabilities [above][left][node]
const uint8_t kKfBmodeProbs[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// RFC 6386 14.1: quantiser index -> DC and AC step
const int kDcQ[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const int kAcQ[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// RFC 6386 17.2: default and update probabilities of the motion vectors
const uint8_t kMvDefaultProbs[2][19] = {
    162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254,
    164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254,
};
const uint8_t kMvUpdateProbs[2][19] = {
    237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254,
    231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254, 254,
};

const uint8_t kCoefBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kPcat[6][12] = {
    {159},
    {165, 145},
    {173, 148, 140},
    {176, 155, 140, 135},
    {180, 157, 141, 134, 130},
    {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129},
};
const int kCatBase[6] = {5, 7, 11, 19, 35, 67};

// 16x16 and chroma modes
enum { DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED };
// subblock modes, libvpx's order
enum { B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU };
// inter modes
enum { MV_NEAREST = 5, MV_NEAR, MV_ZERO, MV_NEW, MV_SPLIT };
enum { REF_INTRA, REF_LAST, REF_GOLDEN, REF_ALTREF };

const int8_t kYmodeTree[8] = {-DC_PRED, 2, 4, 6, -V_PRED, -H_PRED, -TM_PRED, -B_PRED};
const int8_t kKfYmodeTree[8] = {-B_PRED, 2, 4, 6, -DC_PRED, -V_PRED, -H_PRED, -TM_PRED};
const int8_t kUvModeTree[6] = {-DC_PRED, 2, -V_PRED, 4, -H_PRED, -TM_PRED};
const int8_t kBmodeTree[18] = {-B_DC, 2, -B_TM, 4, -B_VE, 6, 8, 12, -B_HE, 10,
                               -B_RD, -B_VR, -B_LD, 14, -B_VL, 16, -B_HD, -B_HU};
const uint8_t kKfYmodeProbs[4] = {145, 156, 163, 128};
const uint8_t kKfUvModeProbs[3] = {142, 114, 183};
const uint8_t kYmodeProbs[4] = {112, 86, 140, 37};
const uint8_t kUvModeProbs[3] = {162, 101, 204};
const uint8_t kBmodeProbs[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
const uint8_t kModeContexts[6][4] = {
    {7, 1, 1, 143}, {14, 18, 14, 107}, {135, 64, 57, 68},
    {60, 56, 128, 65}, {159, 134, 128, 34}, {234, 188, 128, 28},
};
const uint8_t kMbsplitProbs[3] = {110, 111, 150};
const uint8_t kSubMvRefProbs[5][3] = {
    {147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34}, {208, 1, 1},
};
// partition of each subblock: 16x8, 8x16, 8x8, 4x4
const uint8_t kMbsplits[4][16] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
};
const int kMbsplitCount[4] = {2, 2, 4, 16};
const int kSixtap[8][6] = {
    {0, 0, 128, 0, 0, 0},     {0, -6, 123, 12, -1, 0}, {2, -11, 108, 36, -8, 1},
    {0, -9, 93, 50, -6, 0},   {3, -16, 77, 77, -16, 3}, {0, -6, 50, 93, -9, 0},
    {1, -8, 36, 108, -11, 2}, {0, -1, 12, 123, -6, 0},
};

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int clamp(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

struct Error : std::runtime_error {
    int code;
    Error(int c, const std::string& m) : std::runtime_error(m), code(c) {}
};
constexpr int OK = 0, NO_FRAME = 1, UNSUPPORTED = 2, CORRUPT = 3;
// bytes a partition may be read past its end (an encoder's flush leaves at
// most the two of the window) before the frame counts as truncated
constexpr int kMaxOverrun = 16;

// ------------------------------------------------------- boolean decoder
// RFC 6386 section 7: two bytes of window, refilled a byte at a time;
// past the end of the data it reads zeros, as FFmpeg's and libvpx's do.

struct BoolDecoder {
    const uint8_t* p = nullptr;
    const uint8_t* end = nullptr;
    uint32_t value = 0, range = 255;
    int bit_count = 0;
    int overrun = 0;  // bytes read past the end

    void init(const uint8_t* data, size_t n) {
        p = data;
        end = data + n;
        value = 0;
        for (int i = 0; i < 2; i++) value = (value << 8) | next();
        range = 255;
        bit_count = 0;
        overrun = 0;
    }
    uint32_t next() {
        if (p < end) return *p++;
        overrun++;
        return 0;
    }
    int get(int prob) {
        const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
        const uint32_t big = split << 8;
        int bit;
        if (value >= big) {
            bit = 1;
            range -= split;
            value -= big;
        } else {
            bit = 0;
            range = split;
        }
        if (range < 128) {  // renormalise: the bit-at-a-time loop, at once
            const int shift = __builtin_clz(range) - 24;
            value <<= shift;
            range <<= shift;
            bit_count += shift;
            if (bit_count >= 8) {
                bit_count -= 8;
                value |= next() << bit_count;
            }
        }
        return bit;
    }
    int bit() { return get(128); }
    int lit(int n) {
        int v = 0;
        while (n--) v = (v << 1) | bit();
        return v;
    }
    // a flag, then n bits and a sign; 0 without the flag
    int sint(int n) {
        if (!bit()) return 0;
        const int v = lit(n);
        return bit() ? -v : v;
    }
    int tree(const int8_t* t, const uint8_t* probs, int i = 0) {
        while ((i = t[i + get(probs[i >> 1])]) > 0) {
        }
        return -i;
    }
};

// ------------------------------------------------------------ frames

struct Plane {
    int w = 0, h = 0;  // the macroblock-aligned size
    std::vector<uint8_t> px;
    uint8_t* row(int y) { return px.data() + (size_t)y * w; }
    const uint8_t* row(int y) const { return px.data() + (size_t)y * w; }
    uint8_t at(int x, int y) const { return px[(size_t)clamp(y, 0, h - 1) * w + clamp(x, 0, w - 1)]; }
};

struct Image {
    Plane p[3];
    Image(int mbw, int mbh) {
        p[0].w = 16 * mbw;
        p[0].h = 16 * mbh;
        p[1].w = p[2].w = 8 * mbw;
        p[1].h = p[2].h = 8 * mbh;
        for (auto& q : p) q.px.assign((size_t)q.w * q.h, 0);
    }
};
using ImagePtr = std::shared_ptr<Image>;

struct MV {
    int16_t x = 0, y = 0;  // quarter pel (chroma: eighth pel)
    bool operator==(const MV& o) const { return x == o.x && y == o.y; }
    bool operator!=(const MV& o) const { return !(*this == o); }
    bool zero() const { return !x && !y; }
};

struct MbInfo {
    uint8_t ymode = DC_PRED, uvmode = DC_PRED, ref = REF_INTRA, segment = 0;
    uint8_t skip = 0;           // no coefficients (after decoding tokens)
    uint8_t partitioning = 0;   // split MV layout, for SPLITMV
    MV mv;
    MV bmv[16];
    uint8_t bmodes[16];         // subblock modes (implied for 16x16 modes)
};

struct Probs {
    uint8_t coef[4][8][3][11];
    uint8_t ymode[4];
    uint8_t uvmode[3];
    uint8_t mv[2][19];
};

// header features seen, reported to the caller (io/vp8: which fixture
// holds which part of the decoder)
enum Feature {
    F_SEGMENTATION = 1 << 0, F_SEGMENT_MAP = 1 << 1, F_LF_DELTAS = 1 << 2,
    F_PARTITIONS = 1 << 3, F_GOLDEN = 1 << 4, F_ALTREF = 1 << 5, F_COPY = 1 << 6,
    F_SIGN_BIAS = 1 << 7, F_NO_PROB_REFRESH = 1 << 8, F_SIMPLE_FILTER = 1 << 9,
    F_HIDDEN = 1 << 10, F_BPRED = 1 << 11, F_SPLITMV = 1 << 12, F_BILINEAR = 1 << 13,
    F_FULLPEL = 1 << 14, F_COEF_UPDATE = 1 << 15, F_MV_UPDATE = 1 << 16,
    F_MODE_UPDATE = 1 << 17, F_NO_SKIP = 1 << 18, F_QDELTA = 1 << 19,
    F_SHARPNESS = 1 << 20, F_GOLDEN_REF = 1 << 21, F_ALTREF_REF = 1 << 22,
    F_NEARMV = 1 << 23, F_NEWMV = 1 << 24, F_NO_LAST_REFRESH = 1 << 25,
    F_NO_FILTER = 1 << 26, F_INTRA_IN_INTER = 1 << 27,
};

// --------------------------------------------------------- transforms

// the inverse WHT of the Y2 block: DC of each luma subblock (int16 lanes)
void iwht(const int16_t* in, int16_t* dc_out) {
    int16_t t[16];
    for (int i = 0; i < 4; i++) {
        const int a1 = in[i] + in[12 + i], b1 = in[4 + i] + in[8 + i];
        const int c1 = in[4 + i] - in[8 + i], d1 = in[i] - in[12 + i];
        t[i] = (int16_t)(a1 + b1);
        t[4 + i] = (int16_t)(c1 + d1);
        t[8 + i] = (int16_t)(a1 - b1);
        t[12 + i] = (int16_t)(d1 - c1);
    }
    for (int i = 0; i < 4; i++) {
        const int a1 = t[4 * i] + t[4 * i + 3], b1 = t[4 * i + 1] + t[4 * i + 2];
        const int c1 = t[4 * i + 1] - t[4 * i + 2], d1 = t[4 * i] - t[4 * i + 3];
        dc_out[4 * i] = (int16_t)((a1 + b1 + 3) >> 3);
        dc_out[4 * i + 1] = (int16_t)((c1 + d1 + 3) >> 3);
        dc_out[4 * i + 2] = (int16_t)((a1 - b1 + 3) >> 3);
        dc_out[4 * i + 3] = (int16_t)((d1 - c1 + 3) >> 3);
    }
}

inline int mul20091(int a) { return ((a * 20091) >> 16) + a; }
inline int mul35468(int a) { return (a * 35468) >> 16; }

// the inverse DCT of a 4x4 block (raster order), added to dst
void idct_add(const int16_t* b, uint8_t* dst, int stride) {
    int16_t t[16];
    for (int i = 0; i < 4; i++) {
        const int t0 = b[i] + b[8 + i], t1 = b[i] - b[8 + i];
        const int t2 = mul35468(b[4 + i]) - mul20091(b[12 + i]);
        const int t3 = mul20091(b[4 + i]) + mul35468(b[12 + i]);
        t[4 * i] = (int16_t)(t0 + t3);
        t[4 * i + 1] = (int16_t)(t1 + t2);
        t[4 * i + 2] = (int16_t)(t1 - t2);
        t[4 * i + 3] = (int16_t)(t0 - t3);
    }
    for (int i = 0; i < 4; i++, dst += stride) {
        const int t0 = t[i] + t[8 + i], t1 = t[i] - t[8 + i];
        const int t2 = mul35468(t[4 + i]) - mul20091(t[12 + i]);
        const int t3 = mul20091(t[4 + i]) + mul35468(t[12 + i]);
        dst[0] = clip8(dst[0] + ((t0 + t3 + 4) >> 3));
        dst[1] = clip8(dst[1] + ((t1 + t2 + 4) >> 3));
        dst[2] = clip8(dst[2] + ((t1 - t2 + 4) >> 3));
        dst[3] = clip8(dst[3] + ((t0 - t3 + 4) >> 3));
    }
}

// ------------------------------------------------------ intra prediction

// a 16x16 (n = 16) or 8x8 (n = 8) block from its edges: above[-1..n-1]
// (above[-1] the corner), left[0..n-1]; have_above/have_left for DC
void predict_mb(int mode, uint8_t* dst, int stride, int n, const uint8_t* above,
                const uint8_t* left, bool have_above, bool have_left) {
    switch (mode) {
    case DC_PRED: {
        int v = 128;
        const int shift = n == 16 ? 3 : 2;
        if (have_above || have_left) {
            int sum = 0;
            if (have_above)
                for (int i = 0; i < n; i++) sum += above[i];
            if (have_left)
                for (int i = 0; i < n; i++) sum += left[i];
            const int s = shift + have_above + have_left;
            v = (sum + (1 << (s - 1))) >> s;
        }
        for (int r = 0; r < n; r++) memset(dst + r * stride, v, n);
        break;
    }
    case V_PRED:
        for (int r = 0; r < n; r++) memcpy(dst + r * stride, above, n);
        break;
    case H_PRED:
        for (int r = 0; r < n; r++) memset(dst + r * stride, left[r], n);
        break;
    default:  // TM_PRED
        for (int r = 0; r < n; r++)
            for (int c = 0; c < n; c++)
                dst[r * stride + c] = clip8(left[r] + above[c] - above[-1]);
    }
}

inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }
inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }

// a 4x4 subblock: A[-1..7] above (A[-1] the corner, A[4..7] above-right),
// L[0..3] left
void predict_sub(int mode, uint8_t* d, int s, const uint8_t* A, const uint8_t* L) {
    auto D = [&](int r, int c) -> uint8_t& { return d[r * s + c]; };
    const int P = A[-1];
    switch (mode) {
    case B_DC: {
        int v = 4;
        for (int i = 0; i < 4; i++) v += A[i] + L[i];
        v >>= 3;
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++) D(r, c) = (uint8_t)v;
        break;
    }
    case B_TM:
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++) D(r, c) = clip8(L[r] + A[c] - P);
        break;
    case B_VE:
        for (int c = 0; c < 4; c++) {
            const uint8_t v = avg3(A[c - 1], A[c], A[c + 1]);
            for (int r = 0; r < 4; r++) D(r, c) = v;
        }
        break;
    case B_HE: {
        const uint8_t v[4] = {avg3(P, L[0], L[1]), avg3(L[0], L[1], L[2]),
                              avg3(L[1], L[2], L[3]), avg3(L[2], L[3], L[3])};
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++) D(r, c) = v[r];
        break;
    }
    case B_LD:
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++) {
                const int i = r + c;
                D(r, c) = i < 6 ? avg3(A[i], A[i + 1], A[i + 2]) : avg3(A[6], A[7], A[7]);
            }
        break;
    case B_RD: {
        const int pp[9] = {L[3], L[2], L[1], L[0], P, A[0], A[1], A[2], A[3]};
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++) {
                const int i = 3 - r + c;
                D(r, c) = avg3(pp[i], pp[i + 1], pp[i + 2]);
            }
        break;
    }
    case B_VR: {
        const int pp[9] = {L[3], L[2], L[1], L[0], P, A[0], A[1], A[2], A[3]};
        D(3, 0) = avg3(pp[1], pp[2], pp[3]);
        D(2, 0) = avg3(pp[2], pp[3], pp[4]);
        D(3, 1) = D(1, 0) = avg3(pp[3], pp[4], pp[5]);
        D(2, 1) = D(0, 0) = avg2(pp[4], pp[5]);
        D(3, 2) = D(1, 1) = avg3(pp[4], pp[5], pp[6]);
        D(2, 2) = D(0, 1) = avg2(pp[5], pp[6]);
        D(3, 3) = D(1, 2) = avg3(pp[5], pp[6], pp[7]);
        D(2, 3) = D(0, 2) = avg2(pp[6], pp[7]);
        D(1, 3) = avg3(pp[6], pp[7], pp[8]);
        D(0, 3) = avg2(pp[7], pp[8]);
        break;
    }
    case B_VL:
        D(0, 0) = avg2(A[0], A[1]);
        D(1, 0) = avg3(A[0], A[1], A[2]);
        D(2, 0) = D(0, 1) = avg2(A[1], A[2]);
        D(1, 1) = D(3, 0) = avg3(A[1], A[2], A[3]);
        D(2, 1) = D(0, 2) = avg2(A[2], A[3]);
        D(3, 1) = D(1, 2) = avg3(A[2], A[3], A[4]);
        D(0, 3) = D(2, 2) = avg2(A[3], A[4]);
        D(1, 3) = D(3, 2) = avg3(A[3], A[4], A[5]);
        D(2, 3) = avg3(A[4], A[5], A[6]);
        D(3, 3) = avg3(A[5], A[6], A[7]);
        break;
    case B_HD: {
        const int pp[9] = {L[3], L[2], L[1], L[0], P, A[0], A[1], A[2], A[3]};
        D(3, 0) = avg2(pp[0], pp[1]);
        D(3, 1) = avg3(pp[0], pp[1], pp[2]);
        D(2, 0) = D(3, 2) = avg2(pp[1], pp[2]);
        D(2, 1) = D(3, 3) = avg3(pp[1], pp[2], pp[3]);
        D(2, 2) = D(1, 0) = avg2(pp[2], pp[3]);
        D(2, 3) = D(1, 1) = avg3(pp[2], pp[3], pp[4]);
        D(1, 2) = D(0, 0) = avg2(pp[3], pp[4]);
        D(1, 3) = D(0, 1) = avg3(pp[3], pp[4], pp[5]);
        D(0, 2) = avg3(pp[4], pp[5], pp[6]);
        D(0, 3) = avg3(pp[5], pp[6], pp[7]);
        break;
    }
    default: {  // B_HU
        D(0, 0) = avg2(L[0], L[1]);
        D(0, 1) = avg3(L[0], L[1], L[2]);
        D(0, 2) = D(1, 0) = avg2(L[1], L[2]);
        D(0, 3) = D(1, 1) = avg3(L[1], L[2], L[3]);
        D(1, 2) = D(2, 0) = avg2(L[2], L[3]);
        D(1, 3) = D(2, 1) = avg3(L[2], L[3], L[3]);
        D(2, 2) = D(2, 3) = D(3, 0) = D(3, 1) = D(3, 2) = D(3, 3) = (uint8_t)L[3];
    }
    }
}

// ------------------------------------------------- motion compensation

// a bw x bh block at (x, y) of ref displaced by (ix, iy) whole pixels and
// (fx, fy) eighths, edge-extended outside the plane, into dst
void predict_inter(const Plane& ref, int x, int y, int bw, int bh, int ix, int iy, int fx,
                   int fy, bool bilinear, uint8_t* dst, int stride) {
    // the six-tap window: read in place, or copied edge-extended
    const int x0 = x + ix - 2, y0 = y + iy - 2;
    const int ww = bw + 5, wh = bh + 5;
    uint8_t win[21 * 21];
    const uint8_t* src;
    int ss;
    if (x0 >= 0 && y0 >= 0 && x0 + ww <= ref.w && y0 + wh <= ref.h) {
        src = ref.row(y0 + 2) + x0 + 2;
        ss = ref.w;
    } else {
        for (int r = 0; r < wh; r++)
            for (int c = 0; c < ww; c++) win[r * ww + c] = ref.at(x0 + c, y0 + r);
        src = win + 2 * ww + 2;
        ss = ww;
    }
    if (!fx && !fy) {
        for (int r = 0; r < bh; r++) memcpy(dst + r * stride, src + r * ss, bw);
        return;
    }
    if (bilinear) {
        uint8_t tmp[17 * 16];
        for (int r = 0; r < bh + 1; r++)
            for (int c = 0; c < bw; c++)
                tmp[r * bw + c] = (uint8_t)(((8 - fx) * src[r * ss + c] + fx * src[r * ss + c + 1] + 4) >> 3);
        for (int r = 0; r < bh; r++)
            for (int c = 0; c < bw; c++)
                dst[r * stride + c] =
                    (uint8_t)(((8 - fy) * tmp[r * bw + c] + fy * tmp[(r + 1) * bw + c] + 4) >> 3);
        return;
    }
    // six-tap: horizontal over bh + 5 rows, then vertical
    uint8_t tmp[21 * 16];
    const int* fh = kSixtap[fx];
    const int* fv = kSixtap[fy];
    for (int r = 0; r < bh + 5; r++) {
        const uint8_t* s = src + (r - 2) * ss;
        uint8_t* t = tmp + r * bw;
        if (!fx) {
            memcpy(t, s, bw);
            continue;
        }
        for (int c = 0; c < bw; c++) {
            const int v = fh[0] * s[c - 2] + fh[1] * s[c - 1] + fh[2] * s[c] + fh[3] * s[c + 1] +
                          fh[4] * s[c + 2] + fh[5] * s[c + 3];
            t[c] = clip8((v + 64) >> 7);
        }
    }
    for (int r = 0; r < bh; r++) {
        const uint8_t* t = tmp + (r + 2) * bw;
        uint8_t* d = dst + r * stride;
        if (!fy) {
            memcpy(d, t, bw);
            continue;
        }
        for (int c = 0; c < bw; c++) {
            const int v = fv[0] * t[c - 2 * bw] + fv[1] * t[c - bw] + fv[2] * t[c] + fv[3] * t[c + bw] +
                          fv[4] * t[c + 2 * bw] + fv[5] * t[c + 3 * bw];
            d[c] = clip8((v + 64) >> 7);
        }
    }
}

// ------------------------------------------------------------ loop filter

inline int c8(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }

struct EdgeParams {
    int E, I, hev;
};

// pixel i along the edge: p[-k * step] is p(k-1), p[k * step] q(k)
inline bool simple_limit(const uint8_t* p, int step, int E) {
    return 2 * std::abs(p[-step] - p[0]) + (std::abs(p[-2 * step] - p[step]) >> 1) <= E;
}

inline bool normal_limit(const uint8_t* p, int step, int E, int I) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    return simple_limit(p, step, E) && std::abs(p3 - p2) <= I && std::abs(p2 - p1) <= I &&
           std::abs(p1 - p0) <= I && std::abs(q3 - q2) <= I && std::abs(q2 - q1) <= I &&
           std::abs(q1 - q0) <= I;
}

inline bool high_edge_variance(const uint8_t* p, int step, int t) {
    return std::abs(p[-2 * step] - p[-step]) > t || std::abs(p[step] - p[0]) > t;
}

// FFmpeg's filter_common: p0/q0 by the 3(q0 - p0) [+ (p1 - q1)] step;
// p1/q1 too without the outer taps
inline void filter_common(uint8_t* p, int step, bool is4tap) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    int a = 3 * (q0 - p0);
    if (is4tap) a += c8(p1 - q1);
    a = c8(a);
    const int f1 = std::min(a + 4, 127) >> 3;
    const int f2 = std::min(a + 3, 127) >> 3;
    p[-step] = clip8(p0 + f2);
    p[0] = clip8(q0 - f1);
    if (!is4tap) {
        a = (f1 + 1) >> 1;
        p[-2 * step] = clip8(p1 + a);
        p[step] = clip8(q1 - a);
    }
}

inline void filter_mbedge(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    int w = c8(p1 - q1);
    w = c8(w + 3 * (q0 - p0));
    const int a0 = (27 * w + 63) >> 7, a1 = (18 * w + 63) >> 7, a2 = (9 * w + 63) >> 7;
    p[-3 * step] = clip8(p2 + a2);
    p[-2 * step] = clip8(p1 + a1);
    p[-step] = clip8(p0 + a0);
    p[0] = clip8(q0 - a0);
    p[step] = clip8(q1 - a1);
    p[2 * step] = clip8(q2 - a2);
}

// n pixels along an edge at p; step crosses the edge, along walks it
void edge_normal(uint8_t* p, int step, int along, int n, const EdgeParams& e, bool mb) {
    for (int i = 0; i < n; i++, p += along) {
        if (!normal_limit(p, step, e.E, e.I)) continue;
        if (high_edge_variance(p, step, e.hev))
            filter_common(p, step, true);
        else if (mb)
            filter_mbedge(p, step);
        else
            filter_common(p, step, false);
    }
}

void edge_simple(uint8_t* p, int step, int along, int n, int E) {
    for (int i = 0; i < n; i++, p += along)
        if (simple_limit(p, step, E)) filter_common(p, step, true);
}

// ----------------------------------------------------------- decoder

struct Decoder {
    int width = 0, height = 0, mbw = 0, mbh = 0;
    bool have_key = false;
    ImagePtr cur, last, golden, altref;
    Probs probs, saved;
    std::vector<MbInfo> mbs;          // (mbh + 1) x (mbw + 1), row 0 and column 0 the border
    std::vector<uint8_t> segmap;      // persists across frames
    int features = 0;

    // header state that persists across frames
    bool seg_enabled = false, seg_update_map = false, seg_abs = false;
    int seg_quant[4] = {0}, seg_lf[4] = {0};
    uint8_t seg_probs[3] = {255, 255, 255};
    bool lf_delta_enabled = false;
    int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};  // B_PRED, ZERO, MV, SPLIT
    int sign_bias[4] = {0};

    // per frame
    bool keyframe = false, simple_filter = false, bilinear = false, fullpel = false;
    bool clamping = false;   // the last key frame's clamping_type bit
    int filter_level = 0, sharpness = 0;
    int prob_skip = 0, prob_intra = 0, prob_last = 0, prob_golden = 0;
    bool skip_enabled = false;
    int nparts = 1;
    BoolDecoder hdr, parts[8];
    struct Quant {
        int y[2], y2[2], uv[2];
    } quant[4];

    // token contexts: above per MB column (4 Y, 2 U, 2 V, Y2), left per row
    std::vector<uint8_t> above_nz;
    uint8_t left_nz[9];
    std::vector<uint8_t> above_bmodes;  // 4 per MB column (key frames)
    uint8_t left_bmodes[4];

    MbInfo& mb(int mx, int my) { return mbs[(size_t)(my + 1) * (mbw + 1) + mx + 1]; }

    void reset_probs() {
        memcpy(probs.coef, kDefaultCoefProbs, sizeof probs.coef);
        memcpy(probs.ymode, kYmodeProbs, 4);
        memcpy(probs.uvmode, kUvModeProbs, 3);
        memcpy(probs.mv, kMvDefaultProbs, sizeof probs.mv);
    }

    void alloc(int w, int h) {
        width = w;
        height = h;
        mbw = (w + 15) / 16;
        mbh = (h + 15) / 16;
        segmap.assign((size_t)mbw * mbh, 0);
        last = golden = altref = nullptr;
    }

    // ---------------------------------------------------------- header
    void parse_header(const uint8_t* buf, size_t size, int* show) {
        if (size < 3) throw Error(CORRUPT, "a frame of fewer than 3 bytes");
        const uint32_t tag = buf[0] | buf[1] << 8 | buf[2] << 16;
        keyframe = !(tag & 1);
        const int version = (tag >> 1) & 7;
        *show = (tag >> 4) & 1;
        const size_t first = tag >> 5;
        buf += 3;
        size -= 3;
        bilinear = version != 0;
        fullpel = version == 3;
        if (bilinear) features |= F_BILINEAR;
        if (fullpel) features |= F_FULLPEL;
        if (!*show) features |= F_HIDDEN;
        if (keyframe) {
            if (size < 7) throw Error(CORRUPT, "a truncated key frame header");
            if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a)
                throw Error(CORRUPT, "a key frame without the start code");
            const int w = (buf[3] | buf[4] << 8) & 0x3fff;
            const int h = (buf[5] | buf[6] << 8) & 0x3fff;
            if (!w || !h) throw Error(CORRUPT, "a key frame of size 0");
            buf += 7;
            size -= 7;
            if (w != width || h != height || !cur) alloc(w, h);
        } else if (!have_key) {
            throw Error(CORRUPT, "an inter frame before any key frame");
        }
        if (first > size)
            throw Error(CORRUPT, "the first partition runs past the end of the frame");
        hdr.init(buf, first);
        const uint8_t* rest = buf + first;
        size_t rest_n = size - first;

        if (keyframe) {
            hdr.bit();  // colour space
            // clamping type: FFmpeg reconstructs with clamping either way, but
            // takes the bit as its full-range flag (the frame's colour range)
            clamping = hdr.bit();
            reset_probs();
            seg_enabled = seg_abs = false;
            std::fill(seg_quant, seg_quant + 4, 0);
            std::fill(seg_lf, seg_lf + 4, 0);
            lf_delta_enabled = false;
            std::fill(ref_lf_delta, ref_lf_delta + 4, 0);
            std::fill(mode_lf_delta, mode_lf_delta + 4, 0);
            sign_bias[REF_GOLDEN] = sign_bias[REF_ALTREF] = 0;
        }
        seg_enabled = hdr.bit();
        seg_update_map = false;
        if (seg_enabled) {
            features |= F_SEGMENTATION;
            seg_update_map = hdr.bit();
            const bool update_data = hdr.bit();
            if (update_data) {
                seg_abs = hdr.bit();
                for (int i = 0; i < 4; i++) seg_quant[i] = hdr.sint(7);
                for (int i = 0; i < 4; i++) seg_lf[i] = hdr.sint(6);
            }
            if (seg_update_map) {
                features |= F_SEGMENT_MAP;
                for (int i = 0; i < 3; i++) seg_probs[i] = hdr.bit() ? hdr.lit(8) : 255;
            }
        }
        simple_filter = hdr.bit();
        filter_level = hdr.lit(6);
        sharpness = hdr.lit(3);
        if (simple_filter) features |= F_SIMPLE_FILTER;
        if (!filter_level) features |= F_NO_FILTER;
        if (sharpness) features |= F_SHARPNESS;
        lf_delta_enabled = hdr.bit();
        if (lf_delta_enabled) {
            features |= F_LF_DELTAS;
            if (hdr.bit()) {
                for (int i = 0; i < 4; i++)
                    if (hdr.bit()) {
                        ref_lf_delta[i] = hdr.lit(6);
                        if (hdr.bit()) ref_lf_delta[i] = -ref_lf_delta[i];
                    }
                for (int i = 0; i < 4; i++)
                    if (hdr.bit()) {
                        mode_lf_delta[i] = hdr.lit(6);
                        if (hdr.bit()) mode_lf_delta[i] = -mode_lf_delta[i];
                    }
            }
        }
        // token partitions: 3-byte sizes, then the partitions
        nparts = 1 << hdr.lit(2);
        if (nparts > 1) features |= F_PARTITIONS;
        if (rest_n < (size_t)3 * (nparts - 1))
            throw Error(CORRUPT, "the partition sizes run past the end of the frame");
        const uint8_t* sizes = rest;
        rest += 3 * (nparts - 1);
        rest_n -= 3 * (nparts - 1);
        for (int i = 0; i < nparts - 1; i++) {
            const size_t n = sizes[3 * i] | sizes[3 * i + 1] << 8 | sizes[3 * i + 2] << 16;
            if (n > rest_n) throw Error(CORRUPT, "a token partition runs past the end of the frame");
            parts[i].init(rest, n);
            rest += n;
            rest_n -= n;
        }
        parts[nparts - 1].init(rest, rest_n);

        // quantisers
        const int yac = hdr.lit(7);
        const int ydc_d = hdr.sint(4), y2dc_d = hdr.sint(4), y2ac_d = hdr.sint(4);
        const int uvdc_d = hdr.sint(4), uvac_d = hdr.sint(4);
        if (ydc_d || y2dc_d || y2ac_d || uvdc_d || uvac_d) features |= F_QDELTA;
        for (int s = 0; s < 4; s++) {
            int q = yac;
            if (seg_enabled) q = seg_abs ? seg_quant[s] : yac + seg_quant[s];
            q = clamp(q, 0, 127);
            Quant& Q = quant[s];
            Q.y[0] = kDcQ[clamp(q + ydc_d, 0, 127)];
            Q.y[1] = kAcQ[q];
            Q.y2[0] = kDcQ[clamp(q + y2dc_d, 0, 127)] * 2;
            Q.y2[1] = std::max(kAcQ[clamp(q + y2ac_d, 0, 127)] * 101581 >> 16, 8);
            Q.uv[0] = std::min(kDcQ[clamp(q + uvdc_d, 0, 127)], 132);
            Q.uv[1] = kAcQ[clamp(q + uvac_d, 0, 127)];
        }

        if (!keyframe) {
            const int upd_golden = hdr.bit(), upd_altref = hdr.bit();
            golden_src = upd_golden ? SRC_CURRENT : hdr.lit(2);
            altref_src = upd_altref ? SRC_CURRENT : hdr.lit(2);
            sign_bias[REF_GOLDEN] = hdr.bit();
            sign_bias[REF_ALTREF] = hdr.bit();
            if (upd_golden) features |= F_GOLDEN;
            if (upd_altref) features |= F_ALTREF;
            if ((!upd_golden && golden_src) || (!upd_altref && altref_src)) features |= F_COPY;
            if (sign_bias[REF_GOLDEN] || sign_bias[REF_ALTREF]) features |= F_SIGN_BIAS;
        } else {
            golden_src = altref_src = SRC_CURRENT;
        }
        refresh_probs = hdr.bit();
        if (!refresh_probs) {
            saved = probs;
            features |= F_NO_PROB_REFRESH;
        }
        refresh_last = keyframe || hdr.bit();
        if (!refresh_last) features |= F_NO_LAST_REFRESH;
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 8; j++)
                for (int k = 0; k < 3; k++)
                    for (int l = 0; l < 11; l++)
                        if (hdr.get(kCoefUpdateProbs[i][j][k][l])) {
                            probs.coef[i][j][k][l] = (uint8_t)hdr.lit(8);
                            features |= F_COEF_UPDATE;
                        }
        skip_enabled = hdr.bit();
        prob_skip = skip_enabled ? hdr.lit(8) : 0;
        if (!skip_enabled) features |= F_NO_SKIP;
        if (!keyframe) {
            prob_intra = hdr.lit(8);
            prob_last = hdr.lit(8);
            prob_golden = hdr.lit(8);
            if (hdr.bit()) {
                for (int i = 0; i < 4; i++) probs.ymode[i] = (uint8_t)hdr.lit(8);
                features |= F_MODE_UPDATE;
            }
            if (hdr.bit()) {
                for (int i = 0; i < 3; i++) probs.uvmode[i] = (uint8_t)hdr.lit(8);
                features |= F_MODE_UPDATE;
            }
            for (int i = 0; i < 2; i++)
                for (int j = 0; j < 19; j++)
                    if (hdr.get(kMvUpdateProbs[i][j])) {
                        const int x = hdr.lit(7);
                        probs.mv[i][j] = (uint8_t)(x ? x << 1 : 1);
                        features |= F_MV_UPDATE;
                    }
        }
    }

    enum { SRC_NONE = 0, SRC_LAST = 1, SRC_OTHER = 2, SRC_CURRENT = 3 };
    int golden_src = SRC_NONE, altref_src = SRC_NONE;
    bool refresh_probs = true, refresh_last = true;

    // ------------------------------------------------------------ modes
    int read_mv_component(const uint8_t* p) {
        int x = 0;
        if (hdr.get(p[0])) {
            for (int i = 0; i < 3; i++) x += hdr.get(p[9 + i]) << i;
            for (int i = 9; i > 3; i--) x += hdr.get(p[9 + i]) << i;
            if (!(x & 0xFFF0) || hdr.get(p[12])) x += 8;
        } else {
            const uint8_t* ps = p + 2;
            int bit = hdr.get(*ps);
            ps += 1 + 3 * bit;
            x += 4 * bit;
            bit = hdr.get(*ps);
            ps += 1 + bit;
            x += 2 * bit;
            x += hdr.get(*ps);
        }
        return (x && hdr.get(p[1])) ? -x : x;
    }

    MV read_mv(MV base) {
        const int y = read_mv_component(probs.mv[0]);
        const int x = read_mv_component(probs.mv[1]);
        MV m;
        m.y = (int16_t)(base.y + y);
        m.x = (int16_t)(base.x + x);
        return m;
    }

    MV clamp_mv(MV m, int mx, int my) const {
        const int min_x = -64 - 64 * mx, max_x = (mbw - 1 - mx) * 64 + 64;
        const int min_y = -64 - 64 * my, max_y = (mbh - 1 - my) * 64 + 64;
        m.x = (int16_t)clamp(m.x, min_x, max_x);
        m.y = (int16_t)clamp(m.y, min_y, max_y);
        return m;
    }

    void parse_modes(int mx, int my) {
        MbInfo& m = mb(mx, my);
        uint8_t& seg = segmap[(size_t)my * mbw + mx];
        if (seg_update_map) seg = (uint8_t)(hdr.get(seg_probs[0]) ? 2 + hdr.get(seg_probs[2])
                                                                   : hdr.get(seg_probs[1]));
        m.segment = seg_enabled ? seg : 0;
        m.skip = skip_enabled ? (uint8_t)hdr.get(prob_skip) : 0;
        m.partitioning = 0;
        uint8_t* above_b = &above_bmodes[(size_t)4 * mx];
        if (keyframe) {
            m.ref = REF_INTRA;
            m.mv = MV();
            m.ymode = (uint8_t)hdr.tree(kKfYmodeTree, kKfYmodeProbs);
            if (m.ymode == B_PRED) {
                features |= F_BPRED;
                for (int i = 0; i < 16; i++) {
                    const int A = i < 4 ? above_b[i] : m.bmodes[i - 4];
                    const int L = (i & 3) ? m.bmodes[i - 1] : left_bmodes[i >> 2];
                    m.bmodes[i] = (uint8_t)hdr.tree(kBmodeTree, kKfBmodeProbs[A][L]);
                }
            } else {
                static const uint8_t implied[4] = {B_DC, B_VE, B_HE, B_TM};
                memset(m.bmodes, implied[m.ymode], 16);
            }
            m.uvmode = (uint8_t)hdr.tree(kUvModeTree, kKfUvModeProbs);
            for (int i = 0; i < 4; i++) {
                above_b[i] = m.bmodes[12 + i];
                left_bmodes[i] = m.bmodes[4 * i + 3];
            }
            for (auto& b : m.bmv) b = MV();
            return;
        }
        if (!hdr.get(prob_intra)) {  // an intra macroblock of an inter frame
            features |= F_INTRA_IN_INTER;
            m.ref = REF_INTRA;
            m.mv = MV();
            for (auto& b : m.bmv) b = MV();
            m.ymode = (uint8_t)hdr.tree(kYmodeTree, probs.ymode);
            if (m.ymode == B_PRED) {
                features |= F_BPRED;
                for (int i = 0; i < 16; i++) m.bmodes[i] = (uint8_t)hdr.tree(kBmodeTree, kBmodeProbs);
            }
            m.uvmode = (uint8_t)hdr.tree(kUvModeTree, probs.uvmode);
            return;
        }
        m.ref = hdr.get(prob_last) ? (uint8_t)(REF_GOLDEN + hdr.get(prob_golden)) : (uint8_t)REF_LAST;
        if (m.ref == REF_GOLDEN) features |= F_GOLDEN_REF;
        if (m.ref == REF_ALTREF) features |= F_ALTREF_REF;

        // the reference MVs: above, left, above-left (libvpx's find_near_mvs)
        const MbInfo* nb[3] = {&mb(mx, my - 1), &mb(mx - 1, my), &mb(mx - 1, my - 1)};
        const int weight[3] = {2, 2, 1};
        MV near_mvs[4];
        int cnt[4] = {0, 0, 0, 0};
        int idx = 0;
        for (int n = 0; n < 3; n++) {
            const MbInfo* o = nb[n];
            if (o->ref == REF_INTRA) continue;
            if (o->mv.zero()) {
                cnt[0] += weight[n];
                continue;
            }
            MV v = o->mv;
            if (sign_bias[o->ref] != sign_bias[m.ref]) {
                v.x = (int16_t)-v.x;
                v.y = (int16_t)-v.y;
            }
            if (n == 0 || v != near_mvs[idx]) near_mvs[++idx] = v;
            cnt[idx] += weight[n];
        }
        // the above-left MV merged with the nearest one
        if (cnt[3] && near_mvs[3] == near_mvs[1]) cnt[1] += 1;
        cnt[3] = (nb[0]->ymode == MV_SPLIT) * 2 + (nb[1]->ymode == MV_SPLIT) * 2 +
                 (nb[2]->ymode == MV_SPLIT);
        if (cnt[2] > cnt[1]) {
            std::swap(cnt[1], cnt[2]);
            std::swap(near_mvs[1], near_mvs[2]);
        }
        if (cnt[1] >= cnt[0]) near_mvs[0] = near_mvs[1];

        if (!hdr.get(kModeContexts[cnt[0]][0])) {
            m.ymode = MV_ZERO;
            m.mv = MV();
        } else if (!hdr.get(kModeContexts[cnt[1]][1])) {
            m.ymode = MV_NEAREST;
            m.mv = clamp_mv(near_mvs[1], mx, my);
        } else if (!hdr.get(kModeContexts[cnt[2]][2])) {
            m.ymode = MV_NEAR;
            m.mv = clamp_mv(near_mvs[2], mx, my);
            features |= F_NEARMV;
        } else {
            const MV best = clamp_mv(near_mvs[0], mx, my);
            if (hdr.get(kModeContexts[cnt[3]][3])) {
                m.ymode = MV_SPLIT;
                features |= F_SPLITMV;
                read_split(m, nb[1], nb[0], best);
                m.mv = m.bmv[15];
                return;
            }
            m.ymode = MV_NEW;
            features |= F_NEWMV;
            m.mv = read_mv(best);
        }
        for (auto& b : m.bmv) b = m.mv;
    }

    void read_split(MbInfo& m, const MbInfo* left, const MbInfo* above, MV best) {
        int part;
        if (!hdr.get(kMbsplitProbs[0]))
            part = 3;
        else if (!hdr.get(kMbsplitProbs[1]))
            part = 2;
        else
            part = hdr.get(kMbsplitProbs[2]);
        m.partitioning = (uint8_t)part;
        const uint8_t* map = kMbsplits[part];
        for (int j = 0; j < kMbsplitCount[part]; j++) {
            int k = 0;
            while (map[k] != j) k++;
            const MV l = (k & 3) ? m.bmv[k - 1] : left->bmv[k + 3];
            const MV a = k > 3 ? m.bmv[k - 4] : above->bmv[k + 12];
            int ctx;
            if (l == a)
                ctx = l.zero() ? 4 : 3;
            else if (a.zero())
                ctx = 2;
            else
                ctx = l.zero() ? 1 : 0;
            const uint8_t* p = kSubMvRefProbs[ctx];
            MV v;
            if (!hdr.get(p[0]))
                v = l;
            else if (!hdr.get(p[1]))
                v = a;
            else if (!hdr.get(p[2]))
                v = MV();
            else
                v = read_mv(best);
            for (int i = k; i < 16; i++)
                if (map[i] == j) m.bmv[i] = v;
        }
    }

    // ----------------------------------------------------------- tokens
    // one block's tokens from position `first`, dequantised into out
    // (raster order); returns the position after the last token (0: none)
    int read_block(BoolDecoder& b, int type, int first, int ctx, int qdc, int qac, int16_t* out) {
        int i = first;
        const uint8_t* p = probs.coef[type][kCoefBands[i]][ctx];
        if (!b.get(p[0])) return 0;
        while (true) {
            if (!b.get(p[1])) {  // a zero: no EOB may follow
                if (++i == 16) return 16;
                p = probs.coef[type][kCoefBands[i]][0];
                continue;
            }
            int v, next;
            if (!b.get(p[2])) {
                v = 1;
                next = 1;
            } else {
                if (!b.get(p[3])) {
                    v = !b.get(p[4]) ? 2 : 3 + b.get(p[5]);
                } else {
                    int cat;
                    if (!b.get(p[6]))
                        cat = b.get(p[7]);
                    else if (!b.get(p[8]))
                        cat = 2 + b.get(p[9]);
                    else
                        cat = 4 + b.get(p[10]);
                    v = 0;
                    for (const uint8_t* q = kPcat[cat]; *q; q++) v = 2 * v + b.get(*q);
                    v += kCatBase[cat];
                }
                next = 2;
            }
            if (b.bit()) v = -v;
            out[kZigzag[i]] = (int16_t)(v * (i ? qac : qdc));
            if (++i == 16) return 16;
            p = probs.coef[type][kCoefBands[i]][next];
            if (!b.get(p[0])) return i;
        }
    }

    // ----------------------------------------------------- reconstruction
    struct Coeffs {
        int16_t blk[25][16];
        int nz[25];
    };

    bool read_tokens(BoolDecoder& b, MbInfo& m, int mx, Coeffs& c) {
        uint8_t* a = &above_nz[(size_t)9 * mx];
        uint8_t* l = left_nz;
        memset(c.blk, 0, sizeof c.blk);
        memset(c.nz, 0, sizeof c.nz);
        const Quant& q = quant[m.segment];
        const bool y2 = m.ymode != B_PRED && m.ymode != MV_SPLIT;
        int total = 0;
        int first = 0, ytype = 3;
        if (y2) {
            const int n = read_block(b, 1, 0, a[8] + l[8], q.y2[0], q.y2[1], c.blk[24]);
            a[8] = l[8] = n > 0;
            c.nz[24] = n;
            total += n;
            first = 1;
            ytype = 0;
        }
        for (int i = 0; i < 16; i++) {
            const int x = i & 3, y = i >> 2;
            const int n = read_block(b, ytype, first, a[x] + l[y], q.y[0], q.y[1], c.blk[i]);
            a[x] = l[y] = n > 0;
            c.nz[i] = n;
            total += n;
        }
        for (int pl = 0; pl < 2; pl++)
            for (int i = 0; i < 4; i++) {
                const int x = 4 + 2 * pl + (i & 1), y = 4 + 2 * pl + (i >> 1);
                const int n = read_block(b, 2, 0, a[x] + l[y], q.uv[0], q.uv[1], c.blk[16 + 4 * pl + i]);
                a[x] = l[y] = n > 0;
                c.nz[16 + 4 * pl + i] = n;
                total += n;
            }
        return total > 0;
    }

    void clear_contexts(const MbInfo& m, int mx) {
        uint8_t* a = &above_nz[(size_t)9 * mx];
        memset(a, 0, 8);
        memset(left_nz, 0, 8);
        if (m.ymode != B_PRED && m.ymode != MV_SPLIT) a[8] = left_nz[8] = 0;
    }

    // the luma DCs from the Y2 block
    void apply_y2(Coeffs& c) {
        if (!c.nz[24]) return;
        int16_t dc[16];
        iwht(c.blk[24], dc);
        for (int i = 0; i < 16; i++) {
            c.blk[i][0] = dc[i];
            if (dc[i]) c.nz[i] = std::max(c.nz[i], 1);
        }
    }

    void add_residual(uint8_t* dst, int stride, const int16_t* blk, int nz) {
        if (nz) idct_add(blk, dst, stride);
    }

    void intra_mb(MbInfo& m, int mx, int my, Coeffs& c, bool coded) {
        Plane& Y = cur->p[0];
        const int x0 = 16 * mx, y0 = 16 * my;
        const int stride = Y.w;
        uint8_t* dst = Y.row(y0) + x0;
        // the edges: 127 above the frame, 129 left of it
        uint8_t above_buf[1 + 20], left[16];
        uint8_t* above = above_buf + 1;
        if (my == 0) {
            memset(above_buf, 127, sizeof above_buf);
        } else {
            const uint8_t* r = Y.row(y0 - 1);
            above[-1] = mx ? r[x0 - 1] : 129;
            memcpy(above, r + x0, 16);
            if (mx == mbw - 1)
                memset(above + 16, r[x0 + 15], 4);
            else
                memcpy(above + 16, r + x0 + 16, 4);
        }
        for (int i = 0; i < 16; i++) left[i] = mx ? Y.row(y0 + i)[x0 - 1] : 129;
        if (m.ymode == B_PRED) {
            for (int i = 0; i < 16; i++) {
                const int bx = i & 3, by = i >> 2;
                uint8_t* d = dst + 4 * by * stride + 4 * bx;
                uint8_t A_buf[9];
                uint8_t* A = A_buf + 1;
                uint8_t L[4];
                if (by == 0) {
                    memcpy(A_buf, above + 4 * bx - 1, 9);
                } else {
                    const uint8_t* r = d - stride;
                    A[-1] = bx ? r[-1] : left[4 * by - 1];
                    memcpy(A, r, 4);
                    if (bx < 3)
                        memcpy(A + 4, r + 4, 4);
                    else
                        memcpy(A + 4, above + 16, 4);
                }
                for (int k = 0; k < 4; k++) L[k] = bx ? d[k * stride - 1] : left[4 * by + k];
                predict_sub(m.bmodes[i], d, stride, A, L);
                if (coded) add_residual(d, stride, c.blk[i], c.nz[i]);
            }
        } else {
            predict_mb(m.ymode, dst, stride, 16, above, left, my > 0, mx > 0);
            if (coded) luma_residual(dst, stride, c);
        }
        for (int pl = 1; pl < 3; pl++) {
            Plane& P = cur->p[pl];
            const int cx = 8 * mx, cy = 8 * my;
            uint8_t ab[9], lf[8];
            uint8_t* ca = ab + 1;
            if (my == 0) {
                memset(ab, 127, 9);
            } else {
                const uint8_t* r = P.row(cy - 1);
                ca[-1] = mx ? r[cx - 1] : 129;
                memcpy(ca, r + cx, 8);
            }
            for (int i = 0; i < 8; i++) lf[i] = mx ? P.row(cy + i)[cx - 1] : 129;
            uint8_t* d = P.row(cy) + cx;
            predict_mb(m.uvmode, d, P.w, 8, ca, lf, my > 0, mx > 0);
            if (coded) chroma_residual(d, P.w, c, pl);
        }
    }

    void luma_residual(uint8_t* dst, int stride, Coeffs& c) {
        for (int i = 0; i < 16; i++)
            add_residual(dst + 4 * (i >> 2) * stride + 4 * (i & 3), stride, c.blk[i], c.nz[i]);
    }

    void chroma_residual(uint8_t* dst, int stride, Coeffs& c, int pl) {
        for (int i = 0; i < 4; i++) {
            const int k = 16 + 4 * (pl - 1) + i;
            add_residual(dst + 4 * (i >> 1) * stride + 4 * (i & 1), stride, c.blk[k], c.nz[k]);
        }
    }

    void inter_mb(MbInfo& m, int mx, int my, Coeffs& c, bool coded) {
        const Image& ref = *(m.ref == REF_LAST ? last : m.ref == REF_GOLDEN ? golden : altref);
        Plane& Y = cur->p[0];
        const int x0 = 16 * mx, y0 = 16 * my;
        uint8_t* dst = Y.row(y0) + x0;
        if (m.ymode != MV_SPLIT) {
            const MV v = m.mv;
            predict_inter(ref.p[0], x0, y0, 16, 16, v.x >> 2, v.y >> 2, (v.x & 3) * 2,
                          (v.y & 3) * 2, bilinear, dst, Y.w);
            MV uv = v;
            if (fullpel) {
                uv.x = (int16_t)(uv.x & ~7);
                uv.y = (int16_t)(uv.y & ~7);
            }
            for (int pl = 1; pl < 3; pl++) {
                Plane& P = cur->p[pl];
                predict_inter(ref.p[pl], 8 * mx, 8 * my, 8, 8, uv.x >> 3, uv.y >> 3, uv.x & 7,
                              uv.y & 7, bilinear, P.row(8 * my) + 8 * mx, P.w);
            }
        } else {
            for (int i = 0; i < 16; i++) {
                const MV v = m.bmv[i];
                const int bx = x0 + 4 * (i & 3), by = y0 + 4 * (i >> 2);
                predict_inter(ref.p[0], bx, by, 4, 4, v.x >> 2, v.y >> 2, (v.x & 3) * 2,
                              (v.y & 3) * 2, bilinear, Y.row(by) + bx, Y.w);
            }
            for (int y = 0; y < 2; y++)
                for (int x = 0; x < 2; x++) {
                    const int b0 = 8 * y + 2 * x;
                    int sx = m.bmv[b0].x + m.bmv[b0 + 1].x + m.bmv[b0 + 4].x + m.bmv[b0 + 5].x;
                    int sy = m.bmv[b0].y + m.bmv[b0 + 1].y + m.bmv[b0 + 4].y + m.bmv[b0 + 5].y;
                    sx = (sx + 2 + (sx < 0 ? -1 : 0)) >> 2;
                    sy = (sy + 2 + (sy < 0 ? -1 : 0)) >> 2;
                    if (fullpel) {
                        sx &= ~7;
                        sy &= ~7;
                    }
                    for (int pl = 1; pl < 3; pl++) {
                        Plane& P = cur->p[pl];
                        const int bx = 8 * mx + 4 * x, by = 8 * my + 4 * y;
                        predict_inter(ref.p[pl], bx, by, 4, 4, sx >> 3, sy >> 3, sx & 7, sy & 7,
                                      bilinear, P.row(by) + bx, P.w);
                    }
                }
        }
        if (!coded) return;
        luma_residual(dst, Y.w, c);
        for (int pl = 1; pl < 3; pl++) {
            Plane& P = cur->p[pl];
            chroma_residual(P.row(8 * my) + 8 * mx, P.w, c, pl);
        }
    }

    // ------------------------------------------------------- loop filter
    void loop_filter() {
        if (!filter_level) return;
        static const uint8_t hev_key[64] = {
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1,
            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,
            2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2};
        Plane& Y = cur->p[0];
        Plane& U = cur->p[1];
        Plane& V = cur->p[2];
        for (int my = 0; my < mbh; my++)
            for (int mx = 0; mx < mbw; mx++) {
                const MbInfo& m = mb(mx, my);
                int level = seg_enabled ? (seg_abs ? seg_lf[m.segment] : filter_level + seg_lf[m.segment])
                                        : filter_level;
                if (lf_delta_enabled) {
                    level += ref_lf_delta[m.ref];
                    if (m.ymode == B_PRED)
                        level += mode_lf_delta[0];
                    else if (m.ymode == MV_ZERO)
                        level += mode_lf_delta[1];
                    else if (m.ymode == MV_SPLIT)
                        level += mode_lf_delta[3];
                    else if (m.ref != REF_INTRA)
                        level += mode_lf_delta[2];
                }
                level = clamp(level, 0, 63);
                if (!level) continue;
                int interior = level;
                if (sharpness) {
                    interior >>= (sharpness + 3) >> 2;
                    interior = std::min(interior, 9 - sharpness);
                }
                interior = std::max(interior, 1);
                const bool inner = !m.skip || m.ymode == B_PRED || m.ymode == MV_SPLIT;
                const int bedge = 2 * level + interior, mbedge = bedge + 4;
                const int hev = keyframe ? hev_key[level]
                                         : (level >= 40 ? 3 : level >= 20 ? 2 : level >= 15 ? 1 : 0);
                const int ys = Y.w, cs = U.w;
                uint8_t* py = Y.row(16 * my) + 16 * mx;
                uint8_t* pu = U.row(8 * my) + 8 * mx;
                uint8_t* pv = V.row(8 * my) + 8 * mx;
                if (simple_filter) {
                    if (mx) edge_simple(py, 1, ys, 16, mbedge);
                    if (inner)
                        for (int k = 4; k < 16; k += 4) edge_simple(py + k, 1, ys, 16, bedge);
                    if (my) edge_simple(py, ys, 1, 16, mbedge);
                    if (inner)
                        for (int k = 4; k < 16; k += 4) edge_simple(py + k * ys, ys, 1, 16, bedge);
                    continue;
                }
                const EdgeParams mbp{mbedge, interior, hev}, bp{bedge, interior, hev};
                if (mx) {
                    edge_normal(py, 1, ys, 16, mbp, true);
                    edge_normal(pu, 1, cs, 8, mbp, true);
                    edge_normal(pv, 1, cs, 8, mbp, true);
                }
                if (inner) {
                    for (int k = 4; k < 16; k += 4) edge_normal(py + k, 1, ys, 16, bp, false);
                    edge_normal(pu + 4, 1, cs, 8, bp, false);
                    edge_normal(pv + 4, 1, cs, 8, bp, false);
                }
                if (my) {
                    edge_normal(py, ys, 1, 16, mbp, true);
                    edge_normal(pu, cs, 1, 8, mbp, true);
                    edge_normal(pv, cs, 1, 8, mbp, true);
                }
                if (inner) {
                    for (int k = 4; k < 16; k += 4) edge_normal(py + k * ys, ys, 1, 16, bp, false);
                    edge_normal(pu + 4 * cs, cs, 1, 8, bp, false);
                    edge_normal(pv + 4 * cs, cs, 1, 8, bp, false);
                }
            }
    }

    // --------------------------------------------------------- a frame
    // returns whether the frame is shown
    bool decode(const uint8_t* data, size_t size) {
        int show = 1;
        parse_header(data, size, &show);
        cur = std::make_shared<Image>(mbw, mbh);
        mbs.assign((size_t)(mbh + 1) * (mbw + 1), MbInfo());
        for (auto& m : mbs) memset(m.bmodes, B_DC, 16);
        above_nz.assign((size_t)9 * mbw, 0);
        above_bmodes.assign((size_t)4 * mbw, B_DC);
        Coeffs c;
        for (int my = 0; my < mbh; my++) {
            BoolDecoder& tok = parts[my % nparts];
            memset(left_nz, 0, sizeof left_nz);
            memset(left_bmodes, B_DC, sizeof left_bmodes);
            for (int mx = 0; mx < mbw; mx++) {
                parse_modes(mx, my);
                MbInfo& m = mb(mx, my);
                bool coded = false;
                if (!m.skip) {
                    coded = read_tokens(tok, m, mx, c);
                    if (!coded) m.skip = 1;
                } else {
                    clear_contexts(m, mx);
                }
                if (coded && m.ymode != B_PRED && m.ymode != MV_SPLIT) apply_y2(c);
                if (m.ref == REF_INTRA)
                    intra_mb(m, mx, my, c, coded);
                else
                    inter_mb(m, mx, my, c, coded);
            }
            if (hdr.overrun > kMaxOverrun || tok.overrun > kMaxOverrun)
                throw Error(CORRUPT, "a partition ends before its macroblocks do");
        }
        loop_filter();

        // the references: copies from the ones before this frame
        const ImagePtr old_last = last, old_golden = golden, old_altref = altref;
        auto pick = [&](int src, const ImagePtr& self, const ImagePtr& other) {
            return src == SRC_CURRENT ? cur : src == SRC_LAST ? old_last : src == SRC_OTHER ? other : self;
        };
        golden = pick(golden_src, old_golden, old_altref);
        altref = pick(altref_src, old_altref, old_golden);
        if (refresh_last) last = cur;
        if (!refresh_probs) probs = saved;
        if (keyframe) have_key = true;
        return show != 0;
    }

    void output(uint8_t* y, uint8_t* u, uint8_t* v) const {
        const Image& img = *shown;
        const int cw = (width + 1) / 2, ch = (height + 1) / 2;
        for (int r = 0; r < height; r++) memcpy(y + (size_t)r * width, img.p[0].row(r), width);
        for (int r = 0; r < ch; r++) {
            memcpy(u + (size_t)r * cw, img.p[1].row(r), cw);
            memcpy(v + (size_t)r * cw, img.p[2].row(r), cw);
        }
    }

    ImagePtr shown;
};

int fail(const Error& e, char* msg, int64_t cap) {
    snprintf(msg, (size_t)cap, "%s", e.what());
    return e.code;
}

}  // namespace

extern "C" {

void* vp8_dec_new() { return new Decoder(); }

void vp8_dec_free(void* h) { delete (Decoder*)h; }

// one frame: OK (a picture; wh = its size), NO_FRAME (show_frame = 0) or
// an error code with msg; wh[2], wh[3]: the last key frame's clamping_type
// bit, whether this frame is a key frame
int vp8_dec_decode(void* h, const uint8_t* data, int64_t size, int64_t* wh, char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        const bool show = d->decode(data, (size_t)size);
        wh[2] = d->clamping;
        wh[3] = d->keyframe;
        if (!show) return NO_FRAME;
        d->shown = d->cur;
        wh[0] = d->width;
        wh[1] = d->height;
        return OK;
    } catch (const Error& e) {
        return fail(e, msg, cap);
    } catch (const std::exception& e) {
        return fail(Error(CORRUPT, e.what()), msg, cap);
    }
}

void vp8_dec_output(void* h, uint8_t* y, uint8_t* u, uint8_t* v) { ((Decoder*)h)->output(y, u, v); }

int64_t vp8_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
