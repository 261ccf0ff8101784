// H.264's luma quarter-sample interpolation as h264qpel_template.c does
// it at 8 bits: the 6-tap half-sample filter (horizontal, vertical and the
// centre from the unrounded horizontal taps) and the average of two
// neighbours for the quarter positions.  Each output sample depends only on
// its position, so a block of any size is the same as FFmpeg's square
// blocks side by side.  Shared by snow.cpp (its OBMC blocks) and h264.cpp.

#pragma once

#include <cstdint>
#include <cstring>

namespace h264qpel {

inline uint8_t clip(int v) { return uint8_t(v & ~255 ? ~(v >> 31) : v); }

// h264qpel_template.c at 8 bits: put_h264_qpel<size>_mc<x><y>, with the
// destination's stride apart from the source's
inline void lowpass_h(uint8_t* dst, int ds, const uint8_t* s, int ss, int n) {
    for (int y = 0; y < n; y++, dst += ds, s += ss)
        for (int x = 0; x < n; x++)
            dst[x] = clip((20 * (s[x] + s[x + 1]) - 5 * (s[x - 1] + s[x + 2]) + (s[x - 2] + s[x + 3]) + 16) >> 5);
}

inline void lowpass_v(uint8_t* dst, int ds, const uint8_t* s, int ss, int n) {
    for (int y = 0; y < n; y++, dst += ds, s += ss)
        for (int x = 0; x < n; x++)
            dst[x] = clip((20 * (s[x] + s[x + ss]) - 5 * (s[x - ss] + s[x + 2 * ss]) + (s[x - 2 * ss] + s[x + 3 * ss]) +
                            16) >> 5);
}

inline void lowpass_hv(uint8_t* dst, int ds, const uint8_t* s, int ss, int n) {
    int16_t tmp[(16 + 5) * 16];
    for (int y = -2; y < n + 3; y++) {
        const uint8_t* r = s + y * ss;
        for (int x = 0; x < n; x++)
            tmp[(y + 2) * 16 + x] = int16_t(20 * (r[x] + r[x + 1]) - 5 * (r[x - 1] + r[x + 2]) + (r[x - 2] + r[x + 3]));
    }
    for (int y = 0; y < n; y++, dst += ds) {
        const int16_t* t = tmp + (y + 2) * 16;
        for (int x = 0; x < n; x++)
            dst[x] = clip((20 * (t[x] + t[x + 16]) - 5 * (t[x - 16] + t[x + 32]) + (t[x - 32] + t[x + 48]) + 512) >>
                           10);
    }
}

inline void avg2(uint8_t* dst, int ds, const uint8_t* a, int as, const uint8_t* b, int bs, int n) {
    for (int y = 0; y < n; y++, dst += ds, a += as, b += bs)
        for (int x = 0; x < n; x++) dst[x] = uint8_t((a[x] + b[x] + 1) >> 1);
}

// put_h264_qpel_pixels_tab[size][qx + 4 * qy] on an n x n block
inline void put(uint8_t* dst, int ds, const uint8_t* src, int ss, int n, int qx, int qy) {
    uint8_t h[16 * 16], v[16 * 16], hv[16 * 16];
    const int m = qx + 4 * qy;
    switch (m) {
    case 0:
        for (int y = 0; y < n; y++) std::memcpy(dst + y * ds, src + y * ss, n);
        return;
    case 2: lowpass_h(dst, ds, src, ss, n); return;
    case 8: lowpass_v(dst, ds, src, ss, n); return;
    case 10: lowpass_hv(dst, ds, src, ss, n); return;
    case 1:
    case 3:
        lowpass_h(h, 16, src, ss, n);
        avg2(dst, ds, src + (m == 3), ss, h, 16, n);
        return;
    case 4:
    case 12:
        lowpass_v(v, 16, src, ss, n);
        avg2(dst, ds, src + (m == 12 ? ss : 0), ss, v, 16, n);
        return;
    case 5:
    case 7:
    case 13:
    case 15:
        lowpass_h(h, 16, src + (qy == 3 ? ss : 0), ss, n);
        lowpass_v(v, 16, src + (qx == 3), ss, n);
        avg2(dst, ds, h, 16, v, 16, n);
        return;
    case 6:
    case 14:
        lowpass_h(h, 16, src + (qy == 3 ? ss : 0), ss, n);
        lowpass_hv(hv, 16, src, ss, n);
        avg2(dst, ds, h, 16, hv, 16, n);
        return;
    default:   // 9, 11
        lowpass_v(v, 16, src + (qx == 3), ss, n);
        lowpass_hv(hv, 16, src, ss, n);
        avg2(dst, ds, v, 16, hv, 16, n);
        return;
    }
}

// put() over a w x h block (each a multiple of the square side n it is
// cut into: min(w, h), at most 16)
inline void put_block(uint8_t* dst, int ds, const uint8_t* src, int ss, int w, int h, int qx, int qy) {
    const int n = w < h ? w : h;
    for (int y = 0; y < h; y += n)
        for (int x = 0; x < w; x += n) put(dst + y * ds + x, ds, src + y * ss + x, ss, n, qx, qy);
}

}  // namespace h264qpel
