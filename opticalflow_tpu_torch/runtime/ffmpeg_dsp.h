// FFmpeg's pixel arithmetic, shared by the port's host decoders (mpeg4.cpp,
// jpeg.cpp): what cv2.VideoCapture's frames go through, bit for bit, as
// OpenCV 5.0 runs FFmpeg 8 (libavcodec 62, libswscale 9) on x86-64.
//
//   * idct: FFmpeg's simple IDCT, 8-bit (simple_idct_template.c, int16 in),
//     which libavcodec's MPEG-4 Part 2 and Motion JPEG decoders run;
//   * yuv_to_bgr_nearest: swscale's unscaled x86 SIMD yuv2rgb
//     (yuv2rgb.asm): 4:2:0 or 4:2:2 planes at an even height, nearest
//     chroma, with video-range (yuv420p) or full-range (yuvj) coefficients;
//   * yuv_to_bgr: swscale's conversion of planes to BGR24 at the same size
//     with SWS_BICUBIC, as OpenCV's FFmpeg backend asks for it, at video
//     range (yuv420p: what the MPEG-4 Part 2, VP8, rawvideo and yuv4mpeg
//     decoders hand over) or full range (yuvj420p, yuvj422p, yuvj444p,
//     yuvj440p, yuvj411p: FFmpeg's MJPEG decoder): the unscaled path above
//     where swscale takes it, else its scaler (scale_to_bgr), which also
//     takes planes from one size to another, luma and chroma, as cv2
//     converts a picture of another size than its stream's first;
//   * rgb48_to_bgr: swscale's conversion of 16-bit RGB (rgb48be, and
//     rgba64be with its alpha dropped: FFmpeg's PNG decoder's 16-bit
//     colour) to BGR24, through its internal video-range YUV;
//   * scale_to_bgr over 10- and 12-bit planes (yuv4xxp10/12, which swscale
//     converts through its scaler alone, reading them with hScale16To15).
//
// Header only; each including source is one shared library.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace ffdsp {

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ------------------------------------------------------------------ IDCT
// FFmpeg's simple IDCT, 8-bit (simple_idct_template.c, int16 in).

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873,
              W6 = 8867, W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20;

inline void idct_row(int16_t* row) {
    bool ac = false;
    for (int i = 1; i < 8; i++) ac |= row[i] != 0;
    if (!ac) {
        int16_t v = (int16_t)(uint16_t)((uint32_t)row[0] << 3);
        for (int i = 0; i < 8; i++) row[i] = v;
        return;
    }
    uint32_t a0 = (uint32_t)W4 * row[0] + (1u << (ROW_SHIFT - 1));
    uint32_t a1 = a0, a2 = a0, a3 = a0;
    a0 += (uint32_t)W2 * row[2];
    a1 += (uint32_t)W6 * row[2];
    a2 -= (uint32_t)W6 * row[2];
    a3 -= (uint32_t)W2 * row[2];
    uint32_t b0 = (uint32_t)W1 * row[1] + (uint32_t)W3 * row[3];
    uint32_t b1 = (uint32_t)W3 * row[1] - (uint32_t)W7 * row[3];
    uint32_t b2 = (uint32_t)W5 * row[1] - (uint32_t)W1 * row[3];
    uint32_t b3 = (uint32_t)W7 * row[1] - (uint32_t)W5 * row[3];
    a0 += (uint32_t)W4 * row[4] + (uint32_t)W6 * row[6];
    a1 += -(uint32_t)W4 * row[4] - (uint32_t)W2 * row[6];
    a2 += -(uint32_t)W4 * row[4] + (uint32_t)W2 * row[6];
    a3 += (uint32_t)W4 * row[4] - (uint32_t)W6 * row[6];
    b0 += (uint32_t)W5 * row[5] + (uint32_t)W7 * row[7];
    b1 += -(uint32_t)W1 * row[5] - (uint32_t)W5 * row[7];
    b2 += (uint32_t)W7 * row[5] + (uint32_t)W3 * row[7];
    b3 += (uint32_t)W3 * row[5] - (uint32_t)W1 * row[7];
    row[0] = (int16_t)((int32_t)(a0 + b0) >> ROW_SHIFT);
    row[7] = (int16_t)((int32_t)(a0 - b0) >> ROW_SHIFT);
    row[1] = (int16_t)((int32_t)(a1 + b1) >> ROW_SHIFT);
    row[6] = (int16_t)((int32_t)(a1 - b1) >> ROW_SHIFT);
    row[2] = (int16_t)((int32_t)(a2 + b2) >> ROW_SHIFT);
    row[5] = (int16_t)((int32_t)(a2 - b2) >> ROW_SHIFT);
    row[3] = (int16_t)((int32_t)(a3 + b3) >> ROW_SHIFT);
    row[4] = (int16_t)((int32_t)(a3 - b3) >> ROW_SHIFT);
}

// the column pass; ``add`` adds to dest instead of writing it
inline void idct_col(const int16_t* col, uint8_t* dest, int stride, bool add) {
    uint32_t a0 = (uint32_t)W4 * (col[0] + ((1 << (COL_SHIFT - 1)) / W4));
    uint32_t a1 = a0, a2 = a0, a3 = a0;
    a0 += (uint32_t)W2 * col[16];
    a1 += (uint32_t)W6 * col[16];
    a2 += -(uint32_t)W6 * col[16];
    a3 += -(uint32_t)W2 * col[16];
    uint32_t b0 = (uint32_t)W1 * col[8] + (uint32_t)W3 * col[24];
    uint32_t b1 = (uint32_t)W3 * col[8] - (uint32_t)W7 * col[24];
    uint32_t b2 = (uint32_t)W5 * col[8] - (uint32_t)W1 * col[24];
    uint32_t b3 = (uint32_t)W7 * col[8] - (uint32_t)W5 * col[24];
    a0 += (uint32_t)W4 * col[32];
    a1 += -(uint32_t)W4 * col[32];
    a2 += -(uint32_t)W4 * col[32];
    a3 += (uint32_t)W4 * col[32];
    b0 += (uint32_t)W5 * col[40];
    b1 += -(uint32_t)W1 * col[40];
    b2 += (uint32_t)W7 * col[40];
    b3 += (uint32_t)W3 * col[40];
    a0 += (uint32_t)W6 * col[48];
    a1 += -(uint32_t)W2 * col[48];
    a2 += (uint32_t)W2 * col[48];
    a3 += -(uint32_t)W6 * col[48];
    b0 += (uint32_t)W7 * col[56];
    b1 += -(uint32_t)W5 * col[56];
    b2 += (uint32_t)W3 * col[56];
    b3 += -(uint32_t)W1 * col[56];
    int v[8] = {(int32_t)(a0 + b0) >> COL_SHIFT, (int32_t)(a1 + b1) >> COL_SHIFT,
                (int32_t)(a2 + b2) >> COL_SHIFT, (int32_t)(a3 + b3) >> COL_SHIFT,
                (int32_t)(a3 - b3) >> COL_SHIFT, (int32_t)(a2 - b2) >> COL_SHIFT,
                (int32_t)(a1 - b1) >> COL_SHIFT, (int32_t)(a0 - b0) >> COL_SHIFT};
    for (int i = 0; i < 8; i++, dest += stride)
        *dest = clip8(add ? *dest + v[i] : v[i]);
}

// blk: 64 coefficients in raster order (row = vertical frequency), already
// dequantised; the rows are transformed in place
inline void idct(int16_t* blk, uint8_t* dest, int stride, bool add) {
    for (int i = 0; i < 8; i++) idct_row(blk + 8 * i);
    for (int i = 0; i < 8; i++) idct_col(blk + i, dest + i, stride, add);
}

// ------------------------------------------------- YUV -> BGR24, SIMD
// swscale's x86 yuv2rgb arithmetic (yuv2rgb.asm, and the MMX packed
// output functions of its scaler): Y, U, V as 16-bit words at 8x scale,
// the offsets subtracted, pmulhw by 13-bit coefficients, saturating adds,
// packuswb.  The coefficients are ff_yuv2rgb_c_init_tables' for BT.601:
// video range (yuv420p), and full range (yuvj*, sws srcRange=1), where the
// chroma ones are scaled by 224/255 and Y is neither scaled nor offset.

struct YuvCoeffs {
    int y, vr, ub, ug, vg, yoff;
    int matrix;   // kMatrices' index: 0 BT.601, 1 BT.709, 2 SMPTE 240M, 3 BT.2020, 4 FCC
};
constexpr YuvCoeffs kVideoRange{9539, 13075, 16525, -3209, -6660, 128, 0};
constexpr YuvCoeffs kFullRange{8192, 11485, 14516, -2819, -5850, 0, 0};

// sws_getCoefficients' inverse matrices (crv, cbu, cgu, cgv, 16.16): what
// swscale converts a frame with when it is handed the frame's colour
// space (FFmpeg's ff_yuv2rgb_coeffs; unspecified and SMPTE 170M are BT.601)
struct InvMatrix {
    int64_t crv, cbu, cgu, cgv;
};
constexpr InvMatrix kMatrices[5] = {{104597, 132201, 25675, 53279},
                                    {117489, 138438, 13975, 34925},
                                    {117579, 136230, 16907, 35559},
                                    {110013, 140363, 12277, 42626},
                                    {104448, 132798, 24759, 53109}};

// sws_setColorspaceDetails' coefficients (roundToInt16 of the 16.16
// values at 2^13) for a matrix and a range
inline YuvCoeffs yuv_coeffs(int matrix, bool full) {
    const InvMatrix& m = kMatrices[matrix];
    int64_t cy = 1 << 16, oy = 0, crv = m.crv, cbu = m.cbu, cgu = -m.cgu, cgv = -m.cgv;
    if (!full) {
        cy = cy * 255 / 219;
        oy = (int64_t)16 << 16;
    } else {
        crv = crv * 224 / 255;
        cbu = cbu * 224 / 255;
        cgu = cgu * 224 / 255;
        cgv = cgv * 224 / 255;
    }
    auto r16 = [](int64_t f) {
        const int64_t r = (f + (1 << 15)) >> 16;
        return (int)(r < -0x7FFF ? -0x8000 : r > 0x7FFF ? 0x7FFF : r);
    };
    return YuvCoeffs{r16(cy << 13), r16(crv << 13), r16(cbu << 13), r16(cgu << 13), r16(cgv << 13),
                     r16(oy << 3), matrix};
}

inline int mulhw(int a, int b) { return (a * b) >> 16; }
inline int sat16(int v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; }
inline int wrap16(int v) { return (int16_t)(uint16_t)v; }

// one pixel from Y, U, V at 8x scale (a sample << 3)
inline void simd_pixel(int y8, int u8, int v8, const YuvCoeffs& k, uint8_t* bgr) {
    int ys = mulhw(wrap16(y8 - k.yoff), k.y);
    int uu = wrap16(u8 - 1024), vv = wrap16(v8 - 1024);
    int g = sat16(mulhw(uu, k.ug) + mulhw(vv, k.vg));
    bgr[0] = clip8(sat16(ys + mulhw(uu, k.ub)));
    bgr[1] = clip8(sat16(ys + g));
    bgr[2] = clip8(sat16(ys + mulhw(vv, k.vr)));
}

// swscale's unscaled yuv2rgb: chroma of 4:2:0 (vshift 1) or 4:2:2
// (vshift 0) planes taken at (x >> 1, y >> vshift).  simd_pixel's terms,
// hoisted: the luma one by sample value, the chroma ones once a chroma
// row.
inline void yuv_to_bgr_nearest(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                               int w, int h, int ystride, int cstride, int vshift,
                               const YuvCoeffs& k, uint8_t* bgr) {
    int ys[256];
    for (int i = 0; i < 256; i++) ys[i] = mulhw(wrap16((i << 3) - k.yoff), k.y);
    const int cw = (w + 1) >> 1;
    std::vector<int> tb(cw), tg(cw), tr(cw);
    for (int r = 0; r < h; r++) {
        if (r == 0 || (r >> vshift) != ((r - 1) >> vshift)) {
            const uint8_t* pu = u + (size_t)(r >> vshift) * cstride;
            const uint8_t* pv = v + (size_t)(r >> vshift) * cstride;
            for (int c = 0; c < cw; c++) {
                int uu = wrap16((pu[c] << 3) - 1024), vv = wrap16((pv[c] << 3) - 1024);
                tb[c] = mulhw(uu, k.ub);
                tg[c] = sat16(mulhw(uu, k.ug) + mulhw(vv, k.vg));
                tr[c] = mulhw(vv, k.vr);
            }
        }
        const uint8_t* py = y + (size_t)r * ystride;
        uint8_t* out = bgr + (size_t)r * w * 3;
        for (int c = 0; c < w; c++) {
            const int l = ys[py[c]];
            out[3 * c + 0] = clip8(sat16(l + tb[c >> 1]));
            out[3 * c + 1] = clip8(sat16(l + tg[c >> 1]));
            out[3 * c + 2] = clip8(sat16(l + tr[c >> 1]));
        }
    }
}

// --------------------------------------------- swscale's scaler, BGR24
// The path swscale takes for YUV planes it cannot convert unscaled (4:4:4,
// 4:4:0, 4:1:1, 4:2:0 or 4:2:2 at an odd height, and planes of another
// size than the output): luma is copied (identity filters) where the sizes
// agree and scaled where they differ; chroma goes through initFilter's
// bicubic filters (B = 0, C = 0.6; 14-bit horizontal, 12-bit vertical,
// x86 filter alignment 4 and 2), hScale8To15 and the vertical pass.  The
// output chroma is full width (SWS_FULL_CHR_H_INT, which swscale forces
// for an odd width and for unsubsampled chroma: yuv2bgr24_full_*_c) or
// half width (yuv2bgr24_* of its x86 MMXEXT code, and the C versions with
// their lookup tables for the last two rows, which swscale converts
// without MMX).

struct Filter {
    int size = 0;
    std::vector<int> pos;
    std::vector<int> coef;  // size coefficients an output sample
};

inline int scale_inc(int src, int dst) {
    return (int)((((int64_t)src << 16) + (dst >> 1)) / dst);
}

inline int64_t rounded_div(int64_t a, int64_t b) {
    return a >= 0 ? (a + (b >> 1)) / b : (a - (b >> 1)) / b;
}

inline int av_log2(unsigned v) {
    int n = 0;
    while (v >>= 1) n++;
    return n;
}

// libswscale's initFilter for SWS_BICUBIC, no source or destination filter;
// srcPos and dstPos are get_local_pos's sample sites (1/256 of a sample:
// 128 at swscale's default siting, so the filter is the identity where the
// sizes and the sites agree)
inline Filter init_filter(int xInc, int srcW, int dstW, int filterAlign, int one,
                          int srcPos = 128, int dstPos = 128) {
    const int64_t fone = (int64_t)1 << (54 - std::min(av_log2(srcW / dstW), 8));
    std::vector<int> pos(dstW);
    std::vector<int64_t> filt;
    int fsize;
    if (std::abs(xInc - 0x10000) < 10 && srcPos == dstPos) {
        fsize = 1;
        filt.assign(dstW, fone);
        for (int i = 0; i < dstW; i++) pos[i] = i;
    } else {
        const int sizeFactor = 4;
        fsize = xInc <= 1 << 16 ? 1 + sizeFactor
                                : 1 + (sizeFactor * srcW + dstW - 1) / dstW;
        fsize = std::max(std::min(fsize, srcW - 2), 1);
        filt.assign((size_t)dstW * fsize, 0);
        const int64_t B = 0, C = (int64_t)(0.6 * (1 << 24));
        int64_t xDstInSrc = ((dstPos * (int64_t)xInc) >> 7) - ((srcPos * 0x10000LL) >> 7);
        for (int i = 0; i < dstW; i++) {
            int xx = (int)((xDstInSrc - (int64_t)(fsize - 2) * (1 << 16)) / (1 << 17));
            pos[i] = xx;
            for (int j = 0; j < fsize; j++, xx++) {
                int64_t d = std::abs((int64_t)xx * (1 << 17) - xDstInSrc) << 13;
                if (xInc > 1 << 16) d = d * dstW / srcW;
                int64_t coeff;
                if (d >= (int64_t)1 << 31) {
                    coeff = 0;
                } else {
                    int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
                    if (d < (int64_t)1 << 30)
                        coeff = (12 * ((int64_t)1 << 24) - 9 * B - 6 * C) * ddd +
                                (-18 * ((int64_t)1 << 24) + 12 * B + 6 * C) * dd +
                                (6 * ((int64_t)1 << 24) - 2 * B) * ((int64_t)1 << 30);
                    else
                        coeff = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd +
                                (-12 * B - 48 * C) * d + (8 * B + 24 * C) * ((int64_t)1 << 30);
                }
                filt[(size_t)i * fsize + j] = coeff / (((int64_t)1 << 54) / fone);
            }
            xDstInSrc += 2 * (int64_t)xInc;
        }
    }
    // reduce: drop near-zero taps on the left (shifting), count them on the right
    const double cut = 0.002 * (double)fone;
    int minsize = 0;
    for (int i = dstW - 1; i >= 0; i--) {
        int64_t* f = filt.data() + (size_t)i * fsize;
        int mn = fsize;
        int64_t acc = 0;
        for (int j = 0; j < fsize; j++) {
            acc += std::abs(f[0]);
            if ((double)acc > cut) break;
            if (i < dstW - 1 && pos[i] >= pos[i + 1]) break;
            for (int k = 1; k < fsize; k++) f[k - 1] = f[k];
            f[fsize - 1] = 0;
            pos[i]++;
        }
        acc = 0;
        for (int j = fsize - 1; j > 0; j--) {
            acc += std::abs(f[j]);
            if ((double)acc > cut) break;
            mn--;
        }
        minsize = std::max(minsize, mn);
    }
    if (minsize == 1 && filterAlign == 2) filterAlign = 1;  // unscaled vertical
    const int size = (minsize + filterAlign - 1) & ~(filterAlign - 1);
    std::vector<int64_t> g((size_t)dstW * size, 0);
    for (int i = 0; i < dstW; i++)
        for (int j = 0; j < std::min(size, fsize); j++)
            g[(size_t)i * size + j] = filt[(size_t)i * fsize + j];
    // borders: fold taps outside [0, srcW) onto the edge samples
    for (int i = 0; i < dstW; i++) {
        int64_t* f = g.data() + (size_t)i * size;
        if (pos[i] < 0) {
            for (int j = 1; j < size; j++) {
                int left = std::max(j + pos[i], 0);
                f[left] += f[j];
                f[j] = 0;
            }
            pos[i] = 0;
        }
        if (pos[i] + size > srcW) {
            int shift = pos[i] + std::min(size - srcW, 0);
            int64_t acc = 0;
            for (int j = size - 1; j >= 0; j--)
                if (pos[i] + j >= srcW) {
                    acc += f[j];
                    f[j] = 0;
                }
            for (int j = size - 1; j >= 0; j--) f[j] = j < shift ? 0 : f[j - shift];
            pos[i] -= shift;
            f[srcW - 1 - pos[i]] += acc;
        }
    }
    // normalise to ``one`` with error diffusion
    Filter out;
    out.size = size;
    out.pos = pos;
    out.coef.assign((size_t)dstW * size, 0);
    for (int i = 0; i < dstW; i++) {
        const int64_t* f = g.data() + (size_t)i * size;
        int64_t sum = 0, err = 0;
        for (int j = 0; j < size; j++) sum += f[j];
        sum = (sum + one / 2) / one;
        if (!sum) sum = 1;
        for (int j = 0; j < size; j++) {
            int64_t v = f[j] + err;
            int64_t iv = rounded_div(v, sum);
            out.coef[(size_t)i * size + j] = (int)iv;
            err = v - iv * sum;
        }
    }
    return out;
}

// hScale8To15 (8-bit samples) or hScale16To15 (9 to 14 bits: the sum
// shifted by the depth less one): one row -> 15-bit
template <typename T>
inline void hscale_to15(const T* src, int srcW, const Filter& f, int dstW, int16_t* dst, int bits = 8) {
    const int sh = bits == 8 ? 7 : bits - 1;
    for (int i = 0; i < dstW; i++) {
        int val = 0;
        const int* c = f.coef.data() + (size_t)i * f.size;
        for (int j = 0; j < f.size; j++)
            if (f.pos[i] + j < srcW) val += (int)src[f.pos[i] + j] * c[j];
        dst[i] = (int16_t)std::min(val >> sh, (1 << 15) - 1);
    }
}

// ff_yuv2rgb_c_init_tables' 24-bit lookup tables (BT.601), read by the C
// packed output functions
struct RgbTables {
    static constexpr int kHead = 512, kLumaHead = 512;
    std::vector<uint8_t> y;              // y[base + offset + Y]
    int base;                            // yoffs
    std::vector<int> rv, gu, gv, bu;     // offsets into y, by chroma + kHead
    RgbTables(bool video, int matrix) {
        // 16.16: at video range luma scaled by 255/219 and offset by 16, at
        // full range the chroma coefficients times 224/255; then the chroma
        // ones divided by the luma scale, since they index the luma table
        const InvMatrix& m = kMatrices[matrix];
        int64_t cy = 1 << 16, oy = 0, crv = m.crv, cbu = m.cbu, cgu = -m.cgu, cgv = -m.cgv;
        if (video) {
            cy = cy * 255 / 219;
            oy = 16 << 16;
        } else {
            crv = crv * 224 / 255;
            cbu = cbu * 224 / 255;
            cgu = cgu * 224 / 255;
            cgv = cgv * 224 / 255;
        }
        crv = (crv * 65536 + 0x8000) / cy;
        cbu = (cbu * 65536 + 0x8000) / cy;
        cgu = (cgu * 65536 + 0x8000) / cy;
        cgv = (cgv * 65536 + 0x8000) / cy;
        base = (video ? 326 : 384) + kLumaHead;
        y.resize(1024 + 2 * kLumaHead);
        int64_t yb = -((int64_t)384 << 16) - kLumaHead * cy - oy;
        for (size_t i = 0; i < y.size(); i++, yb += cy) y[i] = clip8((int)((yb + 0x8000) >> 16));
        auto fill = [](std::vector<int>& t, int64_t inc) {
            t.resize(256 + 2 * kHead);
            for (int i = 0; i < 256 + 2 * kHead; i++) {
                int64_t cb = (int64_t)std::min(std::max(i - kHead, 0), 255) * inc;
                t[i] = (int)(-(inc >> 9) + (cb >> 16));
            }
        };
        fill(rv, crv);
        fill(gu, cgu);
        fill(bu, cbu);
        fill(gv, cgv);
    }
    void pixel(int Y, int U, int V, uint8_t* bgr) const {
        U = std::min(std::max(U, -kHead), 255 + kHead) + kHead;
        V = std::min(std::max(V, -kHead), 255 + kHead) + kHead;
        bgr[0] = y[base + bu[U] + Y];
        bgr[1] = y[base + gu[U] + gv[V] + Y];
        bgr[2] = y[base + rv[V] + Y];
    }
};

inline const RgbTables& rgb_tables(bool video, int matrix) {
    static const RgbTables tables[10] = {{false, 0}, {true, 0}, {false, 1}, {true, 1},
                                         {false, 2}, {true, 2}, {false, 3}, {true, 3},
                                         {false, 4}, {true, 4}};
    return tables[2 * matrix + video];
}

// yuv2rgb_write_full (BGR24) from Y, U, V at 2^10 fixed point; the luma
// offset (yuv2rgb_y_offset, 16 << 9 at video range) at that scale
inline void full_pixel(int Y, int U, int V, const YuvCoeffs& k, uint8_t* bgr) {
    uint32_t yv = (uint32_t)((Y - (k.yoff << 6)) * k.y + (1 << 21));
    int32_t R = (int32_t)(yv + (uint32_t)V * (uint32_t)k.vr);
    int32_t G = (int32_t)(yv + (uint32_t)V * (uint32_t)k.vg + (uint32_t)U * (uint32_t)k.ug);
    int32_t B = (int32_t)(yv + (uint32_t)U * (uint32_t)k.ub);
    auto clip30 = [](int32_t x) { return x < 0 ? 0 : x > (1 << 30) - 1 ? (1 << 30) - 1 : x; };
    if ((R | G | B) & 0xC0000000) {
        R = clip30(R);
        G = clip30(G);
        B = clip30(B);
    }
    bgr[0] = (uint8_t)(B >> 22);
    bgr[1] = (uint8_t)(G >> 22);
    bgr[2] = (uint8_t)(R >> 22);
}

// get_local_pos: a chroma site (1/256 of a luma sample from the first
// luma sample's, the default centred one where negative) at a subsampling
inline int local_pos(int pos, int subsample) {
    if (pos < 0) pos = (128 << subsample) - 128;
    return (pos + 128) >> subsample;
}

// The scaler: Y (sw x sh) and U, V at ceil(sw >> hshift) x ceil(sh >>
// vshift), with the coefficients of the planes' range, to BGR24 at dw x dh;
// the chroma sited at (hpos, vpos) (1/256 of a luma sample; -1: swscale's
// default, centred), as FFmpeg 8's swscale takes the decoder's chroma
// location.  Luma goes through its own bicubic filters, the identity where
// the sizes agree.  The vertical pass is packed_vscale's choice: one tap
// (or two that blend) of luma and chroma, yuv2packed1; else the general
// yuv2packedX.  Returns false where swscale would take yuv2packed2 (two
// blending luma taps, which no bicubic filter between two real sizes has),
// which this header does not reproduce.
// ``bits``: the samples' depth (T uint16_t above 8: yuv4xxp10/12, which
// swscale reads through hScale16To15 and converts through the same path).
template <typename T>
inline bool scale_to_bgr(const T* y, int ystride, const T* u, const T* v,
                         int cstride, int sw, int sh, int hshift, int vshift, const YuvCoeffs& k,
                         uint8_t* bgr, int dw, int dh, int hpos = -1, int vpos = -1, int bits = 8) {
    const int w = dw, h = dh;
    const bool full = (w & 1) || (hshift == 0 && vshift == 0);
    const int csw = (sw + (1 << hshift) - 1) >> hshift, csh = (sh + (1 << vshift) - 1) >> vshift;
    const int cdw = full ? w : (w + 1) >> 1;
    const Filter lhf = init_filter(scale_inc(sw, w), sw, w, 4, 1 << 14);
    const Filter lvf = init_filter(scale_inc(sh, h), sh, h, 2, 1 << 12);
    const Filter hf = init_filter(scale_inc(csw, cdw), csw, cdw, 4, 1 << 14,
                                  local_pos(hpos, hshift), local_pos(-1, full ? 0 : 1));
    const Filter vf = init_filter(scale_inc(csh, h), csh, h, 2, 1 << 12,
                                  local_pos(vpos, vshift), local_pos(-1, 0));
    const int lfs = lvf.size, fs = vf.size;
    const bool lblend2 = lfs == 2 && [&] {
        for (int r = 0; r < h; r++) {
            const int* c = lvf.coef.data() + (size_t)r * 2;
            if (c[0] + c[1] != 4096 || (unsigned)c[1] > 4096u) return false;
        }
        return true;
    }();
    std::vector<int16_t> y15((size_t)sh * w), u15((size_t)csh * cdw), v15((size_t)csh * cdw);
    for (int r = 0; r < sh; r++)
        hscale_to15(y + (size_t)r * ystride, sw, lhf, w, y15.data() + (size_t)r * w, bits);
    for (int r = 0; r < csh; r++) {
        hscale_to15(u + (size_t)r * cstride, csw, hf, cdw, u15.data() + (size_t)r * cdw, bits);
        hscale_to15(v + (size_t)r * cstride, csw, hf, cdw, v15.data() + (size_t)r * cdw, bits);
    }
    const RgbTables& tab = rgb_tables(k.yoff != 0, k.matrix);
    std::vector<int> U(cdw), V(cdw), Y(w);
    for (int r = 0; r < h; r++) {
        uint8_t* out = bgr + (size_t)r * w * 3;
        const int* c = vf.coef.data() + (size_t)r * fs;
        const int* lc = lvf.coef.data() + (size_t)r * lfs;
        const int16_t* y0 = y15.data() + (size_t)lvf.pos[r] * w;
        const int16_t* u0 = u15.data() + (size_t)vf.pos[r] * cdw;
        const int16_t* v0 = v15.data() + (size_t)vf.pos[r] * cdw;
        // packed_vscale: one tap, or two that blend (yuv2packed1's uvalpha),
        // or the general filter (yuv2packedX)
        const bool blend2 = fs == 2 && c[0] + c[1] == 4096 && (unsigned)c[1] <= 4096u;
        if (lfs == 2 && lblend2 && blend2) return false;   // yuv2packed2
        const bool one = lfs == 1 && (fs == 1 || blend2);
        const int alpha = fs == 1 ? 0 : c[1];
        const int16_t* u1 = fs > 1 ? u0 + cdw : u0;
        const int16_t* v1 = fs > 1 ? v0 + cdw : v0;
        if (full) {  // yuv2bgr24_full_{1,X}_c
            for (int i = 0; i < cdw; i++) {
                if (one) {
                    U[i] = (u0[i] * (4096 - alpha) + u1[i] * alpha - (128 << 19)) >> 10;
                    V[i] = (v0[i] * (4096 - alpha) + v1[i] * alpha - (128 << 19)) >> 10;
                } else {
                    int su = (1 << 9) - (128 << 19), sv = su;
                    for (int j = 0; j < fs; j++) {
                        su += u0[(size_t)j * cdw + i] * c[j];
                        sv += v0[(size_t)j * cdw + i] * c[j];
                    }
                    U[i] = su >> 10;
                    V[i] = sv >> 10;
                }
            }
            for (int x = 0; x < w; x++) {
                int yy = 1 << 9;
                for (int j = 0; j < lfs; j++) yy += y0[(size_t)j * w + x] * lc[j];
                full_pixel(one ? y0[x] * 4 : yy >> 10, U[x], V[x], k, out + 3 * x);
            }
            continue;
        }
        if (r < h - 2) {  // the MMXEXT functions: 8x-scale words
            for (int i = 0; i < cdw; i++) {
                if (one) {  // yuv2bgr24_1: nearest or average
                    if (alpha < 2048) {
                        U[i] = u0[i] >> 4;
                        V[i] = v0[i] >> 4;
                    } else {
                        U[i] = (uint16_t)(u0[i] + u1[i]) >> 5;
                        V[i] = (uint16_t)(v0[i] + v1[i]) >> 5;
                    }
                } else {  // yuv2bgr24_X: pmulhw taps onto the rounder
                    int su = 4, sv = 4;
                    for (int j = 0; j < fs; j++) {
                        su = wrap16(su + mulhw(u0[(size_t)j * cdw + i], c[j]));
                        sv = wrap16(sv + mulhw(v0[(size_t)j * cdw + i], c[j]));
                    }
                    U[i] = su;
                    V[i] = sv;
                }
            }
            for (int x = 0; x < w; x++) {
                int y8 = y0[x] >> 4;
                if (!one) {
                    y8 = 4;
                    for (int j = 0; j < lfs; j++) y8 = wrap16(y8 + mulhw(y0[(size_t)j * w + x], lc[j]));
                }
                simd_pixel(y8, U[x >> 1], V[x >> 1], k, out + 3 * x);
            }
            continue;
        }
        for (int i = 0; i < cdw; i++) {  // the C functions, through the tables
            if (fs == 1 && one) {
                U[i] = (u0[i] + 64) >> 7;
                V[i] = (v0[i] + 64) >> 7;
            } else if (one) {
                U[i] = (u0[i] * (4096 - alpha) + u1[i] * alpha + (128 << 11)) >> 19;
                V[i] = (v0[i] * (4096 - alpha) + v1[i] * alpha + (128 << 11)) >> 19;
            } else {
                int su = 1 << 18, sv = 1 << 18;
                for (int j = 0; j < fs; j++) {
                    su += u0[(size_t)j * cdw + i] * c[j];
                    sv += v0[(size_t)j * cdw + i] * c[j];
                }
                U[i] = su >> 19;
                V[i] = sv >> 19;
            }
        }
        for (int x = 0; x < w; x++) {
            int yy = 1 << 18;
            for (int j = 0; j < lfs; j++) yy += y0[(size_t)j * w + x] * lc[j];
            tab.pixel(one ? (y0[x] + 64) >> 7 : yy >> 19, U[x >> 1], V[x >> 1], out + 3 * x);
        }
    }
    return true;
}

// --------------------------------------------- 16-bit RGB -> BGR24
// swscale's path for rgb48be/rgba64be -> BGR24 at the same size
// (SWS_BICUBIC): rgb48ToY_c/rgb48ToUV_c with fill_rgb2yuv_table's BT.601
// video-range coefficients (its special case for the default matrix:
// (int)(0.299 * 219 / 255 * 2^15 + 0.5), ...; RGB2YUV_SHIFT 15) into
// 16-bit Y, U, V; hScale16To15's identity filter (16384, >> 15: the
// sample halved); yuv2bgr24_full_1_c (full chroma, which swscale forces
// for unsubsampled input) with the video-range BT.601 coefficients.
// ``rgb``: n pixels of ``channels`` (3 or 4, the fourth ignored) native
// 16-bit samples in R, G, B order.
inline void rgb48_to_bgr(const uint16_t* rgb, int channels, int64_t n, uint8_t* bgr) {
    constexpr int64_t ry = 8414, gy = 16519, by = 3208;
    constexpr int64_t ru = -4865, gu = -9528, bu = 14392;
    constexpr int64_t rv = 14392, gv = -12061, bv = -2332;
    for (int64_t i = 0; i < n; i++, rgb += channels, bgr += 3) {
        const int64_t r = rgb[0], g = rgb[1], b = rgb[2];
        const int y16 = (int)((ry * r + gy * g + by * b + ((int64_t)0x2001 << 14)) >> 15);
        const int u16 = (int)((ru * r + gu * g + bu * b + ((int64_t)0x10001 << 14)) >> 15);
        const int v16 = (int)((rv * r + gv * g + bv * b + ((int64_t)0x10001 << 14)) >> 15);
        const int y15 = std::min(y16 >> 1, 32767), u15 = std::min(u16 >> 1, 32767),
                  v15 = std::min(v16 >> 1, 32767);
        full_pixel(y15 * 4, (u15 - (128 << 7)) * 4, (v15 - (128 << 7)) * 4, kVideoRange, bgr);
    }
}

// Planes -> BGR24 as swscale converts them: 4:2:0 (hshift 1, vshift 1)
// and 4:2:2 (1, 0) at an even height unscaled, everything else (an odd
// height, other subsamplings) through the scaler, which takes full-width
// chroma for an odd width and the chroma sites (hpos, vpos; see
// scale_to_bgr).  k: kVideoRange or kFullRange (FFmpeg's yuvj formats),
// or yuv_coeffs' for another matrix or a range the decoder reports.
inline void yuv_to_bgr(const uint8_t* y, int ystride, const uint8_t* u, const uint8_t* v,
                       int cstride, int w, int h, int hshift, int vshift,
                       const YuvCoeffs& k, uint8_t* bgr, int hpos = -1, int vpos = -1) {
    if (hshift == 1 && vshift <= 1 && !(h & 1))
        yuv_to_bgr_nearest(y, u, v, w, h, ystride, cstride, vshift, k, bgr);
    else
        scale_to_bgr(y, ystride, u, v, cstride, w, h, hshift, vshift, k, bgr, w, h, hpos, vpos);
}

}  // namespace ffdsp
