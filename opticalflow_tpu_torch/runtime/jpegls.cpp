// JPEG-LS pictures (fourcc MJLS in AVI, Matroska's V_MS/VFW/FOURCC,
// QuickTime, NUT and ASF), decoded in host C++ as FFmpeg 8's jpegls decoder
// (mjpegdec.c's markers and bit unstuffing, jpeglsdec.c, jpegls.c/h,
// golomb.h's get_ur_golomb_jpegls) decodes them for cv2.VideoCapture, bit
// for bit:
//
//   * the markers: SOI, SOF55 (0xFFF7: 8 bits or fewer, 1 or 3
//     components), LSE of type 1 (the preset parameters MAXVAL, T1-T3 and
//     RESET), SOS (its NEAR, the interleave mode ILV), APPn and COM passed
//     over, EOI; the scan's data runs to the next marker, a 0 bit stuffed
//     after each 0xFF byte dropped (ff_mjpeg_find_marker's JPEG-LS
//     unescaping);
//   * ILV 1 (line interleaved: each row's components one after another, as
//     libavcodec's jpegls encoder writes colour and cv2's writer asks for)
//     and ILV 0 with one component (grey);
//   * the coding: context modelling over the 365 regular contexts (the
//     gradients quantised by T1-T3, the sign folded, the bias C and its
//     correction B), the median edge detector, run mode with its 32-entry
//     run index (J: ff_log2_run) and its two run-interruption contexts,
//     limited-length Golomb codes with the escape of qbpp bits, RESET
//     halving, the default thresholds for MAXVAL (jpegls.c's
//     ff_jpegls_reset_coding_parameters);
//   * output: gray8, or rgb24 with component 1 first (init_image's
//     layout; cv2's swscale turns it to BGR24 as a copy).
//
// NEAR above 0 (near-lossless), palettes and the other LSE types, sample
// interleaving (ILV 2), ILV 0 over several components, restart intervals,
// point transforms and more than 8 bits raise kUnsupported; damaged data
// raises kCorrupt where FFmpeg's decoder fails or keeps a part-decoded
// picture.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "lossless_common.h"

namespace {

using lossless::Failure;
using lossless::corrupt;
using lossless::unsupported;

// the decoder's feature bits (jpegls.py's FEATURES, in order)
enum Feature { F_GRAY, F_RGB, F_ILV0, F_ILV1, F_RUN_MODE, F_ESCAPE, F_LSE, F_RESET };

// ff_log2_run: the run lengths' exponents (J of the standard, by run index)
const uint8_t kLog2Run[41] = {0, 0, 0,  0,  1,  1,  1,  1,  2,  2,  2,  2,  3,  3,  3,  3,  4,  4,  5,  5,  6,
                              6, 7, 7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24};

// JLSState
struct State {
    int T1 = 0, T2 = 0, T3 = 0;
    int A[367], B[367], C[365], N[367];
    int limit = 0, reset = 0, bpp = 8, qbpp = 0, maxval = 0, range = 0, near = 0, twonear = 1;
    int run_index[4] = {0, 0, 0, 0};

    static int iso_clip(int v, int vmin, int vmax) { return v > vmax || v < vmin ? vmin : v; }

    // ff_jpegls_reset_coding_parameters(state, 0)
    void reset_coding_parameters() {
        if (maxval == 0) maxval = (1 << bpp) - 1;
        if (maxval >= 128) {
            const int factor = (std::min(maxval, 4095) + 128) >> 8;
            if (T1 == 0) T1 = iso_clip(factor * (3 - 2) + 2 + 5 * near, near + 1, maxval);
            if (T2 == 0) T2 = iso_clip(factor * (7 - 3) + 3 + 7 * near, T1, maxval);
            if (T3 == 0) T3 = iso_clip(factor * (21 - 4) + 4 + 21 * near, T2, maxval);
        } else {
            const int factor = 256 / (maxval + 1);
            if (T1 == 0) T1 = iso_clip(std::max(2, 3 / factor + 3 * near), near + 1, maxval);
            if (T2 == 0) T2 = iso_clip(std::max(3, 7 / factor + 5 * near), T1, maxval);
            if (T3 == 0) T3 = iso_clip(std::max(4, 21 / factor + 7 * near), T2, maxval);
        }
        if (reset == 0) reset = 64;
    }

    // ff_jpegls_init_state
    void init() {
        twonear = near * 2 + 1;
        range = (maxval + twonear - 1) / twonear + 1;
        for (qbpp = 0; (1 << qbpp) < range; qbpp++) {
        }
        int log2 = 0;
        while ((maxval >> (log2 + 1)) > 0) log2++;
        bpp = std::max(log2 + 1, 2);
        limit = 2 * (bpp + std::max(bpp, 8)) - qbpp;
        for (int i = 0; i < 367; i++) {
            A[i] = std::max((range + 32) >> 6, 2);
            N[i] = 1;
            B[i] = 0;
        }
        std::memset(C, 0, sizeof C);
        std::memset(run_index, 0, sizeof run_index);
    }

    int quantize(int v) const {
        if (v == 0) return 0;
        if (v < 0) {
            if (v <= -T3) return -4;
            if (v <= -T2) return -3;
            if (v <= -T1) return -2;
            if (v < -near) return -1;
            return 0;
        }
        if (v <= near) return 0;
        if (v < T1) return 1;
        if (v < T2) return 2;
        if (v < T3) return 3;
        return 4;
    }

    void downscale(int q, int64_t& features) {
        if (N[q] == reset) {
            A[q] >>= 1;
            B[q] >>= 1;
            N[q] >>= 1;
            features |= 1 << F_RESET;
        }
        N[q]++;
    }

    // ff_jpegls_update_state_regular
    int update_regular(int q, int err, int64_t& features) {
        if (std::abs(err) > 0xFFFF || std::abs(err) > 0x7FFFFFFF - A[q]) corrupt("an error value out of range");
        A[q] += std::abs(err);
        err *= twonear;
        B[q] += err;
        downscale(q, features);
        if (B[q] <= -N[q]) {
            B[q] = std::max(B[q] + N[q], 1 - N[q]);
            if (C[q] > -128) C[q]--;
        } else if (B[q] > 0) {
            B[q] = std::min(B[q] - N[q], 0);
            if (C[q] < 127) C[q]++;
        }
        return err;
    }
};

// MSB-first reader over the unstuffed scan (zeros past its end)
struct Reader {
    std::vector<uint8_t> buf;   // padded with 8 zero bytes
    int64_t size = 0, pos = 0;   // bits
    unsigned bit() {
        const unsigned v = buf[pos >> 3] >> (7 - (pos & 7)) & 1;
        pos++;
        return v;
    }
    unsigned bits(int n) {
        unsigned v = 0;
        for (int i = 0; i < n; i++) v = v << 1 | bit();
        return v;
    }
    int64_t left() const { return size - pos; }
};

struct Decoder {
    int width = 0, height = 0, comps = 0, bits = 0;
    int maxval = 0, t1 = 0, t2 = 0, t3 = 0, reset = 0;   // LSE type 1
    int64_t features = 0;
    std::vector<uint8_t> pic;   // packed, comps bytes a pixel
    State st;
    Reader gb;

    // get_ur_golomb_jpegls: a unary prefix of at most limit zeros, then k
    // bits, or the escape's esc bits (plus one) after limit - 1 zeros
    int golomb(int k, int limit, int esc) {
        int i = 0;
        while (i < limit && gb.bit() == 0) i++;
        if (i < limit - 1) return (int)(((unsigned)i << k) + (k ? gb.bits(k) : 0));
        if (i == limit - 1) {
            features |= 1 << F_ESCAPE;
            return (int)gb.bits(esc) + 1;
        }
        corrupt("a Golomb code longer than its limit");
    }

    int code_regular(int q) {
        int k = 0;
        while (((unsigned)st.N[q] << k) < (unsigned)st.A[q] && k < 32) k++;
        int ret = golomb(k, st.limit, st.qbpp);
        ret = (ret & 1) ? -((ret + 1) >> 1) : ret >> 1;
        if (!st.near && !k && 2 * st.B[q] <= -st.N[q]) ret = -(ret + 1);
        return st.update_regular(q, ret, features);
    }

    int code_runterm(int ritype, int limit_add) {
        const int q = 365 + ritype;
        int temp = st.A[q];
        if (ritype) temp += st.N[q] >> 1;
        int k = 0;
        while (((unsigned)st.N[q] << k) < (unsigned)temp && k < 32) k++;
        int ret = golomb(k, st.limit - limit_add - 1, st.qbpp);
        int map = 0;
        if (!k && (ritype || ret) && 2 * st.B[q] < st.N[q]) map = 1;
        ret += ritype + map;
        if (ret & 1) {
            ret = map - ((ret + 1) >> 1);
            st.B[q]++;
        } else {
            ret >>= 1;
        }
        if (std::abs(ret) > 0xFFFF) corrupt("a run interruption value out of range");
        st.A[q] += std::abs(ret) - ritype;
        ret *= st.twonear;
        st.downscale(q, features);
        return ret;
    }

    // ls_decode_line over one row of component comp (8 bits)
    void decode_line(const uint8_t* last, uint8_t* dst, int last2, int w, int stride, int comp) {
        int x = 0;
        while (x < w) {
            if (gb.left() <= 0) corrupt("the scan ends inside the picture");
            int Ra = x ? dst[x - stride] : last[x];
            int Rb = last[x];
            const int Rc = x ? last[x - stride] : last2;
            const int Rd = x >= w - stride ? last[x] : last[x + stride];
            const int D0 = Rd - Rb, D1 = Rb - Rc, D2 = Rc - Ra;
            int pred, err;
            if (std::abs(D0) <= st.near && std::abs(D1) <= st.near && std::abs(D2) <= st.near) {
                features |= 1 << F_RUN_MODE;
                int& ri = st.run_index[comp];
                while (gb.bit()) {
                    int r = 1 << kLog2Run[ri];
                    if (x + r * stride > w) r = (w - x) / stride;
                    for (int i = 0; i < r; i++) {
                        dst[x] = (uint8_t)Ra;
                        x += stride;
                    }
                    if (r != 1 << kLog2Run[ri]) return;
                    if (ri < 31) ri++;
                    if (x + stride > w) return;
                    if (gb.left() < -64) corrupt("the scan ends inside a run");
                }
                int r = kLog2Run[ri];
                if (r) r = (int)gb.bits(r);
                if (x + r * stride > w) r = (w - x) / stride;
                for (int i = 0; i < r; i++) {
                    dst[x] = (uint8_t)Ra;
                    x += stride;
                }
                if (x >= w) corrupt("run overflow");
                Rb = last[x];
                const int ritype = std::abs(Ra - Rb) <= st.near ? 1 : 0;
                err = code_runterm(ritype, kLog2Run[ri]);
                if (ri) ri--;
                if (st.near && ritype)
                    pred = Ra + err;
                else
                    pred = Rb < Ra ? Rb - err : Rb + err;
            } else {
                int context = st.quantize(D0) * 81 + st.quantize(D1) * 9 + st.quantize(D2);
                pred = lossless::mid_pred(Ra, Ra + Rb - Rc, Rb);
                if (context < 0) {
                    context = -context;
                    pred = std::clamp(pred - st.C[context], 0, st.maxval);
                    err = -code_regular(context);
                } else {
                    pred = std::clamp(pred + st.C[context], 0, st.maxval);
                    err = code_regular(context);
                }
                pred += err;
            }
            dst[x] = (uint8_t)(pred & st.maxval);
            x += stride;
        }
    }

    // ff_mjpeg_find_marker's JPEG-LS branch: the scan from p to the next
    // marker, a stuffed 0 bit after each 0xFF dropped; the bytes it took
    int64_t unstuff(const uint8_t* p, int64_t n) {
        int64_t t = 0;
        while (t < n) {
            uint8_t x = p[t++];
            if (x == 0xFF) {
                while (t < n && x == 0xFF) x = p[t++];
                if (x & 0x80) {
                    t -= std::min<int64_t>(2, t);
                    break;
                }
            }
        }
        gb.buf.assign((size_t)t + 16, 0);
        int64_t bitpos = 0, count = t * 8;
        auto put = [&](unsigned v, int nbits) {
            for (int i = nbits - 1; i >= 0; i--, bitpos++)
                if (v >> i & 1) gb.buf[bitpos >> 3] |= (uint8_t)(0x80 >> (bitpos & 7));
        };
        for (int64_t b = 0; b < t;) {
            uint8_t x = p[b++];
            put(x, 8);
            if (x == 0xFF && b < t) {
                x = p[b++] & 0x7F;
                put(x, 7);
                count--;
            }
        }
        gb.size = ((count + 7) >> 3) * 8;
        gb.pos = 0;
        return t;
    }

    void scan(int near, int ilv, int point_transform) {
        if (point_transform) unsupported("a point transform");
        if (near) unsupported("near-lossless coding (NEAR " + std::to_string(near) + ")");
        if (ilv == 2) unsupported("sample interleaving (ILV 2)");
        if (ilv > 2) unsupported("interleave mode " + std::to_string(ilv));
        if (ilv == 0 && comps > 1) unsupported("one scan a component (ILV 0 over 3 components)");
        features |= 1 << (ilv ? F_ILV1 : F_ILV0);
        st.near = near;
        st.bpp = bits < 2 ? 2 : bits;
        st.maxval = maxval;
        st.T1 = t1;
        st.T2 = t2;
        st.T3 = t3;
        st.reset = reset;
        st.reset_coding_parameters();
        st.init();
        if (st.maxval > 255) unsupported("MAXVAL above 255 at 8 bits");
        if (gb.left() < height) corrupt("a scan shorter than a bit a row");
        const int stride = comps, w = width * stride;
        std::vector<uint8_t> zero((size_t)w, 0);
        const uint8_t* last = zero.data();
        int rc[3] = {0, 0, 0};
        for (int i = 0; i < height; i++) {
            uint8_t* cur = pic.data() + (size_t)i * w;
            for (int j = 0; j < stride; j++) {
                decode_line(last + j, cur + j, rc[j], w, stride, j);
                rc[j] = last[j];
            }
            last = cur;
        }
    }

    // the markers up to the scan, which is decoded unless probe (the
    // picture's size is read from SOF55 then)
    void decode(const uint8_t* d, int64_t n, bool probe = false) {
        if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) corrupt("no SOI marker");
        maxval = t1 = t2 = t3 = reset = 0;
        bool sof = false, done = false;
        int64_t pos = 2;
        while (pos + 4 <= n && !done) {
            if (d[pos] != 0xFF) {   // garbage before a marker: FFmpeg skips it
                pos++;
                continue;
            }
            const int m = d[pos + 1];
            if (m == 0xFF || m < 0xC0) {
                pos++;
                continue;
            }
            pos += 2;
            if (m == 0xD9) break;
            if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) continue;
            const int len = d[pos] << 8 | d[pos + 1];
            if (len < 2 || pos + len > n) corrupt("a marker segment past the packet");
            const uint8_t* s = d + pos + 2;
            switch (m) {
                case 0xF7: {   // SOF55
                    if (len < 8) corrupt("a short SOF55");
                    bits = s[0];
                    height = s[1] << 8 | s[2];
                    width = s[3] << 8 | s[4];
                    comps = s[5];
                    if (bits > 8) unsupported(std::to_string(bits) + "-bit samples");
                    if (bits < 2) unsupported(std::to_string(bits) + "-bit samples");
                    if (comps != 1 && comps != 3) unsupported(std::to_string(comps) + " components");
                    if (len < 8 + 3 * comps) corrupt("a short SOF55");
                    for (int c = 0; c < comps; c++)
                        if (s[6 + 3 * c + 1] != 0x11) unsupported("subsampled components");
                    // ff_set_dimensions' av_image_check_size
                    if (width <= 0 || height <= 0 || (int64_t)(width + 128) * (height + 128) >= INT32_MAX / 8)
                        corrupt("picture size " + std::to_string(width) + "x" + std::to_string(height));
                    if (probe) return;
                    pic.assign((size_t)width * height * comps, 0);
                    features |= 1 << (comps == 3 ? F_RGB : F_GRAY);
                    sof = true;
                    break;
                }
                case 0xF8: {   // LSE
                    if (len < 3) corrupt("a short LSE");
                    const int id = s[0];
                    if (id == 1) {
                        if (len < 13) corrupt("a short LSE");
                        maxval = s[1] << 8 | s[2];
                        t1 = s[3] << 8 | s[4];
                        t2 = s[5] << 8 | s[6];
                        t3 = s[7] << 8 | s[8];
                        reset = s[9] << 8 | s[10];
                        features |= 1 << F_LSE;
                    } else if (id == 2 || id == 3) {
                        unsupported("a palette (LSE " + std::to_string(id) + ")");
                    } else {
                        unsupported("LSE type " + std::to_string(id));
                    }
                    break;
                }
                case 0xDD: unsupported("restart intervals");
                case 0xDA: {   // SOS: the header, then the scan
                    if (!sof) corrupt("a scan before the frame header");
                    const int ns = s[0];
                    if (len < 6 + 2 * ns || ns < 1) corrupt("a short SOS");
                    if (ns != comps && !(ns == 1 && comps == 1)) unsupported("a scan of some of the components");
                    const int near = s[1 + 2 * ns], ilv = s[2 + 2 * ns], al = s[3 + 2 * ns] & 15;
                    unstuff(d + pos + len, n - pos - len);
                    scan(near, ilv, al);
                    done = true;
                    break;
                }
                default:
                    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC)
                        unsupported("a JPEG frame other than JPEG-LS (SOF" + std::to_string(m - 0xC0) + ")");
                    break;   // APPn, COM, DQT, DHT: passed over
            }
            pos += len;
        }
        if (!done) corrupt(sof ? "no scan" : "no SOF55 frame header");
    }
};

}  // namespace

extern "C" {

void* jls_dec_new() { return new Decoder(); }

void jls_dec_free(void* h) { delete (Decoder*)h; }

// decode one picture, or (probe != 0) read its size alone
int jls_dec_decode(void* h, const uint8_t* d, int64_t n, int64_t probe, char* msg, int64_t cap) {
    try {
        ((Decoder*)h)->decode(d, n, probe != 0);
        return lossless::OK;
    } catch (const Failure& f) {
        lossless::put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// the last picture's (width, height, components)
void jls_dec_layout(void* h, int64_t* out) {
    const Decoder* dec = (Decoder*)h;
    out[0] = dec->width;
    out[1] = dec->height;
    out[2] = dec->comps;
}

// its samples, packed: gray8, or rgb24 (component 1 first)
void jls_dec_output(void* h, uint8_t* out) {
    const Decoder* dec = (Decoder*)h;
    std::memcpy(out, dec->pic.data(), dec->pic.size());
}

int64_t jls_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
