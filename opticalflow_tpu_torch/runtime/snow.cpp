// Snow decoded in host C++ as FFmpeg 8's snow decoder (snowdec.c, snow.c,
// snow.h, snow_dwt.c, rangecoder.h, h264qpel_template.c) decodes it for
// cv2.VideoCapture, bit for bit:
//
//   * the range coder and its symbols (rangecoder.h, shared with FFV1;
//     get_symbol2 with its log2 context);
//   * the frame header: a key frame's version, colour space and chroma
//     shifts, decomposition count, reference count and quantiser logs; each
//     frame's deltas of the wavelet type, qlog, mv_scale, qbias and block
//     depth, and an inter frame's new decomposition count with its logs;
//     FFmpeg's range checks;
//   * the block tree (decode_q_branch): intra blocks with their colour, the
//     reference index, motion vectors predicted by the median of left, top
//     and top-right (scaled between references), the quadtree one level
//     deep;
//   * the coefficients (unpack_coeffs: runs and contexts from the left, top
//     and parent coefficients), their dequantisation (ff_qexp, qbias,
//     lossless at LOSSLESS_QLOG) and the LL band's median correlation;
//   * the inverse 9/7 and 5/3 integer lifting (snow_dwt.c), each step
//     stored back into 16 bits as FFmpeg's IDWTELEM lines are;
//   * the prediction: overlapped block motion compensation with the OBMC
//     windows, each block predicted by h264's 6-tap qpel where the block and
//     vector allow and by mc_block's half-pel planes otherwise, references
//     read with their edges replicated, added to the residual in FRAC_BITS
//     before the final rounding and clip (ff_snow_inner_add_yblock);
//   * the reference list of max_ref_frames pictures back to the last key
//     frame (ff_snow_frames_prepare).
//
// The picture size comes from the container; the planes come out as the
// decoder's pixel format lays them (yuv420p, yuv410p, yuv444p or gray).
// What libavcodec's encoder never writes (an MC filter other than its default, a temporal
// decomposition, spatial scalability, always_reset, other colour spaces
// and chroma shifts) raises SNOW_UNSUPPORTED with a message naming it;
// damaged data raises SNOW_CORRUPT.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

#include "h264_qpel.h"
#include "rangecoder.h"
#include "snow_tables.h"

namespace {

enum { SNOW_OK = 0, SNOW_UNSUPPORTED = 2, SNOW_CORRUPT = 3 };

constexpr int kMidState = 128;
constexpr int kMaxDecompositions = 8;
constexpr int kMaxRefFrames = 8;
constexpr int kQShift = 5;
constexpr int kQRoot = 1 << kQShift;
constexpr int kLosslessQlog = -128;
constexpr int kFracBits = 4;
constexpr int kQExpShift = 7 - kFracBits + 8;
constexpr int kQBiasShift = 3;
constexpr int kMbSize = 16;
constexpr int kHTapsMax = 8;
constexpr int kBlockIntra = 1;
constexpr int kWin = 64;       // the stride of the prediction's scratch planes

struct Failure {
    int kind;
    std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Failure{SNOW_CORRUPT, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Failure{SNOW_UNSUPPORTED, m}; }
[[noreturn]] void symbol_overlong() { corrupt("a range-coded symbol longer than 32 bits"); }

using RangeCoder = rangecoder::Coder<symbol_overlong>;

// the decoder's feature bits (snow.py's FEATURES, in order)
enum Feature {
    F_KEY, F_INTER, F_DWT97, F_DWT53, F_LOSSLESS, F_YUV420, F_YUV410, F_YUV444, F_GRAY,
    F_HPEL, F_QPEL, F_SPLIT, F_INTRA_BLOCK, F_REFS, F_REF_INDEX, F_MC_H264, F_MC_BLOCK,
    F_MC_BILINEAR, F_EDGE, F_QBIAS, F_COUNT_UPDATE, F_QLOG_DELTA, F_ALWAYS_RESET, F_TEMPORAL,
    F_SCALABILITY, F_MC_FILTER, F_NO_DIAG_MC,
};

// a plane's half-pel filter (update_mc): ff_snow_common_init's defaults,
// the fast_mc filter (H.264's 6 taps: 40/-10/2) with diagonal positions
struct McFilter {
    int diag_mc = 1, htaps = 6;
    int hcoeff[4] = {40, -10, 2, 0};
    bool fast = true;
};

std::string fmt(const char* f, long long a, long long b = 0) {
    char buf[200];
    std::snprintf(buf, sizeof buf, f, a, b);
    return buf;
}

int av_log2(unsigned v) { return 31 - __builtin_clz(v | 1); }

int mid_pred(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

int mirror(int x, int w) {     // avpriv_mirror
    if (!w) return 0;
    while ((unsigned)x > (unsigned)w) {
        x = -x;
        if (x < 0) x += 2 * w;
    }
    return x;
}

uint8_t clip8(int v) { return uint8_t(v & ~255 ? ~(v >> 31) : v); }

const uint8_t kQExp[kQRoot] = {128, 131, 134, 137, 140, 143, 146, 149, 152, 156, 159,
                               162, 166, 170, 173, 177, 181, 185, 189, 193, 197, 202,
                               206, 211, 215, 220, 225, 230, 235, 240, 245, 251};

int quant3bA(int v) { return v < 2 ? 0 : (v & 1 ? -1 : 1); }   // ff_quant3bA[v & 0xFF]

// ------------------------------------------------------------ symbols

int get_symbol2(RangeCoder& c, uint8_t* state, int log2) {
    unsigned r = log2 >= 0 ? 1u << log2 : 1u;
    unsigned v = 0;
    while (log2 < 28 && c.bit(state + 4 + log2)) {
        v += r;
        log2++;
        if (log2 > 0) r += r;
    }
    for (int i = log2 - 1; i >= 0; i--) v += unsigned(c.bit(state + 31 - i)) << i;
    return int(v);
}

// ------------------------------------------------------------ inverse DWT

// snow_dwt.c's inv_lift / inv_liftS on IDWTELEM lines
void inv_lift(int16_t* dst, const int16_t* src, const int16_t* ref, int dst_step, int src_step, int ref_step,
              int width, int mul, int add, int shift, int highpass, int inverse) {
    const int mirror_left = !highpass;
    const int mirror_right = (width & 1) ^ highpass;
    const int w = (width >> 1) - 1 + (highpass & width);
    auto lift = [&](int s, int r) { return inverse ? s - r : s + r; };
    if (mirror_left) {
        dst[0] = int16_t(lift(src[0], (mul * 2 * ref[0] + add) >> shift));
        dst += dst_step;
        src += src_step;
    }
    for (int i = 0; i < w; i++)
        dst[i * dst_step] =
            int16_t(lift(src[i * src_step], (mul * (ref[i * ref_step] + ref[(i + 1) * ref_step]) + add) >> shift));
    if (mirror_right) dst[w * dst_step] = int16_t(lift(src[w * src_step], (mul * 2 * ref[w * ref_step] + add) >> shift));
}

void inv_liftS(int16_t* dst, const int16_t* src, const int16_t* ref, int dst_step, int src_step, int ref_step,
               int width, int mul, int add, int shift, int highpass) {
    const int mirror_left = !highpass;
    const int mirror_right = (width & 1) ^ highpass;
    const int w = (width >> 1) - 1 + (highpass & width);
    auto lifts = [&](int s, int r) { return s + ((r + 4 * s) >> shift); };
    if (mirror_left) {
        dst[0] = int16_t(lifts(src[0], mul * 2 * ref[0] + add));
        dst += dst_step;
        src += src_step;
    }
    for (int i = 0; i < w; i++)
        dst[i * dst_step] = int16_t(lifts(src[i * src_step], mul * (ref[i * ref_step] + ref[(i + 1) * ref_step]) + add));
    if (mirror_right) dst[w * dst_step] = int16_t(lifts(src[w * src_step], mul * 2 * ref[w * ref_step] + add));
}

// W_AM.. W_DS of snow_dwt.h
void horizontal_compose97i(int16_t* b, int16_t* temp, int width) {
    const int w2 = (width + 1) >> 1;
    inv_lift(temp, b, b + w2, 1, 1, 1, width, 3, 4, 3, 0, 1);
    inv_lift(temp + w2, b + w2, temp, 1, 1, 1, width, 1, 0, 0, 1, 1);
    inv_liftS(b, temp, temp + w2, 2, 1, 1, width, 1, 8, 4, 0);
    inv_lift(b + 1, temp + w2, b, 2, 1, 2, width, 3, 0, 1, 1, 0);
}

void horizontal_compose53i(int16_t* b, int16_t* temp, int width) {
    const int width2 = width >> 1;
    const int w2 = (width + 1) >> 1;
    int x;
    for (x = 0; x < width2; x++) {
        temp[2 * x] = b[x];
        temp[2 * x + 1] = b[x + w2];
    }
    if (width & 1) temp[2 * x] = b[x];
    b[0] = int16_t(temp[0] - ((temp[1] + 1) >> 1));
    for (x = 2; x < width - 1; x += 2) {
        b[x] = int16_t(temp[x] - ((temp[x - 1] + temp[x + 1] + 2) >> 2));
        b[x - 1] = int16_t(temp[x - 1] + ((b[x - 2] + b[x] + 1) >> 1));
    }
    if (width & 1) {
        b[x] = int16_t(temp[x] - ((temp[x - 1] + 1) >> 1));
        b[x - 1] = int16_t(temp[x - 1] + ((b[x - 2] + b[x] + 1) >> 1));
    } else {
        b[x - 1] = int16_t(temp[x - 1] + b[x - 2]);
    }
}

// the inverse transform of one plane, coarsest level first, each level
// composed two lines at a time as spatial_compose97i_dy/53i_dy do (the
// slice-buffered decode gives the same lines)
void spatial_idwt(int16_t* buf, int16_t* temp, int width, int height, int stride, int type, int count) {
    for (int level = count - 1; level >= 0; level--) {
        const int w = width >> level, h = height >> level;
        const ptrdiff_t sl = ptrdiff_t(stride) << level;
        auto line = [&](int y) { return buf + mirror(y, h - 1) * sl; };
        auto in = [&](int y) { return (unsigned)y < (unsigned)h; };
        if (type == 0) {
            int16_t *b0 = line(-4), *b1 = line(-3), *b2 = line(-2), *b3 = line(-1);
            for (int y = -3; y <= h; y += 2) {
                int16_t* b4 = line(y + 3);
                int16_t* b5 = line(y + 4);
                if (in(y + 3))
                    for (int i = 0; i < w; i++) b4[i] = int16_t(b4[i] - ((3 * (b3[i] + b5[i]) + 4) >> 3));
                if (in(y + 2))
                    for (int i = 0; i < w; i++) b3[i] = int16_t(b3[i] - (b2[i] + b4[i]));
                if (in(y + 1))
                    for (int i = 0; i < w; i++) b2[i] = int16_t(b2[i] + ((b1[i] + b3[i] + 4 * b2[i] + 8) >> 4));
                if (in(y))
                    for (int i = 0; i < w; i++) b1[i] = int16_t(b1[i] + ((3 * (b0[i] + b2[i])) >> 1));
                if (in(y - 1)) horizontal_compose97i(b0, temp, w);
                if (in(y)) horizontal_compose97i(b1, temp, w);
                b0 = b2;
                b1 = b3;
                b2 = b4;
                b3 = b5;
            }
        } else {
            int16_t *b0 = line(-2), *b1 = line(-1);
            for (int y = -1; y <= h; y += 2) {
                int16_t* b2 = line(y + 1);
                int16_t* b3 = line(y + 2);
                if (in(y + 1))
                    for (int i = 0; i < w; i++) b2[i] = int16_t(b2[i] - ((b1[i] + b3[i] + 2) >> 2));
                if (in(y))
                    for (int i = 0; i < w; i++) b1[i] = int16_t(b1[i] + ((b0[i] + b2[i]) >> 1));
                if (in(y - 1)) horizontal_compose53i(b0, temp, w);
                if (in(y)) horizontal_compose53i(b1, temp, w);
                b0 = b2;
                b1 = b3;
            }
        }
    }
}

// ------------------------------------------------------------ motion compensation

// the half-pel filter over the 8 samples a[0..7] a step apart, centred
// between a[3] and a[4]: H.264's 6 taps (fast_mc), else the plane's
template <typename T>
int hpel_taps(const T* a, int step, const McFilter& f) {
    if (f.fast) return 20 * (a[3 * step] + a[4 * step]) - 5 * (a[2 * step] + a[5 * step]) + (a[step] + a[6 * step]);
    return f.hcoeff[0] * (a[3 * step] + a[4 * step]) + f.hcoeff[1] * (a[2 * step] + a[5 * step]) +
           f.hcoeff[2] * (a[step] + a[6 * step]) + f.hcoeff[3] * (a[0] + a[7 * step]);
}

// snow.c's mc_block with the plane's filter (its 6-tap fast_mc form, or
// the general one FFmpeg takes when fast_mc is off; without diag_mc every
// position is bilinear between the half-pel planes):
// src is the window's corner, 3 pixels above and left of the block
int mc_block(uint8_t* dst, int ds, const uint8_t* src, int ss, int b_w, int b_h, int dx, int dy, const McFilter& f) {
    using namespace snow_tables;
    int16_t tmpIt[64 * (32 + kHTapsMax)];
    uint8_t tmp2t[3][64 * (32 + kHTapsMax)];
    const uint8_t* hpel[11] = {};
    const int r = kBrane[dx + 16 * dy] & 15;
    const int l = kBrane[dx + 16 * dy] >> 4;
    const int b = f.diag_mc ? kNeeds[l] | kNeeds[r] : 15;
    // fast_mc rounds the 6 taps' sum of 32 by 5 bits, the general filter
    // its sum of 64 by 6
    const int sh = f.fast ? 5 : 6;
    if (b & 5) {
        const uint8_t* s = src;
        for (int y = 0; y < b_h + kHTapsMax - 1; y++, s += ss) {
            for (int x = 0; x < b_w; x++) {
                const int am = hpel_taps(s + x, 1, f);
                tmpIt[y * 64 + x] = int16_t(am);
                tmp2t[0][y * 64 + x] = clip8((am + (1 << (sh - 1))) >> sh);
            }
        }
    }
    const uint8_t* s = src + kHTapsMax / 2 - 1;
    if (b & 2) {
        for (int y = 0; y < b_h; y++)
            for (int x = 0; x < b_w + 1; x++)
                tmp2t[1][y * 64 + x] = clip8((hpel_taps(s + y * ss + x, ss, f) + (1 << (sh - 1))) >> sh);
    }
    s += ss * (kHTapsMax / 2 - 1);
    if (b & 4) {
        for (int y = 0; y < b_h; y++)
            for (int x = 0; x < b_w; x++)
                tmp2t[2][y * 64 + x] =
                    clip8((hpel_taps(tmpIt + y * 64 + x, 64, f) + (1 << (2 * sh - 1))) >> (2 * sh));
    }
    hpel[0] = s;
    hpel[1] = tmp2t[0] + 64 * (kHTapsMax / 2 - 1);
    hpel[2] = s + 1;
    hpel[4] = tmp2t[1];
    hpel[5] = tmp2t[2];
    hpel[6] = tmp2t[1] + 1;
    hpel[8] = s + ss;
    hpel[9] = hpel[1] + 64;
    hpel[10] = hpel[8] + 1;
    auto mc_stride = [&](int i) { return kNeeds[i] ? 64 : ss; };
    if (b == 15) {
        const int dxy = dx / 8 + dy / 8 * 4;
        const uint8_t *s1 = hpel[dxy], *s2 = hpel[dxy + 1], *s3 = hpel[dxy + 4], *s4 = hpel[dxy + 5];
        const int st1 = mc_stride(dxy), st2 = mc_stride(dxy + 1), st3 = mc_stride(dxy + 4), st4 = mc_stride(dxy + 5);
        const int fx = dx & 7, fy = dy & 7;
        for (int y = 0; y < b_h; y++, s1 += st1, s2 += st2, s3 += st3, s4 += st4, dst += ds)
            for (int x = 0; x < b_w; x++)
                dst[x] = uint8_t(((8 - fx) * (8 - fy) * s1[x] + fx * (8 - fy) * s2[x] + (8 - fx) * fy * s3[x] +
                                  fx * fy * s4[x] + 32) >> 6);
        return F_MC_BILINEAR;
    }
    const uint8_t *s1 = hpel[l], *s2 = hpel[r];
    const int st1 = mc_stride(l), st2 = mc_stride(r);
    const int a = kWeight[(dx & 7) + 8 * (dy & 7)];
    const int bw = 8 - a;
    for (int y = 0; y < b_h; y++, s1 += st1, s2 += st2, dst += ds)
        for (int x = 0; x < b_w; x++) dst[x] = uint8_t((a * s1[x] + bw * s2[x] + 4) >> 3);
    return F_MC_BLOCK;
}

// ------------------------------------------------------------ the decoder

struct Block {
    int16_t mx = 0, my = 0;
    uint8_t ref = 0;
    uint8_t color[3] = {0, 0, 0};
    uint8_t type = 0;
    uint8_t level = 0;
};

Block null_block() {
    Block b;
    b.color[0] = b.color[1] = b.color[2] = 128;
    return b;
}

struct XC {     // x_and_coeff
    int16_t x;
    uint16_t coeff;
};

struct Band {
    int level = 0, width = 0, height = 0, qlog = 0;
    int stride_line = 0, x0 = 0, y0 = 0;   // its lines in the plane's buffer
    Band* parent = nullptr;
    std::vector<XC> xc;
    uint8_t state[7 + 512][32];
};

struct Plane {
    int width = 0, height = 0;
    Band band[kMaxDecompositions][4];
};

struct Picture {
    std::vector<uint8_t> data[3];
    bool key = false;
    bool valid() const { return !data[0].empty(); }
    void release() {
        for (auto& d : data) std::vector<uint8_t>().swap(d);
        key = false;
    }
};

struct Decoder {
    int width = 0, height = 0;
    RangeCoder c;
    uint8_t header_state[32];
    uint8_t block_state[128 + 32 * 128];
    int keyframe = 0, always_reset = 0;
    int spatial_count = 1, hshift = 0, vshift = 0, nb_planes = 0;
    int max_ref_frames = 1, ref_frames = 0;
    int spatial_type = 0, qlog = 0, qbias = 0, mv_scale = 0, block_max_depth = 0;
    bool have_key = false;
    int layout = -1;            // nb_planes, hshift, vshift of the first key frame
    int b_width = 0, b_height = 0;
    std::vector<Block> blocks;
    Plane plane[3];
    McFilter mc[3];
    Picture last[kMaxRefFrames];
    Picture cur;
    std::vector<int16_t> idwt, temp;
    int64_t features = 0;
    bool prepared = false;      // the references rotated for this frame

    void mark(int f) { features |= int64_t(1) << f; }

    void reset_contexts() {
        for (auto& p : plane)
            for (int level = 0; level < kMaxDecompositions; level++)
                for (int o = level ? 1 : 0; o < 4; o++) std::memset(p.band[level][o].state, kMidState, sizeof p.band[level][o].state);
        std::memset(header_state, kMidState, sizeof header_state);
        std::memset(block_state, kMidState, sizeof block_state);
    }

    Decoder(int w, int h) : width(w), height(h) { reset_contexts(); }

    void decode_qlogs() {
        for (int pi = 0; pi < nb_planes; pi++)
            for (int level = 0; level < spatial_count; level++)
                for (int o = level ? 1 : 0; o < 4; o++) {
                    int q;
                    if (pi == 2)
                        q = plane[1].band[level][o].qlog;
                    else if (o == 2)
                        q = plane[pi].band[level][1].qlog;
                    else
                        q = c.symbol(header_state, true);
                    plane[pi].band[level][o].qlog = q;
                }
    }

    // update_mc: the first two planes' diag_mc, htaps and hcoeff (each
    // coefficient from htaps/2 down to 1; the one at 0 makes their sum 32;
    // those above htaps/2 keep their values), the third plane's copied from
    // the second's, as snowdec.c's decode_header reads them
    void read_mc() {
        for (int pi = 0; pi < std::min(nb_planes, 2); pi++) {
            McFilter& f = mc[pi];
            f.diag_mc = c.bit(header_state);
            const int sym = c.symbol(header_state, false);
            if ((unsigned)sym >= kHTapsMax / 2 - 1) corrupt(fmt("htaps %lld", 2 * sym + 2));
            f.htaps = sym * 2 + 2;
            int sum = 0;
            for (int i = f.htaps / 2; i; i--) {
                const unsigned v = unsigned(c.symbol(header_state, false));
                if (v > 127) corrupt(fmt("hcoeff %lld", v));
                f.hcoeff[i] = int(v) * (1 - 2 * (i & 1));
                sum += f.hcoeff[i];
            }
            f.hcoeff[0] = 32 - sum;
        }
        mc[2].diag_mc = mc[1].diag_mc;
        mc[2].htaps = mc[1].htaps;
        std::memcpy(mc[2].hcoeff, mc[1].hcoeff, sizeof mc[2].hcoeff);
    }

    // decode_frame: each plane's fast_mc, whatever its fourth coefficient
    void set_fast_mc() {
        for (auto& f : mc) {
            f.fast = f.diag_mc && f.htaps == 6 && f.hcoeff[0] == 40 && f.hcoeff[1] == -10 && f.hcoeff[2] == 2;
            if (!f.fast) mark(F_MC_FILTER);
            if (!f.diag_mc) mark(F_NO_DIAG_MC);
        }
    }

    int read_count() {
        const int tmp = c.symbol(header_state, false);
        if (!(0 < tmp && tmp <= kMaxDecompositions)) corrupt(fmt("spatial_decomposition_count %lld", tmp));
        return tmp;
    }

    void decode_header() {
        uint8_t kstate[32];
        std::memset(kstate, kMidState, sizeof kstate);
        keyframe = c.bit(kstate);
        if (keyframe || always_reset) {
            reset_contexts();
            spatial_type = qlog = qbias = mv_scale = block_max_depth = 0;
        }
        if (keyframe) {
            // read whole, then taken: a refused header leaves the layout the
            // references were decoded under
            const int version = c.symbol(header_state, false);
            if (version != 0) corrupt(fmt("version %lld", version));
            const int reset = c.bit(header_state);
            const int ttype = c.symbol(header_state, false);
            const int tcount = c.symbol(header_state, false);
            const int count = read_count();
            const int space = c.symbol(header_state, false);
            int hs = hshift, vs = vshift, planes = 1;
            if (space == 0) {
                hs = c.symbol(header_state, false);
                vs = c.symbol(header_state, false);
                if (!(hs == vs && (hs == 0 || hs == 1 || hs == 2))) unsupported(fmt("chroma shifts %lld,%lld", hs, vs));
                planes = 3;
            } else if (space != 1) {
                unsupported(fmt("colorspace_type %lld", space));
            }
            const int scalability = c.bit(header_state);
            const int refs = c.symbol(header_state, false);
            if ((unsigned)refs >= (unsigned)kMaxRefFrames) corrupt(fmt("max_ref_frames %lld", refs + 1));
            always_reset = reset;
            spatial_count = count;
            nb_planes = planes;
            hshift = hs;
            vshift = vs;
            max_ref_frames = refs + 1;
            decode_qlogs();
            // FFmpeg reads the temporal decomposition and spatial
            // scalability and acts on neither
            if (always_reset) mark(F_ALWAYS_RESET);
            if (ttype || tcount) mark(F_TEMPORAL);
            if (scalability) mark(F_SCALABILITY);
            have_key = true;
        }
        if (!have_key) corrupt("an inter frame before the first key frame");
        // FFmpeg keeps the pixel format of its first picture and refuses
        // every frame decoded under another (mconly_picture's format)
        const int fmt_now = nb_planes * 16 + hshift * 4 + vshift;
        if (layout < 0) layout = fmt_now;
        if (layout != fmt_now) corrupt("the pixel format changed");
        mark(keyframe ? F_KEY : F_INTER);
        if (!keyframe) {
            if (c.bit(header_state)) read_mc();
            if (c.bit(header_state)) {
                spatial_count = read_count();
                decode_qlogs();
                mark(F_COUNT_UPDATE);
            }
        }
        spatial_type += c.symbol(header_state, true);
        if ((unsigned)spatial_type > 1u) corrupt(fmt("spatial_decomposition_type %lld", spatial_type));
        if ((std::min(width >> hshift, height >> vshift) >> (spatial_count - 1)) <= 1)
            corrupt(fmt("spatial_decomposition_count %lld too large for the size", spatial_count));
        const int dq = c.symbol(header_state, true);
        qlog += dq;
        mv_scale += c.symbol(header_state, true);
        qbias += c.symbol(header_state, true);
        block_max_depth += c.symbol(header_state, true);
        if (block_max_depth > 1 || block_max_depth < 0 || (unsigned)mv_scale > 256u) {
            const int d = block_max_depth;
            block_max_depth = mv_scale = 0;
            corrupt(fmt("block_max_depth %lld", d));
        }
        if (std::abs(qbias) > 127) {
            const int q = qbias;
            qbias = 0;
            corrupt(fmt("qbias %lld", q));
        }
        if (!keyframe && dq) mark(F_QLOG_DELTA);
        if (qbias) mark(F_QBIAS);
        mark(spatial_type ? F_DWT53 : F_DWT97);
        if (qlog == kLosslessQlog) mark(F_LOSSLESS);
        mark(nb_planes == 1 ? F_GRAY : hshift == 2 ? F_YUV410 : hshift ? F_YUV420 : F_YUV444);
    }

    // ff_snow_common_init_after_header: the planes and their bands
    void init_bands() {
        for (int pi = 0; pi < nb_planes; pi++) {
            int w = width, h = height;
            if (pi) {
                w = -((-w) >> hshift);
                h = -((-h) >> vshift);
            }
            Plane& p = plane[pi];
            p.width = w;
            p.height = h;
            for (int level = spatial_count - 1; level >= 0; level--) {
                for (int o = level ? 1 : 0; o < 4; o++) {
                    Band& b = p.band[level][o];
                    b.level = level;
                    b.width = (w + !(o & 1)) >> 1;
                    b.height = (h + !(o > 1)) >> 1;
                    b.stride_line = 1 << (spatial_count - level);
                    b.x0 = o & 1 ? (w + 1) >> 1 : 0;
                    b.y0 = o > 1 ? b.stride_line >> 1 : 0;
                    b.parent = level ? &p.band[level - 1][o] : nullptr;
                    b.xc.assign(size_t(b.width + 1) * b.height + 2, XC{0, 0});
                }
                w = (w + 1) >> 1;
                h = (h + 1) >> 1;
            }
        }
    }

    // ff_snow_frames_prepare
    void frames_prepare() {
        last[max_ref_frames - 1].release();
        Picture tmp = std::move(last[max_ref_frames - 1]);
        for (int i = max_ref_frames - 1; i > 0; i--) last[i] = std::move(last[i - 1]);
        last[0] = std::move(cur);
        cur = std::move(tmp);
        cur.release();
        if (keyframe) {
            ref_frames = 0;
            cur.key = true;
        } else {
            int i;
            for (i = 0; i < max_ref_frames && last[i].valid(); i++)
                if (i && last[i - 1].key) break;
            ref_frames = i;
            if (!ref_frames) corrupt("no reference frames");
            cur.key = false;
        }
    }

    // ------------------------------------------------------------ blocks

    void set_blocks(int level, int x, int y, int l, int cb, int cr, int mx, int my, int ref, int type) {
        const int w = b_width << block_max_depth;
        const int rem_depth = block_max_depth - level;
        const int index = (x + y * w) << rem_depth;
        const int block_w = 1 << rem_depth;
        Block b;
        b.color[0] = uint8_t(l);
        b.color[1] = uint8_t(cb);
        b.color[2] = uint8_t(cr);
        b.mx = int16_t(mx);
        b.my = int16_t(my);
        b.ref = uint8_t(ref);
        b.type = uint8_t(type);
        b.level = uint8_t(level);
        for (int j = 0; j < block_w; j++)
            for (int i = 0; i < block_w; i++) blocks[index + i + j * w] = b;
    }

    void pred_mv(int* mx, int* my, int ref, const Block* left, const Block* top, const Block* tr) {
        if (ref_frames == 1) {
            *mx = mid_pred(left->mx, top->mx, tr->mx);
            *my = mid_pred(left->my, top->my, tr->my);
        } else {
            auto sc = [&](int v, int r) { return (v * (256 * (ref + 1) / (r + 1)) + 128) >> 8; };   // ff_scale_mv_ref
            *mx = mid_pred(sc(left->mx, left->ref), sc(top->mx, top->ref), sc(tr->mx, tr->ref));
            *my = mid_pred(sc(left->my, left->ref), sc(top->my, top->ref), sc(tr->my, tr->ref));
        }
    }

    void decode_q_branch(int level, int x, int y) {
        static const Block kNull = null_block();
        const int w = b_width << block_max_depth;
        const int rem_depth = block_max_depth - level;
        const int index = (x + y * w) << rem_depth;
        const int trx = (x + 1) << rem_depth;
        const Block* left = x ? &blocks[index - 1] : &kNull;
        const Block* top = y ? &blocks[index - w] : &kNull;
        const Block* tl = y && x ? &blocks[index - w - 1] : left;
        const Block* tr = y && trx < w && ((x & 1) == 0 || level == 0) ? &blocks[index - w + (1 << rem_depth)] : tl;
        const int s_context = 2 * left->level + 2 * top->level + tl->level + tr->level;

        if (keyframe) {
            set_blocks(level, x, y, 128, 128, 128, 0, 0, 0, kBlockIntra);
            return;
        }
        if (level == block_max_depth || c.bit(&block_state[4 + s_context])) {
            int mx, my;
            int l = left->color[0], cb = left->color[1], cr = left->color[2];
            int ref = 0;
            const int ref_context = av_log2(2 * left->ref) + av_log2(2 * top->ref);
            const int mx_context = av_log2(2 * std::abs(left->mx - top->mx));
            const int my_context = av_log2(2 * std::abs(left->my - top->my));
            const int type = c.bit(&block_state[1 + left->type + top->type]) ? kBlockIntra : 0;
            if (type) {
                pred_mv(&mx, &my, 0, left, top, tr);
                const int ld = c.symbol(&block_state[32], true);
                if (ld < -255 || ld > 255) corrupt(fmt("an intra block's luma delta %lld", ld));
                l += ld;
                if (nb_planes > 2) {
                    const int cbd = c.symbol(&block_state[64], true);
                    const int crd = c.symbol(&block_state[96], true);
                    if (cbd < -255 || cbd > 255 || crd < -255 || crd > 255)
                        corrupt(fmt("an intra block's chroma deltas %lld, %lld", cbd, crd));
                    cb += cbd;
                    cr += crd;
                }
                mark(F_INTRA_BLOCK);
            } else {
                if (ref_frames > 1) ref = c.symbol(&block_state[128 + 1024 + 32 * ref_context], false);
                if ((unsigned)ref >= (unsigned)ref_frames) corrupt(fmt("reference %lld of %lld", ref, ref_frames));
                if (ref) mark(F_REF_INDEX);
                pred_mv(&mx, &my, ref, left, top, tr);
                mx += c.symbol(&block_state[128 + 32 * (mx_context + 16 * !!ref)], true);
                my += c.symbol(&block_state[128 + 32 * (my_context + 16 * !!ref)], true);
            }
            set_blocks(level, x, y, l, cb, cr, mx, my, ref, type);
        } else {
            mark(F_SPLIT);
            decode_q_branch(level + 1, 2 * x + 0, 2 * y + 0);
            decode_q_branch(level + 1, 2 * x + 1, 2 * y + 0);
            decode_q_branch(level + 1, 2 * x + 0, 2 * y + 1);
            decode_q_branch(level + 1, 2 * x + 1, 2 * y + 1);
        }
    }

    void decode_blocks() {
        for (int y = 0; y < b_height; y++)
            for (int x = 0; x < b_width; x++) {
                if (c.p >= c.end) corrupt("the frame ends inside its block tree");
                decode_q_branch(0, x, y);
            }
    }

    // ------------------------------------------------------------ coefficients

    void unpack_coeffs(Band& b) {
        Band* parent = b.parent;
        const int w = b.width, h = b.height;
        XC* xc = b.xc.data();
        XC* prev_xc = nullptr;
        XC* prev2_xc = xc;
        XC* parent_xc = parent ? parent->xc.data() : nullptr;
        XC* prev_parent_xc = parent_xc;
        int run, runs = get_symbol2(c, b.state[30], 0);
        if (runs-- > 0)
            run = get_symbol2(c, b.state[1], 3);
        else
            run = INT32_MAX;
        for (int y = 0; y < h; y++) {
            int v = 0;
            int lt = 0, t = 0, rt = 0;
            if (y && prev_xc->x == 0) rt = prev_xc->coeff;
            for (int x = 0; x < w; x++) {
                int p = 0;
                const int l = v;
                lt = t;
                t = rt;
                if (y) {
                    if (prev_xc->x <= x) prev_xc++;
                    rt = prev_xc->x == x + 1 ? prev_xc->coeff : 0;
                }
                if (parent_xc) {
                    if (x >> 1 > parent_xc->x) parent_xc++;
                    if (x >> 1 == parent_xc->x) p = parent_xc->coeff;
                }
                if (l | lt | t | rt | p) {
                    const int context = av_log2(3 * (l >> 1) + (lt >> 1) + (t & ~1) + (rt >> 1) + (p >> 1));
                    v = c.bit(&b.state[0][context]);
                    if (v) {
                        v = 2 * (get_symbol2(c, b.state[context + 2], context - 4) + 1);
                        v += c.bit(&b.state[0][16 + 1 + 3 + quant3bA(l & 0xFF) + 3 * quant3bA(t & 0xFF)]);
                        if ((uint16_t)v != v) v = 1;   // "Coefficient damaged"
                        xc->x = int16_t(x);
                        (xc++)->coeff = uint16_t(v);
                    }
                } else if (!run) {
                    if (runs-- > 0)
                        run = get_symbol2(c, b.state[1], 3);
                    else
                        run = INT32_MAX;
                    v = 2 * (get_symbol2(c, b.state[0 + 2], 0 - 4) + 1);
                    v += c.bit(&b.state[0][16 + 1 + 3]);
                    if ((uint16_t)v != v) v = 1;
                    xc->x = int16_t(x);
                    (xc++)->coeff = uint16_t(v);
                } else {
                    run--;
                    v = 0;
                    int max_run = y ? std::min(run, prev_xc->x - x - 2) : std::min(run, w - x - 1);
                    if (parent_xc) max_run = std::min(max_run, 2 * parent_xc->x - x - 1);
                    if (max_run < 0 || max_run > run) corrupt("a coefficient run out of range");
                    x += max_run;
                    run -= max_run;
                }
            }
            (xc++)->x = int16_t(w + 1);
            prev_xc = prev2_xc;
            prev2_xc = xc;
            if (parent_xc) {
                if (y & 1) {
                    while (parent_xc->x != parent->width + 1) parent_xc++;
                    parent_xc++;
                    prev_parent_xc = parent_xc;
                } else {
                    parent_xc = prev_parent_xc;
                }
            }
        }
        (xc++)->x = int16_t(w + 1);
    }

    int16_t* band_line(Band& b, int pw, int y) { return idwt.data() + ptrdiff_t(y * b.stride_line + b.y0) * pw + b.x0; }

    void band_q(const Band& b, int* qmul, int* qadd) {
        const int ql = std::clamp(qlog + b.qlog, 0, kQRoot * 16);
        *qmul = kQExp[ql & (kQRoot - 1)] << (ql >> kQShift);
        *qadd = (qbias * *qmul) >> kQBiasShift;
    }

    // decode_subband_slice_buffered over the whole band
    void dequantize_band(Band& b, int pw, bool ll) {
        int qmul, qadd;
        band_q(b, &qmul, &qadd);
        if (ll || qlog == kLosslessQlog) {
            qadd = 0;
            qmul = 1 << kQExpShift;
        }
        size_t k = 0;
        for (int y = 0; y < b.height; y++) {
            int16_t* line = band_line(b, pw, y);
            std::memset(line, 0, sizeof(int16_t) * b.width);
            int v = b.xc[k].coeff;
            int x = b.xc[k++].x;
            while (x < b.width) {
                const int t = int((unsigned)(v >> 1) * (unsigned)qmul + (unsigned)qadd) >> kQExpShift;
                const int u = -(v & 1);
                line[x] = int16_t((t ^ u) - u);
                v = b.xc[k].coeff;
                x = b.xc[k++].x;
            }
        }
    }

    // correlate_slice_buffered (use_median 0), then dequantize_slice_buffered
    void correlate_ll(Band& b, int pw) {
        int16_t* prev = nullptr;
        for (int y = 0; y < b.height; y++) {
            int16_t* line = band_line(b, pw, y);
            for (int x = 0; x < b.width; x++) {
                if (x) {
                    if (y)
                        line[x] = int16_t(line[x] + mid_pred(line[x - 1], prev[x], line[x - 1] + prev[x] - prev[x - 1]));
                    else
                        line[x] = int16_t(line[x] + line[x - 1]);
                } else if (y) {
                    line[x] = int16_t(line[x] + prev[x]);
                }
            }
            prev = line;
        }
        if (qlog == kLosslessQlog) return;
        int qmul, qadd;
        band_q(b, &qmul, &qadd);
        for (int y = 0; y < b.height; y++) {
            int16_t* line = band_line(b, pw, y);
            for (int x = 0; x < b.width; x++) {
                const int i = line[x];
                if (i < 0)
                    line[x] = int16_t(-int(((unsigned)(-i) * (unsigned)qmul + (unsigned)qadd) >> kQExpShift));
                else if (i > 0)
                    line[x] = int16_t(int(((unsigned)i * (unsigned)qmul + (unsigned)qadd) >> kQExpShift));
            }
        }
    }

    // ------------------------------------------------------------ prediction

    // ff_snow_pred_block into dst (stride ds) for the b_w x b_h block at
    // (sx, sy) of plane pi
    void pred_block(uint8_t* dst, int ds, int sx, int sy, int b_w, int b_h, const Block& blk, int pi, int w, int h) {
        if (blk.type & kBlockIntra) {
            for (int y = 0; y < b_h; y++) std::memset(dst + y * ds, blk.color[pi], b_w);
            return;
        }
        const Picture& ref = last[blk.ref];
        if (!ref.valid()) corrupt("a block refers to a missing picture");
        const uint8_t* src = ref.data[pi].data();
        const int scale = pi ? (2 * mv_scale) >> hshift : 2 * mv_scale;
        const int mx = blk.mx * scale, my = blk.my * scale;
        const int dx = mx & 15, dy = my & 15;
        sx += (mx >> 4) - (kHTapsMax / 2 - 1);
        sy += (my >> 4) - (kHTapsMax / 2 - 1);
        // the window the filters read, its edges replicated past the
        // picture (emulated_edge_mc where the window leaves it)
        uint8_t win[(16 + kHTapsMax) * kWin];
        const int ww = b_w + kHTapsMax - 1, wh = b_h + kHTapsMax - 1;
        if (sx < 0 || sy < 0 || sx + ww > w || sy + wh > h) mark(F_EDGE);
        for (int y = 0; y < wh; y++) {
            const uint8_t* row = src + size_t(std::clamp(sy + y, 0, h - 1)) * w;
            for (int x = 0; x < ww; x++) win[y * kWin + x] = row[std::clamp(sx + x, 0, w - 1)];
        }
        if ((dx & 3) || (dy & 3) || !(b_w == b_h || 2 * b_w == b_h || b_w == 2 * b_h) || (b_w & (b_w - 1)) ||
            b_w == 1 || b_h == 1 || !mc[pi].fast) {
            mark(mc_block(dst, ds, win, kWin, b_w, b_h, dx, dy, mc[pi]));
            return;
        }
        mark(F_MC_H264);
        const uint8_t* s = win + 3 + 3 * kWin;
        const int qx = dx >> 2, qy = dy >> 2;
        if (b_w == b_h) {
            h264qpel::put(dst, ds, s, kWin, b_w, qx, qy);
        } else if (b_w == 2 * b_h) {
            h264qpel::put(dst, ds, s, kWin, b_h, qx, qy);
            h264qpel::put(dst + b_h, ds, s + b_h, kWin, b_h, qx, qy);
        } else {
            h264qpel::put(dst, ds, s, kWin, b_w, qx, qy);
            h264qpel::put(dst + b_w * ds, ds, s + b_w * kWin, kWin, b_w, qx, qy);
        }
    }

    static bool same_block(const Block& a, const Block& b) {
        if ((a.type & kBlockIntra) && (b.type & kBlockIntra))
            return a.color[0] == b.color[0] && a.color[1] == b.color[1] && a.color[2] == b.color[2];
        return a.mx == b.mx && a.my == b.my && a.ref == b.ref && !((a.type ^ b.type) & kBlockIntra);
    }

    // add_yblock (sliced, add) for the region (src_x, src_y) between the
    // centres of blocks (b_x, b_y) and (b_x + 1, b_y + 1)
    void add_yblock(uint8_t* out, const uint8_t* obmc, int src_x, int src_y, int b_w, int b_h, int w, int h,
                    int obmc_stride, int b_x, int b_y, int pi) {
        const int b_width = this->b_width << block_max_depth;
        const int b_height = this->b_height << block_max_depth;
        const int b_stride = b_width;
        int lt = b_x + b_y * b_stride, rt = lt + 1, lb = lt + b_stride, rb = lb + 1;
        if (b_x < 0) {
            lt = rt;
            lb = rb;
        } else if (b_x + 1 >= b_width) {
            rt = lt;
            rb = lb;
        }
        if (b_y < 0) {
            lt = lb;
            rt = rb;
        } else if (b_y + 1 >= b_height) {
            lb = lt;
            rb = rt;
        }
        if (src_x < 0) {
            obmc -= src_x;
            b_w += src_x;
            src_x = 0;
        }
        if (src_x + b_w > w) b_w = w - src_x;
        if (src_y < 0) {
            obmc -= src_y * obmc_stride;
            b_h += src_y;
            src_y = 0;
        }
        if (src_y + b_h > h) b_h = h - src_y;
        if (b_w <= 0 || b_h <= 0) return;

        const Block* nb[4] = {&blocks[lt], &blocks[rt], &blocks[lb], &blocks[rb]};
        uint8_t pred[4][16 * 16];
        const uint8_t* block[4];
        for (int k = 0; k < 4; k++) {
            int same = -1;
            for (int j = 0; j < k && same < 0; j++)
                if (same_block(*nb[j], *nb[k])) same = j;
            if (same >= 0) {
                block[k] = block[same];
            } else {
                pred_block(pred[k], 16, src_x, src_y, b_w, b_h, *nb[k], pi, w, h);
                block[k] = pred[k];
            }
        }
        const int half = obmc_stride >> 1;
        for (int y = 0; y < b_h; y++) {
            const uint8_t* obmc1 = obmc + y * obmc_stride;
            const uint8_t* obmc2 = obmc1 + half;
            const uint8_t* obmc3 = obmc1 + obmc_stride * half;
            const uint8_t* obmc4 = obmc3 + half;
            const int16_t* res = idwt.data() + size_t(src_y + y) * w + src_x;
            uint8_t* dst8 = out + size_t(src_y + y) * w + src_x;
            for (int x = 0; x < b_w; x++) {
                int v = obmc1[x] * block[3][x + y * 16] + obmc2[x] * block[2][x + y * 16] +
                        obmc3[x] * block[1][x + y * 16] + obmc4[x] * block[0][x + y * 16];
                v >>= 8 - kFracBits;   // LOG2_OBMC_MAX is 8
                v += res[x];
                v = (v + (1 << (kFracBits - 1))) >> kFracBits;
                dst8[x] = clip8(v);
            }
        }
    }

    void reconstruct(int pi) {
        using namespace snow_tables;
        Plane& p = plane[pi];
        const int w = p.width, h = p.height;
        idwt.assign(size_t(w) * h, 0);
        temp.assign(size_t(w) + 16, 0);
        for (int level = 0; level < spatial_count; level++)
            for (int o = level ? 1 : 0; o < 4; o++) {
                Band& b = p.band[level][o];
                dequantize_band(b, w, level == 0 && o == 0);
                if (level == 0 && o == 0) correlate_ll(b, w);
            }
        spatial_idwt(idwt.data(), temp.data(), w, h, w, spatial_type, spatial_count);
        if (qlog == kLosslessQlog)
            for (auto& v : idwt) v = int16_t(v * (1 << kFracBits));
        std::vector<uint8_t>& out = cur.data[pi];
        out.assign(size_t(w) * h, 0);
        if (keyframe) {
            for (size_t i = 0; i < out.size(); i++)
                out[i] = clip8((idwt[i] + (128 << kFracBits) + (1 << (kFracBits - 1))) >> kFracBits);
            return;
        }
        const int mb_w = b_width << block_max_depth, mb_h = b_height << block_max_depth;
        const int block_size = kMbSize >> block_max_depth;
        const int block_w = pi ? block_size >> hshift : block_size;
        const int block_h = pi ? block_size >> vshift : block_size;
        static const uint8_t* const kObmc[4] = {kObmc32, kObmc16, kObmc8, kObmc4};
        const uint8_t* obmc = pi ? kObmc[block_max_depth + hshift] : kObmc[block_max_depth];
        const int obmc_stride = pi ? (2 * block_size) >> hshift : 2 * block_size;
        for (int mb_y = 0; mb_y <= mb_h; mb_y++)
            for (int mb_x = 0; mb_x <= mb_w; mb_x++)
                add_yblock(out.data(), obmc, block_w * mb_x - block_w / 2, block_h * mb_y - block_h / 2, block_w,
                           block_h, w, h, obmc_stride, mb_x - 1, mb_y - 1, pi);
    }

    int decode(const uint8_t* buf, size_t n) {
        prepared = false;
        c.init(buf, n);
        decode_header();
        init_bands();
        set_fast_mc();
        b_width = (width + kMbSize - 1) >> 4;
        b_height = (height + kMbSize - 1) >> 4;
        blocks.assign(size_t(b_width * b_height) << (2 * block_max_depth), Block());
        frames_prepare();
        prepared = true;
        if (ref_frames > 1) mark(F_REFS);
        if (!keyframe) mark(mv_scale == 2 ? F_QPEL : F_HPEL);
        decode_blocks();
        for (int pi = 0; pi < nb_planes; pi++) {
            Plane& p = plane[pi];
            for (int level = 0; level < spatial_count; level++)
                for (int o = level ? 1 : 0; o < 4; o++) unpack_coeffs(p.band[level][o]);
            reconstruct(pi);
        }
        last[max_ref_frames - 1].release();   // ff_snow_release_buffer
        return SNOW_OK;
    }
};

void put_msg(char* msg, int64_t cap, const std::string& s) {
    if (cap <= 0) return;
    const size_t n = std::min<size_t>(s.size(), size_t(cap - 1));
    std::memcpy(msg, s.data(), n);
    msg[n] = 0;
}

}  // namespace

extern "C" {

// a decoder at the container's size (SNOW_OK, else the error in msg)
int snow_dec_new(int64_t w, int64_t h, void** out, char* msg, int64_t cap) {
    *out = nullptr;
    if (w <= 0 || h <= 0 || w > 16384 || h > 16384) {
        put_msg(msg, cap, fmt("a %lldx%lld picture", w, h));
        return SNOW_CORRUPT;
    }
    *out = new Decoder(int(w), int(h));
    return SNOW_OK;
}

void snow_dec_free(void* h) { delete (Decoder*)h; }

// Decode one packet; on SNOW_OK snow_dec_output copies its planes out
int snow_dec_decode(void* h, const uint8_t* data, int64_t n, char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        return d->decode(data, size_t(n));
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        if (d->prepared) d->cur.release();   // no half-decoded reference
        return f.kind;
    }
}

// the layout of the last picture: planes, chroma shift
void snow_dec_layout(void* h, int64_t* planes, int64_t* shift) {
    Decoder* d = (Decoder*)h;
    *planes = d->nb_planes;
    *shift = d->hshift;
}

void snow_dec_output(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
    Decoder* d = (Decoder*)h;
    uint8_t* dst[3] = {y, u, v};
    for (int p = 0; p < d->nb_planes; p++) std::memcpy(dst[p], d->cur.data[p].data(), d->cur.data[p].size());
}

int64_t snow_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
