// Dirac/VC-2 decoded in host C++ as FFmpeg 8's dirac decoder (diracdec.c,
// dirac.c, dirac_dwt.c with dirac_dwt_template.c, diracdsp.c, diractab.c)
// decodes it for cv2.VideoCapture, bit for bit:
//
//   * parse units: the "BBCD" prefix, the parse code and the next/previous
//     offsets; a packet holds several, searched and walked as
//     dirac_decode_frame walks them (a unit that ends at the packet's last
//     13 bytes, an end of sequence, is not reached);
//   * the sequence header (av_dirac_parse_sequence_header): version,
//     profile, level, the base video format and its defaults, custom
//     dimensions, chroma format, scan format, frame rate, pixel aspect,
//     clean area, signal range and colour spec, picture coding mode; one
//     sequence header is taken until an end of sequence drops it;
//   * the picture header and transform parameters of HQ pictures (parse
//     code 0xE8/0xEC): the picture number, the wavelet index and depth,
//     the slice counts, prefix bytes and size scaler, the quantisation
//     matrix (custom, or ff_dirac_default_qmat with Haar's depth offset);
//   * HQ slices (decode_hq_slice): each slice's quantiser, each
//     component's length times the size scaler, the interleaved signed
//     exp-Golomb coefficients of each subband's region (values cut off at
//     the component's end dropped, as ff_dirac_golomb_read_16bit drops
//     them, the rest zero) and their dequantisation through
//     ff_dirac_qscale_tab and ff_dirac_qoffset_intra_tab in 16 bits;
//   * the inverse wavelet over 16-bit coefficient lines padded to a
//     multiple of 1 << depth: Deslauriers-Dubuc (9,7), LeGall (5,3), Haar
//     without and with shift (wavelet indices 0, 1, 3, 4), each lifting
//     step in the arithmetic cv2's libavcodec runs: the x86 SIMD steps
//     (SSE2 vertical steps over each line's first multiple of 8 samples,
//     SSE2 Haar and SSSE3 (9,7) horizontal steps over the first multiple
//     of 8 pairs) in 16-bit lanes, the rest in C's int arithmetic, each
//     result stored back into 16 bits;
//   * the output: coefficients + 128 clipped to 8 bits
//     (put_signed_rect_clamped), cropped to the picture;
//   * 10- and 12-bit samples (pshift): coefficients in 32 bits throughout
//     (ff_dirac_golomb_read_32bit, the int32 dequantisation), the inverse
//     wavelet in C's int arithmetic alone (libavcodec has SIMD steps for
//     8 bits only: dirac_dwt_template.c at int32_t), the output plus
//     1 << (bits - 1) clipped to the depth into 16-bit samples, as the
//     yuv4xxp10/12 formats hold them.
//
// The planes come out as the decoder's pixel format lays them (yuv420p,
// yuv422p or yuv444p, or their 10- and 12-bit forms; the range and matrix
// by dirac_seq_info). What no
// encoder here writes (core-syntax and low-delay pictures, the wavelets
// DD (13,7), Fidelity and Daubechies (9,7), depths other than 8, 10 and
// 12 bits, a later major version's transform parameters) raises
// DIRAC_UNSUPPORTED
// with a message naming it; damaged data and what FFmpeg's decoder
// refuses (field coding among it) raise DIRAC_CORRUPT.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { DIRAC_OK = 0, DIRAC_NO_PICTURE = 1, DIRAC_UNSUPPORTED = 2, DIRAC_CORRUPT = 3 };

constexpr int kUnitHeader = 13;
constexpr int kMaxDwtLevels = 5;
constexpr int kMaxQuantIndex = 116;

struct Failure {
    int kind;
    std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Failure{DIRAC_CORRUPT, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Failure{DIRAC_UNSUPPORTED, m}; }

// the decoder's feature bits (dirac.py's FEATURES, in order)
enum Feature {
    F_HQ = 0, F_DD97, F_LEGALL53, F_HAAR0, F_HAAR1, F_DEPTH1, F_DEPTH2, F_DEPTH3, F_DEPTH4,
    F_DEPTH5, F_CUSTOM_QM, F_YUV420, F_YUV422, F_YUV444, F_LIMITED_RANGE, F_FULL_RANGE,
    F_CUSTOM_SIZE, F_SLICES, F_PREFIX_BYTES, F_SIZE_SCALER, F_CUT_COEFFS, F_REFERENCE, F_10BIT,
    F_12BIT,
};

// ---------------------------------------------------------------- tables

// ff_dirac_qscale_tab: 4 * 2^(q/4) by the specification's formula
const uint32_t kQScale[kMaxQuantIndex] = {
    4, 5, 6, 7, 8, 10, 11, 13, 16, 19, 23, 27, 32, 38, 45, 54, 64, 76, 91, 108, 128, 152, 181, 215,
    256, 304, 362, 431, 512, 609, 724, 861, 1024, 1218, 1448, 1722, 2048, 2435, 2896, 3444, 4096,
    4871, 5793, 6889, 8192, 9742, 11585, 13777, 16384, 19484, 23170, 27554, 32768, 38968, 46341,
    55109, 65536, 77936, 92682, 110218, 131072, 155872, 185364, 220436, 262144, 311744, 370728,
    440872, 524288, 623487, 741455, 881744, 1048576, 1246974, 1482910, 1763488, 2097152, 2493948,
    2965821, 3526975, 4194304, 4987896, 5931642, 7053950, 8388608, 9975792, 11863283, 14107901,
    16777216, 19951585, 23726566, 28215802, 33554432, 39903169, 47453133, 56431603, 67108864,
    79806339, 94906266, 112863206, 134217728, 159612677, 189812531, 225726413, 268435456,
    319225354, 379625062, 451452825, 536870912, 638450708, 759250125, 902905651, 1073741824,
    1276901417, 1518500250, 1805811301};

// ff_dirac_qoffset_intra_tab
const uint32_t kQOffsetIntra[kMaxQuantIndex] = {
    1, 2, 3, 4, 4, 5, 6, 7, 8, 10, 12, 14, 16, 19, 23, 27, 32, 38, 46, 54, 64, 76, 91, 108, 128,
    152, 181, 216, 256, 305, 362, 431, 512, 609, 724, 861, 1024, 1218, 1448, 1722, 2048, 2436,
    2897, 3445, 4096, 4871, 5793, 6889, 8192, 9742, 11585, 13777, 16384, 19484, 23171, 27555,
    32768, 38968, 46341, 55109, 65536, 77936, 92682, 110218, 131072, 155872, 185364, 220436,
    262144, 311744, 370728, 440872, 524288, 623487, 741455, 881744, 1048576, 1246974, 1482911,
    1763488, 2097152, 2493948, 2965821, 3526975, 4194304, 4987896, 5931642, 7053951, 8388608,
    9975793, 11863283, 14107901, 16777216, 19951585, 23726567, 28215802, 33554432, 39903170,
    47453133, 56431603, 67108864, 79806339, 94906266, 112863207, 134217728, 159612677, 189812531,
    225726413, 268435456, 319225354, 379625063, 451452826, 536870912, 638450709, 759250125,
    902905651};

// ff_dirac_default_qmat[wavelet][level][orientation]
const uint8_t kDefaultQmat[7][4][4] = {
    {{5, 3, 3, 0}, {0, 4, 4, 1}, {0, 5, 5, 2}, {0, 6, 6, 3}},
    {{4, 2, 2, 0}, {0, 4, 4, 2}, {0, 5, 5, 3}, {0, 7, 7, 5}},
    {{5, 3, 3, 0}, {0, 4, 4, 1}, {0, 5, 5, 2}, {0, 6, 6, 3}},
    {{8, 4, 4, 0}, {0, 4, 4, 0}, {0, 4, 4, 0}, {0, 4, 4, 0}},
    {{8, 4, 4, 0}, {0, 4, 4, 0}, {0, 4, 4, 0}, {0, 4, 4, 0}},
    {{0, 4, 4, 8}, {0, 8, 8, 12}, {0, 13, 13, 17}, {0, 17, 17, 21}},
    {{3, 1, 1, 0}, {0, 4, 4, 2}, {0, 6, 6, 5}, {0, 9, 9, 7}},
};

// dirac_source_parameters_defaults: width, height, chroma format,
// interlaced, frame rate index, pixel range index, colour spec index
struct BaseFormat {
    int width, height, chroma, interlaced, frame_rate, range, color;
};
const BaseFormat kBaseFormats[21] = {
    {640, 480, 2, 0, 1, 1, 0},     {176, 120, 2, 0, 9, 1, 1},     {176, 144, 2, 0, 10, 1, 2},
    {352, 240, 2, 0, 9, 1, 1},     {352, 288, 2, 0, 10, 1, 2},    {704, 480, 2, 0, 9, 1, 1},
    {704, 576, 2, 0, 10, 1, 2},    {720, 480, 1, 1, 4, 3, 1},     {720, 576, 1, 1, 3, 3, 2},
    {1280, 720, 1, 0, 7, 3, 3},    {1280, 720, 1, 0, 6, 3, 3},    {1920, 1080, 1, 1, 4, 3, 3},
    {1920, 1080, 1, 1, 3, 3, 3},   {1920, 1080, 1, 0, 7, 3, 3},   {1920, 1080, 1, 0, 6, 3, 3},
    {2048, 1080, 0, 0, 2, 4, 4},   {4096, 2160, 0, 0, 2, 4, 4},   {3840, 2160, 1, 0, 7, 3, 3},
    {3840, 2160, 1, 0, 6, 3, 3},   {7680, 4320, 1, 0, 7, 3, 3},   {7680, 4320, 1, 0, 6, 3, 3},
};

// the frame rates of indices 1-10: ff_mpeg12_frame_rate_tab[1..8], then
// dirac_frame_rate
const int kFrameRates[11][2] = {{0, 0},   {24000, 1001}, {24, 1},  {25, 1},  {30000, 1001}, {30, 1},
                                {50, 1},  {60000, 1001}, {60, 1},  {15000, 1001}, {25, 2}};

// the colour matrix of each colour spec preset (dirac_color_presets): 0
// BT.709, 1 BT.470BG (BT.601's matrix)
const int kPresetMatrix[5] = {0, 1, 1, 0, 0};

// ---------------------------------------------------------------- bits

struct Bits {
    const uint8_t* p;
    int64_t n;     // bits
    int64_t pos = 0;
    Bits(const uint8_t* data, int64_t bytes) : p(data), n(bytes * 8) {}
    int bit() {
        if (pos >= n) { pos++; return 0; }
        int b = p[pos >> 3] >> (7 - (pos & 7)) & 1;
        pos++;
        return b;
    }
    uint32_t get(int k) {
        uint32_t v = 0;
        for (int i = 0; i < k; i++) v = v << 1 | bit();
        return v;
    }
    // get_interleaved_ue_golomb
    uint32_t ue() {
        uint32_t v = 1;
        while (!bit()) {
            if (pos > n || v >= 0x8000000u) corrupt("an exp-Golomb code runs past its unit");
            v = v << 1 | bit();
        }
        return v - 1;
    }
    int32_t se() {     // dirac_get_se_golomb
        uint32_t v = ue();
        if (v && bit()) return -int32_t(v);
        return int32_t(v);
    }
    void align() { pos = (pos + 7) & ~int64_t(7); }
    int64_t left() const { return n - pos; }
};

// ---------------------------------------------------------------- sequence

struct Seq {
    int major = 0, minor = 0, profile = 0, level = 0, video_format = 0;
    int width = 0, height = 0, chroma = 2, interlaced = 0;
    int rate_num = 0, rate_den = 0;
    int range_index = 0, bit_depth = 8, full_range = 0;
    int matrix = 0;          // 0 BT.709, 1 BT.601 (BT.470BG)
    int color_index = 0;
    int custom_size = 0;
    uint32_t coding_mode = 0;   // 0 frames, 1 fields
};

Seq parse_sequence(const uint8_t* data, int64_t n) {
    Bits gb(data, n);
    Seq s;
    s.major = gb.ue();
    s.minor = gb.ue();
    s.profile = gb.ue();
    s.level = gb.ue();
    s.video_format = gb.ue();
    if (s.video_format > 20) corrupt("base video format " + std::to_string(s.video_format));
    const BaseFormat& b = kBaseFormats[s.video_format];
    s.width = b.width;
    s.height = b.height;
    s.chroma = b.chroma;
    s.interlaced = b.interlaced;
    int rate_index = b.frame_rate;
    s.range_index = b.range;
    s.color_index = b.color;
    if (gb.bit()) {
        s.width = gb.ue();
        s.height = gb.ue();
        s.custom_size = 1;
    }
    if (gb.bit()) s.chroma = gb.ue();
    if (s.chroma > 2) corrupt("chroma format " + std::to_string(s.chroma));
    if (gb.bit()) s.interlaced = gb.ue();
    if (s.interlaced > 1) corrupt("scan format " + std::to_string(s.interlaced));
    int num = 0, den = 0;
    if (gb.bit()) {
        rate_index = gb.ue();
        if (rate_index > 10) corrupt("frame rate index " + std::to_string(rate_index));
        if (!rate_index) {
            num = gb.ue();
            den = gb.ue();
        }
    }
    if (rate_index > 0) {
        num = kFrameRates[rate_index][0];
        den = kFrameRates[rate_index][1];
    }
    s.rate_num = num;
    s.rate_den = den;
    if (gb.bit()) {     // pixel aspect ratio
        unsigned idx = gb.ue();
        if (idx > 6) corrupt("aspect ratio index " + std::to_string(idx));
        if (!idx) {
            gb.ue();
            gb.ue();
        }
    }
    if (gb.bit()) {     // clean area
        gb.ue();
        gb.ue();
        gb.ue();
        gb.ue();
    }
    int luma_depth = 8, luma_offset = 16;
    int range_mpeg = 1;
    if (gb.bit()) {
        s.range_index = gb.ue();
        if (s.range_index > 4) corrupt("signal range index " + std::to_string(s.range_index));
        if (!s.range_index) {
            luma_offset = gb.ue();
            uint32_t excursion = gb.ue();
            luma_depth = 31 - __builtin_clz(excursion | 1) + 1;
            gb.ue();
            gb.ue();
            range_mpeg = luma_offset != 0;
        }
    }
    if (s.range_index > 0) {
        static const int depth[4] = {8, 8, 10, 12};
        luma_depth = depth[s.range_index - 1];
        range_mpeg = s.range_index != 1;
    }
    s.bit_depth = luma_depth;
    s.full_range = !range_mpeg;
    const int xs = s.chroma >= 1 ? 1 : 0, ys = s.chroma == 2 ? 1 : 0;
    if ((s.width % (1 << xs)) || (s.height % (1 << ys)))
        corrupt("dimensions not a multiple of the chroma subsampling");
    s.matrix = kPresetMatrix[s.color_index];
    if (gb.bit()) {
        s.color_index = gb.ue();
        if (s.color_index > 4) corrupt("colour spec index " + std::to_string(s.color_index));
        s.matrix = kPresetMatrix[s.color_index];
        if (!s.color_index) {
            if (gb.bit()) gb.ue();           // primaries
            if (gb.bit()) {
                unsigned idx = gb.ue();
                s.matrix = idx == 1 ? 1 : 0;   // else the preset's, BT.709
            }
            if (gb.bit()) gb.ue();           // transfer function
        }
    }
    s.coding_mode = gb.ue();
    if (gb.pos > gb.n) corrupt("a sequence header cut short");
    return s;
}

// ---------------------------------------------------------------- wavelets

inline int16_t w16(int v) { return int16_t(uint16_t(v)); }
inline int16_t sat16(int v) { return int16_t(std::min(32767, std::max(-32768, v))); }

// the lifting steps (dirac_dwt.h), C's arithmetic then SSE2's 16-bit lanes
inline int c_53iL0(int b0, int b1, int b2) { return b1 - ((b0 + b2 + 2) >> 2); }
inline int c_d53iH0(int b0, int b1, int b2) { return b1 + ((b0 + b2 + 1) >> 1); }
inline int c_dd97iH0(int b0, int b1, int b2, int b3, int b4) {
    return b2 + ((-b0 + 9 * b1 + 9 * b3 - b4 + 8) >> 4);
}
inline int c_haarL0(int b0, int b1) { return b0 - ((b1 + 1) >> 1); }
inline int c_haarH0(int b0, int b1) { return b0 + b1; }

inline int16_t s_53iL0(int16_t b0, int16_t b1, int16_t b2) {
    return w16(b1 - (w16(w16(b0 + b2) + 2) >> 2));
}
inline int16_t s_d53iH0(int16_t b0, int16_t b1, int16_t b2) {
    return w16(b1 + (w16(w16(b0 + b2) + 1) >> 1));
}
inline int16_t s_dd97iH0(int16_t b0, int16_t b1, int16_t b2, int16_t b3, int16_t b4) {
    const int m0 = w16(w16(b0 + b4) - 8), m1 = w16(b1 + b3);
    return w16(b2 + sat16((9 * m1 - m0) >> 4));
}

enum Wavelet { DD97 = 0, LEGALL53 = 1, DD137 = 2, HAAR0 = 3, HAAR1 = 4 };

// T: the coefficients' type (int16_t at 8 bits, int32_t above); Simd: the
// x86 steps cv2's libavcodec runs (at 8 bits), else C's alone
template <typename T, bool Simd>
struct Dwt {
    int type;
    T* buf;
    int width, height;       // padded plane
    int stride;              // samples
    std::vector<T> temp_store;
    T* temp;

    Dwt(int t, T* b, int w, int h, int s) : type(t), buf(b), width(w), height(h), stride(s) {
        temp_store.assign(size_t(w) + 64, 0);
        temp = temp_store.data() + 8;
    }

    // vertical steps: SSE2 over the first width & ~7 samples, C after.
    // The SSE2 loops run from the end down and test after each 8 samples,
    // so a line narrower than 8 runs once, over the 8 samples before its
    // start: the end of the line above in the buffer (or the padding
    // before the plane), which cv2's libavcodec changes there too
    static int simd_from(int w) { return (w & ~7) ? 0 : -8; }
    // the first sample SIMD steps cover and the end of their run (none
    // without Simd)
    static int simd_start(int w) { return Simd ? simd_from(w) : 0; }
    static int simd_end(int w) { return Simd ? w & ~7 : 0; }
    void v_53iL0(T* b0, T* b1, T* b2, int w) {
        const int a = simd_end(w);
        for (int i = a; i < w; i++) b1[i] = T(c_53iL0(b0[i], b1[i], b2[i]));
        for (int i = simd_start(w); i < a; i++) b1[i] = s_53iL0(b0[i], b1[i], b2[i]);
    }
    void v_d53iH0(T* b0, T* b1, T* b2, int w) {
        const int a = simd_end(w);
        for (int i = a; i < w; i++) b1[i] = T(c_d53iH0(b0[i], b1[i], b2[i]));
        for (int i = simd_start(w); i < a; i++) b1[i] = s_d53iH0(b0[i], b1[i], b2[i]);
    }
    void v_dd97iH0(T* b0, T* b1, T* b2, T* b3, T* b4, int w) {
        const int a = simd_end(w);
        for (int i = a; i < w; i++) b2[i] = T(c_dd97iH0(b0[i], b1[i], b2[i], b3[i], b4[i]));
        for (int i = simd_start(w); i < a; i++) b2[i] = s_dd97iH0(b0[i], b1[i], b2[i], b3[i], b4[i]);
    }
    void v_haar(T* b0, T* b1, int w) {
        const int a = simd_end(w);
        for (int i = a; i < w; i++) {
            b0[i] = T(c_haarL0(b0[i], b1[i]));
            b1[i] = T(c_haarH0(b1[i], b0[i]));
        }
        for (int i = simd_start(w); i < a; i++) {
            b0[i] = w16(b0[i] - (w16(b1[i] + 1) >> 1));
            b1[i] = w16(b1[i] + b0[i]);
        }
    }

    // horizontal steps: low half [0, w/2) and high half [w/2, w) of a line
    // composed and interleaved
    void h_dd97(T* b, int w) {   // SSSE3's lowpass, then its highpass (or C's)
        const int w2 = w >> 1;
        T* tmp = temp;
        auto low = [&](int b0, int b1, int b2) { return Simd ? T(s_53iL0(b0, b1, b2)) : T(c_53iL0(b0, b1, b2)); };
        tmp[0] = low(b[w2], b[0], b[w2]);
        for (int x = 1; x < w2; x++) tmp[x] = low(b[x + w2 - 1], b[x], b[x + w2]);
        tmp[-1] = tmp[0];
        tmp[w2 + 1] = tmp[w2] = tmp[w2 - 1];
        const int a = Simd && w2 >= 8 ? w2 & ~7 : 0;
        std::vector<T> hi(b + w2, b + w);   // the high half, read before the writes
        for (int x = 0; x < a; x++) {
            const int16_t h = s_dd97iH0(tmp[x - 1], tmp[x], hi[x], tmp[x + 1], tmp[x + 2]);
            b[2 * x] = w16(w16(tmp[x] + 1) >> 1);
            b[2 * x + 1] = w16(w16(h + 1) >> 1);
        }
        for (int x = a; x < w2; x++) {
            b[2 * x] = T((tmp[x] + 1) >> 1);
            b[2 * x + 1] = T((int(T(c_dd97iH0(tmp[x - 1], tmp[x], hi[x], tmp[x + 1], tmp[x + 2]))) + 1) >> 1);
        }
    }
    void h_d53(T* b, int w) {    // C only
        const int w2 = w >> 1;
        T* t = temp;
        t[0] = T(c_53iL0(b[w2], b[0], b[w2]));
        for (int x = 1; x < w2; x++) {
            t[x] = T(c_53iL0(b[x + w2 - 1], b[x], b[x + w2]));
            t[x + w2 - 1] = T(c_d53iH0(t[x - 1], b[x + w2 - 1], t[x]));
        }
        t[w - 1] = T(c_d53iH0(t[w2 - 1], b[w - 1], t[w2 - 1]));
        for (int i = 0; i < w2; i++) {
            b[2 * i] = T((t[i] + 1) >> 1);
            b[2 * i + 1] = T((t[i + w2] + 1) >> 1);
        }
    }
    void h_haar(T* b, int w, int shift) {   // SSE2's lowpass, its highpass, C's tail
        const int w2 = w >> 1;
        T* t = temp;
        for (int x = 0; x < w2; x++)
            t[x] = Simd ? T(w16(b[x] - (w16(b[x + w2] + 1) >> 1))) : T(c_haarL0(b[x], b[x + w2]));
        const int a = Simd && w2 >= 8 ? w2 & ~7 : 0;
        std::vector<T> hi(b + w2, b + w);
        for (int x = 0; x < a; x++) {
            int16_t lo = t[x], h = w16(hi[x] + t[x]);
            if (shift) {
                lo = w16(lo + 1) >> 1;
                h = w16(h + 1) >> 1;
            }
            b[2 * x] = lo;
            b[2 * x + 1] = h;
        }
        for (int x = a; x < w2; x++) {
            const int h = c_haarH0(hi[x], t[x]);
            b[2 * x] = shift ? T((t[x] + 1) >> 1) : t[x];
            b[2 * x + 1] = T(shift ? (h + 1) >> 1 : h);
        }
    }
    void horizontal(T* b, int w) {
        if (type == DD97) h_dd97(b, w);
        else if (type == LEGALL53) h_d53(b, w);
        else h_haar(b, w, type == HAAR1);
    }

    static int clip(int v, int lo, int hi) { return std::min(std::max(v, lo), hi); }
    static int mirror(int x, int w) {    // avpriv_mirror
        if (!w) return 0;
        while (unsigned(x) > unsigned(w)) {
            x = -x;
            if (x < 0) x += 2 * w;
        }
        return x;
    }

    // one level of ff_spatial_idwt_slice2, run to the level's end
    void level(int lvl) {
        const int wl = width >> lvl, hl = height >> lvl, sl = stride << lvl;
        auto row = [&](int r) { return buf + ptrdiff_t(r) * sl; };
        const unsigned uh = unsigned(hl);
        if (type == DD97) {
            int r[8];
            for (int i = 0; i < 6; i++) r[i] = clip(-6 + i, i & 1 ? 1 : 0, i & 1 ? hl - 1 : hl - 2);
            for (int y = -5; y <= hl; y += 2) {
                r[6] = clip(y + 5, 0, hl - 2);
                r[7] = clip(y + 6, 1, hl - 1);
                if (unsigned(y + 5) < uh) v_53iL0(row(r[5]), row(r[6]), row(r[7]), wl);
                if (unsigned(y + 1) < uh) v_dd97iH0(row(r[0]), row(r[2]), row(r[3]), row(r[4]), row(r[6]), wl);
                if (unsigned(y - 1) < uh) horizontal(row(r[0]), wl);
                if (unsigned(y) < uh) horizontal(row(r[1]), wl);
                for (int i = 0; i < 6; i++) r[i] = r[i + 2];
            }
        } else if (type == LEGALL53) {
            int r0 = mirror(-2, hl - 1), r1 = mirror(-1, hl - 1);
            for (int y = -1; y <= hl; y += 2) {
                const int r2 = mirror(y + 1, hl - 1), r3 = mirror(y + 2, hl - 1);
                if (unsigned(y + 1) < uh) v_53iL0(row(r1), row(r2), row(r3), wl);
                if (unsigned(y) < uh) v_d53iH0(row(r0), row(r1), row(r2), wl);
                if (unsigned(y - 1) < uh) horizontal(row(r0), wl);
                if (unsigned(y) < uh) horizontal(row(r1), wl);
                r0 = r2;
                r1 = r3;
            }
        } else {
            for (int y = 1; y <= hl; y += 2) {
                v_haar(row(y - 1), row(y), wl);
                horizontal(row(y - 1), wl);
                horizontal(row(y), wl);
            }
        }
    }

    void run(int depth) {
        for (int lvl = depth - 1; lvl >= 0; lvl--) level(lvl);
    }
};

// ---------------------------------------------------------------- decoder

// the samples before a plane's first line that SIMD steps on lines
// narrower than 8 reach (FFmpeg's top padding, zeroed with the plane)
constexpr int kFront = 64;

struct Plane {
    int width = 0, height = 0;      // the picture's
    int pw = 0, ph = 0, stride = 0; // the padded transform's
    std::vector<int16_t> store;     // kFront samples, then the lines
    int16_t* coef = nullptr;
    std::vector<int32_t> store32;   // above 8 bits
    int32_t* coef32 = nullptr;
    std::vector<uint8_t> out;
    std::vector<uint16_t> out16;    // above 8 bits
};

struct Decoder {
    bool have_seq = false;
    Seq seq;
    int xs = 1, ys = 1;
    Plane plane[3];
    bool got = false;
    int64_t frame_number = -1;   // the picture number due next
    int64_t features = 0;
    void mark(int f) { features |= int64_t(1) << f; }

    // picture parameters
    int wavelet = 0, depth = 0, num_x = 0, num_y = 0;
    int64_t prefix_bytes = 0, size_scaler = 0;
    int quant[kMaxDwtLevels][4] = {};

    void sequence(const uint8_t* data, int64_t n) {
        if (have_seq) return;
        Seq s = parse_sequence(data, n);
        if (s.coding_mode != 0)
            corrupt("picture coding mode " + std::to_string(s.coding_mode) +
                    " (field coding), which FFmpeg's decoder refuses");
        if (s.width <= 0 || s.height <= 0 || int64_t(s.width) * s.height > (int64_t(1) << 26))
            corrupt("picture size " + std::to_string(s.width) + "x" + std::to_string(s.height));
        seq = s;
        xs = seq.chroma >= 1 ? 1 : 0;
        ys = seq.chroma == 2 ? 1 : 0;
        have_seq = true;
        // alloc_sequence_buffers: zeroed coefficient planes at the largest
        // depth's padding, kept (with what each picture leaves in them)
        // until the next sequence header FFmpeg takes
        auto pad = [](int v) { return ((v + 31) >> 5) << 5; };
        for (int c = 0; c < 3; c++) {
            const int w = seq.width >> (c ? xs : 0), h = seq.height >> (c ? ys : 0);
            const size_t n = kFront + size_t((pad(w) + 7) & ~7) * pad(h);
            if (seq.bit_depth > 8) {
                plane[c].store32.assign(n, 0);
                plane[c].coef32 = plane[c].store32.data() + kFront;
                std::vector<int16_t>().swap(plane[c].store);
            } else {
                plane[c].store.assign(n, 0);
                plane[c].coef = plane[c].store.data() + kFront;
                std::vector<int32_t>().swap(plane[c].store32);
            }
        }
    }

    void picture(int code, const uint8_t* data, int64_t n) {
        if (!have_seq) corrupt("a picture before any sequence header");
        const int num_refs = code & 3;
        const bool low_delay = (code & 0x88) == 0x88;
        const bool core = (code & 0x88) == 0x08;
        bool ld = (code & 0xF8) == 0xC8;
        const bool hq = (code & 0xF8) == 0xE8;
        const bool reference = (code & 0x0C) == 0x0C;
        if (num_refs > 2) corrupt("num_refs of 3");
        if (seq.minor == 2 && code == 0x88) ld = true;
        if (low_delay && !(ld || hq)) corrupt("invalid low delay flag");
        if (core) unsupported("core-syntax pictures (arithmetic-coded wavelets and motion)");
        if (ld) unsupported("low-delay pictures");
        if (!hq) corrupt("parse code " + std::to_string(code));
        if (num_refs) unsupported("HQ pictures with references");
        if (seq.bit_depth != 8 && seq.bit_depth != 10 && seq.bit_depth != 12)
            unsupported(std::to_string(seq.bit_depth) + "-bit samples");
        if (seq.major >= 3) unsupported("major version " + std::to_string(seq.major) + " transform parameters");
        Bits gb(data, n);
        const int64_t number = gb.get(32);
        // the first picture after a sequence header starts the order; the
        // port reads pictures in order (intra only: none is held back)
        if (frame_number < 0) frame_number = number;
        if (number > frame_number)
            unsupported("picture " + std::to_string(number) + " before picture " +
                        std::to_string(frame_number) + " (pictures out of order)");
        if (reference) {
            gb.se();                     // the retired picture
            mark(F_REFERENCE);
        }
        gb.align();
        wavelet = gb.ue();
        if (wavelet > 6) corrupt("wavelet index " + std::to_string(wavelet));
        depth = gb.ue();
        if (depth < 1 || depth > kMaxDwtLevels) corrupt("wavelet depth " + std::to_string(depth));
        num_x = gb.ue();
        num_y = gb.ue();
        if (int64_t(num_x) * num_y == 0 || num_x > seq.width || num_y > seq.height)
            corrupt("slice counts " + std::to_string(num_x) + "x" + std::to_string(num_y));
        prefix_bytes = gb.ue();
        size_scaler = gb.ue();
        if (prefix_bytes >= (int64_t(1) << 31) / 8) corrupt("too many prefix bytes");
        if (gb.bit()) {
            mark(F_CUSTOM_QM);
            for (int l = 0; l < depth; l++)
                for (int o = l ? 1 : 0; o < 4; o++) quant[l][o] = gb.ue();
        } else {
            if (depth > 4) corrupt("depth " + std::to_string(depth) + " without its custom quantisation matrix");
            for (int l = 0; l < depth; l++)
                for (int o = 0; o < 4; o++) {
                    quant[l][o] = kDefaultQmat[wavelet][l][o];
                    if (wavelet == HAAR0) quant[l][o] += 4 * (depth - 1 - l);
                }
        }
        if (gb.pos > gb.n) corrupt("a picture header cut short");
        if (wavelet != DD97 && wavelet != LEGALL53 && wavelet != HAAR0 && wavelet != HAAR1) {
            static const char* names[7] = {"", "", "Deslauriers-Dubuc (13,7)", "", "", "Fidelity",
                                           "Daubechies (9,7)"};
            unsupported(std::string("the ") + names[wavelet] + " wavelet");
        }
        mark(F_HQ);
        mark(wavelet == DD97 ? F_DD97 : wavelet == LEGALL53 ? F_LEGALL53 : wavelet == HAAR0 ? F_HAAR0 : F_HAAR1);
        mark(F_DEPTH1 + depth - 1);
        mark(seq.chroma == 2 ? F_YUV420 : seq.chroma == 1 ? F_YUV422 : F_YUV444);
        mark(seq.full_range ? F_FULL_RANGE : F_LIMITED_RANGE);
        if (seq.custom_size) mark(F_CUSTOM_SIZE);
        if (num_x * num_y > 1) mark(F_SLICES);
        if (prefix_bytes) mark(F_PREFIX_BYTES);
        if (size_scaler > 1) mark(F_SIZE_SCALER);
        if (seq.bit_depth > 8) mark(seq.bit_depth == 10 ? F_10BIT : F_12BIT);
        init_planes();
        gb.align();
        const bool deep = seq.bit_depth > 8;
        if (deep) slices<int32_t>(data + gb.pos / 8, n - gb.pos / 8);
        else slices<int16_t>(data + gb.pos / 8, n - gb.pos / 8);
        const int top = (1 << seq.bit_depth) - 1, mid = 1 << (seq.bit_depth - 1);
        for (int c = 0; c < 3; c++) {
            Plane& p = plane[c];
            if (deep) {
                Dwt<int32_t, false>(wavelet, p.coef32, p.pw, p.ph, p.stride).run(depth);
                p.out16.resize(size_t(p.width) * p.height);
                for (int y = 0; y < p.height; y++)
                    for (int x = 0; x < p.width; x++) {
                        const int v = p.coef32[size_t(y) * p.stride + x] + mid;
                        p.out16[size_t(y) * p.width + x] = uint16_t(std::min(top, std::max(0, v)));
                    }
                continue;
            }
            Dwt<int16_t, true>(wavelet, p.coef, p.pw, p.ph, p.stride).run(depth);
            p.out.resize(size_t(p.width) * p.height);
            for (int y = 0; y < p.height; y++)
                for (int x = 0; x < p.width; x++) {
                    const int v = p.coef[size_t(y) * p.stride + x] + 128;
                    p.out[size_t(y) * p.width + x] = uint8_t(std::min(255, std::max(0, v)));
                }
        }
        // FFmpeg hands over the picture numbered as the one due, and drops
        // an earlier one
        got = number == frame_number;
        if (got) frame_number = number + 1;
    }

    void init_planes() {
        for (int c = 0; c < 3; c++) {
            Plane& p = plane[c];
            p.width = seq.width >> (c ? xs : 0);
            p.height = seq.height >> (c ? ys : 0);
            p.pw = ((p.width + (1 << depth) - 1) >> depth) << depth;
            p.ph = ((p.height + (1 << depth) - 1) >> depth) << depth;
            p.stride = (p.pw + 7) & ~7;
        }
    }

    // the band (level, orientation) of plane c: its width, height, and the
    // buffer offset and row step of its element (0, 0)
    struct Band {
        int w, h;
        ptrdiff_t origin, step;
    };
    Band band(int c, int l, int o) const {
        const Plane& p = plane[c];
        Band b;
        b.w = p.pw >> (depth - l);
        b.h = p.ph >> (depth - l);
        b.step = ptrdiff_t(p.stride) << (depth - l);
        b.origin = (o & 1 ? b.w : 0) + (o > 1 ? b.step / 2 : 0);
        return b;
    }

    template <typename T>
    void slices(const uint8_t* buf, int64_t avail) {
        int64_t bufsize = avail * 8;
        std::vector<T> tmp;
        for (int sy = 0; sy < num_y; sy++)
            for (int sx = 0; sx < num_x; sx++) {
                if (bufsize <= 0) corrupt("too few slices");
                int64_t bytes = prefix_bytes + 1;
                for (int i = 0; i < 3; i++)
                    if (bytes <= bufsize / 8) {
                        if (bytes >= bufsize / 8) corrupt("a slice's lengths run past its picture");
                        bytes += int64_t(buf[bytes]) * size_scaler + 1;
                    }
                if (bytes >= (int64_t(1) << 31) || bytes * 8 > bufsize) corrupt("too many bytes in a slice");
                slice(sx, sy, buf, bufsize, tmp);
                buf += bytes;
                bufsize = bufsize / 8 >= bytes ? bufsize - bytes * 8 : 0;
            }
    }

    template <typename T>
    T* coefs(int c) { return reinterpret_cast<T*>(sizeof(T) == 2 ? (void*)plane[c].coef : (void*)plane[c].coef32); }

    template <typename T>
    void slice(int sx, int sy, const uint8_t* buf, int64_t bits, std::vector<T>& tmp) {
        Bits gb(buf, bits / 8);
        gb.pos += 8 * prefix_bytes;
        const int qi = gb.get(8);
        if (qi > kMaxQuantIndex - 1) corrupt("quantisation index " + std::to_string(qi));
        uint32_t qf[kMaxDwtLevels][4], qo[kMaxDwtLevels][4];
        for (int l = 0; l < depth; l++)
            for (int o = l ? 1 : 0; o < 4; o++) {
                const int q = std::max(qi - quant[l][o], 0);
                qf[l][o] = kQScale[q];
                qo[l][o] = kQOffsetIntra[q] + 2;
            }
        for (int c = 0; c < 3; c++) {
            const int64_t length = size_scaler * int64_t(gb.get(8));
            const int64_t end = gb.pos + 8 * length;
            if (length * 8 > gb.left()) corrupt("a slice component runs past its picture");
            // each level's region of this slice (subband_coeffs)
            int top[kMaxDwtLevels], left[kMaxDwtLevels], tw[kMaxDwtLevels], th[kMaxDwtLevels];
            int64_t total = 0;
            for (int l = 0; l < depth; l++) {
                const Band b = band(c, l, 3);
                top[l] = int64_t(b.h) * sy / num_y;
                left[l] = int64_t(b.w) * sx / num_x;
                tw[l] = int(int64_t(b.w) * (sx + 1) / num_x) - left[l];
                th[l] = int(int64_t(b.h) * (sy + 1) / num_y) - top[l];
                total += int64_t(tw[l]) * th[l] * (l ? 3 : 4);
            }
            tmp.assign(size_t(total), 0);
            const int64_t got_n = golomb(buf + gb.pos / 8, length, tmp);
            if (got_n < total) mark(F_CUT_COEFFS);
            int64_t off = 0;
            for (int l = 0; l < depth; l++)
                for (int o = l ? 1 : 0; o < 4; o++) {
                    const Band b = band(c, l, o);
                    T* base = coefs<T>(c) + b.origin + top[l] * b.step + left[l];
                    for (int y = 0; y < th[l]; y++)
                        for (int x = 0; x < tw[l]; x++) {
                            const int v = tmp[size_t(off++)];
                            T r = 0;
                            if (v < 0) r = T(-int((uint32_t(-v) * qf[l][o] + qo[l][o]) >> 2));
                            else if (v > 0) r = T(int((uint32_t(v) * qf[l][o] + qo[l][o]) >> 2));
                            base[y * b.step + x] = r;
                        }
                }
            gb.pos = end;
        }
    }

    // ff_dirac_golomb_read_16bit (and _32bit): the interleaved signed
    // exp-Golomb values wholly inside `bytes` bytes, up to out.size() of
    // them, as T
    template <typename T>
    static int64_t golomb(const uint8_t* p, int64_t bytes, std::vector<T>& out) {
        Bits gb(p, bytes);
        const int64_t want = int64_t(out.size());
        int64_t k = 0;
        while (k < want) {
            uint64_t v = 1;
            bool done = false;
            while (gb.pos < gb.n) {
                if (gb.bit()) {
                    done = true;
                    break;
                }
                if (gb.pos >= gb.n) break;
                v = v << 1 | gb.bit();
            }
            if (!done) break;
            int64_t m = int64_t(v) - 1;
            if (m) {
                if (gb.pos >= gb.n) break;      // the sign bit is past the end
                if (gb.bit()) m = -m;
            }
            out[size_t(k++)] = T(m);
        }
        return k;
    }

    // dirac_decode_frame over one packet
    int decode(const uint8_t* buf, int64_t size) {
        got = false;
        int64_t idx = 0;
        for (;;) {
            for (; idx + kUnitHeader < size; idx++)
                if (buf[idx] == 'B' && buf[idx + 1] == 'B' && buf[idx + 2] == 'C' && buf[idx + 3] == 'D') break;
            if (idx + kUnitHeader >= size) break;
            const uint32_t unit = uint32_t(buf[idx + 5]) << 24 | buf[idx + 6] << 16 | buf[idx + 7] << 8 | buf[idx + 8];
            if (unit > size - idx || !unit) {
                idx += 4;
                continue;
            }
            if (unit < uint32_t(kUnitHeader)) corrupt("a parse unit shorter than its header");
            const int code = buf[idx + 4];
            const uint8_t* body = buf + idx + kUnitHeader;
            const int64_t n = unit - kUnitHeader;
            if (code == 0x00) sequence(body, n);
            else if (code == 0x10) have_seq = false;    // end of sequence
            else if (code & 0x08) picture(code, body, n);
            idx += unit;
        }
        return got ? DIRAC_OK : DIRAC_NO_PICTURE;
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

void* dirac_dec_new() { return new Decoder(); }

void dirac_dec_free(void* h) { delete (Decoder*)h; }

// one packet: DIRAC_OK with a picture, DIRAC_NO_PICTURE without one, else
// an error with its message
int dirac_dec_decode(void* h, const uint8_t* data, int64_t n, char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        return d->decode(data, n);
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    } catch (const std::exception& e) {
        put_msg(msg, cap, e.what());
        return DIRAC_CORRUPT;
    }
}

// the last picture's layout: width, height, chroma shifts, full range,
// matrix (0 BT.709, 1 BT.601), bits a sample
void dirac_dec_layout(void* h, int64_t* out) {
    Decoder* d = (Decoder*)h;
    out[0] = d->seq.width;
    out[1] = d->seq.height;
    out[2] = d->xs;
    out[3] = d->ys;
    out[4] = d->seq.full_range;
    out[5] = d->seq.matrix;
    out[6] = d->seq.bit_depth;
}

// the planes: 8-bit samples, or 16-bit ones (native order) above 8 bits
void dirac_dec_output(void* h, void* y, void* u, void* v) {
    Decoder* d = (Decoder*)h;
    void* dst[3] = {y, u, v};
    for (int p = 0; p < 3; p++) {
        const Plane& pl = d->plane[p];
        if (d->seq.bit_depth > 8) std::memcpy(dst[p], pl.out16.data(), pl.out16.size() * 2);
        else std::memcpy(dst[p], pl.out.data(), pl.out.size());
    }
}

int64_t dirac_dec_features(void* h) { return ((Decoder*)h)->features; }

// the inverse wavelet alone, in place over h lines of w coefficients in a
// buffer with kFront samples before its first line (w and h multiples of
// 1 << depth): what picture() runs on each plane
void dirac_idwt(int16_t* buf, int64_t w, int64_t h, int64_t stride, int64_t wavelet, int64_t depth) {
    Dwt<int16_t, true>(int(wavelet), buf + kFront, int(w), int(h), int(stride)).run(int(depth));
}

// the same over 32-bit coefficients, C's steps alone (above 8 bits)
void dirac_idwt32(int32_t* buf, int64_t w, int64_t h, int64_t stride, int64_t wavelet, int64_t depth) {
    Dwt<int32_t, false>(int(wavelet), buf + kFront, int(w), int(h), int(stride)).run(int(depth));
}

// the first sequence header of a packet or stream: width, height, frame
// rate numerator and denominator, bits a sample, picture coding mode (1:
// fields); DIRAC_NO_PICTURE where there is none
int dirac_seq_info(const uint8_t* buf, int64_t size, int64_t* out, char* msg, int64_t cap) {
    try {
        for (int64_t idx = 0; idx + kUnitHeader < size; idx++) {
            if (!(buf[idx] == 'B' && buf[idx + 1] == 'B' && buf[idx + 2] == 'C' && buf[idx + 3] == 'D'))
                continue;
            if (buf[idx + 4] != 0x00) continue;
            const uint32_t unit = uint32_t(buf[idx + 5]) << 24 | buf[idx + 6] << 16 | buf[idx + 7] << 8 | buf[idx + 8];
            const int64_t n = (unit && unit <= size - idx ? int64_t(unit) : size - idx) - kUnitHeader;
            const Seq s = parse_sequence(buf + idx + kUnitHeader, n);
            const int64_t v[6] = {s.width, s.height, s.rate_num, s.rate_den, s.bit_depth,
                                  int64_t(s.coding_mode)};
            std::memcpy(out, v, sizeof(v));
            return DIRAC_OK;
        }
        return DIRAC_NO_PICTURE;
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

}  // extern "C"
