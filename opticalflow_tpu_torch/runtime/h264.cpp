// H.264 decoded in host C++ as FFmpeg 8's h264 decoder (h264dec.c,
// h264_slice.c, h264_ps.c, h264_refs.c, h264_picture.c, h264_mb.c,
// h264_cavlc.c, h264_cabac.c, h264_loopfilter.c, h264pred_template.c,
// h264idct_template.c, h264qpel_template.c) decodes it for
// cv2.VideoCapture, bit for bit.  H.264 decoding is exact by the standard
// (integer transforms, defined interpolation and deblocking), so the planes
// follow ITU-T H.264 itself; what is FFmpeg's own is which pictures come out
// and when, and the crop it applies.  Read:
//
//   * NAL units from Annex B start codes or with the length prefix of an
//     avcC record (1, 2 or 4 bytes), emulation prevention removed; AUD, SEI
//     (but its recovery point), filler, end of sequence or stream, the SPS
//     extension, auxiliary slices and the MVC/SVC units passed over;
//   * the SPS (scaling lists with fall-back rule A, POC types 0-2, cropping,
//     the VUI: range, colour description, chroma site, bitstream
//     restriction) and PPS (the 8x8 transform, its scaling lists with rule
//     A or B, both chroma QP offsets, explicit weighted prediction), each by
//     id, re-sent at will;
//   * I, P and B slices, several a picture, in CAVLC or CABAC: I_NxN with
//     the 4x4 or 8x8 transform, I_16x16, I_PCM; P_L0_16x16, 16x8, 8x16,
//     P_8x8 and P_8x8ref0 with their sub-partitions, P_Skip; every B
//     mb_type and sub_mb_type, B_Skip and B_Direct (h264_direct.c: spatial
//     direct with colZeroFlag, temporal direct with the co-located
//     picture's references mapped onto list 0 by frame_num as fill_colmap
//     maps them, from its last slice's lists, an unmapped one to list 0's
//     first; direct_8x8_inference_flag 0 and 1);
//   * reconstruction: intra 4x4, 8x8 (filtered references) and 16x16
//     prediction, chroma prediction, constrained intra prediction; the
//     dequantisation with the scaling matrices, the 4x4 and 8x8 inverse
//     transforms, the luma DC Hadamard and the chroma 2x2 DC; median and
//     directional motion vector prediction for each list, P_Skip;
//     quarter-sample luma (h264_qpel.h) and eighth-sample chroma over
//     edge-replicated references; explicit weights, bi-prediction averaged,
//     explicitly weighted or implicitly by POC distance (with the 32/32
//     fall-back);
//   * the deblocking filter (bS 0-4, alpha/beta/tC0 with the slice
//     offsets, disable_deblocking_filter_idc 0-2, chroma QP per Cb and Cr;
//     bS 1 by both lists' pictures and vectors, paired either way round, as
//     check_mv compares them);
//   * reference lists (list 1 and list 0 of a B slice by POC, list 1's
//     first two swapped where it equals list 0) with their modification,
//     the sliding window and MMCO 1-6 with long-term references, B
//     pictures as references;
//   * the output: h264_select_output_frame's reorder buffer (the delay from
//     max_num_reorder_frames, or FFmpeg's guess raised as the POCs and B
//     slices show, from the depth the caller starts it at: cv2's decoder
//     starts from the depth FFmpeg's probe found), no picture before an
//     IDR or recovery point, the flush at the end, and the crop as
//     av_frame_apply_cropping applies it (a left crop that would unalign
//     the planes is dropped).
//
// Refused with H264_UNSUPPORTED and a message naming it: SP and SI slices;
// field pictures and MBAFF; other than 8-bit 4:2:0;
// qpprime_y_zero_transform_bypass; FMO, data partitioning and redundant
// pictures; a gap in frame_num; more than 16 references a list; and
// whatever FFmpeg would conceal (a missing reference, a picture with
// missing macroblocks, two pictures in one packet).  Damaged data raises
// H264_CORRUPT; nothing crashes.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <algorithm>
#include <climits>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "h264_qpel.h"
#include "h264_tables.h"

namespace {

using namespace h264_tables;

enum { kOk = 0, kNoFrame = 1, kUnsupported = 2, kCorrupt = 3 };

struct Failure {
    int kind;
    std::string msg;
};

[[noreturn]] void fail(int kind, const char* fmt, ...) {
    char buf[320];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof buf, fmt, ap);
    va_end(ap);
    throw Failure{kind, buf};
}

#define CORRUPT(...) fail(kCorrupt, __VA_ARGS__)
#define UNSUPPORTED(...) fail(kUnsupported, __VA_ARGS__)

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline uint8_t clip1(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// ------------------------------------------------------------------ features

// what the stream reached (h264.py's FEATURES, in order)
enum Feature {
    F_CAVLC, F_CABAC, F_ANNEXB, F_AVCC, F_I_PCM, F_I4X4, F_I8X8, F_I16X16, F_P16X16, F_P16X8,
    F_P8X16, F_P8X8, F_P8X8REF0, F_SUB8X8, F_SUB8X4, F_SUB4X8, F_SUB4X4, F_PSKIP, F_MULTI_REF,
    F_LIST_MOD, F_LONG_TERM_LIST_MOD, F_LONG_TERM, F_MMCO1, F_MMCO2, F_MMCO3, F_MMCO4, F_MMCO5,
    F_MMCO6, F_SLIDING_WINDOW, F_WEIGHTED, F_SPS_SCALING, F_PPS_SCALING, F_FALLBACK_A, F_FALLBACK_B,
    F_DEFAULT_LIST, F_CHROMA_QP_OFFSET, F_SECOND_CHROMA_QP_OFFSET, F_QP_DELTA, F_QP_WRAP,
    F_DEBLOCK_OFF, F_DEBLOCK_SLICE_EDGES, F_DEBLOCK_OFFSETS, F_MULTI_SLICE, F_POC0, F_POC1, F_POC2,
    F_VUI, F_REORDER, F_FULL_RANGE, F_COLOUR_DESCRIPTION, F_CHROMA_LOC, F_CROPPING,
    F_LEFT_CROP_DROPPED, F_RECOVERY_POINT, F_MID_IDR, F_NON_IDR_I, F_CONSTRAINED_INTRA,
    F_TRANSFORM_8X8, F_LEVEL_ESCAPE, F_NON_REF, F_EDGE_MV, F_REORDER_GUESSED, F_PARAMS_RESENT,
    F_COUNT
};
static_assert(F_COUNT <= 64, "feature bits");

// what B slices reached (third word, h264.py's B_FEATURES): each mb_type
// 0-22 of Table 7-14, each sub_mb_type 0-12 of Table 7-18, then the rest
enum FeatureB {
    FB_MB = 0, FB_SUB = 23, FB_SKIP = 36, FB_SPATIAL, FB_TEMPORAL, FB_INFERENCE, FB_DIRECT_4X4, FB_COL_ZERO,
    FB_COL_INTRA, FB_COL_L1, FB_IMPLICIT, FB_IMPLICIT_FALLBACK, FB_EXPLICIT, FB_LIST1_MOD, FB_LIST1_SWAP,
    FB_B_REFERENCE, FB_LONG_TERM_L1, FB_B_INTRA, FB_COL_UNMAPPED, FB_COUNT
};
static_assert(FB_COUNT <= 64, "B feature bits");

// the intra modes reached (second word): 4x4 0-8, 8x8 0-8, 16x16 0-3,
// chroma 0-3, then the same where the block lacks its top or left
// neighbour (a picture or slice edge)
enum { M_I4 = 0, M_I8 = 9, M_I16 = 18, M_CHROMA = 22, M_EDGE = 26 };

// ------------------------------------------------------------------ bits

struct Bits {
    const uint8_t* d = nullptr;
    int64_t size = 0;   // bits
    int64_t pos = 0;

    void reset(const uint8_t* data, int64_t bytes) {
        d = data;
        size = bytes * 8;
        pos = 0;
    }
    uint32_t peek32() const {   // past the end: zeros
        int64_t byte = pos >> 3;
        uint64_t v = 0;
        for (int i = 0; i < 5; i++) {
            int64_t b = byte + i;
            v = (v << 8) | ((b >= 0 && b * 8 < size) ? d[b] : 0);
        }
        return uint32_t(v >> (8 - (pos & 7)));
    }
    uint32_t show(int n) const { return n ? peek32() >> (32 - n) : 0; }
    uint32_t get(int n) {
        uint32_t v = show(n);
        pos += n;
        check();
        return v;
    }
    bool get1() {
        if (pos >= size) CORRUPT("data runs past the end of its NAL unit");
        bool v = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
        return v;
    }
    void check() const {
        if (pos > size) CORRUPT("data runs past the end of its NAL unit");
    }
    uint32_t ue() {
        int lz = 0;
        while (!get1()) {
            if (++lz > 31) CORRUPT("exp-Golomb code longer than 32 bits");
        }
        if (!lz) return 0;
        return uint32_t(((uint64_t)1 << lz) - 1 + get(lz));
    }
    int32_t se() {
        uint32_t k = ue();
        return (k & 1) ? int32_t((k + 1) / 2) : -int32_t(k / 2);
    }
    uint32_t ue_max(uint32_t max, const char* what) {
        uint32_t v = ue();
        if (v > max) CORRUPT("%s %u out of range", what, v);
        return v;
    }
    int32_t se_range(int lo, int hi, const char* what) {
        int32_t v = se();
        if (v < lo || v > hi) CORRUPT("%s %d out of range", what, v);
        return v;
    }
    // the position of the rbsp_stop_one_bit: the last 1 in the data
    int64_t stop_bit() const {
        for (int64_t b = size / 8 - 1; b >= 0; b--)
            if (d[b])
                for (int k = 0; k < 8; k++)
                    if (d[b] >> k & 1) return b * 8 + 7 - k;
        return -1;
    }
    bool byte_aligned() const { return !(pos & 7); }
};

// ------------------------------------------------------------------ tables

const uint8_t kZigzag4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kZigzag8[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                              12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                              35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                              58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
// the standard's default scaling lists, in raster order (as libavcodec's
// default_scaling4/8 hold them)
const uint8_t kDefault4[2][16] = {{6, 13, 20, 28, 13, 20, 28, 32, 20, 28, 32, 37, 28, 32, 37, 42},
                                  {10, 14, 20, 24, 14, 20, 24, 27, 20, 24, 27, 30, 24, 27, 30, 34}};
const uint8_t kDefault8[2][64] = {
    {6,  10, 13, 16, 18, 23, 25, 27, 10, 11, 16, 18, 23, 25, 27, 29, 13, 16, 18, 23, 25, 27,
     29, 31, 16, 18, 23, 25, 27, 29, 31, 33, 18, 23, 25, 27, 29, 31, 33, 36, 23, 25, 27, 29,
     31, 33, 36, 38, 25, 27, 29, 31, 33, 36, 38, 40, 27, 29, 31, 33, 36, 38, 40, 42},
    {9,  13, 15, 17, 19, 21, 22, 24, 13, 13, 17, 19, 21, 22, 24, 25, 15, 17, 19, 21, 22, 24,
     25, 27, 17, 19, 21, 22, 24, 25, 27, 28, 19, 21, 22, 24, 25, 27, 28, 30, 21, 22, 24, 25,
     27, 28, 30, 32, 22, 24, 25, 27, 28, 30, 32, 33, 24, 25, 27, 28, 30, 32, 33, 35}};
// LevelScale's normAdjust4x4 (v0 v1 v2) and normAdjust8x8 (v0-v5)
const int kNorm4[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16}, {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
const int kNorm8[6][6] = {{20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26}, {26, 23, 42, 24, 33, 31},
                          {28, 25, 45, 26, 35, 33}, {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};

int norm4(int q, int x, int y) {
    if (!(x & 1) && !(y & 1)) return kNorm4[q][0];
    if ((x & 1) && (y & 1)) return kNorm4[q][1];
    return kNorm4[q][2];
}
int norm8(int q, int x, int y) {
    if (!(x & 3) && !(y & 3)) return kNorm8[q][0];
    if ((x & 1) && (y & 1)) return kNorm8[q][1];
    if ((x & 3) == 2 && (y & 3) == 2) return kNorm8[q][2];
    if ((!(x & 3) && (y & 1)) || ((x & 1) && !(y & 3))) return kNorm8[q][3];
    if ((!(x & 3) && (y & 3) == 2) || ((x & 3) == 2 && !(y & 3))) return kNorm8[q][4];
    return kNorm8[q][5];
}

// coeff_token lookups: 16 bits of the stream → (total_coeff << 2 |
// trailing_ones) << 5 | length, 0 where no code matches; tables 0-3 by nC,
// 4 for chroma DC
struct CoeffTokenLut {
    std::vector<uint16_t> t[5];
    CoeffTokenLut() {
        for (int k = 0; k < 5; k++) {
            t[k].assign(65536, 0);
            for (int tc = 0; tc <= 16; tc++)
                for (int t1 = 0; t1 < 4; t1++) {
                    int len, code;
                    if (k < 4) {
                        len = kCoeffTokenLen[k][tc * 4 + t1];
                        code = kCoeffTokenBits[k][tc * 4 + t1];
                    } else {
                        if (tc > 4) continue;
                        len = kChromaDcCoeffTokenLen[tc * 4 + t1];
                        code = kChromaDcCoeffTokenBits[tc * 4 + t1];
                    }
                    if (!len) continue;
                    int lo = code << (16 - len), n = 1 << (16 - len);
                    for (int i = 0; i < n; i++) t[k][lo + i] = uint16_t((tc << 2 | t1) << 5 | len);
                }
        }
    }
};
const CoeffTokenLut& coeff_token_lut() {
    static const CoeffTokenLut lut;
    return lut;
}

// a VLC of a few short codes (total_zeros, run_before): lengths and words
int read_short_vlc(Bits& br, const uint8_t* len, const uint8_t* bits, int n, const char* what) {
    for (int l = 1; l <= 16; l++) {
        uint32_t v = br.show(l);
        for (int i = 0; i < n; i++)
            if (len[i] == l && bits[i] == v) {
                br.pos += l;
                br.check();
                return i;
            }
    }
    CORRUPT("invalid %s code", what);
}

// ------------------------------------------------------------------ parameter sets

struct Sps {
    bool valid = false;
    int profile = 0, level = 0, constraints = 0;
    int chroma_format = 1;
    bool scaling_present = false;
    uint8_t sl4[6][16];
    uint8_t sl8[2][64];
    int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4;
    bool delta_pic_order_always_zero = false;
    int offset_for_non_ref_pic = 0, offset_for_top_to_bottom_field = 0;
    std::vector<int> offset_for_ref_frame;
    int max_num_ref_frames = 0;
    bool gaps_allowed = false;
    int mb_w = 0, mb_h = 0;
    bool direct_8x8 = false;
    int crop_l = 0, crop_r = 0, crop_t = 0, crop_b = 0;   // samples
    bool vui = false, full_range = false, colour_description = false;
    int matrix = 2, chroma_loc = -1;
    bool bitstream_restriction = false;
    int num_reorder_frames = 0;
    uint32_t num_units_in_tick = 0, time_scale = 0;
    bool fallback_a = false, default_list = false;
    std::vector<uint8_t> raw;
};

struct Pps {
    bool valid = false;
    int sps_id = 0;
    bool cabac = false, bottom_field_pic_order = false;
    int num_ref_idx_default[2] = {1, 1};
    bool weighted_pred = false;
    int weighted_bipred_idc = 0;
    int init_qp = 26;
    int chroma_qp_offset[2] = {0, 0};
    bool deblocking_control = false, constrained_intra = false, redundant_pic_cnt_present = false;
    bool transform_8x8 = false;
    bool scaling_present = false, fallback_a = false, fallback_b = false, default_list = false;
    uint8_t sl4[6][16];
    uint8_t sl8[2][64];
    std::vector<uint8_t> raw;
};

// decode_scaling_list: ``fallback`` where the list is not sent, the
// default where its first delta makes nextScale 0
void scaling_list(Bits& br, uint8_t* out, int size, const uint8_t* def, const uint8_t* fallback,
                  bool& used_fallback, bool& used_default) {
    const uint8_t* scan = size == 16 ? kZigzag4 : kZigzag8;
    if (!br.get1()) {
        std::memcpy(out, fallback, size);
        used_fallback = true;
        return;
    }
    int last = 8, next = 8;
    for (int i = 0; i < size; i++) {
        if (next) {
            int v = br.se_range(-128, 127, "delta_scale");
            next = (last + v) & 0xff;
        }
        if (!i && !next) {
            std::memcpy(out, def, size);
            used_default = true;
            return;
        }
        last = out[scan[i]] = uint8_t(next ? next : last);
    }
}

void skip_hrd(Bits& br) {
    int cpb_cnt = (int)br.ue_max(31, "cpb_cnt_minus1") + 1;
    br.get(4);
    br.get(4);
    for (int i = 0; i < cpb_cnt; i++) {
        br.ue();
        br.ue();
        br.get1();
    }
    br.get(5);
    br.get(5);
    br.get(5);
    br.get(5);
}

bool high_profile(int p) {
    return p == 100 || p == 110 || p == 122 || p == 244 || p == 44 || p == 83 || p == 86 || p == 118 ||
           p == 128 || p == 138 || p == 139 || p == 134 || p == 135;
}

// what an SPS holds that the port refuses, checked when a slice uses it
struct SpsRefusal {
    int chroma_format = 1, bit_depth_luma = 8, bit_depth_chroma = 8;
    bool transform_bypass = false, frame_mbs_only = true, mbaff = false;
};

void parse_sps(Bits& br, Sps& s, SpsRefusal& r) {
    s.profile = (int)br.get(8);
    s.constraints = (int)br.get(8);
    s.level = (int)br.get(8);
    br.ue_max(31, "seq_parameter_set_id");
    if (high_profile(s.profile)) {
        r.chroma_format = (int)br.ue_max(3, "chroma_format_idc");
        if (r.chroma_format == 3) br.get1();   // separate_colour_plane_flag
        r.bit_depth_luma = (int)br.ue_max(6, "bit_depth_luma_minus8") + 8;
        r.bit_depth_chroma = (int)br.ue_max(6, "bit_depth_chroma_minus8") + 8;
        r.transform_bypass = br.get1();
        s.scaling_present = br.get1();
        if (s.scaling_present) {
            bool fb = false, def = false;
            const uint8_t* fb4[6] = {kDefault4[0], s.sl4[0], s.sl4[1], kDefault4[1], s.sl4[3], s.sl4[4]};
            for (int i = 0; i < 6; i++)
                scaling_list(br, s.sl4[i], 16, kDefault4[i / 3], fb4[i], fb, def);
            int n8 = r.chroma_format == 3 ? 6 : 2;
            for (int i = 0; i < n8; i++) {
                uint8_t tmp[64];
                scaling_list(br, i < 2 ? s.sl8[i] : tmp, 64, kDefault8[i & 1], kDefault8[i & 1], fb, def);
            }
            s.fallback_a = fb;
            s.default_list = def;
        }
    }
    if (!s.scaling_present) {
        std::memset(s.sl4, 16, sizeof s.sl4);
        std::memset(s.sl8, 16, sizeof s.sl8);
    }
    s.log2_max_frame_num = (int)br.ue_max(12, "log2_max_frame_num_minus4") + 4;
    s.poc_type = (int)br.ue_max(2, "pic_order_cnt_type");
    if (s.poc_type == 0) {
        s.log2_max_poc_lsb = (int)br.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
    } else if (s.poc_type == 1) {
        s.delta_pic_order_always_zero = br.get1();
        s.offset_for_non_ref_pic = br.se();
        s.offset_for_top_to_bottom_field = br.se();
        int n = (int)br.ue_max(255, "num_ref_frames_in_pic_order_cnt_cycle");
        s.offset_for_ref_frame.resize(n);
        for (int i = 0; i < n; i++) s.offset_for_ref_frame[i] = br.se();
    }
    s.max_num_ref_frames = (int)br.ue_max(16, "max_num_ref_frames");
    s.gaps_allowed = br.get1();
    s.mb_w = (int)br.ue_max(1023, "pic_width_in_mbs_minus1") + 1;
    int map_h = (int)br.ue_max(1023, "pic_height_in_map_units_minus1") + 1;
    r.frame_mbs_only = br.get1();
    if (!r.frame_mbs_only) r.mbaff = br.get1();
    s.mb_h = map_h * (r.frame_mbs_only ? 1 : 2);
    s.direct_8x8 = br.get1();
    if (br.get1()) {   // frame_cropping_flag
        int cx = r.chroma_format == 1 || r.chroma_format == 2 ? 2 : 1;
        int cy = (r.chroma_format == 1 ? 2 : 1) * (r.frame_mbs_only ? 1 : 2);
        s.crop_l = (int)br.ue_max(8192, "frame_crop_left_offset") * cx;
        s.crop_r = (int)br.ue_max(8192, "frame_crop_right_offset") * cx;
        s.crop_t = (int)br.ue_max(8192, "frame_crop_top_offset") * cy;
        s.crop_b = (int)br.ue_max(8192, "frame_crop_bottom_offset") * cy;
        if (s.crop_l + s.crop_r >= 16 * s.mb_w || s.crop_t + s.crop_b >= 16 * s.mb_h)
            CORRUPT("the frame crop leaves no picture");
    }
    s.vui = br.get1();
    if (s.vui) {
        if (br.get1()) {   // aspect_ratio_info_present_flag
            if (br.get(8) == 255) {
                br.get(16);
                br.get(16);
            }
        }
        if (br.get1()) br.get1();   // overscan
        if (br.get1()) {            // video_signal_type_present_flag
            br.get(3);
            s.full_range = br.get1();
            s.colour_description = br.get1();
            if (s.colour_description) {
                br.get(8);
                br.get(8);
                s.matrix = (int)br.get(8);
            }
        }
        if (br.get1()) {   // chroma_loc_info_present_flag
            s.chroma_loc = (int)br.ue_max(5, "chroma_sample_loc_type_top_field");
            br.ue_max(5, "chroma_sample_loc_type_bottom_field");
        }
        if (br.get1()) {   // timing_info_present_flag
            s.num_units_in_tick = br.get(32);
            s.time_scale = br.get(32);
            br.get1();
        }
        bool nal_hrd = br.get1();
        if (nal_hrd) skip_hrd(br);
        bool vcl_hrd = br.get1();
        if (vcl_hrd) skip_hrd(br);
        if (nal_hrd || vcl_hrd) br.get1();
        br.get1();   // pic_struct_present_flag
        s.bitstream_restriction = br.get1();
        if (s.bitstream_restriction) {
            br.get1();
            br.ue();
            br.ue();
            br.ue();
            br.ue();
            s.num_reorder_frames = (int)br.ue();
            br.ue();
            if (s.num_reorder_frames > 16) s.num_reorder_frames = 16;
        }
    }
}

void parse_pps(Bits& br, Pps& p, const Sps& s, bool& fmo) {
    p.cabac = br.get1();
    p.bottom_field_pic_order = br.get1();
    int groups = (int)br.ue_max(7, "num_slice_groups_minus1") + 1;
    fmo = groups > 1;
    if (fmo) {   // skipped: FMO is refused where a slice uses it
        int type = (int)br.ue_max(6, "slice_group_map_type");
        if (type == 0) {
            for (int i = 0; i < groups; i++) br.ue();
        } else if (type == 2) {
            for (int i = 0; i < groups - 1; i++) {
                br.ue();
                br.ue();
            }
        } else if (type >= 3 && type <= 5) {
            br.get1();
            br.ue();
        } else if (type == 6) {
            int n = (int)br.ue_max(1 << 20, "pic_size_in_map_units_minus1") + 1;
            int bits = 0;
            while ((1 << bits) < groups) bits++;
            for (int i = 0; i < n; i++) br.get(bits);
        }
    }
    p.num_ref_idx_default[0] = (int)br.ue_max(31, "num_ref_idx_l0_default_active_minus1") + 1;
    p.num_ref_idx_default[1] = (int)br.ue_max(31, "num_ref_idx_l1_default_active_minus1") + 1;
    p.weighted_pred = br.get1();
    p.weighted_bipred_idc = (int)br.get(2);
    p.init_qp = 26 + br.se_range(-26, 25, "pic_init_qp_minus26");
    br.se();   // pic_init_qs_minus26
    p.chroma_qp_offset[0] = p.chroma_qp_offset[1] = br.se_range(-12, 12, "chroma_qp_index_offset");
    p.deblocking_control = br.get1();
    p.constrained_intra = br.get1();
    p.redundant_pic_cnt_present = br.get1();
    std::memcpy(p.sl4, s.sl4, sizeof p.sl4);
    std::memcpy(p.sl8, s.sl8, sizeof p.sl8);
    // h264_ps.c: more data in the PPS, unless the profile's constraints
    // say it has none
    bool constrained = (s.profile == 66 || s.profile == 77 || s.profile == 88) && (s.constraints & 0xe0);
    if (br.pos < br.stop_bit() && !constrained) {
        p.transform_8x8 = br.get1();
        p.scaling_present = br.get1();
        if (p.scaling_present) {
            bool fb_sps = s.scaling_present;
            const uint8_t* fb[4] = {fb_sps ? s.sl4[0] : kDefault4[0], fb_sps ? s.sl4[3] : kDefault4[1],
                                    fb_sps ? s.sl8[0] : kDefault8[0], fb_sps ? s.sl8[1] : kDefault8[1]};
            bool used_fb = false, def = false;
            bool fb0 = false;
            scaling_list(br, p.sl4[0], 16, kDefault4[0], fb[0], fb0, def);
            scaling_list(br, p.sl4[1], 16, kDefault4[0], p.sl4[0], used_fb, def);
            scaling_list(br, p.sl4[2], 16, kDefault4[0], p.sl4[1], used_fb, def);
            bool fb3 = false;
            scaling_list(br, p.sl4[3], 16, kDefault4[1], fb[1], fb3, def);
            scaling_list(br, p.sl4[4], 16, kDefault4[1], p.sl4[3], used_fb, def);
            scaling_list(br, p.sl4[5], 16, kDefault4[1], p.sl4[4], used_fb, def);
            bool fb8 = false;
            if (p.transform_8x8) {
                scaling_list(br, p.sl8[0], 64, kDefault8[0], fb[2], fb8, def);
                scaling_list(br, p.sl8[1], 64, kDefault8[1], fb[3], fb8, def);
                if (s.chroma_format == 3) {
                    uint8_t tmp[64];
                    for (int i = 0; i < 4; i++) scaling_list(br, tmp, 64, kDefault8[i & 1], kDefault8[i & 1], fb8, def);
                }
            }
            bool any = used_fb || fb0 || fb3 || fb8;
            // rule B takes the SPS's lists, rule A the defaults
            (fb_sps ? p.fallback_b : p.fallback_a) = any;
            p.default_list = def;
        }
        p.chroma_qp_offset[1] = br.se_range(-12, 12, "second_chroma_qp_index_offset");
    }
}

// ------------------------------------------------------------------ pictures

struct Picture {
    int w = 0, h = 0;   // coded size
    std::vector<uint8_t> y, u, v;
    int frame_num = 0, poc = 0;
    int long_term_idx = -1;
    bool short_ref = false, long_ref = false;
    bool key = false, mmco_reset = false, recovered = false, is_b = false;
    int serial = 0;
    int64_t id = 0;
    // what a later B picture's direct prediction reads of it, as it stands
    // co-located (list 1's first picture): per macroblock whether intra,
    // per 8x8 each list's reference index, per 4x4 each list's vector, and
    // (as FFmpeg keeps them, from its last slice) the frame_num of each
    // list's entries
    std::vector<uint8_t> col_intra;
    std::vector<int8_t> col_ref[2];
    std::vector<int16_t> col_mv[2];
    int ref_count[2] = {0, 0};
    int ref_fn[2][32];
};
using PicPtr = std::shared_ptr<Picture>;

enum MbKind { MB_I4, MB_I8, MB_I16, MB_PCM, MB_P, MB_SKIP };

struct MbInfo {
    int slice = -1;
    uint8_t kind = MB_P;
    bool t8 = false;
    int qp = 0;
    int cbp = 0;          // luma bits 0-3, chroma 4-5
    int cbf_dc = 0;       // CABAC's coded_block_flag of the DC blocks: luma, Cb, Cr
    int chroma_mode = 0;
    int qp_delta = 0;
    int8_t ipred[16];     // raster 4x4: intra 4x4/8x8 modes, 2 for other intra, -1 inter
    uint8_t nnz[16];      // raster 4x4: total_coeff (CAVLC), coefficients or not (CABAC)
    uint8_t nnzc[2][4];   // chroma AC, raster 2x2
    uint8_t nzd[16];      // deblocking: coefficients in the 4x4 (or its 8x8) block
    int8_t ref[2][4];     // per list, per 8x8 (raster): -1 intra or unused
    int64_t ref_id[2][4]; // the picture each refers to, -1 none
    int16_t mv[2][16][2];
    uint8_t mvd[2][16][2];   // CABAC: |mvd| capped at 70
    uint8_t direct8 = 0;  // the 8x8 blocks predicted as direct (or skipped)
    bool direct16 = false;   // B_Skip or B_Direct_16x16
    bool intra() const { return kind <= MB_PCM; }
};

struct SliceParams {
    int disable_deblock = 0, alpha_off = 0, beta_off = 0;
    int chroma_qp_offset[2] = {0, 0};
    bool b = false;
};

struct RefEntry {
    PicPtr pic;
    // explicit weights (luma, Cb, Cr): weight, offset, whether sent
    int w[3] = {1, 1, 1}, o[3] = {0, 0, 0};
    bool weighted[3] = {false, false, false};
};

// the decoder's CABAC engine (9.3.3.2), one bin at a time
struct Cabac {
    Bits* br = nullptr;
    uint32_t range = 0, offset = 0;
    int overread = 0;
    uint8_t state[1024], mps[1024];

    int bit() {
        if (br->pos >= br->size) {
            if (++overread > 64) CORRUPT("CABAC data runs past the end of its slice");
            br->pos++;
            return 0;
        }
        int v = (br->d[br->pos >> 3] >> (7 - (br->pos & 7))) & 1;
        br->pos++;
        return v;
    }
    void start() {
        range = 510;
        offset = 0;
        for (int i = 0; i < 9; i++) offset = (offset << 1) | bit();
        if (offset >= 510) CORRUPT("CABAC offset %u at the start of a slice", offset);
    }
    void init_contexts(int table, int qp) {
        qp = clip3(0, 51, qp);
        for (int i = 0; i < 1024; i++) {
            int m = kCabacInit[table][i][0], n = kCabacInit[table][i][1];
            int pre = clip3(1, 126, ((m * qp) >> 4) + n);
            if (pre <= 63) {
                state[i] = uint8_t(63 - pre);
                mps[i] = 0;
            } else {
                state[i] = uint8_t(pre - 64);
                mps[i] = 1;
            }
        }
    }
    int decision(int ctx) {
        int s = state[ctx];
        uint32_t lps = kRangeTabLPS[s][(range >> 6) & 3];
        range -= lps;
        int bin;
        if (offset >= range) {
            bin = !mps[ctx];
            offset -= range;
            range = lps;
            if (!s) mps[ctx] = uint8_t(1 - mps[ctx]);
            state[ctx] = kTransIdxLPS[s];
        } else {
            bin = mps[ctx];
            if (s < 62) state[ctx] = uint8_t(s + 1);
        }
        while (range < 256) {
            range <<= 1;
            offset = (offset << 1) | bit();
        }
        return bin;
    }
    int bypass() {
        offset = (offset << 1) | bit();
        if (offset >= range) {
            offset -= range;
            return 1;
        }
        return 0;
    }
    int terminate() {
        range -= 2;
        if (offset >= range) return 1;
        while (range < 256) {
            range <<= 1;
            offset = (offset << 1) | bit();
        }
        return 0;
    }
};

// one macroblock as parsed: levels in scan order, dequantised later
struct MbData {
    int kind = MB_P;
    int part = 0;          // P: 0 16x16, 1 16x8, 2 8x16, 3 8x8, 4 8x8ref0
    int sub[4] = {0, 0, 0, 0};
    bool t8 = false;
    int i16_mode = 0, chroma_mode = 0;
    int cbp = 0;
    int ipred[16];         // decode order: 4x4 modes, or 8x8 modes in [0..3]
    int16_t lv4[16][16];   // luma 4x4 blocks (decode order), scan order
    int16_t lv8[4][64];
    int16_t dc[16];
    int16_t cdc[2][4];
    int16_t cac[2][4][16];   // chroma AC, scan positions 1-15 at [1..15]
    uint8_t pcm[384];
};

const int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
const int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
const int kRasterToBlk[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};
inline int raster(int b) { return kBlkY[b] * 4 + kBlkX[b]; }


struct Mmco {
    int op, a, b;
};

void refuse(const SpsRefusal& r) {
    if (r.chroma_format != 1) UNSUPPORTED("chroma_format_idc %d (other than 4:2:0)", r.chroma_format);
    if (r.bit_depth_luma != 8 || r.bit_depth_chroma != 8)
        UNSUPPORTED("a bit depth of %d/%d (above 8)", r.bit_depth_luma, r.bit_depth_chroma);
    if (r.transform_bypass) UNSUPPORTED("qpprime_y_zero_transform_bypass (lossless)");
    if (!r.frame_mbs_only) UNSUPPORTED("frame_mbs_only_flag 0 (field pictures and MBAFF)");
}

struct SliceHeader {
    int first_mb = 0, type = 0, pps_id = 0, frame_num = 0;
    int poc_lsb = 0, delta_poc_bottom = 0, delta_poc[2] = {0, 0};
    int num_ref_idx = 0, num_ref_idx1 = 0;
    bool direct_spatial = false;
    std::vector<std::pair<int, int>> mods, mods1;
    int luma_log2 = 0, chroma_log2 = 0;
    // pred_weight_table, per list
    int lw[2][32] = {}, lo[2][32] = {}, cw[2][32][2] = {}, co[2][32][2] = {};
    bool lflag[2][32] = {}, cflag[2][32] = {};
    bool long_term_reference = false, adaptive = false;
    std::vector<Mmco> mmco;
    int cabac_init_idc = 0, qp_delta = 0;
    int disable_deblock = 0, alpha = 0, beta = 0;
};

struct Decoder {
    Sps sps[32];
    SpsRefusal sps_refusal[32];
    Pps pps[256];
    bool pps_fmo[256];
    int nal_length_size = 0;   // 0: Annex B
    bool headers_only = false;   // parameter sets alone (h264_probe)

    // the active parameter sets and the picture geometry
    const Sps* S = nullptr;
    const Pps* P = nullptr;
    int mb_w = 0, mb_h = 0, width = 0, height = 0;
    int dq4[6][52][16], dq8[2][52][64];
    int pps_version = 0, dq_version = -1;

    // references and the output queue
    std::vector<PicPtr> refs;
    int max_long_term_idx = -1;
    std::vector<PicPtr> delayed, out;
    int has_b_frames = 0;
    int last_pocs[16];
    int next_outputed_poc = INT_MIN;
    int frame_recovered = 0;   // 1: IDR, 2: SEI
    int recovery_frame = -1;
    bool valid_recovery_point = false;
    int sei_recovery = -1;
    bool mmco_reset = false;

    // POC and frame_num state (8.2.1)
    int prev_poc_msb = 0, prev_poc_lsb = 0, prev_frame_num_offset = 0, prev_frame_num = 0;
    int prev_ref_frame_num = 0;
    bool prev_mmco5 = false, have_prev = false;

    // the picture being decoded
    PicPtr cur;
    SliceHeader first;   // its first slice's header (marking, POC)
    int cur_ref_idc = 0;
    bool cur_idr = false;
    int frame_num_offset = 0, poc_msb = 0;
    std::vector<MbInfo> mbs;
    int mbs_done = 0;
    std::vector<SliceParams> slices;
    int64_t next_id = 1;
    int serial = -1;
    int pictures = 0;
    uint64_t features = 0, modes = 0, features_b = 0;

    // the slice being decoded
    Bits br;
    Cabac cab;
    bool is_cabac = false;
    int slice_idx = 0, slice_type = 0, qp = 0, last_qp_delta = 0;
    RefEntry list[2][33];
    int nref[2] = {0, 0};
    int luma_log2 = 0, chroma_log2 = 0;
    int wmode = 0;   // 0 none, 1 explicit, 2 implicit (B)
    int implicit_w[16][16];   // implicit bi-prediction: list 0's weight
    bool implicit_fb[16][16];   // ... 32 by the fall-back rule
    bool direct_spatial = false;
    int map_col[2][32];   // temporal direct: the co-located's index → list 0's, -1 none
    int dsf[16];          // temporal direct: DistScaleFactor of each list 0 entry
    int cqp_off[2] = {0, 0};
    int mb_x = 0, mb_y = 0, mb_addr = 0;
    bool assigned[2][16];
    std::vector<uint8_t> rbsp;

    Decoder() {
        for (int i = 0; i < 16; i++) last_pocs[i] = INT_MIN;
        std::memset(pps_fmo, 0, sizeof pps_fmo);
    }

    void feat(int f) { features |= uint64_t(1) << f; }
    void featb(int f) { features_b |= uint64_t(1) << f; }

    // ------------------------------------------------------------ NAL units

    // the RBSP of a NAL unit's payload (after its header byte)
    void unescape(const uint8_t* d, int64_t n) {
        rbsp.clear();
        rbsp.reserve(n);
        int zeros = 0;
        for (int64_t i = 0; i < n; i++) {
            if (zeros >= 2 && d[i] == 3) {
                zeros = 0;
                continue;
            }
            rbsp.push_back(d[i]);
            zeros = d[i] ? 0 : zeros + 1;
        }
    }

    void extradata(const uint8_t* d, int64_t n) {
        if (n >= 7 && d[0] == 1) {   // avcC
            nal_length_size = (d[4] & 3) + 1;
            if (nal_length_size == 3) CORRUPT("avcC with a 3-byte NAL length");
            feat(F_AVCC);
            int64_t p = 5;
            for (int k = 0; k < 2; k++) {
                if (p >= n) CORRUPT("truncated avcC");
                int count = k == 0 ? (d[p] & 31) : d[p];
                p++;
                for (int i = 0; i < count; i++) {
                    if (p + 2 > n) CORRUPT("truncated avcC");
                    int64_t len = d[p] << 8 | d[p + 1];
                    p += 2;
                    if (p + len > n || len < 1) CORRUPT("truncated avcC parameter set");
                    nal(d + p, len);
                    p += len;
                }
            }
            return;
        }
        annexb(d, n);
    }

    void annexb(const uint8_t* d, int64_t n) {
        int64_t i = 0, start = -1;
        while (i + 2 < n) {
            if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) {
                if (start >= 0) nal(d + start, trim(d, start, i));
                i += 3;
                start = i;
                continue;
            }
            i++;
        }
        if (start >= 0) nal(d + start, trim(d, start, n));
    }
    static int64_t trim(const uint8_t* d, int64_t start, int64_t end) {
        while (end > start && d[end - 1] == 0) end--;   // trailing_zero_8bits
        return end - start;
    }

    void packet(const uint8_t* d, int64_t n) {
        if (!nal_length_size) {
            feat(F_ANNEXB);
            annexb(d, n);
            return;
        }
        int64_t p = 0;
        while (p < n) {
            if (p + nal_length_size > n) CORRUPT("truncated NAL length");
            int64_t len = 0;
            for (int i = 0; i < nal_length_size; i++) len = len << 8 | d[p + i];
            p += nal_length_size;
            if (len > n - p) CORRUPT("NAL unit of %lld bytes past the end of its packet", (long long)len);
            if (len) nal(d + p, len);
            p += len;
        }
    }

    void nal(const uint8_t* d, int64_t n) {
        if (n < 1) return;
        if (d[0] & 0x80) CORRUPT("forbidden_zero_bit set");
        int ref_idc = d[0] >> 5 & 3, type = d[0] & 31;
        if (headers_only && type != 7 && type != 8) return;
        switch (type) {
        case 1:
        case 5:
            unescape(d + 1, n - 1);
            br.reset(rbsp.data(), (int64_t)rbsp.size());
            slice(type == 5, ref_idc);
            break;
        case 2:
        case 3:
        case 4:
            UNSUPPORTED("data partitioning (NAL unit type %d)", type);
        case 6:
            unescape(d + 1, n - 1);
            br.reset(rbsp.data(), (int64_t)rbsp.size());
            try {
                sei();
            } catch (const Failure&) {
                // FFmpeg logs a damaged SEI message and decodes on
            }
            break;
        case 7: {
            unescape(d + 1, n - 1);
            br.reset(rbsp.data(), (int64_t)rbsp.size());
            Sps s;
            SpsRefusal r;
            if (rbsp.size() < 4) CORRUPT("truncated SPS");
            int id;
            {
                Bits peek = br;
                peek.get(24);
                id = (int)peek.ue_max(31, "seq_parameter_set_id");
            }
            parse_sps(br, s, r);
            s.valid = true;
            s.raw = rbsp;
            if (sps[id].valid) {
                if (sps[id].raw == s.raw) {
                    feat(F_PARAMS_RESENT);
                    break;
                }
                if (cur) UNSUPPORTED("an SPS changed inside a picture");
            }
            sps[id] = s;
            sps_refusal[id] = r;
            break;
        }
        case 8: {
            unescape(d + 1, n - 1);
            br.reset(rbsp.data(), (int64_t)rbsp.size());
            int id = (int)br.ue_max(255, "pic_parameter_set_id");
            int sid = (int)br.ue_max(31, "seq_parameter_set_id");
            if (!sps[sid].valid) CORRUPT("PPS %d refers to SPS %d, which was not sent", id, sid);
            Pps p;
            p.sps_id = sid;
            bool fmo = false;
            parse_pps(br, p, sps[sid], fmo);
            p.valid = true;
            p.raw = rbsp;
            if (pps[id].valid && pps[id].raw == p.raw) {
                feat(F_PARAMS_RESENT);
                break;
            }
            if (cur && P == &pps[id]) UNSUPPORTED("a PPS changed inside a picture");
            pps[id] = p;
            pps_fmo[id] = fmo;
            pps_version++;
            break;
        }
        default:   // AUD, end of sequence/stream, filler, SPS extension, prefix, MVC/SVC
            break;
        }
    }

    void sei() {
        int64_t stop = br.stop_bit();
        while (br.pos + 16 <= stop) {
            int type = 0, size = 0, b;
            do {
                b = (int)br.get(8);
                type += b;
            } while (b == 255);
            do {
                b = (int)br.get(8);
                size += b;
            } while (b == 255);
            int64_t end = br.pos + 8 * (int64_t)size;
            if (end > br.size) CORRUPT("SEI message past the end of its NAL unit");
            if (type == 6) {   // recovery point
                sei_recovery = (int)br.ue_max(65535, "recovery_frame_cnt");
                feat(F_RECOVERY_POINT);
            }
            br.pos = end;
        }
    }

    // ------------------------------------------------------------ slices

    const Sps& activate(const SliceHeader& h) {
        const Pps& p = pps[h.pps_id];
        refuse(sps_refusal[p.sps_id]);
        if (pps_fmo[h.pps_id]) UNSUPPORTED("slice groups (FMO)");
        return sps[p.sps_id];
    }

    void parse_header(SliceHeader& h, bool idr, int ref_idc) {
        h.first_mb = (int)br.ue();
        int t = (int)br.ue_max(9, "slice_type");
        h.type = t % 5;
        if (h.type == 3 || h.type == 4) UNSUPPORTED("SP and SI slices");
        h.pps_id = (int)br.ue_max(255, "pic_parameter_set_id");
        if (!pps[h.pps_id].valid) CORRUPT("slice refers to PPS %d, which was not sent", h.pps_id);
        const Pps& p = pps[h.pps_id];
        if (!sps[p.sps_id].valid) CORRUPT("PPS %d's SPS was not sent", h.pps_id);
        const Sps& s = activate(h);
        h.frame_num = (int)br.get(s.log2_max_frame_num);
        if (idr) br.ue_max(65535, "idr_pic_id");
        if (s.poc_type == 0) {
            h.poc_lsb = (int)br.get(s.log2_max_poc_lsb);
            if (p.bottom_field_pic_order) h.delta_poc_bottom = br.se();
        } else if (s.poc_type == 1 && !s.delta_pic_order_always_zero) {
            h.delta_poc[0] = br.se();
            if (p.bottom_field_pic_order) h.delta_poc[1] = br.se();
        }
        if (p.redundant_pic_cnt_present) {
            int rpc = (int)br.ue_max(127, "redundant_pic_cnt");
            if (rpc) UNSUPPORTED("redundant pictures (redundant_pic_cnt %d)", rpc);
        }
        h.num_ref_idx = h.num_ref_idx1 = 0;
        if (h.type == 1) h.direct_spatial = br.get1();
        if (h.type != 2) {
            h.num_ref_idx = p.num_ref_idx_default[0];
            if (h.type == 1) h.num_ref_idx1 = p.num_ref_idx_default[1];
            if (br.get1()) {   // num_ref_idx_active_override_flag
                h.num_ref_idx = (int)br.ue_max(31, "num_ref_idx_l0_active_minus1") + 1;
                if (h.type == 1) h.num_ref_idx1 = (int)br.ue_max(31, "num_ref_idx_l1_active_minus1") + 1;
            }
            // h264_parse_ref_count: a frame holds at most 16 a list; FFmpeg
            // drops the slice and conceals it
            if (h.num_ref_idx > 16 || h.num_ref_idx1 > 16)
                UNSUPPORTED("more than 16 reference indices in a frame's list (FFmpeg conceals the slice)");
            for (int l = 0; l < (h.type == 1 ? 2 : 1); l++) {
                if (!br.get1()) continue;   // ref_pic_list_modification_flag_lX
                auto& mods = l ? h.mods1 : h.mods;
                for (int k = 0;; k++) {
                    if (k > 32) CORRUPT("too many reference list modifications");
                    int idc = (int)br.ue_max(3, "modification_of_pic_nums_idc");
                    if (idc == 3) break;
                    mods.emplace_back(idc, (int)br.ue());
                }
            }
            if ((p.weighted_pred && h.type == 0) || (p.weighted_bipred_idc == 1 && h.type == 1)) {
                h.luma_log2 = (int)br.ue_max(7, "luma_log2_weight_denom");
                h.chroma_log2 = (int)br.ue_max(7, "chroma_log2_weight_denom");
                for (int l = 0; l < (h.type == 1 ? 2 : 1); l++)
                    for (int i = 0; i < (l ? h.num_ref_idx1 : h.num_ref_idx); i++) {
                        h.lflag[l][i] = br.get1();
                        h.lw[l][i] = 1 << h.luma_log2;
                        h.lo[l][i] = 0;
                        if (h.lflag[l][i]) {
                            h.lw[l][i] = br.se_range(-128, 127, "luma_weight");
                            h.lo[l][i] = br.se_range(-128, 127, "luma_offset");
                        }
                        h.cflag[l][i] = br.get1();
                        for (int j = 0; j < 2; j++) {
                            h.cw[l][i][j] = 1 << h.chroma_log2;
                            h.co[l][i][j] = 0;
                            if (h.cflag[l][i]) {
                                h.cw[l][i][j] = br.se_range(-128, 127, "chroma_weight");
                                h.co[l][i][j] = br.se_range(-128, 127, "chroma_offset");
                            }
                        }
                    }
            }
        }
        if (ref_idc) {
            if (idr) {
                br.get1();   // no_output_of_prior_pics_flag: FFmpeg passes it over
                h.long_term_reference = br.get1();
            } else {
                h.adaptive = br.get1();
                if (h.adaptive) {
                    for (int k = 0;; k++) {
                        if (k > 66) CORRUPT("too many memory management operations");
                        int op = (int)br.ue_max(6, "memory_management_control_operation");
                        if (!op) break;
                        Mmco m{op, 0, 0};
                        if (op == 1 || op == 3) m.a = (int)br.ue();
                        if (op == 2) m.a = (int)br.ue();
                        if (op == 3 || op == 6) m.b = (int)br.ue_max(15, "long_term_frame_idx");
                        if (op == 4) m.a = (int)br.ue_max(16, "max_long_term_frame_idx_plus1");
                        h.mmco.push_back(m);
                    }
                }
            }
        }
        if (p.cabac && h.type != 2) h.cabac_init_idc = (int)br.ue_max(2, "cabac_init_idc");
        h.qp_delta = br.se();
        if (p.init_qp + h.qp_delta < 0 || p.init_qp + h.qp_delta > 51)
            CORRUPT("slice QP %d out of range", p.init_qp + h.qp_delta);
        h.disable_deblock = 0;
        h.alpha = h.beta = 0;
        if (p.deblocking_control) {
            h.disable_deblock = (int)br.ue_max(2, "disable_deblocking_filter_idc");
            if (h.disable_deblock != 1) {
                h.alpha = br.se_range(-6, 6, "slice_alpha_c0_offset_div2") * 2;
                h.beta = br.se_range(-6, 6, "slice_beta_offset_div2") * 2;
            }
        }
    }

    void slice(bool idr, int ref_idc) {
        SliceHeader h;
        parse_header(h, idr, ref_idc);
        const Pps& p = pps[h.pps_id];
        const Sps& s = sps[p.sps_id];
        if (h.first_mb == 0) {
            if (cur) UNSUPPORTED("two pictures in one packet, of which FFmpeg hands over only the last");
            start_picture(h, s, p, idr, ref_idc);
        } else {
            if (!cur) UNSUPPORTED("a picture whose first slice is missing (FFmpeg conceals it)");
            if (&s != S || (idr != cur_idr) || h.frame_num != first.frame_num)
                UNSUPPORTED("a slice of another picture inside a picture (FFmpeg conceals the rest)");
            if (h.first_mb >= mb_w * mb_h) CORRUPT("first_mb_in_slice %d of %d", h.first_mb, mb_w * mb_h);
            feat(F_MULTI_SLICE);
        }
        P = &p;
        decode_slice(h);
    }

    // ------------------------------------------------------------ pictures

    void dequant_tables() {
        if (dq_version == pps_version && P == dq_pps) return;
        dq_pps = P;
        dq_version = pps_version;
        for (int l = 0; l < 6; l++)
            for (int q = 0; q < 52; q++)
                for (int i = 0; i < 16; i++)
                    dq4[l][q][i] = (norm4(q % 6, i & 3, i >> 2) * P->sl4[l][i]) << (q / 6 + 2);
        for (int l = 0; l < 2; l++)
            for (int q = 0; q < 52; q++)
                for (int i = 0; i < 64; i++) dq8[l][q][i] = (norm8(q % 6, i & 7, i >> 3) * P->sl8[l][i]) << (q / 6);
    }
    const Pps* dq_pps = nullptr;

    void start_picture(const SliceHeader& h, const Sps& s, const Pps& p, bool idr, int ref_idc) {
        if (S && (s.mb_w != mb_w || s.mb_h != mb_h) && pictures)
            UNSUPPORTED("a change of picture size from %dx%d macroblocks to %dx%d", mb_w, mb_h, s.mb_w, s.mb_h);
        S = &s;
        mb_w = s.mb_w;
        mb_h = s.mb_h;
        width = 16 * mb_w;
        height = 16 * mb_h;
        const int max_frame_num = 1 << s.log2_max_frame_num;
        if (idr) {
            if (h.frame_num) CORRUPT("an IDR picture with frame_num %d", h.frame_num);
            // idr(): every reference dropped, the POC guess restarted
            refs.clear();
            max_long_term_idx = -1;
            for (int i = 0; i < 16; i++) last_pocs[i] = INT_MIN;
            prev_poc_msb = prev_poc_lsb = prev_frame_num_offset = prev_frame_num = 0;
            prev_ref_frame_num = 0;
            prev_mmco5 = false;
            if (have_prev) feat(F_MID_IDR);
        } else if (have_prev && h.frame_num != prev_ref_frame_num &&
                   h.frame_num != (prev_ref_frame_num + 1) % max_frame_num) {
            UNSUPPORTED("a gap in frame_num (%d after %d), which FFmpeg conceals", h.frame_num, prev_ref_frame_num);
        }
        if (!idr && h.type == 2) feat(F_NON_IDR_I);
        if (!ref_idc) feat(F_NON_REF);
        first = h;
        cur_idr = idr;
        cur_ref_idc = ref_idc;
        // 8.2.1: the picture order count
        int poc = 0;
        if (s.poc_type == 0) {
            feat(F_POC0);
            int max_lsb = 1 << s.log2_max_poc_lsb;
            int pm = prev_poc_msb, pl = prev_poc_lsb;
            if (idr) pm = pl = 0;
            if (h.poc_lsb < pl && pl - h.poc_lsb >= max_lsb / 2) poc_msb = pm + max_lsb;
            else if (h.poc_lsb > pl && h.poc_lsb - pl > max_lsb / 2) poc_msb = pm - max_lsb;
            else poc_msb = pm;
            int top = poc_msb + h.poc_lsb;
            int bottom = top + h.delta_poc_bottom;
            poc = std::min(top, bottom);
        } else {
            feat(s.poc_type == 1 ? F_POC1 : F_POC2);
            int prev_off = prev_mmco5 ? 0 : prev_frame_num_offset;
            if (idr) frame_num_offset = 0;
            else if (prev_frame_num > h.frame_num) frame_num_offset = prev_off + max_frame_num;
            else frame_num_offset = prev_off;
            if (s.poc_type == 1) {
                int n = (int)s.offset_for_ref_frame.size();
                int abs_num = n ? frame_num_offset + h.frame_num : 0;
                if (!ref_idc && abs_num > 0) abs_num--;
                int expected = 0;
                if (abs_num > 0) {
                    int delta = 0;
                    for (int i = 0; i < n; i++) delta += s.offset_for_ref_frame[i];
                    int cycle = (abs_num - 1) / n, in_cycle = (abs_num - 1) % n;
                    expected = cycle * delta;
                    for (int i = 0; i <= in_cycle; i++) expected += s.offset_for_ref_frame[i];
                }
                if (!ref_idc) expected += s.offset_for_non_ref_pic;
                int top = expected + h.delta_poc[0];
                int bottom = top + s.offset_for_top_to_bottom_field + h.delta_poc[1];
                poc = std::min(top, bottom);
            } else {
                poc = idr ? 0 : !ref_idc ? 2 * (frame_num_offset + h.frame_num) - 1
                                         : 2 * (frame_num_offset + h.frame_num);
            }
        }
        if (s.vui) feat(F_VUI);
        if (s.bitstream_restriction) feat(F_REORDER);
        if (s.full_range) feat(F_FULL_RANGE);
        if (s.colour_description) feat(F_COLOUR_DESCRIPTION);
        if (s.chroma_loc >= 0) feat(F_CHROMA_LOC);
        if (s.crop_l | s.crop_r | s.crop_t | s.crop_b) feat(F_CROPPING);
        if (s.crop_l & 63) feat(F_LEFT_CROP_DROPPED);
        if (s.scaling_present) feat(F_SPS_SCALING);
        if (s.fallback_a || p.fallback_a) feat(F_FALLBACK_A);
        if (p.fallback_b) feat(F_FALLBACK_B);
        if (s.default_list || p.default_list) feat(F_DEFAULT_LIST);
        if (p.scaling_present) feat(F_PPS_SCALING);
        if (p.chroma_qp_offset[0]) feat(F_CHROMA_QP_OFFSET);
        if (p.chroma_qp_offset[1] != p.chroma_qp_offset[0]) feat(F_SECOND_CHROMA_QP_OFFSET);
        if (p.constrained_intra) feat(F_CONSTRAINED_INTRA);
        if (p.cabac) feat(F_CABAC);
        else feat(F_CAVLC);

        cur = std::make_shared<Picture>();
        cur->w = width;
        cur->h = height;
        cur->y.assign((size_t)width * height, 0);
        cur->u.assign((size_t)width * height / 4, 0);
        cur->v.assign((size_t)width * height / 4, 0);
        cur->frame_num = h.frame_num;
        cur->poc = poc;
        cur->key = idr;
        cur->is_b = h.type == 1;
        cur->serial = serial;
        cur->id = next_id++;
        mbs.assign((size_t)mb_w * mb_h, MbInfo());
        mbs_done = 0;
        slices.clear();

        // h264_field_start: the recovery point, and which pictures count as
        // recovered
        if (sei_recovery >= 0) {
            if (h.frame_num != sei_recovery || h.type != 2) valid_recovery_point = true;
            int mask = max_frame_num - 1;
            if (recovery_frame < 0 || ((recovery_frame - h.frame_num) & mask) > sei_recovery) {
                recovery_frame = (h.frame_num + sei_recovery) & mask;
                if (!valid_recovery_point) recovery_frame = h.frame_num;
            }
            sei_recovery = -1;
        }
        if (idr || (recovery_frame == h.frame_num && ref_idc)) {
            recovery_frame = -1;
            cur->recovered = true;
        }
        if (idr) frame_recovered |= 1;
        if (frame_recovered) cur->recovered = true;
        select_output();
        pictures++;
    }

    // h264_select_output_frame
    void select_output() {
        cur->mmco_reset = mmco_reset;
        mmco_reset = false;
        if (S->bitstream_restriction) has_b_frames = std::max(has_b_frames, S->num_reorder_frames);
        int i = 0;
        for (;; i++) {
            if (i == 16 || cur->poc < last_pocs[i]) {
                if (i) last_pocs[i - 1] = cur->poc;
                break;
            } else if (i) {
                last_pocs[i - 1] = last_pocs[i];
            }
        }
        int out_of_order = 16 - i;
        if (cur->is_b || (last_pocs[14] > INT_MIN && (int64_t)last_pocs[15] - last_pocs[14] > 2))
            out_of_order = std::max(out_of_order, 1);
        if (out_of_order == 16) {
            for (int k = 1; k < 16; k++) last_pocs[k] = INT_MIN;
            last_pocs[0] = cur->poc;
            cur->mmco_reset = true;
        } else if (out_of_order && !S->bitstream_restriction) {
            // the POCs show reordering (whether or not the depth the decoder
            // started from already covers it)
            feat(F_REORDER_GUESSED);
            has_b_frames = std::max(has_b_frames, out_of_order);
        }
        delayed.push_back(cur);
        int pics = (int)delayed.size();
        PicPtr o = delayed[0];
        int oi = 0;
        for (int k = 1; k < pics && !delayed[k]->key && !delayed[k]->mmco_reset; k++)
            if (delayed[k]->poc < o->poc) {
                o = delayed[k];
                oi = k;
            }
        if (has_b_frames == 0 && (delayed[0]->key || delayed[0]->mmco_reset)) next_outputed_poc = INT_MIN;
        bool ooo = o->poc < next_outputed_poc;
        if (ooo || pics > has_b_frames) delayed.erase(delayed.begin() + oi);
        if (!ooo && pics > has_b_frames) {
            if (oi == 0 && !delayed.empty() && (delayed[0]->key || delayed[0]->mmco_reset))
                next_outputed_poc = INT_MIN;
            else
                next_outputed_poc = o->poc;
            if (o->recovered) frame_recovered |= 2;
            if (frame_recovered & 2) o->recovered = true;
            // handed over at the end of the packet if recovered by then (an
            // I picture's reference marking may recover it: finalize_frame)
            out.push_back(o);
        }
    }

    // send_next_delayed_frame, until none is left
    void flush() {
        while (!delayed.empty()) {
            PicPtr o = delayed[0];
            int oi = 0;
            for (int k = 1; k < (int)delayed.size() && !delayed[k]->key && !delayed[k]->mmco_reset; k++)
                if (delayed[k]->poc < o->poc) {
                    o = delayed[k];
                    oi = k;
                }
            delayed.erase(delayed.begin() + oi);
            if (o->recovered) frame_recovered |= 1;
            if (frame_recovered & 2) o->recovered = true;
            if (o->recovered) out.push_back(o);
        }
    }

    void finish_picture() {
        if (mbs_done != mb_w * mb_h)
            UNSUPPORTED("a picture with %d of its %d macroblocks missing, which FFmpeg conceals",
                        mb_w * mb_h - mbs_done, mb_w * mb_h);
        deblock();
        // what a B picture reads of this one where it lies co-located
        const int n = mb_w * mb_h;
        cur->col_intra.resize(n);
        for (int l = 0; l < 2; l++) {
            cur->col_ref[l].resize(4 * n);
            cur->col_mv[l].resize(32 * n);
        }
        for (int a = 0; a < n; a++) {
            const MbInfo& m = mbs[a];
            cur->col_intra[a] = m.intra();
            for (int l = 0; l < 2; l++) {
                std::memcpy(&cur->col_ref[l][4 * a], m.ref[l], 4);
                std::memcpy(&cur->col_mv[l][32 * a], m.mv[l], 64);
            }
        }
        if (cur_ref_idc) {
            if (cur->is_b) featb(FB_B_REFERENCE);
            mark_references();
            prev_poc_msb = poc_msb;
            prev_poc_lsb = first.poc_lsb;
            if (prev_mmco5_now) {
                prev_poc_msb = 0;
                prev_poc_lsb = 0;
            }
            prev_ref_frame_num = prev_mmco5_now ? 0 : first.frame_num;
        }
        prev_frame_num_offset = frame_num_offset;
        prev_frame_num = prev_mmco5_now ? 0 : first.frame_num;
        prev_mmco5 = prev_mmco5_now;
        prev_mmco5_now = false;
        have_prev = true;
        cur.reset();
    }
    bool prev_mmco5_now = false;

    // 8.2.5: the reference marking, and FFmpeg's recovery guess for an I
    // picture with few references
    void mark_references() {
        const int max_frame_num = 1 << S->log2_max_frame_num;
        auto pic_num = [&](const PicPtr& r) {
            return r->frame_num > cur->frame_num ? r->frame_num - max_frame_num : r->frame_num;
        };
        bool long_marked = false;
        if (cur_idr) {
            if (first.long_term_reference) {
                cur->long_ref = true;
                cur->long_term_idx = 0;
                max_long_term_idx = 0;
                long_marked = true;
                feat(F_LONG_TERM);
            } else {
                max_long_term_idx = -1;
            }
        } else if (first.adaptive) {
            for (const Mmco& m : first.mmco) {
                feat(F_MMCO1 + m.op - 1);
                if (m.op == 1 || m.op == 3) {
                    int num = (cur->frame_num - (m.a + 1));
                    PicPtr found;
                    for (auto& r : refs)
                        if (r->short_ref && pic_num(r) == num) found = r;
                    if (!found) UNSUPPORTED("an MMCO naming short-term picture %d, which is not held", num);
                    if (m.op == 1) {
                        found->short_ref = false;
                    } else {
                        for (auto& r : refs)
                            if (r->long_ref && r->long_term_idx == m.b) r->long_ref = false;
                        if (m.b > max_long_term_idx) CORRUPT("long_term_frame_idx %d above the maximum", m.b);
                        found->short_ref = false;
                        found->long_ref = true;
                        found->long_term_idx = m.b;
                        feat(F_LONG_TERM);
                    }
                } else if (m.op == 2) {
                    bool hit = false;
                    for (auto& r : refs)
                        if (r->long_ref && r->long_term_idx == m.a) {
                            r->long_ref = false;
                            hit = true;
                        }
                    if (!hit) UNSUPPORTED("an MMCO naming long-term picture %d, which is not held", m.a);
                } else if (m.op == 4) {
                    max_long_term_idx = m.a - 1;
                    for (auto& r : refs)
                        if (r->long_ref && r->long_term_idx > max_long_term_idx) r->long_ref = false;
                } else if (m.op == 5) {
                    for (auto& r : refs) r->short_ref = r->long_ref = false;
                    max_long_term_idx = -1;
                    mmco_reset = true;
                    cur->mmco_reset = true;
                    for (int i = 0; i < 16; i++) last_pocs[i] = INT_MIN;
                    prev_mmco5_now = true;
                    cur->frame_num = 0;
                } else if (m.op == 6) {
                    for (auto& r : refs)
                        if (r->long_ref && r->long_term_idx == m.b) r->long_ref = false;
                    if (m.b > max_long_term_idx) CORRUPT("long_term_frame_idx %d above the maximum", m.b);
                    cur->long_ref = true;
                    cur->long_term_idx = m.b;
                    long_marked = true;
                    feat(F_LONG_TERM);
                }
                refs.erase(std::remove_if(refs.begin(), refs.end(),
                                          [](const PicPtr& r) { return !r->short_ref && !r->long_ref; }),
                           refs.end());
            }
        } else {
            int n_short = 0, n_long = 0;
            for (auto& r : refs) (r->short_ref ? n_short : n_long)++;
            if (n_short && n_short + n_long >= std::max(S->max_num_ref_frames, 1)) {
                PicPtr oldest;
                for (auto& r : refs)
                    if (r->short_ref && (!oldest || pic_num(r) < pic_num(oldest))) oldest = r;
                oldest->short_ref = false;
                feat(F_SLIDING_WINDOW);
            }
        }
        refs.erase(std::remove_if(refs.begin(), refs.end(),
                                  [](const PicPtr& r) { return !r->short_ref && !r->long_ref; }),
                   refs.end());
        if (!long_marked) cur->short_ref = true;
        refs.push_back(cur);
        if ((int)refs.size() > std::max(S->max_num_ref_frames, 1))
            UNSUPPORTED("more reference pictures (%d) than max_num_ref_frames", (int)refs.size());
        // ff_h264_execute_ref_pic_marking's guess: an I picture with no
        // long-term reference counts as a recovery point (an I slice refers
        // to no picture, so its reference counts pass)
        int n_long = 0;
        for (auto& r : refs) n_long += r->long_ref;
        if (!n_long && first.type == 2) {
            cur->recovered = true;
            if (!has_b_frames) frame_recovered |= 2;
        }
    }

    // ------------------------------------------------------------ reference list

    // h264_refs.c's add_sorted: the short-term references on one side of
    // ``limit`` by POC, nearest first (``dir`` 1: at or below it)
    static std::vector<PicPtr> add_sorted(const std::vector<PicPtr>& src, int limit, int dir) {
        std::vector<PicPtr> out;
        for (;;) {
            int best = dir ? INT_MIN : INT_MAX;
            PicPtr pick;
            for (auto& r : src) {
                int poc = r->poc;
                if (((poc > limit) ^ dir) && ((poc < best) ^ dir)) {
                    best = poc;
                    pick = r;
                }
            }
            if (!pick) return out;
            out.push_back(pick);
            limit = pick->poc - dir;
        }
    }

    // 8.2.4: both lists (list 1 for B), their modification and weights,
    // and what direct prediction and implicit weights take from them
    void build_lists(const SliceHeader& h) {
        const int max_frame_num = 1 << S->log2_max_frame_num;
        const bool b = h.type == 1;
        nref[0] = h.num_ref_idx;
        nref[1] = b ? h.num_ref_idx1 : 0;
        if (nref[0] > 1) feat(F_MULTI_REF);
        std::vector<PicPtr> shorts, longs;
        for (auto& r : refs) (r->short_ref ? shorts : longs).push_back(r);
        // FFmpeg's short_ref array holds the newest first
        std::reverse(shorts.begin(), shorts.end());
        auto wrap = [&](const PicPtr& r) {
            return r->frame_num > h.frame_num ? r->frame_num - max_frame_num : r->frame_num;
        };
        std::stable_sort(longs.begin(), longs.end(),
                         [](const PicPtr& a, const PicPtr& b) { return a->long_term_idx < b->long_term_idx; });
        std::vector<PicPtr> init[2];
        if (!b) {
            init[0] = shorts;
            std::stable_sort(init[0].begin(), init[0].end(),
                             [&](const PicPtr& a, const PicPtr& b) { return wrap(a) > wrap(b); });
            init[0].insert(init[0].end(), longs.begin(), longs.end());
        } else {
            for (int l = 0; l < 2; l++) {
                init[l] = add_sorted(shorts, cur->poc, 1 ^ l);
                auto more = add_sorted(shorts, cur->poc, l);
                init[l].insert(init[l].end(), more.begin(), more.end());
                init[l].insert(init[l].end(), longs.begin(), longs.end());
            }
            if (init[0].size() == init[1].size() && init[1].size() > 1 && init[0] == init[1]) {
                std::swap(init[1][0], init[1][1]);
                featb(FB_LIST1_SWAP);
            }
        }
        for (int L = 0; L < (b ? 2 : 1); L++) {
            const int n = nref[L];
            std::vector<PicPtr> l(n + 1);
            for (int i = 0; i < n && i < (int)init[L].size(); i++) l[i] = init[L][i];
            // 8.2.4.3
            int pred = h.frame_num, idx = 0;
            for (auto& m : L ? h.mods1 : h.mods) {
                if (idx >= n) CORRUPT("more reference list modifications than entries");
                PicPtr pic;
                if (m.first < 2) {
                    feat(F_LIST_MOD);
                    if (L) featb(FB_LIST1_MOD);
                    int d = m.second + 1;
                    if (d > max_frame_num) CORRUPT("abs_diff_pic_num_minus1 %d out of range", m.second);
                    int no_wrap = m.first == 0 ? pred - d : pred + d;
                    if (no_wrap < 0) no_wrap += max_frame_num;
                    if (no_wrap >= max_frame_num) no_wrap -= max_frame_num;
                    pred = no_wrap;
                    int num = no_wrap > h.frame_num ? no_wrap - max_frame_num : no_wrap;
                    for (auto& r : shorts)
                        if (wrap(r) == num) pic = r;
                    if (!pic) UNSUPPORTED("a list modification naming picture %d, which is not held (FFmpeg conceals it)", num);
                    for (int c = n; c > idx; c--) l[c] = l[c - 1];
                    l[idx++] = pic;
                    int k = idx;
                    for (int c = idx; c <= n; c++)
                        if (!(l[c] && l[c]->short_ref && wrap(l[c]) == num)) l[k++] = l[c];
                } else {
                    feat(F_LONG_TERM_LIST_MOD);
                    if (L) featb(FB_LIST1_MOD);
                    for (auto& r : longs)
                        if (r->long_term_idx == m.second) pic = r;
                    if (!pic) UNSUPPORTED("a list modification naming long-term picture %d, which is not held", m.second);
                    for (int c = n; c > idx; c--) l[c] = l[c - 1];
                    l[idx++] = pic;
                    int k = idx;
                    for (int c = idx; c <= n; c++)
                        if (!(l[c] && l[c]->long_ref && l[c]->long_term_idx == m.second)) l[k++] = l[c];
                }
            }
            for (int i = 0; i < n; i++) {
                if (!l[i]) UNSUPPORTED("reference index %d names no picture (FFmpeg substitutes another)", i);
                RefEntry& e = list[L][i];
                e = RefEntry();
                e.pic = l[i];
                if ((P->weighted_pred && !b) || (P->weighted_bipred_idc == 1 && b)) {
                    e.w[0] = h.lw[L][i];
                    e.o[0] = h.lo[L][i];
                    for (int j = 0; j < 2; j++) {
                        e.w[1 + j] = h.cw[L][i][j];
                        e.o[1 + j] = h.co[L][i][j];
                    }
                    if (h.lflag[L][i] || h.cflag[L][i]) feat(F_WEIGHTED);
                }
            }
        }
        wmode = (!b && P->weighted_pred) || (b && P->weighted_bipred_idc == 1) ? 1
                : b && P->weighted_bipred_idc == 2 ? 2 : 0;
        luma_log2 = h.luma_log2;
        chroma_log2 = h.chroma_log2;
        // ff_h264_direct_ref_list_init: the picture keeps its lists' frame
        // numbers, from its last slice, for the B pictures that find it
        // co-located
        for (int L = 0; L < (b ? 2 : 1); L++) {
            cur->ref_count[L] = nref[L];
            for (int i = 0; i < nref[L]; i++) cur->ref_fn[L][i] = list[L][i].pic->frame_num;
        }
        if (!b) return;
        for (int i = 0; i < nref[1]; i++)
            if (list[1][i].pic->long_ref) featb(FB_LONG_TERM_L1);
        direct_spatial = h.direct_spatial;
        featb(direct_spatial ? FB_SPATIAL : FB_TEMPORAL);
        const Picture& col = *list[1][0].pic;
        if (!direct_spatial) {
            // fill_colmap: each of the co-located's entries → the first of
            // list 0 with its frame_num
            for (int L = 0; L < 2; L++)
                for (int k = 0; k < 32; k++) {
                    map_col[L][k] = -1;
                    if (k >= col.ref_count[L]) continue;
                    for (int j = 0; j < nref[0]; j++)
                        if (list[0][j].pic->frame_num == col.ref_fn[L][k]) {
                            map_col[L][k] = j;
                            break;
                        }
                }
            // get_scale_factor
            for (int i = 0; i < nref[0]; i++) {
                const Picture& r = *list[0][i].pic;
                int td = clip3(-128, 127, col.poc - r.poc);
                if (!td || r.long_ref) {
                    dsf[i] = 256;
                } else {
                    int tb = clip3(-128, 127, cur->poc - r.poc);
                    int tx = (16384 + (std::abs(td) >> 1)) / td;
                    dsf[i] = clip3(-1024, 1023, (tb * tx + 32) >> 6);
                }
            }
        }
        if (wmode == 2) {
            // implicit_weight_table: both lists of one picture each, as far
            // before as after: default averaging
            if (nref[0] == 1 && nref[1] == 1 &&
                (int64_t)list[0][0].pic->poc + list[1][0].pic->poc == 2LL * cur->poc) {
                wmode = 0;
                return;
            }
            luma_log2 = chroma_log2 = 5;
            for (int i0 = 0; i0 < nref[0]; i0++)
                for (int i1 = 0; i1 < nref[1]; i1++) {
                    int w = 32;
                    implicit_fb[i0][i1] = true;
                    const Picture &r0 = *list[0][i0].pic, &r1 = *list[1][i1].pic;
                    if (!r0.long_ref && !r1.long_ref) {
                        int td = clip3(-128, 127, r1.poc - r0.poc);
                        if (td) {
                            int tb = clip3(-128, 127, cur->poc - r0.poc);
                            int tx = (16384 + (std::abs(td) >> 1)) / td;
                            int d = (tb * tx + 32) >> 8;
                            if (d >= -64 && d <= 128) {
                                w = 64 - d;
                                implicit_fb[i0][i1] = false;
                            }
                        }
                    }
                    implicit_w[i0][i1] = w;
                }
        }
    }

    // ------------------------------------------------------------ slice data

    bool avail(int addr) const { return addr >= 0 && mbs[addr].slice == slice_idx; }
    int addr_a() const { return mb_x > 0 ? mb_addr - 1 : -1; }
    int addr_b() const { return mb_y > 0 ? mb_addr - mb_w : -1; }
    int addr_c() const { return (mb_y > 0 && mb_x < mb_w - 1) ? mb_addr - mb_w + 1 : -1; }
    int addr_d() const { return (mb_y > 0 && mb_x > 0) ? mb_addr - mb_w - 1 : -1; }
    bool intra_avail(int addr) const {
        return avail(addr) && !(P->constrained_intra && !mbs[addr].intra());
    }

    // the macroblock holding luma sample (x, y) relative to the current one
    // (-2: the current one, -1: none available) and its 4x4 block (raster)
    int locate(int x, int y, int& blk) const {
        int addr;
        if (y < 0) addr = x < 0 ? addr_d() : x < 16 ? addr_b() : addr_c();
        else if (x < 0) addr = addr_a();
        else if (x < 16) addr = -2;
        else return -1;
        if (addr == -1 || (addr >= 0 && !avail(addr))) return -1;
        blk = (((y + 16) & 15) >> 2) * 4 + (((x + 16) & 15) >> 2);
        return addr;
    }
    MbInfo& info(int addr) { return addr == -2 ? mbs[mb_addr] : mbs[addr]; }

    void decode_slice(const SliceHeader& h) {
        const Pps& p = *P;
        slice_idx = (int)slices.size();
        SliceParams sp;
        sp.disable_deblock = h.disable_deblock;
        sp.alpha_off = h.alpha;
        sp.beta_off = h.beta;
        sp.chroma_qp_offset[0] = p.chroma_qp_offset[0];
        sp.chroma_qp_offset[1] = p.chroma_qp_offset[1];
        slices.push_back(sp);
        if (h.disable_deblock == 1) feat(F_DEBLOCK_OFF);
        if (h.disable_deblock == 2) feat(F_DEBLOCK_SLICE_EDGES);
        if (h.alpha || h.beta) feat(F_DEBLOCK_OFFSETS);
        slice_type = h.type;
        is_cabac = p.cabac;
        qp = p.init_qp + h.qp_delta;
        last_qp_delta = 0;
        cqp_off[0] = p.chroma_qp_offset[0];
        cqp_off[1] = p.chroma_qp_offset[1];
        dequant_tables();
        slices.back().b = h.type == 1;
        if (h.type != 2) build_lists(h);
        else nref[0] = nref[1] = 0;
        const int total = mb_w * mb_h;
        mb_addr = h.first_mb;
        if (is_cabac) {
            while (!br.byte_aligned())
                if (!br.get1()) CORRUPT("cabac_alignment_one_bit 0");
            cab.br = &br;
            cab.overread = 0;
            cab.init_contexts(h.type == 2 ? 0 : h.cabac_init_idc + 1, qp);
            cab.start();
            for (;;) {
                if (mb_addr >= total) CORRUPT("slice runs past the last macroblock");
                start_mb();
                if (h.type != 2 && cabac_skip_flag()) decode_skip();
                else macroblock();
                mb_addr++;
                if (cab.terminate()) break;
            }
            return;
        }
        const int64_t stop = br.stop_bit();
        for (;;) {
            if (h.type != 2) {
                uint32_t run = br.ue_max((uint32_t)total, "mb_skip_run");
                for (uint32_t k = 0; k < run; k++) {
                    if (mb_addr >= total) CORRUPT("mb_skip_run runs past the last macroblock");
                    start_mb();
                    decode_skip();
                    mb_addr++;
                }
                if (run && br.pos >= stop) break;
            }
            if (mb_addr >= total) CORRUPT("slice runs past the last macroblock");
            start_mb();
            macroblock();
            mb_addr++;
            if (br.pos >= stop) break;
        }
        if (br.pos > stop) CORRUPT("slice data runs past its stop bit");
    }

    void start_mb() {
        mb_x = mb_addr % mb_w;
        mb_y = mb_addr / mb_w;
        MbInfo& m = mbs[mb_addr];
        if (m.slice >= 0) CORRUPT("macroblock %d decoded twice", mb_addr);
        m = MbInfo();
        m.slice = slice_idx;
        std::memset(m.ipred, -1, sizeof m.ipred);
        std::memset(m.nnz, 0, sizeof m.nnz);
        std::memset(m.nnzc, 0, sizeof m.nnzc);
        std::memset(m.nzd, 0, sizeof m.nzd);
        std::memset(m.ref, -1, sizeof m.ref);
        for (int l = 0; l < 2; l++)
            for (int i = 0; i < 4; i++) m.ref_id[l][i] = -1;
        std::memset(m.mv, 0, sizeof m.mv);
        std::memset(m.mvd, 0, sizeof m.mvd);
        std::memset(assigned, 0, sizeof assigned);
        mbs_done++;
    }

    // ------------------------------------------------------------ motion vectors

    struct Nb {
        bool avail;
        int ref;
        int mv[2];
    };
    // list l's reference and vector at luma (x, y) relative to the
    // macroblock: unavailable (a block of the current macroblock not yet
    // reached in list l's order counts so), or ref -1 for intra or a block
    // that predicts not from list l
    Nb neighbour(int l, int x, int y) {
        Nb n{false, -1, {0, 0}};
        int blk = 0;
        int a = locate(x, y, blk);
        if (a == -1) return n;
        if (a == -2 && !assigned[l][blk]) return n;
        const MbInfo& m = info(a);
        n.avail = true;
        if (m.intra()) return n;
        n.ref = m.ref[l][(blk >> 3) * 2 + ((blk & 3) >> 1)];
        n.mv[0] = m.mv[l][blk][0];
        n.mv[1] = m.mv[l][blk][1];
        return n;
    }
    static int median(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

    // 8.4.1.3; shape 0 plain, 1/2 the upper/lower 16x8, 3/4 the left/right 8x16
    void mv_pred(int l, int x, int y, int w, int ref, int shape, int out[2]) {
        Nb A = neighbour(l, x - 1, y), B = neighbour(l, x, y - 1), C = neighbour(l, x + w, y - 1);
        if (!C.avail) C = neighbour(l, x - 1, y - 1);
        const Nb* pick = nullptr;
        if (shape == 1 && B.ref == ref) pick = &B;
        else if (shape == 2 && A.ref == ref) pick = &A;
        else if (shape == 3 && A.ref == ref) pick = &A;
        else if (shape == 4 && C.ref == ref) pick = &C;
        if (!pick && !B.avail && !C.avail && A.avail) pick = &A;
        if (!pick) {
            int match = (A.ref == ref) + (B.ref == ref) + (C.ref == ref);
            if (match == 1) pick = A.ref == ref ? &A : B.ref == ref ? &B : &C;
        }
        if (pick) {
            out[0] = pick->mv[0];
            out[1] = pick->mv[1];
        } else {
            out[0] = median(A.mv[0], B.mv[0], C.mv[0]);
            out[1] = median(A.mv[1], B.mv[1], C.mv[1]);
        }
    }

    void assign(int l, int x, int y, int w, int h, const int mv[2], int mvdx, int mvdy) {
        MbInfo& m = mbs[mb_addr];
        if (mv[0] < -32768 || mv[0] > 32767 || mv[1] < -32768 || mv[1] > 32767)
            CORRUPT("motion vector out of range");
        for (int j = y / 4; j < (y + h) / 4; j++)
            for (int i = x / 4; i < (x + w) / 4; i++) {
                int b = j * 4 + i;
                m.mv[l][b][0] = int16_t(mv[0]);
                m.mv[l][b][1] = int16_t(mv[1]);
                m.mvd[l][b][0] = uint8_t(std::min(std::abs(mvdx), 70));
                m.mvd[l][b][1] = uint8_t(std::min(std::abs(mvdy), 70));
                assigned[l][b] = true;
            }
    }

    void decode_skip() {
        MbInfo& m = mbs[mb_addr];
        m.kind = MB_SKIP;
        m.qp = qp;
        m.direct8 = 15;
        last_qp_delta = 0;
        if (slice_type == 1) {
            featb(FB_SKIP);
            m.direct16 = true;
            direct(15);
            predict_mb();
            return;
        }
        feat(F_PSKIP);
        if (nref[0] < 1) CORRUPT("P_Skip with no reference picture");
        for (int i = 0; i < 4; i++) set_ref(0, i, 0);
        int mv[2] = {0, 0};
        int ba = 0, bb = 0;
        int a = locate(-1, 0, ba), b = locate(0, -1, bb);
        bool zero = a == -1 || b == -1;
        if (!zero) {
            const MbInfo& ma = mbs[a];
            const MbInfo& mb = mbs[b];
            if (!ma.intra() && ma.ref[0][(ba >> 3) * 2 + ((ba & 3) >> 1)] == 0 && !ma.mv[0][ba][0] &&
                !ma.mv[0][ba][1])
                zero = true;
            if (!mb.intra() && mb.ref[0][(bb >> 3) * 2 + ((bb & 3) >> 1)] == 0 && !mb.mv[0][bb][0] &&
                !mb.mv[0][bb][1])
                zero = true;
        }
        if (!zero) mv_pred(0, 0, 0, 16, 0, 0, mv);
        assign(0, 0, 0, 16, 16, mv, 0, 0);
        predict_mb();
    }

    // ------------------------------------------------------------ direct prediction (8.4.1.2)

    // the derived references and vectors, applied to the macroblock where
    // each 8x8 block's turn comes (direct_ref/direct_mv, per list)
    int8_t direct_ref[2][4];
    int16_t direct_mv[2][16][2];

    // h264_direct.c: the 8x8 blocks of ``mask`` predicted directly, spatial
    // or temporal, into direct_ref/direct_mv; B_Skip and B_Direct_16x16
    // (mask 15) are applied at once
    void direct(int mask) {
        const Picture& col = *list[1][0].pic;
        if ((int)col.col_intra.size() != mb_w * mb_h) UNSUPPORTED("a co-located picture of another size");
        const bool col_intra = col.col_intra[mb_addr];
        if (col_intra) featb(FB_COL_INTRA);
        const int8_t* cref[2] = {&col.col_ref[0][mb_addr * 4], &col.col_ref[1][mb_addr * 4]};
        const int16_t* cmv[2] = {&col.col_mv[0][mb_addr * 32], &col.col_mv[1][mb_addr * 32]};
        const bool inference = S->direct_8x8;
        featb(inference ? FB_INFERENCE : FB_DIRECT_4X4);
        static const int kCorner[4] = {0, 3, 12, 15};
        auto col_blk = [&](int b8, int blk) { return inference ? kCorner[b8] : blk; };
        if (direct_spatial) {
            int ref[2], mv[2][2];
            for (int l = 0; l < 2; l++) {
                Nb A = neighbour(l, -1, 0), B = neighbour(l, 0, -1), C = neighbour(l, 16, -1);
                if (!C.avail) C = neighbour(l, -1, -1);
                unsigned r = std::min(std::min((unsigned)A.ref, (unsigned)B.ref), (unsigned)C.ref);
                ref[l] = r > 31 ? -1 : (int)r;
                mv[l][0] = mv[l][1] = 0;
                if (ref[l] < 0) continue;
                int match = (A.ref == ref[l]) + (B.ref == ref[l]) + (C.ref == ref[l]);
                const Nb& one = A.ref == ref[l] ? A : B.ref == ref[l] ? B : C;
                mv[l][0] = match > 1 ? median(A.mv[0], B.mv[0], C.mv[0]) : one.mv[0];
                mv[l][1] = match > 1 ? median(A.mv[1], B.mv[1], C.mv[1]) : one.mv[1];
            }
            const bool none = ref[0] < 0 && ref[1] < 0;
            if (none) ref[0] = ref[1] = 0;
            // colZeroFlag: list 1's first picture short-term, its block's
            // reference 0 and vector within one quarter sample
            const bool col_ok = !col_intra && !list[1][0].pic->long_ref;
            for (int b8 = 0; b8 < 4; b8++) {
                if (!(mask >> b8 & 1)) continue;
                int cl = cref[0][b8] == 0 ? 0 : (cref[0][b8] < 0 && cref[1][b8] == 0) ? 1 : -1;
                for (int l = 0; l < 2; l++) direct_ref[l][b8] = int8_t(ref[l]);
                for (int k = 0; k < 4; k++) {
                    int blk = ((b8 >> 1) * 2 + (k >> 1)) * 4 + (b8 & 1) * 2 + (k & 1);
                    bool zero = false;
                    if (!none && col_ok && cl >= 0) {
                        const int16_t* v = &cmv[cl][col_blk(b8, blk) * 2];
                        zero = std::abs(v[0]) <= 1 && std::abs(v[1]) <= 1;
                        if (cl) featb(FB_COL_L1);
                    }
                    for (int l = 0; l < 2; l++) {
                        bool z = zero && ref[l] == 0;
                        if (z) featb(FB_COL_ZERO);
                        direct_mv[l][blk][0] = int16_t(z ? 0 : mv[l][0]);
                        direct_mv[l][blk][1] = int16_t(z ? 0 : mv[l][1]);
                    }
                }
            }
        } else {
            for (int b8 = 0; b8 < 4; b8++) {
                if (!(mask >> b8 & 1)) continue;
                direct_ref[1][b8] = 0;
                if (col_intra) {
                    direct_ref[0][b8] = 0;
                    for (int k = 0; k < 4; k++) {
                        int blk = ((b8 >> 1) * 2 + (k >> 1)) * 4 + (b8 & 1) * 2 + (k & 1);
                        for (int l = 0; l < 2; l++) direct_mv[l][blk][0] = direct_mv[l][blk][1] = 0;
                    }
                    continue;
                }
                int cl = cref[0][b8] >= 0 ? 0 : 1;
                if (cl) featb(FB_COL_L1);
                int rc = cref[cl][b8];
                if (rc < 0 || rc >= col.ref_count[cl]) CORRUPT("a co-located block with no reference");
                // fill_colmap leaves a picture list 0 does not hold at entry 0
                int r0 = map_col[cl][rc];
                if (r0 < 0) {
                    featb(FB_COL_UNMAPPED);
                    r0 = 0;
                }
                direct_ref[0][b8] = int8_t(r0);
                for (int k = 0; k < 4; k++) {
                    int blk = ((b8 >> 1) * 2 + (k >> 1)) * 4 + (b8 & 1) * 2 + (k & 1);
                    const int16_t* v = &cmv[cl][col_blk(b8, blk) * 2];
                    int mx = (dsf[r0] * v[0] + 128) >> 8, my = (dsf[r0] * v[1] + 128) >> 8;
                    direct_mv[0][blk][0] = int16_t(mx);
                    direct_mv[0][blk][1] = int16_t(my);
                    direct_mv[1][blk][0] = int16_t(mx - v[0]);
                    direct_mv[1][blk][1] = int16_t(my - v[1]);
                }
            }
        }
        if (mask == 15)
            for (int l = 0; l < 2; l++)
                for (int b8 = 0; b8 < 4; b8++) apply_direct(l, b8);
    }

    // list l of direct 8x8 block b8 into the macroblock
    void apply_direct(int l, int b8) {
        set_ref(l, b8, direct_ref[l][b8]);
        int x0 = (b8 & 1) * 2, y0 = (b8 >> 1) * 2;
        for (int j = y0; j < y0 + 2; j++)
            for (int i = x0; i < x0 + 2; i++) {
                int v[2] = {direct_mv[l][j * 4 + i][0], direct_mv[l][j * 4 + i][1]};
                assign(l, 4 * i, 4 * j, 4, 4, v, 0, 0);
            }
    }

    // ------------------------------------------------------------ CABAC syntax elements

    bool cabac_skip_flag() {
        int ctx = slice_type == 1 ? 24 : 11;
        if (avail(addr_a()) && mbs[addr_a()].kind != MB_SKIP) ctx++;
        if (avail(addr_b()) && mbs[addr_b()].kind != MB_SKIP) ctx++;
        return cab.decision(ctx);
    }

    // decode_cabac_intra_mb_type: 0 I_NxN, 1-24 I_16x16, 25 I_PCM
    int cabac_intra_type(int base, bool intra_slice) {
        int st = base;
        if (intra_slice) {
            int ctx = 0;
            int a = addr_a(), b = addr_b();
            if (avail(a) && (mbs[a].kind == MB_I16 || mbs[a].kind == MB_PCM)) ctx++;
            if (avail(b) && (mbs[b].kind == MB_I16 || mbs[b].kind == MB_PCM)) ctx++;
            if (!cab.decision(st + ctx)) return 0;
            st += 2;
        } else {
            if (!cab.decision(st)) return 0;
        }
        if (cab.terminate()) return 25;
        int t = 1;
        t += 12 * cab.decision(st + 1);
        if (cab.decision(st + 2)) t += 4 + 4 * cab.decision(st + 2 + intra_slice);
        t += 2 * cab.decision(st + 3 + intra_slice);
        t += cab.decision(st + 3 + 2 * intra_slice);
        return t;
    }

    int cabac_ipred(int pred) {
        if (cab.decision(68)) return pred;
        int m = cab.decision(69);
        m += 2 * cab.decision(69);
        m += 4 * cab.decision(69);
        return m + (m >= pred);
    }

    int cabac_chroma_mode() {
        int ctx = 0, a = addr_a(), b = addr_b();
        if (avail(a) && mbs[a].intra() && mbs[a].kind != MB_PCM && mbs[a].chroma_mode) ctx++;
        if (avail(b) && mbs[b].intra() && mbs[b].kind != MB_PCM && mbs[b].chroma_mode) ctx++;
        if (!cab.decision(64 + ctx)) return 0;
        if (!cab.decision(67)) return 1;
        return cab.decision(67) ? 3 : 2;
    }

    // the neighbours' coded_block_pattern bits as FFmpeg's left_cbp/top_cbp
    // hold them: all set where unavailable (luma), PCM all coded
    int nb_cbp(int addr) const {
        if (!avail(addr)) return 0x0f;
        const MbInfo& m = mbs[addr];
        if (m.kind == MB_PCM) return 0x2f;
        return m.cbp;
    }
    int cabac_cbp() {
        int ca = nb_cbp(addr_a()), cb = nb_cbp(addr_b());
        int cbp = 0;
        int ctx = !(ca & 2) + 2 * !(cb & 4);
        cbp |= cab.decision(73 + ctx);
        ctx = !(cbp & 1) + 2 * !(cb & 8);
        cbp |= cab.decision(73 + ctx) << 1;
        ctx = !(ca & 8) + 2 * !(cbp & 1);
        cbp |= cab.decision(73 + ctx) << 2;
        ctx = !(cbp & 4) + 2 * !(cbp & 2);
        cbp |= cab.decision(73 + ctx) << 3;
        // chroma: unavailable or skip neighbours count as none, PCM as 2
        int a = addr_a(), b = addr_b();
        int cha = avail(a) ? (mbs[a].kind == MB_PCM ? 2 : mbs[a].cbp >> 4) : 0;
        int chb = avail(b) ? (mbs[b].kind == MB_PCM ? 2 : mbs[b].cbp >> 4) : 0;
        ctx = (cha > 0) + 2 * (chb > 0);
        if (cab.decision(77 + ctx)) {
            ctx = 4 + (cha == 2) + 2 * (chb == 2);
            cbp |= (1 + cab.decision(77 + ctx)) << 4;
        }
        return cbp;
    }

    int cabac_qp_delta() {
        if (!cab.decision(60 + (last_qp_delta != 0))) return 0;
        int v = 1, ctx = 62;
        while (cab.decision(ctx)) {
            ctx = 63;
            if (++v > 2 * 52) CORRUPT("mb_qp_delta too long");
        }
        return (v & 1) ? (v + 1) >> 1 : -((v + 1) >> 1);
    }

    // ref_idx_lX: refIdxZeroFlag counts a neighbour predicted directly (or
    // skipped) as reference 0
    int cabac_ref(int l, int x, int y) {
        int ctx = 0, blk = 0;
        for (int k = 0; k < 2; k++) {
            int a = k ? locate(x, y - 1, blk) : locate(x - 1, y, blk);
            if (a == -1) continue;
            const MbInfo& m = info(a);
            int b8 = (blk >> 3) * 2 + ((blk & 3) >> 1);
            if (!m.intra() && !(m.direct8 >> b8 & 1) && m.ref[l][b8] > 0) ctx += 1 << k;
        }
        int ref = 0;
        while (cab.decision(54 + ctx)) {
            ref++;
            ctx = (ctx >> 2) + 4;
            if (ref >= 32) CORRUPT("ref_idx too long");
        }
        return ref;
    }

    int cabac_mvd(int l, int x, int y, int comp) {
        int amvd = 0, blk = 0;
        int a = locate(x - 1, y, blk);
        if (a != -1) amvd += info(a).mvd[l][blk][comp];
        int b = locate(x, y - 1, blk);
        if (b != -1) amvd += info(b).mvd[l][blk][comp];
        int base = comp ? 47 : 40;
        int inc = amvd < 3 ? 0 : amvd <= 32 ? 1 : 2;
        if (!cab.decision(base + inc)) return 0;
        int mvd = 1, ctx = base + 3;
        while (mvd < 9 && cab.decision(ctx)) {
            if (mvd < 4) ctx++;
            mvd++;
        }
        if (mvd >= 9) {
            int k = 3;
            while (cab.bypass()) {
                mvd += 1 << k;
                if (++k > 24) CORRUPT("mvd too long");
            }
            while (k--) mvd += cab.bypass() << k;
        }
        return cab.bypass() ? -mvd : mvd;
    }

    // decode_cabac_mb_type_b: 0-22, or 23 + the intra type
    int cabac_b_type() {
        int ctx = 0, a = addr_a(), b = addr_b();
        if (avail(a) && !mbs[a].direct16) ctx++;
        if (avail(b) && !mbs[b].direct16) ctx++;
        if (!cab.decision(27 + ctx)) return 0;
        if (!cab.decision(27 + 3)) return 1 + cab.decision(27 + 5);
        int bits = cab.decision(27 + 4) << 3;
        bits |= cab.decision(27 + 5) << 2;
        bits |= cab.decision(27 + 5) << 1;
        bits |= cab.decision(27 + 5);
        if (bits < 8) return bits + 3;
        if (bits == 13) return 23 + cabac_intra_type(32, false);
        if (bits == 14) return 11;
        if (bits == 15) return 22;
        bits = (bits << 1) | cab.decision(27 + 5);
        return bits - 4;
    }

    int cabac_b_sub_type() {
        if (!cab.decision(36)) return 0;
        if (!cab.decision(37)) return 1 + cab.decision(39);
        int t = 3;
        if (cab.decision(38)) {
            if (cab.decision(39)) return 11 + cab.decision(39);
            t += 4;
        }
        t += 2 * cab.decision(39);
        t += cab.decision(39);
        return t;
    }

    // coded_block_flag's condTermFlagN for a luma 4x4 block (raster x4, y4)
    // and its neighbour in direction (dx, dy)
    int cbf_luma(int x4, int y4, int dx, int dy, bool intra_cur) {
        int blk = 0;
        int a = locate(4 * x4 + dx, 4 * y4 + dy, blk);
        if (a == -1) return intra_cur;
        const MbInfo& m = info(a);
        if (m.kind == MB_PCM) return 1;
        if (m.kind == MB_SKIP) return 0;
        return m.nnz[blk] != 0;
    }
    int cbf_chroma(int c, int x2, int y2, int dx, int dy, bool intra_cur) {
        int nx = x2 + dx, ny = y2 + dy;
        if (nx >= 0 && ny >= 0) return mbs[mb_addr].nnzc[c][ny * 2 + nx] != 0;
        int a = dx ? addr_a() : addr_b();
        if (!avail(a)) return intra_cur;
        const MbInfo& m = mbs[a];
        if (m.kind == MB_PCM) return 1;
        if (m.kind == MB_SKIP) return 0;
        return m.nnzc[c][((ny + 2) & 1) * 2 + ((nx + 2) & 1)] != 0;
    }
    int cbf_dc(int bit, bool intra_cur) {
        int ctx = 0;
        int ab[2] = {addr_a(), addr_b()};
        for (int k = 0; k < 2; k++) {
            int c;
            if (!avail(ab[k])) c = intra_cur;
            else if (mbs[ab[k]].kind == MB_PCM) c = 1;
            else c = mbs[ab[k]].cbf_dc >> bit & 1;
            ctx += c << k;
        }
        return ctx;
    }

    // residual_block_cabac: levels into out[] at the block's list indices;
    // returns the number coded
    int cabac_block(int16_t* out, int cat, int max, int cbf_ctx) {
        if (cbf_ctx >= 0 && !cab.decision(cbf_ctx)) return 0;
        static const int kSig[5] = {0, 15, 29, 44, 47}, kAbs[5] = {0, 10, 20, 30, 39};
        int sig_base, last_base, abs_base;
        if (cat == 5) {
            sig_base = 402;
            last_base = 417;
            abs_base = 426;
        } else {
            sig_base = 105 + kSig[cat];
            last_base = 166 + kSig[cat];
            abs_base = 227 + kAbs[cat];
        }
        int pos[64], n = 0;
        int i = 0;
        for (; i < max - 1; i++) {
            int sc = cat == 5 ? sig_base + kSigCoeffFlagOffset8x8[i] : sig_base + (cat == 3 ? std::min(i, 2) : i);
            if (cab.decision(sc)) {
                pos[n++] = i;
                int lc = cat == 5 ? last_base + kLastCoeffFlagOffset8x8[i] : last_base + (cat == 3 ? std::min(i, 2) : i);
                if (cab.decision(lc)) break;
            }
        }
        if (i == max - 1) pos[n++] = max - 1;
        int gt1 = 0, eq1 = 0;
        for (int k = n - 1; k >= 0; k--) {
            int absm1 = 0;
            if (cab.decision(abs_base + (gt1 ? 0 : std::min(4, 1 + eq1)))) {
                int c2 = abs_base + 5 + std::min(4 - (cat == 3), gt1);
                absm1 = 1;
                while (absm1 < 14 && cab.decision(c2)) absm1++;
                if (absm1 >= 14) {
                    int j = 0;
                    while (cab.bypass()) {
                        if (++j > 22) CORRUPT("coeff_abs_level_minus1 too long");
                    }
                    int v = 1;
                    while (j--) v = 2 * v + cab.bypass();
                    absm1 = 14 + v - 1;
                    feat(F_LEVEL_ESCAPE);
                }
            }
            if (absm1) gt1++;
            else eq1++;
            int level = absm1 + 1;
            out[pos[k]] = int16_t(cab.bypass() ? -level : level);
        }
        return n;
    }

    // ------------------------------------------------------------ CAVLC residual

    int nc_luma(int x4, int y4) {
        int ba = 0, bb = 0;
        int a = locate(4 * x4 - 1, 4 * y4, ba), b = locate(4 * x4, 4 * y4 - 1, bb);
        int na = a != -1 ? (info(a).kind == MB_PCM ? 16 : info(a).nnz[ba]) : 0;
        int nb = b != -1 ? (info(b).kind == MB_PCM ? 16 : info(b).nnz[bb]) : 0;
        if (a != -1 && b != -1) return (na + nb + 1) >> 1;
        return a != -1 ? na : b != -1 ? nb : 0;
    }
    int nc_chroma(int c, int x2, int y2) {
        int na = 0, nb = 0;
        bool ha, hb;
        if (x2 > 0) {
            ha = true;
            na = mbs[mb_addr].nnzc[c][y2 * 2 + x2 - 1];
        } else {
            ha = avail(addr_a());
            if (ha) na = mbs[addr_a()].kind == MB_PCM ? 16 : mbs[addr_a()].nnzc[c][y2 * 2 + 1];
        }
        if (y2 > 0) {
            hb = true;
            nb = mbs[mb_addr].nnzc[c][x2];
        } else {
            hb = avail(addr_b());
            if (hb) nb = mbs[addr_b()].kind == MB_PCM ? 16 : mbs[addr_b()].nnzc[c][2 + x2];
        }
        if (ha && hb) return (na + nb + 1) >> 1;
        return ha ? na : hb ? nb : 0;
    }

    int cavlc_block(int16_t* out, int max, int nc) {
        int tab = nc < 0 ? 4 : nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
        uint16_t e = coeff_token_lut().t[tab][br.show(16)];
        if (!e) CORRUPT("invalid coeff_token");
        br.pos += e & 31;
        br.check();
        int tc = e >> 7, t1 = (e >> 5) & 3;
        if (!tc) return 0;
        if (tc > max) CORRUPT("total_coeff %d in a block of %d", tc, max);
        int level[16];
        int suffix = (tc > 10 && t1 < 3) ? 1 : 0;
        for (int i = 0; i < tc; i++) {
            if (i < t1) {
                level[i] = br.get1() ? -1 : 1;
                continue;
            }
            int prefix = 0;
            while (!br.get1()) {
                if (++prefix > 28) CORRUPT("level_prefix too long");
            }
            int code = std::min(15, prefix) << suffix;
            int size = (prefix == 14 && !suffix) ? 4 : prefix >= 15 ? prefix - 3 : suffix;
            if (size) code += (int)br.get(size);
            if (prefix >= 15 && !suffix) code += 15;
            if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
            if (prefix >= 15) feat(F_LEVEL_ESCAPE);
            if (i == t1 && t1 < 3) code += 2;
            level[i] = (code & 1) ? (-code - 1) >> 1 : (code + 2) >> 1;
            if (!suffix) suffix = 1;
            if (std::abs(level[i]) > (3 << (suffix - 1)) && suffix < 6) suffix++;
        }
        int zeros = 0;
        if (tc < max) {
            if (nc < 0)
                zeros = read_short_vlc(br, kChromaDcTotalZerosLen[tc - 1], kChromaDcTotalZerosBits[tc - 1], 4,
                                       "total_zeros");
            else
                zeros = read_short_vlc(br, kTotalZerosLen[tc - 1], kTotalZerosBits[tc - 1], 16, "total_zeros");
            if (zeros > max - tc) CORRUPT("total_zeros %d with %d coefficients of %d", zeros, tc, max);
        }
        int coeff = -1;
        int runs[16];
        int left = zeros;
        for (int i = 0; i < tc - 1; i++) {
            int r = 0;
            if (left > 0) {
                int t = std::min(left, 7) - 1;
                r = read_short_vlc(br, kRunLen[t], kRunBits[t], 16, "run_before");
                if (r > left) CORRUPT("run_before %d with %d zeros left", r, left);
            }
            runs[i] = r;
            left -= r;
        }
        runs[tc - 1] = left;
        for (int i = tc - 1; i >= 0; i--) {
            coeff += runs[i] + 1;
            out[coeff] = int16_t(level[i]);
        }
        return tc;
    }

    // ------------------------------------------------------------ macroblock layer

    // Intra4x4PredMode / Intra8x8PredMode prediction: Min(A, B), 2 where
    // either neighbour is missing (or inter under constrained intra)
    int pred_mode(int x, int y) {
        int ba = 0, bb = 0;
        int a = locate(x - 1, y, ba), b = locate(x, y - 1, bb);
        if (a == -1 || b == -1) return 2;
        int ma = info(a).ipred[ba], mb = info(b).ipred[bb];
        if (ma < 0 || mb < 0) {
            if (P->constrained_intra) return 2;
            if (ma < 0) ma = 2;
            if (mb < 0) mb = 2;
        }
        return std::min(ma, mb);
    }

    void macroblock() {
        MbInfo& m = mbs[mb_addr];
        MbData d;
        std::memset(d.lv4, 0, sizeof d.lv4);
        std::memset(d.lv8, 0, sizeof d.lv8);
        std::memset(d.dc, 0, sizeof d.dc);
        std::memset(d.cdc, 0, sizeof d.cdc);
        std::memset(d.cac, 0, sizeof d.cac);
        int type;   // 0-4 P types, 5 + intra type, -1 B inter (btype)
        int btype = -1;
        if (slice_type == 1) {
            btype = is_cabac ? cabac_b_type() : (int)br.ue_max(48, "mb_type");
            if (btype >= 23) featb(FB_B_INTRA);
            type = btype >= 23 ? 5 + btype - 23 : -1;
        } else if (is_cabac) {
            if (slice_type == 2) {
                type = 5 + cabac_intra_type(3, true);
            } else if (!cab.decision(14)) {
                if (!cab.decision(15)) type = cab.decision(16) ? 3 : 0;
                else type = cab.decision(17) ? 1 : 2;
            } else {
                type = 5 + cabac_intra_type(17, false);
            }
        } else {
            type = slice_type == 2 ? 5 + (int)br.ue_max(25, "mb_type") : (int)br.ue_max(30, "mb_type");
        }
        if (type == 30) {
            pcm(m);
            return;
        }
        bool intra = type >= 5;
        int cbp = 0;
        if (type == 5) {   // I_NxN
            d.kind = MB_I4;
            if (P->transform_8x8) d.t8 = is_cabac ? cab.decision(399 + t8_ctx()) : br.get1();
            if (d.t8) {
                d.kind = MB_I8;
                feat(F_I8X8);
                for (int b8 = 0; b8 < 4; b8++) {
                    int x = (b8 & 1) * 8, y = (b8 >> 1) * 8;
                    int pred = pred_mode(x, y), mode;
                    if (is_cabac) mode = cabac_ipred(pred);
                    else mode = br.get1() ? pred : [&] { int r = (int)br.get(3); return r < pred ? r : r + 1; }();
                    d.ipred[b8] = mode;
                    for (int j = 0; j < 2; j++)
                        for (int i = 0; i < 2; i++) m.ipred[(y / 4 + j) * 4 + x / 4 + i] = int8_t(mode);
                }
            } else {
                feat(F_I4X4);
                for (int b = 0; b < 16; b++) {
                    int x = kBlkX[b] * 4, y = kBlkY[b] * 4;
                    int pred = pred_mode(x, y), mode;
                    if (is_cabac) mode = cabac_ipred(pred);
                    else mode = br.get1() ? pred : [&] { int r = (int)br.get(3); return r < pred ? r : r + 1; }();
                    d.ipred[b] = mode;
                    m.ipred[raster(b)] = int8_t(mode);
                }
            }
            m.kind = uint8_t(d.kind);
            m.t8 = d.t8;
            d.chroma_mode = is_cabac ? cabac_chroma_mode() : (int)br.ue_max(3, "intra_chroma_pred_mode");
            m.chroma_mode = d.chroma_mode;
            cbp = is_cabac ? cabac_cbp() : kGolombToIntraCbp[br.ue_max(47, "coded_block_pattern")];
        } else if (intra) {   // I_16x16
            int t = type - 6;
            d.kind = MB_I16;
            feat(F_I16X16);
            d.i16_mode = t % 4;
            cbp = ((t / 4) % 3) << 4 | (t >= 12 ? 15 : 0);
            m.kind = MB_I16;
            std::memset(m.ipred, 2, sizeof m.ipred);
            d.chroma_mode = is_cabac ? cabac_chroma_mode() : (int)br.ue_max(3, "intra_chroma_pred_mode");
            m.chroma_mode = d.chroma_mode;
        } else {
            // transform_size_8x8_flag: no partition below 8x8, a direct one
            // counting so only under direct_8x8_inference_flag
            bool t8_ok = type >= 0 ? inter(d, type) : b_inter(d, btype);
            cbp = is_cabac ? cabac_cbp() : kGolombToInterCbp[br.ue_max(47, "coded_block_pattern")];
            if ((cbp & 15) && P->transform_8x8 && t8_ok) {
                d.t8 = is_cabac ? cab.decision(399 + t8_ctx()) : br.get1();
                m.t8 = d.t8;
            }
        }
        if (d.t8) feat(F_TRANSFORM_8X8);
        d.cbp = cbp;
        m.cbp = cbp;
        if (cbp || d.kind == MB_I16) {
            int dq = is_cabac ? cabac_qp_delta() : br.se_range(-26, 25, "mb_qp_delta");
            if (dq < -26 || dq > 25) CORRUPT("mb_qp_delta %d out of range", dq);
            if (dq) feat(F_QP_DELTA);
            last_qp_delta = dq;
            qp += dq;
            if (qp < 0 || qp > 51) {
                qp = (qp + 52) % 52;
                feat(F_QP_WRAP);
            }
            residual(d, m);
        } else {
            last_qp_delta = 0;
        }
        m.qp = qp;
        reconstruct(d, m);
    }

    int t8_ctx() {
        int a = addr_a(), b = addr_b();
        return (avail(a) && mbs[a].t8) + (avail(b) && mbs[b].t8);
    }

    void pcm(MbInfo& m) {
        feat(F_I_PCM);
        uint8_t s[384];
        if (is_cabac) {
            // the engine has read up to the stop bit of its flush; the samples
            // start at the next byte
            int64_t p = (br.pos + 7) & ~int64_t(7);
            if (p + 384 * 8 > br.size) CORRUPT("truncated I_PCM samples");
            std::memcpy(s, br.d + p / 8, 384);
            br.pos = p + 384 * 8;
            cab.start();
        } else {
            while (!br.byte_aligned()) br.get1();
            if (br.pos + 384 * 8 > br.size) CORRUPT("truncated I_PCM samples");
            std::memcpy(s, br.d + br.pos / 8, 384);
            br.pos += 384 * 8;
        }
        m.kind = MB_PCM;
        m.qp = 0;   // for the deblocking; the running QP carries on
        m.cbp = 0x2f;
        m.cbf_dc = 7;
        m.chroma_mode = 0;
        std::memset(m.ipred, 2, sizeof m.ipred);
        std::memset(m.nnz, 16, sizeof m.nnz);
        std::memset(m.nnzc, 16, sizeof m.nnzc);
        last_qp_delta = 0;
        for (int y = 0; y < 16; y++) std::memcpy(&cur->y[(mb_y * 16 + y) * width + mb_x * 16], s + 16 * y, 16);
        for (int c = 0; c < 2; c++)
            for (int y = 0; y < 8; y++)
                std::memcpy(&(c ? cur->v : cur->u)[(mb_y * 8 + y) * (width / 2) + mb_x * 8], s + 256 + 64 * c + 8 * y,
                            8);
    }

    int read_ref(int l, int x, int y) {
        if (nref[l] <= 1) return 0;
        if (is_cabac) return cabac_ref(l, x, y);
        if (nref[l] == 2) return !br.get1();
        return (int)br.ue_max((uint32_t)nref[l] - 1, "ref_idx");
    }

    // list l's reference of 8x8 block b8 (-1: not predicted from list l)
    void set_ref(int l, int b8, int ref) {
        if (ref >= nref[l]) CORRUPT("ref_idx %d of %d", ref, nref[l]);
        MbInfo& m = mbs[mb_addr];
        m.ref[l][b8] = int8_t(ref);
        m.ref_id[l][b8] = ref < 0 ? -1 : list[l][ref].pic->id;
    }

    void part_mv(int l, int x, int y, int w, int h, int ref, int shape) {
        int mvd[2];
        for (int c = 0; c < 2; c++) mvd[c] = is_cabac ? cabac_mvd(l, x, y, c) : br.se();
        int mv[2];
        mv_pred(l, x, y, w, ref, shape, mv);
        mv[0] += mvd[0];
        mv[1] += mvd[1];
        assign(l, x, y, w, h, mv, mvd[0], mvd[1]);
    }

    // a list a partition does not predict from: vector 0, reference -1
    void unused(int l, int x, int y, int w, int h) {
        static const int zero[2] = {0, 0};
        assign(l, x, y, w, h, zero, 0, 0);
    }

    // P_L0_16x16 ... P_8x8ref0; whether the 8x8 transform may follow
    bool inter(MbData& d, int type) {
        MbInfo& m = mbs[mb_addr];
        m.kind = MB_P;
        d.kind = MB_P;
        d.part = type;
        static const int kFeat[5] = {F_P16X16, F_P16X8, F_P8X16, F_P8X8, F_P8X8REF0};
        feat(kFeat[type]);
        if (nref[0] < 1) CORRUPT("a P macroblock with no reference picture");
        bool small = false;
        if (type == 0) {
            set_ref(0, 0, read_ref(0, 0, 0));
            for (int i = 1; i < 4; i++) set_ref(0, i, m.ref[0][0]);
            part_mv(0, 0, 0, 16, 16, m.ref[0][0], 0);
        } else if (type == 1) {
            set_ref(0, 0, read_ref(0, 0, 0));
            set_ref(0, 1, m.ref[0][0]);
            set_ref(0, 2, read_ref(0, 0, 8));
            set_ref(0, 3, m.ref[0][2]);
            part_mv(0, 0, 0, 16, 8, m.ref[0][0], 1);
            part_mv(0, 0, 8, 16, 8, m.ref[0][2], 2);
        } else if (type == 2) {
            set_ref(0, 0, read_ref(0, 0, 0));
            set_ref(0, 2, m.ref[0][0]);
            set_ref(0, 1, read_ref(0, 8, 0));
            set_ref(0, 3, m.ref[0][1]);
            part_mv(0, 0, 0, 8, 16, m.ref[0][0], 3);
            part_mv(0, 8, 0, 8, 16, m.ref[0][1], 4);
        } else {
            for (int i = 0; i < 4; i++) {
                d.sub[i] = is_cabac ? [&] {
                    if (cab.decision(21)) return 0;
                    if (!cab.decision(22)) return 1;
                    return cab.decision(23) ? 2 : 3;
                }()
                                    : (int)br.ue_max(3, "sub_mb_type");
                static const int kSubFeat[4] = {F_SUB8X8, F_SUB8X4, F_SUB4X8, F_SUB4X4};
                feat(kSubFeat[d.sub[i]]);
                small |= d.sub[i] != 0;
            }
            for (int i = 0; i < 4; i++) set_ref(0, i, type == 4 ? 0 : read_ref(0, (i & 1) * 8, (i >> 1) * 8));
            for (int i = 0; i < 4; i++) sub_mvs(0, i, d.sub[i], m.ref[0][i]);
        }
        predict_mb();
        return !small;
    }

    // the partitions of sub-macroblock i (shape 0 8x8, 1 8x4, 2 4x8, 3 4x4)
    void sub_mvs(int l, int i, int shape, int r) {
        int x0 = (i & 1) * 8, y0 = (i >> 1) * 8;
        switch (shape) {
        case 0: part_mv(l, x0, y0, 8, 8, r, 0); break;
        case 1:
            part_mv(l, x0, y0, 8, 4, r, 0);
            part_mv(l, x0, y0 + 4, 8, 4, r, 0);
            break;
        case 2:
            part_mv(l, x0, y0, 4, 8, r, 0);
            part_mv(l, x0 + 4, y0, 4, 8, r, 0);
            break;
        default:
            part_mv(l, x0, y0, 4, 4, r, 0);
            part_mv(l, x0 + 4, y0, 4, 4, r, 0);
            part_mv(l, x0, y0 + 4, 4, 4, r, 0);
            part_mv(l, x0 + 4, y0 + 4, 4, 4, r, 0);
            break;
        }
    }

    // B_Direct_16x16 ... B_8x8 (Table 7-14, 7-18); whether the 8x8
    // transform may follow
    bool b_inter(MbData& d, int type) {
        // each type's partition shape (0 16x16, 1 16x8, 2 8x16, 3 8x8) and
        // each partition's lists (1 L0, 2 L1, 3 both)
        static const uint8_t kShape[23] = {0, 0, 0, 0, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 3};
        static const uint8_t kPred[23][2] = {{0, 0}, {1, 0}, {2, 0}, {3, 0}, {1, 1}, {1, 1}, {2, 2}, {2, 2},
                                             {1, 2}, {1, 2}, {2, 1}, {2, 1}, {1, 3}, {1, 3}, {2, 3}, {2, 3},
                                             {3, 1}, {3, 1}, {3, 2}, {3, 2}, {3, 3}, {3, 3}, {0, 0}};
        // sub_mb_type: shape (-1 direct), lists
        static const int8_t kSub[13][2] = {{-1, 0}, {0, 1}, {0, 2}, {0, 3}, {1, 1}, {2, 1}, {1, 2},
                                           {2, 2},  {1, 3}, {2, 3}, {3, 1}, {3, 2}, {3, 3}};
        MbInfo& m = mbs[mb_addr];
        m.kind = MB_P;
        d.kind = MB_P;
        featb(FB_MB + type);
        if (nref[0] < 1 || nref[1] < 1) CORRUPT("a B macroblock with an empty list");
        if (type == 0) {
            m.direct16 = true;
            m.direct8 = 15;
            direct(15);
            predict_mb();
            return S->direct_8x8;
        }
        const int shape = kShape[type];
        if (shape == 0) {
            for (int l = 0; l < 2; l++) {
                int r = kPred[type][0] >> l & 1 ? read_ref(l, 0, 0) : -1;
                for (int i = 0; i < 4; i++) set_ref(l, i, r);
            }
            for (int l = 0; l < 2; l++) {
                if (kPred[type][0] >> l & 1) part_mv(l, 0, 0, 16, 16, m.ref[l][0], 0);
                else unused(l, 0, 0, 16, 16);
            }
        } else if (shape < 3) {
            // partition p: 16x8 rows or 8x16 columns
            for (int l = 0; l < 2; l++)
                for (int p = 0; p < 2; p++) {
                    int r = kPred[type][p] >> l & 1 ? read_ref(l, shape == 2 ? 8 * p : 0, shape == 1 ? 8 * p : 0) : -1;
                    if (shape == 1) {
                        set_ref(l, 2 * p, r);
                        set_ref(l, 2 * p + 1, r);
                    } else {
                        set_ref(l, p, r);
                        set_ref(l, p + 2, r);
                    }
                }
            for (int l = 0; l < 2; l++)
                for (int p = 0; p < 2; p++) {
                    int x = shape == 2 ? 8 * p : 0, y = shape == 1 ? 8 * p : 0;
                    int w = shape == 2 ? 8 : 16, h = shape == 1 ? 8 : 16;
                    if (kPred[type][p] >> l & 1) part_mv(l, x, y, w, h, m.ref[l][shape == 1 ? 2 * p : p], shape == 1 ? 1 + p : 3 + p);
                    else unused(l, x, y, w, h);
                }
        } else {
            int sub[4], dmask = 0;
            bool ok = true;
            for (int i = 0; i < 4; i++) {
                sub[i] = is_cabac ? cabac_b_sub_type() : (int)br.ue_max(12, "sub_mb_type");
                featb(FB_SUB + sub[i]);
                if (!sub[i]) dmask |= 1 << i;
                ok &= sub[i] ? kSub[sub[i]][0] == 0 : S->direct_8x8;
            }
            m.direct8 = uint8_t(dmask);
            if (dmask) direct(dmask);
            for (int l = 0; l < 2; l++)
                for (int i = 0; i < 4; i++) {
                    if (!sub[i]) continue;
                    set_ref(l, i, kSub[sub[i]][1] >> l & 1 ? read_ref(l, (i & 1) * 8, (i >> 1) * 8) : -1);
                }
            for (int l = 0; l < 2; l++)
                for (int i = 0; i < 4; i++) {
                    if (!sub[i]) apply_direct(l, i);
                    else if (kSub[sub[i]][1] >> l & 1) sub_mvs(l, i, kSub[sub[i]][0], m.ref[l][i]);
                    else unused(l, (i & 1) * 8, (i >> 1) * 8, 8, 8);
                }
            predict_mb();
            return ok;
        }
        predict_mb();
        return true;
    }

    void residual(MbData& d, MbInfo& m) {
        const bool intra = d.kind <= MB_PCM;
        const int cl = d.cbp & 15, cc = d.cbp >> 4;
        int16_t l[64];
        if (d.kind == MB_I16) {
            std::memset(l, 0, sizeof l);
            int n = is_cabac ? cabac_block(l, 0, 16, 85 + cbf_dc(0, true)) : cavlc_block(l, 16, nc_luma(0, 0));
            if (n) m.cbf_dc |= 1;
            for (int i = 0; i < 16; i++) d.dc[i] = l[i];
        }
        for (int b8 = 0; b8 < 4; b8++) {
            if (!(cl >> b8 & 1)) continue;
            if (d.t8 && is_cabac) {
                int n = cabac_block(d.lv8[b8], 5, 64, -1);
                int x4 = (b8 & 1) * 2, y4 = (b8 >> 1) * 2;
                for (int j = 0; j < 2; j++)
                    for (int i = 0; i < 2; i++) m.nnz[(y4 + j) * 4 + x4 + i] = uint8_t(n);
                continue;
            }
            for (int i4 = 0; i4 < 4; i4++) {
                int b = b8 * 4 + i4, x4 = kBlkX[b], y4 = kBlkY[b];
                std::memset(l, 0, 16 * sizeof(int16_t));
                int n;
                if (d.kind == MB_I16) {
                    n = is_cabac ? cabac_block(l, 1, 15,
                                               85 + 4 + cbf_luma(x4, y4, -1, 0, true) + 2 * cbf_luma(x4, y4, 0, -1, true))
                                 : cavlc_block(l, 15, nc_luma(x4, y4));
                    for (int i = 0; i < 15; i++) d.lv4[b][i + 1] = l[i];
                } else {
                    n = is_cabac ? cabac_block(l, 2, 16,
                                               85 + 8 + cbf_luma(x4, y4, -1, 0, intra) + 2 * cbf_luma(x4, y4, 0, -1, intra))
                                 : cavlc_block(l, 16, nc_luma(x4, y4));
                    if (d.t8)
                        for (int i = 0; i < 16; i++) d.lv8[b8][4 * i + i4] = l[i];
                    else
                        for (int i = 0; i < 16; i++) d.lv4[b][i] = l[i];
                }
                m.nnz[y4 * 4 + x4] = uint8_t(n);
            }
        }
        if (cc) {
            for (int c = 0; c < 2; c++) {
                std::memset(l, 0, 4 * sizeof(int16_t));
                int n = is_cabac ? cabac_block(l, 3, 4, 85 + 12 + cbf_dc(1 + c, intra)) : cavlc_block(l, 4, -1);
                if (n) m.cbf_dc |= 2 << c;
                for (int i = 0; i < 4; i++) d.cdc[c][i] = l[i];
            }
        }
        if (cc == 2) {
            for (int c = 0; c < 2; c++)
                for (int b = 0; b < 4; b++) {
                    int x2 = b & 1, y2 = b >> 1;
                    std::memset(l, 0, 16 * sizeof(int16_t));
                    int n = is_cabac ? cabac_block(l, 4, 15,
                                                   85 + 16 + cbf_chroma(c, x2, y2, -1, 0, intra) +
                                                       2 * cbf_chroma(c, x2, y2, 0, -1, intra))
                                     : cavlc_block(l, 15, nc_chroma(c, x2, y2));
                    for (int i = 0; i < 15; i++) d.cac[c][b][i + 1] = l[i];
                    m.nnzc[c][b] = uint8_t(n);
                }
        }
    }

    // ------------------------------------------------------------ transforms

    // h264idct_template.c: rows, then columns, each pass stored in 16 bits
    static void idct4_add(const int16_t* c, uint8_t* dst, int ds) {
        int16_t b[16], t[16];
        std::memcpy(b, c, sizeof b);
        b[0] = int16_t(b[0] + 32);
        for (int y = 0; y < 4; y++) {
            const int16_t* r = b + 4 * y;
            int z0 = r[0] + r[2], z1 = r[0] - r[2];
            int z2 = (r[1] >> 1) - r[3], z3 = r[1] + (r[3] >> 1);
            t[4 * y + 0] = int16_t(z0 + z3);
            t[4 * y + 1] = int16_t(z1 + z2);
            t[4 * y + 2] = int16_t(z1 - z2);
            t[4 * y + 3] = int16_t(z0 - z3);
        }
        for (int x = 0; x < 4; x++) {
            int z0 = t[x] + t[8 + x], z1 = t[x] - t[8 + x];
            int z2 = (t[4 + x] >> 1) - t[12 + x], z3 = t[4 + x] + (t[12 + x] >> 1);
            int o[4] = {z0 + z3, z1 + z2, z1 - z2, z0 - z3};
            for (int y = 0; y < 4; y++) dst[y * ds + x] = clip1(dst[y * ds + x] + (o[y] >> 6));
        }
    }

    // FFmpeg's choice between the full transform and the DC alone
    // (h264_idct_add16 and its kin): a block whose only coefficient is its
    // DC (``ac_nnz`` counts the others' and it; or, where ``dc_separate``, the
    // DC came from the DC transform and ``ac_nnz`` counts the AC alone) adds
    // (dc + 32) >> 6 without the 16-bit pass
    static void add4(const int16_t* c, int nnz, bool dc_separate, uint8_t* dst, int ds) {
        bool dc_only = dc_separate ? (!nnz && c[0]) : (nnz == 1 && c[0]);
        if (dc_only) {
            int dc = (c[0] + 32) >> 6;
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) dst[y * ds + x] = clip1(dst[y * ds + x] + dc);
        } else if (nnz) {
            idct4_add(c, dst, ds);
        }
    }

    static void idct8_1d(const int* s, int* o) {
        int a0 = s[0] + s[4], a2 = s[0] - s[4];
        int a4 = (s[2] >> 1) - s[6], a6 = (s[6] >> 1) + s[2];
        int b0 = a0 + a6, b2 = a2 + a4, b4 = a2 - a4, b6 = a0 - a6;
        int a1 = -s[3] + s[5] - s[7] - (s[7] >> 1);
        int a3 = s[1] + s[7] - s[3] - (s[3] >> 1);
        int a5 = -s[1] + s[7] + s[5] + (s[5] >> 1);
        int a7 = s[3] + s[5] + s[1] + (s[1] >> 1);
        int b1 = (a7 >> 2) + a1, b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5, b7 = a7 - (a1 >> 2);
        o[0] = b0 + b7;
        o[7] = b0 - b7;
        o[1] = b2 + b5;
        o[6] = b2 - b5;
        o[2] = b4 + b3;
        o[5] = b4 - b3;
        o[3] = b6 + b1;
        o[4] = b6 - b1;
    }
    static void idct8_add(const int16_t* c, uint8_t* dst, int ds) {
        int16_t b[64];
        std::memcpy(b, c, sizeof b);
        b[0] = int16_t(b[0] + 32);
        int16_t t[64];
        for (int y = 0; y < 8; y++) {
            int s[8], o[8];
            for (int x = 0; x < 8; x++) s[x] = b[8 * y + x];
            idct8_1d(s, o);
            for (int x = 0; x < 8; x++) t[8 * y + x] = int16_t(o[x]);
        }
        for (int x = 0; x < 8; x++) {
            int s[8], o[8];
            for (int y = 0; y < 8; y++) s[y] = t[8 * y + x];
            idct8_1d(s, o);
            for (int y = 0; y < 8; y++) dst[y * ds + x] = clip1(dst[y * ds + x] + (o[y] >> 6));
        }
    }

    // levels in scan order → dequantised coefficients in raster order
    void dequant4(const int16_t* lv, const int* dq, int16_t* out, bool skip_dc) {
        for (int k = skip_dc ? 1 : 0; k < 16; k++) {
            int pos = kZigzag4[k];
            out[pos] = lv[k] ? int16_t((lv[k] * (int64_t)dq[pos] + 32) >> 6) : 0;
        }
    }

    // ------------------------------------------------------------ intra prediction

    // the neighbours of an n x n block at (px, py) of a plane: T[-1..2n-1]
    // (the corner, the top and the top right), L[-1..n-1]
    void gather(const uint8_t* plane, int stride, int px, int py, int n, bool top, bool left, bool tl, bool tr,
                int* T, int* L) {
        if (top) {
            for (int i = 0; i < n; i++) T[i] = plane[(py - 1) * stride + px + i];
            for (int i = n; i < 2 * n; i++) T[i] = tr ? plane[(py - 1) * stride + px + i] : T[n - 1];
        }
        if (left)
            for (int j = 0; j < n; j++) L[j] = plane[(py + j) * stride + px - 1];
        if (tl) T[-1] = L[-1] = plane[(py - 1) * stride + px - 1];
    }

    // Intra_4x4 and Intra_8x8 modes on (filtered) neighbours
    static void pred_nxn(int mode, int n, const int* T, const int* L, bool top, bool left, uint8_t* dst, int ds) {
        auto put = [&](int x, int y, int v) { dst[y * ds + x] = uint8_t(v); };
        const int last = 2 * n - 1;
        switch (mode) {
        case 0:
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) put(x, y, T[x]);
            break;
        case 1:
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) put(x, y, L[y]);
            break;
        case 2: {
            int s = 0, v;
            int lg = n == 4 ? 2 : 3;
            if (top && left) {
                for (int i = 0; i < n; i++) s += T[i] + L[i];
                v = (s + n) >> (lg + 1);
            } else if (left) {
                for (int i = 0; i < n; i++) s += L[i];
                v = (s + n / 2) >> lg;
            } else if (top) {
                for (int i = 0; i < n; i++) s += T[i];
                v = (s + n / 2) >> lg;
            } else {
                v = 128;
            }
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) put(x, y, v);
            break;
        }
        case 3:
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++)
                    put(x, y, (x == n - 1 && y == n - 1) ? (T[last - 1] + 3 * T[last] + 2) >> 2
                                                         : (T[x + y] + 2 * T[x + y + 1] + T[x + y + 2] + 2) >> 2);
            break;
        case 4:
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) {
                    int v;
                    if (x > y) v = (T[x - y - 2] + 2 * T[x - y - 1] + T[x - y] + 2) >> 2;
                    else if (x < y) v = (L[y - x - 2] + 2 * L[y - x - 1] + L[y - x] + 2) >> 2;
                    else v = (T[0] + 2 * T[-1] + L[0] + 2) >> 2;
                    put(x, y, v);
                }
            break;
        case 5:
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) {
                    int z = 2 * x - y, v;
                    if (z >= 0 && !(z & 1)) v = (T[x - (y >> 1) - 1] + T[x - (y >> 1)] + 1) >> 1;
                    else if (z >= 0) v = (T[x - (y >> 1) - 2] + 2 * T[x - (y >> 1) - 1] + T[x - (y >> 1)] + 2) >> 2;
                    else if (z == -1) v = (L[0] + 2 * L[-1] + T[0] + 2) >> 2;
                    else v = (L[y - 2 * x - 1] + 2 * L[y - 2 * x - 2] + L[y - 2 * x - 3] + 2) >> 2;
                    put(x, y, v);
                }
            break;
        case 6:
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) {
                    int z = 2 * y - x, v;
                    if (z >= 0 && !(z & 1)) v = (L[y - (x >> 1) - 1] + L[y - (x >> 1)] + 1) >> 1;
                    else if (z >= 0) v = (L[y - (x >> 1) - 2] + 2 * L[y - (x >> 1) - 1] + L[y - (x >> 1)] + 2) >> 2;
                    else if (z == -1) v = (L[0] + 2 * L[-1] + T[0] + 2) >> 2;
                    else v = (T[x - 2 * y - 1] + 2 * T[x - 2 * y - 2] + T[x - 2 * y - 3] + 2) >> 2;
                    put(x, y, v);
                }
            break;
        case 7:
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) {
                    int i = x + (y >> 1);
                    put(x, y, (y & 1) ? (T[i] + 2 * T[i + 1] + T[i + 2] + 2) >> 2 : (T[i] + T[i + 1] + 1) >> 1);
                }
            break;
        default:
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) {
                    int z = x + 2 * y, i = y + (x >> 1), v;
                    if (z > 2 * n - 3) v = L[n - 1];
                    else if (z == 2 * n - 3) v = (L[n - 2] + 3 * L[n - 1] + 2) >> 2;
                    else if (z & 1) v = (L[i] + 2 * L[i + 1] + L[i + 2] + 2) >> 2;
                    else v = (L[i] + L[i + 1] + 1) >> 1;
                    put(x, y, v);
                }
            break;
        }
    }

    // 8.3.2.2.1: the reference samples of an 8x8 block, filtered
    static void filter8(int* T, int* L, bool top, bool left, bool tl) {
        int t[17] = {}, l[9] = {};
        const int* pt = T;
        if (top) {
            t[1] = tl ? (T[-1] + 2 * T[0] + T[1] + 2) >> 2 : (3 * T[0] + T[1] + 2) >> 2;
            for (int x = 1; x < 15; x++) t[1 + x] = (pt[x - 1] + 2 * pt[x] + pt[x + 1] + 2) >> 2;
            t[16] = (T[14] + 3 * T[15] + 2) >> 2;
        }
        if (tl) {
            if (!top || !left) {
                if (top) t[0] = (3 * T[-1] + T[0] + 2) >> 2;
                else if (left) t[0] = (3 * T[-1] + L[0] + 2) >> 2;
                else t[0] = T[-1];
            } else {
                t[0] = (T[0] + 2 * T[-1] + L[0] + 2) >> 2;
            }
        }
        if (left) {
            l[1] = tl ? (T[-1] + 2 * L[0] + L[1] + 2) >> 2 : (3 * L[0] + L[1] + 2) >> 2;
            for (int y = 1; y < 7; y++) l[1 + y] = (L[y - 1] + 2 * L[y] + L[y + 1] + 2) >> 2;
            l[8] = (L[6] + 3 * L[7] + 2) >> 2;
        }
        if (top)
            for (int x = 0; x < 16; x++) T[x] = t[1 + x];
        if (left)
            for (int y = 0; y < 8; y++) L[y] = l[1 + y];
        if (tl) T[-1] = L[-1] = t[0];
    }

    void mode_feat(int base, int mode, bool top, bool left) {
        modes |= uint64_t(1) << (base + mode);
        if (!top || !left) modes |= uint64_t(1) << (M_EDGE + base + mode);
    }

    void pred16(int mode, bool top, bool left, bool tl, uint8_t* dst, int ds, const uint8_t* plane, int stride, int px,
                int py) {
        int Tb[34], Lb[18];
        int *T = Tb + 1, *L = Lb + 1;
        gather(plane, stride, px, py, 16, top, left, tl, false, T, L);
        if ((mode == 0 && !top) || (mode == 1 && !left) || (mode == 3 && !(top && left && tl)))
            CORRUPT("Intra_16x16 mode %d without its neighbours", mode);
        int v = 128;
        switch (mode) {
        case 0:
            for (int y = 0; y < 16; y++)
                for (int x = 0; x < 16; x++) dst[y * ds + x] = uint8_t(T[x]);
            return;
        case 1:
            for (int y = 0; y < 16; y++)
                for (int x = 0; x < 16; x++) dst[y * ds + x] = uint8_t(L[y]);
            return;
        case 2: {
            int s = 0;
            if (top && left) {
                for (int i = 0; i < 16; i++) s += T[i] + L[i];
                v = (s + 16) >> 5;
            } else if (left) {
                for (int i = 0; i < 16; i++) s += L[i];
                v = (s + 8) >> 4;
            } else if (top) {
                for (int i = 0; i < 16; i++) s += T[i];
                v = (s + 8) >> 4;
            }
            for (int y = 0; y < 16; y++)
                for (int x = 0; x < 16; x++) dst[y * ds + x] = uint8_t(v);
            return;
        }
        default: {
            int H = 0, V = 0;
            for (int i = 0; i < 8; i++) {
                H += (i + 1) * (T[8 + i] - T[6 - i]);
                V += (i + 1) * (L[8 + i] - L[6 - i]);
            }
            int a = 16 * (L[15] + T[15]), b = (5 * H + 32) >> 6, c = (5 * V + 32) >> 6;
            for (int y = 0; y < 16; y++)
                for (int x = 0; x < 16; x++) dst[y * ds + x] = clip1((a + b * (x - 7) + c * (y - 7) + 16) >> 5);
            return;
        }
        }
    }

    void pred_chroma(int mode, bool top, bool left, bool tl, uint8_t* plane, int stride, int px, int py) {
        int Tb[18], Lb[10];
        int *T = Tb + 1, *L = Lb + 1;
        gather(plane, stride, px, py, 8, top, left, tl, false, T, L);
        uint8_t* dst = plane + py * stride + px;
        if ((mode == 1 && !left) || (mode == 2 && !top) || (mode == 3 && !(top && left && tl)))
            CORRUPT("chroma prediction mode %d without its neighbours", mode);
        if (mode == 0) {
            for (int by = 0; by < 2; by++)
                for (int bx = 0; bx < 2; bx++) {
                    int st = 0, sl = 0;
                    for (int i = 0; i < 4; i++) {
                        if (top) st += T[4 * bx + i];
                        if (left) sl += L[4 * by + i];
                    }
                    int v = 128;
                    if (bx == by) {   // (0,0) and (1,1)
                        if (top && left) v = (st + sl + 4) >> 3;
                        else if (left) v = (sl + 2) >> 2;
                        else if (top) v = (st + 2) >> 2;
                    } else if (bx) {   // top right
                        if (top) v = (st + 2) >> 2;
                        else if (left) v = (sl + 2) >> 2;
                    } else {   // bottom left
                        if (left) v = (sl + 2) >> 2;
                        else if (top) v = (st + 2) >> 2;
                    }
                    for (int y = 0; y < 4; y++)
                        for (int x = 0; x < 4; x++) dst[(4 * by + y) * stride + 4 * bx + x] = uint8_t(v);
                }
        } else if (mode == 1) {
            for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++) dst[y * stride + x] = uint8_t(L[y]);
        } else if (mode == 2) {
            for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++) dst[y * stride + x] = uint8_t(T[x]);
        } else {
            int H = 0, V = 0;
            for (int i = 0; i < 4; i++) {
                H += (i + 1) * (T[4 + i] - T[2 - i]);
                V += (i + 1) * (L[4 + i] - L[2 - i]);
            }
            int a = 16 * (L[7] + T[7]), b = (34 * H + 32) >> 6, c = (34 * V + 32) >> 6;
            for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++) dst[y * stride + x] = clip1((a + b * (x - 3) + c * (y - 3) + 16) >> 5);
        }
    }

    // ------------------------------------------------------------ reconstruction

    void reconstruct(MbData& d, MbInfo& m) {
        const int cw = width / 2;
        uint8_t* Y = &cur->y[(mb_y * 16) * width + mb_x * 16];
        const int qpc[2] = {kChromaQp[clip3(0, 51, qp + cqp_off[0])], kChromaQp[clip3(0, 51, qp + cqp_off[1])]};
        const bool intra = d.kind <= MB_PCM;
        const int A = addr_a(), B = addr_b(), C = addr_c(), D = addr_d();
        const bool ia = intra_avail(A), ib = intra_avail(B), ic = intra_avail(C), id = intra_avail(D);
        int16_t c[64];
        if (d.kind == MB_I4) {
            const int* dq = dq4[0][qp];
            for (int b = 0; b < 16; b++) {
                int bx = kBlkX[b], by = kBlkY[b];
                bool left = bx > 0 || ia, top = by > 0 || ib;
                bool tl = (bx > 0 && by > 0) || (bx == 0 && by > 0 ? ia : bx > 0 && by == 0 ? ib : id);
                bool tr = by == 0 ? (bx < 3 ? ib : ic) : (bx < 3 && kRasterToBlk[(by - 1) * 4 + bx + 1] < b);
                int mode = d.ipred[b];
                check_mode(mode, top, left, tl);
                mode_feat(M_I4, mode, top, left);
                int Tb[9], Lb[5];
                int *T = Tb + 1, *L = Lb + 1;
                gather(cur->y.data(), width, mb_x * 16 + 4 * bx, mb_y * 16 + 4 * by, 4, top, left, tl, tr, T, L);
                uint8_t* dst = Y + 4 * by * width + 4 * bx;
                pred_nxn(mode, 4, T, L, top, left, dst, width);
                if (m.nnz[by * 4 + bx]) {
                    std::memset(c, 0, 32);
                    dequant4(d.lv4[b], dq, c, false);
                    add4(c, m.nnz[by * 4 + bx], false, dst, width);
                }
            }
        } else if (d.kind == MB_I8) {
            for (int b8 = 0; b8 < 4; b8++) {
                int bx = b8 & 1, by = b8 >> 1;
                bool left = bx > 0 || ia, top = by > 0 || ib;
                bool tl = (bx && by) || (!bx && by ? ia : bx && !by ? ib : id);
                bool tr = by == 0 ? (bx == 0 ? ib : ic) : bx == 0;
                int mode = d.ipred[b8];
                check_mode(mode, top, left, tl);
                mode_feat(M_I8, mode, top, left);
                int Tb[17], Lb[9];
                int *T = Tb + 1, *L = Lb + 1;
                gather(cur->y.data(), width, mb_x * 16 + 8 * bx, mb_y * 16 + 8 * by, 8, top, left, tl, tr, T, L);
                filter8(T, L, top, left, tl);
                uint8_t* dst = Y + 8 * by * width + 8 * bx;
                pred_nxn(mode, 8, T, L, top, left, dst, width);
                if (d.cbp >> b8 & 1) add8(d.lv8[b8], dq8[0][qp], dst, width, nnz8(m, b8));
            }
        } else if (d.kind == MB_I16) {
            mode_feat(M_I16, d.i16_mode, ib, ia);
            pred16(d.i16_mode, ib, ia, id, Y, width, cur->y.data(), width, mb_x * 16, mb_y * 16);
            // the DC Hadamard, dequantised as ff_h264_luma_dc_dequant_idct
            int f[16], t[16];
            for (int k = 0; k < 16; k++) f[kZigzag4[k]] = d.dc[k];
            for (int y = 0; y < 4; y++) {
                int z0 = f[4 * y] + f[4 * y + 1], z1 = f[4 * y] - f[4 * y + 1];
                int z2 = f[4 * y + 2] - f[4 * y + 3], z3 = f[4 * y + 2] + f[4 * y + 3];
                t[4 * y + 0] = z0 + z3;
                t[4 * y + 1] = z0 - z3;
                t[4 * y + 2] = z1 - z2;
                t[4 * y + 3] = z1 + z2;
            }
            int dcv[16];
            const int q0 = dq4[0][qp][0];
            for (int x = 0; x < 4; x++) {
                int z0 = t[x] + t[8 + x], z1 = t[x] - t[8 + x];
                int z2 = t[4 + x] - t[12 + x], z3 = t[4 + x] + t[12 + x];
                dcv[0 * 4 + x] = int16_t((int)((int64_t)(z0 + z3) * q0 + 128) >> 8);
                dcv[1 * 4 + x] = int16_t((int)((int64_t)(z1 + z2) * q0 + 128) >> 8);
                dcv[2 * 4 + x] = int16_t((int)((int64_t)(z1 - z2) * q0 + 128) >> 8);
                dcv[3 * 4 + x] = int16_t((int)((int64_t)(z0 - z3) * q0 + 128) >> 8);
            }
            // the Hadamard's rows and columns map onto the order FFmpeg
            // stores its output in: dcv[i][j] is the block at x j, y i...
            for (int b = 0; b < 16; b++) {
                int bx = kBlkX[b], by = kBlkY[b];
                std::memset(c, 0, 32);
                dequant4(d.lv4[b], dq4[0][qp], c, true);
                c[0] = int16_t(dcv[by * 4 + bx]);
                add4(c, m.nnz[by * 4 + bx], true, Y + 4 * by * width + 4 * bx, width);
            }
        } else {
            // inter: predicted while parsing; the residual
            int lst = 3;
            if (d.t8) {
                for (int b8 = 0; b8 < 4; b8++)
                    if (d.cbp >> b8 & 1)
                        add8(d.lv8[b8], dq8[1][qp], Y + 8 * (b8 >> 1) * width + 8 * (b8 & 1), width, nnz8(m, b8));
            } else {
                for (int b = 0; b < 16; b++) {
                    int bx = kBlkX[b], by = kBlkY[b];
                    if (!m.nnz[by * 4 + bx]) continue;
                    std::memset(c, 0, 32);
                    dequant4(d.lv4[b], dq4[lst][qp], c, false);
                    add4(c, m.nnz[by * 4 + bx], false, Y + 4 * by * width + 4 * bx, width);
                }
            }
        }
        // chroma
        for (int k = 0; k < 2; k++) {
            std::vector<uint8_t>& plane = k ? cur->v : cur->u;
            uint8_t* dst = &plane[(mb_y * 8) * cw + mb_x * 8];
            if (intra) {
                if (k == 0) mode_feat(M_CHROMA, d.chroma_mode, ib, ia);
                pred_chroma(d.chroma_mode, ib, ia, id, plane.data(), cw, mb_x * 8, mb_y * 8);
            }
            if (!(d.cbp >> 4)) continue;
            const int lst = (intra ? 1 : 4) + k;
            const int q = dq4[lst][qpc[k]][0];
            const int16_t* dc = d.cdc[k];
            int a = dc[0], b = dc[1], cc = dc[2], dd = dc[3];
            int e = a - b;
            a = a + b;
            b = cc - dd;
            cc = cc + dd;
            int dcv[4] = {(int)(((int64_t)(a + cc) * q) >> 7), (int)(((int64_t)(e + b) * q) >> 7),
                          (int)(((int64_t)(a - cc) * q) >> 7), (int)(((int64_t)(e - b) * q) >> 7)};
            for (int blk = 0; blk < 4; blk++) {
                std::memset(c, 0, 32);
                dequant4(d.cac[k][blk], dq4[lst][qpc[k]], c, true);
                c[0] = int16_t(dcv[blk]);
                add4(c, m.nnzc[k][blk], true, dst + 4 * (blk >> 1) * cw + 4 * (blk & 1), cw);
            }
        }
        // what the deblocking reads: coefficients per 4x4 (per 8x8 under
        // the 8x8 transform)
        for (int i = 0; i < 16; i++) m.nzd[i] = m.nnz[i] != 0;
        if (m.t8)
            for (int b8 = 0; b8 < 4; b8++) {
                int x4 = (b8 & 1) * 2, y4 = (b8 >> 1) * 2;
                bool nz = false;
                for (int k = 0; k < 64; k++) nz |= d.lv8[b8][k] != 0;
                for (int j = 0; j < 2; j++)
                    for (int i = 0; i < 2; i++) m.nzd[(y4 + j) * 4 + x4 + i] = nz;
            }
    }

    // the coefficients of an 8x8 block as FFmpeg counts them (CAVLC: its
    // four interleaved blocks' total_coeff summed)
    int nnz8(const MbInfo& m, int b8) const {
        int x4 = (b8 & 1) * 2, y4 = (b8 >> 1) * 2;
        if (is_cabac) return m.nnz[y4 * 4 + x4];
        return m.nnz[y4 * 4 + x4] + m.nnz[y4 * 4 + x4 + 1] + m.nnz[(y4 + 1) * 4 + x4] + m.nnz[(y4 + 1) * 4 + x4 + 1];
    }

    void add8(const int16_t* lv, const int* dq, uint8_t* dst, int ds, int nnz) {
        int16_t c[64];
        for (int k = 0; k < 64; k++) {
            int pos = kZigzag8[k];
            c[pos] = lv[k] ? int16_t((lv[k] * (int64_t)dq[pos] + 32) >> 6) : 0;
        }
        if (nnz == 1 && c[0]) {   // ff_h264_idct8_dc_add
            int dc = (c[0] + 32) >> 6;
            for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++) dst[y * ds + x] = clip1(dst[y * ds + x] + dc);
        } else if (nnz) {
            idct8_add(c, dst, ds);
        }
    }

    static void check_mode(int mode, bool top, bool left, bool tl) {
        static const uint8_t need[9] = {1, 2, 0, 1, 7, 7, 7, 1, 2};   // 1 top, 2 left, 4 top-left
        int have = (top ? 1 : 0) | (left ? 2 : 0) | (tl ? 4 : 0);
        if ((need[mode] & have) != need[mode]) CORRUPT("intra mode %d without its neighbours", mode);
    }

    // ------------------------------------------------------------ inter prediction

    // one list's prediction of a w x h block at (px, py) from R: quarter-
    // sample luma into ly (stride lys), eighth-sample chroma into lu, lv
    // (stride cs), over edge-replicated references
    void mc(const Picture& R, int px, int py, int w, int h, const int16_t* mv, uint8_t* ly, int lys, uint8_t* lu,
            uint8_t* lv, int cs) {
        int xi = px + (mv[0] >> 2) - 2, yi = py + (mv[1] >> 2) - 2;
        int fx = mv[0] & 3, fy = mv[1] & 3;
        if (px + (mv[0] >> 2) < 0 || py + (mv[1] >> 2) < 0 || px + (mv[0] >> 2) + w > width ||
            py + (mv[1] >> 2) + h > height)
            feat(F_EDGE_MV);
        if (xi >= 0 && yi >= 0 && xi + w + 5 <= width && yi + h + 5 <= height) {
            h264qpel::put_block(ly, lys, &R.y[(yi + 2) * width + xi + 2], width, w, h, fx, fy);
        } else {
            uint8_t tmp[21 * 21];
            for (int j = 0; j < h + 5; j++)
                for (int i = 0; i < w + 5; i++)
                    tmp[j * 21 + i] = R.y[clip3(0, height - 1, yi + j) * width + clip3(0, width - 1, xi + i)];
            h264qpel::put_block(ly, lys, tmp + 2 * 21 + 2, 21, w, h, fx, fy);
        }
        const int cw = width / 2, ch = height / 2;
        int cxi = px / 2 + (mv[0] >> 3), cyi = py / 2 + (mv[1] >> 3);
        int cfx = mv[0] & 7, cfy = mv[1] & 7;
        int wa = (8 - cfx) * (8 - cfy), wb = cfx * (8 - cfy), wc = (8 - cfx) * cfy, wd = cfx * cfy;
        for (int k = 0; k < 2; k++) {
            const std::vector<uint8_t>& src = k ? R.v : R.u;
            uint8_t* cd = k ? lv : lu;
            for (int j = 0; j < h / 2; j++) {
                int y0 = clip3(0, ch - 1, cyi + j), y1 = clip3(0, ch - 1, cyi + j + 1);
                for (int i = 0; i < w / 2; i++) {
                    int x0 = clip3(0, cw - 1, cxi + i), x1 = clip3(0, cw - 1, cxi + i + 1);
                    cd[j * cs + i] = uint8_t((wa * src[y0 * cw + x0] + wb * src[y0 * cw + x1] +
                                              wc * src[y1 * cw + x0] + wd * src[y1 * cw + x1] + 32) >> 6);
                }
            }
        }
    }

    // 8.4.2.2-3: the block at (x, y) of the macroblock from its 8x8 block's
    // references and its top-left 4x4's vectors, each list alone, or both
    // averaged or weighted (explicitly, or implicitly by POC distance)
    void predict(int x, int y, int w, int h) {
        const MbInfo& m = mbs[mb_addr];
        const int b8 = (y >> 3) * 2 + (x >> 3), blk = (y >> 2) * 4 + (x >> 2);
        const int r0 = m.ref[0][b8], r1 = m.ref[1][b8];
        const int px = mb_x * 16 + x, py = mb_y * 16 + y, cw = width / 2;
        uint8_t* dy = &cur->y[py * width + px];
        uint8_t* du = &cur->u[(py / 2) * cw + px / 2];
        uint8_t* dv = &cur->v[(py / 2) * cw + px / 2];
        if (r0 < 0 && r1 < 0) CORRUPT("an inter block with no reference");
        if (r0 >= 0 && r1 >= 0) {
            mc(*list[0][r0].pic, px, py, w, h, m.mv[0][blk], dy, width, du, dv, cw);
            uint8_t ty[256], tu[64], tv[64];
            mc(*list[1][r1].pic, px, py, w, h, m.mv[1][blk], ty, 16, tu, tv, 8);
            if (wmode == 1) {
                featb(FB_EXPLICIT);
                const RefEntry &e0 = list[0][r0], &e1 = list[1][r1];
                biweight(dy, width, ty, 16, w, h, luma_log2, e0.w[0], e1.w[0], e0.o[0] + e1.o[0]);
                biweight(du, cw, tu, 8, w / 2, h / 2, chroma_log2, e0.w[1], e1.w[1], e0.o[1] + e1.o[1]);
                biweight(dv, cw, tv, 8, w / 2, h / 2, chroma_log2, e0.w[2], e1.w[2], e0.o[2] + e1.o[2]);
            } else if (wmode == 2 && implicit_w[r0][r1] != 32) {
                featb(FB_IMPLICIT);
                int w0 = implicit_w[r0][r1];
                biweight(dy, width, ty, 16, w, h, 5, w0, 64 - w0, 0);
                biweight(du, cw, tu, 8, w / 2, h / 2, 5, w0, 64 - w0, 0);
                biweight(dv, cw, tv, 8, w / 2, h / 2, 5, w0, 64 - w0, 0);
            } else {
                if (wmode == 2) featb(implicit_fb[r0][r1] ? FB_IMPLICIT_FALLBACK : FB_IMPLICIT);
                average(dy, width, ty, 16, w, h);
                average(du, cw, tu, 8, w / 2, h / 2);
                average(dv, cw, tv, 8, w / 2, h / 2);
            }
            return;
        }
        const int l = r0 >= 0 ? 0 : 1;
        const RefEntry& r = list[l][l ? r1 : r0];
        mc(*r.pic, px, py, w, h, m.mv[l][blk], dy, width, du, dv, cw);
        if (wmode == 1) {
            weight(dy, width, w, h, luma_log2, r.w[0], r.o[0]);
            weight(du, cw, w / 2, h / 2, chroma_log2, r.w[1], r.o[1]);
            weight(dv, cw, w / 2, h / 2, chroma_log2, r.w[2], r.o[2]);
        }
    }

    // the macroblock's inter prediction, in the largest blocks of one
    // motion (the samples do not depend on how a block is split)
    void predict_mb() {
        const MbInfo& m = mbs[mb_addr];
        auto same = [&](int a, int b) {
            for (int l = 0; l < 2; l++)
                if (m.mv[l][a][0] != m.mv[l][b][0] || m.mv[l][a][1] != m.mv[l][b][1]) return false;
            return true;
        };
        bool whole = true;
        for (int l = 0; l < 2; l++)
            for (int i = 1; i < 4; i++) whole &= m.ref[l][i] == m.ref[l][0];
        for (int b = 1; b < 16 && whole; b++) whole &= same(0, b);
        if (whole) {
            predict(0, 0, 16, 16);
            return;
        }
        for (int b8 = 0; b8 < 4; b8++) {
            int x = (b8 & 1) * 8, y = (b8 >> 1) * 8, b = (y / 4) * 4 + x / 4;
            if (same(b, b + 1) && same(b, b + 4) && same(b, b + 5)) {
                predict(x, y, 8, 8);
                continue;
            }
            for (int k = 0; k < 4; k++) predict(x + (k & 1) * 4, y + (k >> 1) * 4, 4, 4);
        }
    }

    // (p0 + p1 + 1) >> 1
    static void average(uint8_t* d, int ds, const uint8_t* s, int ss, int w, int h) {
        for (int j = 0; j < h; j++)
            for (int i = 0; i < w; i++) d[j * ds + i] = uint8_t((d[j * ds + i] + s[j * ss + i] + 1) >> 1);
    }

    // h264_biweight: ((p0 w0 + p1 w1 + 2^lg) >> (lg + 1)) + ((o0 + o1 + 1) >> 1)
    static void biweight(uint8_t* d, int ds, const uint8_t* s, int ss, int w, int h, int lg, int w0, int w1,
                         int o) {
        int off = ((o + 1) | 1) * (1 << lg);
        for (int j = 0; j < h; j++)
            for (int i = 0; i < w; i++)
                d[j * ds + i] = clip1((d[j * ds + i] * w0 + s[j * ss + i] * w1 + off) >> (lg + 1));
    }

    static void weight(uint8_t* p, int ds, int w, int h, int lg, int wt, int o) {
        for (int j = 0; j < h; j++)
            for (int i = 0; i < w; i++) {
                int v = p[j * ds + i] * wt;
                p[j * ds + i] = lg >= 1 ? clip1(((v + (1 << (lg - 1))) >> lg) + o) : clip1(v + o);
            }
    }

    // ------------------------------------------------------------ deblocking (8.7)

    // h264_loopfilter.c's check_mv: the references (as pictures) and
    // vectors of both lists (of list 0 in a P slice), the pairings compared
    // either way round
    static int bs_of(const MbInfo& p, int bp, const MbInfo& q, int bq, bool mb_edge, bool two) {
        if (p.intra() || q.intra()) return mb_edge ? 4 : 3;
        if (p.nzd[bp] || q.nzd[bq]) return 2;
        int rp = (bp >> 3) * 2 + ((bp & 3) >> 1), rq = (bq >> 3) * 2 + ((bq & 3) >> 1);
        auto far = [&](int lp, int lq) {
            return std::abs(p.mv[lp][bp][0] - q.mv[lq][bq][0]) >= 4 || std::abs(p.mv[lp][bp][1] - q.mv[lq][bq][1]) >= 4;
        };
        bool v = p.ref_id[0][rp] != q.ref_id[0][rq];
        if (!v && p.ref_id[0][rp] != -1) v = far(0, 0);
        if (!two) return v;
        if (!v) v = p.ref_id[1][rp] != q.ref_id[1][rq] || far(1, 1);
        if (!v) return 0;
        if (p.ref_id[0][rp] != q.ref_id[1][rq] || p.ref_id[1][rp] != q.ref_id[0][rq]) return 1;
        return far(0, 1) || far(1, 0);
    }

    static void filter_luma(uint8_t* pix, int xs, int ys, const int* bs, int qpav, int aoff, int boff) {
        int ia = clip3(0, 51, qpav + aoff), ib = clip3(0, 51, qpav + boff);
        int alpha = kAlpha[ia], beta = kBeta[ib];
        for (int i = 0; i < 16; i++) {
            int b = bs[i >> 2];
            if (!b) continue;
            uint8_t* s = pix + i * ys;
            int p0 = s[-xs], p1 = s[-2 * xs], p2 = s[-3 * xs], p3 = s[-4 * xs];
            int q0 = s[0], q1 = s[xs], q2 = s[2 * xs], q3 = s[3 * xs];
            if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta)) continue;
            int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
            if (b < 4) {
                int tc0 = kTc0[ia][b - 1];
                int tc = tc0 + (ap < beta) + (aq < beta);
                int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
                s[-xs] = clip1(p0 + delta);
                s[0] = clip1(q0 - delta);
                if (ap < beta) s[-2 * xs] = uint8_t(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1));
                if (aq < beta) s[xs] = uint8_t(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1));
            } else {
                bool strong = std::abs(p0 - q0) < ((alpha >> 2) + 2);
                if (ap < beta && strong) {
                    s[-xs] = uint8_t((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
                    s[-2 * xs] = uint8_t((p2 + p1 + p0 + q0 + 2) >> 2);
                    s[-3 * xs] = uint8_t((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
                } else {
                    s[-xs] = uint8_t((2 * p1 + p0 + q1 + 2) >> 2);
                }
                if (aq < beta && strong) {
                    s[0] = uint8_t((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
                    s[xs] = uint8_t((p0 + q0 + q1 + q2 + 2) >> 2);
                    s[2 * xs] = uint8_t((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
                } else {
                    s[0] = uint8_t((2 * q1 + q0 + p1 + 2) >> 2);
                }
            }
        }
    }

    static void filter_chroma(uint8_t* pix, int xs, int ys, const int* bs, int qpav, int aoff, int boff) {
        int ia = clip3(0, 51, qpav + aoff), ib = clip3(0, 51, qpav + boff);
        int alpha = kAlpha[ia], beta = kBeta[ib];
        for (int i = 0; i < 8; i++) {
            int b = bs[i >> 1];
            if (!b) continue;
            uint8_t* s = pix + i * ys;
            int p0 = s[-xs], p1 = s[-2 * xs], q0 = s[0], q1 = s[xs];
            if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta)) continue;
            if (b < 4) {
                int tc = kTc0[ia][b - 1] + 1;
                int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
                s[-xs] = clip1(p0 + delta);
                s[0] = clip1(q0 - delta);
            } else {
                s[-xs] = uint8_t((2 * p1 + p0 + q1 + 2) >> 2);
                s[0] = uint8_t((2 * q1 + q0 + p1 + 2) >> 2);
            }
        }
    }

    int chroma_qp_of(const MbInfo& m, int k) const {
        return kChromaQp[clip3(0, 51, m.qp + slices[m.slice].chroma_qp_offset[k])];
    }

    void deblock() {
        const int cw = width / 2;
        for (int addr = 0; addr < mb_w * mb_h; addr++) {
            const MbInfo& q = mbs[addr];
            const SliceParams& sp = slices[q.slice];
            if (sp.disable_deblock == 1) continue;
            const int mx = addr % mb_w, my = addr / mb_w;
            const bool edge[2] = {mx > 0 && !(sp.disable_deblock == 2 && mbs[addr - 1].slice != q.slice),
                                  my > 0 && !(sp.disable_deblock == 2 && mbs[addr - mb_w].slice != q.slice)};
            int bs[2][4][4];
            for (int dir = 0; dir < 2; dir++)
                for (int e = 0; e < 4; e++)
                    for (int s = 0; s < 4; s++) {
                        int& b = bs[dir][e][s];
                        b = 0;
                        if (e == 0 && !edge[dir]) continue;
                        if ((e & 1) && q.t8) continue;
                        int bq = dir ? e * 4 + s : s * 4 + e;
                        if (e) {
                            int bp = dir ? (e - 1) * 4 + s : s * 4 + e - 1;
                            b = bs_of(q, bp, q, bq, false, sp.b);
                        } else {
                            const MbInfo& p = mbs[dir ? addr - mb_w : addr - 1];
                            int bp = dir ? 12 + s : s * 4 + 3;
                            b = bs_of(p, bp, q, bq, true, sp.b);
                        }
                    }
            uint8_t* Y = &cur->y[(my * 16) * width + mx * 16];
            for (int dir = 0; dir < 2; dir++)
                for (int e = 0; e < 4; e++) {
                    if (!(bs[dir][e][0] | bs[dir][e][1] | bs[dir][e][2] | bs[dir][e][3])) continue;
                    const MbInfo& p = e ? q : mbs[dir ? addr - mb_w : addr - 1];
                    int qpav = (p.qp + q.qp + 1) >> 1;
                    uint8_t* pix = dir ? Y + 4 * e * width : Y + 4 * e;
                    filter_luma(pix, dir ? width : 1, dir ? 1 : width, bs[dir][e], qpav, sp.alpha_off, sp.beta_off);
                }
            for (int k = 0; k < 2; k++) {
                uint8_t* C = &(k ? cur->v : cur->u)[(my * 8) * cw + mx * 8];
                for (int dir = 0; dir < 2; dir++)
                    for (int e = 0; e < 4; e += 2) {
                        if (!(bs[dir][e][0] | bs[dir][e][1] | bs[dir][e][2] | bs[dir][e][3])) continue;
                        const MbInfo& p = e ? q : mbs[dir ? addr - mb_w : addr - 1];
                        int qpav = (chroma_qp_of(p, k) + chroma_qp_of(q, k) + 1) >> 1;
                        uint8_t* pix = dir ? C + 2 * e * cw : C + 2 * e;
                        filter_chroma(pix, dir ? cw : 1, dir ? 1 : cw, bs[dir][e], qpav, sp.alpha_off, sp.beta_off);
                    }
            }
        }
    }

    // ------------------------------------------------------------ the packet

    // the crop FFmpeg applies to the frames it hands over: the SPS's, but a
    // left crop that would unalign the planes rounded down to 64
    // (av_frame_apply_cropping); the stream's own size stays the SPS's crop
    // (cv2 scales the frame to it)
    int crop_left() const { return S->crop_l & ~63; }
    void geometry(int64_t* info) const {
        info[1] = width - crop_left() - S->crop_r;
        info[2] = height - S->crop_t - S->crop_b;
        info[3] = S->full_range;
        info[4] = S->colour_description ? S->matrix : 2;
        info[5] = S->chroma_loc;
    }

    void decode(const uint8_t* d, int64_t n, bool end) {
        out.clear();
        if (end) {
            flush();
            return;
        }
        serial++;
        try {
            packet(d, n);
            if (cur) finish_picture();
            out.erase(std::remove_if(out.begin(), out.end(), [](const PicPtr& p) { return !p->recovered; }),
                      out.end());
        } catch (...) {
            cur.reset();
            throw;
        }
    }

    void copy_out(int i, uint8_t* y, uint8_t* u, uint8_t* v) const {
        const Picture& p = *out[i];
        int x0 = crop_left(), y0 = S->crop_t;
        int w = width - x0 - S->crop_r, h = height - S->crop_t - S->crop_b;
        for (int j = 0; j < h; j++) std::memcpy(y + (int64_t)j * w, &p.y[(y0 + j) * width + x0], w);
        int cw = (w + 1) / 2, ch = (h + 1) / 2;
        for (int j = 0; j < ch; j++) {
            std::memcpy(u + (int64_t)j * cw, &p.u[(y0 / 2 + j) * (width / 2) + x0 / 2], cw);
            std::memcpy(v + (int64_t)j * cw, &p.v[(y0 / 2 + j) * (width / 2) + x0 / 2], cw);
        }
    }
};

void put_msg(char* msg, int64_t cap, const std::string& s) {
    if (!msg || cap <= 0) return;
    int64_t n = std::min<int64_t>((int64_t)s.size(), cap - 1);
    std::memcpy(msg, s.data(), (size_t)n);
    msg[n] = 0;
}

}  // namespace

extern "C" {

void* h264_dec_new() { return new (std::nothrow) Decoder(); }

void h264_dec_free(void* h) { delete (Decoder*)h; }

// a container's codec record: avcC (sets the NAL length size) or Annex B
int h264_dec_extradata(void* h, const uint8_t* d, int64_t n, char* msg, int64_t cap) {
    try {
        ((Decoder*)h)->extradata(d, n);
        return kOk;
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    } catch (const std::bad_alloc&) {
        put_msg(msg, cap, "out of memory");
        return kCorrupt;
    }
}

// One packet (``end``: the end of the stream, no data) → kOk with the
// pictures it hands over counted in info[0], their size, range, matrix and
// chroma site in info[1..5] and the packet each came in (0 the first) in
// info[6..]; h264_dec_output copies them out.
int h264_dec_decode(void* h, const uint8_t* d, int64_t n, int end, int64_t* info, char* msg, int64_t cap) {
    Decoder* dec = (Decoder*)h;
    try {
        dec->decode(d, n, end != 0);
        info[0] = (int64_t)dec->out.size();
        if (dec->out.size() > 26) CORRUPT("too many pictures handed over at once");
        if (dec->S) dec->geometry(info);
        for (size_t i = 0; i < dec->out.size(); i++) info[6 + i] = dec->out[i]->serial;
        return dec->out.empty() ? kNoFrame : kOk;
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    } catch (const std::bad_alloc&) {
        put_msg(msg, cap, "out of memory");
        return kCorrupt;
    }
}

void h264_dec_output(void* h, int64_t i, uint8_t* y, uint8_t* u, uint8_t* v) {
    ((Decoder*)h)->copy_out((int)i, y, u, v);
}

uint64_t h264_dec_features(void* h) { return ((Decoder*)h)->features; }

uint64_t h264_dec_modes(void* h) { return ((Decoder*)h)->modes; }

uint64_t h264_dec_features_b(void* h) { return ((Decoder*)h)->features_b; }

// the reorder depth (AVCodecContext.has_b_frames): set before the first
// packet to the depth FFmpeg's probe left in the stream's parameters
// (video_delay), read after any
int h264_dec_delay(void* h, int set) {
    Decoder* d = (Decoder*)h;
    if (set >= 0) d->has_b_frames = std::min(set, 16);
    return d->has_b_frames;
}

// The first SPS in ``d`` (Annex B, or an avcC record where it starts with
// 1), refused (H264_UNSUPPORTED) where it is of what the port does not
// read: info[0..1] the cropped size, [2] full range, [3] matrix, [4] chroma
// site, [5] num_units_in_tick, [6] time_scale, [7] the reorder frames (-1
// without a bitstream restriction), [8] profile; kNoFrame where there is
// none.
int h264_probe(const uint8_t* d, int64_t n, int64_t* info, char* msg, int64_t cap) {
    try {
        Decoder dec;
        dec.headers_only = true;
        dec.extradata(d, n);
        for (int i = 0; i < 32; i++) {
            const Sps& s = dec.sps[i];
            if (!s.valid) continue;
            refuse(dec.sps_refusal[i]);
            info[0] = 16 * s.mb_w - s.crop_l - s.crop_r;
            info[1] = 16 * s.mb_h - s.crop_t - s.crop_b;
            info[2] = s.full_range;
            info[3] = s.colour_description ? s.matrix : 2;
            info[4] = s.chroma_loc;
            info[5] = s.num_units_in_tick;
            info[6] = s.time_scale;
            info[7] = s.bitstream_restriction ? s.num_reorder_frames : -1;
            info[8] = s.profile;
            info[9] = s.level;
            info[10] = s.mb_w * s.mb_h;
            info[11] = s.max_num_ref_frames;
            return kOk;
        }
        return kNoFrame;
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

}  // extern "C"
