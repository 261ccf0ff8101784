// MPEG-1 and MPEG-2 video (ISO/IEC 11172-2, 13818-2): a decoder, host C++.
//
// It hands over the pictures FFmpeg 8's mpeg1video / mpeg2video decoder
// (mpeg12dec.c, as OpenCV 5.0 runs it on x86-64) gives for the same
// packets, bit for bit and in the same order:
//
//   * sequence header with its quantiser matrices, sequence extension
//     (4:2:0), sequence display extension (its matrix_coefficients), GOP
//     header, picture header (MPEG-1's full_pel and f_codes), picture coding
//     extension (frame pictures), quant matrix extension;
//   * slices; macroblock address increments with escape and stuffing;
//     skipped macroblocks (a P-picture's copy the reference with a zero
//     vector, a B-picture's repeat the previous macroblock's vectors and
//     direction); I, P and B macroblock types; coded block patterns;
//   * tables B-14 and B-15, MPEG-1's 8/16-bit escape and MPEG-2's 12-bit
//     one, DC differentials and their resets; MPEG-1's oddification (with
//     FFmpeg's (level - 1) | 1, which turns a 0 into -1), MPEG-2's mismatch
//     control, the linear and non-linear quantiser scales;
//   * vector prediction and wrapping per f_code; forward, backward and
//     averaged half-pel prediction (FFmpeg's rounded hpeldsp: its x86 SIMD
//     versions of these are exact); FFmpeg's simple IDCT (ffmpeg_dsp.h);
//   * display order as FFmpeg gives it: a B-picture (or any picture of a
//     low_delay sequence) is handed over when it is decoded, an I- or
//     P-picture when the next one arrives, the last at the end of the
//     stream; a P-picture without a reference and before any sync point,
//     and a B-picture without a forward reference in an open GOP, are
//     dropped as FFmpeg drops them after a seek;
//   * a picture its packet ends before its last slice (slice_end at the
//     packet's end; a slice whose end-of-slice code lies past the data
//     fails): an I- or P-picture concealed as error_resilience.c conceals
//     it (mpegc::ErrorResilience); slices before any picture header in a
//     packet passed over.
//
// Interlaced coding (field pictures, interlaced frames, field and
// dual-prime prediction, field DCT), 4:2:2 and 4:4:4, D-pictures, scalable
// extensions and repeated fields are refused with M12_UNSUPPORTED and a
// message naming the feature; damaged data (a vector that leaves the
// picture among it) with M12_CORRUPT.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "ffmpeg_dsp.h"
#include "mpeg_common.h"

namespace {

using namespace mpegc;

enum { M12_OK = kOk, M12_NO_FRAME = kNoFrame, M12_UNSUPPORTED = kUnsupported,
       M12_CORRUPT = kCorrupt };

// the start codes that are not slices
enum : uint32_t { PICTURE = 0x00, SEQUENCE = 0xB3, EXTENSION = 0xB5, SEQUENCE_END = 0xB7, GOP = 0xB8 };

// the decoder's feature bits (runtime/mpeg12.FEATURES, in order)
enum Feature {
    F_MPEG1, F_MPEG2, F_P_PICTURES, F_B_PICTURES, F_SKIPPED_P, F_SKIPPED_B,
    F_INTRA_MATRIX, F_INTER_MATRIX, F_QUANT_MATRIX_EXT, F_ALTERNATE_SCAN,
    F_INTRA_VLC_FORMAT, F_Q_SCALE_TYPE, F_DC_PRECISION_9, F_DC_PRECISION_10,
    F_DC_PRECISION_11, F_CONCEALMENT_MV, F_COLOUR_DESCRIPTION, F_OPEN_GOP,
    F_BROKEN_LINK, F_LOW_DELAY, F_FULL_PEL, F_ESCAPE, F_ESCAPE_LONG,
    F_MB_QUANT, F_MB_ESCAPE, F_MB_STUFFING, F_FORWARD, F_BACKWARD,
    F_BIDIRECTIONAL, F_NO_MC, F_FRAME_MOTION_TYPE, F_INTERLACED_SEQUENCE,
    F_ODDIFY_ZERO, F_MISMATCH, F_SIZE_CHANGE
};

// ------------------------------------------------------------------ tables

// macroblock_address_increment 1..33, then escape (33), stuffing (34) and
// the 8 zero bits that end a slice (35)
const Code kMbAddrIncr[36] = {
    {0x1, 1},   {0x3, 3},   {0x2, 3},   {0x3, 4},   {0x2, 4},   {0x3, 5},
    {0x2, 5},   {0x7, 7},   {0x6, 7},   {0xb, 8},   {0xa, 8},   {0x9, 8},
    {0x8, 8},   {0x7, 8},   {0x6, 8},   {0x17, 10}, {0x16, 10}, {0x15, 10},
    {0x14, 10}, {0x13, 10}, {0x12, 10}, {0x23, 11}, {0x22, 11}, {0x21, 11},
    {0x20, 11}, {0x1f, 11}, {0x1e, 11}, {0x1d, 11}, {0x1c, 11}, {0x1b, 11},
    {0x1a, 11}, {0x19, 11}, {0x18, 11}, {0x8, 11},  {0xf, 11},  {0x0, 8}};

// coded_block_pattern 0..63 (table B-9)
const Code kCbp[64] = {
    {0x1, 9},  {0xb, 5},  {0x9, 5},  {0xd, 6},  {0xd, 4},  {0x17, 7}, {0x13, 7}, {0x1f, 8},
    {0xc, 4},  {0x16, 7}, {0x12, 7}, {0x1e, 8}, {0x13, 5}, {0x1b, 8}, {0x17, 8}, {0x13, 8},
    {0xb, 4},  {0x15, 7}, {0x11, 7}, {0x1d, 8}, {0x11, 5}, {0x19, 8}, {0x15, 8}, {0x11, 8},
    {0xf, 6},  {0xf, 8},  {0xd, 8},  {0x3, 9},  {0xf, 5},  {0xb, 8},  {0x7, 8},  {0x7, 9},
    {0xa, 4},  {0x14, 7}, {0x10, 7}, {0x1c, 8}, {0xe, 6},  {0xe, 8},  {0xc, 8},  {0x2, 9},
    {0x10, 5}, {0x18, 8}, {0x14, 8}, {0x10, 8}, {0xe, 5},  {0xa, 8},  {0x6, 8},  {0x6, 9},
    {0x12, 5}, {0x1a, 8}, {0x16, 8}, {0x12, 8}, {0xd, 5},  {0x9, 8},  {0x5, 8},  {0x5, 9},
    {0xc, 5},  {0x8, 8},  {0x4, 8},  {0x4, 9},  {0x7, 3},  {0xa, 5},  {0x8, 5},  {0xc, 6}};

// motion_code magnitude 0..16 (table B-10, the sign bit follows)
const Code kMotion[17] = {
    {0x1, 1},  {0x1, 2},  {0x1, 3},  {0x1, 4},  {0x3, 6},  {0x5, 7},
    {0x4, 7},  {0x3, 7},  {0xb, 9},  {0xa, 9},  {0x9, 9},  {0x11, 10},
    {0x10, 10}, {0xf, 10}, {0xe, 10}, {0xd, 10}, {0xc, 10}};

// macroblock_type: flags of each code (tables B-2, B-3, B-4)
enum MbFlags { QUANT = 1, FWD = 2, BWD = 4, PATTERN = 8, INTRA = 16 };
const Code kMbTypeI[2] = {{0x1, 1}, {0x1, 2}};
const int kMbFlagsI[2] = {INTRA, INTRA | QUANT};
const Code kMbTypeP[7] = {{0x1, 1}, {0x1, 2}, {0x1, 3}, {0x3, 5},
                          {0x2, 5}, {0x1, 5}, {0x1, 6}};
const int kMbFlagsP[7] = {FWD | PATTERN, PATTERN, FWD, INTRA,
                          QUANT | FWD | PATTERN, QUANT | PATTERN, QUANT | INTRA};
const Code kMbTypeB[11] = {{0x2, 2}, {0x3, 2}, {0x2, 3}, {0x3, 3}, {0x2, 4}, {0x3, 4},
                           {0x3, 5}, {0x2, 5}, {0x3, 6}, {0x2, 6}, {0x1, 6}};
const int kMbFlagsB[11] = {FWD | BWD, FWD | BWD | PATTERN, BWD, BWD | PATTERN, FWD,
                           FWD | PATTERN, INTRA, QUANT | FWD | BWD | PATTERN,
                           QUANT | FWD | PATTERN, QUANT | BWD | PATTERN, QUANT | INTRA};

// DCT coefficients, tables B-14 (MPEG-1, and MPEG-2 with intra_vlc_format
// 0) and B-15 (MPEG-2 intra blocks with intra_vlc_format 1): 111 (run,
// level) codes in kRun/kLevel's order, then the escape and the end of block
const Code kCoefB14[113] = {
    {0x3, 2},   {0x4, 4},   {0x5, 5},   {0x6, 7},   {0x26, 8},  {0x21, 8},  {0xa, 10},
    {0x1d, 12}, {0x18, 12}, {0x13, 12}, {0x10, 12}, {0x1a, 13}, {0x19, 13}, {0x18, 13},
    {0x17, 13}, {0x1f, 14}, {0x1e, 14}, {0x1d, 14}, {0x1c, 14}, {0x1b, 14}, {0x1a, 14},
    {0x19, 14}, {0x18, 14}, {0x17, 14}, {0x16, 14}, {0x15, 14}, {0x14, 14}, {0x13, 14},
    {0x12, 14}, {0x11, 14}, {0x10, 14}, {0x18, 15}, {0x17, 15}, {0x16, 15}, {0x15, 15},
    {0x14, 15}, {0x13, 15}, {0x12, 15}, {0x11, 15}, {0x10, 15}, {0x3, 3},   {0x6, 6},
    {0x25, 8},  {0xc, 10},  {0x1b, 12}, {0x16, 13}, {0x15, 13}, {0x1f, 15}, {0x1e, 15},
    {0x1d, 15}, {0x1c, 15}, {0x1b, 15}, {0x1a, 15}, {0x19, 15}, {0x13, 16}, {0x12, 16},
    {0x11, 16}, {0x10, 16}, {0x5, 4},   {0x4, 7},   {0xb, 10},  {0x14, 12}, {0x14, 13},
    {0x7, 5},   {0x24, 8},  {0x1c, 12}, {0x13, 13}, {0x6, 5},   {0xf, 10},  {0x12, 12},
    {0x7, 6},   {0x9, 10},  {0x12, 13}, {0x5, 6},   {0x1e, 12}, {0x14, 16}, {0x4, 6},
    {0x15, 12}, {0x7, 7},   {0x11, 12}, {0x5, 7},   {0x11, 13}, {0x27, 8},  {0x10, 13},
    {0x23, 8},  {0x1a, 16}, {0x22, 8},  {0x19, 16}, {0x20, 8},  {0x18, 16}, {0xe, 10},
    {0x17, 16}, {0xd, 10},  {0x16, 16}, {0x8, 10},  {0x15, 16}, {0x1f, 12}, {0x1a, 12},
    {0x19, 12}, {0x17, 12}, {0x16, 12}, {0x1f, 13}, {0x1e, 13}, {0x1d, 13}, {0x1c, 13},
    {0x1b, 13}, {0x1f, 16}, {0x1e, 16}, {0x1d, 16}, {0x1c, 16}, {0x1b, 16}, {0x1, 6},
    {0x2, 2}};
const Code kCoefB15[113] = {
    {0x2, 2},   {0x6, 3},   {0x7, 4},   {0x1c, 5},  {0x1d, 5},  {0x5, 6},   {0x4, 6},
    {0x7b, 7},  {0x7c, 7},  {0x23, 8},  {0x22, 8},  {0xfa, 8},  {0xfb, 8},  {0xfe, 8},
    {0xff, 8},  {0x1f, 14}, {0x1e, 14}, {0x1d, 14}, {0x1c, 14}, {0x1b, 14}, {0x1a, 14},
    {0x19, 14}, {0x18, 14}, {0x17, 14}, {0x16, 14}, {0x15, 14}, {0x14, 14}, {0x13, 14},
    {0x12, 14}, {0x11, 14}, {0x10, 14}, {0x18, 15}, {0x17, 15}, {0x16, 15}, {0x15, 15},
    {0x14, 15}, {0x13, 15}, {0x12, 15}, {0x11, 15}, {0x10, 15}, {0x2, 3},   {0x6, 5},
    {0x79, 7},  {0x27, 8},  {0x20, 8},  {0x16, 13}, {0x15, 13}, {0x1f, 15}, {0x1e, 15},
    {0x1d, 15}, {0x1c, 15}, {0x1b, 15}, {0x1a, 15}, {0x19, 15}, {0x13, 16}, {0x12, 16},
    {0x11, 16}, {0x10, 16}, {0x5, 5},   {0x7, 7},   {0xfc, 8},  {0xc, 10},  {0x14, 13},
    {0x7, 5},   {0x26, 8},  {0x1c, 12}, {0x13, 13}, {0x6, 6},   {0xfd, 8},  {0x12, 12},
    {0x7, 6},   {0x4, 9},   {0x12, 13}, {0x6, 7},   {0x1e, 12}, {0x14, 16}, {0x4, 7},
    {0x15, 12}, {0x5, 7},   {0x11, 12}, {0x78, 7},  {0x11, 13}, {0x7a, 7},  {0x10, 13},
    {0x21, 8},  {0x1a, 16}, {0x25, 8},  {0x19, 16}, {0x24, 8},  {0x18, 16}, {0x5, 9},
    {0x17, 16}, {0x7, 9},   {0x16, 16}, {0xd, 10},  {0x15, 16}, {0x1f, 12}, {0x1a, 12},
    {0x19, 12}, {0x17, 12}, {0x16, 12}, {0x1f, 13}, {0x1e, 13}, {0x1d, 13}, {0x1c, 13},
    {0x1b, 13}, {0x1f, 16}, {0x1e, 16}, {0x1d, 16}, {0x1c, 16}, {0x1b, 16}, {0x1, 6},
    {0x6, 4}};
constexpr int kEscape = 111, kEob = 112;

// quantiser_scale for q_scale_type 1 (table 7-6)
const int kNonLinearQ[32] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  10, 12,
                             14, 16, 18, 20, 22, 24, 28, 32, 36, 40, 44,
                             48, 52, 56, 64, 72, 80, 88, 96, 104, 112};

struct Tables {
    Vlc incr, cbp, motion, dc_luma, dc_chroma, type_i, type_p, type_b, b14, b15;
    uint8_t run[111], level[111];
    Tables() {
        incr.build(kMbAddrIncr, 36, 11);
        cbp.build(kCbp, 64, 9);
        motion.build(kMotion, 17, 10);
        dc_luma.build(kDcLuma, 12, 9);
        dc_chroma.build(kDcChroma, 12, 10);
        type_i.build(kMbTypeI, 2, 2);
        type_p.build(kMbTypeP, 7, 6);
        type_b.build(kMbTypeB, 11, 6);
        b14.build(kCoefB14, 113, 16);
        b15.build(kCoefB15, 113, 16);
        // run 0: levels 1-40, run 1: 1-18, run 2: 1-5, run 3: 1-4,
        // runs 4-6: 1-3, runs 7-16: 1-2, runs 17-31: 1
        const int max_level[32] = {40, 18, 5, 4, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                   2,  1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
        int k = 0;
        for (int r = 0; r < 32; r++)
            for (int l = 1; l <= max_level[r]; l++, k++) {
                run[k] = (uint8_t)r;
                level[k] = (uint8_t)l;
            }
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// ------------------------------------------------------------ the stream

struct Sequence {
    int width = 0, height = 0, mb_w = 0, mb_h = 0;
    bool mpeg2 = false, progressive = true, low_delay = false;
    int matrix_coefficients = 2;    // unspecified: swscale's BT.601
    // raster order, as FFmpeg keeps them (luma and chroma)
    uint16_t intra[64], inter[64], chroma_intra[64], chroma_inter[64];
};

struct PictureHeader {
    int type = 0;               // 1 I, 2 P, 3 B
    int temporal_reference = 0;
    int full_pel[2] = {0, 0};
    int f_code[2][2] = {{1, 1}, {1, 1}};
    int intra_dc_precision = 0, structure = 3;
    bool frame_pred_frame_dct = true, concealment = false, q_scale_type = false,
         intra_vlc_format = false, alternate_scan = false;
};

// a decoded picture, with the number of the packet it came in
struct Ref : Picture {
    int64_t serial = -1;
};
using Pic = std::shared_ptr<Ref>;

struct Decoder {
    Sequence seq;
    bool have_seq = false, closed_gop = false, sync = false;
    PictureHeader ph;
    Pic last, next, cur;
    Pic next_ref;               // a B-picture's backward reference
    bool last_dummy = false;
    uint64_t features = 0;
    int64_t packets = 0;        // packets decoded (extradata aside)
    std::vector<Pic> out;       // this call's pictures, in display order

    // per slice and macroblock
    BitReader br;
    int qscale = 0, last_dc[3] = {0, 0, 0};
    int last_mv[2][2] = {{0, 0}, {0, 0}}, mv[2][2] = {{0, 0}, {0, 0}};
    int mv_dir = 0;             // FWD | BWD of the last coded macroblock
    bool prev_intra = false;
    std::vector<uint8_t> decoded;   // macroblocks of the picture decoded
    std::vector<uint8_t> mb_intra;  // ... each intra or not
    // mbskip_table as FFmpeg keeps it from picture to picture: 1 for a
    // skipped macroblock or any of a B-picture (not a reference)
    std::vector<uint8_t> mbskip;
    // the slices decoded: (first macroblock, last), or (first, -1 - the one
    // after the last) for a slice that failed
    std::vector<std::pair<int, int>> slices_done;
    int16_t blk[6][64];

    void feature(Feature f) { features |= 1ull << f; }

    // ---------------------------------------------------------- headers

    void load_matrix(uint16_t* m0, uint16_t* m1, bool intra) {
        for (int i = 0; i < 64; i++) {
            int v = (int)br.get(8);
            if (!v) CORRUPT("quantiser matrix damaged (a 0 entry)");
            if (intra && i == 0) v = 8;     // FFmpeg ignores another DC step
            m0[kZigzag[i]] = (uint16_t)v;
            if (m1) m1[kZigzag[i]] = (uint16_t)v;
        }
        br.check();
    }

    void sequence_header() {
        int width = (int)br.get(12), height = (int)br.get(12);
        br.skip(4);                     // aspect_ratio_information
        br.skip(4);                     // frame_rate_code (the demuxers read it)
        br.skip(18);                    // bit_rate_value
        if (!br.get1()) CORRUPT("missing marker bit in the sequence header");
        br.skip(10 + 1);                // vbv_buffer_size, constrained_parameters
        Sequence s = seq;
        if (br.get1()) {
            load_matrix(s.chroma_intra, s.intra, true);
            feature(F_INTRA_MATRIX);
        } else {
            for (int i = 0; i < 64; i++) s.intra[i] = s.chroma_intra[i] = kDefaultIntra[i];
        }
        if (br.get1()) {
            load_matrix(s.chroma_inter, s.inter, false);
            feature(F_INTER_MATRIX);
        } else {
            for (int i = 0; i < 64; i++) s.inter[i] = s.chroma_inter[i] = 16;
        }
        br.check();
        if (!width || !height) CORRUPT("sequence header of size %dx%d", width, height);
        if (have_seq && (width != (seq.width & 0xfff) || height != (seq.height & 0xfff))) {
            // FFmpeg reinitialises its context at the new size: the
            // reference pictures go, the one held back for display too
            feature(F_SIZE_CHANGE);
            last.reset();
            next.reset();
            last_dummy = false;
        }
        s.width = width;
        s.height = height;
        s.mpeg2 = false;                // until a sequence extension follows
        s.progressive = true;
        s.low_delay = false;
        seq = s;
        set_size();
        have_seq = true;
    }

    void set_size() {
        if (seq.height > 2800) UNSUPPORTED("a picture over 2800 lines (slice_vertical_position_extension)");
        seq.mb_w = (seq.width + 15) / 16;
        seq.mb_h = seq.mpeg2 && !seq.progressive ? 2 * ((seq.height + 31) / 32)
                                                 : (seq.height + 15) / 16;
    }

    void sequence_extension() {
        br.skip(1);                     // escape bit of profile_and_level
        int profile = (int)br.get(3);
        br.skip(4);                     // level
        seq.progressive = br.get1();
        int chroma = (int)br.get(2);
        if (!chroma) chroma = 1;        // FFmpeg takes 0 for 4:2:0
        if (chroma != 1)
            UNSUPPORTED("chroma_format %s (the port reads 4:2:0)", chroma == 2 ? "4:2:2" : "4:4:4");
        if (profile == 1 || profile == 2 || profile == 3)
            UNSUPPORTED("a scalable MPEG-2 profile (profile %d)", profile);
        int hext = (int)br.get(2), vext = (int)br.get(2);
        seq.width = (seq.width & 0xfff) | hext << 12;
        seq.height = (seq.height & 0xfff) | vext << 12;
        br.skip(12);                    // bit_rate_extension
        br.skip(1);                     // marker
        br.skip(8);                     // vbv_buffer_size_extension
        seq.low_delay = br.get1();
        br.skip(2 + 5);                 // frame_rate_extension_n, _d
        seq.mpeg2 = true;
        if (!seq.progressive) feature(F_INTERLACED_SEQUENCE);
        if (seq.low_delay) feature(F_LOW_DELAY);
        set_size();
    }

    void sequence_display_extension() {
        br.skip(3);                     // video_format
        if (br.get1()) {                // colour_description
            br.skip(8 + 8);             // colour_primaries, transfer_characteristics
            seq.matrix_coefficients = (int)br.get(8);
            feature(F_COLOUR_DESCRIPTION);
        }
    }

    void quant_matrix_extension() {
        feature(F_QUANT_MATRIX_EXT);
        if (br.get1()) load_matrix(seq.chroma_intra, seq.intra, true);
        if (br.get1()) load_matrix(seq.chroma_inter, seq.inter, false);
        if (br.get1()) load_matrix(seq.chroma_intra, nullptr, true);
        if (br.get1()) load_matrix(seq.chroma_inter, nullptr, false);
    }

    void gop_header() {
        br.skip(25);                    // time_code
        closed_gop = br.get1();
        if (br.get1()) feature(F_BROKEN_LINK);   // read, and ignored, as FFmpeg does
        if (!closed_gop) feature(F_OPEN_GOP);
        sync = true;
    }

    // false: a picture FFmpeg does not decode (no such type)
    bool picture_header() {
        PictureHeader p;
        p.temporal_reference = (int)br.get(10);
        p.type = (int)br.get(3);
        br.skip(16);                    // vbv_delay
        if (p.type == 4) UNSUPPORTED("D-pictures (MPEG-1 DC-coded pictures)");
        if (p.type < 1 || p.type > 3) CORRUPT("picture_coding_type %d", p.type);
        if (p.type >= 2) {
            p.full_pel[0] = br.get1();
            int f = (int)br.get(3);
            f += !f;
            p.f_code[0][0] = p.f_code[0][1] = f;
        }
        if (p.type == 3) {
            p.full_pel[1] = br.get1();
            int f = (int)br.get(3);
            f += !f;
            p.f_code[1][0] = p.f_code[1][1] = f;
        }
        br.check();
        if (p.full_pel[0] || p.full_pel[1]) feature(F_FULL_PEL);
        ph = p;
        return true;
    }

    void picture_coding_extension() {
        ph.full_pel[0] = ph.full_pel[1] = 0;
        for (int i = 0; i < 2; i++)
            for (int j = 0; j < 2; j++) {
                int f = (int)br.get(4);
                ph.f_code[i][j] = f + !f;
            }
        ph.intra_dc_precision = (int)br.get(2);
        ph.structure = (int)br.get(2);
        br.skip(1);                     // top_field_first
        ph.frame_pred_frame_dct = br.get1();
        ph.concealment = br.get1();
        ph.q_scale_type = br.get1();
        ph.intra_vlc_format = br.get1();
        ph.alternate_scan = br.get1();
        int rff = br.get1();
        br.skip(1);                     // chroma_420_type
        int progressive_frame = br.get1();
        if (ph.structure != 3)
            UNSUPPORTED("field pictures (interlaced MPEG-2, picture_structure %d)", ph.structure);
        if (rff) UNSUPPORTED("repeat_first_field (pulldown)");
        if (!progressive_frame)
            UNSUPPORTED("interlaced frames (progressive_frame 0; swscale does not "
                        "convert them for OpenCV)");
        if (ph.concealment) feature(F_CONCEALMENT_MV);
        if (ph.q_scale_type) feature(F_Q_SCALE_TYPE);
        if (ph.intra_vlc_format) feature(F_INTRA_VLC_FORMAT);
        if (ph.alternate_scan) feature(F_ALTERNATE_SCAN);
        if (ph.intra_dc_precision) feature((Feature)(F_DC_PRECISION_9 + ph.intra_dc_precision - 1));
    }

    void extension(bool after_picture, bool picture_seen) {
        int id = (int)br.get(4);
        switch (id) {
            case 1:
                if (!after_picture && !picture_seen) sequence_extension();
                break;
            case 2: sequence_display_extension(); break;
            case 3: quant_matrix_extension(); break;
            case 5: UNSUPPORTED("a sequence scalable extension (scalable MPEG-2)");
            case 8:
                if (after_picture) picture_coding_extension();
                break;
            case 9: UNSUPPORTED("a picture spatial scalable extension (scalable MPEG-2)");
            case 10: UNSUPPORTED("a picture temporal scalable extension (scalable MPEG-2)");
            default: break;             // picture display, copyright, ...: not needed
        }
    }

    // ------------------------------------------------------- macroblocks

    int get_qscale() {
        int code = (int)br.get(5);
        return ph.q_scale_type ? kNonLinearQ[code] : code << 1;
    }

    int decode_dc(int component) {
        const Tables& t = tables();
        int size = br.vlc(component ? t.dc_chroma : t.dc_luma);
        if (!size) return 0;
        int v = (int)br.get(size);
        return (v >> (size - 1)) ? v : v - (1 << size) + 1;
    }

    // one (run, level) code; returns the code's index (kEscape, kEob or a
    // run/level pair) and leaves the sign bit unread
    int coef(bool b15) {
        const Tables& t = tables();
        return br.vlc(b15 ? t.b15 : t.b14);
    }
    bool next_is_eob14() const { return br.show(2) == 2; }

    static int16_t wrap16(int v) { return (int16_t)(uint16_t)(unsigned)v; }

    void block_intra(int n, int16_t* b) {
        const Tables& t = tables();
        const uint8_t* scan = ph.alternate_scan ? kAltVertical : kZigzag;
        int component = n < 4 ? 0 : n - 3;
        int dc = last_dc[component] + decode_dc(component);
        last_dc[component] = dc;
        if (!seq.mpeg2) {
            // ff_mpeg1_decode_block_intra
            const uint16_t* qm = seq.intra;
            b[0] = wrap16(dc * qm[0]);
            int i = 0;
            if (next_is_eob14()) {
                br.skip(2);
                br.check();
                return;
            }
            for (;;) {
                int c = coef(false);
                int level, j;
                if (c != kEscape) {
                    if (c == kEob) CORRUPT("misplaced end of block");
                    i += t.run[c] + 1;
                    if (i > 63) CORRUPT("ac-tex damaged (intra block)");
                    j = scan[i];
                    level = (t.level[c] * qscale * qm[j]) >> 4;
                    if (!level) feature(F_ODDIFY_ZERO);
                    level = (level - 1) | 1;
                    if (br.get1()) level = -level;
                } else {
                    int run = (int)br.get(6) + 1;
                    level = (int)(int8_t)br.get(8);
                    feature(F_ESCAPE);
                    if (level == -128) {
                        level = (int)br.get(8) - 256;
                        feature(F_ESCAPE_LONG);
                    } else if (level == 0) {
                        level = (int)br.get(8);
                        feature(F_ESCAPE_LONG);
                    }
                    i += run;
                    if (i > 63) CORRUPT("ac-tex damaged (intra block)");
                    j = scan[i];
                    bool neg = level < 0;
                    level = ((neg ? -level : level) * qscale * qm[j]) >> 4;
                    if (!level) feature(F_ODDIFY_ZERO);
                    level = (level - 1) | 1;
                    if (neg) level = -level;
                }
                b[j] = wrap16(level);
                if (next_is_eob14()) break;
            }
            br.skip(2);
            br.check();
            return;
        }
        // mpeg2_decode_block_intra
        const uint16_t* qm = n < 4 ? seq.intra : seq.chroma_intra;
        b[0] = wrap16(dc * (1 << (3 - ph.intra_dc_precision)));
        int mismatch = b[0] ^ 1;
        int i = 0;
        for (;;) {
            int c = coef(ph.intra_vlc_format);
            if (c == kEob) break;
            int level, j;
            if (c != kEscape) {
                i += t.run[c] + 1;
                if (i > 63) CORRUPT("ac-tex damaged (intra block)");
                j = scan[i];
                level = (t.level[c] * qscale * qm[j]) >> 4;
                if (br.get1()) level = -level;
            } else {
                int run = (int)br.get(6) + 1;
                int v = (int)br.get(12);
                level = v >= 2048 ? v - 4096 : v;
                feature(F_ESCAPE);
                i += run;
                if (i > 63) CORRUPT("ac-tex damaged (intra block)");
                j = scan[i];
                level = level < 0 ? -((-level * qscale * qm[j]) >> 4)
                                  : (level * qscale * qm[j]) >> 4;
            }
            mismatch ^= level;
            b[j] = wrap16(level);
        }
        br.check();
        if (!(mismatch & 1)) feature(F_MISMATCH);
        b[63] ^= mismatch & 1;
    }

    void block_inter(int n, int16_t* b) {
        const Tables& t = tables();
        const uint8_t* scan = ph.alternate_scan ? kAltVertical : kZigzag;
        const bool m2 = seq.mpeg2;
        const uint16_t* qm = !m2 || n < 4 ? seq.inter : seq.chroma_inter;
        int mismatch = 1;
        int i = -1;
        auto put = [&](int j, int level) {
            mismatch ^= level;
            b[j] = wrap16(level);
        };
        // a first code '1s' is run 0, level 1
        if (br.show(1)) {
            int level = (3 * qscale * qm[0]) >> 5;
            if (!m2) {
                if (!level) feature(F_ODDIFY_ZERO);
                level = (level - 1) | 1;
            }
            br.skip(1);
            if (br.get1()) level = -level;
            put(0, level);
            i = 0;
            if (next_is_eob14()) goto end;
        }
        for (;;) {
            int c = coef(false);
            int level, j;
            if (c == kEob) CORRUPT("misplaced end of block");
            if (c != kEscape) {
                i += t.run[c] + 1;
                if (i > 63) CORRUPT("ac-tex damaged (inter block)");
                j = scan[i];
                level = ((t.level[c] * 2 + 1) * qscale * qm[j]) >> 5;
                if (!m2) {
                    if (!level) feature(F_ODDIFY_ZERO);
                    level = (level - 1) | 1;
                }
                if (br.get1()) level = -level;
            } else {
                int run = (int)br.get(6) + 1;
                feature(F_ESCAPE);
                if (m2) {
                    int v = (int)br.get(12);
                    level = v >= 2048 ? v - 4096 : v;
                } else {
                    level = (int)(int8_t)br.get(8);
                    if (level == -128) {
                        level = (int)br.get(8) - 256;
                        feature(F_ESCAPE_LONG);
                    } else if (level == 0) {
                        level = (int)br.get(8);
                        feature(F_ESCAPE_LONG);
                    }
                }
                i += run;
                if (i > 63) CORRUPT("ac-tex damaged (inter block)");
                j = scan[i];
                bool neg = level < 0;
                level = (((neg ? -level : level) * 2 + 1) * qscale * qm[j]) >> 5;
                if (!m2) {
                    if (!level) feature(F_ODDIFY_ZERO);
                    level = (level - 1) | 1;
                }
                if (neg) level = -level;
            }
            put(j, level);
            if (next_is_eob14()) break;
        }
    end:
        br.skip(2);
        br.check();
        if (m2) {
            if (!(mismatch & 1)) feature(F_MISMATCH);
            b[63] ^= mismatch & 1;
        }
    }

    // mpeg_decode_motion
    int motion(int fcode, int pred) {
        int code = br.vlc(tables().motion);
        if (!code) return pred;
        int sign = br.get1();
        int shift = fcode - 1;
        int val = code;
        if (shift) {
            val = (val - 1) << shift;
            val |= (int)br.get(shift);
            val++;
        }
        if (sign) val = -val;
        val += pred;
        int bits = 5 + shift;           // sign_extend(val, 5 + shift)
        return (int)((unsigned)val << (32 - bits)) >> (32 - bits);
    }

    void read_vectors(int dir) {
        for (int k = 0; k < 2; k++) {
            int v = motion(ph.f_code[dir][k], last_mv[dir][k]);
            last_mv[dir][k] = v;
            mv[dir][k] = ph.full_pel[dir] ? v * 2 : v;
        }
    }

    // one prediction (mpeg_motion for a 16x16 frame macroblock) into dst;
    // ``avg`` averages with what dst holds (the second direction)
    void predict(const Picture& ref, int mbx, int mby, const int* v, bool avg, uint8_t* dst[3],
                 const int stride[3]) {
        const int mx = v[0], my = v[1];
        const int ew = seq.mb_w * 16, eh = seq.mb_h * 16;
        int src_x = mbx * 16 + (mx >> 1), src_y = mby * 16 + (my >> 1);
        if ((unsigned)src_x >= (unsigned)std::max(ew - (mx & 1) - 15, 0) ||
            (unsigned)src_y >= (unsigned)std::max(eh - (my & 1) - 15, 0))
            CORRUPT("a motion vector out of the picture at macroblock (%d, %d), which "
                    "FFmpeg does not predict",
                    mbx, mby);
        uint8_t tmp[16 * 16];
        mc_block(ref.p[0], ew, eh, src_x, src_y, (my & 1) << 1 | (mx & 1), 16, 16, false,
                 avg ? tmp : dst[0], avg ? 16 : stride[0]);
        if (avg) average(dst[0], stride[0], tmp, 16, 16);
        int cx = mx / 2, cy = my / 2;   // C division, as FFmpeg's
        int uv_dxy = (cy & 1) << 1 | (cx & 1);
        int ux = mbx * 8 + (cx >> 1), uy = mby * 8 + (cy >> 1);
        for (int c = 1; c < 3; c++) {
            mc_block(ref.p[c], ew / 2, eh / 2, ux, uy, uv_dxy, 8, 8, false,
                     avg ? tmp : dst[c], avg ? 8 : stride[c]);
            if (avg) average(dst[c], stride[c], tmp, 8, 8);
        }
    }

    static void average(uint8_t* d, int ds, const uint8_t* s, int ss, int n) {
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++)
                d[y * ds + x] = (uint8_t)((d[y * ds + x] + s[y * ss + x] + 1) >> 1);
    }

    void reconstruct(int mbx, int mby, bool intra, int cbp_mask) {
        mb_intra[(size_t)mby * seq.mb_w + mbx] = intra;
        Picture& p = *cur;
        uint8_t* dst[3] = {p.p[0].at(mbx * 16, mby * 16), p.p[1].at(mbx * 8, mby * 8),
                           p.p[2].at(mbx * 8, mby * 8)};
        const int stride[3] = {p.p[0].w, p.p[1].w, p.p[2].w};
        if (!intra) {
            bool fwd = mv_dir & FWD;
            if (fwd) predict(*last, mbx, mby, mv[0], false, dst, stride);
            if (mv_dir & BWD) predict(*next_ref, mbx, mby, mv[1], fwd, dst, stride);
        }
        for (int n = 0; n < 6; n++) {
            uint8_t* d = n < 4 ? dst[0] + (n >> 1) * 8 * stride[0] + (n & 1) * 8 : dst[n - 3];
            int s = n < 4 ? stride[0] : stride[n - 3];
            if (intra)
                ffdsp::idct(blk[n], d, s, false);
            else if (cbp_mask & (32 >> n))
                ffdsp::idct(blk[n], d, s, true);
        }
    }

    void reset_dc() { last_dc[0] = last_dc[1] = last_dc[2] = 128 << ph.intra_dc_precision; }

    // mpeg_decode_mb for a macroblock that is coded
    void macroblock(int mbx, int mby) {
        const Tables& t = tables();
        int flags;
        if (ph.type == 1) flags = kMbFlagsI[br.vlc(t.type_i)];
        else if (ph.type == 2) flags = kMbFlagsP[br.vlc(t.type_p)];
        else flags = kMbFlagsB[br.vlc(t.type_b)];
        if (flags & QUANT) feature(F_MB_QUANT);
        bool frame_mode = ph.frame_pred_frame_dct;
        if (flags & INTRA) {
            memset(blk, 0, sizeof blk);
            if (!frame_mode && br.get1()) UNSUPPORTED("field DCT (interlaced MPEG-2, dct_type 1)");
            if (flags & QUANT) qscale = get_qscale();
            if (ph.concealment) {
                for (int k = 0; k < 2; k++) {
                    int v = motion(ph.f_code[0][k], last_mv[0][k]);
                    last_mv[0][k] = v;
                    mv[0][k] = v;
                }
                if (!br.get1()) CORRUPT("missing marker bit after concealment_motion_vectors");
            } else {
                memset(last_mv, 0, sizeof last_mv);
            }
            for (int n = 0; n < 6; n++) block_intra(n, blk[n]);
            prev_intra = true;
            reconstruct(mbx, mby, true, 63);
            return;
        }
        if (!(flags & (FWD | BWD))) {
            // P-picture, no motion compensation: a zero forward vector
            feature(F_NO_MC);
            if (!frame_mode && br.get1()) UNSUPPORTED("field DCT (interlaced MPEG-2, dct_type 1)");
            if (flags & QUANT) qscale = get_qscale();
            mv_dir = FWD;
            memset(last_mv[0], 0, sizeof last_mv[0]);
            mv[0][0] = mv[0][1] = 0;
        } else {
            if (!frame_mode) {
                int motion_type = (int)br.get(2);
                if (motion_type == 1) UNSUPPORTED("field prediction (interlaced MPEG-2)");
                if (motion_type == 3) UNSUPPORTED("dual-prime prediction (interlaced MPEG-2)");
                if (motion_type == 0) CORRUPT("frame_motion_type 0");
                feature(F_FRAME_MOTION_TYPE);
                if ((flags & PATTERN) && br.get1())
                    UNSUPPORTED("field DCT (interlaced MPEG-2, dct_type 1)");
            }
            if (flags & QUANT) qscale = get_qscale();
            mv_dir = flags & (FWD | BWD);
            if (mv_dir == (FWD | BWD)) feature(F_BIDIRECTIONAL);
            else if (mv_dir == BWD) feature(F_BACKWARD);
            else feature(F_FORWARD);
            for (int dir = 0; dir < 2; dir++)
                if (mv_dir & (dir ? BWD : FWD)) read_vectors(dir);
        }
        prev_intra = false;
        reset_dc();
        int cbp = 0;
        if (flags & PATTERN) {
            cbp = br.vlc(t.cbp);
            if (cbp <= 0) CORRUPT("invalid coded_block_pattern %d", cbp);
            for (int n = 0; n < 6; n++)
                if (cbp & (32 >> n)) {
                    memset(blk[n], 0, sizeof blk[n]);
                    block_inter(n, blk[n]);
                }
        }
        reconstruct(mbx, mby, false, cbp);
    }

    void skipped(int mbx, int mby) {
        if (ph.type == 2) {
            feature(F_SKIPPED_P);
            mv_dir = FWD;
            mv[0][0] = mv[0][1] = 0;
            memset(last_mv[0], 0, sizeof last_mv[0]);
        } else {
            if (prev_intra) CORRUPT("a skipped macroblock after an intra one in a B-picture");
            feature(F_SKIPPED_B);
            for (int d = 0; d < 2; d++)
                for (int k = 0; k < 2; k++) mv[d][k] = last_mv[d][k];
        }
        reset_dc();
        reconstruct(mbx, mby, false, 0);
    }

    // mpeg_decode_slice: a slice from after its start code (to the end of
    // the packet: the zero bits that end a slice may be the next start
    // code's)
    void slice(int mb_y, const uint8_t* data, int64_t n) {
        const Tables& t = tables();
        if (mb_y >= seq.mb_h) CORRUPT("slice below the picture (%d >= %d)", mb_y, seq.mb_h);
        br.reset(data, n);
        reset_dc();
        memset(last_mv, 0, sizeof last_mv);
        qscale = get_qscale();
        if (!qscale) CORRUPT("qscale 0 in a slice header");
        while (br.get1()) br.skip(8);   // intra_slice_flag and extra_bit_slice
        int mb_x = 0;
        for (;;) {
            if (br.left() <= 0) CORRUPT("slice without macroblocks");
            int code = br.vlc(t.incr);
            if (code >= 33) {
                if (code == 33) {
                    mb_x += 33;
                    feature(F_MB_ESCAPE);
                } else if (code == 34) {
                    feature(F_MB_STUFFING);
                } else {
                    CORRUPT("first mb_incr damaged");
                }
            } else {
                mb_x += code;
                break;
            }
        }
        if (mb_x >= seq.mb_w) CORRUPT("initial skip overflow");
        const int first = mb_y * seq.mb_w + mb_x;
        int skip_run = 0;
        for (;;) {
            int mb_xy = mb_y * seq.mb_w + mb_x;
            if (skip_run) {
                skip_run--;
                skipped(mb_x, mb_y);
            } else {
                macroblock(mb_x, mb_y);
                skip_run = -1;
            }
            decoded[mb_xy] = 1;
            mbskip[mb_xy] = skip_run >= 0 || ph.type == 3;
            if (++mb_x >= seq.mb_w) {
                mb_x = 0;
                if (++mb_y >= seq.mb_h) {
                    int64_t left = br.left();
                    if (left < 0 || (left && br.show((int)std::min<int64_t>(left, 23))))
                        CORRUPT("end mismatch at the last macroblock");
                    slices_done.emplace_back(first, mb_xy);
                    return;
                }
            }
            if (skip_run == -1) {
                skip_run = 0;
                if (br.left() <= 0) {
                    // the packet ends with the slice: FFmpeg reads the
                    // end-of-slice code past the data ("overread") and
                    // adds the slice as failed before the next macroblock
                    slices_done.emplace_back(first, -1 - (mb_y * seq.mb_w + mb_x));
                    return;
                }
                for (;;) {
                    int c = br.vlc(t.incr);
                    if (c >= 33) {
                        if (c == 33) {
                            skip_run += 33;
                            feature(F_MB_ESCAPE);
                        } else if (c == 35) {
                            if (skip_run || br.show(15))
                                CORRUPT("slice mismatch");
                            // end of slice; read past the data, it failed
                            slices_done.emplace_back(
                                first, br.left() < 0 ? -1 - (mb_y * seq.mb_w + mb_x) : mb_xy);
                            return;
                        } else {
                            feature(F_MB_STUFFING);
                        }
                    } else {
                        skip_run += c;
                        break;
                    }
                }
                if (skip_run && ph.type == 1) CORRUPT("skipped macroblock in an I-picture");
            }
        }
    }

    // ---------------------------------------------------------- pictures

    Pic new_picture() {
        Pic p = std::make_shared<Ref>();
        p->alloc(seq.mb_w, seq.mb_h);
        p->serial = packets - 1;
        return p;
    }

    // the picture is about to be decoded (mpeg_field_start and
    // ff_mpv_frame_start): false where FFmpeg skips it
    bool start_picture() {
        if (ph.type == 3 && !last && !closed_gop)
            return false;               // open GOP, no forward reference
        if (ph.type == 1) sync = true;
        if (ph.type == 2 && !next && !sync) return false;
        if (ph.type == 1 && seq.mpeg2) feature(F_MPEG2);
        if (ph.type == 1 && !seq.mpeg2) feature(F_MPEG1);
        if (ph.type == 2) feature(F_P_PICTURES);
        if (ph.type == 3) feature(F_B_PICTURES);
        cur = new_picture();
        if (ph.type != 3) {
            last = next;
            last_dummy = false;
            next = cur;
        }
        if (!last && ph.type != 1) {
            // FFmpeg's dummy reference: mid grey, never handed over
            last = new_picture();
            for (auto& pl : last->p) std::fill(pl.d.begin(), pl.d.end(), 0x80);
            last_dummy = true;
        }
        next_ref = next;
        if (ph.type == 3 && !next) {    // a dummy backward reference
            next_ref = new_picture();
            for (auto& pl : next_ref->p) std::fill(pl.d.begin(), pl.d.end(), 0x80);
        }
        decoded.assign((size_t)seq.mb_w * seq.mb_h, 0);
        mb_intra.assign(decoded.size(), 0);
        if (mbskip.size() != decoded.size()) mbskip.assign(decoded.size(), 0);
        slices_done.clear();
        return true;
    }

    // slice_end's ff_er_frame_end over a picture whose packet ended before
    // its last slice (the slices it holds decoded, each ended whole): an I-
    // or P-picture concealed as FFmpeg conceals it (mpegc::ErrorResilience;
    // MPEG-1/2 pictures keep no vectors, so every vector FFmpeg's guess can
    // take is zero: a damaged inter macroblock is the last picture's)
    void conceal() {
        if (ph.type == 3) UNSUPPORTED("a B-picture with missing slices, which FFmpeg conceals");
        const int num = seq.mb_w * seq.mb_h;
        ErrorResilience er;
        er.start(seq.mb_w, seq.mb_h);
        for (auto& sl : slices_done) {
            if (sl.second >= 0) er.add_slice(sl.first, sl.second);
            else er.add_error(sl.first, -1 - sl.second);
        }
        std::vector<uint8_t> counted((size_t)num);
        for (int m = 0; m < num; m++) counted[m] = !mbskip[m];
        er.spread(counted);
        for (int m = 0; m < num; m++) er.is_intra[m] = decoded[m] && mb_intra[m];
        const bool intra_likely = er.intra_more_likely(*cur, last.get(), ph.type);
        for (int m = 0; m < num; m++)
            if (er.damaged(m)) er.is_intra[m] = intra_likely;
        if (last)
            for (int m = 0; m < num; m++) {
                if (er.is_intra[m] || !(er.st[m] & ErrorResilience::kMvError)) continue;
                const int x = m % seq.mb_w, y = m / seq.mb_w;
                for (int r = 0; r < 16; r++) memcpy(cur->p[0].at(16 * x, 16 * y + r), last->p[0].at(16 * x, 16 * y + r), 16);
                for (int k = 1; k < 3; k++)
                    for (int r = 0; r < 8; r++) memcpy(cur->p[k].at(8 * x, 8 * y + r), last->p[k].at(8 * x, 8 * y + r), 8);
            }
        er.finish(*cur);
    }

    void end_picture() {
        bool damaged = false;
        for (size_t i = 0; i < decoded.size(); i++) damaged |= !decoded[i];
        for (auto& sl : slices_done) damaged |= sl.second < 0;
        if (damaged) conceal();
        if (ph.type == 3 || seq.low_delay) out.push_back(cur);
        else if (last && !last_dummy) out.push_back(last);
        cur.reset();
    }

    // decode_chunks over one packet; ``extradata``: a container's codec
    // headers (its sequence header does not make a sync point)
    void decode(const uint8_t* d, int64_t n, bool extradata = false) {
        out.clear();
        if (n == 4 && d[0] == 0 && d[1] == 0 && d[2] == 1 && d[3] == SEQUENCE_END) {
            flush();                    // FFmpeg's end of stream in a packet
            return;
        }
        if (!extradata) packets++;
        bool picture = false, in_picture = false, skip = false, sliced = false;
        auto next_start = [&](int64_t from) {
            for (int64_t k = from; k + 3 < n; k++)
                if (d[k] == 0 && d[k + 1] == 0 && d[k + 2] == 1) return k;
            return n;
        };
        for (int64_t pos = next_start(0); pos < n;) {
            uint32_t code = d[pos + 3];
            int64_t body = pos + 4, end = next_start(body);
            if (code >= 0x01 && code <= 0xAF) {
                if (in_picture && !skip) {
                    if (!sliced) {
                        if ((int64_t)seq.mb_w * seq.mb_h * 11 / (33 * 2 * 8) > n)
                            CORRUPT("a picture of %lld bytes is too short", (long long)n);
                        skip = !start_picture();
                        sliced = !skip;
                    }
                    // the slice reads on into what follows, as FFmpeg's does
                    if (!skip) slice((int)code - 1, d + body, n - body);
                }
            } else {
                if (sliced) {
                    end_picture();
                    sliced = in_picture = false;
                }
                br.reset(d + body, end - body);
                switch (code) {
                    case SEQUENCE:
                        if (!picture) {
                            sequence_header();
                            sync = sync || !extradata;
                        }
                        break;
                    case EXTENSION:
                        if (have_seq) extension(in_picture, picture);
                        break;
                    case GOP:
                        if (!picture) gop_header();
                        break;
                    case PICTURE:
                        if (extradata) break;
                        if (picture)
                            CORRUPT("two pictures in one packet (FFmpeg decodes one a packet)");
                        if (!have_seq) CORRUPT("a picture before any sequence header");
                        picture_header();
                        picture = in_picture = true;
                        skip = false;
                        break;
                    default:                    // user data, sequence end, ...
                        break;
                }
            }
            pos = end;
        }
        if (sliced) end_picture();
    }

    // the end of the stream: the last reference picture
    void flush() {
        out.clear();
        if (!seq.low_delay && next) out.push_back(next);
        next.reset();
        last.reset();
    }
};

void copy_plane(const Plane& p, int w, int h, uint8_t* dst) {
    for (int y = 0; y < h; y++) memcpy(dst + (size_t)y * w, p.at(0, y), w);
}

}  // namespace

extern "C" {

void* m12_dec_new() {
    try {
        tables();
        return new Decoder();
    } catch (...) {
        return nullptr;
    }
}

void m12_dec_free(void* h) { delete static_cast<Decoder*>(h); }

// info: [0] pictures handed over, [1] width, [2] height, [3] MPEG-2 (1) or
// MPEG-1 (0), [4] matrix_coefficients, [5] low_delay, [6], [7] the number
// of the packet each picture came in (from 0, the decoder's first packet;
// at most two pictures a call).  ``mode``: 0 a
// packet, 1 the end of the stream (data is ignored), 2 a container's codec
// headers (extradata)
int m12_dec_decode(void* h, const uint8_t* data, int64_t n, int mode, int64_t* info, char* msg,
                   int64_t cap) {
    Decoder* dec = static_cast<Decoder*>(h);
    try {
        if (mode == 1) dec->flush();
        else dec->decode(data, n, mode == 2);
        info[0] = (int64_t)dec->out.size();
        info[1] = dec->seq.width;
        info[2] = dec->seq.height;
        info[3] = dec->seq.mpeg2;
        info[4] = dec->seq.matrix_coefficients;
        info[5] = dec->seq.low_delay;
        for (size_t i = 0; i < dec->out.size() && i < 2; i++) info[6 + i] = dec->out[i]->serial;
        return dec->out.empty() ? M12_NO_FRAME : M12_OK;
    } catch (const Failure& f) {
        dec->out.clear();
        put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// picture ``i`` of the last call, cropped to the sequence's size
void m12_dec_output(void* h, int64_t i, uint8_t* y, uint8_t* u, uint8_t* v) {
    Decoder* dec = static_cast<Decoder*>(h);
    const Picture& p = *dec->out[(size_t)i];
    int w = dec->seq.width, hh = dec->seq.height;
    copy_plane(p.p[0], w, hh, y);
    copy_plane(p.p[1], (w + 1) / 2, (hh + 1) / 2, u);
    copy_plane(p.p[2], (w + 1) / 2, (hh + 1) / 2, v);
}

int64_t m12_dec_features(void* h) { return (int64_t) static_cast<Decoder*>(h)->features; }

}  // extern "C"
