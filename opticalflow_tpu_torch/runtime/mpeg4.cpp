// MPEG-4 Part 2 Simple Profile video: a decoder and an encoder, host C++.
//
// The decoder reads what FFmpeg's mpeg4 encoder writes (``cv2.VideoWriter``
// with fourcc mp4v, XVID or FMP4) and hands over the pixels FFmpeg's decoder
// gives for it, bit for bit:
//
//   * rectangular progressive VOLs; I-, P- and not-coded VOPs;
//   * the MCBPC, CBPY, MVD, DC-size and TCOEF VLCs with their three escapes;
//   * intra DC/AC prediction, H.263 and MPEG quantisation (the VOL's own
//     matrices), 1MV and 4MV half-pel motion compensation with
//     vop_rounding_type, unrestricted vectors over edge-clamped references;
//   * video packets (resync markers) and in-band VOL headers.
//
// Where FFmpeg departs from the letter of the standard, this code follows
// FFmpeg (its mpeg4videodec.c, h263.c and mpegvideo_motion.c): the
// availability rules of DC and motion-vector prediction at a packet's first
// row, the 4MV clipping of luma and chroma source positions, its simple
// integer IDCT (simple_idct_template.c, 8-bit), and the x86 SIMD half-pel
// averages it runs without AV_CODEC_FLAG_BITEXACT.
//
// The encoder writes an I-VOP every 12 frames (kGop, as cv2.VideoWriter's
// mp4v writer does) and P-VOPs between them:
// 1MV half-pel motion search, H.263 quantisation at a fixed quantiser, no
// user data.  Its reconstruction is this file's decoder run on its own
// output, so a decoder that matches FFmpeg decodes the stream to the
// encoder's reconstruction bit for bit.
//
// Also here: YUV 4:2:0 -> BGR24 in swscale's arithmetic (its x86 SIMD
// yuv2rgb path, which cv2.VideoCapture's frames go through; ffmpeg_dsp.h,
// with the IDCT), and BGR24 or RGB24 -> I420 in OpenCV's cvtColor
// arithmetic (the port's io/yuv.rgb_to_i420, its numpy reference).
//
// Everything outside the Simple Profile (B-VOPs, interlace, quarter-pel,
// GMC/sprites, shape coding, data partitioning, studio and N-bit profiles)
// is refused with OM4_UNSUPPORTED and a message naming the feature.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "ffmpeg_dsp.h"
#include "mpeg_common.h"

namespace {

using namespace mpegc;

enum { OM4_OK = kOk, OM4_NO_FRAME = kNoFrame, OM4_UNSUPPORTED = kUnsupported,
       OM4_CORRUPT = kCorrupt };

// ------------------------------------------------------------------ tables

const uint8_t kDefaultIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

const int kDcThreshold[8] = {32, 13, 15, 17, 19, 21, 23, 0};

int y_dc_scale(int q) {
    return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16;
}
int c_dc_scale(int q) { return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6; }

struct Tables {
    Vlc intra_mcbpc, inter_mcbpc, cbpy, mvd, dc_lum, dc_chrom;
    RunLevel inter, intra;
    Tables() {
        intra_mcbpc.build(kIntraMcbpc, 9, 9);
        inter_mcbpc.build(kInterMcbpc, 28, 13);
        cbpy.build(kCbpy, 16, 6);
        mvd.build(kMvd, 33, 12);
        dc_lum.build(kDcLum, 13, 11);
        dc_chrom.build(kDcChrom, 13, 12);
        inter.build(kInterTcoef, kInterMaxLevel0, 27, kInterMaxLevel1, 41);
        intra.build(kIntraTcoef, kIntraMaxLevel0, 15, kIntraMaxLevel1, 21);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

struct BitWriter {
    std::vector<uint8_t> out;
    uint64_t acc = 0;
    int n = 0;
    void put(int bits, uint32_t v) {
        if (!bits) return;
        acc = (acc << bits) | (v & ((bits == 32) ? 0xffffffffu : ((1u << bits) - 1)));
        n += bits;
        while (n >= 8) {
            out.push_back((uint8_t)(acc >> (n - 8)));
            n -= 8;
        }
    }
    void put(const Code& c) { put(c.bits, c.code); }
    // next_start_code(): a zero, then ones up to the byte boundary
    void stuff() {
        put(1, 0);
        while (n) put(1, 1);
    }
    void start_code(uint32_t code) {
        put(24, 1);
        put(8, code & 0xff);
    }
};

// ------------------------------------------------------------------ IDCT
// FFmpeg's simple IDCT (ffmpeg_dsp.h, shared with jpeg.cpp)

using ffdsp::clip8;
using ffdsp::idct;

// ------------------------------------------------------------ VOL / VOP

struct Vol {
    bool valid = false;
    int width = 0, height = 0, mb_w = 0, mb_h = 0, mb_num = 0;
    int time_bits = 1;
    int time_res = 0;
    bool mpeg_quant = false;
    bool resync_marker = true;   // !resync_marker_disable
    uint8_t intra_m[64], inter_m[64];   // raster order
};

// bits to code 0..n-1 (at least 1): FFmpeg's av_log2(n - 1) + 1, the
// width of vop_time_increment and of a video packet's macroblock number
int bits_for(int n) {
    int b = 1;
    while ((1 << b) < n) b++;
    return b;
}

void read_matrix(BitReader& br, uint8_t* m) {
    int last = 0, i = 0;
    for (; i < 64; i++) {
        int v = (int)br.get(8);
        if (!v) break;
        last = v;
        m[kZigzag[i]] = (uint8_t)v;
    }
    if (i == 0) CORRUPT("quantiser matrix starts with 0");
    for (; i < 64; i++) m[kZigzag[i]] = (uint8_t)last;
}

// video_object_layer(): the fields after the start code
Vol parse_vol(BitReader& br) {
    Vol v;
    br.skip(1);                         // random_accessible_vol
    int type = (int)br.get(8);
    if (type == 0x12)
        UNSUPPORTED("the Fine Granularity Scalable profile");
    int verid = 1;
    if (br.get1()) {                    // is_object_layer_identifier
        verid = (int)br.get(4);
        br.skip(3);
    }
    if (br.get(4) == 15) br.skip(16);   // extended PAR
    if (br.get1()) {                    // vol_control_parameters
        int chroma = (int)br.get(2);
        if (chroma != 1) UNSUPPORTED("chroma format %d (only 4:2:0 is read)", chroma);
        int low_delay = br.get1();
        (void)low_delay;
        if (br.get1()) br.skip(79);     // vbv_parameters (with markers)
    }
    int shape = (int)br.get(2);
    if (shape != 0) UNSUPPORTED("shape coding (video_object_layer_shape %d)", shape);
    if (verid != 1 && shape == 3) br.skip(4);
    br.marker("before time_increment_resolution");
    v.time_res = (int)br.get(16);
    if (!v.time_res) CORRUPT("vop_time_increment_resolution is 0");
    v.time_bits = bits_for(v.time_res);
    br.marker("after time_increment_resolution");
    if (br.get1()) br.skip(v.time_bits);   // fixed_vop_rate
    br.marker("before width");
    v.width = (int)br.get(13);
    br.marker("before height");
    v.height = (int)br.get(13);
    br.marker("after height");
    if (!v.width || !v.height) CORRUPT("VOL of size %dx%d", v.width, v.height);
    if (br.get1()) UNSUPPORTED("interlaced video");
    if (!br.get1()) UNSUPPORTED("overlapped block motion compensation");
    int sprite = (int)br.get(verid == 1 ? 1 : 2);
    if (sprite) UNSUPPORTED("sprites / global motion compensation (sprite_enable %d)", sprite);
    if (br.get1()) UNSUPPORTED("N-bit video (not_8_bit)");
    v.mpeg_quant = br.get1();
    memcpy(v.intra_m, kDefaultIntraMatrix, 64);
    memcpy(v.inter_m, kDefaultInterMatrix, 64);
    if (v.mpeg_quant) {
        if (br.get1()) read_matrix(br, v.intra_m);
        if (br.get1()) read_matrix(br, v.inter_m);
    }
    if (verid != 1 && br.get1()) UNSUPPORTED("quarter-pel motion compensation");
    if (!br.get1()) UNSUPPORTED("complexity estimation headers");
    // resync_marker_disable: packets are found either way; FFmpeg's
    // no-padding workaround reads the flag
    v.resync_marker = !br.get1();
    if (br.get1()) UNSUPPORTED("data partitioning / reversible VLC");
    if (verid != 1) {
        if (br.get1()) UNSUPPORTED("NEWPRED");
        if (br.get1()) UNSUPPORTED("reduced-resolution VOPs");
    }
    if (br.get1()) UNSUPPORTED("scalability");
    br.check();
    v.mb_w = (v.width + 15) / 16;
    v.mb_h = (v.height + 15) / 16;
    v.mb_num = v.mb_w * v.mb_h;
    v.valid = true;
    return v;
}

// ---------------------------------------------------- prediction state
// DC, AC and motion-vector predictors of the macroblocks decoded so far in
// a VOP, and the packet (slice) the current macroblock belongs to.  Blocks
// are addressed on an 8x8 grid with a border row on top and a border
// column on either side that is never written: DC 1024, AC and MVs 0.

struct Pred : MvPred {
    int cs = 0;
    std::vector<int> dc[3];
    std::vector<int16_t> ac[3];     // 16 a block: [1..7] column 0, [9..15] row 0
    std::vector<uint8_t> qs;        // a macroblock's quantiser

    void init(int w, int h) {
        init_mv(w, h);
        cs = w + 2;
        size_t ln = (size_t)ls * (2 * h + 1), cn = (size_t)cs * (h + 1);
        dc[0].assign(ln, 1024);
        dc[1].assign(cn, 1024);
        dc[2].assign(cn, 1024);
        ac[0].assign(ln * 16, 0);
        ac[1].assign(cn * 16, 0);
        ac[2].assign(cn * 16, 0);
        qs.assign((size_t)w * h, 1);
    }
    // (plane, grid index, grid stride) of block n of macroblock (x, y)
    int plane(int n) const { return n < 4 ? 0 : n - 3; }
    int index(int n, int x, int y) const {
        if (n < 4) return block(n, x, y);
        return (y + 1) * cs + x + 1;
    }
    int wrap(int n) const { return n < 4 ? ls : cs; }

    // a new packet starts at macroblock (x, y): ff_mpeg4_clean_buffers
    // zeroes the AC of the blocks before it on its rows (its predictors)
    void start_packet(int x, int y) {
        resync_x = x;
        resync_y = y;
        first_line = true;
        // luma: block row 2y-1 from column 2x-1, row 2y, row 2y+1 to 2x-1
        auto clear = [&](int p, int stride, int row, int c0, int c1) {
            if (row < 0) return;
            for (int c = c0; c <= c1; c++)
                memset(&ac[p][((size_t)(row + 1) * stride + c + 1) * 16], 0,
                       16 * sizeof(int16_t));
        };
        clear(0, ls, 2 * y - 1, 2 * x - 1, 2 * mb_w - 1);
        clear(0, ls, 2 * y, -1, 2 * mb_w - 1);
        clear(0, ls, 2 * y + 1, -1, 2 * x - 1);
        for (int p = 1; p < 3; p++) {
            clear(p, cs, y - 1, x - 1, mb_w - 1);
            clear(p, cs, y, -1, x - 1);
        }
    }
    void next_mb(int x, int y) {
        if (x == resync_x && y == resync_y + 1) first_line = false;
    }

    // ff_mpeg4_pred_dc: the prediction (in quantised units) and direction
    // (0 left, 1 top) of block n's DC
    int pred_dc(int n, int x, int y, int scale, int* dir) const {
        const int* d = &dc[plane(n)][index(n, x, y)];
        int w = wrap(n);
        int a = d[-1], b = d[-1 - w], c = d[-w];
        if (first_line && n != 3) {
            if (n != 2) b = c = 1024;
            if (n != 1 && x == resync_x) b = a = 1024;
        }
        if (x == resync_x && y == resync_y + 1 && (n == 0 || n == 4 || n == 5))
            b = 1024;
        int pred;
        if (std::abs(a - b) < std::abs(b - c)) {
            pred = c;
            *dir = 1;
        } else {
            pred = a;
            *dir = 0;
        }
        return (pred + (scale >> 1)) / scale;
    }
    void store_dc(int n, int x, int y, int level, int scale) {
        level *= scale;
        if (level & ~2047) level = level < 0 ? 0 : 2047;
        dc[plane(n)][index(n, x, y)] = level;
    }
    // ff_mpeg4_pred_ac: add the prediction (if ac_pred) and store the
    // block's first row and column; blk is raster-ordered, quantised
    void pred_ac(int16_t* blk, int n, int x, int y, int dir, bool ac_pred, int q) {
        int16_t* cur = &ac[plane(n)][(size_t)index(n, x, y) * 16];
        if (ac_pred) {
            if (dir == 0) {
                const int16_t* a = cur - 16;
                int nq = x > 0 ? qs[(size_t)y * mb_w + x - 1] : q;
                if (x == 0 || q == nq || n == 1 || n == 3) {
                    for (int i = 1; i < 8; i++) blk[i << 3] += a[i];
                } else {
                    for (int i = 1; i < 8; i++) blk[i << 3] += rdiv(a[i] * nq, q);
                }
            } else {
                const int16_t* a = cur - 16 * wrap(n);
                int nq = y > 0 ? qs[(size_t)(y - 1) * mb_w + x] : q;
                if (y == 0 || q == nq || n == 2 || n == 3) {
                    for (int i = 1; i < 8; i++) blk[i] += a[i + 8];
                } else {
                    for (int i = 1; i < 8; i++) blk[i] += rdiv(a[i + 8] * nq, q);
                }
            }
        }
        for (int i = 1; i < 8; i++) cur[i] = blk[i << 3];
        for (int i = 1; i < 8; i++) cur[8 + i] = blk[i];
    }
    static int rdiv(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }
    // a non-intra macroblock: its DC predictors 1024, its AC 0
    void clear_intra(int x, int y) {
        for (int n = 0; n < 6; n++) {
            int p = plane(n), i = index(n, x, y);
            dc[p][i] = 1024;
            memset(&ac[p][(size_t)i * 16], 0, 16 * sizeof(int16_t));
        }
    }

};

// ------------------------------------------------------------- decoder

struct MbData {
    bool intra = false, skip = false, ac_pred = false, mv4 = false;
    int cbp = 0, q = 1;
    int mv[4][2] = {};
    int16_t blk[6][64];
    int last[6];
};

class Decoder {
  public:
    Vol vol;
    Picture cur, ref;
    bool have_ref = false;
    Pred pred;
    BitReader br;
    // the current VOP
    int pict_type = 0, qscale = 1, fcode = 1, dc_thr = 0;
    bool no_rnd = false;
    // the writer, as FFmpeg tells it from user data and the fourcc: it
    // decodes Xvid's streams with its Xvid IDCT, which this file lacks
    bool xvid_tag = false;
    int xvid = -1, divx = -1, lavc = -1;
    // a sample the container cut short (the end of the file fell inside
    // it): decoded as far as it goes, the rest concealed (``conceal``)
    bool cut = false;
    // the macroblock the VOP's data failed at (-1: none), its packets'
    // first macroblocks, and what error resilience reads of the pictures:
    // each 8x8 block's vector (this VOP's and the last's), each
    // macroblock's intra flag
    int error_mb = -1;
    bool slice_ended = false;   // error_mb is the first missing one, not a failed one
    // every macroblock decoded, but the last video packet's end not
    // reached (error_mb its first macroblock): no end is marked
    bool slice_open = false;
    // FFmpeg's padding-bug detection across the stream (decode_slice's
    // padding_bug_score, and FF_BUG_NO_PADDING where it sets it)
    int padding_score = 0;
    bool no_padding = false;
    // the last concealment: its VOP type, error_mb, slice_ended, the
    // macroblocks that kept their vectors, whether guess_mv searched, and
    // whether the damaged macroblocks were taken as intra
    int64_t concealed[6] = {0, -1, 0, 0, 0, 0};
    std::vector<int> packets;
    std::vector<int16_t> mv8, last_mv8;
    std::vector<uint8_t> intra, skipped;
    // the last VOP was not coded: at the end of the stream FFmpeg hands
    // over the last picture again (h263dec.c's flush of a stream that
    // ended with an N-VOP)
    bool skipped_last = false;
    bool have_last_mv8 = false;
    // what FFmpeg's context holds when a macroblock fails, which
    // ff_h263_update_motion_val writes for it: s->mb_intra and s->mv[0][0]
    // (both carry over from the macroblocks before), whether its mv_type
    // became 8x8 and how many of its four vectors were read
    bool er_intra = false, er_mv4 = false;
    int er_mv[2] = {0, 0}, er_mv4_read = 0;

    void set_vol(const Vol& v) {
        bool same = vol.valid && v.width == vol.width && v.height == vol.height;
        vol = v;
        if (!same) {
            cur.alloc(v.mb_w, v.mb_h);
            ref.alloc(v.mb_w, v.mb_h);
            have_ref = false;
            have_last_mv8 = false;
            pred.init(v.mb_w, v.mb_h);
            mv8.assign((size_t)v.mb_num * 8, 0);
            last_mv8.assign((size_t)v.mb_num * 8, 0);
            intra.assign((size_t)v.mb_num, 0);
            skipped.assign((size_t)v.mb_num, 0);
        }
    }

    // parse every start code of the data; decode its VOP if there is one
    // (unless ``headers_only``).  Returns OM4_OK (a picture in ``ref``) or
    // OM4_NO_FRAME.
    int decode(const uint8_t* d, int64_t n, bool headers_only = false) {
        int64_t i = 0;
        bool vop = false;
        while (true) {
            int64_t s = find_start(d, n, i);
            if (s < 0) break;
            uint8_t code = d[s + 3];
            int64_t next = find_start(d, n, s + 4);
            int64_t end = next < 0 ? n : next;
            if (code >= 0x20 && code <= 0x2f) {
                br.reset(d + s + 4, end - s - 4);
                set_vol(parse_vol(br));
            } else if (code == 0xb6) {
                br.reset(d + s + 4, n - s - 4);   // a VOP runs to the end
                br.zeros_past_end = cut;
                vop = true;
                break;
            } else if (code == 0xb2) {
                std::string u((const char*)d + s + 4, (size_t)(end - s - 4));
                if (u.compare(0, 4, "XviD") == 0) xvid = atoi(u.c_str() + 4);
                else if (u.compare(0, 4, "DivX") == 0) divx = 1;
                else if (u.compare(0, 4, "Lavc") == 0 || u.compare(0, 5, "FFmpe") == 0) lavc = 1;
            } else if (code == 0xb0 && s + 4 < n) {
                int pli = d[s + 4];
                // studio profiles (0xe1-0xe8) are 10/12-bit
                if (pli >= 0xe1 && pli <= 0xe8) UNSUPPORTED("the studio profiles");
            }
            i = end;
        }
        if (!vop || headers_only) return OM4_NO_FRAME;
        if (!vol.valid) CORRUPT("VOP before any VOL header");
        if (xvid < 0 && divx < 0 && lavc < 0 && xvid_tag) xvid = 0;
        if (xvid >= 0)
            UNSUPPORTED("a stream written by Xvid (FFmpeg decodes it with its Xvid IDCT, "
                        "which the port does not reproduce)");
        return decode_vop();
    }

    static int64_t find_start(const uint8_t* d, int64_t n, int64_t i) {
        for (; i + 3 < n; i++)
            if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) return i;
        return -1;
    }

    int decode_vop() {
        skipped_last = false;
        if (!cut) return decode_vop_data();
        // a cut VOP whose header fails, or which holds fewer bits after
        // it than half its macroblocks, is dropped, as FFmpeg drops it; one
        // whose first macroblock fails is concealed.  One cut right after
        // its start code FFmpeg
        // parses from the packet's zero padding: a VOP whose vop_coded bit
        // is 0 (see ``skipped_last``)
        if (!br.size) {
            skipped_last = true;
            return OM4_NO_FRAME;
        }
        try {
            return decode_vop_data();
        } catch (const Failure& f) {
            if (f.kind != kCorrupt || error_mb >= 0) throw;
            return OM4_NO_FRAME;
        }
    }

    int decode_vop_data() {
        error_mb = -1;
        slice_ended = slice_open = false;
        int type = (int)br.get(2);
        if (type == 2) UNSUPPORTED("B-VOPs (Advanced Simple Profile)");
        if (type == 3) UNSUPPORTED("S-VOPs (sprites / global motion compensation)");
        while (br.get1()) {
            if (br.left() <= 0) CORRUPT("truncated VOP header");
        }
        if (cut) {
            // a cut VOP's header runs into the packet's zero padding:
            // FFmpeg only warns of a bad marker, and where the bit after
            // the time increment is no marker it guesses time_increment_bits
            // (decode_vop_header's search), then reads on
            br.skip(1);
            if (!(br.show(vol.time_bits + 1) & 1)) {
                int bits = 1;
                for (; bits < 16; bits++)
                    if (type == 1 ? (br.show(bits + 6) & 0x37) == 0x30
                                  : (br.show(bits + 5) & 0x1f) == 0x18)
                        break;
                vol.time_bits = bits;
            }
            br.skip(vol.time_bits + 1);
        } else {
            br.marker("before vop_time_increment");
            br.skip(vol.time_bits);
            br.marker("after vop_time_increment");
        }
        if (!br.get1()) {   // vop_coded = 0: FFmpeg outputs no picture
            skipped_last = true;
            br.check();
            return OM4_NO_FRAME;
        }
        pict_type = type == 0 ? 1 : 2;
        no_rnd = pict_type == 2 ? br.get1() : false;
        dc_thr = kDcThreshold[br.get(3)];
        qscale = (int)br.get(5);
        if (!qscale) CORRUPT("vop_quant 0");
        if (pict_type == 2) {
            fcode = (int)br.get(3);
            if (!fcode) CORRUPT("vop_fcode_forward 0");
            if (!have_ref) CORRUPT("P-VOP without a reference picture");
        }
        br.check();
        // FFmpeg decodes no VOP with fewer bits after its header than half
        // its macroblocks (what a VOP the container cut short runs into)
        if (vol.mb_num / 2 > br.left()) {
            if (cut) return OM4_NO_FRAME;
            CORRUPT("a VOP of %lld bits for %d macroblocks", (long long)br.left(), vol.mb_num);
        }
        decode_mbs();
        keep_vectors();
        if (error_mb >= 0) conceal();
        std::swap(cur, ref);
        std::swap(mv8, last_mv8);
        have_ref = have_last_mv8 = true;
        return OM4_OK;   // the picture is in ``ref`` now
    }

    int prefix_len() const { return pict_type == 1 ? 16 : fcode + 15; }

    // mpeg4_is_resync: the macroblock number of a video packet that starts
    // at the reader's position, 0 if none
    int is_resync() {
        if (no_padding && !vol.resync_marker) return 0;
        int v = (int)br.show(16);
        while (v <= 0xff) {   // macroblock stuffing before the marker
            if ((v >> (8 - pict_type)) != 1) break;
            br.skip(8 + pict_type);
            v = (int)br.show(16);
        }
        int64_t bits = br.pos;
        static const uint16_t prefix[8] = {0x7f00, 0x7e00, 0x7c00, 0x7800,
                                           0x7000, 0x6000, 0x4000, 0x0000};
        int result = 0;
        if (bits + 8 >= br.size) {
            // the data's last byte: its stuffing, or (where the container
            // cut the VOP) the end of what is there, ends the slice
            if (((v >> 8) | (0x7f >> (7 - (bits & 7)))) == 0x7f) result = vol.mb_num;
        } else if (v == prefix[bits & 7]) {
            br.skip(1);
            br.align();
            int len = 0;
            while (len < 32 && !br.get1()) len++;
            int mb_bits = bits_for(vol.mb_num);
            int mb = (int)br.get(mb_bits);
            if (len >= prefix_len())
                result = (!mb || mb > vol.mb_num || br.pos + 6 > br.size) ? -1 : mb;
        }
        br.pos = bits;   // the stuffing is consumed either way
        return result;
    }

    // ff_mpeg4_decode_video_packet_header, after the stuffing
    int packet_header() {
        br.skip(1);
        br.align();
        int len = 0;
        while (len < 32 && !br.get1()) len++;
        if (len != prefix_len()) CORRUPT("resync marker does not match vop_fcode");
        int mb = (int)br.get(bits_for(vol.mb_num));
        if (mb <= 0 || mb >= vol.mb_num) CORRUPT("video packet at macroblock %d", mb);
        int q = (int)br.get(5);
        if (q) qscale = q;
        if (br.get1()) {   // header_extension_code
            while (br.get1()) {
                if (br.left() <= 0) CORRUPT("truncated video packet header");
            }
            br.marker("in a video packet header");
            br.skip(vol.time_bits);
            br.marker("in a video packet header");
            br.skip(2 + 3);
            if (pict_type != 1) br.skip(3);
        }
        br.check();
        return mb;
    }

    void decode_mbs() {
        pred.start_packet(0, 0);
        MbData mb;
        int mbn = 0;
        packets.assign(1, 0);
        while (mbn < vol.mb_num) {
            int x = mbn % vol.mb_w, y = mbn / vol.mb_w;
            pred.next_mb(x, y);
            if (cut) {
                // FFmpeg's decode_slice: the first macroblock that fails
                // ends the VOP's decoding (its error concealment takes
                // over); what is unsupported stays so
                try {
                    decode_mb(mb, x, y);
                } catch (const Failure& f) {
                    if (f.kind != kCorrupt) throw;
                    error_mb = mbn;
                    return;
                }
            } else {
                decode_mb(mb, x, y);
            }
            intra[mbn] = mb.intra;
            skipped[mbn] = mb.skip;
            reconstruct(mb, x, y);
            mbn++;
            if (mbn < vol.mb_num) {
                int next = is_resync();
                if (next == vol.mb_num || (cut && next < 0)) {
                    // FFmpeg's slice ends here (SLICE_END: the data's last
                    // byte reads as stuffing, or a cut VOP's padding as a
                    // bad packet header) and no packet header follows: the
                    // macroblocks from here on are missing
                    padding_score--;
                    error_mb = mbn;
                    slice_ended = true;
                    return;
                }
                if (next < 0) CORRUPT("bad video packet header");
                if (next > 0) {
                    padding_score--;
                    if (next != mbn) CORRUPT("video packet at macroblock %d after %d", next, mbn);
                    packet_header();
                    packets.push_back(mbn);
                    pred.start_packet(x == vol.mb_w - 1 ? 0 : x + 1,
                                      x == vol.mb_w - 1 ? y + 1 : y);
                }
            }
        }
        if (is_resync()) {
            padding_score--;   // the last slice's SLICE_END
        } else if (end_not_reached() && cut) {
            // the last macroblock of a cut VOP read into the zero padding:
            // FFmpeg's slice end is not reached ("slice end not reached
            // but screenspace end", or "overreading"), no end is marked,
            // and its error concealment takes the whole last video packet
            error_mb = packets.back();
            slice_open = true;
            return;
        }
        br.check();
    }

    // decode_slice after its last macroblock without a SLICE_END: the
    // padding-bug score and FF_BUG_NO_PADDING updated from the bits left;
    // whether the slice's end is not reached (none is marked)
    bool end_not_reached() {
        const int64_t left = br.size - br.pos;
        if (left >= 48 && br.show(24) == 0x4010) padding_score += 32;
        if (left >= 0 && left < 137) {
            if (left == 0) {
                padding_score += 16;
            } else if (left != 1) {
                const int v = (int)br.show(8) | (0x7f >> (7 - (br.pos & 7)));
                if (v == 0x7f && left <= 8) padding_score--;
                else if (v == 0x7f && ((br.pos + 8) & 8) && left <= 16) padding_score += 4;
                else padding_score++;
            }
        }
        no_padding = padding_score > -2;
        return !no_padding || left < 0;
    }

    void set_q(int q) { qscale = std::min(std::max(q, 1), 31); }

    void decode_mb(MbData& mb, int x, int y) {
        const Tables& t = tables();
        mb.skip = mb.intra = mb.ac_pred = mb.mv4 = false;
        er_mv4 = false;
        er_mv4_read = 0;
        int cbpc, dquant;
        if (pict_type == 2) {
            while (true) {
                if (br.get1()) {   // not_coded
                    er_intra = false;
                    er_mv[0] = er_mv[1] = 0;
                    mb.skip = true;
                    mb.q = qscale;
                    mb.cbp = 0;
                    mb.mv[0][0] = mb.mv[0][1] = 0;
                    pred.set_mv16(x, y, 0, 0);
                    pred.qs[(size_t)y * vol.mb_w + x] = (uint8_t)qscale;
                    pred.clear_intra(x, y);
                    br.check();
                    return;
                }
                cbpc = br.vlc(t.inter_mcbpc);
                if (cbpc != 20) break;
            }
            dquant = cbpc & 8;
            mb.intra = (cbpc & 4) != 0;
            er_intra = mb.intra;
            if (!mb.intra) {
                // FFmpeg does not check this code: an invalid one reads as
                // -1, whose cbp codes no luma block
                int cbpy = br.vlc_or_invalid(t.cbpy) ^ 0xf;
                mb.cbp = (cbpc & 3) | (cbpy * 4);
                if (dquant) set_q(qscale + kDquant[br.get(2)]);
                mb.q = qscale;
                if (!(cbpc & 16)) {
                    int px, py;
                    pred.pred_mv(0, x, y, &px, &py);
                    mb.mv[0][0] = read_mv(px);
                    mb.mv[0][1] = read_mv(py);
                    er_mv[0] = mb.mv[0][0];
                    er_mv[1] = mb.mv[0][1];
                    pred.set_mv16(x, y, mb.mv[0][0], mb.mv[0][1]);
                } else {
                    mb.mv4 = er_mv4 = true;
                    for (int n = 0; n < 4; n++) {
                        int px, py;
                        pred.pred_mv(n, x, y, &px, &py);
                        mb.mv[n][0] = read_mv(px);
                        mb.mv[n][1] = read_mv(py);
                        int16_t* m = pred.mv_at(n, x, y);
                        m[0] = (int16_t)mb.mv[n][0];
                        m[1] = (int16_t)mb.mv[n][1];
                        if (!n) {
                            er_mv[0] = mb.mv[0][0];
                            er_mv[1] = mb.mv[0][1];
                        }
                        er_mv4_read = n + 1;
                    }
                }
                pred.qs[(size_t)y * vol.mb_w + x] = (uint8_t)qscale;
                pred.clear_intra(x, y);
                for (int n = 0; n < 6; n++)
                    inter_block(mb, n, (mb.cbp >> (5 - n)) & 1);
                br.check();
                return;
            }
        } else {
            do {
                cbpc = br.vlc(t.intra_mcbpc);
            } while (cbpc == 8);
            dquant = cbpc & 4;
            mb.intra = er_intra = true;
        }
        // intra
        mb.ac_pred = br.get1();
        int cbpy = br.vlc(t.cbpy);
        mb.cbp = (cbpc & 3) | (cbpy << 2);
        bool dc_vlc = qscale < dc_thr;
        if (dquant) set_q(qscale + kDquant[br.get(2)]);
        mb.q = qscale;
        pred.set_mv16(x, y, 0, 0);
        pred.qs[(size_t)y * vol.mb_w + x] = (uint8_t)qscale;
        for (int n = 0; n < 6; n++)
            intra_block(mb, n, x, y, (mb.cbp >> (5 - n)) & 1, dc_vlc);
        br.check();
    }

    int read_mv(int pred_v) { return read_motion(br, tables().mvd, pred_v, fcode); }

    // one TCOEF event: (last, run, level) with the escapes resolved
    void read_tcoef(const RunLevel& rl, int* last, int* run, int* level, bool* esc3) {
        *esc3 = false;
        int i = br.vlc(rl.vlc);
        if (i < 102) {
            *last = rl.last[i];
            *run = rl.run[i];
            *level = br.get1() ? -rl.level[i] : rl.level[i];
            return;
        }
        if (!br.get1()) {   // escape 1: level offset
            i = br.vlc(rl.vlc);
            if (i >= 102) CORRUPT("escape in escape");
            *last = rl.last[i];
            *run = rl.run[i];
            int lv = rl.level[i] + rl.max_level[*last][*run];
            *level = br.get1() ? -lv : lv;
        } else if (!br.get1()) {   // escape 2: run offset
            i = br.vlc(rl.vlc);
            if (i >= 102) CORRUPT("escape in escape");
            *last = rl.last[i];
            *run = rl.run[i] + rl.max_run[*last][rl.level[i]] + 1;
            *level = br.get1() ? -rl.level[i] : rl.level[i];
        } else {   // escape 3: fixed length
            *last = br.get1();
            *run = (int)br.get(6);
            br.marker("in an escape-3 level");
            int v = (int)br.get(12);
            *level = v >= 2048 ? v - 4096 : v;
            br.marker("after an escape-3 level");
            *esc3 = true;
        }
    }

    void intra_block(MbData& mb, int n, int x, int y, bool coded, bool dc_vlc) {
        const Tables& t = tables();
        int16_t* blk = mb.blk[n];
        memset(blk, 0, 64 * sizeof(int16_t));
        int scale = n < 4 ? y_dc_scale(mb.q) : c_dc_scale(mb.q);
        int dir;
        int dcp = pred.pred_dc(n, x, y, scale, &dir);
        int i;
        if (dc_vlc) {
            int size = br.vlc(n < 4 ? t.dc_lum : t.dc_chrom);
            if (size > 9) CORRUPT("illegal DC size");
            int level = 0;
            if (size) {
                int v = (int)br.get(size);
                level = (v >> (size - 1)) ? v : v - (1 << size) + 1;
                if (size > 8) br.skip(1);   // marker (FFmpeg does not insist)
            }
            // mpeg4_decode_block takes a negative DC (the differential plus
            // its prediction, before the scale) for decode_dc's error code:
            // the macroblock fails, whatever err_recognition says
            if (level + dcp < 0) CORRUPT("a negative intra DC (%d)", level + dcp);
            blk[0] = (int16_t)(level + dcp);
            i = 0;
        } else {
            i = -1;
        }
        if (coded) {
            const uint8_t* scan = !mb.ac_pred ? kZigzag : dir == 0 ? kAltVertical : kAltHorizontal;
            while (true) {
                int last, run, level;
                bool esc3;
                read_tcoef(t.intra, &last, &run, &level, &esc3);
                i += run + 1;
                if (i > 63) CORRUPT("AC coefficients past the block's end");
                blk[scan[i]] = (int16_t)level;
                if (last) break;
            }
        }
        if (!dc_vlc) {
            blk[0] = (int16_t)(blk[0] + dcp);
            if (i < 0) i = 0;
        }
        pred.store_dc(n, x, y, blk[0], scale);
        pred.pred_ac(blk, n, x, y, dir, mb.ac_pred, mb.q);
        mb.last[n] = mb.ac_pred ? 63 : i;
    }

    void inter_block(MbData& mb, int n, bool coded) {
        int16_t* blk = mb.blk[n];
        memset(blk, 0, 64 * sizeof(int16_t));
        mb.last[n] = -1;
        if (!coded) return;
        const RunLevel& rl = tables().inter;
        int qmul = vol.mpeg_quant ? 1 : 2 * mb.q;
        int qadd = vol.mpeg_quant ? 0 : (mb.q - 1) | 1;
        int i = -1;
        while (true) {
            int last, run, level;
            bool esc3;
            read_tcoef(rl, &last, &run, &level, &esc3);
            if (level > 0) level = level * qmul + qadd;
            else level = level * qmul - qadd;
            if (esc3 && (unsigned)(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
            i += run + 1;
            if (i > 63) CORRUPT("AC coefficients past the block's end");
            blk[kZigzag[i]] = (int16_t)level;
            if (last) break;
        }
        mb.last[n] = i;
    }

    // ---- reconstruction (ff_mpv_reconstruct_mb)

    void dequant_intra(MbData& mb, int n) {
        int16_t* blk = mb.blk[n];
        int q = mb.q;
        int dcs = n < 4 ? y_dc_scale(q) : c_dc_scale(q);
        if (!vol.mpeg_quant) {   // dct_unquantize_h263_intra
            int qmul = q << 1, qadd = (q - 1) | 1;
            blk[0] = (int16_t)(blk[0] * dcs);
            for (int i = 1; i < 64; i++) {
                int l = blk[i];
                if (l) blk[i] = (int16_t)(l < 0 ? l * qmul - qadd : l * qmul + qadd);
            }
        } else {   // dct_unquantize_mpeg2_intra
            int qs = q << 1;
            blk[0] = (int16_t)(blk[0] * dcs);
            for (int i = 1; i <= mb.last[n]; i++) {
                int j = kZigzag[i];
                int l = blk[j];
                if (l) {
                    int a = (int)(std::abs(l) * qs * vol.intra_m[j]) >> 4;
                    blk[j] = (int16_t)(l < 0 ? -a : a);
                }
            }
        }
    }

    void dequant_inter_mpeg(MbData& mb, int n) {   // dct_unquantize_mpeg2_inter
        int16_t* blk = mb.blk[n];
        int qs = mb.q << 1;
        int sum = -1;
        for (int i = 0; i <= mb.last[n]; i++) {
            int j = kZigzag[i];
            int l = blk[j];
            if (l) {
                int a = (((std::abs(l) << 1) + 1) * qs * vol.inter_m[j]) >> 5;
                l = l < 0 ? -a : a;
                blk[j] = (int16_t)l;
                sum += l;
            }
        }
        blk[63] ^= sum & 1;
    }

    void reconstruct(MbData& mb, int x, int y) {
        Plane* p = cur.p;
        uint8_t* dy = p[0].at(x * 16, y * 16);
        uint8_t* du = p[1].at(x * 8, y * 8);
        uint8_t* dv = p[2].at(x * 8, y * 8);
        const int ls = p[0].w, cs = p[1].w;
        uint8_t* dst[6] = {dy, dy + 8, dy + 8 * ls, dy + 8 * ls + 8, du, dv};
        const int stride[6] = {ls, ls, ls, ls, cs, cs};
        if (mb.intra) {
            for (int n = 0; n < 6; n++) {
                dequant_intra(mb, n);
                idct(mb.blk[n], dst[n], stride[n], false);
            }
            return;
        }
        motion(mb, x, y, dy, du, dv);
        if (mb.skip) return;
        for (int n = 0; n < 6; n++) {
            if (mb.last[n] < 0) continue;
            if (vol.mpeg_quant) dequant_inter_mpeg(mb, n);
            idct(mb.blk[n], dst[n], stride[n], true);
        }
    }

    void motion(MbData& mb, int x, int y, uint8_t* dy, uint8_t* du, uint8_t* dv) {
        // FFmpeg's reference edges: the macroblock-aligned size, not the
        // display size (the padding macroblocks' pixels are read)
        const Edges e{vol.mb_w * 16, vol.mb_h * 16, vol.width, vol.height};
        const int ls = cur.p[0].w, cs = cur.p[1].w;
        if (!mb.mv4) {
            mpeg_motion(ref, e, x, y, mb.mv[0][0], mb.mv[0][1], no_rnd, dy, du, dv, ls, cs);
            return;
        }
        int sumx = 0, sumy = 0;
        for (int i = 0; i < 4; i++) {
            hpel_motion(ref.p[0], e, x * 16 + (i & 1) * 8, y * 16 + (i >> 1) * 8, mb.mv[i][0],
                        mb.mv[i][1], no_rnd, dy + (i & 1) * 8 + (i >> 1) * 8 * ls, ls);
            sumx += mb.mv[i][0];
            sumy += mb.mv[i][1];
        }
        chroma_4mv_motion(ref, e, x, y, sumx, sumy, no_rnd, du, dv, cs);
    }

    // ---- error resilience: error_resilience.c as FFmpeg runs it for
    // MPEG-4 Part 2 (error_concealment 3: guess vectors, deblock) over a
    // VOP whose data failed at ``error_mb``

    enum { kAcError = 2, kDcError = 4, kMvError = 8, kAcEnd = 16, kDcEnd = 32, kMvEnd = 64,
           kMbError = kAcError | kDcError | kMvError, kMbEnd = kAcEnd | kDcEnd | kMvEnd, kVpStart = 1 };

    // each 8x8 block's vector in this VOP (update_motion_val's): the
    // decoded macroblocks', zero in intra and skipped ones; the failed
    // macroblock's what ff_h263_update_motion_val writes from the context
    // its decoding left (an 8x8 macroblock's vectors as far as they were
    // read, else s->mv[0][0] unless s->mb_intra); zero after it (FFmpeg's
    // tables start zeroed)
    void keep_vectors() {
        std::fill(mv8.begin(), mv8.end(), 0);
        const int last = error_mb < 0 || slice_open ? vol.mb_num : error_mb;
        for (int m = 0; m < last; m++) {
            const int x = m % vol.mb_w, y = m / vol.mb_w;
            for (int n = 0; n < 4; n++) {
                const int16_t* v = pred.mv_at(n, x, y);
                int16_t* o = &mv8[blk8(x * 2 + (n & 1), y * 2 + (n >> 1)) * 2];
                o[0] = intra[m] || pict_type == 1 ? 0 : v[0];
                o[1] = intra[m] || pict_type == 1 ? 0 : v[1];
            }
        }
        if (error_mb < 0 || slice_ended || slice_open) return;
        const int x = error_mb % vol.mb_w, y = error_mb / vol.mb_w;
        for (int n = 0; n < 4; n++) {
            int16_t* o = &mv8[blk8(x * 2 + (n & 1), y * 2 + (n >> 1)) * 2];
            if (er_mv4) {
                const int16_t* v = pred.mv_at(n, x, y);
                o[0] = n < er_mv4_read ? v[0] : 0;
                o[1] = n < er_mv4_read ? v[1] : 0;
            } else {
                o[0] = er_intra ? 0 : (int16_t)er_mv[0];
                o[1] = er_intra ? 0 : (int16_t)er_mv[1];
            }
        }
    }
    size_t blk8(int bx, int by) const { return (size_t)by * 2 * vol.mb_w + bx; }

    void conceal() {
        const int mw = vol.mb_w, mh = vol.mb_h, num = vol.mb_num;
        // ff_er_frame_start and ff_er_add_slice: each packet decoded whole
        // ends (its last macroblock ER_MB_END), the failed one's error at
        // its macroblock, the macroblocks after it untouched
        ErrorResilience er;
        er.start(mw, mh);
        std::vector<uint8_t>& st = er.st;
        for (size_t k = 0; k < packets.size(); k++) {
            const int start = packets[k];
            const bool last = k + 1 == packets.size();
            // a packet ends at its last macroblock (ER_MB_END), the last one
            // at the macroblock that failed (ER_MB_ERROR) or, where its slice
            // ended early, at the one before the missing ones
            const bool failed = last && !slice_ended;
            if (last && slice_open) {
                // its macroblocks cleared, none of them an end
                for (int m = start; m < num; m++) st[m] = 0;
                st[start] |= kVpStart;
                continue;
            }
            const int end = !last ? packets[k + 1] - 1 : failed ? error_mb : error_mb - 1;
            for (int m = start; m < end; m++) st[m] = 0;
            st[end] = failed ? kMbError : kMbEnd;
            st[start] |= kVpStart;
        }
        // a skipped macroblock decoded (before the error, or anywhere in a
        // VOP decoded whole) does not count towards the 50 that share it
        const int decoded = slice_open ? num : error_mb;
        std::vector<uint8_t> counted((size_t)num);
        for (int m = 0; m < num; m++) counted[m] = !(m < decoded && skipped[m]);
        er.spread(counted);
        // the damaged macroblocks' kind (is_intra_more_likely), inter with
        // a reference picture only
        std::vector<uint8_t>& is_intra = er.is_intra;
        for (int m = 0; m < num; m++) is_intra[m] = m < error_mb && intra[m];
        const bool intra_likely = er.intra_more_likely(cur, have_ref ? &ref : nullptr, pict_type);
        concealed[0] = pict_type;
        concealed[1] = error_mb;
        concealed[2] = slice_ended;
        concealed[5] = intra_likely;
        for (int m = 0; m < num; m++)
            if (er.damaged(m)) is_intra[m] = intra_likely;
        if (!have_ref)
            for (auto& t : is_intra) t = 1;
        guess_vectors(st, is_intra);
        er.mv8 = mv8;
        er.finish(cur);
    }

    // guess_mv: the last picture's vector into each damaged inter
    // macroblock's first block; where few macroblocks keep their vectors
    // (no more than half the longer side's count), each damaged inter
    // macroblock predicted from the last picture with a zero vector; else
    // FFmpeg's search, outwards from the macroblocks that keep theirs:
    // each candidate (the neighbours' vectors, their mean and median, zero,
    // the last vector) rendered and scored by the steps at the borders it
    // shares with settled neighbours, the best kept, for up to 10 passes a
    // ring while any vector changes
    enum { kMvFrozen = 8, kMvChanged = 4, kMvUnchanged = 2, kMvListed = 1 };

    void render16(int x, int y, int mx, int my) {
        MbData mb;
        mb.mv[0][0] = mx;
        mb.mv[0][1] = my;
        motion(mb, x, y, cur.p[0].at(x * 16, y * 16), cur.p[1].at(x * 8, y * 8), cur.p[2].at(x * 8, y * 8));
    }

    void guess_vectors(const std::vector<uint8_t>& st, const std::vector<uint8_t>& is_intra) {
        const int mw = vol.mb_w, mh = vol.mb_h, num = vol.mb_num;
        std::vector<uint8_t> fixed((size_t)num);
        int avail = 0;
        for (int m = 0; m < num; m++) {
            int f = 0;
            if (is_intra[m] || !(st[m] & kMvError)) f = kMvFrozen;
            fixed[m] = (uint8_t)f;
            if (f == kMvFrozen) {
                avail++;
            } else if (have_ref && have_last_mv8) {
                const int x = m % mw, y = m / mw;
                const size_t b = blk8(2 * x, 2 * y) * 2;
                mv8[b] = last_mv8[b];
                mv8[b + 1] = last_mv8[b + 1];
            }
        }
        concealed[3] = avail;
        concealed[4] = avail > std::max(mw, mh) / 2;
        if (!concealed[4]) {
            for (int m = 0; m < num; m++) {
                if (is_intra[m] || !(st[m] & kMvError)) continue;
                render16(m % mw, m / mw, 0, 0);
            }
            return;
        }
        std::vector<std::pair<int, int>> list, next;
        auto add = [&](std::vector<std::pair<int, int>>& l, int x, int y) {
            uint8_t& f = fixed[(size_t)y * mw + x];
            if (f) return;
            f = kMvListed;
            l.emplace_back(x, y);
        };
        // a settled macroblock's unsettled neighbours: left, up, right, down
        auto neighbours = [&](std::vector<std::pair<int, int>>& l, int x, int y) {
            if (x) add(l, x - 1, y);
            if (y) add(l, x, y - 1);
            if (x + 1 < mw) add(l, x + 1, y);
            if (y + 1 < mh) add(l, x, y + 1);
        };
        for (int y = 0; y < mh; y++)
            for (int x = 0; x < mw; x++)
                if (fixed[(size_t)y * mw + x] == kMvFrozen) neighbours(list, x, y);
        const Plane& lp = cur.p[0];
        const int ls = lp.w;
        for (;;) {
            bool none_left = true;
            int changed = 1;
            for (int pass = 0; (changed || pass < 2) && pass < 10; pass++) {
                changed = 0;
                for (const auto& xy : list) {
                    const int x = xy.first, y = xy.second, m = y * mw + x;
                    if ((x ^ y ^ pass) & 1) continue;
                    int j = 0;
                    if (x > 0) j |= fixed[m - 1];
                    if (x + 1 < mw) j |= fixed[m + 1];
                    if (y > 0) j |= fixed[m - mw];
                    if (y + 1 < mh) j |= fixed[m + mw];
                    if (!(j & kMvChanged) && pass > 1) continue;
                    none_left = false;
                    int pv[8][2], pc = 0;
                    auto take = [&](int bx, int by) {
                        const size_t b = blk8(bx, by) * 2;
                        pv[pc][0] = mv8[b];
                        pv[pc][1] = mv8[b + 1];
                        pc++;
                    };
                    if (x > 0 && fixed[m - 1] > 1) take(2 * x - 2, 2 * y);
                    if (x + 1 < mw && fixed[m + 1] > 1) take(2 * x + 2, 2 * y);
                    if (y > 0 && fixed[m - mw] > 1) take(2 * x, 2 * y - 2);
                    if (y + 1 < mh && fixed[m + mw] > 1) take(2 * x, 2 * y + 2);
                    if (pc == 0) continue;
                    if (pc > 1) {
                        int sum_x = 0, sum_y = 0;
                        for (int k = 0; k < pc; k++) {
                            sum_x += pv[k][0];
                            sum_y += pv[k][1];
                        }
                        pv[pc][0] = sum_x / pc;   // the mean
                        pv[pc][1] = sum_y / pc;
                        int min_x, min_y, max_x, max_y;
                        if (pc >= 3) {
                            min_x = min_y = 99999;
                            max_x = max_y = -99999;
                        } else {
                            min_x = min_y = max_x = max_y = 0;
                        }
                        for (int k = 0; k < pc; k++) {
                            max_x = std::max(max_x, pv[k][0]);
                            max_y = std::max(max_y, pv[k][1]);
                            min_x = std::min(min_x, pv[k][0]);
                            min_y = std::min(min_y, pv[k][1]);
                        }
                        pv[pc + 1][0] = sum_x - max_x - min_x;   // the median
                        pv[pc + 1][1] = sum_y - max_y - min_y;
                        if (pc == 4) {
                            pv[pc + 1][0] /= 2;
                            pv[pc + 1][1] /= 2;
                        }
                        pc += 2;
                    }
                    pv[pc][0] = pv[pc][1] = 0;   // zero
                    pc++;
                    const size_t b0 = blk8(2 * x, 2 * y) * 2;
                    const int prev_x = mv8[b0], prev_y = mv8[b0 + 1];
                    pv[pc][0] = prev_x;   // the last vector
                    pv[pc][1] = prev_y;
                    pc++;
                    int best = 0, best_score = 256 * 256 * 256 * 64;
                    const uint8_t* src = lp.at(x * 16, y * 16);
                    for (int k = 0; k < pc; k++) {
                        mv8[b0] = (int16_t)pv[k][0];
                        mv8[b0 + 1] = (int16_t)pv[k][1];
                        render16(x, y, pv[k][0], pv[k][1]);
                        int score = 0;
                        if (x > 0 && fixed[m - 1] > 1)
                            for (int r = 0; r < 16; r++) score += std::abs(src[r * ls - 1] - src[r * ls]);
                        if (x + 1 < mw && fixed[m + 1] > 1)
                            for (int r = 0; r < 16; r++) score += std::abs(src[r * ls + 15] - src[r * ls + 16]);
                        if (y > 0 && fixed[m - mw] > 1)
                            for (int c = 0; c < 16; c++) score += std::abs(src[c - ls] - src[c]);
                        if (y + 1 < mh && fixed[m + mw] > 1)
                            for (int c = 0; c < 16; c++) score += std::abs(src[c + ls * 15] - src[c + ls * 16]);
                        if (score <= best_score) {   // <= favours the last vector
                            best_score = score;
                            best = k;
                        }
                    }
                    for (int n = 0; n < 4; n++) {
                        const size_t b = blk8(2 * x + (n & 1), 2 * y + (n >> 1)) * 2;
                        mv8[b] = (int16_t)pv[best][0];
                        mv8[b + 1] = (int16_t)pv[best][1];
                    }
                    render16(x, y, pv[best][0], pv[best][1]);
                    if (pv[best][0] != prev_x || pv[best][1] != prev_y) {
                        fixed[m] = kMvChanged;
                        changed++;
                    } else {
                        fixed[m] = kMvUnchanged;
                    }
                }
            }
            if (none_left) return;
            next.clear();
            for (const auto& xy : list) {
                const int x = xy.first, y = xy.second, m = y * mw + x;
                if (fixed[m] & (kMvChanged | kMvUnchanged | kMvFrozen)) {
                    fixed[m] = kMvFrozen;
                    neighbours(next, x, y);
                }
            }
            std::swap(list, next);
        }
    }

    // the last decoded picture's planes at the display size
    void output(uint8_t* y, uint8_t* u, uint8_t* v) const {
        const int w = vol.width, h = vol.height, cw = (w + 1) / 2, ch = (h + 1) / 2;
        for (int r = 0; r < h; r++) memcpy(y + (size_t)r * w, ref.p[0].at(0, r), w);
        for (int r = 0; r < ch; r++) {
            memcpy(u + (size_t)r * cw, ref.p[1].at(0, r), cw);
            memcpy(v + (size_t)r * cw, ref.p[2].at(0, r), cw);
        }
    }
};

// ------------------------------------------------------------- encoder

constexpr int kGop = 12;   // the I-VOP period

struct EncParams {
    int width = 0, height = 0;   // even
    int qscale = 5;
    int fcode = 2;               // vectors of +-32 px; the search stays in +-16
    int time_res = 25, time_inc = 1;
    bool inband = false;         // VOS/VO/VOL before every I-VOP (AVI)
    int packet_rows = 0;         // a video packet every n macroblock rows
    int rounding = 0;            // 0: vop_rounding_type 0; 1: alternate as FFmpeg
    bool mv4 = false;            // try 4 vectors a macroblock
    bool ac_pred = true;
    bool mpeg_quant = false;     // with the matrices below
    uint8_t intra_m[64], inter_m[64];
    int dquant = 0;              // >0: vary the quantiser by macroblock (a test pattern)
};

struct FDct {
    float c[8][8];   // c[x][u]: basis u at sample x
    FDct() {
        for (int u = 0; u < 8; u++)
            for (int x = 0; x < 8; x++)
                c[x][u] = (float)((u ? 0.5 : 0.5 / std::sqrt(2.0)) *
                                  std::cos((2 * x + 1) * u * M_PI / 16));
    }
    // the loops run over u innermost, so they vectorise; each output still
    // sums its eight products in sample order
    void operator()(const int* in, float* out) const {
        float t[64] = {0};
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                float v = (float)in[y * 8 + x];
                for (int u = 0; u < 8; u++) t[y * 8 + u] += c[x][u] * v;
            }
        for (int v = 0; v < 64; v++) out[v] = 0;
        for (int y = 0; y < 8; y++)
            for (int v = 0; v < 8; v++)
                for (int u = 0; u < 8; u++) out[v * 8 + u] += c[y][v] * t[y * 8 + u];
    }
};

int mvd_bits(int v, int fcode) {
    if (!v) return 1;
    int a = std::abs(v), shift = fcode - 1;
    int code = ((a - 1) >> shift) + 1;
    return kMvd[std::min(code, 32)].bits + 1 + shift;
}

class Encoder {
  public:
    EncParams p;
    Decoder dec;    // reconstructs each VOP from its own bits
    Pred pred;
    FDct fdct;
    int mb_w, mb_h, frame = 0;
    int64_t last_sec = 0;
    bool no_rnd = false;
    std::vector<uint8_t> vol_bytes;
    BitWriter bw;
    Picture src, pic;    // the input at macroblock size; a prediction
    int cur_q = 0;

    void open(const EncParams& ep) {
        p = ep;
        mb_w = (p.width + 15) / 16;
        mb_h = (p.height + 15) / 16;
        pred.init(mb_w, mb_h);
        src.alloc(mb_w, mb_h);
        pic.alloc(mb_w, mb_h);
        BitWriter h;
        write_vol(h);
        vol_bytes = h.out;
        dec.decode(vol_bytes.data(), (int64_t)vol_bytes.size());
    }

    void write_vol(BitWriter& w) const {
        w.start_code(0xb0);
        w.put(8, 0x01);                 // profile_and_level_indication
        w.start_code(0xb5);
        w.put(1, 1);                    // is_visual_object_identifier
        w.put(4, 1);                    // visual_object_verid
        w.put(3, 1);                    // visual_object_priority
        w.put(4, 1);                    // video
        w.put(1, 0);                    // video_signal_type
        w.stuff();
        w.start_code(0x00);             // video_object_start_code
        w.start_code(0x20);             // video_object_layer_start_code
        w.put(1, 0);                    // random_accessible_vol
        w.put(8, 1);                    // simple object type
        w.put(1, 0);                    // is_object_layer_identifier
        w.put(4, 1);                    // square pixels
        w.put(1, 1);                    // vol_control_parameters
        w.put(2, 1);                    // 4:2:0
        w.put(1, 1);                    // low_delay
        w.put(1, 0);                    // vbv_parameters
        w.put(2, 0);                    // rectangular
        w.put(1, 1);
        w.put(16, (uint32_t)p.time_res);
        w.put(1, 1);
        w.put(1, 0);                    // fixed_vop_rate
        w.put(1, 1);
        w.put(13, (uint32_t)p.width);
        w.put(1, 1);
        w.put(13, (uint32_t)p.height);
        w.put(1, 1);
        w.put(1, 0);                    // interlaced
        w.put(1, 1);                    // obmc_disable
        w.put(1, 0);                    // sprite_enable
        w.put(1, 0);                    // not_8_bit
        w.put(1, p.mpeg_quant);
        if (p.mpeg_quant) {
            w.put(1, 1);
            for (int i = 0; i < 64; i++) w.put(8, p.intra_m[kZigzag[i]]);
            w.put(1, 1);
            for (int i = 0; i < 64; i++) w.put(8, p.inter_m[kZigzag[i]]);
        }
        w.put(1, 1);                    // complexity_estimation_disable
        w.put(1, p.packet_rows ? 0 : 1);  // resync_marker_disable
        w.put(1, 0);                    // data_partitioned
        w.put(1, 0);                    // scalability
        w.stuff();
    }

    // ---- bits of one macroblock's parts

    void put_tcoef(const RunLevel& rl, int last, int run, int level) {
        int a = std::abs(level), s = level < 0;
        const Code& esc = rl.codes[102];
        if (a <= 27 && run < 64 && rl.index[last][run][a] >= 0) {
            bw.put(rl.codes[rl.index[last][run][a]]);
            bw.put(1, s);
            return;
        }
        int ml = run < 64 ? rl.max_level[last][run] : 0;
        if (ml && a > ml && a - ml <= 27 && rl.index[last][run][a - ml] >= 0) {
            bw.put(esc);
            bw.put(1, 0);
            bw.put(rl.codes[rl.index[last][run][a - ml]]);
            bw.put(1, s);
            return;
        }
        if (a <= 27 && rl.index[last][0][a] >= 0) {
            int r2 = run - rl.max_run[last][a] - 1;
            if (r2 >= 0 && r2 < 64 && rl.index[last][r2][a] >= 0) {
                bw.put(esc);
                bw.put(2, 2);
                bw.put(rl.codes[rl.index[last][r2][a]]);
                bw.put(1, s);
                return;
            }
        }
        bw.put(esc);
        bw.put(2, 3);
        bw.put(1, last);
        bw.put(6, (uint32_t)run);
        bw.put(1, 1);
        bw.put(12, (uint32_t)level & 0xfff);
        bw.put(1, 1);
    }

    // the coefficients of a block from scan position ``start``
    void put_block(const RunLevel& rl, const int16_t* blk, const uint8_t* scan, int start) {
        int lastpos = -1;
        for (int i = start; i < 64; i++)
            if (blk[scan[i]]) lastpos = i;
        int run = 0;
        for (int i = start; i <= lastpos; i++) {
            int v = blk[scan[i]];
            if (!v) {
                run++;
                continue;
            }
            put_tcoef(rl, i == lastpos, run, v);
            run = 0;
        }
    }

    void put_mvd(int v) {
        // v: the difference in half-pels, wrapped into the f_code range
        int bits = 5 + p.fcode;
        v = (int)((uint32_t)v << (32 - bits)) >> (32 - bits);
        if (!v) {
            bw.put(kMvd[0]);
            return;
        }
        int shift = p.fcode - 1, a = std::abs(v);
        int code = ((a - 1) >> shift) + 1;
        bw.put(kMvd[code]);
        bw.put(1, v < 0);
        if (shift) bw.put(shift, (uint32_t)((a - 1) & ((1 << shift) - 1)));
    }

    void put_dc(int n, int diff) {
        int a = std::abs(diff), size = 0;
        while ((1 << size) <= a) size++;
        bw.put(n < 4 ? kDcLum[size] : kDcChrom[size]);
        if (size) {
            bw.put(size, (uint32_t)(diff > 0 ? diff : diff + (1 << size) - 1));
            if (size > 8) bw.put(1, 1);
        }
    }

    // ---- pixels

    void load(const uint8_t* y, const uint8_t* u, const uint8_t* v) {
        // the frame at macroblock size, its last row and column repeated
        const int w = p.width, h = p.height, cw = w / 2, ch = h / 2;
        const uint8_t* in[3] = {y, u, v};
        for (int c = 0; c < 3; c++) {
            Plane& pl = src.p[c];
            int iw = c ? cw : w, ih = c ? ch : h;
            for (int r = 0; r < pl.h; r++) {
                const uint8_t* row = in[c] + (size_t)std::min(r, ih - 1) * iw;
                uint8_t* o = pl.at(0, r);
                memcpy(o, row, iw);
                memset(o + iw, row[iw - 1], pl.w - iw);
            }
        }
    }

    // the 8x8 block n of macroblock (x, y) of picture ``pc`` as ints
    void block_of(const Picture& pc, int n, int x, int y, int* out) const {
        const Plane& pl = pc.p[n < 4 ? 0 : n - 3];
        int bx = n < 4 ? x * 16 + (n & 1) * 8 : x * 8;
        int by = n < 4 ? y * 16 + (n >> 1) * 8 : y * 8;
        for (int r = 0; r < 8; r++)
            for (int c = 0; c < 8; c++) out[r * 8 + c] = pl.at(bx, by + r)[c];
    }

    int sad16(int x, int y, int sx, int sy, int dxy, int best) {
        uint8_t tmp[256];
        const int ew = mb_w * 16, eh = mb_h * 16;
        const Plane& r = dec.ref.p[0];
        const uint8_t* s = src.p[0].at(x * 16, y * 16);
        const int ss = src.p[0].w;
        const uint8_t* q;
        int qs;
        if (dxy == 0 && sx >= 0 && sy >= 0 && sx + 16 <= ew && sy + 16 <= eh) {
            q = r.at(sx, sy);
            qs = r.w;
        } else {
            mc_block(r, ew, eh, sx, sy, dxy, 16, 16, no_rnd, tmp, 16);
            q = tmp;
            qs = 16;
        }
        int sum = 0;
        for (int i = 0; i < 16; i++) {
            const uint8_t* a = s + i * ss;
            const uint8_t* b = q + i * qs;
            for (int j = 0; j < 16; j++) sum += std::abs(a[j] - b[j]);
            if (sum >= best) return sum;
        }
        return sum;
    }

    int sad8(int x, int y, int n, int mx, int my) {
        uint8_t tmp[64];
        const int ew = mb_w * 16, eh = mb_h * 16;
        int sx = x * 16 + (n & 1) * 8 + (mx >> 1), sy = y * 16 + (n >> 1) * 8 + (my >> 1);
        int dxy = ((my & 1) << 1) | (mx & 1);
        // the decoder's 4MV clipping
        sx = std::min(std::max(sx, -16), p.width);
        if (sx == p.width) dxy &= ~1;
        sy = std::min(std::max(sy, -16), p.height);
        if (sy == p.height) dxy &= ~2;
        mc_block(dec.ref.p[0], ew, eh, sx, sy, dxy, 8, 8, no_rnd, tmp, 8);
        const uint8_t* s = src.p[0].at(x * 16 + (n & 1) * 8, y * 16 + (n >> 1) * 8);
        int sum = 0;
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++) sum += std::abs(s[i * src.p[0].w + j] - tmp[i * 8 + j]);
        return sum;
    }

    // 1MV search: predictors, a small diamond at full pel, then half pel.
    // Vectors stay within +-16 px (+-32 half-pels) and the f_code range.
    int search16(int x, int y, int px, int py, int* bmx, int* bmy) {
        const int lim = 32, lambda = cur_q;
        auto cost_of = [&](int mx, int my) {
            return lambda * (mvd_bits(mx - px, p.fcode) + mvd_bits(my - py, p.fcode));
        };
        int best = INT32_MAX, bx = 0, by = 0;
        auto tryfull = [&](int fx, int fy) {   // full-pel candidate, in pels
            if (std::abs(fx) > lim / 2 || std::abs(fy) > lim / 2) return;
            int mx = 2 * fx, my = 2 * fy;
            int c = cost_of(mx, my);
            if (c >= best) return;
            c += sad16(x, y, x * 16 + fx, y * 16 + fy, 0, best - c);
            if (c < best) {
                best = c;
                bx = mx;
                by = my;
            }
        };
        tryfull(0, 0);
        tryfull(px >> 1, py >> 1);
        const int16_t* cand[3] = {pred.mv_at(1, x - 1, y), pred.mv_at(2, x, y - 1),
                                  pred.mv_at(2, x + 1, y - 1)};
        for (auto* c : cand) tryfull(c[0] >> 1, c[1] >> 1);
        for (int it = 0; it < 32; it++) {
            int cx = bx, cy = by;
            tryfull((cx >> 1) - 1, cy >> 1);
            tryfull((cx >> 1) + 1, cy >> 1);
            tryfull(cx >> 1, (cy >> 1) - 1);
            tryfull(cx >> 1, (cy >> 1) + 1);
            if (cx == bx && cy == by) break;
        }
        // half-pel: the 8 neighbours, interpolated from one clamped fetch
        // of the 18x18 pixels around the full-pel block (the decoder's
        // 16-wide averages; only the choice depends on them)
        uint8_t win[18 * 18];
        const int ew = mb_w * 16, eh = mb_h * 16;
        const Plane& rp = dec.ref.p[0];
        const int x0 = x * 16 + (bx >> 1) - 1, y0 = y * 16 + (by >> 1) - 1;
        for (int r = 0; r < 18; r++) {
            const uint8_t* row = rp.at(0, std::min(std::max(y0 + r, 0), eh - 1));
            for (int c = 0; c < 18; c++)
                win[r * 18 + c] = row[std::min(std::max(x0 + c, 0), ew - 1)];
        }
        const uint8_t* sp = src.p[0].at(x * 16, y * 16);
        const int ss = src.p[0].w, rnd = no_rnd ? 0 : 1;
        int fx = bx, fy = by;
        for (int dy = -1; dy <= 1; dy++)
            for (int dx = -1; dx <= 1; dx++) {
                if (!dx && !dy) continue;
                int mx = fx + dx, my = fy + dy;
                if (std::abs(mx) > lim + 1 || std::abs(my) > lim + 1) continue;
                int c = cost_of(mx, my);
                if (c >= best) continue;
                // integer offset into the window, and the half flags
                const uint8_t* q = win + ((my >> 1) - (fy >> 1) + 1) * 18 + (mx >> 1) - (fx >> 1) + 1;
                const int hx = mx & 1, hy = my & 1;
                int sum = 0;
                for (int i = 0; i < 16 && c + sum < best; i++) {
                    const uint8_t* a = q + i * 18;
                    const uint8_t* b = a + 18;
                    const uint8_t* o = sp + i * ss;
                    for (int j = 0; j < 16; j++) {
                        int p;
                        if (hx && hy) p = (a[j] + a[j + 1] + b[j] + b[j + 1] + 1 + rnd) >> 2;
                        else if (hx) p = (a[j] + a[j + 1] + rnd) >> 1;
                        else p = (a[j] + b[j] + rnd) >> 1;
                        sum += std::abs(o[j] - p);
                    }
                }
                c += sum;
                if (c < best) {
                    best = c;
                    bx = mx;
                    by = my;
                }
            }
        *bmx = bx;
        *bmy = by;
        return best;
    }

    // refine each 8x8 block around the 16x16 vector (4MV)
    int search8(int x, int y, int mx0, int my0, int mv[4][2]) {
        int total = 0;
        for (int n = 0; n < 4; n++) {
            int bx = mx0, by = my0, best = sad8(x, y, n, bx, by);
            for (int dy = -2; dy <= 2; dy++)
                for (int dx = -2; dx <= 2; dx++) {
                    int mx = mx0 + dx, my = my0 + dy;
                    if ((!dx && !dy) || std::abs(mx) > 33 || std::abs(my) > 33) continue;
                    int c = sad8(x, y, n, mx, my);
                    if (c < best) {
                        best = c;
                        bx = mx;
                        by = my;
                    }
                }
            mv[n][0] = bx;
            mv[n][1] = by;
            total += best;
        }
        return total;
    }

    // ---- quantisation

    void quant_intra(int n, const float* f, int q, int16_t* out) const {
        int dcs = n < 4 ? y_dc_scale(q) : c_dc_scale(q);
        int dc = (int)std::lround(f[0]);
        out[0] = (int16_t)std::min(std::max((dc + (dcs >> 1)) / dcs, 0), 2047 / dcs);
        for (int i = 1; i < 64; i++) {
            float a = std::fabs(f[i]);
            int l;
            if (!p.mpeg_quant) l = (int)(a / (2 * q) + 0.375f);
            else l = (int)(a * 8.0f / (q * p.intra_m[i]) + 0.375f);
            l = std::min(l, 2047);
            out[i] = (int16_t)(f[i] < 0 ? -l : l);
        }
    }

    int quant_inter(const float* f, int q, int16_t* out) const {
        int nz = 0;
        for (int i = 0; i < 64; i++) {
            float a = std::fabs(f[i]);
            int l;
            if (!p.mpeg_quant) l = (int)(a / (2 * q) - 0.25f);
            else l = (int)(a * 8.0f / (q * p.inter_m[i]) - 0.25f);
            l = std::max(0, std::min(l, 2047));
            out[i] = (int16_t)(f[i] < 0 ? -l : l);
            nz |= l;
        }
        return nz != 0;
    }

    // ---- macroblocks

    int mb_q(int x, int y) const {
        if (!p.dquant) return p.qscale;
        static const int pattern[5] = {0, 1, -1, 2, -2};
        return std::min(std::max(p.qscale + pattern[(x * 7 + y * 3) % 5], 1), 31);
    }

    // the MCBPC dquant field, or -1 when no step of -2..2 reaches q
    static int dquant_code(int from, int to) {
        for (int i = 0; i < 4; i++)
            if (from + kDquant[i] == to) return i;
        return -1;
    }

    void encode_intra(int x, int y, bool pvop) {
        int q = cur_q, dq = -1;
        int want = mb_q(x, y);
        if (want != q) {
            dq = dquant_code(q, want);
            if (dq >= 0) q = want;
        }
        // (intra_dc_vlc_thr 0: every DC has its own VLC)
        pred.set_mv16(x, y, 0, 0);
        pred.qs[(size_t)y * mb_w + x] = (uint8_t)q;
        int16_t lv[6][64], res[6][64];
        int dir[6], dcp[6], gain = 0;
        for (int n = 0; n < 6; n++) {
            int px[64];
            float f[64];
            block_of(src, n, x, y, px);
            fdct(px, f);
            quant_intra(n, f, q, lv[n]);
            // the predictors, in the decoder's order: each block's DC and
            // AC are stored before the next block is predicted from them
            int scale = n < 4 ? y_dc_scale(q) : c_dc_scale(q);
            dcp[n] = pred.pred_dc(n, x, y, scale, &dir[n]);
            pred.store_dc(n, x, y, lv[n][0], scale);
            int16_t pr[64] = {0};
            pred.pred_ac(pr, n, x, y, dir[n], true, q);
            memcpy(res[n], lv[n], sizeof res[n]);
            for (int i = 1; i < 8; i++) {
                int k = dir[n] == 0 ? i * 8 : i;
                res[n][k] = (int16_t)(lv[n][k] - pr[k]);
                gain += std::abs(lv[n][k]) - std::abs(res[n][k]);
            }
            int16_t tmp[64];
            memcpy(tmp, lv[n], sizeof tmp);
            pred.pred_ac(tmp, n, x, y, dir[n], false, q);   // stores the levels
        }
        bool acp = p.ac_pred && gain > 0;
        int cbp = 0;
        for (int n = 0; n < 6; n++) {
            const int16_t* c = acp ? res[n] : lv[n];
            for (int i = 1; i < 64; i++)
                if (c[i]) {
                    cbp |= 32 >> n;
                    break;
                }
        }
        if (pvop) {
            bw.put(1, 0);
            bw.put(kInterMcbpc[(dq >= 0 ? 12 : 4) + (cbp & 3)]);
        } else {
            bw.put(kIntraMcbpc[(dq >= 0 ? 4 : 0) + (cbp & 3)]);
        }
        bw.put(1, acp);
        bw.put(kCbpy[cbp >> 2]);
        if (dq >= 0) bw.put(2, (uint32_t)dq);
        cur_q = q;
        const Tables& t = tables();
        for (int n = 0; n < 6; n++) {
            put_dc(n, lv[n][0] - dcp[n]);
            if (cbp & (32 >> n)) {
                const uint8_t* scan = !acp ? kZigzag : dir[n] == 0 ? kAltVertical : kAltHorizontal;
                put_block(t.intra, acp ? res[n] : lv[n], scan, 1);
            }
        }
    }

    void encode_p_mb(int x, int y) {
        int px, py;
        pred.pred_mv(0, x, y, &px, &py);
        int mx, my;
        int cost = search16(x, y, px, py, &mx, &my);
        // intra if the block's own spread is well under the inter cost
        const Plane& sp = src.p[0];
        int sum = 0;
        for (int i = 0; i < 16; i++)
            for (int j = 0; j < 16; j++) sum += sp.at(x * 16, y * 16 + i)[j];
        int mean = (sum + 128) >> 8, dev = 0;
        for (int i = 0; i < 16; i++)
            for (int j = 0; j < 16; j++) dev += std::abs(sp.at(x * 16, y * 16 + i)[j] - mean);
        if (dev + 500 < cost) {
            encode_intra(x, y, true);
            return;
        }
        pred.pred_mv(0, x, y, &px, &py);   // (pred_mv may write; recompute)
        MbData mb;
        mb.intra = false;
        mb.skip = false;
        mb.mv4 = false;
        mb.mv[0][0] = mx;
        mb.mv[0][1] = my;
        if (p.mv4) {
            int mv[4][2];
            int c4 = search8(x, y, mx, my, mv);
            int c1 = sad16(x, y, x * 16 + (mx >> 1), y * 16 + (my >> 1),
                           ((my & 1) << 1) | (mx & 1), INT32_MAX);
            if (c4 + 8 * cur_q < c1) {
                mb.mv4 = true;
                memcpy(mb.mv, mv, sizeof mv);
            }
        }
        // the prediction, through the decoder's own motion compensation
        uint8_t* dy = pic.p[0].at(x * 16, y * 16);
        uint8_t* du = pic.p[1].at(x * 8, y * 8);
        uint8_t* dv = pic.p[2].at(x * 8, y * 8);
        dec.motion(mb, x, y, dy, du, dv);
        int q = cur_q, dq = -1;
        int want = mb_q(x, y);
        if (want != q) {
            dq = dquant_code(q, want);
            if (dq >= 0) q = want;
        }
        int16_t lv[6][64];
        int cbp = 0;
        for (int n = 0; n < 6; n++) {
            int a[64], b[64];
            float f[64];
            block_of(src, n, x, y, a);
            block_of(pic, n, x, y, b);
            for (int i = 0; i < 64; i++) a[i] -= b[i];
            fdct(a, f);
            int16_t raster[64];
            if (quant_inter(f, q, raster)) cbp |= 32 >> n;
            memcpy(lv[n], raster, sizeof raster);
        }
        if (!mb.mv4 && !mx && !my && !cbp && dq < 0) {   // not coded
            bw.put(1, 1);
            pred.set_mv16(x, y, 0, 0);
            pred.qs[(size_t)y * mb_w + x] = (uint8_t)cur_q;
            pred.clear_intra(x, y);
            return;
        }
        bw.put(1, 0);
        int type = mb.mv4 ? 16 : dq >= 0 ? 8 : 0;
        if (mb.mv4 && dq >= 0) {   // no inter4v+q in MPEG-4: keep the quantiser
            dq = -1;
            q = cur_q;
            // requantise at the running quantiser
            cbp = 0;
            for (int n = 0; n < 6; n++) {
                int a[64], b[64];
                float f[64];
                block_of(src, n, x, y, a);
                block_of(pic, n, x, y, b);
                for (int i = 0; i < 64; i++) a[i] -= b[i];
                fdct(a, f);
                if (quant_inter(f, q, lv[n])) cbp |= 32 >> n;
            }
        }
        bw.put(kInterMcbpc[type + (cbp & 3)]);
        bw.put(kCbpy[(cbp >> 2) ^ 0xf]);
        if (dq >= 0) bw.put(2, (uint32_t)dq);
        cur_q = q;
        if (!mb.mv4) {
            put_mvd(mx - px);
            put_mvd(my - py);
            pred.set_mv16(x, y, mx, my);
        } else {
            for (int n = 0; n < 4; n++) {
                int qx, qy;
                pred.pred_mv(n, x, y, &qx, &qy);
                put_mvd(mb.mv[n][0] - qx);
                put_mvd(mb.mv[n][1] - qy);
                int16_t* m = pred.mv_at(n, x, y);
                m[0] = (int16_t)mb.mv[n][0];
                m[1] = (int16_t)mb.mv[n][1];
            }
        }
        pred.qs[(size_t)y * mb_w + x] = (uint8_t)q;
        pred.clear_intra(x, y);
        const Tables& t = tables();
        for (int n = 0; n < 6; n++)
            if (cbp & (32 >> n)) put_block(t.inter, lv[n], kZigzag, 0);
    }

    // one frame (I420 at the stream's size) -> one VOP in ``bw.out``
    bool encode(const uint8_t* y, const uint8_t* u, const uint8_t* v) {
        load(y, u, v);
        bool intra = frame % kGop == 0;
        bw = BitWriter();
        if (intra && p.inband) {
            BitWriter h;
            write_vol(h);
            bw.out = h.out;
        }
        int64_t t = (int64_t)frame * p.time_inc;
        int64_t sec = t / p.time_res;
        bw.start_code(0xb6);
        bw.put(2, intra ? 0 : 1);
        for (int64_t i = last_sec; i < sec; i++) bw.put(1, 1);
        bw.put(1, 0);
        last_sec = sec;
        bw.put(1, 1);
        bw.put(bits_for(p.time_res), (uint32_t)(t % p.time_res));
        bw.put(1, 1);
        bw.put(1, 1);   // vop_coded
        if (!intra) {
            if (p.rounding) no_rnd = !no_rnd;
            else no_rnd = false;
            bw.put(1, no_rnd);
        } else {
            no_rnd = false;
        }
        dec.no_rnd = no_rnd;
        bw.put(3, 0);   // intra_dc_vlc_thr
        bw.put(5, (uint32_t)p.qscale);
        if (!intra) bw.put(3, (uint32_t)p.fcode);
        cur_q = p.qscale;
        pred.start_packet(0, 0);
        for (int my = 0; my < mb_h; my++) {
            if (p.packet_rows && my && my % p.packet_rows == 0) {
                // a video packet: stuffing, resync marker, its header
                bw.stuff();
                int len = intra ? 16 : p.fcode + 15;
                bw.put(len, 0);
                bw.put(1, 1);
                bw.put(bits_for(mb_w * mb_h), (uint32_t)(my * mb_w));
                bw.put(5, (uint32_t)cur_q);
                bw.put(1, 0);   // header_extension_code
                pred.start_packet(0, my);
            }
            for (int mx = 0; mx < mb_w; mx++) {
                pred.next_mb(mx, my);
                if (intra) encode_intra(mx, my, false);
                else encode_p_mb(mx, my);
            }
        }
        bw.stuff();
        frame++;
        int rc = dec.decode(bw.out.data(), (int64_t)bw.out.size());
        if (rc != OM4_OK) CORRUPT("the encoder's own VOP did not decode");
        return intra;
    }
};

// BGR24 (rgb = 0) or RGB24 (rgb = 1) -> I420 in OpenCV's cvtColor
// arithmetic (io/yuv.rgb_to_i420): BT.601 video range at 20-bit fixed
// point, round half up; each 2x2 block's chroma is its top-left pixel's.
// w and h even.
void to_i420(const uint8_t* px3, int w, int h, int rgb, uint8_t* y,
             uint8_t* u, uint8_t* v) {
    const int bi = rgb ? 2 : 0, ri = 2 - bi;
    const int S = 20, HALF = 1 << (S - 1);
    for (int r = 0; r < h; r++) {
        const uint8_t* px = px3 + (size_t)r * w * 3;
        uint8_t* py = y + (size_t)r * w;
        for (int c = 0; c < w; c++) {
            int B = px[3 * c + bi], G = px[3 * c + 1], R = px[3 * c + ri];
            py[c] = clip8((269484 * R + 528482 * G + 102760 * B + HALF + (16 << S)) >> S);
        }
        if (r & 1) continue;
        uint8_t* pu = u + (size_t)(r / 2) * (w / 2);
        uint8_t* pv = v + (size_t)(r / 2) * (w / 2);
        for (int c = 0; c < w; c += 2) {
            int B = px[3 * c + bi], G = px[3 * c + 1], R = px[3 * c + ri];
            pu[c / 2] = clip8((-155188 * R - 305135 * G + 460324 * B + HALF + (128 << S)) >> S);
            pv[c / 2] = clip8((460324 * R - 385875 * G - 74448 * B + HALF + (128 << S)) >> S);
        }
    }
}

}  // namespace

// ===================================================================== C API

extern "C" {

// xvid_tag: the container's fourcc is one FFmpeg takes for Xvid's
// (XVID, XVIX, RMP4, ZMP4, SIPP) when no user data names the writer
void* om4_dec_new(int xvid_tag) {
    tables();
    Decoder* d = new Decoder();
    d->xvid_tag = xvid_tag != 0;
    return d;
}

void om4_dec_free(void* h) { delete (Decoder*)h; }

// Parse headers (a DecoderSpecificInfo, or a sample's in-band headers)
// without decoding a VOP; wh: the VOL's width and height
int om4_dec_headers(void* h, const uint8_t* data, int64_t n, int64_t* wh,
                    char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        d->decode(data, n, true);
        if (!d->vol.valid) CORRUPT("no VOL header");
        wh[0] = d->vol.width;
        wh[1] = d->vol.height;
        return OM4_OK;
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// Decode one sample.  On OM4_OK the picture's display size is in
// wh[0..1]; om4_dec_output copies its I420 planes out.
int om4_dec_decode(void* h, const uint8_t* data, int64_t n, int64_t* wh,
                   char* msg, int64_t cap, int cut) {
    Decoder* d = (Decoder*)h;
    d->cut = cut != 0;
    try {
        int rc = d->decode(data, n);
        if (rc != OM4_OK) return rc;
        wh[0] = d->vol.width;
        wh[1] = d->vol.height;
        return OM4_OK;
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// The end of the stream: OM4_OK (the last picture again, its size in
// wh[0..1]) where the last VOP was not coded, else OM4_NO_FRAME.
int om4_dec_flush(void* h, int64_t* wh) {
    Decoder* d = (Decoder*)h;
    if (!d->skipped_last || !d->have_ref) return OM4_NO_FRAME;
    d->skipped_last = false;
    wh[0] = d->vol.width;
    wh[1] = d->vol.height;
    return OM4_OK;
}

// the last concealment (Decoder::concealed): VOP type (1 I, 2 P; 0 none
// yet), the macroblock that failed or the first missing one, whether the
// slice ended before it, the macroblocks that kept their vectors, whether
// guess_mv searched, whether the damaged ones were taken as intra
void om4_dec_concealment(void* h, int64_t* out) {
    for (int i = 0; i < 6; i++) out[i] = ((Decoder*)h)->concealed[i];
}

void om4_dec_output(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
    ((Decoder*)h)->output(y, u, v);
}

void om4_to_i420(const uint8_t* px3, int w, int h, int rgb, uint8_t* y,
                 uint8_t* u, uint8_t* v) {
    to_i420(px3, w, h, rgb, y, u, v);
}

// 16-bit RGB or RGBA (native samples, alpha dropped) -> BGR24, as swscale
// converts rgb48be/rgba64be (ffmpeg_dsp.h's rgb48_to_bgr)
void om4_rgb48_to_bgr(const uint16_t* rgb, int channels, int64_t n, uint8_t* bgr) {
    ffdsp::rgb48_to_bgr(rgb, channels, n, bgr);
}

// yuv420p (full = 0) or yuvj420p (full = 1) planes -> BGR24, as swscale
// converts them (its scaler at an odd height, the chroma sited at hpos,
// vpos: 1/256 of a luma sample, -1 for the default centred site)
void om4_yuv420_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                       int w, int h, int ystride, int cstride, int full, int hpos, int vpos,
                       int matrix, uint8_t* bgr) {
    ffdsp::yuv_to_bgr(y, ystride, u, v, cstride, w, h, 1, 1,
                      ffdsp::yuv_coeffs(matrix, full != 0), bgr, hpos, vpos);
}

// Planes of any subsampling (Y w x h, U and V at ceil(w >> hshift) x
// ceil(h >> vshift)) -> BGR24 at the same size, as swscale converts them;
// through its scaler alone where ``scaler`` (a format its unscaled
// yuv2rgb does not take, such as yuva422p)
void om4_yuv_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v, int w, int h,
                    int ystride, int cstride, int hshift, int vshift, int full, int hpos,
                    int vpos, int matrix, int scaler, uint8_t* bgr) {
    const ffdsp::YuvCoeffs k = ffdsp::yuv_coeffs(matrix, full != 0);
    if (scaler)
        ffdsp::scale_to_bgr(y, ystride, u, v, cstride, w, h, hshift, vshift, k, bgr, w, h, hpos, vpos);
    else
        ffdsp::yuv_to_bgr(y, ystride, u, v, cstride, w, h, hshift, vshift, k, bgr, hpos, vpos);
}

// 10- or 12-bit planes (native 16-bit samples; yuv4xxp10/12) -> BGR24 at
// the same size, as swscale converts them: always through its scaler
void om4_yuv16_to_bgr(const uint16_t* y, const uint16_t* u, const uint16_t* v, int w, int h,
                      int ystride, int cstride, int hshift, int vshift, int bits, int full, int hpos,
                      int vpos, int matrix, uint8_t* bgr) {
    const ffdsp::YuvCoeffs k = ffdsp::yuv_coeffs(matrix, full != 0);
    ffdsp::scale_to_bgr(y, ystride, u, v, cstride, w, h, hshift, vshift, k, bgr, w, h, hpos, vpos, bits);
}

// The same planes (sw x sh) -> BGR24 at dw x dh, scaled as swscale scales
// them; 0, or -1 where swscale would take a path ffmpeg_dsp.h lacks
int om4_yuv420_scale_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                            int sw, int sh, int ystride, int cstride, int full, int hpos,
                            int vpos, int matrix, int dw, int dh, uint8_t* bgr) {
    return ffdsp::scale_to_bgr(y, ystride, u, v, cstride, sw, sh, 1, 1,
                               ffdsp::yuv_coeffs(matrix, full != 0), bgr, dw, dh, hpos, vpos)
               ? 0
               : -1;
}

// ---- encoder

// params: width, height, qscale, time_res, time_inc, inband,
// packet_rows, rounding, mv4, ac_pred, mpeg_quant, dquant; matrices (128
// bytes, raster order) when mpeg_quant
void* om4_enc_new(const int64_t* prm, const uint8_t* matrices, char* msg, int64_t cap) {
    try {
        tables();
        EncParams ep;
        ep.width = (int)prm[0];
        ep.height = (int)prm[1];
        ep.qscale = (int)prm[2];
        ep.time_res = (int)prm[3];
        ep.time_inc = (int)prm[4];
        ep.inband = prm[5] != 0;
        ep.packet_rows = (int)prm[6];
        ep.rounding = (int)prm[7];
        ep.mv4 = prm[8] != 0;
        ep.ac_pred = prm[9] != 0;
        ep.mpeg_quant = prm[10] != 0;
        ep.dquant = (int)prm[11];
        if (ep.width < 2 || ep.height < 2 || ep.width % 2 || ep.height % 2 ||
            ep.width > 8190 || ep.height > 8190)
            CORRUPT("frame size %dx%d (even, 2..8190)", ep.width, ep.height);
        if (ep.qscale < 1 || ep.qscale > 31) CORRUPT("qscale %d (1..31)", ep.qscale);
        if (ep.time_res < 1 || ep.time_res > 65535 || ep.time_inc < 1 || ep.time_inc >= 65536)
            CORRUPT("time base %d/%d", ep.time_inc, ep.time_res);
        if (ep.mpeg_quant) {
            memcpy(ep.intra_m, matrices, 64);
            memcpy(ep.inter_m, matrices + 64, 64);
        }
        Encoder* e = new Encoder();
        e->open(ep);
        return e;
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return nullptr;
    }
}

void om4_enc_free(void* h) { delete (Encoder*)h; }

// the VOS/VO/VOL headers (an MP4 DecoderSpecificInfo); returns the length
int64_t om4_enc_headers(void* h, uint8_t* out, int64_t cap) {
    Encoder* e = (Encoder*)h;
    int64_t n = (int64_t)e->vol_bytes.size();
    if (n <= cap) memcpy(out, e->vol_bytes.data(), n);
    return n;
}

// Encode one I420 frame; returns the VOP's length (its bytes are fetched
// with om4_enc_take), or -1 on error; *key = 1 for an I-VOP.
int64_t om4_enc_frame(void* h, const uint8_t* y, const uint8_t* u, const uint8_t* v,
                      int64_t* key, char* msg, int64_t cap) {
    Encoder* e = (Encoder*)h;
    try {
        *key = e->encode(y, u, v);
        return (int64_t)e->bw.out.size();
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return -1;
    }
}

void om4_enc_take(void* h, uint8_t* out) {
    Encoder* e = (Encoder*)h;
    memcpy(out, e->bw.out.data(), e->bw.out.size());
}

// the reconstruction of the last frame, I420 at the stream's size
void om4_enc_recon(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
    ((Encoder*)h)->dec.output(y, u, v);
}

}  // extern "C"
