// H.263 baseline video (ITU-T H.263 without PLUSPTYPE), decoded in host
// C++ as FFmpeg 8's h263 decoder (ituh263dec.c, h263dec.c) decodes it for
// cv2.VideoCapture, bit for bit:
//
//   * the picture header: PSC, TR, PTYPE with the five source formats
//     (sub-QCIF 128x96, QCIF 176x144, CIF 352x288, 4CIF 704x576, 16CIF
//     1408x1152), I- and P-pictures, PQUANT, the CPM bit (FFmpeg reads no
//     PSBI after it) and PEI/PSUPP;
//   * GOB headers (GBSC, GN, GFID, GQUANT), found as ff_h263_resync finds
//     them: a macroblock followed by 16 zero bits ends a slice; each GOB
//     starts a new one for motion-vector prediction;
//   * the macroblock layer: COD, MCBPC, CBPY, DQUANT, an 8-bit INTRADC with
//     no DC/AC prediction, TCOEF with H.263's escape (LAST, RUN 6, LEVEL 8,
//     and FFmpeg's 11-bit level after -128), MVD with ff_h263_pred_motion
//     (no MPEG-4 above-right rule at a slice's first line);
//   * H.263 dequantisation applied at reconstruction (int16 wrap, as FFmpeg
//     stores it), the simple IDCT (ffmpeg_dsp.h) and half-pel motion
//     compensation over edge-clamped references with rounding, 16x16 or
//     8x8 vectors with H.263's chroma vector (mpeg_common.h);
//   * Annex F, advanced prediction: 8x8 vectors and overlapped block motion
//     compensation (apply_obmc, put_obmc), the right neighbour's vectors
//     previewed from the bitstream as FFmpeg's preview_obmc reads them
//     (before the current macroblock's own 16x16 vector is stored).
//
// PLUSPTYPE (H.263+), syntax-based arithmetic coding (Annex E), PB-frames
// (Annex G) and unrestricted vectors (Annex D) outside PLUSPTYPE raise
// H263_UNSUPPORTED with a message naming the feature.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "ffmpeg_dsp.h"
#include "mpeg_common.h"

namespace {

using namespace mpegc;
using ffdsp::idct;

enum { H263_OK = kOk, H263_NO_FRAME = kNoFrame, H263_UNSUPPORTED = kUnsupported,
       H263_CORRUPT = kCorrupt };

// what a stream reached (h263.py's FEATURES, in order)
enum Feature {
    F_SUB_QCIF, F_QCIF, F_CIF, F_4CIF, F_16CIF, F_P_PICTURES, F_SKIPPED_MB, F_INTRA_IN_P,
    F_DQUANT, F_MV4, F_ADVANCED_PREDICTION, F_GOB_HEADERS, F_ESCAPE, F_ESCAPE_EXTENDED,
    F_PEI, F_SIZE_CHANGE, F_MCBPC_STUFFING, F_DC_128,
};

// ff_h263_format: the source formats' sizes (0 forbidden, 6 and 7 are
// PLUSPTYPE's)
const int kFormats[6][2] = {{0, 0}, {128, 96}, {176, 144}, {352, 288}, {704, 576}, {1408, 1152}};

struct Tables {
    Vlc intra_mcbpc, inter_mcbpc, cbpy, mvd;
    RunLevel tcoef;
    Tables() {
        intra_mcbpc.build(kIntraMcbpc, 9, 9);
        inter_mcbpc.build(kInterMcbpc, 28, 13);
        cbpy.build(kCbpy, 16, 6);
        mvd.build(kMvd, 33, 12);
        tcoef.build(kInterTcoef, kInterMaxLevel0, 27, kInterMaxLevel1, 41);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// Annex F's weights of the current block's own prediction, and of the
// above/below and left/right neighbours' (each used on its half)
const uint8_t kObmcMid[8][8] = {{4, 5, 5, 5, 5, 5, 5, 4}, {5, 5, 5, 5, 5, 5, 5, 5},
                                {5, 5, 6, 6, 6, 6, 5, 5}, {5, 5, 6, 6, 6, 6, 5, 5},
                                {5, 5, 6, 6, 6, 6, 5, 5}, {5, 5, 6, 6, 6, 6, 5, 5},
                                {5, 5, 5, 5, 5, 5, 5, 5}, {4, 5, 5, 5, 5, 5, 5, 4}};
const uint8_t kObmcTopBottom[8][8] = {{2, 2, 2, 2, 2, 2, 2, 2}, {1, 1, 2, 2, 2, 2, 1, 1},
                                      {1, 1, 1, 1, 1, 1, 1, 1}, {1, 1, 1, 1, 1, 1, 1, 1},
                                      {1, 1, 1, 1, 1, 1, 1, 1}, {1, 1, 1, 1, 1, 1, 1, 1},
                                      {1, 1, 2, 2, 2, 2, 1, 1}, {2, 2, 2, 2, 2, 2, 2, 2}};
const uint8_t kObmcLeftRight[8][8] = {{2, 1, 1, 1, 1, 1, 1, 2}, {2, 2, 1, 1, 1, 1, 2, 2},
                                      {2, 2, 1, 1, 1, 1, 2, 2}, {2, 2, 1, 1, 1, 1, 2, 2},
                                      {2, 2, 1, 1, 1, 1, 2, 2}, {2, 2, 1, 1, 1, 1, 2, 2},
                                      {2, 2, 1, 1, 1, 1, 2, 2}, {2, 1, 1, 1, 1, 1, 1, 2}};

struct MbData {
    bool intra = false, skip = false, mv4 = false;
    int q = 1;
    int mv[4][2] = {};
    int16_t blk[6][64];
    int last[6];
};

enum { SLICE_OK, SLICE_END };

class Decoder {
  public:
    int width = 0, height = 0, mb_w = 0, mb_h = 0, gob_height = 1;
    Picture cur, ref;
    bool have_ref = false;
    MvPred mvp;
    std::vector<uint8_t> intra_mb;   // the picture's intra macroblocks (mb_type)
    BitReader br;
    int qscale = 1;
    bool inter = false, obmc = false;
    int mb_x = 0, mb_y = 0;
    int64_t last_resync = 0;
    int64_t features = 0;

    void feature(int f) { features |= (int64_t)1 << f; }

    // one packet: its picture (H263_OK, planes in ``ref``)
    int decode(const uint8_t* d, int64_t n) {
        br.reset(d, n);
        picture_header();
        if (inter && !have_ref) CORRUPT("a P-picture without a reference picture");
        mvp.init_mv(mb_w, mb_h);   // FFmpeg zeroes motion_val every picture
        intra_mb.assign((size_t)mb_w * mb_h, 0);
        mb_x = mb_y = 0;
        slice();
        while (mb_y < mb_h) {
            const int prev = mb_y * mb_w + mb_x;
            if (!resync()) CORRUPT("macroblocks %d on are missing (FFmpeg conceals them)", prev);
            if (prev < mb_y * mb_w + mb_x)
                CORRUPT("a GOB header skips macroblocks %d-%d (FFmpeg conceals them)", prev,
                        mb_y * mb_w + mb_x - 1);
            slice();
        }
        std::swap(cur, ref);
        have_ref = true;
        return H263_OK;
    }

    // ff_h263_decode_picture_header, H.263 version 1
    void picture_header() {
        uint32_t sc = br.get(14);
        for (int64_t i = br.left(); i > 24; i -= 8) {
            sc = ((sc << 8) | br.get(8)) & 0x3FFFFF;
            if (sc == 0x20) break;
        }
        if (sc != 0x20) CORRUPT("no picture start code");
        br.skip(8);   // TR
        if (!br.get1()) CORRUPT("PTYPE's marker bit is 0");
        if (br.get1()) CORRUPT("bad H.263 id bit");
        br.skip(3);   // split screen, document camera, freeze picture release
        const int format = (int)br.get(3);
        if (format >= 6) UNSUPPORTED("H.263+ picture headers (PLUSPTYPE)");
        if (!format) CORRUPT("forbidden source format 0");
        feature(F_SUB_QCIF + format - 1);
        inter = br.get1();
        if (br.get1()) UNSUPPORTED("unrestricted motion vectors (H.263 Annex D) outside PLUSPTYPE");
        if (br.get1()) UNSUPPORTED("syntax-based arithmetic coding (H.263 Annex E)");
        obmc = br.get1();
        if (br.get1()) UNSUPPORTED("PB-frames (H.263 Annex G)");
        qscale = (int)br.get(5);
        br.skip(1);   // CPM
        if (br.left() <= 0) CORRUPT("truncated picture header");
        while (br.get1()) {   // PEI, PSUPP
            feature(F_PEI);
            br.skip(8);
            if (br.left() <= 0) CORRUPT("truncated PSUPP");
        }
        br.check();
        if (inter) feature(F_P_PICTURES);
        if (obmc) feature(F_ADVANCED_PREDICTION);
        set_size(kFormats[format][0], kFormats[format][1]);
    }

    void set_size(int w, int h) {
        if (w == width && h == height) return;
        if (width) feature(F_SIZE_CHANGE);
        width = w;
        height = h;
        mb_w = (w + 15) / 16;
        mb_h = (h + 15) / 16;
        gob_height = h <= 400 ? 1 : h <= 800 ? 2 : 4;
        cur.alloc(mb_w, mb_h);
        ref.alloc(mb_w, mb_h);
        have_ref = false;
    }

    // h263_decode_gob_header at the reader's position
    bool gob_header() {
        if (br.show(16)) return false;
        br.skip(16);
        int64_t left = std::min<int64_t>(br.left(), 32);
        for (; left > 13; left--)
            if (br.get1()) break;
        if (left <= 13) return false;
        const int gn = (int)br.get(5);
        mb_x = 0;
        mb_y = gob_height * gn;
        br.skip(2);   // GFID
        qscale = (int)br.get(5);
        if (mb_y >= mb_h || !qscale) return false;
        feature(F_GOB_HEADERS);
        return true;
    }

    // ff_h263_resync: a GOB header where the slice ended, else the first
    // one found byte by byte from where the slice started
    bool resync() {
        if (br.show(16) == 0 && gob_header()) return true;
        br.pos = last_resync;
        br.align();
        for (int64_t left = br.left(); left > 16 + 1 + 5 + 5; left -= 8) {
            if (br.show(16) == 0) {
                const int64_t bak = br.pos;
                if (gob_header()) return true;
                br.pos = bak;
            }
            br.skip(8);
        }
        return false;
    }

    void set_q(int q) { qscale = std::min(std::max(q, 1), 31); }

    // decode_slice
    void slice() {
        last_resync = br.pos;
        mvp.first_line = true;
        mvp.resync_x = mb_x;
        mvp.resync_y = mb_y;
        set_q(qscale);
        MbData mb;
        for (; mb_y < mb_h; mb_y++) {
            for (; mb_x < mb_w; mb_x++) {
                if (mvp.resync_x == mb_x && mvp.resync_y + 1 == mb_y) mvp.first_line = false;
                const int ret = decode_mb(mb);
                if (!mb.mv4) {   // ff_h263_update_motion_val
                    const bool moved = !mb.intra && !mb.skip;
                    mvp.set_mv16(mb_x, mb_y, moved ? mb.mv[0][0] : 0, moved ? mb.mv[0][1] : 0);
                }
                reconstruct(mb);
                if (ret == SLICE_END) {
                    if (++mb_x >= mb_w) {
                        mb_x = 0;
                        mb_y++;
                    }
                    return;
                }
            }
            mb_x = 0;
        }
    }

    // ff_h263_decode_mb
    int decode_mb(MbData& mb) {
        const Tables& t = tables();
        const int xy = mb_y * mb_w + mb_x;
        mb.intra = mb.skip = mb.mv4 = false;
        int cbpc;
        if (inter) {
            while (true) {
                if (br.get1()) {   // COD: skipped
                    feature(F_SKIPPED_MB);
                    mb.skip = true;
                    mb.q = qscale;
                    mb.mv[0][0] = mb.mv[0][1] = 0;
                    for (int n = 0; n < 6; n++) mb.last[n] = -1;
                    intra_mb[xy] = 0;
                    return mb_end();
                }
                cbpc = br.vlc(t.inter_mcbpc);
                if (cbpc != 20) break;
                feature(F_MCBPC_STUFFING);
            }
            mb.intra = (cbpc & 4) != 0;
            if (mb.intra) feature(F_INTRA_IN_P);
        } else {
            while ((cbpc = br.vlc(t.intra_mcbpc)) == 8) feature(F_MCBPC_STUFFING);
            mb.intra = true;
        }
        const bool dquant = mb.intra && !inter ? (cbpc & 4) != 0 : (cbpc & 8) != 0;
        int cbpy = br.vlc(t.cbpy);
        if (!mb.intra) cbpy ^= 0xF;
        int cbp = (cbpc & 3) | (cbpy << 2);
        if (dquant) {
            feature(F_DQUANT);
            set_q(qscale + kDquant[br.get(2)]);
        }
        mb.q = qscale;
        intra_mb[xy] = mb.intra;
        if (!mb.intra) {
            if (!(cbpc & 16)) {
                int px, py;
                mvp.pred_mv(0, mb_x, mb_y, &px, &py, false);
                mb.mv[0][0] = read_motion(br, t.mvd, px, 1);
                mb.mv[0][1] = read_motion(br, t.mvd, py, 1);
            } else {
                feature(F_MV4);
                mb.mv4 = true;
                for (int n = 0; n < 4; n++) {
                    int px, py;
                    mvp.pred_mv(n, mb_x, mb_y, &px, &py, false);
                    mb.mv[n][0] = read_motion(br, t.mvd, px, 1);
                    mb.mv[n][1] = read_motion(br, t.mvd, py, 1);
                    int16_t* m = mvp.mv_at(n, mb_x, mb_y);
                    m[0] = (int16_t)mb.mv[n][0];
                    m[1] = (int16_t)mb.mv[n][1];
                }
            }
        }
        for (int n = 0; n < 6; n++, cbp += cbp) decode_block(mb, n, (cbp & 32) != 0);
        if (obmc && !mb.intra && inter && mb_x + 1 < mb_w) preview_obmc();
        return mb_end();
    }

    // the per-macroblock end-of-slice check: 16 zero bits (or the end)
    int mb_end() {
        if (br.left() < 0) CORRUPT("bitstream overread (truncated picture)");
        uint32_t v = br.show(16);
        if (br.left() < 16) v >>= 16 - br.left();
        return v == 0 ? SLICE_END : SLICE_OK;
    }

    // h263_decode_block: levels in raster order, not yet dequantised
    void decode_block(MbData& mb, int n, bool coded) {
        const RunLevel& rl = tables().tcoef;
        int16_t* blk = mb.blk[n];
        memset(blk, 0, 64 * sizeof(int16_t));
        int i = 0;
        if (mb.intra) {
            int level = (int)br.get(8);
            if (level == 255) {
                level = 128;
                feature(F_DC_128);
            }
            blk[0] = (int16_t)level;
            i = 1;
        }
        if (!coded) {
            mb.last[n] = i - 1;
            return;
        }
        i--;
        while (true) {
            const int idx = br.vlc(rl.vlc);
            int run, level;
            if (idx == 102) {   // escape: LAST, RUN, LEVEL
                feature(F_ESCAPE);
                run = (int)br.get(7) + 1;   // LAST lands at bit 6: run + 64
                level = (int8_t)br.get(8);
                if (level == -128) {
                    feature(F_ESCAPE_EXTENDED);
                    const int lo = (int)br.get(5);
                    const int hi = (int)br.get(6);
                    level = lo | ((hi >= 32 ? hi - 64 : hi) * 32);
                }
            } else {
                run = rl.run[idx] + 1 + (rl.last[idx] ? 192 : 0);
                level = br.get1() ? -rl.level[idx] : rl.level[idx];
            }
            i += run;
            if (i >= 64) {   // the last coefficient, or a run past the block
                i = i - run + ((run - 1) & 63) + 1;
                if (i < 64) {
                    blk[kZigzag[i]] = (int16_t)level;
                    break;
                }
                CORRUPT("TCOEF run past the block's end at macroblock (%d, %d)", mb_x, mb_y);
            }
            blk[kZigzag[i]] = (int16_t)level;
        }
        mb.last[n] = i;
    }

    // preview_obmc: the next macroblock's vectors and type, read ahead
    // (the reader is restored)
    void preview_obmc() {
        const Tables& t = tables();
        const int64_t pos = br.pos;
        const int nx = mb_x + 1, xy = mb_y * mb_w + nx;
        int cbpc;
        while (true) {
            if (br.get1()) {
                mvp.set_mv16(nx, mb_y, 0, 0);
                intra_mb[xy] = 0;
                br.pos = pos;
                return;
            }
            cbpc = br.vlc(t.inter_mcbpc);
            if (cbpc != 20) break;
        }
        intra_mb[xy] = (cbpc & 4) != 0;
        if (!(cbpc & 4)) {
            br.vlc(t.cbpy);
            if (cbpc & 8) br.skip(2);
            if (!(cbpc & 16)) {
                int px, py;
                mvp.pred_mv(0, nx, mb_y, &px, &py, false);
                const int mx = read_motion(br, t.mvd, px, 1);
                const int my = read_motion(br, t.mvd, py, 1);
                mvp.set_mv16(nx, mb_y, mx, my);
            } else {
                for (int n = 0; n < 4; n++) {
                    int px, py;
                    mvp.pred_mv(n, nx, mb_y, &px, &py, false);
                    const int mx = read_motion(br, t.mvd, px, 1);
                    const int my = read_motion(br, t.mvd, py, 1);
                    int16_t* m = mvp.mv_at(n, nx, mb_y);
                    m[0] = (int16_t)mx;
                    m[1] = (int16_t)my;
                }
            }
        }
        br.pos = pos;
    }

    // ---- reconstruction (ff_mpv_reconstruct_mb)

    // dct_unquantize_h263_{intra,inter}: int16 results, as FFmpeg stores them
    static void dequant(int16_t* blk, int q, bool intra) {
        const int qmul = q << 1, qadd = (q - 1) | 1;
        int i = 0;
        if (intra) {
            blk[0] = (int16_t)(blk[0] * 8);   // ff_mpeg1_dc_scale_table
            i = 1;
        }
        for (; i < 64; i++) {
            const int l = blk[i];
            if (l) blk[i] = (int16_t)(l < 0 ? l * qmul - qadd : l * qmul + qadd);
        }
    }

    Edges edges() const { return Edges{mb_w * 16, mb_h * 16, width, height}; }

    void reconstruct(MbData& mb) {
        Plane* p = cur.p;
        const int x = mb_x, y = mb_y;
        uint8_t* dy = p[0].at(x * 16, y * 16);
        uint8_t* du = p[1].at(x * 8, y * 8);
        uint8_t* dv = p[2].at(x * 8, y * 8);
        const int ls = p[0].w, cs = p[1].w;
        uint8_t* dst[6] = {dy, dy + 8, dy + 8 * ls, dy + 8 * ls + 8, du, dv};
        const int stride[6] = {ls, ls, ls, ls, cs, cs};
        if (mb.intra) {
            for (int n = 0; n < 6; n++) {
                dequant(mb.blk[n], mb.q, true);
                idct(mb.blk[n], dst[n], stride[n], false);
            }
            return;
        }
        const Edges e = edges();
        if (obmc) {
            apply_obmc(dy, du, dv, ls, cs);
        } else if (mb.mv4) {
            int sumx = 0, sumy = 0;
            for (int i = 0; i < 4; i++) {
                hpel_motion(ref.p[0], e, x * 16 + (i & 1) * 8, y * 16 + (i >> 1) * 8, mb.mv[i][0],
                            mb.mv[i][1], false, dy + (i & 1) * 8 + (i >> 1) * 8 * ls, ls);
                sumx += mb.mv[i][0];
                sumy += mb.mv[i][1];
            }
            chroma_4mv_motion(ref, e, x, y, sumx, sumy, false, du, dv, cs);
        } else {
            mpeg_motion(ref, e, x, y, mb.mv[0][0], mb.mv[0][1], false, dy, du, dv, ls, cs);
        }
        for (int n = 0; n < 6; n++) {
            if (mb.last[n] < 0) continue;
            dequant(mb.blk[n], mb.q, false);
            idct(mb.blk[n], dst[n], stride[n], true);
        }
    }

    // apply_obmc: each 8x8 luma block blended from its own vector's
    // prediction and its neighbours' (a missing or intra neighbour's taken
    // from the block itself; below, the macroblock's own lower row), the
    // chroma from the sum of the four own vectors
    void apply_obmc(uint8_t* dy, uint8_t* du, uint8_t* dv, int ls, int cs) {
        const int x = mb_x, y = mb_y, xy = y * mb_w + x;
        int16_t cache[4][4][2];
        auto put = [&](int r, int c, const int16_t* m) {
            cache[r][c][0] = m[0];
            cache[r][c][1] = m[1];
        };
        put(1, 1, mvp.mv_at(0, x, y));
        put(1, 2, mvp.mv_at(1, x, y));
        put(2, 1, mvp.mv_at(2, x, y));
        put(2, 2, mvp.mv_at(3, x, y));
        put(3, 1, mvp.mv_at(2, x, y));
        put(3, 2, mvp.mv_at(3, x, y));
        const bool above = y > 0 && !intra_mb[xy - mb_w];
        put(0, 1, above ? mvp.mv_at(2, x, y - 1) : cache[1][1]);
        put(0, 2, above ? mvp.mv_at(3, x, y - 1) : cache[1][2]);
        const bool left = x > 0 && !intra_mb[xy - 1];
        put(1, 0, left ? mvp.mv_at(1, x - 1, y) : cache[1][1]);
        put(2, 0, left ? mvp.mv_at(3, x - 1, y) : cache[2][1]);
        const bool right = x + 1 < mb_w && !intra_mb[xy + 1];
        put(1, 3, right ? mvp.mv_at(0, x + 1, y) : cache[1][2]);
        put(2, 3, right ? mvp.mv_at(2, x + 1, y) : cache[2][2]);
        const Edges e = edges();
        int sumx = 0, sumy = 0;
        for (int i = 0; i < 4; i++) {
            const int c = (i & 1) + 1, r = (i >> 1) + 1;
            // mid, top, left, right, bottom
            const int16_t* mv[5] = {cache[r][c], cache[r - 1][c], cache[r][c - 1], cache[r][c + 1],
                                    cache[r + 1][c]};
            uint8_t pred[5][64];
            for (int k = 0; k < 5; k++)
                hpel_motion(ref.p[0], e, x * 16 + (i & 1) * 8, y * 16 + (i >> 1) * 8, mv[k][0], mv[k][1],
                            false, pred[k], 8);
            uint8_t* d = dy + (i & 1) * 8 + (i >> 1) * 8 * ls;
            for (int yy = 0; yy < 8; yy++)
                for (int xx = 0; xx < 8; xx++) {
                    const int j = yy * 8 + xx;
                    const int tb = kObmcTopBottom[yy][xx], lr = kObmcLeftRight[yy][xx];
                    const int v = kObmcMid[yy][xx] * pred[0][j] + (yy < 4 ? tb * pred[1][j] : tb * pred[4][j]) +
                                  (xx < 4 ? lr * pred[2][j] : lr * pred[3][j]);
                    d[yy * ls + xx] = (uint8_t)((v + 4) >> 3);
                }
            sumx += mv[0][0];
            sumy += mv[0][1];
        }
        chroma_4mv_motion(ref, e, x, y, sumx, sumy, false, du, dv, cs);
    }

    void output(uint8_t* y, uint8_t* u, uint8_t* v) const {
        const int w = width, h = height, cw = (w + 1) / 2, ch = (h + 1) / 2;
        for (int r = 0; r < h; r++) memcpy(y + (size_t)r * w, ref.p[0].at(0, r), w);
        for (int r = 0; r < ch; r++) {
            memcpy(u + (size_t)r * cw, ref.p[1].at(0, r), cw);
            memcpy(v + (size_t)r * cw, ref.p[2].at(0, r), cw);
        }
    }
};

}  // namespace

// ===================================================================== C API

extern "C" {

void* h263_dec_new() {
    tables();
    return new Decoder();
}

void h263_dec_free(void* h) { delete (Decoder*)h; }

// Decode one packet.  On H263_OK the picture's size is in wh[0..1];
// h263_dec_output copies its I420 planes out.
int h263_dec_decode(void* h, const uint8_t* data, int64_t n, int64_t* wh, char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        const int rc = d->decode(data, n);
        wh[0] = d->width;
        wh[1] = d->height;
        return rc;
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

void h263_dec_output(void* h, uint8_t* y, uint8_t* u, uint8_t* v) { ((Decoder*)h)->output(y, u, v); }

int64_t h263_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
