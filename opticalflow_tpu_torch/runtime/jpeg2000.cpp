// JPEG 2000 decoded in host C++ as FFmpeg 8's jpeg2000 decoder
// (jpeg2000dec.c, jpeg2000.c, jpeg2000dwt.c, mqcdec.c, mqc.c,
// jpeg2000dsp.c with its x86 ICT) decodes it for cv2.VideoCapture, bit
// for bit:
//
//   * the JP2 wrapper (jp2_find_codestream: the signature box, the jp2h
//     header's colr box, whose enumerated colour space picks the pixel
//     format list) or a bare codestream, searched for its SOC marker;
//   * the main and tile-part headers: SIZ, COD, COC, QCD, QCC, POC, SOT
//     with its tile-parts, SOD, and COM, TLM, PLT, PLM and CRG passed
//     over; a marker segment whose length runs past the data ends the
//     headers (FFmpeg's "Missing EOC Marker" at normal compliance);
//   * the packets of each tile in the five progression orders (LRCP,
//     RLCP, RPCL, PCRL, CPRL) and the POC's, with SOP and EPH markers,
//     the inclusion and zero bit-plane tag trees, the pass counts, Lblock
//     and the code-word segments of the terminating code-block styles;
//   * EBCOT tier 1: the MQ decoder (FFmpeg's inverted-C form, 0xFFFF after
//     each segment), the significance propagation, magnitude refinement
//     and clean-up passes with their contexts, and the code-block style
//     bits (bypass, context reset, terminate each pass, vertically causal
//     contexts, segmentation symbols);
//   * dequantisation into the tile's float (9/7) or integer (5/3) planes
//     at FFmpeg's step sizes (init_band_stepsize: the 9/7 gains folded in
//     with pow in double);
//   * the inverse 9/7 in float (sr_1d97_float, no FMA contraction: the
//     library is built with -ffp-contract=off) and the inverse 5/3 in
//     integers, over each level's rows then columns as dwt_decode* walks
//     them;
//   * the inverse ICT (the x86 FMA3 ict_float cv2's libavcodec runs:
//     fused multiply-adds in its order, std::fmaf here) or RCT, the level
//     shift, lrintf's rounding and the clip to the component's depth.
//
// The planes come out as the decoder's pixel format lays them: rgb24,
// rgba, rgb48, rgba64, ya8, ya16 and pal8 (with the JP2 palette) packed,
// gray8 or gray16, yuv410p, yuv411p, yuv420p, yuv422p, yuv440p or yuv444p,
// 4:2:0, 4:2:2 and 4:4:4 at 9, 10, 12, 14 and 16 bits (16-bit samples)
// and with an alpha plane, chosen as get_siz chooses from the colr box's
// list. What the port leaves out (image offsets, region of interest
// shifts, packed packet headers, High-Throughput code-blocks, Digital
// Cinema's XYZ) raises
// J2K_UNSUPPORTED with a message naming it; damaged data and what FFmpeg's
// decoder refuses raise J2K_CORRUPT.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <iterator>
#include <string>
#include <vector>

namespace {

enum { J2K_OK = 0, J2K_NO_PICTURE = 1, J2K_UNSUPPORTED = 2, J2K_CORRUPT = 3 };

struct Failure {
    int kind;
    std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Failure{J2K_CORRUPT, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Failure{J2K_UNSUPPORTED, m}; }

// the decoder's feature bits (jpeg2000.py's FEATURES, in order)
enum Feature {
    F_JP2 = 0, F_CODESTREAM, F_COLR_SRGB, F_COLR_GRAY, F_COLR_SYCC, F_RGB24, F_GRAY8, F_YUV410,
    F_YUV411, F_YUV420, F_YUV422, F_YUV440, F_YUV444, F_DWT97, F_DWT53, F_ICT, F_RCT, F_LRCP,
    F_RLCP, F_RPCL, F_PCRL, F_CPRL, F_TILES, F_TILE_PARTS, F_SOP, F_EPH, F_LAYERS, F_PRECINCTS,
    F_POC, F_COC, F_QCC, F_QSTY_NONE, F_QSTY_DERIVED, F_QSTY_EXPOUNDED, F_BYPASS, F_RESET,
    F_TERMALL, F_VSC, F_PREDTERM, F_SEGSYM, F_ODD_SIZE, F_COM, F_GRAY16, F_RGB48, F_YUV_DEEP,
    F_PAL8, F_ALPHA,
};

constexpr int kMaxReslevels = 33;
constexpr int kMaxDeclevels = 32;
constexpr int kMaxPasses = 100;
constexpr int kMaxPocs = 32;
constexpr int kTileParts = 32;

// markers
constexpr int SOC = 0xff4f, SIZ = 0xff51, COD = 0xff52, COC = 0xff53, TLM = 0xff55,
              PLM = 0xff57, PLT = 0xff58, QCD = 0xff5c, QCC = 0xff5d, RGN = 0xff5e,
              POC = 0xff5f, PPM = 0xff60, PPT = 0xff61, CRG = 0xff63, COM = 0xff64,
              SOT = 0xff90, SOP = 0xff91, EPH = 0xff92, SOD = 0xff93, EOC = 0xffd9,
              CAP = 0xff50, CPF = 0xff59;

// coding style bits
constexpr int CSTY_PREC = 0x01, CSTY_SOP = 0x02, CSTY_EPH = 0x04;
constexpr int CBLK_BYPASS = 0x01, CBLK_RESET = 0x02, CBLK_TERMALL = 0x04, CBLK_VSC = 0x08,
              CBLK_PREDTERM = 0x10, CBLK_SEGSYM = 0x20, CBLK_HT = 0x40;
enum { DWT97 = 0, DWT53 = 1 };
enum { QSTY_NONE = 0, QSTY_SI = 1, QSTY_SE = 2 };
enum { PGOD_LRCP = 0, PGOD_RLCP = 1, PGOD_RPCL = 2, PGOD_PCRL = 3, PGOD_CPRL = 4 };
constexpr int HAD_COC = 0x01, HAD_QCC = 0x02;

// tier-1 flags (jpeg2000.h)
constexpr int T1_SIG_N = 0x0001, T1_SIG_E = 0x0002, T1_SIG_W = 0x0004, T1_SIG_S = 0x0008,
              T1_SIG_NE = 0x0010, T1_SIG_NW = 0x0020, T1_SIG_SE = 0x0040, T1_SIG_SW = 0x0080,
              T1_SIG_NB = 0x00ff, T1_SGN_N = 0x0100, T1_SGN_S = 0x0200, T1_SGN_W = 0x0400,
              T1_SGN_E = 0x0800, T1_VIS = 0x1000, T1_SIG = 0x2000, T1_REF = 0x4000;
constexpr int MQC_CX_UNI = 17, MQC_CX_RL = 18;

// the 9/7 lifting constants (jpeg2000dwt.h)
constexpr float F_LFTG_K = 1.230174104914001f;
constexpr float F_LFTG_X = 0.812893066115961f;
constexpr float F_LFTG_ALPHA = 1.586134342059924f;
constexpr float F_LFTG_BETA = 0.052980118572961f;
constexpr float F_LFTG_GAMMA = 0.882911075530934f;
constexpr float F_LFTG_DELTA = 0.443506852043971f;

// the inverse ICT's factors (jpeg2000dsp.c's f_ict_params, x86's pf_ict*)
constexpr float kIct0 = 1.402f, kIct1 = 0.34413f, kIct2 = 0.71414f, kIct3 = 1.772f;

inline int ceildiv(int64_t a, int64_t b) { return int((a + b - 1) / b); }
inline int ceildivpow2(int64_t a, int b) { return int(-((-a) >> b)); }

// ---------------------------------------------------------------- MQ decoder

struct MqState {
    uint16_t qe;
    uint8_t nmps, nlps, sw;
};
const MqState kMqStates[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

struct MqTables {
    uint16_t qe[94];
    uint8_t nlps[94], nmps[94];
    MqTables() {
        for (int i = 0; i < 47; i++) {
            qe[2 * i] = qe[2 * i + 1] = kMqStates[i].qe;
            nlps[2 * i] = uint8_t(2 * kMqStates[i].nlps + kMqStates[i].sw);
            nlps[2 * i + 1] = uint8_t(2 * kMqStates[i].nlps + 1 - kMqStates[i].sw);
            nmps[2 * i] = uint8_t(2 * kMqStates[i].nmps);
            nmps[2 * i + 1] = uint8_t(2 * kMqStates[i].nmps + 1);
        }
    }
};
const MqTables kMq;

struct Mqc {
    const uint8_t* bp = nullptr;
    uint32_t a = 0, c = 0;
    int raw = 0;
    uint8_t cx[19];

    void init_contexts() {
        std::memset(cx, 0, sizeof(cx));
        cx[MQC_CX_UNI] = 2 * 46;
        cx[MQC_CX_RL] = 2 * 3;
        cx[0] = 2 * 4;
    }
    void bytein() {
        if (*bp == 0xff) {
            if (bp[1] > 0x8f) {
                c++;
            } else {
                bp++;
                c += 2 + 0xfe00 - (uint32_t(*bp) << 9);
            }
        } else {
            bp++;
            c += 1 + 0xff00 - (uint32_t(*bp) << 8);
        }
    }
    void initdec(const uint8_t* p, int is_raw, int reset) {
        if (reset) init_contexts();
        bp = p;
        c = uint32_t(*bp ^ 0xff) << 16;
        bytein();
        c = c << 7;
        a = 0x8000;
        raw = is_raw;
    }
    int exchange(uint8_t* st, int lps) {
        int d;
        if ((a < kMq.qe[*st]) ^ (!lps)) {
            if (lps) a = kMq.qe[*st];
            d = *st & 1;
            *st = kMq.nmps[*st];
        } else {
            if (lps) a = kMq.qe[*st];
            d = 1 - (*st & 1);
            *st = kMq.nlps[*st];
        }
        do {
            if (!(c & 0xff)) {
                c -= 0x100;
                bytein();
            }
            a += a;
            c += c;
        } while (!(a & 0x8000));
        return d;
    }
    int bypass() {
        int bit = !(c & 0x40000000);
        if (!(c & 0xff)) {
            c -= 0x100;
            bytein();
        }
        c += c;
        return bit;
    }
    int decode(uint8_t* st) {
        if (raw) return bypass();
        a -= kMq.qe[*st];
        if ((c >> 16) < a) {
            if (a & 0x8000) return *st & 1;
            return exchange(st, 0);
        }
        c -= a << 16;
        return exchange(st, 1);
    }
};

// ------------------------------------------------------------ context tables

struct CtxTables {
    uint8_t sig[256][4];
    uint8_t sgn[16][16];
    uint8_t xorbit[16][16];

    static int getsigctxno(int flag, int bandno) {
        int h = ((flag & T1_SIG_E) ? 1 : 0) + ((flag & T1_SIG_W) ? 1 : 0);
        int v = ((flag & T1_SIG_N) ? 1 : 0) + ((flag & T1_SIG_S) ? 1 : 0);
        int d = ((flag & T1_SIG_NE) ? 1 : 0) + ((flag & T1_SIG_NW) ? 1 : 0) +
                ((flag & T1_SIG_SE) ? 1 : 0) + ((flag & T1_SIG_SW) ? 1 : 0);
        if (bandno < 3) {
            if (bandno == 1) std::swap(h, v);
            if (h == 2) return 8;
            if (h == 1) {
                if (v >= 1) return 7;
                if (d >= 1) return 6;
                return 5;
            }
            if (v == 2) return 4;
            if (v == 1) return 3;
            if (d >= 2) return 2;
            if (d == 1) return 1;
        } else {
            if (d >= 3) return 8;
            if (d == 2) return h + v >= 1 ? 7 : 6;
            if (d == 1) {
                if (h + v >= 2) return 5;
                if (h + v == 1) return 4;
                return 3;
            }
            if (h + v >= 2) return 2;
            if (h + v == 1) return 1;
        }
        return 0;
    }
    static int getsgnctxno(int flag, uint8_t* x) {
        static const int contrib[3][3] = {{0, -1, 1}, {-1, -1, 0}, {1, 0, 1}};
        static const int label[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
        static const int xb[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
        int hc = contrib[flag & T1_SIG_E ? (flag & T1_SGN_E ? 1 : 2) : 0]
                        [flag & T1_SIG_W ? (flag & T1_SGN_W ? 1 : 2) : 0] + 1;
        int vc = contrib[flag & T1_SIG_S ? (flag & T1_SGN_S ? 1 : 2) : 0]
                        [flag & T1_SIG_N ? (flag & T1_SGN_N ? 1 : 2) : 0] + 1;
        *x = uint8_t(xb[hc][vc]);
        return label[hc][vc];
    }
    CtxTables() {
        for (int i = 0; i < 256; i++)
            for (int j = 0; j < 4; j++) sig[i][j] = uint8_t(getsigctxno(i, j));
        for (int i = 0; i < 16; i++)
            for (int j = 0; j < 16; j++) sgn[i][j] = uint8_t(getsgnctxno(i + (j << 8), &xorbit[i][j]));
    }
};
const CtxTables kCtx;

inline int sigctxno(int flag, int bandno) { return kCtx.sig[flag & 255][bandno]; }
inline int sgnctxno(int flag, int* xorbit) {
    *xorbit = kCtx.xorbit[flag & 15][(flag >> 8) & 15];
    return kCtx.sgn[flag & 15][(flag >> 8) & 15];
}
inline int refctxno(int flag) {
    static const uint8_t lut[2][2] = {{14, 15}, {16, 16}};
    return lut[(flag >> 14) & 1][(flag & 255) != 0];
}

// --------------------------------------------------------------- byte reader

// bytestream2's GetByteContext: reads past the end give 0 and stop there
struct Gb {
    const uint8_t* start = nullptr;
    const uint8_t* buf = nullptr;
    const uint8_t* end = nullptr;

    void init(const uint8_t* p, int64_t n) {
        start = buf = p;
        end = p + std::max<int64_t>(n, 0);
    }
    int left() const { return int(end - buf); }
    int tell() const { return int(buf - start); }
    int size() const { return int(end - start); }
    int byte() {
        if (buf >= end) return 0;
        return *buf++;
    }
    int peek_byte() const { return buf < end ? *buf : 0; }
    int be16() {
        if (left() < 2) {
            buf = end;
            return 0;
        }
        int v = buf[0] << 8 | buf[1];
        buf += 2;
        return v;
    }
    int peek_be16() const { return left() < 2 ? 0 : (buf[0] << 8 | buf[1]); }
    uint32_t be32() {
        if (left() < 4) {
            buf = end;
            return 0;
        }
        uint32_t v = uint32_t(buf[0]) << 24 | uint32_t(buf[1]) << 16 | uint32_t(buf[2]) << 8 | buf[3];
        buf += 4;
        return v;
    }
    uint32_t peek_be32() const {
        if (left() < 4) return 0;
        return uint32_t(buf[0]) << 24 | uint32_t(buf[1]) << 16 | uint32_t(buf[2]) << 8 | buf[3];
    }
    void skip(int64_t n) { buf += std::min<int64_t>(std::max<int64_t>(n, 0), left()); }
    void seek(int64_t pos) { buf = start + std::min<int64_t>(std::max<int64_t>(pos, 0), size()); }
};

// ------------------------------------------------------------ the structures

struct TgtNode {
    int val = 0;
    int vis = 0;
    TgtNode* parent = nullptr;
};

std::vector<TgtNode> tag_tree(int w, int h) {
    int64_t size = 0;
    for (int ww = w, hh = h; ww > 1 || hh > 1; ww = (ww + 1) >> 1, hh = (hh + 1) >> 1)
        size += int64_t(ww) * hh;
    std::vector<TgtNode> t(size_t(size + 1));
    TgtNode* cur = t.data();
    while (w > 1 || h > 1) {
        int pw = w, ph = h;
        w = (w + 1) >> 1;
        h = (h + 1) >> 1;
        TgtNode* up = cur + int64_t(pw) * ph;
        for (int i = 0; i < ph; i++)
            for (int j = 0; j < pw; j++) cur[i * pw + j].parent = &up[(i >> 1) * w + (j >> 1)];
        cur = up;
    }
    cur[0].parent = nullptr;
    return t;
}

struct Cblk {
    int npasses = 0, nonzerobits = 0, zbp = 0, lblock = 3, incl = 0;
    int length = 0;
    std::vector<uint8_t> data;
    std::vector<int> lengthinc;
    int nb_lengthinc = 0, nb_terminations = 0, nb_terminationsinc = 0;
    std::vector<int> data_start;
    int coord[2][2] = {};
};

struct Prec {
    int coord[2][2] = {};
    int nb_cw = 0, nb_ch = 0;
    std::vector<TgtNode> cblkincl, zerobits;
    std::vector<Cblk> cblk;
    int decoded_layers = 0;
};

struct Band {
    int coord[2][2] = {};
    int log2_cblk_w = 0, log2_cblk_h = 0;
    float f_stepsize = 0;
    int i_stepsize = 0;
    std::vector<Prec> prec;
};

struct ResLevel {
    int coord[2][2] = {};
    int nbands = 0;
    int log2_prec_w = 0, log2_prec_h = 0;
    int nprec_x = 0, nprec_y = 0;
    std::vector<Band> band;
};

struct CodingStyle {
    int nreslevels = 0, nreslevels2decode = 0;
    int log2_cblk_w = 0, log2_cblk_h = 0;
    int transform = 0;
    int csty = 0, nlayers = 0, mct = 0, cblk_style = 0, prog_order = 0;
    uint8_t log2_prec_w[kMaxReslevels] = {}, log2_prec_h[kMaxReslevels] = {};
    int init = 0;
};

struct QuantStyle {
    uint8_t expn[kMaxDeclevels * 3] = {};
    uint16_t mant[kMaxDeclevels * 3] = {};
    int quantsty = 0, nguardbits = 0;
};

struct PocEntry {
    int RSpoc, CSpoc, LYEpoc, REpoc, CEpoc, Ppoc;
};

struct Poc {
    PocEntry poc[kMaxPocs] = {};
    int nb_poc = 0;
    int is_default = 0;
};

struct Dwt {
    int linelen[kMaxDeclevels][2] = {};
    int mod[kMaxDeclevels][2] = {};
    int ndeclevels = 0, type = 0;
};

struct Component {
    int coord[2][2] = {}, coord_o[2][2] = {};
    std::vector<ResLevel> reslevel;
    std::vector<float> f_data;
    std::vector<int32_t> i_data;
    Dwt dwt;
};

struct TilePart {
    Gb tpg;
    const uint8_t* tp_end = nullptr;
};

struct Tile {
    std::vector<Component> comp;
    CodingStyle codsty[4];
    QuantStyle qntsty[4];
    Poc poc;
    TilePart tile_part[kTileParts];
    int tp_idx = 0;
    uint8_t properties[4] = {};
    int coord[2][2] = {};
};

// ------------------------------------------------------------------- the DWT

void dwt_init(Dwt& d, const int border[2][2], int levels, int type) {
    int b[2][2];
    for (int i = 0; i < 2; i++)
        for (int j = 0; j < 2; j++) b[i][j] = border[i][j];
    d.ndeclevels = levels;
    d.type = type;
    for (int lev = levels - 1; lev >= 0; lev--)
        for (int i = 0; i < 2; i++) {
            d.linelen[lev][i] = b[i][1] - b[i][0];
            d.mod[lev][i] = b[i][0] & 1;
            for (int j = 0; j < 2; j++) b[i][j] = (b[i][j] + 1) >> 1;
        }
}

void extend53(int32_t* p, int i0, int i1) {
    p[i0 - 1] = p[i0 + 1];
    p[i1] = p[i1 - 2];
    p[i0 - 2] = p[i0 + 2];
    p[i1 + 1] = p[i1 - 3];
}

void sr_1d53(int32_t* p, int i0, int i1) {
    if (i1 <= i0 + 1) {
        if (i0 == 1) p[1] = p[1] >> 1;
        return;
    }
    extend53(p, i0, i1);
    for (int i = (i0 >> 1); i < (i1 >> 1) + 1; i++)
        p[2 * i] = int32_t(uint32_t(p[2 * i]) -
                           uint32_t(int32_t(uint32_t(p[2 * i - 1]) + uint32_t(p[2 * i + 1]) + 2u) >> 2));
    for (int i = (i0 >> 1); i < (i1 >> 1); i++)
        p[2 * i + 1] = int32_t(uint32_t(p[2 * i + 1]) +
                               uint32_t(int32_t(uint32_t(p[2 * i]) + uint32_t(p[2 * i + 2])) >> 1));
}

void extend97_float(float* p, int i0, int i1) {
    for (int i = 1; i <= 4; i++) {
        p[i0 - i] = p[i0 + i];
        p[i1 + i - 1] = p[i1 - i - 1];
    }
}

void sr_1d97_float(float* p, int i0, int i1) {
    if (i1 <= i0 + 1) {
        if (i0 == 1)
            p[1] *= F_LFTG_K / 2;
        else
            p[0] *= F_LFTG_X;
        return;
    }
    extend97_float(p, i0, i1);
    for (int i = (i0 >> 1) - 1; i < (i1 >> 1) + 2; i++)
        p[2 * i] -= F_LFTG_DELTA * (p[2 * i - 1] + p[2 * i + 1]);
    for (int i = (i0 >> 1) - 1; i < (i1 >> 1) + 1; i++)
        p[2 * i + 1] -= F_LFTG_GAMMA * (p[2 * i] + p[2 * i + 2]);
    for (int i = (i0 >> 1); i < (i1 >> 1) + 1; i++)
        p[2 * i] += F_LFTG_BETA * (p[2 * i - 1] + p[2 * i + 1]);
    for (int i = (i0 >> 1); i < (i1 >> 1); i++)
        p[2 * i + 1] += F_LFTG_ALPHA * (p[2 * i] + p[2 * i + 2]);
}

template <typename T, int Pad, void (*Sr)(T*, int, int)>
void dwt_decode(const Dwt& s, T* t) {
    int maxlen = 0;
    for (int lev = 0; lev < s.ndeclevels; lev++)
        maxlen = std::max({maxlen, s.linelen[lev][0], s.linelen[lev][1]});
    std::vector<T> buf(size_t(maxlen) + 2 * Pad + 2);
    T* line = buf.data() + Pad;
    int w = s.linelen[s.ndeclevels - 1][0];
    for (int lev = 0; lev < s.ndeclevels; lev++) {
        int lh = s.linelen[lev][0], lv = s.linelen[lev][1];
        int mh = s.mod[lev][0], mv = s.mod[lev][1];
        T* l = line + mh;
        for (int lp = 0; lp < lv; lp++) {
            int j = 0;
            for (int i = mh; i < lh; i += 2, j++) l[i] = t[int64_t(w) * lp + j];
            for (int i = 1 - mh; i < lh; i += 2, j++) l[i] = t[int64_t(w) * lp + j];
            Sr(line, mh, mh + lh);
            for (int i = 0; i < lh; i++) t[int64_t(w) * lp + i] = l[i];
        }
        l = line + mv;
        for (int lp = 0; lp < lh; lp++) {
            int j = 0;
            for (int i = mv; i < lv; i += 2, j++) l[i] = t[int64_t(w) * j + lp];
            for (int i = 1 - mv; i < lv; i += 2, j++) l[i] = t[int64_t(w) * j + lp];
            Sr(line, mv, mv + lv);
            for (int i = 0; i < lv; i++) t[int64_t(w) * i + lp] = l[i];
        }
    }
}

// ---------------------------------------------------------------- the decoder

// the pixel formats get_siz picks from (pix_fmt_match: the component
// count, each component's depth at least the stream's, the luma plane
// unsubsampled, the other planes at the format's subsampling, a palette
// only where the JP2 header gave one), in the order of FFmpeg's lists;
// Digital Cinema's XYZ is left out
enum Kind { GRAY, RGB, YUV, PAL };
struct Format {
    Kind kind;
    int comps, log2w, log2h, depth;
};
const Format kFormats[] = {
    {GRAY, 1, 0, 0, 8},  {RGB, 3, 0, 0, 8},   {YUV, 3, 2, 2, 8},   {YUV, 3, 2, 0, 8},
    {YUV, 3, 1, 1, 8},   {YUV, 3, 1, 0, 8},   {YUV, 3, 0, 1, 8},   {YUV, 3, 0, 0, 8},
    {GRAY, 1, 0, 0, 16}, {RGB, 3, 0, 0, 16},  {YUV, 3, 1, 1, 9},   {YUV, 3, 1, 0, 9},
    {YUV, 3, 0, 0, 9},   {YUV, 3, 1, 1, 10},  {YUV, 3, 1, 0, 10},  {YUV, 3, 0, 0, 10},
    {YUV, 3, 1, 1, 12},  {YUV, 3, 1, 0, 12},  {YUV, 3, 0, 0, 12},  {YUV, 3, 1, 1, 14},
    {YUV, 3, 1, 0, 14},  {YUV, 3, 0, 0, 14},  {YUV, 3, 1, 1, 16},  {YUV, 3, 1, 0, 16},
    {YUV, 3, 0, 0, 16},  {PAL, 1, 0, 0, 8},   {RGB, 4, 0, 0, 8},   {RGB, 4, 0, 0, 16},
    {GRAY, 2, 0, 0, 8},  {GRAY, 2, 0, 0, 16}, {YUV, 4, 1, 1, 8},   {YUV, 4, 1, 0, 8},
    {YUV, 4, 0, 0, 8},   {YUV, 4, 1, 1, 9},   {YUV, 4, 1, 0, 9},   {YUV, 4, 0, 0, 9},
    {YUV, 4, 1, 1, 10},  {YUV, 4, 1, 0, 10},  {YUV, 4, 0, 0, 10},  {YUV, 4, 1, 1, 16},
    {YUV, 4, 1, 0, 16},  {YUV, 4, 0, 0, 16},
};
enum { PIX_NONE = -1, PIX_GRAY8 = 0, PIX_RGB24 = 1, PIX_GRAY16 = 8, PIX_RGB48 = 9, PIX_PAL8 = 25,
       PIX_RGBA64 = 27, PIX_YA8 = 28, PIX_YA16 = 29, PIX_YUVA420P = 30 };
// RGB_PIXEL_FORMATS, GRAY_PIXEL_FORMATS, YUV_PIXEL_FORMATS
const int kRgbList[] = {25, 1, 26, 9, 27};
const int kGrayList[] = {0, 28, 8, 29};
const int kYuvList[] = {2,  3,  30, 4,  5,  31, 6,  7,  32, 10, 11, 12, 33, 34, 35, 13, 14,
                        15, 36, 37, 38, 16, 17, 18, 19, 20, 21, 22, 23, 24, 39, 40, 41};
const int kAllList[] = {25, 1,  26, 9,  27, 0,  28, 8,  29, 2,  3,  30, 4,  5,  31, 6,  7,
                        32, 10, 11, 12, 33, 34, 35, 13, 14, 15, 36, 37, 38, 16, 17, 18, 19,
                        20, 21, 22, 23, 24, 39, 40, 41};

struct Decoder {
    // the picture
    int width = 0, height = 0, ncomponents = 0, precision = 0;
    int tile_width = 0, tile_height = 0, tile_offset_x = 0, tile_offset_y = 0;
    int numXtiles = 0, numYtiles = 0;
    // each component's depth and sampling (its sign bit, which FFmpeg's
    // output ignores, is not kept)
    int cbps[4] = {}, cdx[4] = {}, cdy[4] = {};
    int cdef[4] = {-1, -1, -1, -1};
    int colour_space = 0;
    // the JP2 header's palette (pclr), kept with the context as FFmpeg's
    int pal8 = 0;
    uint32_t palette[256] = {};
    int pix = PIX_NONE;   // kFormats' index
    int dimx = 0, dimy = 0;
    // the headers
    CodingStyle codsty[4];
    QuantStyle qntsty[4];
    uint8_t properties[4] = {};
    Poc poc;
    std::vector<Tile> tile;
    int curtileno = -1;
    Gb g;
    int bit_index = 8;
    // the output: planes, or packed rgb24
    std::vector<std::vector<uint8_t>> planes;
    int64_t features = 0;
    double t1_ms = 0, dwt_ms = 0, out_ms = 0;

    void feature(int f) { features |= int64_t(1) << f; }

    void cleanup() {
        tile.clear();
        for (auto& c : codsty) c = CodingStyle();
        for (auto& q : qntsty) q = QuantStyle();
        std::memset(properties, 0, sizeof(properties));
        poc = Poc();
        numXtiles = numYtiles = 0;
        ncomponents = 0;
    }

    // ---- jp2 boxes

    bool jp2_find_codestream() {
        int search_range = 10;
        while (search_range && g.left() >= 8) {
            uint32_t atom_size = g.be32();
            uint32_t atom = g.be32();
            int64_t atom_end;
            if (atom_size == 1) {
                if (g.be32()) unsupported("a JP2 box of more than 4 GiB");
                atom_size = g.be32();
                if (atom_size < 16) corrupt("a JP2 box shorter than its header");
                atom_end = int64_t(g.tell()) + atom_size - 16;
            } else {
                if (atom_size < 8) corrupt("a JP2 box shorter than its header");
                atom_end = int64_t(g.tell()) + atom_size - 8;
            }
            if (atom == 0x6a703263)   // jp2c
                return true;
            if (g.left() < int64_t(atom_size) || atom_end < atom_size) return false;
            if (atom == 0x6a703268 && atom_size >= 16) {   // jp2h
                int64_t atom2_end;
                do {
                    if (g.left() < 8) break;
                    uint32_t atom2_size = g.be32();
                    uint32_t atom2 = g.be32();
                    atom2_end = int64_t(g.tell()) + atom2_size - 8;
                    if (atom2_size < 8 || atom2_end > atom_end || atom2_end < atom2_size) break;
                    atom2_size -= 8;
                    if (atom2 == 0x6a703263) {
                        return true;
                    } else if (atom2 == 0x636f6c72 && atom2_size >= 7) {   // colr
                        int method = g.byte();
                        g.skip(2);
                        if (method == 1) colour_space = int(g.be32());
                    } else if (atom2 == 0x70636c72 && atom2_size >= 6) {   // pclr
                        read_palette(atom2_size);
                    } else if (atom2 == 0x63646566 && atom2_size >= 2) {   // cdef
                        for (int n = g.be16(); n > 0; n--) {
                            int cn = g.be16();
                            g.be16();   // the channel's type
                            int asoc = g.be16();
                            if (cn < 4 && asoc < 4) cdef[cn] = asoc;
                        }
                    }
                    g.seek(atom2_end);
                } while (atom_end - atom2_end >= 8);
            } else {
                search_range--;
            }
            g.seek(atom_end);
        }
        return false;
    }

    // a pclr box: up to 256 entries of 3 channels of at most 16 bits, each
    // scaled to 8 bits (a shorter one's high bits repeated below it); any
    // other palette is passed over, as FFmpeg passes over it
    void read_palette(uint32_t size) {
        int count = g.be16(), channels = g.byte(), depth[3];
        for (int& d : depth) d = (g.byte() & 0x7f) + 1;
        uint32_t need = 0;
        for (int d : depth) need += uint32_t((d + 7) >> 3) * count;
        if (count > 256 || channels != 3 || depth[0] > 16 || depth[1] > 16 || depth[2] > 16 ||
            size < need)
            return;
        pal8 = 1;
        for (int i = 0; i < count; i++) {
            uint32_t rgb[3];
            for (int c = 0; c < 3; c++) {
                if (depth[c] <= 8) {
                    rgb[c] = uint32_t(g.byte()) << (8 - depth[c]);
                    rgb[c] |= rgb[c] >> depth[c];
                } else {
                    rgb[c] = uint32_t(g.be16()) >> (depth[c] - 8);
                }
            }
            palette[i] = 0xffu << 24 | rgb[0] << 16 | rgb[1] << 8 | rgb[2];
        }
    }

    // ---- marker segments

    void get_siz() {
        if (g.left() < 36) corrupt("insufficient space for SIZ");
        int profile = g.be16();
        width = int(g.be32());
        height = int(g.be32());
        uint32_t image_offset_x = g.be32(), image_offset_y = g.be32();
        tile_width = int(g.be32());
        tile_height = int(g.be32());
        tile_offset_x = int(g.be32());
        tile_offset_y = int(g.be32());
        int nc = g.be16();
        if (image_offset_x || image_offset_y) unsupported("image offsets (SIZ XOsiz/YOsiz)");
        if (width <= 0 || height <= 0 || int64_t(width) * height > (int64_t(1) << 28))
            unsupported("a picture of " + std::to_string(width) + "x" + std::to_string(height));
        if (nc <= 0) corrupt("invalid number of components");
        if (nc > 4) unsupported(std::to_string(nc) + " components");
        if (tile_offset_x < 0 || tile_offset_y < 0 || 0 < tile_offset_x || 0 < tile_offset_y ||
            tile_width + int64_t(tile_offset_x) <= 0 || tile_height + int64_t(tile_offset_y) <= 0)
            corrupt("tile offsets are invalid");
        ncomponents = nc;
        if (tile_width <= 0 || tile_height <= 0) corrupt("invalid tile dimension");
        if (g.left() < 3 * nc) corrupt("insufficient space for the components in SIZ");
        for (int i = 0; i < nc; i++) {
            if (cdef[i] < 0) {
                for (int k = 0; k < nc; k++) cdef[k] = k + 1;
                if ((nc & 1) == 0) cdef[nc - 1] = 0;
            }
        }
        uint32_t log2_chroma_wh = 0;
        for (int i = 0; i < nc; i++) {
            int x = g.byte();
            cbps[i] = (x & 0x7f) + 1;
            precision = std::max(cbps[i], precision);
            cdx[i] = g.byte();
            cdy[i] = g.byte();
            if (!cdx[i] || cdx[i] == 3 || cdx[i] > 4 || !cdy[i] || cdy[i] == 3 || cdy[i] > 4)
                corrupt("invalid sample separation");
            log2_chroma_wh |= uint32_t(cdy[i] >> 1) << (i * 4) | uint32_t(cdx[i] >> 1) << (i * 4 + 2);
        }
        numXtiles = ceildiv(width - tile_offset_x, tile_width);
        numYtiles = ceildiv(height - tile_offset_y, tile_height);
        if (int64_t(numXtiles) * numYtiles * 14 > g.size()) {
            numXtiles = numYtiles = 0;
            corrupt("more tiles than the data can hold");
        }
        tile.assign(size_t(numXtiles) * numYtiles, Tile());
        for (auto& t : tile) t.comp.assign(size_t(nc), Component());
        if (numXtiles * numYtiles > 1) feature(F_TILES);

        int o_dimx = width, o_dimy = height;
        dimx = ceildiv(o_dimx, cdx[0]);
        dimy = ceildiv(o_dimy, cdy[0]);
        for (int i = 1; i < nc; i++) {
            dimx = std::max(dimx, ceildiv(o_dimx, cdx[i]));
            dimy = std::max(dimy, ceildiv(o_dimy, cdy[i]));
        }
        if (profile == 3 || profile == 4) unsupported("Digital Cinema (XYZ) profiles");
        // get_siz: the format list by the colr box's colour space
        const int* list;
        int n;
        switch (colour_space) {
            case 16: list = kRgbList; n = int(std::size(kRgbList)); break;
            case 17: list = kGrayList; n = int(std::size(kGrayList)); break;
            case 18: list = kYuvList; n = int(std::size(kYuvList)); break;
            default: list = kAllList; n = int(std::size(kAllList)); break;
        }
        auto match = [&](int f) {   // pix_fmt_match's cases, falling through
            const Format& d = kFormats[f];
            if (d.comps != nc || d.depth < precision) return false;
            const uint32_t wh = log2_chroma_wh;
            const bool chroma = d.kind == YUV;   // the other formats' planes are full
            const int lw = chroma ? d.log2w : 0, lh = chroma ? d.log2h : 0;
            bool m = true;
            if (nc == 4) m = m && (wh >> 14 & 3) == 0 && (wh >> 12 & 3) == 0;
            if (nc >= 3) m = m && int(wh >> 10 & 3) == lw && int(wh >> 8 & 3) == lh;
            if (nc >= 2) m = m && int(wh >> 6 & 3) == lw && int(wh >> 4 & 3) == lh;
            return m && (wh >> 2 & 3) == 0 && (wh & 3) == 0 && (d.kind == PAL) == (pal8 != 0);
        };
        // a format kept from the last picture where it still matches
        if (!(pix != PIX_NONE && match(pix))) {
            pix = PIX_NONE;
            for (int i = 0; i < n; i++)
                if (match(list[i])) {
                    pix = list[i];
                    break;
                }
            if (pix != PIX_NONE) {
            } else if (nc == 4 && cdy[0] == 1 && cdx[0] == 1 && cdy[1] == 1 && cdx[1] == 1 &&
                       cdy[2] == cdy[3] && cdx[2] == cdx[3]) {
                if (precision == 8 && cdy[2] == 2 && cdx[2] == 2 && !pal8) {
                    pix = PIX_YUVA420P;
                    for (int k = 0; k < 4; k++) cdef[k] = k;
                }
            } else if (nc == 3 && precision == 8 && cdx[0] == cdx[1] && cdx[0] == cdx[2] &&
                       cdy[0] == cdy[1] && cdy[0] == cdy[2]) {
                pix = PIX_RGB24;
            } else if (nc == 2 && precision == 8 && cdx[0] == cdx[1] && cdy[0] == cdy[1]) {
                pix = PIX_YA8;
            } else if (nc == 2 && precision == 16 && cdx[0] == cdx[1] && cdy[0] == cdy[1]) {
                pix = PIX_YA16;
            } else if (nc == 1 && precision == 8) {
                pix = PIX_GRAY8;
            } else if (nc == 1 && precision == 12) {
                pix = PIX_GRAY16;
            }
        }
        if (pix == PIX_NONE) corrupt("unknown pixel format for the components' sampling");
        if ((width & 1) || (height & 1)) feature(F_ODD_SIZE);
        static const Feature by_format[] = {F_GRAY8, F_RGB24, F_YUV410, F_YUV411, F_YUV420, F_YUV422,
                                            F_YUV440, F_YUV444, F_GRAY16, F_RGB48};
        feature(pix < int(std::size(by_format)) ? by_format[pix]
                : pix < PIX_PAL8                 ? F_YUV_DEEP
                : pix == PIX_PAL8                ? F_PAL8
                                                 : F_ALPHA);
    }

    void get_cox(CodingStyle& c) {
        if (g.left() < 5) corrupt("insufficient space for COX");
        c.nreslevels = g.byte() + 1;
        if (c.nreslevels >= kMaxReslevels) corrupt("nreslevels is invalid");
        c.nreslevels2decode = c.nreslevels;
        c.log2_cblk_w = (g.byte() & 15) + 2;
        c.log2_cblk_h = (g.byte() & 15) + 2;
        if (c.log2_cblk_w > 10 || c.log2_cblk_h > 10 || c.log2_cblk_w + c.log2_cblk_h > 12)
            corrupt("code-block size invalid");
        c.cblk_style = g.byte();
        if (c.cblk_style & CBLK_HT) unsupported("High-Throughput (HTJ2K) code-blocks");
        if (c.cblk_style & CBLK_BYPASS) feature(F_BYPASS);
        if (c.cblk_style & CBLK_RESET) feature(F_RESET);
        if (c.cblk_style & CBLK_TERMALL) feature(F_TERMALL);
        if (c.cblk_style & CBLK_VSC) feature(F_VSC);
        if (c.cblk_style & CBLK_PREDTERM) feature(F_PREDTERM);
        if (c.cblk_style & CBLK_SEGSYM) feature(F_SEGSYM);
        c.transform = g.byte();
        if (c.transform != DWT97 && c.transform != DWT53) corrupt("unknown wavelet transform");
        if (c.csty & CSTY_PREC) {
            feature(F_PRECINCTS);
            for (int i = 0; i < c.nreslevels; i++) {
                int b = g.byte();
                c.log2_prec_w[i] = uint8_t(b & 0x0f);
                c.log2_prec_h[i] = uint8_t((b >> 4) & 0x0f);
                if (i && (c.log2_prec_w[i] == 0 || c.log2_prec_h[i] == 0)) corrupt("precinct size invalid");
            }
        } else {
            std::memset(c.log2_prec_w, 15, sizeof(c.log2_prec_w));
            std::memset(c.log2_prec_h, 15, sizeof(c.log2_prec_h));
        }
    }

    void get_cod(CodingStyle* c, uint8_t* props) {
        if (g.left() < 5) corrupt("insufficient space for COD");
        CodingStyle tmp;
        tmp.csty = g.byte();
        tmp.prog_order = g.byte();
        tmp.nlayers = g.be16();
        tmp.mct = g.byte();
        if (tmp.mct && ncomponents < 3) corrupt("MCT with too few components");
        get_cox(tmp);
        tmp.init = 1;
        for (int k = 0; k < ncomponents; k++)
            if (!(props[k] & HAD_COC)) c[k] = tmp;
    }

    void get_coc(CodingStyle* c, uint8_t* props) {
        if (g.left() < 2) corrupt("insufficient space for COC");
        int compno = g.byte();
        if (compno >= ncomponents) corrupt("invalid component in COC");
        feature(F_COC);
        CodingStyle& cs = c[compno];
        int has_eph = cs.csty & CSTY_EPH, has_sop = cs.csty & CSTY_SOP;
        cs.csty = g.byte() | has_eph | has_sop;
        get_cox(cs);
        props[compno] |= HAD_COC;
        cs.init = 1;
    }

    void get_qcx(int n, QuantStyle& q) {
        if (g.left() < 1) corrupt("insufficient space for QCX");
        int x = g.byte();
        q.nguardbits = x >> 5;
        q.quantsty = x & 0x1f;
        if (q.quantsty == QSTY_NONE) {
            feature(F_QSTY_NONE);
            n -= 3;
            if (g.left() < n || n > kMaxDeclevels * 3) corrupt("QCX too long");
            for (int i = 0; i < n; i++) q.expn[i] = uint8_t(g.byte() >> 3);
        } else if (q.quantsty == QSTY_SI) {
            feature(F_QSTY_DERIVED);
            if (g.left() < 2) corrupt("QCX too short");
            x = g.be16();
            q.expn[0] = uint8_t(x >> 11);
            q.mant[0] = uint16_t(x & 0x7ff);
            for (int i = 1; i < kMaxDeclevels * 3; i++) {
                int curexpn = std::max(0, q.expn[0] - (i - 1) / 3);
                q.expn[i] = uint8_t(curexpn);
                q.mant[i] = q.mant[0];
            }
        } else {
            feature(F_QSTY_EXPOUNDED);
            n = (n - 3) >> 1;
            if (g.left() < 2 * n || n > kMaxDeclevels * 3) corrupt("QCX too long");
            for (int i = 0; i < n; i++) {
                x = g.be16();
                q.expn[i] = uint8_t(x >> 11);
                q.mant[i] = uint16_t(x & 0x7ff);
            }
        }
    }

    void get_qcd(int n, QuantStyle* q, uint8_t* props) {
        QuantStyle tmp;
        get_qcx(n, tmp);
        for (int k = 0; k < ncomponents; k++)
            if (!(props[k] & HAD_QCC)) q[k] = tmp;
    }

    void get_qcc(int n, QuantStyle* q, uint8_t* props) {
        if (g.left() < 1) corrupt("insufficient space for QCC");
        int compno = g.byte();
        if (compno >= ncomponents) corrupt("invalid component in QCC");
        feature(F_QCC);
        props[compno] |= HAD_QCC;
        get_qcx(n - 1, q[compno]);
    }

    void get_poc(int size, Poc& p) {
        const int elem_size = 7;
        if (g.left() < 5 || size < 2 + elem_size) corrupt("insufficient space for POC");
        Poc tmp;
        tmp.nb_poc = (size - 2) / elem_size;
        if (tmp.nb_poc > kMaxPocs) unsupported("more than 32 progression order changes");
        for (int i = 0; i < tmp.nb_poc; i++) {
            PocEntry& e = tmp.poc[i];
            e.RSpoc = g.byte();
            e.CSpoc = g.byte();
            e.LYEpoc = g.be16();
            e.REpoc = g.byte();
            e.CEpoc = g.byte();
            e.Ppoc = g.byte();
            if (!e.CEpoc) e.CEpoc = 256;
            if (e.CEpoc > ncomponents) e.CEpoc = ncomponents;
            if (e.RSpoc >= e.REpoc || e.REpoc > 33 || e.CSpoc >= e.CEpoc || e.CEpoc > ncomponents ||
                !e.LYEpoc)
                corrupt("a POC entry is invalid");
        }
        feature(F_POC);
        if (!p.nb_poc || p.is_default) {
            p = tmp;
        } else {
            if (p.nb_poc + tmp.nb_poc > kMaxPocs) corrupt("insufficient space for POC");
            for (int i = 0; i < tmp.nb_poc; i++) p.poc[p.nb_poc + i] = tmp.poc[i];
            p.nb_poc += tmp.nb_poc;
        }
        p.is_default = 0;
    }

    void get_sot(int n) {
        if (g.left() < 8) corrupt("insufficient space for SOT");
        curtileno = 0;
        int isot = g.be16();
        if (isot >= numXtiles * numYtiles) corrupt("SOT names a tile past the picture's");
        curtileno = isot;
        uint32_t psot = g.be32();
        int tpsot = g.byte();
        g.byte();   // TNsot
        if (!psot) psot = uint32_t(g.left() - 2 + n + 2);
        if (int64_t(psot) > int64_t(g.left()) - 2 + n + 2) corrupt("a tile-part's Psot runs past the data");
        if (tpsot >= kTileParts) unsupported("more than 32 tile-parts");
        if (tpsot) feature(F_TILE_PARTS);
        Tile& t = tile[isot];
        t.tp_idx = tpsot;
        TilePart& tp = t.tile_part[tpsot];
        tp.tp_end = g.buf + psot - n - 2;
        if (!tpsot) {
            for (int k = 0; k < ncomponents; k++) {
                t.codsty[k] = codsty[k];
                t.qntsty[k] = qntsty[k];
            }
            t.poc = poc;
            t.poc.is_default = 1;
        }
    }

    void read_main_headers() {
        CodingStyle* cs = codsty;
        QuantStyle* qs = qntsty;
        Poc* pc = &poc;
        uint8_t* props = properties;
        for (;;) {
            if (g.left() < 2) break;   // "Missing EOC"
            int marker = g.be16();
            int oldpos = g.tell();
            if (marker >= 0xff30 && marker <= 0xff3f) continue;
            if (marker == SOD) {
                if (tile.empty()) corrupt("missing SIZ");
                if (curtileno < 0) corrupt("missing SOT");
                Tile& t = tile[curtileno];
                TilePart& tp = t.tile_part[t.tp_idx];
                if (tp.tp_end < g.buf) corrupt("invalid tile-part end");
                tp.tpg.init(g.buf, tp.tp_end - g.buf);
                g.skip(tp.tp_end - g.buf);
                continue;
            }
            if (marker == EOC) break;
            int len = g.be16();
            if (len < 2 || g.left() < len - 2) break;   // "Missing EOC Marker" (not strict)
            switch (marker) {
                case SIZ:
                    if (ncomponents) corrupt("duplicate SIZ");
                    get_siz();
                    break;
                case COC: get_coc(cs, props); break;
                case COD: get_cod(cs, props); break;
                case QCC: get_qcc(len, qs, props); break;
                case QCD: get_qcd(len, qs, props); break;
                case POC: get_poc(len, *pc); break;
                case SOT:
                    get_sot(len);
                    cs = tile[curtileno].codsty;
                    qs = tile[curtileno].qntsty;
                    pc = &tile[curtileno].poc;
                    props = tile[curtileno].properties;
                    break;
                case COM:
                    feature(F_COM);
                    g.skip(len - 2);
                    break;
                case PLM:
                case CRG:
                case TLM:
                case PLT:
                    g.skip(len - 2);
                    break;
                case RGN: unsupported("region of interest shifts (RGN)");
                case PPM: unsupported("packed packet headers (PPM)");
                case PPT: unsupported("packed packet headers (PPT)");
                case CAP:
                case CPF: unsupported("Part 15 (HTJ2K) capabilities");
                default: g.skip(len - 2); break;   // "unsupported marker", passed over
            }
            if (g.tell() - oldpos != len) corrupt("error during processing a marker segment");
        }
    }

    // ---- tiles and their structures

    void init_band_stepsize(Band& band, const CodingStyle& cs, const QuantStyle& qs, int bandno,
                            int gbandno, int reslevelno, int cbps_) {
        switch (qs.quantsty) {
            case QSTY_NONE: band.f_stepsize = 1; break;
            case QSTY_SI:
            case QSTY_SE: {
                int gain = cbps_;
                band.f_stepsize = std::ldexp(1.0f, gain - qs.expn[gbandno]);
                band.f_stepsize = float(band.f_stepsize * (qs.mant[gbandno] / 2048.0 + 1.0));
                break;
            }
            default: band.f_stepsize = 0; break;
        }
        if (cs.transform != DWT53) {
            int lband = 0;
            switch (bandno + (reslevelno > 0)) {
                case 1:
                case 2:
                    band.f_stepsize *= F_LFTG_X * 2;
                    lband = 1;
                    break;
                case 3: band.f_stepsize *= F_LFTG_X * F_LFTG_X * 4; break;
            }
            band.f_stepsize = float(band.f_stepsize *
                                    std::pow(double(F_LFTG_K),
                                             2 * (cs.nreslevels2decode - reslevelno) + lband - 2));
        }
        if (band.f_stepsize > float(INT32_MAX >> 15)) band.f_stepsize = 0;
        band.i_stepsize = int(band.f_stepsize * (1 << 15));
    }

    void init_prec(Band& band, ResLevel& rl, Component& comp, Prec& prec, int precno, int bandno,
                   int reslevelno, int lbpw, int lbph) {
        prec.decoded_layers = 0;
        prec.coord[0][0] = ((rl.coord[0][0] >> rl.log2_prec_w) + precno % rl.nprec_x) * (1 << lbpw);
        prec.coord[1][0] = ((rl.coord[1][0] >> rl.log2_prec_h) + precno / rl.nprec_x) * (1 << lbph);
        prec.coord[0][1] = prec.coord[0][0] + (1 << lbpw);
        prec.coord[0][0] = std::max(prec.coord[0][0], band.coord[0][0]);
        prec.coord[0][1] = std::min(prec.coord[0][1], band.coord[0][1]);
        prec.coord[1][1] = prec.coord[1][0] + (1 << lbph);
        prec.coord[1][0] = std::max(prec.coord[1][0], band.coord[1][0]);
        prec.coord[1][1] = std::min(prec.coord[1][1], band.coord[1][1]);
        prec.nb_cw = ceildivpow2(prec.coord[0][1], band.log2_cblk_w) - (prec.coord[0][0] >> band.log2_cblk_w);
        prec.nb_ch = ceildivpow2(prec.coord[1][1], band.log2_cblk_h) - (prec.coord[1][0] >> band.log2_cblk_h);
        if (prec.nb_cw < 0 || prec.nb_ch < 0) corrupt("a precinct with negative code-block counts");
        prec.cblkincl = tag_tree(prec.nb_cw, prec.nb_ch);
        prec.zerobits = tag_tree(prec.nb_cw, prec.nb_ch);
        prec.cblk.assign(size_t(prec.nb_cw) * prec.nb_ch, Cblk());
        for (int cblkno = 0; cblkno < int(prec.cblk.size()); cblkno++) {
            Cblk& cb = prec.cblk[cblkno];
            int cx0 = (prec.coord[0][0] >> band.log2_cblk_w) << band.log2_cblk_w;
            cx0 = cx0 + ((cblkno % prec.nb_cw) << band.log2_cblk_w);
            cb.coord[0][0] = std::max(cx0, prec.coord[0][0]);
            int cy0 = (prec.coord[1][0] >> band.log2_cblk_h) << band.log2_cblk_h;
            cy0 = cy0 + ((cblkno / prec.nb_cw) << band.log2_cblk_h);
            cb.coord[1][0] = std::max(cy0, prec.coord[1][0]);
            cb.coord[0][1] = std::min(cx0 + (1 << band.log2_cblk_w), prec.coord[0][1]);
            cb.coord[1][1] = std::min(cy0 + (1 << band.log2_cblk_h), prec.coord[1][1]);
            if ((bandno + !!reslevelno) & 1) {
                int d = comp.reslevel[reslevelno - 1].coord[0][1] - comp.reslevel[reslevelno - 1].coord[0][0];
                cb.coord[0][0] += d;
                cb.coord[0][1] += d;
            }
            if ((bandno + !!reslevelno) & 2) {
                int d = comp.reslevel[reslevelno - 1].coord[1][1] - comp.reslevel[reslevelno - 1].coord[1][0];
                cb.coord[1][0] += d;
                cb.coord[1][1] += d;
            }
            cb.lblock = 3;
            cb.data_start.assign(1, 0);
        }
    }

    void init_component(Component& comp, const CodingStyle& cs, const QuantStyle& qs, int cbps_) {
        if (cs.nreslevels2decode <= 0) corrupt("nreslevels2decode invalid or uninitialized");
        dwt_init(comp.dwt, comp.coord, cs.nreslevels2decode - 1, cs.transform);
        int cw = comp.coord[0][1] - comp.coord[0][0], ch = comp.coord[1][1] - comp.coord[1][0];
        if (cw > 32768 || ch > 32768) unsupported("a component larger than 32768");
        size_t csize = size_t(cw) * ch + 64;
        if (cs.transform == DWT97)
            comp.f_data.assign(csize, 0.0f);
        else
            comp.i_data.assign(csize, 0);
        comp.reslevel.assign(size_t(cs.nreslevels), ResLevel());
        int gbandno = 0;
        for (int r = 0; r < cs.nreslevels; r++) {
            int declvl = cs.nreslevels - r;
            ResLevel& rl = comp.reslevel[r];
            for (int i = 0; i < 2; i++)
                for (int j = 0; j < 2; j++) rl.coord[i][j] = ceildivpow2(comp.coord_o[i][j], declvl - 1);
            rl.log2_prec_w = cs.log2_prec_w[r];
            rl.log2_prec_h = cs.log2_prec_h[r];
            rl.nbands = r == 0 ? 1 : 3;
            rl.nprec_x = rl.coord[0][1] == rl.coord[0][0]
                             ? 0
                             : ceildivpow2(rl.coord[0][1], rl.log2_prec_w) - (rl.coord[0][0] >> rl.log2_prec_w);
            rl.nprec_y = rl.coord[1][1] == rl.coord[1][0]
                             ? 0
                             : ceildivpow2(rl.coord[1][1], rl.log2_prec_h) - (rl.coord[1][0] >> rl.log2_prec_h);
            rl.band.assign(size_t(rl.nbands), Band());
            for (int b = 0; b < rl.nbands; b++, gbandno++) {
                Band& band = rl.band[b];
                init_band_stepsize(band, cs, qs, b, gbandno, r, cbps_);
                int lbpw, lbph;
                if (r == 0) {
                    for (int i = 0; i < 2; i++)
                        for (int j = 0; j < 2; j++) band.coord[i][j] = ceildivpow2(comp.coord_o[i][j], declvl - 1);
                    lbpw = rl.log2_prec_w;
                    lbph = rl.log2_prec_h;
                    band.log2_cblk_w = std::min(cs.log2_cblk_w, rl.log2_prec_w);
                    band.log2_cblk_h = std::min(cs.log2_cblk_h, rl.log2_prec_h);
                } else {
                    for (int i = 0; i < 2; i++)
                        for (int j = 0; j < 2; j++)
                            band.coord[i][j] = ceildivpow2(
                                comp.coord_o[i][j] - (int64_t(((b + 1) >> i) & 1) << (declvl - 1)), declvl);
                    band.log2_cblk_w = std::min(cs.log2_cblk_w, rl.log2_prec_w - 1);
                    band.log2_cblk_h = std::min(cs.log2_cblk_h, rl.log2_prec_h - 1);
                    lbpw = rl.log2_prec_w - 1;
                    lbph = rl.log2_prec_h - 1;
                }
                int nprec = rl.nprec_x * rl.nprec_y;
                band.prec.assign(size_t(nprec), Prec());
                for (int p = 0; p < nprec; p++) init_prec(band, rl, comp, band.prec[p], p, b, r, lbpw, lbph);
            }
        }
    }

    void init_tile(int tileno) {
        Tile& t = tile[tileno];
        int tilex = tileno % numXtiles, tiley = tileno / numXtiles;
        auto clip = [](int64_t v, int lo, int hi) { return int(std::min<int64_t>(std::max<int64_t>(v, lo), hi)); };
        t.coord[0][0] = clip(int64_t(tilex) * tile_width + tile_offset_x, 0, width);
        t.coord[0][1] = clip(int64_t(tilex + 1) * tile_width + tile_offset_x, 0, width);
        t.coord[1][0] = clip(int64_t(tiley) * tile_height + tile_offset_y, 0, height);
        t.coord[1][1] = clip(int64_t(tiley + 1) * tile_height + tile_offset_y, 0, height);
        for (int k = 0; k < ncomponents; k++) {
            Component& comp = t.comp[k];
            comp.coord_o[0][0] = ceildiv(t.coord[0][0], cdx[k]);
            comp.coord_o[0][1] = ceildiv(t.coord[0][1], cdx[k]);
            comp.coord_o[1][0] = ceildiv(t.coord[1][0], cdy[k]);
            comp.coord_o[1][1] = ceildiv(t.coord[1][1], cdy[k]);
            for (int i = 0; i < 2; i++)
                for (int j = 0; j < 2; j++) comp.coord[i][j] = comp.coord_o[i][j];
            if (!t.codsty[k].init) corrupt("a tile without a coding style");
            init_component(comp, t.codsty[k], t.qntsty[k], cbps[k]);
        }
    }

    // ---- packet headers

    int get_bits(int n) {
        int res = 0;
        while (--n >= 0) {
            res <<= 1;
            if (bit_index == 0) bit_index = 7 + (g.byte() != 0xff);
            bit_index--;
            res |= (g.peek_byte() >> bit_index) & 1;
        }
        return res;
    }

    void flush() {
        if (g.byte() == 0xff) g.skip(1);
        bit_index = 8;
    }

    int tag_tree_decode(TgtNode* node, int threshold) {
        TgtNode* stack[30];
        int sp = -1, curval = 0;
        while (node && !node->vis) {
            if (sp >= 29) corrupt("a tag tree too deep");
            stack[++sp] = node;
            node = node->parent;
        }
        curval = node ? node->val : stack[sp]->val;
        while (curval < threshold && sp >= 0) {
            if (curval < stack[sp]->val) curval = stack[sp]->val;
            while (curval < threshold) {
                if (get_bits(1) > 0) {
                    stack[sp]->vis++;
                    break;
                }
                curval++;
            }
            stack[sp]->val = curval;
            sp--;
        }
        return curval;
    }

    int getlblockinc() {
        int res = 0;
        while (get_bits(1)) res++;
        return res;
    }

    int getnpasses() {
        if (!get_bits(1)) return 1;
        if (!get_bits(1)) return 2;
        int num = get_bits(2);
        if (num != 3) return 3 + num;
        num = get_bits(5);
        if (num != 31) return 6 + num;
        return 37 + get_bits(7);
    }

    static int needs_termination(int style, int passno) {
        if (style & CBLK_BYPASS) {
            int type = passno % 3;
            passno /= 3;
            if (type == 0 && passno > 2) return 2;
            if (type == 2 && passno > 2) return 1;
            if (style & CBLK_TERMALL) return passno > 2 ? 2 : 1;
        }
        if (style & CBLK_TERMALL) return 1;
        return 0;
    }

    void select_stream(Tile& t, int* tp_index, const CodingStyle& cs) {
        g = t.tile_part[*tp_index].tpg;
        bool end = g.left() == 0 && bit_index == 8;
        while (end) {
            if (*tp_index < kTileParts - 1) {
                g = t.tile_part[++(*tp_index)].tpg;
                end = g.left() == 0 && bit_index == 8;
            } else {
                end = false;
            }
        }
        if (cs.csty & CSTY_SOP) {
            feature(F_SOP);
            if (g.peek_be32() == 0xff910004u) g.skip(6);
        }
    }

    void decode_packet(Tile& t, int* tp_index, const CodingStyle& cs, ResLevel& rl, int precno, int layno,
                       const uint8_t* expn, int numgbits) {
        if (layno < rl.band[0].prec[precno].decoded_layers) return;
        rl.band[0].prec[precno].decoded_layers = layno + 1;
        if (layno) feature(F_LAYERS);
        select_stream(t, tp_index, cs);
        if (get_bits(1)) {   // else an empty packet
            for (int bandno = 0; bandno < rl.nbands; bandno++) {
                Band& band = rl.band[bandno];
                Prec& prec = band.prec[precno];
                if (band.coord[0][0] == band.coord[0][1] || band.coord[1][0] == band.coord[1][1]) continue;
                int nb = prec.nb_ch * prec.nb_cw;
                for (int cblkno = 0; cblkno < nb; cblkno++) {
                    Cblk& cb = prec.cblk[cblkno];
                    int incl;
                    if (!cb.incl) {
                        incl = tag_tree_decode(&prec.cblkincl[cblkno], layno + 1) == layno;
                        if (incl) {
                            int zbp = tag_tree_decode(&prec.zerobits[cblkno], 100);
                            int v = expn[bandno] + numgbits - 1 - zbp;
                            if (v < 0 || v > 30) corrupt("nonzerobits invalid or unsupported");
                            cb.incl = 1;
                            cb.nonzerobits = v;
                            cb.zbp = zbp;
                            cb.lblock = 3;
                        }
                    } else {
                        incl = get_bits(1);
                    }
                    if (!incl) continue;
                    int newpasses = getnpasses();
                    if (cb.npasses + newpasses >= kMaxPasses) unsupported("too many coding passes");
                    int llen = getlblockinc();
                    int log2np = 31 - __builtin_clz(unsigned(newpasses));
                    if (cb.lblock + llen + log2np > 16) unsupported("a code-block length beyond 16 bits");
                    cb.lblock += llen;
                    cb.nb_lengthinc = 0;
                    cb.nb_terminationsinc = 0;
                    cb.lengthinc.assign(size_t(newpasses), 0);
                    cb.data_start.resize(size_t(cb.nb_terminations + newpasses + 1));
                    do {
                        int newpasses1 = 0;
                        while (newpasses1 < newpasses) {
                            newpasses1++;
                            if (needs_termination(cs.cblk_style, cb.npasses + newpasses1 - 1)) {
                                cb.nb_terminationsinc++;
                                break;
                            }
                        }
                        int ret = get_bits((31 - __builtin_clz(unsigned(newpasses1))) + cb.lblock);
                        cb.lengthinc[size_t(cb.nb_lengthinc++)] = ret;
                        cb.npasses += newpasses1;
                        newpasses -= newpasses1;
                    } while (newpasses);
                }
            }
        }
        flush();
        // EPH follows an empty packet's header too (FFmpeg skips it there
        // as well: the damaged streams libavcodec's encoder writes with SOP
        // and EPH fail where FFmpeg's decoder fails only so)
        if (cs.csty & CSTY_EPH) {
            feature(F_EPH);
            if (g.peek_be16() == EPH) g.skip(2);
        }
        // the code-blocks' data
        for (int bandno = 0; bandno < rl.nbands; bandno++) {
            Band& band = rl.band[bandno];
            Prec& prec = band.prec[precno];
            int nb = prec.nb_ch * prec.nb_cw;
            for (int cblkno = 0; cblkno < nb; cblkno++) {
                Cblk& cb = prec.cblk[cblkno];
                if (!cb.nb_terminationsinc && cb.lengthinc.empty()) continue;
                for (int k = 0; k < cb.nb_lengthinc; k++) {
                    int inc = cb.lengthinc[size_t(k)];
                    if (g.left() < inc) corrupt("a code-block's data runs past its tile-part");
                    size_t need = size_t(cb.length) + inc + 4;
                    if (cb.data.size() < need) cb.data.resize(std::max(need, 2 * cb.data.size()));
                    std::memcpy(cb.data.data() + cb.length, g.buf, size_t(inc));
                    g.skip(inc);
                    cb.length += inc;
                    cb.lengthinc[size_t(k)] = 0;
                    if (cb.nb_terminationsinc) {
                        cb.nb_terminationsinc--;
                        cb.nb_terminations++;
                        cb.data[size_t(cb.length++)] = 0xff;
                        cb.data[size_t(cb.length++)] = 0xff;
                        cb.data_start[size_t(cb.nb_terminations)] = cb.length;
                    }
                }
                cb.lengthinc.clear();
            }
        }
        t.tile_part[*tp_index].tpg = g;
    }

    void packets_po(Tile& t, int RSpoc, int CSpoc, int LYEpoc, int REpoc, int CEpoc, int Ppoc, int* tp) {
        auto expn = [&](int compno, int r) { return t.qntsty[compno].expn + (r ? 3 * (r - 1) + 1 : 0); };
        switch (Ppoc) {
            case PGOD_RLCP: {
                feature(F_RLCP);
                int ok = 1;
                for (int r = RSpoc; ok && r < REpoc; r++) {
                    ok = 0;
                    for (int layno = 0; layno < LYEpoc; layno++)
                        for (int k = CSpoc; k < CEpoc; k++) {
                            const CodingStyle& cs = t.codsty[k];
                            if (r < cs.nreslevels) {
                                ResLevel& rl = t.comp[k].reslevel[r];
                                ok = 1;
                                for (int p = 0; p < rl.nprec_x * rl.nprec_y; p++)
                                    decode_packet(t, tp, cs, rl, p, layno, expn(k, r), t.qntsty[k].nguardbits);
                            }
                        }
                }
                break;
            }
            case PGOD_LRCP: {
                feature(F_LRCP);
                for (int layno = 0; layno < LYEpoc; layno++) {
                    int ok = 1;
                    for (int r = RSpoc; ok && r < REpoc; r++) {
                        ok = 0;
                        for (int k = CSpoc; k < CEpoc; k++) {
                            const CodingStyle& cs = t.codsty[k];
                            if (r < cs.nreslevels) {
                                ResLevel& rl = t.comp[k].reslevel[r];
                                ok = 1;
                                for (int p = 0; p < rl.nprec_x * rl.nprec_y; p++)
                                    decode_packet(t, tp, cs, rl, p, layno, expn(k, r), t.qntsty[k].nguardbits);
                            }
                        }
                    }
                }
                break;
            }
            case PGOD_CPRL: {
                feature(F_CPRL);
                for (int k = CSpoc; k < CEpoc; k++) {
                    Component& comp = t.comp[k];
                    const CodingStyle& cs = t.codsty[k];
                    int step_x = 32, step_y = 32;
                    if (RSpoc >= std::min(cs.nreslevels, REpoc)) continue;
                    for (int r = RSpoc; r < std::min(cs.nreslevels, REpoc); r++) {
                        int rr = cs.nreslevels - 1 - r;
                        ResLevel& rl = comp.reslevel[r];
                        step_x = std::min(step_x, rl.log2_prec_w + rr);
                        step_y = std::min(step_y, rl.log2_prec_h + rr);
                    }
                    if (step_x >= 31 || step_y >= 31) unsupported("CPRL with a large step");
                    step_x = 1 << step_x;
                    step_y = 1 << step_y;
                    for (int y = t.coord[1][0]; y < t.coord[1][1]; y = (y / step_y + 1) * step_y)
                        for (int x = t.coord[0][0]; x < t.coord[0][1]; x = (x / step_x + 1) * step_x)
                            for (int r = RSpoc; r < std::min(cs.nreslevels, REpoc); r++) {
                                int rr = cs.nreslevels - 1 - r;
                                ResLevel& rl = comp.reslevel[r];
                                int xc = x / cdx[k], yc = y / cdy[k];
                                if (yc % (int64_t(1) << (rl.log2_prec_h + rr)) && y != t.coord[1][0]) continue;
                                if (xc % (int64_t(1) << (rl.log2_prec_w + rr)) && x != t.coord[0][0]) continue;
                                unsigned prcx = unsigned(ceildivpow2(xc, rr) >> rl.log2_prec_w);
                                unsigned prcy = unsigned(ceildivpow2(yc, rr) >> rl.log2_prec_h);
                                prcx -= unsigned(ceildivpow2(comp.coord_o[0][0], rr) >> rl.log2_prec_w);
                                prcy -= unsigned(ceildivpow2(comp.coord_o[1][0], rr) >> rl.log2_prec_h);
                                if (prcx >= unsigned(rl.nprec_x) || prcy >= unsigned(rl.nprec_y)) continue;
                                int p = int(prcx + unsigned(rl.nprec_x) * prcy);
                                for (int layno = 0; layno < LYEpoc; layno++)
                                    decode_packet(t, tp, cs, rl, p, layno, expn(k, r), t.qntsty[k].nguardbits);
                            }
                }
                break;
            }
            case PGOD_RPCL: {
                feature(F_RPCL);
                int ok = 1;
                for (int r = RSpoc; ok && r < REpoc; r++) {
                    ok = 0;
                    int step_x = 30, step_y = 30;
                    for (int k = CSpoc; k < CEpoc; k++) {
                        const CodingStyle& cs = t.codsty[k];
                        if (r < cs.nreslevels) {
                            int rr = cs.nreslevels - 1 - r;
                            ResLevel& rl = t.comp[k].reslevel[r];
                            step_x = std::min(step_x, rl.log2_prec_w + rr);
                            step_y = std::min(step_y, rl.log2_prec_h + rr);
                        }
                    }
                    step_x = 1 << step_x;
                    step_y = 1 << step_y;
                    for (int y = t.coord[1][0]; y < t.coord[1][1]; y = (y / step_y + 1) * step_y)
                        for (int x = t.coord[0][0]; x < t.coord[0][1]; x = (x / step_x + 1) * step_x)
                            for (int k = CSpoc; k < CEpoc; k++) {
                                Component& comp = t.comp[k];
                                const CodingStyle& cs = t.codsty[k];
                                if (r >= cs.nreslevels) continue;
                                if (position_packets(t, comp, cs, k, r, x, y, LYEpoc, tp)) ok = 1;
                            }
                }
                break;
            }
            case PGOD_PCRL: {
                feature(F_PCRL);
                int step_x = 32, step_y = 32;
                for (int k = CSpoc; k < CEpoc; k++) {
                    const CodingStyle& cs = t.codsty[k];
                    for (int r = RSpoc; r < std::min(cs.nreslevels, REpoc); r++) {
                        int rr = cs.nreslevels - 1 - r;
                        ResLevel& rl = t.comp[k].reslevel[r];
                        step_x = std::min(step_x, rl.log2_prec_w + rr);
                        step_y = std::min(step_y, rl.log2_prec_h + rr);
                    }
                }
                if (step_x >= 31 || step_y >= 31) unsupported("PCRL with a large step");
                step_x = 1 << step_x;
                step_y = 1 << step_y;
                for (int y = t.coord[1][0]; y < t.coord[1][1]; y = (y / step_y + 1) * step_y)
                    for (int x = t.coord[0][0]; x < t.coord[0][1]; x = (x / step_x + 1) * step_x)
                        for (int k = CSpoc; k < CEpoc; k++) {
                            const CodingStyle& cs = t.codsty[k];
                            for (int r = RSpoc; r < std::min(cs.nreslevels, REpoc); r++)
                                position_packets(t, t.comp[k], cs, k, r, x, y, LYEpoc, tp);
                        }
                break;
            }
            default: break;
        }
    }

    // RPCL's and PCRL's precinct at (x, y) in resolution level r of
    // component k, its layers' packets decoded; false where it is not one
    // of the precinct grid's corners, true where FFmpeg counts it a
    // resolution level in use (ok_reslevel) even past the grid
    bool position_packets(Tile& t, Component& comp, const CodingStyle& cs, int k, int r, int x, int y,
                          int LYEpoc, int* tp) {
        int rr = cs.nreslevels - 1 - r;
        ResLevel& rl = comp.reslevel[r];
        int trx0 = ceildiv(t.coord[0][0], int64_t(cdx[k]) << rr);
        int try0 = ceildiv(t.coord[1][0], int64_t(cdy[k]) << rr);
        if (!(y % (uint64_t(cdy[k]) << (rl.log2_prec_h + rr)) == 0 ||
              (y == t.coord[1][0] && (uint64_t(int64_t(try0) << rr) % (1ULL << (rr + rl.log2_prec_h))))))
            return false;
        if (!(x % (uint64_t(cdx[k]) << (rl.log2_prec_w + rr)) == 0 ||
              (x == t.coord[0][0] && (uint64_t(int64_t(trx0) << rr) % (1ULL << (rr + rl.log2_prec_w))))))
            return false;
        unsigned prcx = unsigned(ceildiv(x, int64_t(cdx[k]) << rr) >> rl.log2_prec_w);
        unsigned prcy = unsigned(ceildiv(y, int64_t(cdy[k]) << rr) >> rl.log2_prec_h);
        prcx -= unsigned(ceildivpow2(comp.coord_o[0][0], rr) >> rl.log2_prec_w);
        prcy -= unsigned(ceildivpow2(comp.coord_o[1][0], rr) >> rl.log2_prec_h);
        if (prcx >= unsigned(rl.nprec_x) || prcy >= unsigned(rl.nprec_y)) return true;
        int p = int(prcx + unsigned(rl.nprec_x) * prcy);
        const QuantStyle& qs = t.qntsty[k];
        for (int layno = 0; layno < LYEpoc; layno++)
            decode_packet(t, tp, cs, rl, p, layno, qs.expn + (r ? 3 * (r - 1) + 1 : 0), qs.nguardbits);
        return true;
    }

    void decode_packets(Tile& t) {
        int tp_index = 0;
        bit_index = 8;
        if (t.poc.nb_poc) {
            for (int i = 0; i < t.poc.nb_poc; i++) {
                const PocEntry& e = t.poc.poc[i];
                packets_po(t, e.RSpoc, e.CSpoc, std::min(e.LYEpoc, t.codsty[0].nlayers), e.REpoc,
                           std::min(e.CEpoc, ncomponents), e.Ppoc, &tp_index);
            }
        } else {
            packets_po(t, 0, 0, t.codsty[0].nlayers, 33, ncomponents, t.codsty[0].prog_order, &tp_index);
        }
        g.skip(2);
    }

    // ---- tier 1

    struct T1 {
        std::vector<int> data;
        std::vector<uint16_t> flags;
        int stride = 0;
        Mqc mqc;
    };

    static void set_significance(T1& t1, int x, int y, int negative) {
        x++;
        y++;
        const int s = t1.stride;
        uint16_t* f = t1.flags.data();
        f[y * s + x] |= T1_SIG;
        if (negative) {
            f[y * s + x + 1] |= T1_SIG_W | T1_SGN_W;
            f[y * s + x - 1] |= T1_SIG_E | T1_SGN_E;
            f[(y + 1) * s + x] |= T1_SIG_N | T1_SGN_N;
            f[(y - 1) * s + x] |= T1_SIG_S | T1_SGN_S;
        } else {
            f[y * s + x + 1] |= T1_SIG_W;
            f[y * s + x - 1] |= T1_SIG_E;
            f[(y + 1) * s + x] |= T1_SIG_N;
            f[(y - 1) * s + x] |= T1_SIG_S;
        }
        f[(y + 1) * s + x + 1] |= T1_SIG_NW;
        f[(y + 1) * s + x - 1] |= T1_SIG_NE;
        f[(y - 1) * s + x + 1] |= T1_SIG_SW;
        f[(y - 1) * s + x - 1] |= T1_SIG_SE;
    }

    static void sigpass(T1& t1, int width, int height, int bpno, int bandno, int vsc) {
        const int mask = 3 << (bpno - 1), s = t1.stride;
        for (int y0 = 0; y0 < height; y0 += 4)
            for (int x = 0; x < width; x++)
                for (int y = y0; y < height && y < y0 + 4; y++) {
                    int fm = -1;
                    if (vsc && y == y0 + 3) fm &= ~(T1_SIG_S | T1_SIG_SW | T1_SIG_SE | T1_SGN_S);
                    uint16_t& fl = t1.flags[(y + 1) * s + x + 1];
                    if ((fl & T1_SIG_NB & fm) && !(fl & (T1_SIG | T1_VIS))) {
                        if (t1.mqc.decode(t1.mqc.cx + sigctxno(fl & fm, bandno))) {
                            int xorbit, ctxno = sgnctxno(fl & fm, &xorbit);
                            int& d = t1.data[y * s + x];
                            if (t1.mqc.raw)
                                d = t1.mqc.decode(t1.mqc.cx + ctxno) ? -mask : mask;
                            else
                                d = (t1.mqc.decode(t1.mqc.cx + ctxno) ^ xorbit) ? -mask : mask;
                            set_significance(t1, x, y, d < 0);
                        }
                        fl |= T1_VIS;
                    }
                }
    }

    static void refpass(T1& t1, int width, int height, int bpno, int vsc) {
        const int phalf = 1 << (bpno - 1), nhalf = -phalf, s = t1.stride;
        for (int y0 = 0; y0 < height; y0 += 4)
            for (int x = 0; x < width; x++)
                for (int y = y0; y < height && y < y0 + 4; y++) {
                    uint16_t& fl = t1.flags[(y + 1) * s + x + 1];
                    if ((fl & (T1_SIG | T1_VIS)) == T1_SIG) {
                        int fm = (vsc && y == y0 + 3) ? ~(T1_SIG_S | T1_SIG_SW | T1_SIG_SE | T1_SGN_S) : -1;
                        int ctxno = refctxno(fl & fm);
                        int r = t1.mqc.decode(t1.mqc.cx + ctxno) ? phalf : nhalf;
                        int& d = t1.data[y * s + x];
                        d += d < 0 ? -r : r;
                        fl |= T1_REF;
                    }
                }
    }

    static void clnpass(T1& t1, int width, int height, int bpno, int bandno, int seg_symbols, int vsc) {
        const int mask = 3 << (bpno - 1), s = t1.stride;
        const int any = T1_SIG_NB | T1_VIS | T1_SIG;
        for (int y0 = 0; y0 < height; y0 += 4) {
            for (int x = 0; x < width; x++) {
                int fm = -1, runlen, dec;
                if (vsc) fm &= ~(T1_SIG_S | T1_SIG_SW | T1_SIG_SE | T1_SGN_S);
                if (y0 + 3 < height && !((t1.flags[(y0 + 1) * s + x + 1] & any) ||
                                         (t1.flags[(y0 + 2) * s + x + 1] & any) ||
                                         (t1.flags[(y0 + 3) * s + x + 1] & any) ||
                                         (t1.flags[(y0 + 4) * s + x + 1] & any & fm))) {
                    if (!t1.mqc.decode(t1.mqc.cx + MQC_CX_RL)) continue;
                    runlen = t1.mqc.decode(t1.mqc.cx + MQC_CX_UNI);
                    runlen = (runlen << 1) | t1.mqc.decode(t1.mqc.cx + MQC_CX_UNI);
                    dec = 1;
                } else {
                    runlen = 0;
                    dec = 0;
                }
                for (int y = y0 + runlen; y < y0 + 4 && y < height; y++) {
                    int fmy = -1;
                    if (vsc && y == y0 + 3) fmy &= ~(T1_SIG_S | T1_SIG_SW | T1_SIG_SE | T1_SGN_S);
                    uint16_t& fl = t1.flags[(y + 1) * s + x + 1];
                    if (!dec) {
                        if (!(fl & (T1_SIG | T1_VIS))) dec = t1.mqc.decode(t1.mqc.cx + sigctxno(fl & fmy, bandno));
                    }
                    if (dec) {
                        int xorbit, ctxno = sgnctxno(fl & fmy, &xorbit);
                        int& d = t1.data[y * s + x];
                        d = (t1.mqc.decode(t1.mqc.cx + ctxno) ^ xorbit) ? -mask : mask;
                        set_significance(t1, x, y, d < 0);
                    }
                    dec = 0;
                    fl &= ~T1_VIS;
                }
            }
        }
        if (seg_symbols) {
            int val = t1.mqc.decode(t1.mqc.cx + MQC_CX_UNI);
            val = (val << 1) + t1.mqc.decode(t1.mqc.cx + MQC_CX_UNI);
            val = (val << 1) + t1.mqc.decode(t1.mqc.cx + MQC_CX_UNI);
            val = (val << 1) + t1.mqc.decode(t1.mqc.cx + MQC_CX_UNI);
            (void)val;   // FFmpeg logs a wrong one and goes on
        }
    }

    // decode_cblk: 0 where the code-block holds no data
    int decode_cblk(const CodingStyle& cs, T1& t1, Cblk& cb, int width, int height, int bandpos, int magp) {
        int passno = cb.npasses, pass_t = 2;
        int bpno = cb.nonzerobits - 1 + 31 - magp - 1;
        int pass_cnt = 0, term_cnt = 0;
        const int vsc = cs.cblk_style & CBLK_VSC;
        if (width > 1024 || height > 1024 || width * height > 4096) corrupt("a code-block too large");
        std::fill(t1.data.begin(), t1.data.begin() + size_t(t1.stride) * height, 0);
        if (!cb.length) return 0;
        std::fill(t1.flags.begin(), t1.flags.begin() + size_t(t1.stride) * (height + 2), 0);
        if (cb.data.size() < size_t(cb.length) + 4) cb.data.resize(size_t(cb.length) + 4);
        cb.data[size_t(cb.length)] = 0xff;
        cb.data[size_t(cb.length) + 1] = 0xff;
        t1.mqc.initdec(cb.data.data(), 0, 1);
        while (passno--) {
            if (bpno < 0 || bpno > 29) corrupt("a code-block's bit-plane became invalid");
            switch (pass_t) {
                case 0: sigpass(t1, width, height, bpno + 1, bandpos, vsc); break;
                case 1: refpass(t1, width, height, bpno + 1, vsc); break;
                case 2: clnpass(t1, width, height, bpno + 1, bandpos, cs.cblk_style & CBLK_SEGSYM, vsc); break;
            }
            if (cs.cblk_style & CBLK_RESET) t1.mqc.init_contexts();
            int coder_type;
            if (passno && (coder_type = needs_termination(cs.cblk_style, pass_cnt))) {
                if (term_cnt >= cb.nb_terminations) corrupt("missing needed termination");
                t1.mqc.initdec(cb.data.data() + cb.data_start[size_t(++term_cnt)], coder_type == 2, 0);
            }
            pass_t++;
            if (pass_t == 3) {
                bpno--;
                pass_t = 0;
            }
            pass_cnt++;
        }
        return 1;
    }

    void tile_codeblocks(Tile& t) {
        for (int k = 0; k < ncomponents; k++) {
            auto t0 = std::chrono::steady_clock::now();
            Component& comp = t.comp[k];
            const CodingStyle& cs = t.codsty[k];
            const QuantStyle& qs = t.qntsty[k];
            int coded = 0, subbandno = 0;
            T1 t1;
            t1.stride = (1 << cs.log2_cblk_w) + 2;
            const int max_h = 1 << cs.log2_cblk_h;
            t1.data.assign(size_t(t1.stride) * max_h + 8, 0);
            t1.flags.assign(size_t(t1.stride) * (max_h + 2) + 8, 0);
            const int cw = comp.coord[0][1] - comp.coord[0][0];
            for (int r = 0; r < cs.nreslevels2decode; r++) {
                ResLevel& rl = comp.reslevel[r];
                for (int bandno = 0; bandno < rl.nbands; bandno++, subbandno++) {
                    Band& band = rl.band[bandno];
                    int magp = qs.expn[subbandno] + qs.nguardbits - 1;
                    int bandpos = bandno + (r > 0);
                    if (band.coord[0][0] == band.coord[0][1] || band.coord[1][0] == band.coord[1][1]) continue;
                    for (auto& prec : band.prec)
                        for (auto& cb : prec.cblk) {
                            int w = cb.coord[0][1] - cb.coord[0][0], h = cb.coord[1][1] - cb.coord[1][0];
                            if (!decode_cblk(cs, t1, cb, w, h, bandpos, magp)) continue;
                            coded = 1;
                            int x = cb.coord[0][0] - band.coord[0][0];
                            int y = cb.coord[1][0] - band.coord[1][0];
                            const int downshift = 31 - magp;
                            if (cs.transform == DWT97) {
                                float fscale = band.f_stepsize;
                                fscale /= float(1 << downshift);
                                for (int j = 0; j < h; j++) {
                                    float* dp = &comp.f_data[size_t(cw) * (y + j) + x];
                                    const int* src = t1.data.data() + j * t1.stride;
                                    for (int i = 0; i < w; i++) dp[i] = float(src[i]) * fscale;
                                }
                            } else {
                                for (int j = 0; j < h; j++) {
                                    int32_t* dp = &comp.i_data[size_t(cw) * (y + j) + x];
                                    const int* src = t1.data.data() + j * t1.stride;
                                    if (band.i_stepsize == 32768) {
                                        for (int i = 0; i < w; i++) dp[i] = src[i] / (1 << downshift);
                                    } else {
                                        for (int i = 0; i < w; i++)
                                            dp[i] = int32_t((src[i] * int64_t(band.i_stepsize)) /
                                                            (int64_t(32768) << downshift));
                                    }
                                }
                            }
                        }
                }
            }
            auto t1e = std::chrono::steady_clock::now();
            t1_ms += std::chrono::duration<double, std::milli>(t1e - t0).count();
            if (coded && comp.dwt.ndeclevels) {
                if (cs.transform == DWT97)
                    dwt_decode<float, 5, sr_1d97_float>(comp.dwt, comp.f_data.data());
                else
                    dwt_decode<int32_t, 3, sr_1d53>(comp.dwt, comp.i_data.data());
            }
            dwt_ms += std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - t1e).count();
        }
    }

    // ---- the picture

    void mct_decode(Tile& t) {
        for (int i = 1; i < 3; i++) {
            if (t.codsty[0].transform != t.codsty[i].transform) return;   // "Transforms mismatch"
            if (std::memcmp(t.comp[0].coord, t.comp[i].coord, sizeof(t.comp[0].coord))) return;
        }
        int64_t csize = int64_t(t.comp[0].coord[0][1] - t.comp[0].coord[0][0]) *
                        (t.comp[0].coord[1][1] - t.comp[0].coord[1][0]);
        if (t.codsty[0].transform == DWT97) {
            feature(F_ICT);
            float *s0 = t.comp[0].f_data.data(), *s1 = t.comp[1].f_data.data(), *s2 = t.comp[2].f_data.data();
            for (int64_t i = 0; i < csize; i++) {
                // ict_float_fma3: fmaddps / fnmaddps in this order
                float i0 = std::fmaf(s2[i], kIct0, s0[i]);
                float i1 = std::fmaf(-s1[i], kIct1, s0[i]);
                i1 = std::fmaf(-s2[i], kIct2, i1);
                float i2 = std::fmaf(s1[i], kIct3, s0[i]);
                s0[i] = i0;
                s1[i] = i1;
                s2[i] = i2;
            }
        } else {
            feature(F_RCT);
            int32_t *s0 = t.comp[0].i_data.data(), *s1 = t.comp[1].i_data.data(), *s2 = t.comp[2].i_data.data();
            for (int64_t i = 0; i < csize; i++) {
                int32_t i1 = s0[i] - ((s2[i] + s1[i]) >> 2);
                int32_t i0 = i1 + s2[i];
                int32_t i2 = i1 + s1[i];
                s0[i] = i0;
                s1[i] = i1;
                s2[i] = i2;
            }
        }
    }

    // write_frame_8 and write_frame_16: each component's samples, rounded
    // (lrintf) where the 9/7 ran, level-shifted, clipped to its depth and
    // shifted up to the format's (16 for gray16, rgb48 and rgba64, else
    // the stream's depth); YUV in planes by cdef, the rest packed
    void write_frame(Tile& t) {
        const Format& f = kFormats[pix];
        const bool planar = f.kind == YUV, deep = precision > 8;
        const int pixelsize = planar ? 1 : f.comps;
        const int prec = !deep ? 8 : (pix == PIX_GRAY16 || pix == PIX_RGB48 || pix == PIX_RGBA64) ? 16
                                                                                                  : precision;
        for (int k = 0; k < ncomponents; k++) {
            Component& comp = t.comp[k];
            const CodingStyle& cs = t.codsty[k];
            const int cb = cbps[k];
            int plane = 0;
            if (planar) plane = cdef[k] ? cdef[k] - 1 : ncomponents - 1;
            std::vector<uint8_t>& out = planes[size_t(planar ? plane : 0)];
            const int pw = plane_width(planar ? plane : 0);
            const int w = comp.coord[0][1], h = comp.coord[1][1];
            const float* fp = comp.f_data.data();
            const int32_t* ip = comp.i_data.data();
            for (int y = comp.coord[1][0]; y < h; y++) {
                const size_t at = (size_t(y) * pw + comp.coord[0][0]) * pixelsize + (planar ? 0 : k);
                uint8_t* dst8 = out.data() + at;
                uint16_t* dst16 = reinterpret_cast<uint16_t*>(out.data()) + at;
                for (int x = comp.coord[0][0]; x < w; x++) {
                    int val = cs.transform == DWT97 ? int(std::lrintf(*fp++)) : *ip++;
                    val += 1 << (cb - 1);
                    val = std::min(std::max(val, 0), (1 << cb) - 1);
                    if (deep) {
                        *dst16 = uint16_t(val << (prec - cb));
                        dst16 += pixelsize;
                    } else {
                        *dst8 = uint8_t(val << (prec - cb));
                        dst8 += pixelsize;
                    }
                }
            }
        }
    }

    // the alpha plane (the fourth) is full
    int plane_width(int plane) const {
        return plane && plane < 3 ? -((-dimx) >> kFormats[pix].log2w) : dimx;
    }
    int plane_height(int plane) const {
        return plane && plane < 3 ? -((-dimy) >> kFormats[pix].log2h) : dimy;
    }

    void parse_start(const uint8_t* data, int64_t n) {
        g.init(data, n);
        curtileno = -1;
        for (int& c : cdef) c = -1;
        if (g.left() < 2) corrupt("a packet of fewer than 2 bytes");
        if (g.left() >= 12 && g.be32() == 12 && g.be32() == 0x6a502020 && g.be32() == 0x0d0a870a) {
            feature(F_JP2);
            if (!jp2_find_codestream()) corrupt("could not find the JPEG 2000 codestream box");
            if (colour_space == 16) feature(F_COLR_SRGB);
            if (colour_space == 17) feature(F_COLR_GRAY);
            if (colour_space == 18) feature(F_COLR_SYCC);
        } else {
            g.seek(0);
            feature(F_CODESTREAM);
        }
        while (g.left() >= 3 && g.peek_be16() != SOC) g.skip(1);
        if (g.be16() != SOC) corrupt("SOC marker not present");
    }

    void decode(const uint8_t* data, int64_t n) {
        cleanup();
        try {   // the tiles' memory freed on the way out either way
            parse_start(data, n);
            read_main_headers();
            if (!ncomponents) corrupt("no SIZ marker");
            planes.clear();
            const Format& f = kFormats[pix];
            const size_t bytes = precision > 8 ? 2 : 1;
            if (f.kind != YUV) {
                planes.emplace_back(size_t(dimx) * dimy * f.comps * bytes, 0);
            } else {
                for (int p = 0; p < f.comps; p++)
                    planes.emplace_back(size_t(plane_width(p)) * plane_height(p) * bytes, 0);
            }
            for (size_t i = 0; i < tile.size(); i++) {
                init_tile(int(i));
                decode_packets(tile[i]);
            }
            for (size_t i = 0; i < tile.size(); i++) {
                Tile& t = tile[i];
                tile_codeblocks(t);
                auto t0 = std::chrono::steady_clock::now();
                if (t.codsty[0].mct) mct_decode(t);
                write_frame(t);
                out_ms += std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - t0).count();
                for (int k = 0; k < ncomponents; k++) {
                    feature(t.codsty[k].transform == DWT97 ? F_DWT97 : F_DWT53);
                }
            }
        } catch (...) {
            cleanup();
            throw;
        }
        cleanup();
    }
};

void put_msg(char* msg, int64_t cap, const std::string& s) {
    if (cap <= 0) return;
    size_t n = std::min<size_t>(s.size(), size_t(cap - 1));
    std::memcpy(msg, s.data(), n);
    msg[n] = 0;
}

}  // namespace

extern "C" {

void* j2k_dec_new() { return new Decoder(); }

void j2k_dec_free(void* h) { delete (Decoder*)h; }

int j2k_dec_decode(void* h, const uint8_t* data, int64_t n, char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        d->decode(data, n);
        return J2K_OK;
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    } catch (const std::exception& e) {
        put_msg(msg, cap, e.what());
        return J2K_CORRUPT;
    }
}

// width, height, pixel format (kFormats' index), planes, bits a sample
// in memory (8 or 16)
void j2k_dec_layout(void* h, int64_t* out) {
    Decoder* d = (Decoder*)h;
    out[0] = d->dimx;
    out[1] = d->dimy;
    out[2] = d->pix;
    out[3] = int64_t(d->planes.size());
    out[4] = d->precision > 8 ? 16 : 8;
}

void j2k_dec_output(void* h, void* p0, void* p1, void* p2, void* p3) {
    Decoder* d = (Decoder*)h;
    void* dst[4] = {p0, p1, p2, p3};
    for (size_t i = 0; i < d->planes.size() && i < 4; i++)
        if (dst[i]) std::memcpy(dst[i], d->planes[i].data(), d->planes[i].size());
}

// the palette of a pal8 picture: 256 entries 0xAARRGGBB
void j2k_dec_palette(void* h, uint32_t* out) {
    std::memcpy(out, ((Decoder*)h)->palette, sizeof(((Decoder*)h)->palette));
}

int64_t j2k_dec_features(void* h) { return ((Decoder*)h)->features; }

// the milliseconds spent so far in tier 1 with the dequantisation, the
// inverse DWT, and the inverse MCT with the level shift and output
void j2k_dec_times(void* h, double* out) {
    Decoder* d = (Decoder*)h;
    out[0] = d->t1_ms;
    out[1] = d->dwt_ms;
    out[2] = d->out_ms;
}

// the picture size SIZ gives (with the JP2 wrapper's codestream found):
// J2K_OK and out = (width, height, components, precision)
int j2k_probe(const uint8_t* data, int64_t n, int64_t* out, char* msg, int64_t cap) {
    Decoder d;
    try {
        d.parse_start(data, n);
        for (;;) {
            if (d.g.left() < 4) return J2K_NO_PICTURE;
            int marker = d.g.be16();
            int len = d.g.be16();
            if (marker == SIZ) {
                if (d.g.left() < 36) corrupt("insufficient space for SIZ");
                d.g.skip(2);
                out[0] = d.g.be32();
                out[1] = d.g.be32();
                d.g.skip(24);
                out[2] = d.g.be16();
                out[3] = d.g.left() >= 1 ? (d.g.byte() & 0x7f) + 1 : 0;
                return J2K_OK;
            }
            if (len < 2) return J2K_NO_PICTURE;
            d.g.skip(len - 2);
        }
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

}  // extern "C"
