// TIFF pictures (fourcc tiff in AVI, Matroska's V_QUICKTIME, QuickTime and
// NUT; .tif/.tiff files of an image sequence), decoded in host C++ as FFmpeg
// 8's tiff decoder (tiff.c, tiff_common.c, lzw.c) decodes them for
// cv2.VideoCapture, bit for bit, for what libavcodec's tiff encoder and
// PIL write:
//
//   * the header (II or MM, 42, the first IFD's offset) and that IFD's
//     entries, read as ff_tread_tag reads them: a value that does not fit
//     the entry's 4 bytes (or any of more than 4 values) lies at the offset
//     the entry holds; an entry of an unknown type is passed over; tags out
//     of ascending order are refused (StripByteCounts aside);
//   * strips at any RowsPerStrip (StripOffsets and StripByteCounts as one
//     value or as a list of SHORT or LONG), each decoded on its own:
//     compression 1 (rows copied), 32773 (PackBits), 5 (LZW, lzw.c's TIFF
//     mode: 9-12-bit codes MSB first, early change) and 8 or 32946
//     (Deflate: zlib's inflate is the caller's, tiff.py hands the inflated
//     strips in, as tiff_unpack_zlib reads width x lines bytes of them);
//   * horizontal differencing (Predictor 2) over each row, per byte, or per
//     16-bit sample in the file's byte order;
//   * the layouts init_image picks for them: 8-bit grey (gray8), 16-bit
//     grey (gray16le / gray16be by the byte order), RGB (rgb24) and YCbCr
//     at 2x2 subsampling (yuv420p, unpacked as unpack_yuv unpacks each
//     group of four luma samples, Cb and Cr; an odd size clamps to the
//     last row and column).
//
// Tiles, JPEG-in-TIFF, planar configuration 2, palettes, WhiteIsZero,
// CMYK, alpha, float samples, other bit depths and subsamplings, and
// FillOrder 2 raise kUnsupported; damaged data (an IFD past the packet, a
// strip out of it, a code stream that ends short) raises kCorrupt where
// FFmpeg's decoder fails or keeps a part-decoded picture.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "lossless_common.h"

namespace {

using lossless::Failure;
using lossless::corrupt;
using lossless::unsupported;

// the decoder's feature bits (tiff.py's FEATURES, in order)
enum Feature {
    F_LITTLE_ENDIAN, F_BIG_ENDIAN, F_RAW, F_PACKBITS, F_LZW, F_DEFLATE, F_PREDICTOR,
    F_GRAY8, F_GRAY16, F_RGB24, F_YUV420P, F_STRIPS
};

// the output layouts (tiff.py's LAYOUTS, in order)
enum Layout { GRAY8, GRAY16LE, GRAY16BE, RGB24, YUV420P };

enum { kRaw = 1, kLzw = 5, kAdobeDeflate = 8, kPackBits = 32773, kDeflate = 32946 };
enum { kByte = 1, kAscii = 2, kShort = 3, kLong = 4, kRational = 5 };
// tiff_common.c's type_sizes, by type 0-13
const int kTypeSize[14] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 4};

// a reader over the packet as bytestream2 reads it: past the end, zeros
struct Reader {
    const uint8_t* p;
    int64_t n, pos = 0;
    bool le;
    unsigned byte() { return pos < n ? p[pos++] : (pos++, 0u); }
    unsigned u16() {
        if (pos + 2 > n) { pos = n; return 0; }
        unsigned v = le ? p[pos] | p[pos + 1] << 8 : p[pos] << 8 | p[pos + 1];
        pos += 2;
        return v;
    }
    unsigned u32() {
        if (pos + 4 > n) { pos = n; return 0; }
        const uint8_t* q = p + pos;
        pos += 4;
        return le ? (unsigned)q[0] | q[1] << 8 | q[2] << 16 | (unsigned)q[3] << 24
                  : (unsigned)q[0] << 24 | q[1] << 16 | q[2] << 8 | q[3];
    }
    // ff_tget: one value of a BYTE, SHORT or LONG type (UINT_MAX of others)
    unsigned get(unsigned type) {
        switch (type) {
            case kByte: return byte();
            case kShort: return u16();
            case kLong: return u32();
            default: return 0xFFFFFFFFu;
        }
    }
    void seek(int64_t to) { pos = to < 0 ? 0 : to > n ? n : to; }
};

// lzw.c in FF_LZW_TIFF mode over one strip
struct Lzw {
    static constexpr int kMaxBits = 12, kTable = 1 << kMaxBits;
    Reader gb{};
    unsigned bbuf = 0;
    int bbits = 0, cursize = 9, curmask = 0x1FF, codesize = 8, clear_code = 256, end_code = 257;
    int newcodes = 258, top_slot = 512, slot = 258, fc = -1, oc = -1;
    int sp = 0;
    uint8_t stack[kTable], suffix[kTable];
    uint16_t prefix[kTable];

    void init(const uint8_t* data, int64_t n) {
        gb = Reader{data, n, 0, false};
        bbuf = 0;
        bbits = 0;
        codesize = 8;
        cursize = codesize + 1;
        curmask = (1 << cursize) - 1;
        top_slot = 1 << cursize;
        clear_code = 1 << codesize;
        end_code = clear_code + 1;
        slot = newcodes = clear_code + 2;
        oc = fc = -1;
        sp = 0;
    }
    int code() {
        while (bbits < cursize) {
            bbuf = bbuf << 8 | gb.byte();
            bbits += 8;
        }
        const int c = (int)(bbuf >> (bbits - cursize));
        bbits -= cursize;
        return c & curmask;
    }
    // ff_lzw_decode: up to len bytes into buf; the count decoded
    int decode(uint8_t* buf, int len) {
        if (end_code < 0) return 0;
        int l = len;
        for (;;) {
            while (sp > 0) {
                *buf++ = stack[--sp];
                if (--l == 0) return len;
            }
            const int c = code();
            if (c == end_code) break;
            if (c == clear_code) {
                cursize = codesize + 1;
                curmask = (1 << cursize) - 1;
                slot = newcodes;
                top_slot = 1 << cursize;
                fc = oc = -1;
                continue;
            }
            int k = c;
            if (k == slot && fc >= 0) {
                stack[sp++] = (uint8_t)fc;
                k = oc;
            } else if (k >= slot) {
                break;
            }
            while (k >= newcodes) {
                stack[sp++] = suffix[k];
                k = prefix[k];
            }
            stack[sp++] = (uint8_t)k;
            if (slot < top_slot && oc >= 0) {
                suffix[slot] = (uint8_t)k;
                prefix[slot++] = (uint16_t)oc;
            }
            fc = k;
            oc = c;
            if (slot >= top_slot - 1 && cursize < kMaxBits) {   // TIFF's early change
                top_slot <<= 1;
                curmask = (1 << ++cursize) - 1;
            }
        }
        end_code = -1;
        return len - l;
    }
};

struct Decoder {
    // the IFD
    bool le = true;
    int64_t width = 0, height = 0;
    int bpp = 1, bppcount = 1, photometric = -1, compr = kRaw, predictor = 0, planar = 0;
    int fill_order = 0, rps = 0, sub[2] = {1, 1};
    bool tiled = false, palette = false, sample_format = false;
    int64_t strippos = 0, stripoff = 0, stripsizesoff = 0, stripsize = 0;
    int strips = 0;
    unsigned sot = kLong, sstype = kLong;
    int64_t features = 0;
    int layout = GRAY8;
    // the picture: plane 0 (grey, rgb24 or Y) and yuv420p's U and V
    std::vector<uint8_t> planes[3];
    int64_t stride[3] = {0, 0, 0};
    std::vector<uint8_t> line;
    Lzw lzw;

    // one IFD entry (tiff_decode_tag)
    void tag(Reader& gb, unsigned& last_tag) {
        const unsigned t = gb.u16(), type = gb.u16(), count = gb.u32();
        const int64_t next = gb.pos + 4;
        if (type == 0 || type >= 14) {   // an unknown type: passed over
            gb.seek(next);
            return;
        }
        if (count > 4 || !((int64_t)kTypeSize[type] * count <= 4 || type == kAscii))
            gb.seek(gb.u32());
        if (t <= last_tag) corrupt("IFD entries out of order (tag " + std::to_string(t) + ")");
        if (t != 279) last_tag = t;
        const int64_t off = gb.pos;
        unsigned value = 0;
        if (count == 1) {
            if (type == kByte || type == kShort || type == kLong)
                value = gb.get(type);
            else if (!(type == kAscii))
                value = 0xFFFFFFFFu;
        }
        switch (t) {
            case 256:
                if (value > 0x7FFFFFFFu) corrupt("width out of range");
                width = value;
                break;
            case 257:
                if (value > 0x7FFFFFFFu) corrupt("height out of range");
                height = value;
                break;
            case 258:   // BitsPerSample
                if (count > 5 || count == 0) corrupt("BitsPerSample of " + std::to_string(count) + " components");
                bppcount = (int)count;
                if (count == 1) {
                    bpp = (int)value;
                } else if (type == kByte || type == kShort || type == kLong) {
                    if (gb.n - gb.pos < (int64_t)kTypeSize[type] * count) corrupt("BitsPerSample past the packet");
                    bpp = 0;
                    for (unsigned i = 0; i < count; i++) bpp += (int)gb.get(type);
                } else {
                    bpp = -1;
                }
                break;
            case 277:   // SamplesPerPixel
                if (count != 1) corrupt("SamplesPerPixel of many values");
                if (value > 5 || value == 0) corrupt("SamplesPerPixel " + std::to_string(value));
                if (bppcount == 1) bpp *= (int)value;
                bppcount = (int)value;
                break;
            case 259:   // Compression
                compr = (int)value;
                predictor = 0;
                switch (compr) {
                    case kRaw: case kPackBits: case kLzw: case kAdobeDeflate: case kDeflate: break;
                    case 2: case 3: case 4:
                        unsupported("CCITT compression (" + std::to_string(compr) + ")");
                    case 6: case 7:
                        unsupported("JPEG compression");
                    default:
                        unsupported("compression " + std::to_string(compr));
                }
                break;
            case 278:   // RowsPerStrip
                if (!value || (type == kLong && value == 0xFFFFFFFFu)) value = (unsigned)height;
                rps = (int)std::min<int64_t>(value, height);
                break;
            case 273:   // StripOffsets
                if (count == 1) {
                    if (value > 0x7FFFFFFFu) corrupt("strip offset out of range");
                    strippos = 0;
                    stripoff = value;
                } else {
                    strippos = off;
                }
                strips = (int)count;
                if (strips == bppcount) rps = (int)height;
                sot = type;
                break;
            case 279:   // StripByteCounts
                if (count == 1) {
                    if (value > 0x7FFFFFFFu) corrupt("strip size out of range");
                    stripsizesoff = 0;
                    stripsize = value;
                } else {
                    stripsizesoff = off;
                }
                strips = (int)count;
                sstype = type;
                break;
            case 317: predictor = (int)value; break;
            case 262:   // PhotometricInterpretation
                photometric = (int)value;   // init_image refuses what is not read
                break;
            case 266:
                if (value < 1 || value > 2) corrupt("FillOrder " + std::to_string(value));
                fill_order = (int)value - 1;
                break;
            case 284: planar = value == 2; break;
            case 320: palette = true; break;
            case 339: sample_format = value != 1; break;   // SampleFormat: 1, unsigned
            case 322: case 323: case 324: case 325: tiled = true; break;
            case 530:   // YCbCrSubSampling
                if (count != 2) corrupt("YCbCrSubSampling of " + std::to_string(count) + " values");
                for (int i = 0; i < 2; i++) {
                    sub[i] = (int)gb.get(type);
                    if (sub[i] <= 0) {
                        sub[i] = 1;
                        corrupt("YCbCrSubSampling 0");
                    }
                }
                break;
            default: break;
        }
        if (bpp > 64 || bpp < 0) {
            bpp = 0;
            corrupt("unsupported bits per pixel");
        }
        gb.seek(next);
    }

    void parse(const uint8_t* d, int64_t n) {
        if (n < 8) corrupt("a packet shorter than a TIFF header");
        if (d[0] == 'I' && d[1] == 'I') le = true;
        else if (d[0] == 'M' && d[1] == 'M') le = false;
        else corrupt("no TIFF byte order mark");
        Reader gb{d, n, 2, le};
        if (gb.u16() != 42) corrupt("no TIFF magic number");
        const unsigned ifd = gb.u32();
        if (ifd >= 0xFFFFFFFFu - 14 || n < (int64_t)ifd + 14) corrupt("IFD offset past the packet");
        bpp = bppcount = 1;
        photometric = -1;
        compr = kRaw;
        predictor = planar = fill_order = 0;
        tiled = palette = sample_format = false;
        strippos = stripoff = stripsizesoff = stripsize = 0;
        strips = 0;
        sub[0] = sub[1] = 1;
        rps = 0;
        gb.seek(ifd);
        const unsigned entries = gb.u16();
        if (gb.n - gb.pos < (int64_t)entries * 12) corrupt("IFD entries past the packet");
        unsigned last_tag = 0;
        for (unsigned i = 0; i < entries; i++) tag(gb, last_tag);
        if (tiled) unsupported("tiles");
        if (!strippos && !stripoff) corrupt("image data missing");
        // ff_set_dimensions' av_image_check_size
        if (width <= 0 || height <= 0 || (width + 128) * (height + 128) >= INT32_MAX / 8)
            corrupt("picture size " + std::to_string(width) + "x" + std::to_string(height));
        if (fill_order) unsupported("FillOrder 2");
        if (sample_format) unsupported("float or signed samples");
        if (palette || photometric == 3) unsupported("a palette");
        if (planar) unsupported("planar configuration 2");
        const int key = bpp * 10 + bppcount;
        if (key == 81 && photometric == 1) layout = GRAY8;
        else if (key == 161 && photometric == 1) layout = le ? GRAY16LE : GRAY16BE;
        else if (key == 243 && photometric == 2) layout = RGB24;
        else if (key == 243 && photometric == 6 && sub[0] == 2 && sub[1] == 2) layout = YUV420P;
        else
            unsupported(std::to_string(bppcount) + " samples of " + std::to_string(bpp) +
                        " bits a pixel, photometric " + std::to_string(photometric) +
                        (photometric == 6 ? ", subsampling " + std::to_string(sub[0]) + "x" + std::to_string(sub[1]) : ""));
        if (rps <= 0) rps = (int)height;   // TIFF's default: one strip
        if (rps % sub[1]) corrupt("RowsPerStrip " + std::to_string(rps) + " not a multiple of the subsampling");
        if (predictor == 2 && layout == YUV420P) unsupported("Predictor 2 with YCbCr");
        if (predictor != 0 && predictor != 1 && predictor != 2) unsupported("Predictor " + std::to_string(predictor));
    }

    // unpack_yuv: one group row of 2x2 Y, Cb, Cr into the planes
    void unpack_yuv(const uint8_t* src, int64_t lnum) {
        const int64_t w = (width - 1) / 2 + 1;
        uint8_t* pu = planes[1].data() + lnum / 2 * stride[1];
        uint8_t* pv = planes[2].data() + lnum / 2 * stride[2];
        uint8_t* y = planes[0].data();
        for (int64_t i = 0; i < w; i++) {
            for (int j = 0; j < 2; j++)
                for (int k = 0; k < 2; k++)
                    y[std::min(lnum + j, height - 1) * stride[0] + std::min(i * 2 + k, width - 1)] = *src++;
            *pu++ = *src++;
            *pv++ = *src++;
        }
    }

    // tiff_unpack_strip: rows strip_start.. of one strip (lines of them)
    void unpack_strip(const uint8_t* src, int64_t size, int64_t strip_start, int64_t lines, const uint8_t* inflated,
                      int64_t inflated_n) {
        const bool yuv = layout == YUV420P;
        int64_t w = (width * bpp + 7) >> 3;
        uint8_t* dst = planes[0].data() + strip_start * stride[0];
        int64_t dstride = stride[0];
        if (yuv) {
            w = ((width - 1) / 2 + 1) * 6;
            line.assign((size_t)w, 0);
            dst = line.data();
            dstride = 0;
        }
        if (size <= 0) corrupt("an empty strip");
        if (compr == kDeflate || compr == kAdobeDeflate) {
            features |= 1 << F_DEFLATE;
            // tiff_unpack_zlib: width x lines of the inflated bytes (what
            // inflate left short reads as zeros)
            const uint8_t* z = inflated;
            std::vector<uint8_t> pad;
            if (inflated_n < w * lines) {
                pad.assign((size_t)(w * lines), 0);
                if (inflated_n > 0) std::memcpy(pad.data(), inflated, (size_t)inflated_n);
                z = pad.data();
            }
            for (int64_t l = 0; l < lines; l++) {
                std::memcpy(dst, z, (size_t)w);
                if (yuv) {
                    unpack_yuv(dst, strip_start + l);
                    l += 1;
                }
                dst += dstride;
                z += w;
            }
            return;
        }
        if (compr == kLzw) {
            features |= 1 << F_LZW;
            if (size > 1 && !src[0] && (src[1] & 1)) unsupported("old-style LZW");
            lzw.init(src, size);
            for (int64_t l = 0; l < lines; l++) {
                const int got = lzw.decode(dst, (int)w);
                if (got < w) corrupt("LZW decoded " + std::to_string(got) + " bytes of " + std::to_string(w));
                if (yuv) {
                    unpack_yuv(dst, strip_start + l);
                    l += 1;
                }
                dst += dstride;
            }
            return;
        }
        const uint8_t* s = src;
        const uint8_t* end = src + size;
        for (int64_t l = 0; l < lines; l++) {
            if (compr == kRaw) {
                features |= 1 << F_RAW;
                if (end - s < w) corrupt("a raw strip shorter than its rows");
                std::memcpy(dst, s, (size_t)w);
                s += w;
            } else {   // PackBits
                features |= 1 << F_PACKBITS;
                for (int64_t px = 0; px < w;) {
                    if (end - s < 2) corrupt("PackBits read out of the strip");
                    int code = (int8_t)*s++;
                    if (code >= 0) {
                        code++;
                        if (px + code > w || end - s < code) corrupt("PackBits copy out of bounds");
                        std::memcpy(dst + px, s, (size_t)code);
                        s += code;
                        px += code;
                    } else if (code != -128) {
                        code = -code + 1;
                        if (px + code > w) corrupt("PackBits run out of bounds");
                        std::memset(dst + px, *s++, (size_t)code);
                        px += code;
                    }
                }
            }
            if (yuv) {
                unpack_yuv(dst, strip_start + l);
                l += 1;
            }
            dst += dstride;
        }
    }

    void decode(const uint8_t* d, int64_t n, const uint8_t* inflated, const int64_t* inflated_n) {
        parse(d, n);
        features |= 1 << (le ? F_LITTLE_ENDIAN : F_BIG_ENDIAN);
        features |= 1 << (layout == GRAY8 ? F_GRAY8 : layout == RGB24 ? F_RGB24 : layout == YUV420P ? F_YUV420P : F_GRAY16);
        if (strips > 1) features |= 1 << F_STRIPS;
        if ((compr == kDeflate || compr == kAdobeDeflate) && !inflated_n) corrupt("Deflate strips not inflated");
        const int64_t bytes = layout == GRAY8 ? 1 : layout == RGB24 ? 3 : layout == YUV420P ? 1 : 2;
        stride[0] = width * bytes;
        planes[0].assign((size_t)(stride[0] * height), 0);
        if (layout == YUV420P) {
            stride[1] = stride[2] = (width + 1) / 2;
            planes[1].assign((size_t)(stride[1] * ((height + 1) / 2)), 0);
            planes[2].assign(planes[1].size(), 0);
        }
        if (strips == 1 && !stripsize) stripsize = n - stripoff;
        Reader sizes{d, n, stripsizesoff, le}, offs{d, n, strippos, le};
        if (stripsizesoff >= n && stripsizesoff) corrupt("strip sizes past the packet");
        if (strippos >= n && strippos) corrupt("strip offsets past the packet");
        int64_t remaining = n, k = 0, done = 0;
        const uint8_t* z = inflated;
        for (int64_t i = 0; i < height; i += rps, k++) {
            const int64_t ssize = stripsizesoff ? (int64_t)sizes.get(sstype) : stripsize;
            const int64_t soff = strippos ? (int64_t)offs.get(sot) : stripoff;
            if (soff > n || ssize > n - soff || ssize > remaining) corrupt("strip size or offset out of the packet");
            remaining -= ssize;
            const int64_t lines = std::min<int64_t>(rps, height - i);
            const int64_t zn = inflated_n ? inflated_n[k] : 0;
            unpack_strip(d + soff, ssize, i, lines, z, zn);
            if (z) z += zn;
            done = i + lines;
        }
        if (predictor == 2) {
            features |= 1 << F_PREDICTOR;
            const int64_t soff = bpp >> 3, ssize = width * soff;
            uint8_t* p = planes[0].data();
            for (int64_t i = 0; i < done; i++, p += stride[0]) {
                if (layout == GRAY16LE || layout == GRAY16BE) {
                    for (int64_t j = soff; j < ssize; j += 2) {
                        const bool l = layout == GRAY16LE;
                        const unsigned a = l ? p[j] | p[j + 1] << 8 : p[j] << 8 | p[j + 1];
                        const unsigned b = l ? p[j - soff] | p[j - soff + 1] << 8 : p[j - soff] << 8 | p[j - soff + 1];
                        const unsigned v = (a + b) & 0xFFFF;
                        p[j] = (uint8_t)(l ? v : v >> 8);
                        p[j + 1] = (uint8_t)(l ? v >> 8 : v);
                    }
                } else {
                    for (int64_t j = soff; j < ssize; j++) p[j] = (uint8_t)(p[j] + p[j - soff]);
                }
            }
        }
    }
};

// a packet's layout and size without decoding it: (width, height, layout,
// compression, the strips the decoder reads: one every RowsPerStrip rows,
// whatever StripOffsets' count says)
void probe(const uint8_t* d, int64_t n, int64_t* out) {
    Decoder dec;
    dec.parse(d, n);
    out[0] = dec.width;
    out[1] = dec.height;
    out[2] = dec.layout;
    out[3] = dec.compr;
    out[4] = (dec.height + dec.rps - 1) / dec.rps;
}

}  // namespace

extern "C" {

void* tiff_dec_new() { return new Decoder(); }

void tiff_dec_free(void* h) { delete (Decoder*)h; }

// (width, height, layout, compression, strips) of a packet
int tiff_probe(const uint8_t* d, int64_t n, int64_t* out, char* msg, int64_t cap) {
    try {
        probe(d, n, out);
        return lossless::OK;
    } catch (const Failure& f) {
        lossless::put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// the strips the decoder reads (tiff_probe's out[4] of them): each one's
// (offset, size, the bytes tiff_unpack_zlib reads of it), into out
int tiff_strips(const uint8_t* d, int64_t n, int64_t* out, int64_t count, char* msg, int64_t cap) {
    try {
        Decoder dec;
        dec.parse(d, n);
        Reader sizes{d, n, dec.stripsizesoff, dec.le}, offs{d, n, dec.strippos, dec.le};
        const int64_t w = dec.layout == YUV420P ? ((dec.width - 1) / 2 + 1) * 6 : (dec.width * dec.bpp + 7) >> 3;
        for (int64_t k = 0; k < count && k * dec.rps < dec.height; k++) {
            out[3 * k] = dec.strippos ? (int64_t)offs.get(dec.sot) : dec.stripoff;
            out[3 * k + 1] = dec.stripsizesoff                     ? (int64_t)sizes.get(dec.sstype)
                             : dec.strips == 1 && !dec.stripsize ? n - dec.stripoff
                                                                 : dec.stripsize;
            out[3 * k + 2] = w * std::min<int64_t>(dec.rps, dec.height - k * dec.rps);
        }
        return lossless::OK;
    } catch (const Failure& f) {
        lossless::put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// decode one packet; inflated (Deflate only): the strips' inflated bytes one
// after another, inflated_n their lengths
int tiff_dec_decode(void* h, const uint8_t* d, int64_t n, const uint8_t* inflated, const int64_t* inflated_n,
                    char* msg, int64_t cap) {
    try {
        ((Decoder*)h)->decode(d, n, inflated, inflated_n);
        return lossless::OK;
    } catch (const Failure& f) {
        lossless::put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// the last picture's (width, height, layout)
void tiff_dec_layout(void* h, int64_t* out) {
    const Decoder* dec = (Decoder*)h;
    out[0] = dec->width;
    out[1] = dec->height;
    out[2] = dec->layout;
}

// its planes: plane 0 packed as the layout stores it (2 bytes a grey sample
// in the file's byte order, 3 an RGB pixel), U and V for yuv420p
void tiff_dec_output(void* h, uint8_t* p0, uint8_t* p1, uint8_t* p2) {
    const Decoder* dec = (Decoder*)h;
    uint8_t* out[3] = {p0, p1, p2};
    for (int i = 0; i < 3; i++)
        if (out[i] && !dec->planes[i].empty()) std::memcpy(out[i], dec->planes[i].data(), dec->planes[i].size());
}

int64_t tiff_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
