// flowviz — host-side visualization kernels of the PyTorch port's video
// pipeline (C ABI, loaded with ctypes by flowviz.py, built with g++ at first
// use into opticalflow_tpu_torch/_build/).
//
// The port's own copy of opticalflow_tpu/runtime/flowviz.cpp (colour wheel,
// flow resize, thickness-1 segments), plus the rest of what the overlays
// drew with OpenCV, reproduced bit for bit from OpenCV's drawing code
// (imgproc/drawing.cpp): thick lines with round caps, circles of any
// thickness, so that the GPU machine, which has no OpenCV, draws the same
// pixels.
//
// Exposed functions:
//   ofv_flow_to_color : (H,W,2) f32 flow -> (H,W,3) u8 RGB, Middlebury wheel
//   ofv_flow_max_rad  : max |flow| (for cross-frame normalization)
//   ofv_resize_flow_bilinear : half-pixel bilinear flow resize + vector
//                              rescale (the per-frame quarter->full step)
//   ofv_draw_segments : batch 8-connected thickness-1 segments, bit-exact
//                       vs cv2.line incl. rect clipping (arrow overlays)
//   ofv_draw_thick_segments : batch segments of thickness >= 2 with round
//                       caps, bit-exact vs cv2.line(..., thickness)
//   ofv_draw_circle   : cv2.circle with LINE_8, any thickness (filled < 0)
//   ofv_warp_perspective_linear : cv2.warpPerspective, INTER_LINEAR, zero
//                       border, in OpenCV 5's float32 arithmetic

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

constexpr int kSeg[6] = {15, 6, 4, 11, 13, 6};  // RY YG GC CB BM MR
constexpr int kNCols = 55;

struct Wheel {
  uint8_t rgb[kNCols][3];
  Wheel() {
    int col = 0;
    auto ramp = [](int i, int n) {
      return static_cast<uint8_t>(std::floor(255.0 * i / n));
    };
    for (int i = 0; i < kSeg[0]; ++i, ++col) {  // RY: R=255, G up
      rgb[col][0] = 255; rgb[col][1] = ramp(i, kSeg[0]); rgb[col][2] = 0;
    }
    for (int i = 0; i < kSeg[1]; ++i, ++col) {  // YG: R down, G=255
      rgb[col][0] = 255 - ramp(i, kSeg[1]); rgb[col][1] = 255; rgb[col][2] = 0;
    }
    for (int i = 0; i < kSeg[2]; ++i, ++col) {  // GC: G=255, B up
      rgb[col][0] = 0; rgb[col][1] = 255; rgb[col][2] = ramp(i, kSeg[2]);
    }
    for (int i = 0; i < kSeg[3]; ++i, ++col) {  // CB: G down, B=255
      rgb[col][0] = 0; rgb[col][1] = 255 - ramp(i, kSeg[3]); rgb[col][2] = 255;
    }
    for (int i = 0; i < kSeg[4]; ++i, ++col) {  // BM: B=255, R up
      rgb[col][0] = ramp(i, kSeg[4]); rgb[col][1] = 0; rgb[col][2] = 255;
    }
    for (int i = 0; i < kSeg[5]; ++i, ++col) {  // MR: B down, R=255
      rgb[col][0] = 255; rgb[col][1] = 0; rgb[col][2] = 255 - ramp(i, kSeg[5]);
    }
  }
};
const Wheel kWheel;

}  // namespace

extern "C" {

double ofv_flow_max_rad(const float* flow, int64_t n_px) {
  double m = 0.0;
  for (int64_t i = 0; i < n_px; ++i) {
    const double u = flow[2 * i], v = flow[2 * i + 1];
    const double r = u * u + v * v;
    if (r > m) m = r;
  }
  return std::sqrt(m);
}

// max_rad <= 0 means: normalize by this frame's own max (reference behavior).
void ofv_flow_to_color(const float* flow, int64_t h, int64_t w,
                       double max_rad, uint8_t* out) {
  const int64_t n = h * w;
  if (max_rad <= 0.0) max_rad = ofv_flow_max_rad(flow, n);
  const double inv_max = 1.0 / (max_rad + 1e-5);
  for (int64_t i = 0; i < n; ++i) {
    const double u = flow[2 * i], v = flow[2 * i + 1];
    const double rad = std::sqrt(u * u + v * v);
    // fk in [1, 55]; lerp between wheel[(k0-1)%55] and wheel[k0%55]
    const double ang = std::atan2(-v, -u) / M_PI;            // [-1, 1]
    const double fk = (ang + 1.0) * 0.5 * (kNCols - 1) + 1.0;
    const int k0 = static_cast<int>(std::floor(fk));
    const double f = fk - k0;
    const int i0 = ((k0 - 1) % kNCols + kNCols) % kNCols;
    const int i1 = (k0 % kNCols + kNCols) % kNCols;
    const double rn = std::min(std::max(rad * inv_max, 0.0), 1.0);
    for (int ch = 0; ch < 3; ++ch) {
      const double c0 = kWheel.rgb[i0][ch] / 255.0;
      const double c1 = kWheel.rgb[i1][ch] / 255.0;
      const double col = 1.0 - rn * (1.0 - ((1.0 - f) * c0 + f * c1));
      out[3 * i + ch] = static_cast<uint8_t>(
          std::min(std::max(col, 0.0), 1.0) * 255.0);
    }
  }
}

// Half-pixel bilinear resize of an (h,w,2) flow field to (oh,ow), scaling
// u by ow/w and v by oh/h (the create_quiver_frame resize,
// pwc_extract_flow_video.py:100-107).
void ofv_resize_flow_bilinear(const float* flow, int64_t h, int64_t w,
                              int64_t oh, int64_t ow, float* out) {
  const double sx = static_cast<double>(w) / ow;
  const double sy = static_cast<double>(h) / oh;
  const float vsx = static_cast<float>(ow) / w;
  const float vsy = static_cast<float>(oh) / h;
  for (int64_t y = 0; y < oh; ++y) {
    double fy = (y + 0.5) * sy - 0.5;
    fy = std::min(std::max(fy, 0.0), static_cast<double>(h - 1));
    const int64_t y0 = std::min(static_cast<int64_t>(fy), h - 2 >= 0 ? h - 2 : 0);
    const double wy = fy - y0;
    for (int64_t x = 0; x < ow; ++x) {
      double fx = (x + 0.5) * sx - 0.5;
      fx = std::min(std::max(fx, 0.0), static_cast<double>(w - 1));
      const int64_t x0 = std::min(static_cast<int64_t>(fx),
                                  w - 2 >= 0 ? w - 2 : 0);
      const double wx = fx - x0;
      const int64_t y1 = std::min(y0 + 1, h - 1), x1 = std::min(x0 + 1, w - 1);
      for (int ch = 0; ch < 2; ++ch) {
        const double a = flow[(y0 * w + x0) * 2 + ch];
        const double b = flow[(y0 * w + x1) * 2 + ch];
        const double c = flow[(y1 * w + x0) * 2 + ch];
        const double d = flow[(y1 * w + x1) * 2 + ch];
        const double top = a + (b - a) * wx;
        const double bot = c + (d - c) * wx;
        const double val = top + (bot - top) * wy;
        out[(y * ow + x) * 2 + ch] =
            static_cast<float>(val) * (ch == 0 ? vsx : vsy);
      }
    }
  }
}

}  // extern "C"

namespace {

// Iterative outcode clip of a segment to [0, w-1] x [0, h-1], with the same
// integer intersection arithmetic OpenCV's clipLine uses (truncating int64
// division, y-sides first, endpoint-at-a-time recode).  Matching the clip
// exactly matters: the rasterizer below accumulates Bresenham error from the
// (clipped) start point, so a clip that lands one pixel off produces a
// visibly different line.  Held to cv2 in tests/test_torch_viz.py.
bool ClipSegment(int64_t w, int64_t h, int64_t& x1, int64_t& y1,
                 int64_t& x2, int64_t& y2) {
  const int64_t right = w - 1, bottom = h - 1;
  if (w <= 0 || h <= 0) return false;
  auto code = [&](int64_t x, int64_t y) {
    return (x < 0 ? 1 : 0) + (x > right ? 2 : 0) +
           (y < 0 ? 4 : 0) + (y > bottom ? 8 : 0);
  };
  int c1 = code(x1, y1), c2 = code(x2, y2);
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (a - y1) * (x2 - x1) / (y2 - y1);
      y1 = a;
      c1 = (x1 < 0 ? 1 : 0) + (x1 > right ? 2 : 0);
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (a - y2) * (x2 - x1) / (y2 - y1);
      y2 = a;
      c2 = (x2 < 0 ? 1 : 0) + (x2 > right ? 2 : 0);
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (a - x1) * (y2 - y1) / (x2 - x1);
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (a - x2) * (y2 - y1) / (x2 - x1);
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// One 8-connected thickness-1 segment into an (h, w, 3) u8 image, its
// out-of-bounds endpoints rect-clipped first: cv2.line(..., thickness=1)
// step for step, through the same left-to-right endpoint normalization and
// half-error tie-breaking.
void Segment8(uint8_t* img, int64_t h, int64_t w, int64_t x1, int64_t y1,
              int64_t x2, int64_t y2, uint8_t b, uint8_t g, uint8_t r) {
  if (!ClipSegment(w, h, x1, y1, x2, y2)) return;
  int64_t dx = x2 - x1, dy = y2 - y1;
  int64_t delta_x = 1, delta_y = 1;
  if (dx < 0) {  // draw left-to-right, like cv2's LineIterator
    dx = -dx; dy = -dy;
    x1 = x2; y1 = y2;
  }
  if (dy < 0) { dy = -dy; delta_y = -1; }
  const bool vert = dy > dx;
  if (vert) { std::swap(dx, dy); std::swap(delta_x, delta_y); }
  int64_t err = dx - (dy + dy);
  const int64_t plus_delta = dx + dx;
  const int64_t minus_delta = -(dy + dy);
  const int64_t count = dx + 1;
  const int64_t step_major = (vert ? w * 3 : 3) * delta_x;
  const int64_t step_minor = (vert ? 3 : w * 3) * delta_y;
  uint8_t* p = img + (y1 * w + x1) * 3;
  for (int64_t i = 0; i < count; ++i) {
    p[0] = b; p[1] = g; p[2] = r;
    const int64_t mask = err < 0 ? -1 : 0;
    err += minus_delta + (plus_delta & mask);
    p += step_major + (step_minor & mask);
  }
}

}  // namespace

extern "C" {

// Draw n thickness-1 segments (Segment8) into an (h, w, 3) u8 image, in
// place; segs is (n, 4) int32 [x1, y1, x2, y2].  Bit-exact vs a loop of
// cv2.line(..., thickness=1), i.e. vs the reference's per-arrow cv2.line
// calls (pwc_extract_flow_video.py:94-142).
void ofv_draw_segments(uint8_t* img, int64_t h, int64_t w,
                       const int32_t* segs, int64_t n,
                       uint8_t b, uint8_t g, uint8_t r) {
  for (int64_t s = 0; s < n; ++s) {
    Segment8(img, h, w, segs[4 * s], segs[4 * s + 1], segs[4 * s + 2],
             segs[4 * s + 3], b, g, r);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Thick lines, polygons and circles: OpenCV's LINE_8 rasterisers in its
// 16-bit fixed point (XY_SHIFT), step for step, so the pixels they set are
// the ones cv2.line(thickness >= 2), cv2.polylines and cv2.circle set.

namespace {

constexpr int kXYShift = 16;
constexpr int64_t kXYOne = int64_t{1} << kXYShift;

// sin of 0..450 degrees to 7 decimals, as float: OpenCV's own table, which
// its ellipse2Poly reads (tests/test_torch_viz.py recovers cv2's from
// cv2.ellipse2Poly and compares)
const float kSinTable[451] = {
    0.0000000f, 0.0174524f, 0.0348995f, 0.0523360f, 0.0697565f, 0.0871557f,
    0.1045285f, 0.1218693f, 0.1391731f, 0.1564345f, 0.1736482f, 0.1908090f,
    0.2079117f, 0.2249511f, 0.2419219f, 0.2588190f, 0.2756374f, 0.2923717f,
    0.3090170f, 0.3255682f, 0.3420201f, 0.3583679f, 0.3746066f, 0.3907311f,
    0.4067366f, 0.4226183f, 0.4383711f, 0.4539905f, 0.4694716f, 0.4848096f,
    0.5000000f, 0.5150381f, 0.5299193f, 0.5446390f, 0.5591929f, 0.5735764f,
    0.5877853f, 0.6018150f, 0.6156615f, 0.6293204f, 0.6427876f, 0.6560590f,
    0.6691306f, 0.6819984f, 0.6946584f, 0.7071068f, 0.7193398f, 0.7313537f,
    0.7431448f, 0.7547096f, 0.7660444f, 0.7771460f, 0.7880108f, 0.7986355f,
    0.8090170f, 0.8191520f, 0.8290376f, 0.8386706f, 0.8480481f, 0.8571673f,
    0.8660254f, 0.8746197f, 0.8829476f, 0.8910065f, 0.8987940f, 0.9063078f,
    0.9135455f, 0.9205049f, 0.9271839f, 0.9335804f, 0.9396926f, 0.9455186f,
    0.9510565f, 0.9563048f, 0.9612617f, 0.9659258f, 0.9702957f, 0.9743701f,
    0.9781476f, 0.9816272f, 0.9848078f, 0.9876883f, 0.9902681f, 0.9925462f,
    0.9945219f, 0.9961947f, 0.9975641f, 0.9986295f, 0.9993908f, 0.9998477f,
    1.0000000f, 0.9998477f, 0.9993908f, 0.9986295f, 0.9975641f, 0.9961947f,
    0.9945219f, 0.9925462f, 0.9902681f, 0.9876883f, 0.9848078f, 0.9816272f,
    0.9781476f, 0.9743701f, 0.9702957f, 0.9659258f, 0.9612617f, 0.9563048f,
    0.9510565f, 0.9455186f, 0.9396926f, 0.9335804f, 0.9271839f, 0.9205049f,
    0.9135455f, 0.9063078f, 0.8987940f, 0.8910065f, 0.8829476f, 0.8746197f,
    0.8660254f, 0.8571673f, 0.8480481f, 0.8386706f, 0.8290376f, 0.8191520f,
    0.8090170f, 0.7986355f, 0.7880108f, 0.7771460f, 0.7660444f, 0.7547096f,
    0.7431448f, 0.7313537f, 0.7193398f, 0.7071068f, 0.6946584f, 0.6819984f,
    0.6691306f, 0.6560590f, 0.6427876f, 0.6293204f, 0.6156615f, 0.6018150f,
    0.5877853f, 0.5735764f, 0.5591929f, 0.5446390f, 0.5299193f, 0.5150381f,
    0.5000000f, 0.4848096f, 0.4694716f, 0.4539905f, 0.4383711f, 0.4226183f,
    0.4067366f, 0.3907311f, 0.3746066f, 0.3583679f, 0.3420201f, 0.3255682f,
    0.3090170f, 0.2923717f, 0.2756374f, 0.2588190f, 0.2419219f, 0.2249511f,
    0.2079117f, 0.1908090f, 0.1736482f, 0.1564345f, 0.1391731f, 0.1218693f,
    0.1045285f, 0.0871557f, 0.0697565f, 0.0523360f, 0.0348995f, 0.0174524f,
    0.0000000f, -0.0174524f, -0.0348995f, -0.0523360f, -0.0697565f, -0.0871557f,
    -0.1045285f, -0.1218693f, -0.1391731f, -0.1564345f, -0.1736482f, -0.1908090f,
    -0.2079117f, -0.2249511f, -0.2419219f, -0.2588190f, -0.2756374f, -0.2923717f,
    -0.3090170f, -0.3255682f, -0.3420201f, -0.3583679f, -0.3746066f, -0.3907311f,
    -0.4067366f, -0.4226183f, -0.4383711f, -0.4539905f, -0.4694716f, -0.4848096f,
    -0.5000000f, -0.5150381f, -0.5299193f, -0.5446390f, -0.5591929f, -0.5735764f,
    -0.5877853f, -0.6018150f, -0.6156615f, -0.6293204f, -0.6427876f, -0.6560590f,
    -0.6691306f, -0.6819984f, -0.6946584f, -0.7071068f, -0.7193398f, -0.7313537f,
    -0.7431448f, -0.7547096f, -0.7660444f, -0.7771460f, -0.7880108f, -0.7986355f,
    -0.8090170f, -0.8191520f, -0.8290376f, -0.8386706f, -0.8480481f, -0.8571673f,
    -0.8660254f, -0.8746197f, -0.8829476f, -0.8910065f, -0.8987940f, -0.9063078f,
    -0.9135455f, -0.9205049f, -0.9271839f, -0.9335804f, -0.9396926f, -0.9455186f,
    -0.9510565f, -0.9563048f, -0.9612617f, -0.9659258f, -0.9702957f, -0.9743701f,
    -0.9781476f, -0.9816272f, -0.9848078f, -0.9876883f, -0.9902681f, -0.9925462f,
    -0.9945219f, -0.9961947f, -0.9975641f, -0.9986295f, -0.9993908f, -0.9998477f,
    -1.0000000f, -0.9998477f, -0.9993908f, -0.9986295f, -0.9975641f, -0.9961947f,
    -0.9945219f, -0.9925462f, -0.9902681f, -0.9876883f, -0.9848078f, -0.9816272f,
    -0.9781476f, -0.9743701f, -0.9702957f, -0.9659258f, -0.9612617f, -0.9563048f,
    -0.9510565f, -0.9455186f, -0.9396926f, -0.9335804f, -0.9271839f, -0.9205049f,
    -0.9135455f, -0.9063078f, -0.8987940f, -0.8910065f, -0.8829476f, -0.8746197f,
    -0.8660254f, -0.8571673f, -0.8480481f, -0.8386706f, -0.8290376f, -0.8191520f,
    -0.8090170f, -0.7986355f, -0.7880108f, -0.7771460f, -0.7660444f, -0.7547096f,
    -0.7431448f, -0.7313537f, -0.7193398f, -0.7071068f, -0.6946584f, -0.6819984f,
    -0.6691306f, -0.6560590f, -0.6427876f, -0.6293204f, -0.6156615f, -0.6018150f,
    -0.5877853f, -0.5735764f, -0.5591929f, -0.5446390f, -0.5299193f, -0.5150381f,
    -0.5000000f, -0.4848096f, -0.4694716f, -0.4539905f, -0.4383711f, -0.4226183f,
    -0.4067366f, -0.3907311f, -0.3746066f, -0.3583679f, -0.3420201f, -0.3255682f,
    -0.3090170f, -0.2923717f, -0.2756374f, -0.2588190f, -0.2419219f, -0.2249511f,
    -0.2079117f, -0.1908090f, -0.1736482f, -0.1564345f, -0.1391731f, -0.1218693f,
    -0.1045285f, -0.0871557f, -0.0697565f, -0.0523360f, -0.0348995f, -0.0174524f,
    0.0000000f, 0.0174524f, 0.0348995f, 0.0523360f, 0.0697565f, 0.0871557f,
    0.1045285f, 0.1218693f, 0.1391731f, 0.1564345f, 0.1736482f, 0.1908090f,
    0.2079117f, 0.2249511f, 0.2419219f, 0.2588190f, 0.2756374f, 0.2923717f,
    0.3090170f, 0.3255682f, 0.3420201f, 0.3583679f, 0.3746066f, 0.3907311f,
    0.4067366f, 0.4226183f, 0.4383711f, 0.4539905f, 0.4694716f, 0.4848096f,
    0.5000000f, 0.5150381f, 0.5299193f, 0.5446390f, 0.5591929f, 0.5735764f,
    0.5877853f, 0.6018150f, 0.6156615f, 0.6293204f, 0.6427876f, 0.6560590f,
    0.6691306f, 0.6819984f, 0.6946584f, 0.7071068f, 0.7193398f, 0.7313537f,
    0.7431448f, 0.7547096f, 0.7660444f, 0.7771460f, 0.7880108f, 0.7986355f,
    0.8090170f, 0.8191520f, 0.8290376f, 0.8386706f, 0.8480481f, 0.8571673f,
    0.8660254f, 0.8746197f, 0.8829476f, 0.8910065f, 0.8987940f, 0.9063078f,
    0.9135455f, 0.9205049f, 0.9271839f, 0.9335804f, 0.9396926f, 0.9455186f,
    0.9510565f, 0.9563048f, 0.9612617f, 0.9659258f, 0.9702957f, 0.9743701f,
    0.9781476f, 0.9816272f, 0.9848078f, 0.9876883f, 0.9902681f, 0.9925462f,
    0.9945219f, 0.9961947f, 0.9975641f, 0.9986295f, 0.9993908f, 0.9998477f,
    1.0000000f,
};

struct Canvas {
  uint8_t* img;
  int64_t h, w;
  uint8_t c[3];
  void Put(int64_t x, int64_t y) const {
    if (0 <= x && x < w && 0 <= y && y < h) {
      uint8_t* p = img + (y * w + x) * 3;
      p[0] = c[0]; p[1] = c[1]; p[2] = c[2];
    }
  }
  // x1..x2 inclusive on row y, already clipped to the image
  void HLine(int64_t y, int64_t x1, int64_t x2) const {
    uint8_t* p = img + (y * w + x1) * 3;
    for (int64_t x = x1; x <= x2; ++x, p += 3) {
      p[0] = c[0]; p[1] = c[1]; p[2] = c[2];
    }
  }
};

inline int64_t CvRound(double v) { return std::llrint(v); }

// cv::clipLine on 64-bit points, its (double) divisions included
bool ClipLine64(int64_t width, int64_t height, int64_t& x1, int64_t& y1,
                int64_t& x2, int64_t& y2) {
  const int64_t right = width - 1, bottom = height - 1;
  if (width <= 0 || height <= 0) return false;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += static_cast<int64_t>(static_cast<double>(a - y1) * (x2 - x1) /
                                 (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += static_cast<int64_t>(static_cast<double>(a - y2) * (x2 - x1) /
                                 (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += static_cast<int64_t>(static_cast<double>(a - x1) * (y2 - y1) /
                                   (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += static_cast<int64_t>(static_cast<double>(a - x2) * (y2 - y1) /
                                   (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// OpenCV's Line2: an 8-connected line between two fixed-point points
void Line2(const Canvas& cv, int64_t x1, int64_t y1, int64_t x2, int64_t y2) {
  if (!ClipLine64(cv.w << kXYShift, cv.h << kXYShift, x1, y1, x2, y2)) return;
  int64_t dx = x2 - x1, dy = y2 - y1;
  const int64_t j = dx < 0 ? -1 : 0;
  const int64_t ax = (dx ^ j) - j;
  const int64_t i = dy < 0 ? -1 : 0;
  const int64_t ay = (dy ^ i) - i;
  int64_t x_step, y_step, ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    x1 ^= x2 & j; x2 ^= x1 & j; x1 ^= x2 & j;
    y1 ^= y2 & j; y2 ^= y1 & j; y1 ^= y2 & j;
    x_step = kXYOne;
    y_step = (dy << kXYShift) / (ax | 1);
    ecount = (x2 - x1) >> kXYShift;
  } else {
    dx = (dx ^ i) - i;
    x1 ^= x2 & i; x2 ^= x1 & i; x1 ^= x2 & i;
    y1 ^= y2 & i; y2 ^= y1 & i; y1 ^= y2 & i;
    x_step = (dx << kXYShift) / (ay | 1);
    y_step = kXYOne;
    ecount = (y2 - y1) >> kXYShift;
  }
  x1 += kXYOne >> 1;
  y1 += kXYOne >> 1;
  cv.Put((x2 + (kXYOne >> 1)) >> kXYShift, (y2 + (kXYOne >> 1)) >> kXYShift);
  if (ax > ay) {
    x1 >>= kXYShift;
    while (ecount >= 0) {
      cv.Put(x1, y1 >> kXYShift);
      x1++;
      y1 += y_step;
      ecount--;
    }
  } else {
    y1 >>= kXYShift;
    while (ecount >= 0) {
      cv.Put(x1 >> kXYShift, y1);
      x1 += x_step;
      y1++;
      ecount--;
    }
  }
}

// OpenCV's FillConvexPoly for LINE_8 with points in 16-bit fixed point:
// the outline by Line2, then the scanlines between two walked edges
void FillConvexPoly(const Canvas& cv, const int64_t (*v)[2], int npts) {
  const int shift = kXYShift;
  const int64_t delta = (int64_t{1} << shift) >> 1;
  const int64_t delta1 = kXYOne >> 1, delta2 = kXYOne >> 1;
  struct Edge { int idx, di; int64_t x, dx; int64_t ye; } edge[2];
  int imin = 0;
  int edges = npts;
  int64_t xmin = v[0][0], xmax = v[0][0], ymin = v[0][1], ymax = v[0][1];
  int64_t p0x = v[npts - 1][0], p0y = v[npts - 1][1];
  for (int i = 0; i < npts; ++i) {
    const int64_t px = v[i][0], py = v[i][1];
    if (py < ymin) { ymin = py; imin = i; }
    ymax = std::max(ymax, py);
    xmax = std::max(xmax, px);
    xmin = std::min(xmin, px);
    Line2(cv, p0x, p0y, px, py);
    p0x = px; p0y = py;
  }
  xmin = (xmin + delta) >> shift;
  xmax = (xmax + delta) >> shift;
  ymin = (ymin + delta) >> shift;
  ymax = (ymax + delta) >> shift;
  if (npts < 3 || static_cast<int>(xmax) < 0 || static_cast<int>(ymax) < 0 ||
      static_cast<int>(xmin) >= cv.w || static_cast<int>(ymin) >= cv.h)
    return;
  ymax = std::min(ymax, cv.h - 1);
  edge[0].idx = edge[1].idx = imin;
  int64_t y = ymin;
  edge[0].ye = edge[1].ye = y;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -kXYOne;
  edge[0].dx = edge[1].dx = 0;
  do {
    for (int i = 0; i < 2; ++i) {
      if (y >= edge[i].ye) {
        int idx0 = edge[i].idx, di = edge[i].di;
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        for (; edges-- > 0;) {
          const int64_t ty = (v[idx][1] + delta) >> shift;
          if (ty > y) {
            const int64_t xs = v[idx0][0], xe = v[idx][0];
            edge[i].ye = ty;
            edge[i].dx = ((xe - xs) * 2 + (ty - y)) / (2 * (ty - y));
            edge[i].x = xs;
            edge[i].idx = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) { left = 1; right = 0; }
      int64_t xx1 = (edge[left].x + delta1) >> kXYShift;
      int64_t xx2 = (edge[right].x + delta2) >> kXYShift;
      if (xx2 >= 0 && xx1 < cv.w) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= cv.w) xx2 = cv.w - 1;
        cv.HLine(y, xx1, xx2);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= ymax);
}

// OpenCV's Circle (Bresenham, integer centre and radius): the outline when
// fill is false, horizontal spans when it is true
void Circle(const Canvas& cv, int64_t cx, int64_t cy, int64_t radius,
            bool fill) {
  const int64_t width = cv.w, height = cv.h;
  int64_t err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  const bool inside = cx >= radius && cx < width - radius &&
                      cy >= radius && cy < height - radius;
  while (dx >= dy) {
    const int64_t y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int64_t x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (inside) {
      if (!fill) {
        cv.Put(x11, y11); cv.Put(x11, y12); cv.Put(x12, y11); cv.Put(x12, y12);
        cv.Put(x21, y21); cv.Put(x21, y22); cv.Put(x22, y21); cv.Put(x22, y22);
      } else {
        cv.HLine(y11, x11, x12); cv.HLine(y12, x11, x12);
        cv.HLine(y21, x21, x22); cv.HLine(y22, x21, x22);
      }
    } else if (x11 < width && x12 >= 0 && y21 < height && y22 >= 0) {
      if (fill) {
        x11 = std::max<int64_t>(x11, 0);
        x12 = std::min<int64_t>(x12, width - 1);
      }
      for (const int64_t yy : {y11, y12}) {
        if (0 <= yy && yy < height) {
          if (!fill) {
            if (x11 >= 0) cv.Put(x11, yy);
            if (x12 < width) cv.Put(x12, yy);
          } else {
            cv.HLine(yy, x11, x12);
          }
        }
      }
      if (x21 < width && x22 >= 0) {
        if (fill) {
          x21 = std::max<int64_t>(x21, 0);
          x22 = std::min<int64_t>(x22, width - 1);
        }
        for (const int64_t yy : {y21, y22}) {
          if (0 <= yy && yy < height) {
            if (!fill) {
              if (x21 >= 0) cv.Put(x21, yy);
              if (x22 < width) cv.Put(x22, yy);
            } else {
              cv.HLine(yy, x21, x22);
            }
          }
        }
      }
    }
    dy++;
    err += plus;
    plus += 2;
    const int64_t mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

// OpenCV's ThickLine for thickness >= 2, LINE_8, points in fixed point: a
// quadrilateral, then a filled cap circle at p0 (flags & 1) and p1 (& 2)
void ThickLine(const Canvas& cv, int64_t p0x, int64_t p0y, int64_t p1x,
               int64_t p1y, int thickness, int flags) {
  const double inv_one = 1.0 / kXYOne;
  const double dx = (p0x - p1x) * inv_one, dy = (p1y - p0y) * inv_one;
  double r = dx * dx + dy * dy;
  const int odd = thickness & 1;
  const int64_t th = static_cast<int64_t>(thickness) << (kXYShift - 1);
  if (std::fabs(r) > 2.220446049250313e-16) {
    r = (th + odd * kXYOne * 0.5) / std::sqrt(r);
    const int64_t dpx = CvRound(dy * r), dpy = CvRound(dx * r);
    const int64_t pt[4][2] = {{p0x + dpx, p0y + dpy}, {p0x - dpx, p0y - dpy},
                              {p1x - dpx, p1y - dpy}, {p1x + dpx, p1y + dpy}};
    FillConvexPoly(cv, pt, 4);
  }
  for (int i = 0; i < 2; ++i) {
    if (flags & (i + 1)) {
      const int64_t cx = (p0x + (kXYOne >> 1)) >> kXYShift;
      const int64_t cy = (p0y + (kXYOne >> 1)) >> kXYShift;
      Circle(cv, cx, cy, (th + (kXYOne >> 1)) >> kXYShift, true);
    }
    p0x = p1x;
    p0y = p1y;
  }
}

// OpenCV's EllipseEx for a full circle of thickness >= 2 (LINE_8): the
// ellipse2Poly polygon (its angle step from the radius, its sine table),
// rounded to fixed point, drawn as an open polyline of thick segments
void CircleEx(const Canvas& cv, int64_t cx, int64_t cy, int64_t radius,
              int thickness) {
  const int64_t ax = std::abs(radius) << kXYShift;
  const double ccx = static_cast<double>(cx << kXYShift);
  const double ccy = static_cast<double>(cy << kXYShift);
  int delta = static_cast<int>((ax + (kXYOne >> 1)) >> kXYShift);
  delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
  std::vector<std::array<int64_t, 2>> v;
  for (int i = 0; i < 360 + delta; i += delta) {
    const int angle = i > 360 ? 360 : i;
    const double x = static_cast<double>(ax) * kSinTable[450 - angle];
    const double y = static_cast<double>(ax) * kSinTable[angle];
    // ellipse2Poly's rotation by angle 0: cos 1.0f, sin 0.0f
    const double px = ccx + x * 1.0f - y * 0.0f;
    const double py = ccy + x * 0.0f + y * 1.0f;
    int64_t qx = CvRound(px / kXYOne) << kXYShift;
    int64_t qy = CvRound(py / kXYOne) << kXYShift;
    qx += CvRound(px - qx);
    qy += CvRound(py - qy);
    if (v.empty() || v.back()[0] != qx || v.back()[1] != qy)
      v.push_back({qx, qy});
  }
  if (v.size() == 1) v.assign(2, {cx << kXYShift, cy << kXYShift});
  // PolyLine, open: caps at both ends of the first segment, then at the end
  int flags = 3;
  for (size_t i = 1; i < v.size(); ++i) {
    ThickLine(cv, v[i - 1][0], v[i - 1][1], v[i][0], v[i][1], thickness,
              flags);
    flags = 2;
  }
}

}  // namespace

extern "C" {

// Draw n segments of thickness >= 2 with round caps into an (h, w, 3) u8
// image, in place; segs is (n, 4) int32 [x1, y1, x2, y2].  The pixels of a
// loop of cv2.line(img, p1, p2, bgr, thickness) (LINE_8).
void ofv_draw_thick_segments(uint8_t* img, int64_t h, int64_t w,
                             const int32_t* segs, int64_t n, uint8_t b,
                             uint8_t g, uint8_t r, int thickness) {
  const Canvas cv{img, h, w, {b, g, r}};
  for (int64_t s = 0; s < n; ++s) {
    // cv2.line first clips the segment to the image grown by the
    // thickness on every side
    const int64_t t = thickness;
    int64_t x1 = segs[4 * s] + t, y1 = segs[4 * s + 1] + t;
    int64_t x2 = segs[4 * s + 2] + t, y2 = segs[4 * s + 3] + t;
    if (!ClipSegment(w + 2 * t, h + 2 * t, x1, y1, x2, y2)) continue;
    ThickLine(cv, (x1 - t) << kXYShift, (y1 - t) << kXYShift,
              (x2 - t) << kXYShift, (y2 - t) << kXYShift, thickness, 3);
  }
}

// cv2.circle(img, (cx, cy), radius, bgr, thickness) with LINE_8: thickness
// 1 and filled (< 0) by Bresenham, thicker through the polygon of EllipseEx.
void ofv_draw_circle(uint8_t* img, int64_t h, int64_t w, int64_t cx,
                     int64_t cy, int64_t radius, uint8_t b, uint8_t g,
                     uint8_t r, int thickness) {
  const Canvas cv{img, h, w, {b, g, r}};
  if (thickness > 1) {
    CircleEx(cv, cx, cy, radius, thickness);
  } else {
    Circle(cv, cx, cy, radius, thickness < 0);
  }
}

}  // extern "C"

extern "C" {

// cv2.warpPerspective(src, M, (w, h)) with INTER_LINEAR and a zero border,
// given minv = M^-1 (3x3 double, as cv::invert gives it), bit-exact to
// OpenCV 5: the inverse rounded to float; per output pixel the source
// point X/W, Y/W with X = fma(x, m0, y*m1 + m2) in the first
// simd_cols * (w / simd_cols) columns (OpenCV's vector loop) and
// fma(x, m0, y*m1) + m2 past them (its scalar loop); the four taps, 0
// outside the image, blended by fmaf along x then y, rounded half to even.
void ofv_warp_perspective_linear(const uint8_t* src, int64_t h, int64_t w,
                                 int64_t c, const double* minv,
                                 int64_t simd_cols, uint8_t* dst) {
  float m[9];
  for (int i = 0; i < 9; ++i) m[i] = static_cast<float>(minv[i]);
  const int64_t vec_end = simd_cols > 0 ? w / simd_cols * simd_cols : w;
  for (int64_t y = 0; y < h; ++y) {
    const float yf = static_cast<float>(y);
    const float ry[3] = {yf * m[1] + m[2], yf * m[4] + m[5], yf * m[7] + m[8]};
    const float ty[3] = {yf * m[1], yf * m[4], yf * m[7]};
    for (int64_t x = 0; x < w; ++x) {
      const float xf = static_cast<float>(x);
      float cx, cy, cw;
      if (x < vec_end) {
        cx = std::fmaf(xf, m[0], ry[0]);
        cy = std::fmaf(xf, m[3], ry[1]);
        cw = std::fmaf(xf, m[6], ry[2]);
      } else {
        cx = std::fmaf(xf, m[0], ty[0]) + m[2];
        cy = std::fmaf(xf, m[3], ty[1]) + m[5];
        cw = std::fmaf(xf, m[6], ty[2]) + m[8];
      }
      const float sx = cx / cw, sy = cy / cw;
      const float fx = std::floor(sx), fy = std::floor(sy);
      uint8_t* out = dst + (y * w + x) * c;
      // a point off every tap (or not finite) reads the zero border
      if (!(fx >= -1.0f && fx < static_cast<float>(w) &&
            fy >= -1.0f && fy < static_cast<float>(h))) {
        for (int64_t k = 0; k < c; ++k) out[k] = 0;
        continue;
      }
      const int64_t ix = static_cast<int64_t>(fx);
      const int64_t iy = static_cast<int64_t>(fy);
      const float a = sx - fx, b = sy - fy;
      const bool x0 = ix >= 0, x1 = ix + 1 < w, y0 = iy >= 0, y1 = iy + 1 < h;
      for (int64_t k = 0; k < c; ++k) {
        auto px = [&](bool ok, int64_t yy, int64_t xx) {
          return ok ? static_cast<float>(src[(yy * w + xx) * c + k]) : 0.0f;
        };
        const float p00 = px(y0 && x0, iy, ix);
        const float p01 = px(y0 && x1, iy, ix + 1);
        const float p10 = px(y1 && x0, iy + 1, ix);
        const float p11 = px(y1 && x1, iy + 1, ix + 1);
        const float top = std::fmaf(a, p01 - p00, p00);
        const float bot = std::fmaf(a, p11 - p10, p10);
        const float v = std::nearbyint(std::fmaf(b, bot - top, top));
        out[k] = static_cast<uint8_t>(v < 0.0f ? 0.0f : v > 255.0f ? 255.0f
                                                                   : v);
      }
    }
  }
}

}  // extern "C"
