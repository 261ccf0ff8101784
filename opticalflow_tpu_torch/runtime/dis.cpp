// DIS optical flow (Kroeger et al., "Fast Optical Flow using Dense Inverse
// Search", ECCV 2016) as OpenCV 5.0 computes it for
// cv2.DISOpticalFlow_create(DISOPTICAL_FLOW_PRESET_MEDIUM).calc(g1, g2,
// None), rebuilt stage by stage against it, on the host:
//
//   1. the coarsest scale from the image size;
//   2. an INTER_AREA pyramid of the uint8 images;
//   3. 3x3 Sobel gradients of the first image (reflect-101 borders);
//   4. the inverse search of patches on a strided grid, mean-normalised,
//      with spatial propagation in scan order, forward then backward, in a
//      fixed eight stripes of patch rows (as OpenCV, so the result does
//      not depend on the thread count);
//   5. the densification, each patch weighted by 1/max(1, |photometric
//      error|);
//   6. the variational refinement: fixed-point iterations of a data term
//      (brightness and gradient constancy) and a smoothness term, each
//      solved by red-black SOR;
//   7. the flow resized bilinearly x2 between scales.
//
// The propagation is sequential (each patch compares its neighbours'
// newest flow), which is why this runs on the host: as batched tensor ops
// it would be another algorithm.  Plain C interface for ctypes; every
// entry point returns 0, or 1 with a message.

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

template <class T>
struct Img {
  int h = 0, w = 0;
  std::vector<T> d;
  Img() = default;
  Img(int h_, int w_, T v = T()) : h(h_), w(w_), d(size_t(h_) * w_, v) {}
  T* row(int y) { return d.data() + size_t(y) * w; }
  const T* row(int y) const { return d.data() + size_t(y) * w; }
  T& at(int y, int x) { return d[size_t(y) * w + x]; }
  const T& at(int y, int x) const { return d[size_t(y) * w + x]; }
};

using U8 = Img<uint8_t>;
using F32 = Img<float>;

// the preset (runtime/dis.py's MEDIUM), patch means always normalised
struct Params {
  int finest_scale, patch_size, patch_stride, grad_descent_iter, var_iter;
  int spatial_prop;
  float alpha, delta, gamma, epsilon;
};

const float kEps = 0.001f, kInf = 1e10f;
const int kBorder = 16;        // I1's replicated border (OpenCV's border_size)
const int kStripes = 8;        // the inverse search's fixed stripe count
const int kSorIter = 5;        // DIS's SOR iterations a fixed-point one
const float kOmega = 1.6f;     // the SOR relaxation

// f(0) ... f(n-1) over the host's cores; the calls must be independent
template <class F>
void parallel_for(int n, F&& f) {
  int nt = std::min(n, int(std::max(1u, std::thread::hardware_concurrency())));
  if (nt <= 1) {
    for (int i = 0; i < n; i++) f(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; t++)
    pool.emplace_back([&] {
      for (int i; (i = next++) < n;) f(i);
    });
  for (auto& t : pool) t.join();
}

int round_half_even(float v) { return int(std::nearbyint(v)); }

uint8_t sat_u8(float v) {
  int i = round_half_even(v);
  return uint8_t(std::min(std::max(i, 0), 255));
}

// ------------------------------------------------------------ INTER_AREA

struct Tap { int di, si; float alpha; };

// OpenCV's computeResizeAreaTab: the source cells each destination pixel
// covers, fractions at both ends, weights 1/cellWidth
std::vector<Tap> area_tab(int ssize, int dsize, double scale) {
  std::vector<Tap> tab;
  for (int dx = 0; dx < dsize; dx++) {
    double fsx1 = dx * scale, fsx2 = fsx1 + scale;
    double cell = std::min(scale, ssize - fsx1);
    int sx1 = int(std::ceil(fsx1)), sx2 = int(std::floor(fsx2));
    sx2 = std::min(sx2, ssize - 1);
    sx1 = std::min(sx1, sx2);
    if (sx1 - fsx1 > 1e-3)
      tab.push_back({dx, sx1 - 1, float((sx1 - fsx1) / cell)});
    for (int sx = sx1; sx < sx2; sx++)
      tab.push_back({dx, sx, float(1.0 / cell)});
    if (fsx2 - sx2 > 1e-3)
      tab.push_back({dx, sx2,
                     float(std::min(std::min(fsx2 - sx2, 1.), cell) / cell)});
  }
  return tab;
}

// cv2.resize(src, (dw, dh), interpolation=INTER_AREA) of uint8 when
// shrinking: an exact 2x2 decimation rounds (a+b+c+d+2)>>2; any other
// ratio sums float-weighted cells and rounds half to even
U8 resize_area(const U8& s, int dh, int dw) {
  if (s.h == dh && s.w == dw) return s;
  U8 d(dh, dw);
  double sx = double(s.w) / dw, sy = double(s.h) / dh;
  if (sx == 2.0 && sy == 2.0) {
    for (int y = 0; y < dh; y++) {
      const uint8_t *a = s.row(2 * y), *b = s.row(2 * y + 1);
      for (int x = 0; x < dw; x++)
        d.at(y, x) = uint8_t((a[2 * x] + a[2 * x + 1] + b[2 * x] +
                              b[2 * x + 1] + 2) >> 2);
    }
    return d;
  }
  std::vector<Tap> xt = area_tab(s.w, dw, sx), yt = area_tab(s.h, dh, sy);
  std::vector<float> buf(dw), sum(dw, 0.f);
  int prev_dy = yt.empty() ? 0 : yt[0].di;
  for (const Tap& t : yt) {
    const uint8_t* S = s.row(t.si);
    std::fill(buf.begin(), buf.end(), 0.f);
    for (const Tap& k : xt) buf[k.di] += S[k.si] * k.alpha;
    if (t.di != prev_dy) {
      for (int x = 0; x < dw; x++) {
        d.at(prev_dy, x) = sat_u8(sum[x]);
        sum[x] = t.alpha * buf[x];
      }
      prev_dy = t.di;
    } else {
      for (int x = 0; x < dw; x++) sum[x] += t.alpha * buf[x];
    }
  }
  for (int x = 0; x < dw; x++) d.at(prev_dy, x) = sat_u8(sum[x]);
  return d;
}

// ----------------------------------------------------------- INTER_LINEAR

// cv2.resize INTER_LINEAR of float32 as OpenCV 5 computes it on x86: one
// channel through IPP (double positions, a tap outside [0, n-1) takes the
// edge pixel whole, fma(p1 - p0, t, p0), rows then columns), two channels
// through OpenCV's own code (float32 positions, weights 1-t and t, rows
// clamped into the image).  The arithmetic of io/images.resize_bilinear_f32.
struct Lin { std::vector<int> i0; std::vector<float> t; };

Lin linear_taps(int n_src, int n_dst, bool ipp, bool edge_zero) {
  Lin l;
  for (int i = 0; i < n_dst; i++) {
    double pos;
    if (ipp)
      pos = (i + 0.5) * (double(n_src) / n_dst) - 0.5;
    else
      pos = double(float((i + 0.5) * (1.0 / (double(n_dst) / n_src)) - 0.5));
    double first = std::floor(pos);
    int f = int(first);
    float t = float(pos - first);
    if (edge_zero && (f < 0 || f >= n_src - 1)) t = 0.f;
    l.i0.push_back(f);
    l.t.push_back(t);
  }
  return l;
}

// (h, w, cn) float32 planes interleaved; cn is 1 (IPP rule) or 2 (own)
std::vector<float> resize_linear(const std::vector<float>& src, int h, int w,
                                 int cn, int dh, int dw) {
  bool ipp = cn != 2 && h > 1 && w > 1;
  std::vector<float> x = src;
  int cw = w;
  if (dw != w) {
    Lin l = linear_taps(w, dw, ipp, true);
    std::vector<float> o(size_t(h) * dw * cn);
    for (int y = 0; y < h; y++)
      for (int j = 0; j < dw; j++) {
        int a = std::min(std::max(l.i0[j], 0), w - 1);
        int b = std::min(a + 1, w - 1);
        float t = l.t[j];
        for (int c = 0; c < cn; c++) {
          float p0 = x[(size_t(y) * w + a) * cn + c];
          float p1 = x[(size_t(y) * w + b) * cn + c];
          o[(size_t(y) * dw + j) * cn + c] =
              ipp ? std::fma(p1 - p0, t, p0) : p0 * (1.f - t) + p1 * t;
        }
      }
    x.swap(o);
    cw = dw;
  }
  if (dh != h) {
    Lin l = linear_taps(h, dh, ipp, ipp);
    std::vector<float> o(size_t(dh) * cw * cn);
    for (int i = 0; i < dh; i++) {
      int a = std::min(std::max(l.i0[i], 0), h - 1);
      int b = std::min(std::max(l.i0[i] + 1, 0), h - 1);
      float t = l.t[i];
      for (int k = 0; k < cw * cn; k++) {
        float p0 = x[size_t(a) * cw * cn + k], p1 = x[size_t(b) * cw * cn + k];
        o[size_t(i) * cw * cn + k] =
            ipp ? std::fma(p1 - p0, t, p0) : p0 * (1.f - t) + p1 * t;
      }
    }
    x.swap(o);
  }
  return x;
}

F32 resize_plane(const F32& s, int dh, int dw) {
  F32 d(dh, dw);
  d.d = resize_linear(s.d, s.h, s.w, 1, dh, dw);
  return d;
}

// ------------------------------------------------------------- gradients

int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) i = i < 0 ? -i : 2 * (n - 1) - i;
  return i;
}

// cv2.spatialGradient: 3x3 Sobel, reflect-101 borders, int16
void spatial_gradient(const U8& I, Img<int16_t>& gx, Img<int16_t>& gy) {
  gx = Img<int16_t>(I.h, I.w);
  gy = Img<int16_t>(I.h, I.w);
  for (int y = 0; y < I.h; y++) {
    const uint8_t* r[3] = {I.row(reflect101(y - 1, I.h)), I.row(y),
                           I.row(reflect101(y + 1, I.h))};
    for (int x = 0; x < I.w; x++) {
      int l = reflect101(x - 1, I.w), rr = reflect101(x + 1, I.w);
      int dx = (r[0][rr] - r[0][l]) + 2 * (r[1][rr] - r[1][l]) +
               (r[2][rr] - r[2][l]);
      int dy = (r[2][l] + 2 * r[2][x] + r[2][rr]) -
               (r[0][l] + 2 * r[0][x] + r[0][rr]);
      gx.at(y, x) = int16_t(dx);
      gy.at(y, x) = int16_t(dy);
    }
  }
}

// ------------------------------------------------------------ the search

struct Tensor5 { F32 xx, yy, xy, x, y; };

// OpenCV's precomputeStructureTensor: patch sums of the gradient products
// on the patch grid, by running float sums (horizontal, then vertical)
Tensor5 structure_tensor(const Img<int16_t>& Ix, const Img<int16_t>& Iy,
                         int psz, int pstr, int hs, int ws) {
  int h = Ix.h, w = Ix.w;
  F32 axx(h, ws), ayy(h, ws), axy(h, ws), ax(h, ws), ay(h, ws);
  for (int i = 0; i < h; i++) {
    float sxx = 0, syy = 0, sxy = 0, sx = 0, sy = 0;
    const int16_t *xr = Ix.row(i), *yr = Iy.row(i);
    for (int j = 0; j < psz; j++) {
      sxx += xr[j] * xr[j];
      syy += yr[j] * yr[j];
      sxy += xr[j] * yr[j];
      sx += xr[j];
      sy += yr[j];
    }
    axx.at(i, 0) = sxx; ayy.at(i, 0) = syy; axy.at(i, 0) = sxy;
    ax.at(i, 0) = sx; ay.at(i, 0) = sy;
    int js = 1;
    for (int j = psz; j < w; j++) {
      int k = j - psz;
      sxx += (xr[j] * xr[j] - xr[k] * xr[k]);
      syy += (yr[j] * yr[j] - yr[k] * yr[k]);
      sxy += (xr[j] * yr[j] - xr[k] * yr[k]);
      sx += (xr[j] - xr[k]);
      sy += (yr[j] - yr[k]);
      if ((j - psz + 1) % pstr == 0 && js < ws) {
        axx.at(i, js) = sxx; ayy.at(i, js) = syy; axy.at(i, js) = sxy;
        ax.at(i, js) = sx; ay.at(i, js) = sy;
        js++;
      }
    }
  }
  Tensor5 t{F32(hs, ws), F32(hs, ws), F32(hs, ws), F32(hs, ws), F32(hs, ws)};
  std::vector<float> sxx(ws, 0.f), syy(ws, 0.f), sxy(ws, 0.f), sx(ws, 0.f),
      sy(ws, 0.f);
  for (int i = 0; i < psz; i++)
    for (int j = 0; j < ws; j++) {
      sxx[j] += axx.at(i, j); syy[j] += ayy.at(i, j); sxy[j] += axy.at(i, j);
      sx[j] += ax.at(i, j); sy[j] += ay.at(i, j);
    }
  for (int j = 0; j < ws; j++) {
    t.xx.at(0, j) = sxx[j]; t.yy.at(0, j) = syy[j]; t.xy.at(0, j) = sxy[j];
    t.x.at(0, j) = sx[j]; t.y.at(0, j) = sy[j];
  }
  int is = 1;
  for (int i = psz; i < h; i++) {
    int k = i - psz;
    for (int j = 0; j < ws; j++) {
      sxx[j] += (axx.at(i, j) - axx.at(k, j));
      syy[j] += (ayy.at(i, j) - ayy.at(k, j));
      sxy[j] += (axy.at(i, j) - axy.at(k, j));
      sx[j] += (ax.at(i, j) - ax.at(k, j));
      sy[j] += (ay.at(i, j) - ay.at(k, j));
    }
    if ((i - psz + 1) % pstr == 0 && is < hs) {
      for (int j = 0; j < ws; j++) {
        t.xx.at(is, j) = sxx[j]; t.yy.at(is, j) = syy[j];
        t.xy.at(is, j) = sxy[j]; t.x.at(is, j) = sx[j]; t.y.at(is, j) = sy[j];
      }
      is++;
    }
  }
  return t;
}

struct Level {
  const U8 *I0, *I1;        // the level's images
  U8 I1ext;                 // I1 with a replicated kBorder
  Img<int16_t> Ix, Iy;      // I0's Sobel gradients
};

struct Bilinear { float w00, w01, w10, w11; int i, j; };

// the patch origin in I1ext for flow (ux, uy), clamped as OpenCV clamps
Bilinear bilinear_at(int i, int j, float ux, float uy, const Level& L,
                     int psz) {
  float ilo = kBorder - psz + 1.0f, ihi = kBorder + L.I0->h - 1.0f;
  float jlo = kBorder - psz + 1.0f, jhi = kBorder + L.I0->w - 1.0f;
  float ii = std::min(std::max(i + uy + kBorder, ilo), ihi);
  float jj = std::min(std::max(j + ux + kBorder, jlo), jhi);
  float di = ii - std::floor(ii), dj = jj - std::floor(jj);
  return {(1 - di) * (1 - dj), (1 - di) * dj, di * (1 - dj), di * dj,
          int(ii), int(jj)};
}

// the warped difference I1(x + u) - I0(x) of one patch pixel
inline float patch_diff(const Level& L, const Bilinear& b, int i, int j,
                        int r, int c) {
  const uint8_t* p = L.I1ext.row(b.i + r) + b.j + c;
  const uint8_t* q = L.I1ext.row(b.i + r + 1) + b.j + c;
  return b.w00 * p[0] + b.w01 * p[1] + b.w10 * q[0] + b.w11 * q[1] -
         L.I0->at(i + r, j + c);
}

float patch_ssd(const Level& L, int i, int j, float ux, float uy,
                const Params& P) {
  Bilinear b = bilinear_at(i, j, ux, uy, L, P.patch_size);
  float sum = 0.f, sq = 0.f;
  for (int r = 0; r < P.patch_size; r++)
    for (int c = 0; c < P.patch_size; c++) {
      float d = patch_diff(L, b, i, j, r, c);
      sum += d;
      sq += d * d;
    }
  float n = float(P.patch_size) * P.patch_size;
  return sq - sum * sum / n;
}

// one Gauss-Newton step's gradient (dux, duy) and the patch's SSD
float patch_step(const Level& L, int i, int j, float ux, float uy,
                 float gx_sum, float gy_sum, const Params& P, float& dux,
                 float& duy) {
  Bilinear b = bilinear_at(i, j, ux, uy, L, P.patch_size);
  float sum = 0.f, sq = 0.f, sx = 0.f, sy = 0.f;
  for (int r = 0; r < P.patch_size; r++)
    for (int c = 0; c < P.patch_size; c++) {
      float d = patch_diff(L, b, i, j, r, c);
      sum += d;
      sq += d * d;
      sx += d * L.Ix.at(i + r, j + c);
      sy += d * L.Iy.at(i + r, j + c);
    }
  float n = float(P.patch_size) * P.patch_size;
  dux = sx - sum * gx_sum / n;
  duy = sy - sum * gy_sum / n;
  return sq - sum * sum / n;
}

// OpenCV's PatchInverseSearch_ParBody over one stripe of patch rows
void inverse_search_stripe(const Level& L, const Tensor5& T, const F32& Ux,
                           const F32& Uy, F32& Sx, F32& Sy, int hs, int ws,
                           int stripe, int stripe_sz, int num_iter,
                           const Params& P) {
  int psz = P.patch_size, psz2 = psz / 2, pstr = P.patch_stride;
  int inner = int(std::floor(P.grad_descent_iter / float(num_iter)));
  for (int iter = 0; iter < num_iter; iter++) {
    int dir, start_is, end_is, start_js, end_js;
    if (iter % 2 == 0) {
      dir = 1;
      start_is = std::min(stripe * stripe_sz, hs);
      end_is = std::min((stripe + 1) * stripe_sz, hs);
      start_js = 0;
      end_js = ws;
    } else {
      dir = -1;
      start_is = std::min((stripe + 1) * stripe_sz, hs) - 1;
      end_is = std::min(stripe * stripe_sz, hs) - 1;
      start_js = ws - 1;
      end_js = -1;
    }
    for (int is = start_is; dir * is < dir * end_is; is += dir) {
      int i = is * pstr;
      for (int js = start_js; dir * js < dir * end_js; js += dir) {
        int j = js * pstr;
        float& sx = Sx.at(is, js);
        float& sy = Sy.at(is, js);
        if (iter == 0) {
          sx = Ux.at(i + psz2, j + psz2);
          sy = Uy.at(i + psz2, j + psz2);
        }
        if (P.spatial_prop) {
          float best = patch_ssd(L, i, j, sx, sy, P);
          if (dir * js > dir * start_js) {
            float cx = Sx.at(is, js - dir), cy = Sy.at(is, js - dir);
            float c = patch_ssd(L, i, j, cx, cy, P);
            if (c < best) { best = c; sx = cx; sy = cy; }
          }
          if (dir * is > dir * start_is) {
            float cx = Sx.at(is - dir, js), cy = Sy.at(is - dir, js);
            float c = patch_ssd(L, i, j, cx, cy, P);
            if (c < best) { best = c; sx = cx; sy = cy; }
          }
        }
        float ux = sx, uy = sy;
        float xx = T.xx.at(is, js), yy = T.yy.at(is, js), xy = T.xy.at(is, js);
        float det = xx * yy - xy * xy;
        if (std::fabs(det) < kEps) det = kEps;
        float h11 = yy / det, h12 = -xy / det, h22 = xx / det;
        float prev = kInf;
        for (int t = 0; t < inner; t++) {
          float dux, duy;
          float ssd = patch_step(L, i, j, ux, uy, T.x.at(is, js),
                                 T.y.at(is, js), P, dux, duy);
          ux -= h11 * dux + h12 * duy;
          uy -= h12 * dux + h22 * duy;
          if (ssd >= prev) break;
          prev = ssd;
        }
        float ex = ux - sx, ey = uy - sy;
        if (std::sqrt(ex * ex + ey * ey) <= psz) { sx = ux; sy = uy; }
      }
    }
  }
}

// OpenCV's Densification_ParBody: every pixel's flow is the mean of the
// patches over it, weighted by 1/max(1, |I1(x + u) - I0(x)|)
void densify(const U8& I0, const U8& I1, const F32& Sx, const F32& Sy,
             int hs, int ws, const Params& P, F32& Ux, F32& Uy) {
  int h = I0.h, w = I0.w, psz = P.patch_size, pstr = P.patch_stride;
  // the patch rows (columns) over each pixel row (column), as OpenCV
  // steps them
  auto ranges = [&](int n, std::vector<int>& lo, std::vector<int>& hi) {
    int s = 0, e = -1;
    for (int i = 0; i < n; i++) {
      if (i % pstr == 0 && i + psz <= n) e++;
      if (i - psz >= 0 && (i - psz) % pstr == 0 && s < e) s++;
      lo.push_back(s);
      hi.push_back(e);
    }
  };
  std::vector<int> is_lo, is_hi, js_lo, js_hi;
  ranges(h, is_lo, is_hi);
  ranges(w, js_lo, js_hi);
  parallel_for(h, [&](int i) {
    for (int j = 0; j < w; j++) {
      float sum_c = 0.f, sum_x = 0.f, sum_y = 0.f;
      for (int is = is_lo[i]; is <= is_hi[i] && is < hs; is++)
        for (int js = js_lo[j]; js <= js_hi[j] && js < ws; js++) {
          float fx = Sx.at(is, js), fy = Sy.at(is, js);
          float jm = std::min(std::max(j + fx, 0.0f), w - 1.0f - kEps);
          float im = std::min(std::max(i + fy, 0.0f), h - 1.0f - kEps);
          int jl = int(jm), ju = jl + 1, il = int(im), iu = il + 1;
          float diff = (jm - jl) * (im - il) * I1.at(iu, ju) +
                       (ju - jm) * (im - il) * I1.at(iu, jl) +
                       (jm - jl) * (iu - im) * I1.at(il, ju) +
                       (ju - jm) * (iu - im) * I1.at(il, jl) - I0.at(i, j);
          float coef = 1 / std::max(1.0f, std::fabs(diff));
          sum_x += coef * fx;
          sum_y += coef * fy;
          sum_c += coef;
        }
      Ux.at(i, j) = sum_x / sum_c;
      Uy.at(i, j) = sum_y / sum_c;
    }
  });
}

// ------------------------------------------------- variational refinement

// a plane with a one-pixel frame, the frame replicating the edge or zero
struct Padded {
  int h, w;
  std::vector<float> d;
  Padded(int h_, int w_) : h(h_), w(w_), d(size_t(h_ + 2) * (w_ + 2), 0.f) {}
  float& at(int y, int x) { return d[size_t(y + 1) * (w + 2) + x + 1]; }
  float at(int y, int x) const { return d[size_t(y + 1) * (w + 2) + x + 1]; }
  void replicate_frame() {
    for (int y = 0; y < h; y++) {
      at(y, -1) = at(y, 0);
      at(y, w) = at(y, w - 1);
    }
    for (int x = -1; x <= w; x++) {
      at(-1, x) = at(0, x);
      at(h, x) = at(h - 1, x);
    }
  }
};

// Sobel with ksize 1 ([-1 0 1], no smoothing), replicated borders
F32 deriv(const F32& s, bool along_x) {
  F32 d(s.h, s.w);
  for (int y = 0; y < s.h; y++)
    for (int x = 0; x < s.w; x++) {
      if (along_x)
        d.at(y, x) = s.at(y, std::min(x + 1, s.w - 1)) -
                     s.at(y, std::max(x - 1, 0));
      else
        d.at(y, x) = s.at(std::min(y + 1, s.h - 1), x) -
                     s.at(std::max(y - 1, 0), x);
    }
  return d;
}

// I1 (as float) sampled bilinearly at x + (u, v), replicated borders
F32 warp(const U8& I1, const F32& U, const F32& V) {
  F32 d(I1.h, I1.w);
  for (int y = 0; y < I1.h; y++)
    for (int x = 0; x < I1.w; x++) {
      float mx = x + U.at(y, x), my = y + V.at(y, x);
      float fx0 = std::floor(mx), fy0 = std::floor(my);
      float tx = mx - fx0, ty = my - fy0;
      int x0 = int(fx0), y0 = int(fy0);
      auto px = [&](int yy, int xx) {
        return float(I1.at(std::min(std::max(yy, 0), I1.h - 1),
                           std::min(std::max(xx, 0), I1.w - 1)));
      };
      float a = px(y0, x0), b = px(y0, x0 + 1);
      float c = px(y0 + 1, x0), e = px(y0 + 1, x0 + 1);
      float top = a + (b - a) * tx, bot = c + (e - c) * tx;
      d.at(y, x) = top + (bot - top) * ty;
    }
  return d;
}

// OpenCV's VariationalRefinement::calcUV on (U, V) in place
void variational_refinement(const U8& I0, const U8& I1, F32& U, F32& V,
                            const Params& P, int sor_iter) {
  int h = I0.h, w = I0.w;
  const float zeta2 = 0.1f * 0.1f, eps2 = P.epsilon * P.epsilon;
  const float delta2 = P.delta / 2, gamma2 = P.gamma / 2,
              alpha2 = P.alpha / 2;
  F32 warped = warp(I1, U, V), avg(h, w), Iz(h, w);
  for (size_t k = 0; k < avg.d.size(); k++) {
    avg.d[k] = 0.5f * I0.d[k] + 0.5f * warped.d[k];
    Iz.d[k] = warped.d[k] - I0.d[k];
  }
  F32 Ix = deriv(avg, true), Iy = deriv(avg, false);
  F32 Ixz = deriv(Iz, true), Iyz = deriv(Iz, false);
  F32 Ixx = deriv(Ix, true), Ixy = deriv(Ix, false), Iyy = deriv(Iy, false);

  Padded W_u(h, w), W_v(h, w), cur_u(h, w), cur_v(h, w), dU(h, w), dV(h, w),
      weight(h, w);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      W_u.at(y, x) = cur_u.at(y, x) = U.at(y, x);
      W_v.at(y, x) = cur_v.at(y, x) = V.at(y, x);
    }
  W_u.replicate_frame(); W_v.replicate_frame();
  cur_u.replicate_frame(); cur_v.replicate_frame();
  Padded A11(h, w), A12(h, w), A22(h, w), b1(h, w), b2(h, w);

  for (int it = 0; it < P.var_iter; it++) {
    // the data term, linearised about W, at the current increment
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        float ix = Ix.at(y, x), iy = Iy.at(y, x), iz = Iz.at(y, x);
        float ixx = Ixx.at(y, x), ixy = Ixy.at(y, x), iyy = Iyy.at(y, x);
        float ixz = Ixz.at(y, x), iyz = Iyz.at(y, x);
        float du = dU.at(y, x), dv = dV.at(y, x);
        float n1 = ix * ix + iy * iy + zeta2;
        float ik1z = iz + ix * du + iy * dv;
        float wt = (delta2 / std::sqrt(ik1z * ik1z / n1 + eps2)) / n1;
        float a11 = wt * (ix * ix) + zeta2;
        float a12 = wt * (ix * iy);
        float a22 = wt * (iy * iy) + zeta2;
        float c1 = -wt * (iz * ix);
        float c2 = -wt * (iz * iy);
        float nx = ixx * ixx + ixy * ixy + zeta2;
        float ny = iyy * iyy + ixy * ixy + zeta2;
        float zx = ixz + ixx * du + ixy * dv;
        float zy = iyz + ixy * du + iyy * dv;
        wt = gamma2 / std::sqrt(zx * zx / nx + zy * zy / ny + eps2);
        a11 += wt * (ixx * ixx / nx + ixy * ixy / ny);
        a12 += wt * (ixx * ixy / nx + ixy * iyy / ny);
        a22 += wt * (ixy * ixy / nx + iyy * iyy / ny);
        c1 += -wt * (ixx * ixz / nx + ixy * iyz / ny);
        c2 += -wt * (ixy * ixz / nx + iyy * iyz / ny);
        A11.at(y, x) = a11; A12.at(y, x) = a12; A22.at(y, x) = a22;
        b1.at(y, x) = c1; b2.at(y, x) = c2;
      }
    // the smoothness term: each pixel's weight from the current flow's
    // differences to its right and lower neighbours, then the pair terms
    // with the right neighbour (red pixels, then black), then with the
    // lower one
    for (int colour = 0; colour < 2; colour++)
      for (int y = 0; y < h; y++)
        for (int x = (y + colour) % 2; x < w; x += 2) {
          float ux = cur_u.at(y, x + 1) - cur_u.at(y, x);
          float vx = cur_v.at(y, x + 1) - cur_v.at(y, x);
          float uy = cur_u.at(y + 1, x) - cur_u.at(y, x);
          float vy = cur_v.at(y + 1, x) - cur_v.at(y, x);
          float wt = alpha2 / std::sqrt(ux * ux + vx * vx + uy * uy + vy * vy +
                                        eps2);
          weight.at(y, x) = wt;
          if (x == w - 1) continue;
          float du = W_u.at(y, x + 1) - W_u.at(y, x);
          float dv = W_v.at(y, x + 1) - W_v.at(y, x);
          A11.at(y, x) += wt; A22.at(y, x) += wt;
          b1.at(y, x) += wt * du; b2.at(y, x) += wt * dv;
          A11.at(y, x + 1) += wt; A22.at(y, x + 1) += wt;
          b1.at(y, x + 1) += -wt * du; b2.at(y, x + 1) += -wt * dv;
        }
    for (int colour = 0; colour < 2; colour++)
      for (int y = 0; y < h - 1; y++)
        for (int x = (y + colour) % 2; x < w; x += 2) {
          float wt = weight.at(y, x);
          float du = W_u.at(y + 1, x) - W_u.at(y, x);
          float dv = W_v.at(y + 1, x) - W_v.at(y, x);
          A11.at(y, x) += wt; A22.at(y, x) += wt;
          b1.at(y, x) += wt * du; b2.at(y, x) += wt * dv;
          A11.at(y + 1, x) += wt; A22.at(y + 1, x) += wt;
          b1.at(y + 1, x) += -wt * du; b2.at(y + 1, x) += -wt * dv;
        }
    // red-black SOR: a pixel of one colour reads only the other colour,
    // so the rows of one colour's pass run on the host's cores
    for (int s = 0; s < sor_iter; s++)
      for (int colour = 0; colour < 2; colour++)
        parallel_for(h, [&](int y) {
          for (int x = (y + colour) % 2; x < w; x += 2) {
            float wl = weight.at(y, x - 1), wr = weight.at(y, x);
            float wu = weight.at(y - 1, x), wd = weight.at(y, x);
            float su = wl * dU.at(y, x - 1) + wr * dU.at(y, x + 1) +
                       wu * dU.at(y - 1, x) + wd * dU.at(y + 1, x);
            float sv = wl * dV.at(y, x - 1) + wr * dV.at(y, x + 1) +
                       wu * dV.at(y - 1, x) + wd * dV.at(y + 1, x);
            float& du = dU.at(y, x);
            float& dv = dV.at(y, x);
            du += kOmega * ((su + b1.at(y, x) - dv * A12.at(y, x)) /
                               A11.at(y, x) - du);
            dv += kOmega * ((sv + b2.at(y, x) - du * A12.at(y, x)) /
                               A22.at(y, x) - dv);
          }
        });
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        cur_u.at(y, x) = W_u.at(y, x) + dU.at(y, x);
        cur_v.at(y, x) = W_v.at(y, x) + dV.at(y, x);
      }
    cur_u.replicate_frame();
    cur_v.replicate_frame();
  }
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      U.at(y, x) = cur_u.at(y, x);
      V.at(y, x) = cur_v.at(y, x);
    }
}

// ------------------------------------------------------------- the flow

int coarsest_scale(int h, int w, Params& P) {
  const double psz = P.patch_size, ln2 = std::log(2.0);
  int c = std::min(int(std::log(std::max(w, h) / (4.0 * psz)) / ln2 + 0.5),
                   int(std::log(std::min(w, h) / psz) / ln2));
  if (c < 0) throw std::runtime_error(
      "DIS needs an image of at least the patch size on either side");
  if (c < P.finest_scale) {
    // OpenCV chooses the finest level from the coarsest, as OF_DIS's
    // run_dense does
    c = std::max(0, int(std::floor(std::log2(
        (2.0f * w) / (5.0f * P.patch_size)))));
    P.finest_scale = std::max(c - 2, 0);
  }
  return c;
}

void dis_flow(const U8& im0, const U8& im1, const Params& P0, float* out) {
  Params P = P0;
  int h = im0.h, w = im0.w;
  int cs = coarsest_scale(h, w, P);
  int fs = P.finest_scale;
  std::vector<U8> I0s(cs + 1), I1s(cs + 1);
  for (int i = fs; i <= cs; i++) {
    if (i == fs) {
      I0s[i] = resize_area(im0, h >> fs, w >> fs);
      I1s[i] = resize_area(im1, h >> fs, w >> fs);
    } else {
      I0s[i] = resize_area(I0s[i - 1], I0s[i - 1].h / 2, I0s[i - 1].w / 2);
      I1s[i] = resize_area(I1s[i - 1], I1s[i - 1].h / 2, I1s[i - 1].w / 2);
    }
  }
  F32 Ux(I0s[cs].h, I0s[cs].w), Uy(I0s[cs].h, I0s[cs].w);
  for (int s = cs; s >= fs; s--) {
    const U8 &I0 = I0s[s], &I1 = I1s[s];
    if (I0.h < P.patch_size || I0.w < P.patch_size)
      // OpenCV reads out of bounds here (a 12x200 pair crashes cv2 5.0)
      throw std::runtime_error(
          "scale " + std::to_string(s) + " of the pyramid is " +
          std::to_string(I0.h) + "x" + std::to_string(I0.w) +
          ", smaller than the " + std::to_string(P.patch_size) +
          "-px patch");
    Level L{&I0, &I1, U8(I1.h + 2 * kBorder, I1.w + 2 * kBorder), {}, {}};
    for (int y = 0; y < L.I1ext.h; y++)
      for (int x = 0; x < L.I1ext.w; x++)
        L.I1ext.at(y, x) = I1.at(std::min(std::max(y - kBorder, 0), I1.h - 1),
                                 std::min(std::max(x - kBorder, 0), I1.w - 1));
    spatial_gradient(I0, L.Ix, L.Iy);
    int psz = P.patch_size, pstr = P.patch_stride;
    int ws = 1 + (I0.w - psz) / pstr, hs = 1 + (I0.h - psz) / pstr;
    Tensor5 T = structure_tensor(L.Ix, L.Iy, psz, pstr, hs, ws);
    F32 Sx(hs, ws), Sy(hs, ws);
    int stripes = P.spatial_prop ? kStripes : 1;
    int stripe_sz = int(std::ceil(hs / double(stripes)));
    // the stripes share no patch: they run on the host's cores
    parallel_for(stripes, [&](int k) {
      inverse_search_stripe(L, T, Ux, Uy, Sx, Sy, hs, ws, k, stripe_sz,
                            P.spatial_prop ? 2 : 1, P);
    });
    densify(I0, I1, Sx, Sy, hs, ws, P, Ux, Uy);
    if (P.var_iter > 0)
      variational_refinement(I0, I1, Ux, Uy, P, kSorIter);
    if (s > fs) {
      const U8& nxt = I0s[s - 1];
      Ux = resize_plane(Ux, nxt.h, nxt.w);
      Uy = resize_plane(Uy, nxt.h, nxt.w);
      for (float& v : Ux.d) v *= 2;
      for (float& v : Uy.d) v *= 2;
    }
  }
  std::vector<float> uv(size_t(Ux.h) * Ux.w * 2);
  for (size_t k = 0; k < Ux.d.size(); k++) {
    uv[2 * k] = Ux.d[k];
    uv[2 * k + 1] = Uy.d[k];
  }
  std::vector<float> full = resize_linear(uv, Ux.h, Ux.w, 2, h, w);
  float f = float(1 << fs);
  for (size_t k = 0; k < full.size(); k++) out[k] = full[k] * f;
}

Params params_from(const int* ip, const float* fp) {
  return Params{ip[0], ip[1], ip[2], ip[3], ip[4], ip[5],
                fp[0], fp[1], fp[2], fp[3]};
}

void set_msg(char* msg, int64_t cap, const char* text) {
  if (cap > 0) std::snprintf(msg, size_t(cap), "%s", text);
}

U8 wrap(const uint8_t* p, int h, int w) {
  U8 m(h, w);
  std::memcpy(m.d.data(), p, size_t(h) * w);
  return m;
}

}  // namespace

extern "C" {

// the flow from grey uint8 i0 to i1 (h x w) into out (h x w x 2 float32);
// ip = {finest_scale, patch_size, patch_stride, gradient-descent
// iterations, variational iterations, spatial propagation}, fp = {alpha,
// delta, gamma, epsilon}
int odis_flow(const uint8_t* i0, const uint8_t* i1, int h, int w,
              const int* ip, const float* fp, float* out, char* msg,
              int64_t cap) {
  try {
    dis_flow(wrap(i0, h, w), wrap(i1, h, w), params_from(ip, fp), out);
    return 0;
  } catch (const std::exception& e) {
    set_msg(msg, cap, e.what());
    return 1;
  }
}

// cv2.VariationalRefinement's calcUV on u, v (h x w float32) in place;
// ip and fp as odis_flow's (ip[4] the fixed-point iterations)
int odis_variational_refinement(const uint8_t* i0, const uint8_t* i1, int h,
                                int w, const int* ip, const float* fp,
                                int sor_iter, float* u, float* v) {
  Params P = params_from(ip, fp);
  F32 U(h, w), V(h, w);
  std::memcpy(U.d.data(), u, sizeof(float) * h * w);
  std::memcpy(V.d.data(), v, sizeof(float) * h * w);
  variational_refinement(wrap(i0, h, w), wrap(i1, h, w), U, V, P, sor_iter);
  std::memcpy(u, U.d.data(), sizeof(float) * h * w);
  std::memcpy(v, V.d.data(), sizeof(float) * h * w);
  return 0;
}

// cv2.resize(src, (dw, dh), interpolation=cv2.INTER_AREA) of uint8, shrinking
int odis_resize_area(const uint8_t* src, int h, int w, uint8_t* dst, int dh,
                     int dw) {
  U8 d = resize_area(wrap(src, h, w), dh, dw);
  std::memcpy(dst, d.d.data(), size_t(dh) * dw);
  return 0;
}

}  // extern "C"
