// Fused masked bilinear warp + PWC-Net correlation, forward, for NVIDIA
// Hopper (sm_90a):
//   out = corr(f1, warp_with_mask(f2, flow, thr))
// without the warped tensor ever going to device memory.
//
// Replaces the Pallas TPU kernel scripts/probe_fused_warpcorr.py::
// _fused_kernel (with its XLA-side precompute _prep_gather).  On the TPU the
// gather had to be a scalar loop of dynamic row slices, because Mosaic has
// no vectorised gather; here every thread gathers its own corners.
//
// Semantics (NCHW; the port's warp_with_mask and correlation_plain):
//   * sample point of warped pixel (y, x):
//       xs = (x + u)*(W/max(W-1,1)) - 0.5,  ys = (y + v)*(H/max(H-1,1)) - 0.5
//     (grid_sample with the reference's (dim-1) normalisation and
//     align_corners=False), corners (floor(ys)+{0,1}, floor(xs)+{0,1});
//   * four bilinear weights, each zeroed where its corner is outside the
//     image; if their sum is below thr (0.9999, or 0.999 for the old
//     variant) all four are zeroed (the validity mask folded in);
//   * warped = sum_k w_k * f2[corner_k] in float32;
//   * out[b, tj*9+ti, y, x] = (1/C) sum_c f1[b,c,y,x]*warped[b,c,y+tj-4,x+ti-4],
//     zero outside the image, float32 sums, stored in f1's dtype.
// The sample point, weights and mask are computed with explicitly rounded
// float32 operations (__fmul_rn & co., which the compiler never contracts
// into FMAs) in the plain version's order, so the mask decision is the same
// bit for bit as in the plain version on the same inputs.
//
// Bound on this card: memory.  The function must read f1, f2 and the flow
// once and write 81 maps once: at the 448x1024 level 2, B=8, float32 that
// is ~135 MB, ~40 us at 3.35 TB/s, against 2*81*C*H*W + 8*C*H*W flops
// (~24 us at 67 TFLOP/s).
//
// Design (a first, simple kernel; correlation_fwd.cu's structure):
//   * one block per (batch item, TR=4 output rows, TW=32 output columns),
//     one thread per output pixel, its 81 float32 sums in registers across
//     the channel loop; every map written once, coalesced;
//   * first, for each pixel of the (TR+8) x (TW+8) halo window, one thread
//     reads the flow, computes the four corner offsets (clamped into the
//     image, so nothing outside f2 is read) and the four folded weights,
//     and keeps them in shared memory for the whole channel loop;
//   * then, CC channels at a time, the halo loader no longer copies f2: it
//     computes each halo pixel's WARPED value from four reads of f2 and the
//     stored weights (halo pixels outside the image are 0, the
//     correlation's zero padding), beside f1's TR x TW tile;
//   * the inner loop is correlation_fwd.cu's: one shared-memory load per
//     FMA, bank-conflict free.
// Cost of the halo: each block warps (12*40)/(4*32) = 3.75 pixels per
// output pixel (4 corner reads per channel each), mostly served by L2; the
// composed path warps each pixel once but writes the warped tensor out and
// reads it back (plus its own 3.75x halo in the correlation).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int MD = 4;
constexpr int ND = 2 * MD + 1;
constexpr int TW = 32;            // output columns per block (one warp)
constexpr int TR = 4;             // output rows per block (one warp each)
constexpr int CC = 8;             // channels staged in shared memory per chunk
constexpr int WR = TR + 2 * MD;   // halo window rows
constexpr int WC = TW + 2 * MD;   // halo window columns
constexpr int NP = WR * WC;       // halo window pixels

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(TW * TR)
fused_warp_corr_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                       const float* __restrict__ flow, T* __restrict__ out,
                       int C, int H, int W, float scale_x, float scale_y,
                       float thr, float inv_c) {
  __shared__ float s1[CC][TR][TW];
  __shared__ float s2[CC][NP];
  __shared__ float4 s_w[NP];   // folded corner weights (00, 01, 10, 11)
  __shared__ int4 s_off[NP];   // corner offsets in a plane; x < 0: outside

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TR, b = blockIdx.z;
  const long long plane = (long long)H * W;
  const T* f1b = f1 + (long long)b * C * plane;
  const T* f2b = f2 + (long long)b * C * plane;
  const float* fu = flow + (long long)b * 2 * plane;
  const float* fv = fu + plane;

  for (int p = tid; p < NP; p += TW * TR) {
    const int y = y0 - MD + p / WC, x = x0 - MD + p % WC;
    float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
    int4 off = make_int4(-1, 0, 0, 0);
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const long long q = (long long)y * W + x;
      const float xs = __fsub_rn(
          __fmul_rn(__fadd_rn((float)x, __ldg(fu + q)), scale_x), 0.5f);
      const float ys = __fsub_rn(
          __fmul_rn(__fadd_rn((float)y, __ldg(fv + q)), scale_y), 0.5f);
      const float xf = floorf(xs), yf = floorf(ys);
      const float wx = __fsub_rn(xs, xf), wy = __fsub_rn(ys, yf);
      const float ax = __fsub_rn(1.f, wx), ay = __fsub_rn(1.f, wy);
      const int ix = (int)xf, iy = (int)yf;
      const bool vx0 = ix >= 0 && ix <= W - 1, vx1 = ix >= -1 && ix <= W - 2;
      const bool vy0 = iy >= 0 && iy <= H - 1, vy1 = iy >= -1 && iy <= H - 2;
      const float w00 = (vy0 && vx0) ? __fmul_rn(ay, ax) : 0.f;
      const float w01 = (vy0 && vx1) ? __fmul_rn(ay, wx) : 0.f;
      const float w10 = (vy1 && vx0) ? __fmul_rn(wy, ax) : 0.f;
      const float w11 = (vy1 && vx1) ? __fmul_rn(wy, wx) : 0.f;
      const float sum = __fadd_rn(__fadd_rn(__fadd_rn(w00, w01), w10), w11);
      if (sum >= thr) wv = make_float4(w00, w01, w10, w11);
      // corners clamped into the image: a corner outside has weight 0, and
      // its read stays inside f2
      const int cx0 = min(max(ix, 0), W - 1), cx1 = min(max(ix, -1), W - 2) + 1;
      const int cy0 = min(max(iy, 0), H - 1), cy1 = min(max(iy, -1), H - 2) + 1;
      off = make_int4(cy0 * W + cx0, cy0 * W + cx1, cy1 * W + cx0,
                      cy1 * W + cx1);
    }
    s_w[p] = wv;
    s_off[p] = off;
  }

  float acc[ND * ND];
#pragma unroll
  for (int d = 0; d < ND * ND; ++d) acc[d] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cn = min(CC, C - c0);
    // the first chunk's loads also wait for the weights written above
    __syncthreads();
    for (int i = tid; i < cn * TR * TW; i += TW * TR) {
      const int c = i / (TR * TW), r = (i / TW) % TR, col = i % TW;
      const int y = y0 + r, x = x0 + col;
      s1[c][r][col] = (y < H && x < W)
          ? load_f(f1b + (c0 + c) * plane + (long long)y * W + x) : 0.f;
    }
    for (int i = tid; i < cn * NP; i += TW * TR) {
      const int c = i / NP, p = i % NP;
      const int4 off = s_off[p];
      float val = 0.f;
      if (off.x >= 0) {
        const T* src = f2b + (c0 + c) * plane;
        const float4 wv = s_w[p];
        val = wv.x * load_f(src + off.x) + wv.y * load_f(src + off.y)
            + wv.z * load_f(src + off.z) + wv.w * load_f(src + off.w);
      }
      s2[c][p] = val;
    }
    __syncthreads();
    for (int c = 0; c < cn; ++c) {
      const float a = s1[c][ty][tx];
#pragma unroll
      for (int tj = 0; tj < ND; ++tj) {
#pragma unroll
        for (int ti = 0; ti < ND; ++ti) {
          acc[tj * ND + ti] = fmaf(a, s2[c][(ty + tj) * WC + tx + ti],
                                   acc[tj * ND + ti]);
        }
      }
    }
  }

  const int y = y0 + ty, x = x0 + tx;
  if (y < H && x < W) {
    T* o = out + (long long)b * ND * ND * plane + (long long)y * W + x;
#pragma unroll
    for (int d = 0; d < ND * ND; ++d) store_f(o + d * plane, acc[d] * inv_c);
  }
}

template <typename T>
int launch(const void* f1, const void* f2, const void* flow, void* out, int B,
           int C, int H, int W, float thr, cudaStream_t stream) {
  const dim3 block(TW, TR);
  const dim3 grid((W + TW - 1) / TW, (H + TR - 1) / TR, B);
  // the sample-point scale as the plain version rounds it: in double, then
  // to float32
  const float scale_x = (float)((double)W / (double)(W > 1 ? W - 1 : 1));
  const float scale_y = (float)((double)H / (double)(H > 1 ? H - 1 : 1));
  fused_warp_corr_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const float*>(flow), static_cast<T*>(out), C, H, W,
      scale_x, scale_y, thr, 1.0f / C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f1, f2: (B, C, H, W) contiguous, one dtype; flow: (B, 2, H, W) float32
// contiguous (u, v in pixels); out: (B, (2md+1)^2, H, W) contiguous in the
// features' dtype, all on `device`.  md must be 4 (the model's max
// displacement).  dtype: 0 = float32, 1 = bfloat16.  Launches on `stream` of
// `device` and returns the cudaError_t of the launch (cudaErrorInvalidValue
// for an unsupported md, dtype or grid).
extern "C" int fused_warp_corr(const void* f1, const void* f2,
                               const void* flow, void* out, int B, int C,
                               int H, int W, int md, int dtype, float thr,
                               int device, void* stream) {
  if (md != MD || B < 1 || C < 1 || H < 1 || W < 1 || B > 65535 ||
      (H + TR - 1) / TR > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(f1, f2, flow, out, B, C, H, W, thr, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(f1, f2, flow, out, B, C, H, W, thr, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
