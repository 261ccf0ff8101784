// PWC-Net correlation cost volume, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * opticalflow_tpu/ops/pallas_corr.py::_fwd_kernel          (resident f2)
//   * opticalflow_tpu/ops/pallas_corr.py::_fwd_kernel_windowed (f2 in HBM,
//     DMA halo window per row tile; exists only because a TPU core's VMEM
//     cannot hold f2 at >=1080p).
// Both compute, for the hot configuration (kernel_size=1, stride1=stride2=1,
// pad=max_displacement=MD):
//   out[b, tj*ND+ti, y, x] = (1/C) * sum_c f1[b,c,y,x] * f2[b,c,y+tj-MD,x+ti-MD]
// with ND = 2*MD+1, zero outside f2, float32 accumulation, stored in the
// input dtype (float32 or bfloat16).  Layout is NCHW (the port's layout):
// every displacement map is a contiguous plane of the output.
//
// Bound on this card: memory.  The function must read f1 and f2 once and
// write ND*ND maps once; at the 448x1024 B=1 float32 levels that is ~25 MB
// per forward (~7.6 us at the H100 SXM's 3.35 TB/s), against ~0.26 GFLOP
// of fp32 FMA (~4 us at 67 TFLOP/s outside the tensor cores).  The output
// (81 maps) is 80% of the bytes at level 2.
//
// Design (a first, simple kernel; making it fast is later work):
//   * one block per (batch item, TR output rows, TW output columns), one
//     thread per output pixel; each thread keeps its ND*ND float32 sums in
//     registers across the whole channel loop, so the output is written
//     exactly once, one coalesced 128-byte row segment per warp per map;
//   * channels are staged CC at a time in shared memory: f1's TR x TW tile
//     and f2's (TR+2MD) x (TW+2MD) halo window, zero-filled outside the
//     image (the kernel's zero padding, which matters at every edge of the
//     small levels: L6 is 7x16, smaller than the 9x9 window).  A 196-channel
//     window would not fit in shared memory whole, hence the chunks;
//   * f1 is read from device memory once; f2 once per block plus its halo
//     (1 + 2MD/TR rows and 2MD/TW columns: ~3.75x at TR=4, TW=32, mostly
//     served by L2).  There is no residency limit, so the same kernel
//     covers K2's >=1080p domain.
//   * the inner loop is one shared-memory load per FMA, bank-conflict
//     free (a warp reads 32 consecutive floats).
// Measured by chip_smoke.py on an H100 80GB HBM3 (700 W): 31 us at L2
// against a 5 us bound, and the small levels slower still (L6: 133 us at
// B=1 and at B=8).  There the grid has 2-4 blocks per image and each walks
// all C channels in sequence, so the per-block depth over C, not device
// memory, limits them.  Splitting C across warps or blocks, and register
// tiling over x, are the next steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TW = 32;  // output columns per block (one warp)
constexpr int TR = 4;   // output rows per block (one warp each)
constexpr int CC = 16;  // channels staged in shared memory per chunk

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int MD>
__global__ void __launch_bounds__(TW * TR)
corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                T* __restrict__ out, int C, int H, int W, float inv_c) {
  constexpr int ND = 2 * MD + 1;
  constexpr int WR = TR + 2 * MD;  // halo window rows
  constexpr int WC = TW + 2 * MD;  // halo window columns
  __shared__ float s1[CC][TR][TW];
  __shared__ float s2[CC][WR][WC];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TR, b = blockIdx.z;
  const long long plane = (long long)H * W;
  const T* f1b = f1 + (long long)b * C * plane;
  const T* f2b = f2 + (long long)b * C * plane;

  float acc[ND * ND];
#pragma unroll
  for (int d = 0; d < ND * ND; ++d) acc[d] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cn = min(CC, C - c0);
    for (int i = tid; i < cn * TR * TW; i += TW * TR) {
      const int c = i / (TR * TW), r = (i / TW) % TR, col = i % TW;
      const int y = y0 + r, x = x0 + col;
      s1[c][r][col] = (y < H && x < W)
          ? load_f(f1b + (c0 + c) * plane + (long long)y * W + x) : 0.f;
    }
    for (int i = tid; i < cn * WR * WC; i += TW * TR) {
      const int c = i / (WR * WC), r = (i / WC) % WR, col = i % WC;
      const int y = y0 - MD + r, x = x0 - MD + col;
      s2[c][r][col] = (y >= 0 && y < H && x >= 0 && x < W)
          ? load_f(f2b + (c0 + c) * plane + (long long)y * W + x) : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < cn; ++c) {
      const float a = s1[c][ty][tx];
#pragma unroll
      for (int tj = 0; tj < ND; ++tj) {
#pragma unroll
        for (int ti = 0; ti < ND; ++ti) {
          acc[tj * ND + ti] = fmaf(a, s2[c][ty + tj][tx + ti],
                                   acc[tj * ND + ti]);
        }
      }
    }
    __syncthreads();
  }

  const int y = y0 + ty, x = x0 + tx;
  if (y < H && x < W) {
    T* o = out + (long long)b * ND * ND * plane + (long long)y * W + x;
#pragma unroll
    for (int d = 0; d < ND * ND; ++d) store_f(o + d * plane, acc[d] * inv_c);
  }
}

template <typename T, int MD>
int launch(const void* f1, const void* f2, void* out, int B, int C, int H,
           int W, cudaStream_t stream) {
  const dim3 block(TW, TR);
  const dim3 grid((W + TW - 1) / TW, (H + TR - 1) / TR, B);
  corr_fwd_kernel<T, MD><<<grid, block, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<T*>(out), C, H, W, 1.0f / C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f1, f2: (B, C, H, W) contiguous; out: (B, (2md+1)^2, H, W) contiguous.
// md must be 4 (the model's max displacement; the one instantiation).
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an unsupported md, dtype or grid).
extern "C" int corr_fwd(const void* f1, const void* f2, void* out, int B,
                        int C, int H, int W, int md, int dtype,
                        void* stream) {
  if (md != 4 || B < 1 || C < 1 || H < 1 || W < 1 || B > 65535 ||
      (H + TR - 1) / TR > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, 4>(f1, f2, out, B, C, H, W, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16, 4>(f1, f2, out, B, C, H, W, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
