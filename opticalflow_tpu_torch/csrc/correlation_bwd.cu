// PWC-Net correlation cost volume, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's backward of the correlation forward
// (opticalflow_tpu/ops/pallas_corr.py::_corr_bwd_lax, the custom_vjp's
// backward; lax, not Pallas, and it re-reads f1, f2 and g once per
// displacement, 81 times).  For the hot configuration (kernel_size=1,
// stride1=stride2=1, pad=max_displacement=MD=4), NCHW, D = 81 maps of the
// forward's order k = (tj+4)*9 + (ti+4):
//   d1[b,c,y,x] = (1/C) sum_k g[b,k,y,x]       * f2[b,c,y+tj,x+ti]
//   d2[b,c,y,x] = (1/C) sum_k g[b,k,y-tj,x-ti] * f1[b,c,y-tj,x-ti]
// zero outside the image (f1, f2 and g alike), float32 accumulation in the
// order of k, each gradient stored in the inputs' dtype (float32 or
// bfloat16; g arrives in the volume's dtype, which is theirs).
//
// Bound on this card: memory at the training shapes.  The function must read
// f1, f2 and g once and write d1 and d2 once, s*B*H*W*(2C+81) bytes read and
// s*B*H*W*2C written, against 4*81*C*B*H*W float32 operations: at level 2
// of a 320x896 crop (B=4, C=32, float32) 59.9 MB, 17.9 us at 3.35 TB/s,
// against 11.1 us of FMAs at 67 TFLOP/s.
//
// Design (gather form: every output element is one thread's sum, so there
// are no atomics and two runs give the same bits):
//   * One launch, two roles: grid (tiles, channel splits, 2B), blockIdx.z =
//     2b + role.  Role 0 writes d1, role 1 writes d2.  Both are the same
//     shape of work: a thread owns one pixel p of an 8x32 tile and holds 81
//     weights w_k in registers (role 0: g[k,p]; role 1: g[k,p-o_k], zero
//     where p-o_k leaves the image), then for each channel of its split sums
//     w_k * X[c, p + o_k] (role 0, X = f2) or w_k * X[c, p - o_k] (role 1,
//     X = f1) over the 81 k.  So g is read from HBM once per tile and role,
//     not once per channel.
//   * X comes through shared memory: per channel a 16x40 halo window of the
//     tile (zeros outside the image: that is the correlation's padding), in
//     float32 whatever the dtype, 4 channels a stage, two stages.  The next
//     stage's loads go into registers before this stage's FMAs and into
//     shared memory after them (one barrier a stage), so their latency is
//     hidden behind 324 FMAs a thread.  A warp is one tile row: each of its
//     81 window reads per channel is 32 consecutive words, free of bank
//     conflicts.
//   * Channels are split over blocks (no cluster: each block owns whole
//     output channels) until there are two blocks for every SM, each split
//     keeping at least 8 channels; every split re-reads g, so no further.
//   * What bounds this design: one shared-memory load per FMA (81 of each
//     per pixel, channel and role).  A thread that held several pixels
//     would reuse window values, but 81 registers of weights per pixel
//     leave no room for a second pixel.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py phase 7,
// float32, the card alone: 123.6, 66.5, 32.2, 17.5, 12.1 us at levels 2-6
// of a 320x896 crop at B=4 (251.9 us per training step against the 28.7 us
// bound), 116.5 us over the levels of 448x1024 at B=1; bfloat16 1.27x
// float32.  222 registers, so one block an SM: a block's weight loads are
// exposed, and the shared-memory loads run at about 40% of their peak.

#include "corr_tile.cuh"
#include "device_guard.cuh"

namespace {

constexpr int BTW = 32;                 // tile columns (a warp)
constexpr int BNT = TH * BTW;           // threads per block, one per pixel
constexpr int BHW = BTW + 2 * MD;       // halo window columns
constexpr int BWIN = HR * BHW;          // window elements per channel
constexpr int BCC = 4;                  // channels per stage
constexpr int BSTAGE = BCC * BWIN;      // elements per stage
constexpr int BPER = BSTAGE / BNT;      // elements a thread copies per stage
constexpr int BMIN_CHANNELS = 8;        // fewest channels a split keeps
constexpr int BMAX_SPLIT = 64;
static_assert(BSTAGE % BNT == 0, "a stage must divide among the threads");

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// The body of one role.  src is X of batch item b, dst the gradient of batch
// item b, gb the volume's gradient of batch item b.
template <typename T, bool ROLE2>
__device__ __forceinline__ void corr_bwd_role(
    const T* __restrict__ src, const T* __restrict__ gb, T* __restrict__ dst,
    float (*ring)[BSTAGE], int H, int W, int x0, int y0, int cbeg, int cend,
    float inv_c) {
  const int tx = threadIdx.x, ty = threadIdx.y, tid = tx + BTW * ty;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const long long plane = (long long)H * W;

  // this pixel's 81 weights
  float wk[ND2];
#pragma unroll
  for (int tj = 0; tj < ND; ++tj)
#pragma unroll
    for (int ti = 0; ti < ND; ++ti) {
      const int yy = ROLE2 ? y - (tj - MD) : y;
      const int xx = ROLE2 ? x - (ti - MD) : x;
      const bool ok = inside && yy >= 0 && yy < H && xx >= 0 && xx < W;
      wk[tj * ND + ti] =
          ok ? ld(gb + (tj * ND + ti) * plane + (long long)yy * W + xx) : 0.f;
    }

  // a stage of BCC channels' windows: global -> registers (zero outside the
  // image and past the split's last channel) -> shared memory
  float stg[BPER];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int i = 0; i < BPER; ++i) {
      const int e = tid + i * BNT;
      const int c = e / BWIN, r = (e % BWIN) / BHW, col = e % BHW;
      const int yy = y0 - MD + r, xx = x0 - MD + col;
      const bool ok =
          c0 + c < cend && yy >= 0 && yy < H && xx >= 0 && xx < W;
      stg[i] = ok ? ld(src + (long long)(c0 + c) * plane +
                       (long long)yy * W + xx)
                  : 0.f;
    }
  };
  auto put = [&](float* buf) {
#pragma unroll
    for (int i = 0; i < BPER; ++i) buf[tid + i * BNT] = stg[i];
  };

  const int nst = (cend - cbeg + BCC - 1) / BCC;
  fetch(cbeg);
  put(ring[0]);
  __syncthreads();
  for (int s = 0; s < nst; ++s) {
    const int c0 = cbeg + s * BCC;
    if (s + 1 < nst) fetch(c0 + BCC);   // in flight during the FMAs
    const float* buf = ring[s & 1];
#pragma unroll 1
    for (int c = 0; c < BCC && c0 + c < cend; ++c) {
      // window element (ty + MD + dy, tx + MD + dx) is X[y + dy, x + dx]
      const float* h = buf + c * BWIN + ty * BHW + tx;
      float acc = 0.f;
#pragma unroll
      for (int tj = 0; tj < ND; ++tj)
#pragma unroll
        for (int ti = 0; ti < ND; ++ti) {
          const int off = ROLE2 ? (2 * MD - tj) * BHW + (2 * MD - ti)
                                : tj * BHW + ti;
          acc = fmaf(wk[tj * ND + ti], h[off], acc);
        }
      if (inside) {
        store1(dst + (long long)(c0 + c) * plane + (long long)y * W + x,
               acc * inv_c);
      }
    }
    if (s + 1 < nst) put(ring[(s + 1) & 1]);
    __syncthreads();   // the next stage has landed; this one is consumed
  }
}

// grid (tiles, nsplit, 2B), block (32, 8).  Split r owns channels
// [r*cper, min(C, (r+1)*cper)).
template <typename T>
__global__ void __launch_bounds__(BNT)
corr_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                const T* __restrict__ g, T* __restrict__ d1,
                T* __restrict__ d2, int C, int H, int W, int tiles_x,
                int cper, float inv_c) {
  __shared__ __align__(16) float ring[2][BSTAGE];
  const int x0 = (blockIdx.x % tiles_x) * BTW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int b = blockIdx.z >> 1;
  const int cbeg = min(C, blockIdx.y * cper), cend = min(C, cbeg + cper);
  if (cbeg >= cend) return;   // past the last channel: forced splits only
  const long long plane = (long long)H * W;
  const long long fb = (long long)b * C * plane;
  const T* gb = g + (long long)b * ND2 * plane;
  if (blockIdx.z & 1) {
    corr_bwd_role<T, true>(f1 + fb, gb, d2 + fb, ring, H, W, x0, y0, cbeg,
                           cend, inv_c);
  } else {
    corr_bwd_role<T, false>(f2 + fb, gb, d1 + fb, ring, H, W, x0, y0, cbeg,
                            cend, inv_c);
  }
}

struct BwdPlan {
  int tiles;
  int tiles_x;
  int split;
  int cper;
};

// split: 0 lets the rule choose; else 1..64 channel splits (the card tests
// force them, to reach at small shapes what large ones choose).
bool make_bwd_plan(int B, int C, int H, int W, int split, int device,
                   BwdPlan* p) {
  if (split < 0 || split > BMAX_SPLIT || 2LL * B > 65535) return false;
  p->tiles_x = (W + BTW - 1) / BTW;
  p->tiles = ((H + TH - 1) / TH) * p->tiles_x;
  if (split == 0) {
    const long long blocks = 2LL * p->tiles * B;
    split = 1;
    while (split * 2 <= BMAX_SPLIT && C / (split * 2) >= BMIN_CHANNELS &&
           blocks * split < 2LL * sm_count(device)) {
      split *= 2;
    }
  }
  p->split = split;
  p->cper = (C + split - 1) / split;
  return true;
}

template <typename T>
int run(const void* f1, const void* f2, const void* g, void* d1, void* d2,
        int B, int C, int H, int W, int split, int device,
        cudaStream_t stream) {
  BwdPlan p;
  if (!make_bwd_plan(B, C, H, W, split, device, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(p.tiles, p.split, 2 * B);
  const dim3 block(BTW, TH);
  corr_bwd_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const T*>(g), static_cast<T*>(d1), static_cast<T*>(d2), C,
      H, W, p.tiles_x, p.cper, 1.0f / C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f1, f2: (B, C, H, W) contiguous; g: (B, 81, H, W) contiguous; d1, d2:
// (B, C, H, W) contiguous, all of one dtype (0 = float32, 1 = bfloat16) on
// `device`.  md must be 4.  split is 0 (the plan chooses) or 1..64 channel
// splits.  Launches on `stream` of `device` and returns the cudaError_t of
// the launch (cudaErrorInvalidValue for an unsupported md, dtype, split or
// size).
extern "C" int corr_bwd(const void* f1, const void* f2, const void* g,
                        void* d1, void* d2, int B, int C, int H, int W,
                        int md, int dtype, int split, int device,
                        void* stream) {
  if (!shape_ok(B, C, H, W, md) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? run<float>(f1, f2, g, d1, d2, B, C, H, W, split, device, s)
      : run<__nv_bfloat16>(f1, f2, g, d1, d2, B, C, H, W, split, device, s);
}

// The plan corr_bwd would follow, without launching: plan[0..5] = tile
// height, tile width, tiles per batch item, channel splits, channels per
// split, threads per block; plan[6] = static shared memory in bytes.
// Returns 0, or cudaErrorInvalidValue as corr_bwd would.
extern "C" int corr_bwd_plan(int B, int C, int H, int W, int md, int dtype,
                             int split, int device, int* plan) {
  BwdPlan p;
  if (!shape_ok(B, C, H, W, md) || (dtype != 0 && dtype != 1) ||
      !make_bwd_plan(B, C, H, W, split, device, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  plan[0] = TH; plan[1] = BTW; plan[2] = p.tiles; plan[3] = p.split;
  plan[4] = p.cper; plan[5] = BNT;
  plan[6] = static_cast<int>(2 * BSTAGE * sizeof(float));
  return 0;
}
