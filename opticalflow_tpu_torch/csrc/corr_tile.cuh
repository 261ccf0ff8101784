// What the two correlation kernels share (correlation_fwd.cu and
// fused_warp_corr.cu; each is compiled into its own library).
//
// Both give a block an 8-row image tile of one batch item and a share of the
// channels, keep the 81 displacement sums of a thread's 4 adjacent pixels in
// registers, and feed them from shared memory: per channel an f1 tile and an
// f2 halo window of 16 rows.  Here are the constants, the element helpers,
// the asynchronous copy, one channel's FMAs for a thread (the register
// tile), the end of the kernel (the store, or the cluster's fixed-order
// reduction through distributed shared memory and then the store) and the
// host's rule for the tile and the channel split.  What differs stays in
// each .cu: how the shared-memory ring is laid out and filled.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int MD = 4;             // max displacement (the model's)
constexpr int ND = 2 * MD + 1;    // displacements per axis
constexpr int ND2 = ND * ND;      // output maps
constexpr int TH = 8;             // output rows per tile
constexpr int HR = TH + 2 * MD;   // halo rows per tile
constexpr int PX = 4;             // adjacent pixels per thread
constexpr int MAX_SPLIT = 8;      // portable cluster size
constexpr int MAX_DEVICES = 64;

// ---- element helpers -------------------------------------------------------

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned int*>(&lo);
  t.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void zero1(float* p) { *p = 0.f; }
__device__ __forceinline__ void zero1(__nv_bfloat16* p) {
  *p = __float2bfloat16(0.f);
}

// One asynchronous copy of BYTES (16 or 8) from global to shared memory; with
// fill == false the destination is zero-filled and src is not read.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = fill ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- the register tile -----------------------------------------------------

// One channel's FMAs for a thread: its 4 adjacent pixels (p1, in the f1
// tile) against DJ halo rows of 12 f2 values (p2, rows WS elements apart),
// 9 dx each: 1 + 3*DJ vector loads for 36*DJ FMAs.
template <int DJ, int WS, typename T1, typename T2>
__device__ __forceinline__ void fma_channel(const T1* p1, const T2* p2,
                                            float (&acc)[DJ][ND][PX]) {
  float a[PX];
  load4(p1, a);
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    float v[PX + ND - 1];
    load4(p2 + j * WS, v);
    load4(p2 + j * WS + 4, v + 4);
    load4(p2 + j * WS + 8, v + 8);
#pragma unroll
    for (int ti = 0; ti < ND; ++ti)
#pragma unroll
      for (int p = 0; p < PX; ++p)
        acc[j][ti][p] = fmaf(a[p], v[p + ti], acc[j][ti][p]);
  }
}

// ---- the end of the kernel -------------------------------------------------

// For a block (TW/4, TH, NG) of grid (tiles, nsplit, B) whose thread
// (tx, ty, g) holds the sums of pixels (y0 + ty, x0 + 4 tx ..+3) for dy rows
// DJ*g .. DJ*g + DJ - 1 over its block's channels.  With one split the sums
// are scaled and stored.  Otherwise the blocks of a cluster (1, nsplit, 1)
// reduce them: each block's partial sums go to `red` (the start of its
// shared memory, 81 * TH * TW floats, over whatever was there: the caller's
// ring must no longer be needed by this thread, and the barrier here waits
// for the others'); rank r then reads maps r, r + nsplit, ... from every
// rank through distributed shared memory and adds them in rank order, the
// fixed order that makes the bits repeat.  (Pushing the sums into the
// owner's memory instead was measured: no faster, and its separate inbox
// costs a block per SM.)
template <typename T, int TW, int NG>
__device__ __forceinline__ void store_or_reduce(
    float (&acc)[ND / NG][ND][PX], float* red, T* __restrict__ out, int H,
    int W, int x0, int y0, int nsplit, int vec, float inv_c) {
  constexpr int DJ = ND / NG, QX = TW / PX, NT = QX * TH * NG, F1 = TH * TW;
  const int tx = threadIdx.x, ty = threadIdx.y, g = threadIdx.z;
  const int tid = tx + QX * (ty + TH * g);
  const int rank = blockIdx.y, b = blockIdx.z;
  const long long plane = (long long)H * W;

  if (nsplit == 1) {
    const int y = y0 + ty, x = x0 + PX * tx;
    if (y < H && x < W) {
      T* o = out + ((long long)b * ND2 + DJ * g * ND) * plane +
             (long long)y * W + x;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
#pragma unroll
        for (int ti = 0; ti < ND; ++ti) {
          T* q = o + (long long)(j * ND + ti) * plane;
          const float* s = acc[j][ti];
          if (vec) {
            store4(q, s[0] * inv_c, s[1] * inv_c, s[2] * inv_c, s[3] * inv_c);
          } else {
#pragma unroll
            for (int p = 0; p < PX; ++p)
              if (x + p < W) store1(q + p, s[p] * inv_c);
          }
        }
    }
    return;
  }

  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();   // the ring is consumed
#pragma unroll
  for (int j = 0; j < DJ; ++j)
#pragma unroll
    for (int ti = 0; ti < ND; ++ti) {
      const float* s = acc[j][ti];
      *reinterpret_cast<float4*>(red + ((DJ * g + j) * ND + ti) * F1 +
                                 ty * TW + PX * tx) =
          make_float4(s[0], s[1], s[2], s[3]);
    }
  cluster.sync();
  constexpr int QT = TH * QX;   // pixel quads per map
  const int nd = (ND2 - rank + nsplit - 1) / nsplit;
  for (int it = tid; it < nd * QT; it += NT) {
    const int d = rank + (it / QT) * nsplit;
    const int qd = it % QT;
    const int at = d * F1 + PX * qd;
    // all the remote reads first, so that their latencies overlap
    float4 t[MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < nsplit) {
        t[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red, r) + at);
      }
    }
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < nsplit) {
        s.x += t[r].x; s.y += t[r].y; s.z += t[r].z; s.w += t[r].w;
      }
    }
    const int y = y0 + qd / QX, x = x0 + PX * (qd % QX);
    if (y < H && x < W) {
      T* o = out + ((long long)b * ND2 + d) * plane + (long long)y * W + x;
      if (vec) {
        store4(o, s.x * inv_c, s.y * inv_c, s.z * inv_c, s.w * inv_c);
      } else {
        const float sv[PX] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int p = 0; p < PX; ++p)
          if (x + p < W) store1(o + p, sv[p] * inv_c);
      }
    }
  }
  cluster.sync();   // no block leaves while another still reads its sums
}

// ---- the launch plan -------------------------------------------------------

struct Plan {
  int tile_w;   // 32 or 16
  int tiles;    // image tiles per batch item
  int tiles_x;
  int split;    // channel splits = cluster size
  int cper;     // channels per split
  int threads;
  int smem;     // dynamic shared memory per block, bytes
};

int sm_count(int device) {
  static int cached[MAX_DEVICES] = {0};
  if (device < 0 || device >= MAX_DEVICES) return 132;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n < 1) {
      n = 132;
    }
    cached[device] = n;
  }
  return cached[device];
}

int tiles_of(int H, int W, int tw) {
  return ((H + TH - 1) / TH) * ((W + tw - 1) / tw);
}

// The rule both kernels follow, each with its own constants.  tile, split: 0
// lets the rule choose; else the tile width (16 or 32) and the number of
// channel splits (1..8) to use (the card tests force them, to reach at small
// shapes the paths other shapes and cards choose).  The wide tile where it
// gives wide_num blocks to every wide_den SMs, else the narrow one; then the
// smallest power-of-two split that gives every SM a block, each split
// keeping at least min_channels channels.  Fills all of *p but threads and
// smem.
bool choose_tile_and_split(int B, int C, int H, int W, int tile, int split,
                           int device, int wide_num, int wide_den,
                           int min_channels, Plan* p) {
  if (!(tile == 0 || tile == 16 || tile == 32) || split < 0 ||
      split > MAX_SPLIT) {
    return false;
  }
  const int sms = sm_count(device);
  if (tile == 0) {
    tile = (long long)tiles_of(H, W, 32) * B * wide_den >=
                   (long long)wide_num * sms ? 32 : 16;
  }
  const int tiles = tiles_of(H, W, tile);
  if (split == 0) {
    const int most =
        C / min_channels < MAX_SPLIT ? C / min_channels : MAX_SPLIT;
    split = 1;
    while (split * 2 <= most && (long long)tiles * B * split < sms) split *= 2;
  }
  p->tile_w = tile;
  p->tiles = tiles;
  p->tiles_x = (W + tile - 1) / tile;
  p->split = split;
  p->cper = (C + split - 1) / split;
  return true;
}

bool shape_ok(int B, int C, int H, int W, int md) {
  return md == MD && B >= 1 && C >= 1 && H >= 1 && W >= 1 && B <= 65535 &&
         (long long)H * W < (1LL << 31);
}

void write_plan(const Plan& p, int* plan) {
  plan[0] = p.tile_w; plan[1] = p.tiles; plan[2] = p.split; plan[3] = p.cper;
  plan[4] = p.threads; plan[5] = p.smem;
}

}  // namespace
