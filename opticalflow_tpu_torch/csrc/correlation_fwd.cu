// PWC-Net correlation cost volume, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * opticalflow_tpu/ops/pallas_corr.py::_fwd_kernel          (resident f2)
//   * opticalflow_tpu/ops/pallas_corr.py::_fwd_kernel_windowed (f2 in HBM,
//     DMA halo window per row tile; exists only because a TPU core's VMEM
//     cannot hold f2 at >=1080p).
// Both compute, for the hot configuration (kernel_size=1, stride1=stride2=1,
// pad=max_displacement=MD=4):
//   out[b, tj*9+ti, y, x] = (1/C) * sum_c f1[b,c,y,x] * f2[b,c,y+tj-4,x+ti-4]
// zero outside f2, float32 accumulation, stored in the input dtype (float32
// or bfloat16).  Layout is NCHW (the port's layout): every displacement map
// is a contiguous plane of the output.
//
// Bound on this card: memory.  The function must read f1 and f2 once and
// write 81 maps once; at the 448x1024 B=1 float32 levels that is ~25 MB per
// forward (7.58 us at the H100 SXM's 3.35 TB/s), against 0.26 GFLOP of
// float32 FMA (~4 us at 67 TFLOP/s outside the tensor cores).  The output is
// 80% of the bytes at level 2.  Arithmetic is not the limit, so there is no
// wgmma.  What the first version of this kernel lost its time to was
// latency: 2-14 blocks at the small levels, each walking all C channels
// through a load, barrier, compute, barrier loop with nothing in flight, and
// one shared-memory load per FMA.
//
// Design:
//   * Grid = image tiles x channel splits x batch.  The C channels are split
//     over S blocks (S in 1..8), which form a thread block cluster.  Each
//     block sums its channels in order and then lays its partial sums over
//     the ring in its shared memory; rank r of the cluster reads maps r,
//     r+S, ... from every rank through distributed shared memory (all reads
//     started before the first is used), adds them in rank order and stores
//     them.  The order is fixed, so equal inputs give equal bits; there are
//     no atomics.  S is the smallest power of two that gives every SM a
//     block while each split keeps 16 channels: the reduction moves S times
//     the output's bytes across the cluster, which costs more than further
//     splits gain.
//   * Two tiles, chosen per launch.  The wide tile (8 rows x 32 columns,
//     192 threads) serves launches with three blocks or more for every two
//     SMs: a thread owns 4 adjacent pixels x 9 dx x 3 of the 9 dy rows (108
//     float32 sums) and reads, per channel, one 4-vector of f1 and three
//     rows of 12 f2 values: 10 vector loads for 108 FMAs, 0.37 words per
//     FMA.  The narrow tile (8 x 16, 288 threads) serves the rest, where
//     latency counts: a thread owns 4 pixels x 9 dx x 1 dy row (36 sums, 4
//     vector loads), so a tile has three times the threads on a third of the
//     registers, and 7x16 (level 6 of a 448x1024 frame) is one tile.
//     Row strides in shared memory are chosen so that every vector load of
//     a warp is free of bank conflicts.
//   * Channels go through a ring of shared-memory stages (4 stages of 4
//     channels wide, 2 of 8 narrow; 56 KB either way) filled by cp.async
//     (16 bytes for float32, 8 for bfloat16, which stays bfloat16 in shared
//     memory and is widened at use).  The halo origin x0-4 is a multiple of
//     4 pixels, so when W is one too and the base pointers are aligned,
//     every 4-pixel group is wholly inside or wholly outside the image;
//     outside groups use cp.async's zero-fill form with the address kept
//     inside the tensor.  That zero fill is the correlation's padding.  Each
//     thread serves the same one or two 4-pixel slots of every channel,
//     decoded once before the loop, so the loader divides nothing.  One
//     barrier per chunk.
//   * Otherwise (W not a multiple of 4, or a base pointer that is not
//     16-byte (8 for bfloat16) aligned) the same ring is filled by plain
//     element loads with per-element masks, and stores are scalar.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py phase 2,
// float32, the card alone (calls queued behind a spin kernel): 10.4, 10.2,
// 8.3, 7.3, 8.5 us at levels 2-6 of a 448x1024 frame at B=1 (44.7 us per
// forward against the 7.58 us bound; the first version took 372 us), 63.4 us
// at level 2 with B=8 (bound 39.7), 95.3 us per forward at 1088x1920 (bound
// 34.5).  What limits it now: at B=1 each level is a chain of launch, first
// copy, a few chunks, two cluster barriers and the reduction, about 6 us
// that do not shrink with the work; at B=8 and
// 1088x1920 the wide tile's shared-memory vector loads (30 per pixel quad
// and channel, ~30 us of wavefronts at level 2, B=8) and its FMAs (~20 us)
// overlap little at 12 warps per SM (167 registers a thread).

#include "corr_tile.cuh"
#include "device_guard.cuh"

namespace {

// The wide tile (32 columns) is for launches that fill the card several
// times over: a thread owns 3 dy rows (108 sums), which keeps shared-memory
// words per FMA low.  The narrow tile (16 columns) is for the rest, where
// latency counts: a thread owns 1 dy row (36 sums), so a tile has three times
// the threads and needs fewer registers.
template <typename T, int TW>
struct Tile {
  static constexpr int NG = TW == 32 ? 3 : 9;     // dy groups (threadIdx.z)
  static constexpr int DJ = ND / NG;              // dy rows per thread
  static constexpr int CC = TW == 32 ? 4 : 8;     // channels per stage
  static constexpr int STAGES = TW == 32 ? 4 : 2; // stages in the ring
  static constexpr int QX = TW / PX;              // pixel quads per tile row
  static constexpr int NT = QX * TH * NG;         // threads per block
  static constexpr int G2 = (TW + 2 * MD) / PX;   // 4-pixel groups per halo row
  // halo row stride in elements: rows read by one vector-load phase of a
  // warp must fall in distinct banks
  static constexpr int WS = sizeof(T) == 4 ? (TW == 32 ? 40 : 48)
                                           : (TW == 32 ? 96 : 80);
  static constexpr int F1 = TH * TW;              // f1 elements per channel
  static constexpr int SL = F1 + HR * WS;         // slab: f1 tile + f2 halo
  static constexpr int F1S = TH * QX;             // f1 slots per channel
  static constexpr int NS = F1S + HR * G2;        // slots per channel
  static constexpr int SPT = (NS + NT - 1) / NT;  // slots per thread
  static constexpr int RING_BYTES = STAGES * CC * SL * (int)sizeof(T);
  // a block's partial sums, which take the ring's place for the reduction
  static constexpr int RED_BYTES = ND2 * F1 * (int)sizeof(float);
  static constexpr int MAX_BYTES =
      RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
};

// ---- the kernel ------------------------------------------------------------

// grid (tiles, nsplit, B), cluster (1, nsplit, 1), block (TW/4, TH, NG).
// Dynamic shared memory: the ring; for the reduction, the partial sums.
// Rank r of a cluster sums channels [r*cper, min(C, (r+1)*cper)).
template <typename T, int TW>
__global__ void __launch_bounds__(Tile<T, TW>::NT)
corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                T* __restrict__ out, int C, int H, int W, int tiles_x,
                int nsplit, int cper, int vec, float inv_c) {
  using L = Tile<T, TW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int DJ = L::DJ, CC = L::CC, STAGES = L::STAGES;
  T* const ring = reinterpret_cast<T*>(smem_raw);
  float* const red = reinterpret_cast<float*>(smem_raw);

  const int tx = threadIdx.x, ty = threadIdx.y, g = threadIdx.z;
  const int tid = tx + L::QX * (ty + TH * g);
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int rank = blockIdx.y, b = blockIdx.z;
  const long long plane = (long long)H * W;
  const T* f1b = f1 + (long long)b * C * plane;
  const T* f2b = f2 + (long long)b * C * plane;
  const int cbeg = min(C, rank * cper), cend = min(C, cbeg + cper);
  const int nk = (cend - cbeg + CC - 1) / CC;

  // The loader's slots: this thread copies the same 4-pixel groups of every
  // channel.  Slot s < F1S is group s of the f1 tile, the others are groups
  // of the f2 halo.
  const T* s_row[L::SPT];   // start of the slot's image row in channel 0
  int s_off[L::SPT];        // the slot's offset in a channel's slab
  int s_x[L::SPT];          // image column of the slot's first pixel
  bool s_has[L::SPT];       // the slot exists
  bool s_rowok[L::SPT];     // its row lies inside the image
#pragma unroll
  for (int k = 0; k < L::SPT; ++k) {
    const int s = tid + k * L::NT;
    int row, q, y;
    const T* base;
    if (s < L::F1S) {
      row = s / L::QX; q = s % L::QX;
      s_off[k] = row * TW + PX * q;
      y = y0 + row; s_x[k] = x0 + PX * q; base = f1b;
    } else {
      const int h = s - L::F1S;
      row = h / L::G2; q = h % L::G2;
      s_off[k] = L::F1 + row * L::WS + PX * q;
      y = y0 - MD + row; s_x[k] = x0 - MD + PX * q; base = f2b;
    }
    s_has[k] = s < L::NS;
    s_rowok[k] = s_has[k] && y >= 0 && y < H;
    s_row[k] = base + (s_rowok[k] ? (long long)y * W : 0);
  }

  auto fill = [&](int kc) {
    T* const st = ring + (kc % STAGES) * (CC * L::SL);
    const int c0 = cbeg + kc * CC;
    const int cn = min(CC, cend - c0);
#pragma unroll
    for (int k = 0; k < L::SPT; ++k) {
      if (!s_has[k]) continue;
      const T* src = s_row[k] + (long long)c0 * plane;
      T* dst = st + s_off[k];
      if (vec) {
        // the whole group is inside the image or outside it
        const bool ok = s_rowok[k] && s_x[k] >= 0 && s_x[k] < W;
        if (ok) src += s_x[k];
        for (int c = 0; c < cn; ++c, src += plane, dst += L::SL) {
          cp_async<PX * (int)sizeof(T)>(dst, src, ok);
        }
      } else {
        for (int c = 0; c < cn; ++c, src += plane, dst += L::SL) {
#pragma unroll
          for (int e = 0; e < PX; ++e) {
            const int x = s_x[k] + e;
            if (s_rowok[k] && x >= 0 && x < W) dst[e] = src[x];
            else zero1(dst + e);
          }
        }
      }
    }
  };

  float acc[DJ][ND][PX];
#pragma unroll
  for (int j = 0; j < DJ; ++j)
#pragma unroll
    for (int ti = 0; ti < ND; ++ti)
#pragma unroll
      for (int p = 0; p < PX; ++p) acc[j][ti][p] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) fill(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of chunk kc landed
    __syncthreads();               // everyone's did; chunk kc-1 is consumed
    if (kc + STAGES - 1 < nk) fill(kc + STAGES - 1);
    cp_async_commit();
    const T* st = ring + (kc % STAGES) * (CC * L::SL);
    const int cn = min(CC, cend - (cbeg + kc * CC));
    const T* p1 = st + ty * TW + PX * tx;
    const T* p2 = st + L::F1 + (ty + DJ * g) * L::WS + PX * tx;
#pragma unroll 1
    for (int c = 0; c < cn; ++c, p1 += L::SL, p2 += L::SL) {
      fma_channel<DJ, L::WS>(p1, p2, acc);
    }
  }
  cp_async_wait<0>();

  // the ring is consumed: the partial sums may take its place
  store_or_reduce<T, TW, L::NG>(acc, red, out, H, W, x0, y0, nsplit, vec,
                                inv_c);
}

// ---- the launch plan -------------------------------------------------------

// tile, split: 0 lets the plan choose; else the tile width (16 or 32) and the
// number of channel splits (1..8) to use (the card tests force them, to
// reach at small shapes the paths other shapes and cards choose).
template <typename T>
bool make_plan(int B, int C, int H, int W, int tile, int split, int device,
               Plan* p) {
  // the wide tile where it gives three blocks to every two SMs, else the
  // narrow one; the smallest power-of-two split that gives every SM a
  // block, each split keeping at least 16 channels: more splits cost more
  // in the reduction (split x the output's bytes cross the cluster) than
  // they gain in parallel channels
  if (!choose_tile_and_split(B, C, H, W, tile, split, device, 3, 2, 16, p)) {
    return false;
  }
  if (p->tile_w == 32) {
    p->threads = Tile<T, 32>::NT;
    p->smem = p->split > 1 ? Tile<T, 32>::MAX_BYTES : Tile<T, 32>::RING_BYTES;
  } else {
    p->threads = Tile<T, 16>::NT;
    p->smem = p->split > 1 ? Tile<T, 16>::MAX_BYTES : Tile<T, 16>::RING_BYTES;
  }
  return true;
}

template <typename T, int TW>
cudaError_t launch(const void* f1, const void* f2, void* out, int B, int C,
                   int H, int W, const Plan& p, int device,
                   cudaStream_t stream) {
  using L = Tile<T, TW>;
  auto kernel = corr_fwd_kernel<T, TW>;
  static bool ready[MAX_DEVICES] = {false};   // per instantiation
  if (device < 0 || device >= MAX_DEVICES || !ready[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::MAX_BYTES);
    if (e != cudaSuccess) return e;
    if (device >= 0 && device < MAX_DEVICES) ready[device] = true;
  }
  const uintptr_t bits = reinterpret_cast<uintptr_t>(f1) |
                         reinterpret_cast<uintptr_t>(f2) |
                         reinterpret_cast<uintptr_t>(out);
  const int vec = (W % PX == 0 && bits % (PX * sizeof(T)) == 0) ? 1 : 0;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles, p.split, B);
  cfg.blockDim = dim3(L::QX, TH, L::NG);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(f1),
                            static_cast<const T*>(f2), static_cast<T*>(out),
                            C, H, W, p.tiles_x, p.split, p.cper, vec,
                            1.0f / C);
}

template <typename T>
int run(const void* f1, const void* f2, void* out, int B, int C, int H, int W,
        int tile, int split, int device, cudaStream_t stream) {
  Plan p;
  if (!make_plan<T>(B, C, H, W, tile, split, device, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e =
      p.tile_w == 32
          ? launch<T, 32>(f1, f2, out, B, C, H, W, p, device, stream)
          : launch<T, 16>(f1, f2, out, B, C, H, W, p, device, stream);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// f1, f2: (B, C, H, W) contiguous; out: (B, 81, H, W) contiguous, all on
// `device`.  md must be 4 (the model's max displacement; the one
// instantiation).  dtype: 0 = float32, 1 = bfloat16.  tile and split are 0
// (the plan chooses) or a tile width of 16 or 32 and a channel split of
// 1..8.  Launches on `stream` of `device` and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for an unsupported md, dtype, tile, split or
// size).
extern "C" int corr_fwd(const void* f1, const void* f2, void* out, int B,
                        int C, int H, int W, int md, int dtype, int tile,
                        int split, int device, void* stream) {
  if (!shape_ok(B, C, H, W, md) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? run<float>(f1, f2, out, B, C, H, W, tile, split, device, s)
      : run<__nv_bfloat16>(f1, f2, out, B, C, H, W, tile, split, device, s);
}

// The plan corr_fwd would follow, without launching: plan[0..5] = tile
// width, tiles per batch item, channel split, channels per split, threads
// per block, dynamic shared memory in bytes.  Returns 0, or
// cudaErrorInvalidValue as corr_fwd would.
extern "C" int corr_fwd_plan(int B, int C, int H, int W, int md, int dtype,
                             int tile, int split, int device, int* plan) {
  if (!shape_ok(B, C, H, W, md) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  const bool ok = dtype == 0
      ? make_plan<float>(B, C, H, W, tile, split, device, &p)
      : make_plan<__nv_bfloat16>(B, C, H, W, tile, split, device, &p);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  write_plan(p, plan);
  return 0;
}
