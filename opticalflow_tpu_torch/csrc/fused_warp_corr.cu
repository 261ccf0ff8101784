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
// (~24 us at 67 TFLOP/s).  Arithmetic is not the limit, so there is no
// wgmma; the gather's addresses depend on the data, so TMA does not apply.
// What the first version of this kernel lost its time to was latency: 4-14
// blocks at the small levels, each walking all C channels through a
// barrier, gather, barrier, compute loop with nothing in flight, and one
// shared-memory load per FMA.
//
// Design: correlation_fwd.cu's, with another producer for the f2 half of
// the ring (corr_tile.cuh holds what the two kernels share).
//   * Channel split over a cluster.  Grid = image tiles x channel splits x
//     batch; the S blocks (1..8) that share a tile form a thread block
//     cluster, sum their channels in order, lay their partial sums over the
//     ring and reduce them in rank order through distributed shared memory:
//     no atomics, equal inputs give equal bits.
//   * The register tile is correlation_fwd.cu's narrow one in both tiles: a
//     thread owns 4 adjacent pixels x 9 dx x 1 dy row (36 float32 sums) and
//     reads, per channel, one 4-vector of f1 and 12 f2 values: 4 vector
//     loads from shared memory, free of bank conflicts, for 36 FMAs.  The
//     narrow tile (8 x 16) has 288 threads at 96 registers, two blocks an
//     SM; the wide one (8 x 32) 576 threads, one block an SM.  The plan
//     takes the narrow tile unless the wide one is forced: two blocks that
//     gather and compute out of step beat one block with a smaller halo at
//     every shape swept with flows of up to x3 px (with noise of x20 px the
//     smaller halo wins at the largest shapes: 196.7 against 211.7 us at
//     level 2, B=8).
//   * The per-pixel table.  Each block first computes, for every pixel of
//     its 16-row halo window (16 x 24 narrow, 16 x 40 wide), where the 2x2
//     patch of f2 that it samples starts and the patch's four folded
//     weights, and keeps them in shared memory for the whole channel loop.
//     The patch is the one inside the image (where the sample's own sticks
//     out by a column or a row, the patch a step inside is read and the
//     weights move with their corners), so a pixel costs one offset, its
//     four values lie at p, p + 1, p + W, p + W + 1, and nothing outside f2
//     is read.  Every rank of a cluster builds its own copy: sharing it
//     would put a cluster barrier in front of the first gather.  A pixel
//     outside the image (the correlation's zero padding) or with four zero
//     weights (masked out) is marked, and nothing is loaded for it.  (So a
//     non-finite f2 value under an all-zero mask gives 0, not NaN.)
//   * The ring, filled by a register-staged prefetch.  Channels go through
//     a ring of two stages in shared memory.  The f2 half of a stage holds
//     WARPED values, float32 whatever the features' dtype (the plain version
//     keeps the warped tensor float32), so its strides are the float32 ones.
//     Every thread serves the same one or two halo pixels in every chunk of
//     4 channels (their positions decoded once before the loop, so the
//     loader divides nothing): it starts the corner loads of chunk k+1 (4
//     per pixel and channel, 32 registers; two addresses and two immediate
//     offsets, no predicate: a channel past the block's last reads the last
//     again) BEFORE the FMAs of chunk k, and weights, sums and stores them
//     to the other stage AFTER, so the loads' latency runs under the FMAs.
//     One barrier per chunk.  All
//     threads gather, so a chunk's loads are in flight at once, which is
//     what the small levels need (2-4 chunks a block: nothing reaches a
//     steady state there); dedicated producer warps behind mbarriers were
//     not built: with 2-3 warps gathering, the first chunk's loads take
//     several round trips to L2 instead of one, and setmaxnreg needs whole
//     warpgroups, which 6 or 9 consumer warps are not.
//   * The f1 half of a stage stays in the features' dtype and comes by
//     cp.async (16 bytes for float32, 8 for bfloat16) with zero fill outside
//     the image, when W is a multiple of 4 and f1 is aligned; else by
//     element loads.  Stores are 4-pixel vectors under the same condition
//     (and `out` aligned), scalar and masked otherwise.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py phase 3,
// float32, noise flows of x3 px, the card alone (calls queued behind a spin
// kernel), beside the composed path (warp_with_mask, then the correlation
// kernel): 23.5, 17.0, 12.8, 10.8 us at levels 2-5 of a 448x1024 frame at
// B=1 (64.1 us against the composed 278.0; the first version took 611.9;
// bound 7.61), 156.7, 84.0, 35.1, 22.1 us at B=8 (297.8 against 488.8;
// bound 60.9); bfloat16 68.6 and 316.1.  What limits the large shapes now
// is the one data path that shared memory and L1 share: the FMAs' vector
// loads keep it busy in the correlation kernel already, and the gather's
// 4-byte loads pass through it once per cache line a warp touches.  Level
// 2 at B=8 (scripts/sweep_corr.py --fused --variants): corner loads
// replaced by a constant 80.5 us, one load a value instead of four 112.4,
// all four 156.8; a zero flow, whose loads touch the fewest lines, 119.7,
// noise of x3 px 156.8, of x20 px 211.7; the loads sent past L1
// (ld.global.cg) 277.6.  The arithmetic around the loads is not the
// limit: a gather with twice the address arithmetic and a predicate per
// load took 165.5.  A block gathers 3 halo pixels for every output pixel.
// The small levels (B=1, levels 3-5) are the correlation kernel's chain of
// launch, table, first gather, a few chunks, two cluster barriers and the
// reduction: 10.8-17.0 us where that kernel takes 7.5-10.3.

#include <type_traits>

#include "corr_tile.cuh"
#include "device_guard.cuh"

namespace {

// One dy row a thread (36 sums) in both tiles, correlation_fwd.cu's narrow
// shape: the gather, not the FMAs' shared-memory loads, is what this kernel
// waits for, and three times the threads hide more of it (the wide tile
// with 3 dy rows a thread, 192 threads at 239-244 registers, takes 189.2 us
// where this one takes 164.5, level 2, B=8).  The ring differs from that
// kernel's: two stages of CC channels, the f2 halves float32 (warped
// values), the f1 halves in the features' dtype, and behind them the
// per-pixel table.
template <typename T, int TW>
struct Tile {
  static constexpr int NG = 9;                    // dy groups (threadIdx.z)
  static constexpr int DJ = ND / NG;              // dy rows per thread
  static constexpr int CC = 4;                    // channels per stage
  static constexpr int STAGES = 2;                // prefetch distance 1
  static constexpr int QX = TW / PX;              // pixel quads per tile row
  static constexpr int NT = QX * TH * NG;         // threads per block
  static constexpr int HC = TW + 2 * MD;          // halo columns
  static constexpr int NPIX = HR * HC;            // halo pixels
  static constexpr int PPT = (NPIX + NT - 1) / NT;  // halo pixels per thread
  // f2 halo row stride in floats: rows read by one vector-load phase of a
  // warp must fall in distinct banks
  static constexpr int WS = TW == 32 ? 40 : 48;
  static constexpr int F2 = HR * WS;              // f2 floats per channel
  static constexpr int F1 = TH * TW;              // f1 elements per channel
  static constexpr int F1S = TH * QX;             // f1 4-pixel slots a channel
  static constexpr int SPT1 = (CC * F1S + NT - 1) / NT;  // f1 slots a thread
  static constexpr int F2_BYTES = STAGES * CC * F2 * (int)sizeof(float);
  static constexpr int F1_BYTES = STAGES * CC * F1 * (int)sizeof(T);
  static constexpr int TABLE_BYTES = NPIX * (int)(sizeof(float4) + sizeof(int));
  static constexpr int RING_BYTES = F2_BYTES + F1_BYTES + TABLE_BYTES;
  // a block's partial sums, which take the ring's place for the reduction
  static constexpr int RED_BYTES = ND2 * F1 * (int)sizeof(float);
  static constexpr int MAX_BYTES =
      RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
};

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// The table's entry for the warped pixel (y, x): the offset in a plane of
// the upper left of the 2x2 patch of f2 that is read for it (< 0: nothing to
// load, the value is 0) and the patch's folded weights (00, 01, 10, 11).
// The patch always lies inside the image, so its four values are at p, p + 1,
// p + W and p + W + 1 (one address and three immediates; p + 0 where W or H
// is 1): where the sample's own patch sticks out by a column or a row, the
// patch read is the one a step inside, and the weights move with their
// corners (the corner left outside had weight 0).
__device__ __forceinline__ void corner_table(
    const float* __restrict__ fu, const float* __restrict__ fv, int y, int x,
    int H, int W, float scale_x, float scale_y, float thr, int* off_out,
    float4* w_out) {
  float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
  int off = -1;
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
    // below the threshold all four weights are 0: nothing to load either
    if (sum >= thr) {
      const int bx = min(max(ix, 0), max(W - 2, 0));
      const int by = min(max(iy, 0), max(H - 2, 0));
      // A patch moved by one column: the corner that was inside is now the
      // other column's, so the columns' weights change places (one of them
      // is 0).  Moved by more, all four weights are 0.  Rows alike.
      const bool mx = bx != ix, my = by != iy;
      const float a = mx ? w01 : w00, b = mx ? w00 : w01;
      const float c = mx ? w11 : w10, d = mx ? w10 : w11;
      wv = my ? make_float4(c, d, a, b) : make_float4(a, b, c, d);
      off = by * W + bx;
    }
  }
  *off_out = off;
  *w_out = wv;
}

// ---- the kernel ------------------------------------------------------------

// grid (tiles, nsplit, B), cluster (1, nsplit, 1), block (TW/4, TH, NG).
// Dynamic shared memory: the f2 ring, the f1 ring, the table; for the
// reduction, the partial sums over all of them.  Rank r of a cluster sums
// channels [r*cper, min(C, (r+1)*cper)).
template <typename T, int TW>
__global__ void __launch_bounds__(Tile<T, TW>::NT, TW == 32 ? 1 : 2)
fused_warp_corr_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                       const float* __restrict__ flow, T* __restrict__ out,
                       int C, int H, int W, int tiles_x, int nsplit, int cper,
                       int vec, float scale_x, float scale_y, float thr,
                       float inv_c) {
  using L = Tile<T, TW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int DJ = L::DJ, CC = L::CC, PPT = L::PPT;
  float* const ring2 = reinterpret_cast<float*>(smem_raw);
  T* const ring1 = reinterpret_cast<T*>(smem_raw + L::F2_BYTES);
  float4* const t_w =
      reinterpret_cast<float4*>(smem_raw + L::F2_BYTES + L::F1_BYTES);
  int* const t_off = reinterpret_cast<int*>(t_w + L::NPIX);
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

  // The f1 loader's slots: this thread copies the same 4-pixel groups of the
  // same channels of every chunk.
  const T* s_src[L::SPT1];  // the slot's first pixel in channel 0 of f1
  int s_dst[L::SPT1];       // its offset in a stage of the f1 ring
  int s_c[L::SPT1];         // its channel in the chunk; CC: no such slot
  int s_x[L::SPT1];         // image column of its first pixel
  bool s_ok[L::SPT1];       // its row (and, for vec, all of it) is inside
#pragma unroll
  for (int k = 0; k < L::SPT1; ++k) {
    const int s = tid + k * L::NT;
    const int c = s / L::F1S, r = (s % L::F1S) / L::QX, q = s % L::QX;
    const int y = y0 + r, x = x0 + PX * q;
    s_c[k] = s < CC * L::F1S ? c : CC;
    s_dst[k] = c * L::F1 + r * TW + PX * q;
    s_x[k] = x;
    s_ok[k] = y < H && (vec ? x < W : true);
    s_src[k] = f1b + (y < H ? (long long)y * W : 0) +
               (long long)c * plane + (vec && x < W ? x : 0);
  }

  auto fill_f1 = [&](int kc) {
    T* const st = ring1 + (kc & 1) * (CC * L::F1);
    const int c0 = cbeg + kc * CC;
#pragma unroll
    for (int k = 0; k < L::SPT1; ++k) {
      if (c0 + s_c[k] >= cend || s_c[k] >= CC) continue;
      const T* src = s_src[k] + (long long)c0 * plane;
      T* dst = st + s_dst[k];
      if (vec) {
        // the whole group is inside the image or outside it
        cp_async<PX * (int)sizeof(T)>(dst, src, s_ok[k]);
      } else {
#pragma unroll
        for (int e = 0; e < PX; ++e) {
          const int x = s_x[k] + e;
          if (s_ok[k] && x < W) dst[e] = src[x];
          else zero1(dst + e);
        }
      }
    }
  };

  // The gather's pixels: halo pixel tid + k*NT of every chunk is this
  // thread's.  p_dst: its place in a channel's f2 window, -1: no such pixel.
  int p_dst[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * L::NT;
    p_dst[k] = p < L::NPIX ? (p / L::HC) * L::WS + p % L::HC : -1;
  }

  // chunk 0 of f1 is on its way while the table is built
  if (nk > 0) fill_f1(0);
  cp_async_commit();

  if (nk > 0) {
    const float* fu = flow + (long long)b * 2 * plane;
    const float* fv = fu + plane;
    for (int p = tid; p < L::NPIX; p += L::NT) {
      corner_table(fu, fv, y0 - MD + p / L::HC, x0 - MD + p % L::HC, H, W,
                   scale_x, scale_y, thr, t_off + p, t_w + p);
    }
  }
  __syncthreads();

  // The staged corner values of the chunk in flight, and which of this
  // thread's pixels have any (bit k).
  float v[PPT][CC][4];
  unsigned live = 0;

  // inner: the patch's other column and row are 1 and W elements on, which
  // the loads take as immediates and one address each; else (W or H is 1)
  // they are dx1 and dyw, which may be 0.
  const bool inner_image = W > 1 && H > 1;
  const int dx1 = W > 1 ? 1 : 0, dyw = H > 1 ? W : 0;

  auto gather_load = [&](int kc, auto inner) {
    constexpr bool INNER = decltype(inner)::value;
    const int c0 = cbeg + kc * CC;
    // Each channel's plane as a pointer the compiler cannot see through, so
    // that a corner's address is offset * size + base and not a 64-bit
    // index sum rebuilt from f2 for every load (twice the arithmetic).  A
    // channel past the block's last reads the last one again: no load is
    // predicated, and what is stored for it is never read.
    const T* base[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      base[c] = f2b + (long long)min(c0 + c, cend - 1) * plane;
      asm("" : "+l"(base[c]));
    }
    live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (p_dst[k] < 0) continue;
      const int off = t_off[tid + k * L::NT];
      if (off < 0) continue;
      live |= 1u << k;
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        const T* p = base[c] + off;
        const T* q = p + (INNER ? W : dyw);
        v[k][c][0] = load_f(p);
        v[k][c][1] = load_f(p + (INNER ? 1 : dx1));
        v[k][c][2] = load_f(q);
        v[k][c][3] = load_f(q + (INNER ? 1 : dx1));
      }
    }
  };
  auto gather_load_any = [&](int kc) {
    if (inner_image) gather_load(kc, std::true_type{});
    else gather_load(kc, std::false_type{});
  };

  auto gather_store = [&](int kc) {
    float* const st = ring2 + (kc & 1) * (CC * L::F2);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (p_dst[k] < 0) continue;
      float* dst = st + p_dst[k];
      if (live & (1u << k)) {
        const float4 wv = t_w[tid + k * L::NT];
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          dst[c * L::F2] = wv.x * v[k][c][0] + wv.y * v[k][c][1] +
                           wv.z * v[k][c][2] + wv.w * v[k][c][3];
        }
      } else {
#pragma unroll
        for (int c = 0; c < CC; ++c) dst[c * L::F2] = 0.f;
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

  if (nk > 0) {
    gather_load_any(0);
    gather_store(0);
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<0>();   // this thread's f1 copies of chunk kc landed
    __syncthreads();      // everyone's did, and everyone's warped values of
                          // chunk kc are stored; chunk kc-1 is consumed
    const bool more = kc + 1 < nk;
    if (more) {
      fill_f1(kc + 1);
      gather_load_any(kc + 1);   // in flight under the FMAs below
    }
    cp_async_commit();
    const int cn = min(CC, cend - (cbeg + kc * CC));
    const T* p1 = ring1 + (kc & 1) * (CC * L::F1) + ty * TW + PX * tx;
    const float* p2 = ring2 + (kc & 1) * (CC * L::F2) +
                      (ty + DJ * g) * L::WS + PX * tx;
#pragma unroll 1
    for (int c = 0; c < cn; ++c, p1 += L::F1, p2 += L::F2) {
      fma_channel<DJ, L::WS>(p1, p2, acc);
    }
    if (more) gather_store(kc + 1);
  }
  cp_async_wait<0>();

  // the ring and the table are consumed: the partial sums may take their
  // place
  store_or_reduce<T, TW, L::NG>(acc, red, out, H, W, x0, y0, nsplit, vec,
                                inv_c);
}

// ---- the launch plan -------------------------------------------------------

// tile, split: 0 lets the plan choose; else the tile width (16 or 32) and the
// number of channel splits (1..8) to use.
template <typename T>
bool make_plan(int B, int C, int H, int W, int tile, int split, int device,
               Plan* p) {
  // The narrow tile unless the wide one is forced: two narrow blocks an SM
  // beat one wide block at every shape swept with flows of up to x3 px
  // (scripts/sweep_corr.py --fused).  Then correlation_fwd.cu's rule for the split, down to 8
  // channels a split: a channel costs more here (the gather), so one more
  // halving pays (level 4, B=1: 12.7 us at 8 splits of 12, 16.0 at 4).
  if (tile == 0) tile = 16;
  if (!choose_tile_and_split(B, C, H, W, tile, split, device, 3, 2, 8, p)) {
    return false;
  }
  if (p->tile_w == 32) {
    p->threads = Tile<T, 32>::NT;
    p->smem = p->split > 1 ? Tile<T, 32>::MAX_BYTES
                           : Tile<T, 32>::RING_BYTES;
  } else {
    p->threads = Tile<T, 16>::NT;
    p->smem = p->split > 1 ? Tile<T, 16>::MAX_BYTES
                           : Tile<T, 16>::RING_BYTES;
  }
  return true;
}

template <typename T, int TW>
cudaError_t launch(const void* f1, const void* f2, const void* flow,
                   void* out, int B, int C, int H, int W, float thr,
                   const Plan& p, int device, cudaStream_t stream) {
  using L = Tile<T, TW>;
  auto kernel = fused_warp_corr_kernel<T, TW>;
  static bool ready[MAX_DEVICES] = {false};   // per instantiation
  if (device < 0 || device >= MAX_DEVICES || !ready[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::MAX_BYTES);
    if (e != cudaSuccess) return e;
    if (device >= 0 && device < MAX_DEVICES) ready[device] = true;
  }
  // f2 and the flow are read element by element: only f1 (cp.async) and
  // out (vector stores) need the alignment
  const uintptr_t bits = reinterpret_cast<uintptr_t>(f1) |
                         reinterpret_cast<uintptr_t>(out);
  const int vec = (W % PX == 0 && bits % (PX * sizeof(T)) == 0) ? 1 : 0;
  // the sample-point scale as the plain version rounds it: in double, then
  // to float32
  const float scale_x = (float)((double)W / (double)(W > 1 ? W - 1 : 1));
  const float scale_y = (float)((double)H / (double)(H > 1 ? H - 1 : 1));

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
                            static_cast<const T*>(f2),
                            static_cast<const float*>(flow),
                            static_cast<T*>(out), C, H, W, p.tiles_x, p.split,
                            p.cper, vec, scale_x, scale_y, thr, 1.0f / C);
}

template <typename T>
int run(const void* f1, const void* f2, const void* flow, void* out, int B,
        int C, int H, int W, float thr, int tile, int split, int device,
        cudaStream_t stream) {
  Plan p;
  if (!make_plan<T>(B, C, H, W, tile, split, device, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e =
      p.tile_w == 32
          ? launch<T, 32>(f1, f2, flow, out, B, C, H, W, thr, p, device,
                          stream)
          : launch<T, 16>(f1, f2, flow, out, B, C, H, W, thr, p, device,
                          stream);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// f1, f2: (B, C, H, W) contiguous, one dtype; flow: (B, 2, H, W) float32
// contiguous (u, v in pixels); out: (B, (2md+1)^2, H, W) contiguous in the
// features' dtype, all on `device`.  md must be 4 (the model's max
// displacement).  dtype: 0 = float32, 1 = bfloat16.  tile and split are 0
// (the plan chooses) or a tile width of 16 or 32 and a channel split of
// 1..8.  Launches on `stream` of `device` and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for an unsupported md, dtype, tile, split or
// size).
extern "C" int fused_warp_corr(const void* f1, const void* f2,
                               const void* flow, void* out, int B, int C,
                               int H, int W, int md, int dtype, float thr,
                               int tile, int split, int device,
                               void* stream) {
  if (!shape_ok(B, C, H, W, md) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? run<float>(f1, f2, flow, out, B, C, H, W, thr, tile, split, device, s)
      : run<__nv_bfloat16>(f1, f2, flow, out, B, C, H, W, thr, tile, split,
                           device, s);
}

// The plan fused_warp_corr would follow, without launching: plan[0..5] =
// tile width, tiles per batch item, channel split, channels per split,
// threads per block, dynamic shared memory in bytes.  Returns 0, or
// cudaErrorInvalidValue as fused_warp_corr would.
extern "C" int fused_warp_corr_plan(int B, int C, int H, int W, int md,
                                    int dtype, int tile, int split,
                                    int device, int* plan) {
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
