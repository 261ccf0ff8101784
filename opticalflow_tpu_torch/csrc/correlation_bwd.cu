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
// zero outside the image (f1, f2 and g alike), float32 accumulation, each
// gradient stored in the inputs' dtype (float32 or bfloat16; g arrives in the
// volume's dtype, which is theirs).
//
// Bound on this card: memory at the training shapes.  The function must read
// f1, f2 and g once and write d1 and d2 once, s*B*H*W*(2C+81) bytes read and
// s*B*H*W*2C written, against 4*81*C*B*H*W float32 operations: at level 2
// of a 320x896 crop (B=4, C=32, float32) 59.9 MB, 17.9 us at 3.35 TB/s,
// against 11.1 us of FMAs at 67 TFLOP/s.  Shared memory is the nearer
// limit of any design that feeds the FMAs from it: 32 words a clock per SM
// against 128 FMAs.
//
// Design (gather form: every output element is a sum in a fixed order, so
// there are no atomics and two runs give the same bits):
//   * One launch, two roles: grid (tiles, channel splits, 2B), blockIdx.z =
//     2b + role.  Role 0 writes d1 (weights g[k,p], window f2 at p + o_k),
//     role 1 writes d2 (weights g[k,p-o_k], window f1 at p - o_k).  Both are
//     the same shape of work.
//   * A register tile with the displacement row outside the channel loop.
//     The 9 displacement rows tj are split over the block's warps
//     (threadIdx.z); a thread owns BPX = 4 adjacent pixels of one tile row
//     and holds their 9*BPX weights of its row tj in registers for the whole
//     block (loaded once, zero outside the image, 16 bytes at a time where
//     the columns align).  Per channel it reads the BPX+8 window values of
//     one row (three 16-byte loads, as K1's fma_channel does) and does 9*BPX
//     FMAs into BPX sums: a third of a shared-memory word per FMA, where the
//     first version of this kernel read one word per FMA.  (BDR > 1 gives a
//     thread BDR rows on one displacement diagonal, which read the same
//     window row; a sweep variant: its weights do not fit the registers.)
//   * The 9 rows' partial sums meet in shared memory: after each stage of
//     BCC channels every thread writes its BPX sums per channel, and in the
//     next stage the block adds the 9 rows in row order, scales and stores
//     (two words of shared-memory traffic per row and output element).  The
//     order is fixed, so the bits repeat.  The sums are double-buffered, so
//     one barrier a stage serves the ring and the sums together.
//   * The windows (12 halo rows of the 4-row tile, per channel) go global ->
//     shared through cp.async into a ring of BSTAGES stages of BCC channels,
//     the first stages issued before the weights' loads.  The halo origin
//     x0-4 is a multiple of 4 pixels, so when W is one too and the base
//     pointers are aligned every 4-pixel group is wholly inside or outside
//     the image: outside groups take cp.async's zero-fill form, which is the
//     correlation's padding.  Otherwise the same ring is filled by element
//     loads with per-element masks, and stores are scalar.  bfloat16 stays
//     bfloat16 in the ring (8-byte copies, half the bytes) and is widened at
//     the FMA.
//   * 92 registers at most, under ptxas's cap of 96 for two 9-warp blocks an
//     SM (5 warps on some of its 4 register files): the reduction keeps 3
//     loads in flight, not 9, and offsets within a batch item are 32-bit.
//   * Two tiles: 4x32 (288 threads, two blocks an SM) and 4x16 (144
//     threads, four), so a 5x14 level does not run a tile that is mostly
//     empty.  The rule reads how many blocks of each an SM holds
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and was set from the
//     sweep: the narrow tile unless the wide one fills its slots four times
//     over, then channel splits until the blocks fill half the slots.
//   * No tensor cores: per (dy, image row) the work is a banded product, a
//     T x (T+8) matrix with 9 non-zero diagonals against a (T+8) x C window,
//     so mma/wgmma would spend at least 7/8 of its work on zeros; and the
//     float32 parity mode must stay float32 (no TF32).
//   * What bounds it now (sweep diagnostics, PERF.md): the weights' loads
//     at each block's start (about 15% of a training step's time) and the
//     partial sums' reduction (about 17%), then shared-memory bandwidth.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W): see PERF.md (chip_smoke.py
// phase 7; scripts/sweep_corr.py --bwd for every tile, split and variant).

#include <type_traits>

#include "corr_tile.cuh"
#include "device_guard.cuh"

namespace {

constexpr int BPX = 4;              // adjacent pixels a thread owns
constexpr int BDR = 1;              // tile rows a thread owns, on a diagonal
constexpr int BNZ = ND + BDR - 1;   // diagonals (threadIdx.z)
constexpr int BCC = 4;              // channels per ring stage
constexpr int BSTAGES = 3;          // stages in the ring
constexpr int BMIN_CHANNELS = 6;    // fewest channels a split keeps
constexpr int BMAX_SPLIT = 64;
static_assert(BPX % 4 == 0 && BSTAGES >= 2, "bad constants");

// the ring's element type: the inputs' own
template <typename T> using Ring = T;

template <typename T, int TW>
struct BTile {
  using R = Ring<T>;
  static constexpr int TR = 4;                      // output rows
  static constexpr int HRW = TR + 2 * MD;           // window rows
  static constexpr int QX = TW / BPX;               // threads per tile row
  static constexpr int NT = QX * (TR / BDR) * BNZ;  // threads per block
  // window row stride in elements: the rows one vector-load phase of a warp
  // reads (float32: one row of the wide tile, two of the narrow one;
  // bfloat16: two and four) fall in distinct banks
  static constexpr int WS =
      sizeof(R) == 4 ? (TW == 32 ? 40 : (BDR == 1 ? 48 : 40))
                     : (TW == 32 ? (BDR == 1 ? 96 : 48) : 48);
  static constexpr int G2 = (TW + 2 * MD) / 4;      // copy groups a row
  static constexpr int SL = HRW * WS;               // ring elements per channel
  static constexpr int NS = BCC * HRW * G2;         // copy slots per stage
  static constexpr int SPT = (NS + NT - 1) / NT;    // slots per thread
  static constexpr int RING_BYTES = BSTAGES * BCC * SL * (int)sizeof(R);
  // a stage's partial sums, per displacement row: two buffers
  static constexpr int RED = ND * BCC * TR * TW;
  static constexpr int SMEM = RING_BYTES + 2 * RED * (int)sizeof(float);
  static constexpr int MINB = TW == 32 ? 2 : 4;     // blocks an SM, at least
  static_assert(TR % BDR == 0, "a tile's rows divide among the diagonals");
};

// one weight, widened exactly, by a plain load (scripts/sweep_corr.py
// --bwd --variants times the read-only __ldg path against it)
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  const unsigned short u = *reinterpret_cast<const unsigned short*>(p);
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename R, typename T>
__device__ __forceinline__ void put1(R* d, T v) {
  if constexpr (std::is_same_v<R, T>) *d = v;
  else *d = widen(v);
}

// The body of one role.  src is X of batch item b, dst the gradient of batch
// item b, gb the volume's gradient of batch item b.
//
// Thread (tx, u, t) owns pixels x0 + BPX*tx .. +BPX-1 of the BDR tile rows
// BDR*u + i, and for row i the displacement row tj_i that makes all of them
// read one window row: role 0 reads X[y + dy], so tj_i = t - i (window row
// BDR*u + t); role 1 reads X[y - dy], so tj_i = t - (BDR-1) + i (window row
// BDR*u + 2*MD + BDR-1 - t).  A tj_i outside 0..8 is no work (zero weights,
// no partial sum); every (row, tj) pair of the tile has exactly one owner.
template <typename T, int TW, bool ROLE2>
__device__ __forceinline__ void corr_bwd_role(
    const T* __restrict__ src, const T* __restrict__ gb, T* __restrict__ dst,
    unsigned char* smem, int H, int W, int x0, int y0, int cbeg, int cend,
    int vec, float inv_c) {
  using L = BTile<T, TW>;
  using R = typename L::R;
  constexpr int TR = L::TR, CH = L::HRW * L::G2;
  R* const ring = reinterpret_cast<R*>(smem);
  float* const red = reinterpret_cast<float*>(smem + L::RING_BYTES);
  const int tx = threadIdx.x, u = threadIdx.y, t = threadIdx.z;
  const int tid = tx + L::QX * (u + (TR / BDR) * t);
  const int plane = H * W;   // the plan holds 81*H*W below 2^31
  const int x = x0 + BPX * tx;

  // The loader's slots: this thread copies the same 4-element groups of
  // every stage.  Slot s is group s % G2 of window row (s % CH) / G2 of
  // the stage's channel s / CH.
  constexpr bool kCopy = sizeof(R) == sizeof(T);   // the ring is T itself
  auto fill = [&](int kc) {
    R* const st = ring + (kc % BSTAGES) * (BCC * L::SL);
    const int c0 = cbeg + kc * BCC;
#pragma unroll
    for (int k = 0; k < L::SPT; ++k) {
      const int sl = tid + k * L::NT;
      const int c = sl / CH, row = (sl % CH) / L::G2, grp = sl % L::G2;
      if (sl >= L::NS || c0 + c >= cend) continue;
      const int yy = y0 - MD + row, xs = x0 - MD + 4 * grp;
      const bool rowok = yy >= 0 && yy < H;
      const T* sp = src + (c0 + c) * plane + (rowok ? yy * W : 0);
      R* d = st + c * L::SL + row * L::WS + 4 * grp;
      if (kCopy && vec) {
        // the whole group is inside the image or outside it; outside, the
        // zero fill is the padding
        const bool ok = rowok && xs >= 0 && xs < W;
        cp_async<4 * (int)sizeof(T)>(d, ok ? sp + xs : sp, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (rowok && xs + e >= 0 && xs + e < W) put1(d + e, sp[xs + e]);
          else zero1(d + e);
        }
      }
    }
  };

  // the first stages' copies go out before the weights' loads
  const int nk = (cend - cbeg + BCC - 1) / BCC;
#pragma unroll
  for (int s = 0; s < BSTAGES - 1; ++s) {
    if (s < nk) fill(s);
    cp_async_commit();
  }

  // this thread's weights: BDR rows x 9 dx x BPX pixels, each row at its
  // own displacement row, zero outside the image.  Pixel p of dx ti lies in
  // column xs + p; where xs is a multiple of 4 (role 0, and ti = 0, 4, 8 in
  // role 1) and W is one too, the 4 columns are one vector load, wholly
  // inside the image or outside it.
  int tjr[BDR];
  float wk[BDR][ND][BPX];
#pragma unroll
  for (int i = 0; i < BDR; ++i) {
    const int tj = ROLE2 ? t - (BDR - 1) + i : t - i;
    tjr[i] = tj;
    const int y = y0 + BDR * u + i;
    const int yy = ROLE2 ? y - (tj - MD) : y;
    const bool rowok = tj >= 0 && tj < ND && yy >= 0 && yy < H;
#pragma unroll
    for (int ti = 0; ti < ND; ++ti) {
      const int xs = ROLE2 ? x + MD - ti : x;
      const T* gp =
          gb + (rowok ? tj * ND + ti : 0) * plane + (rowok ? yy * W : 0);
      if ((ROLE2 ? (MD - ti) % 4 == 0 : true) && vec) {
#pragma unroll
        for (int q = 0; q < BPX / 4; ++q) {
          if (rowok && xs + 4 * q >= 0 && xs + 4 * q < W) {
            load4(gp + xs + 4 * q, wk[i][ti] + 4 * q);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) wk[i][ti][4 * q + e] = 0.f;
          }
        }
      } else {
#pragma unroll
        for (int p = 0; p < BPX; ++p) {
          const bool ok = rowok && xs + p >= 0 && xs + p < W;
          wk[i][ti][p] = ok ? ld(gp + xs + p) : 0.f;
        }
      }
    }
  }

  // the window row all of this thread's rows read
  const int wr = ROLE2 ? BDR * u + 2 * MD + BDR - 1 - t : BDR * u + t;
  const R* const pr = ring + wr * L::WS + BPX * tx;
  constexpr int QT = TR * TW / 4;   // output 4-pixel groups per channel

  // One barrier a stage.  Iteration kc reduces the sums of stage kc-1 (the
  // barrier has seen them all written) and computes those of stage kc into
  // the other buffer (the barrier has seen it reduced, in iteration kc-1).
  for (int kc = 0; kc <= nk; ++kc) {
    cp_async_wait<BSTAGES - 2>();   // this thread's copies of stage kc landed
    __syncthreads();                // everyone's; stage kc-1 is consumed
    if (kc + BSTAGES - 1 < nk) fill(kc + BSTAGES - 1);
    cp_async_commit();

    if (kc > 0) {
      // the 9 displacement rows' sums of stage kc-1 added in row order,
      // scaled, stored
      const int c0 = cbeg + (kc - 1) * BCC;
      const int cn = min(BCC, cend - c0);
      const float* rb = red + ((kc - 1) & 1) * L::RED;
      for (int it = tid; it < cn * QT; it += L::NT) {
        const int c = it / QT, q = it % QT;
        const float* sp = rb + c * TR * TW + 4 * q;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        // three loads in flight, not nine: the registers go to the weights
#pragma unroll 3
        for (int tj = 0; tj < ND; ++tj) {
          const float4 v =
              *reinterpret_cast<const float4*>(sp + tj * BCC * TR * TW);
          a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
        }
        const int yq = y0 + q / (TW / 4), xq = x0 + 4 * (q % (TW / 4));
        if (yq < H && xq < W) {
          T* o = dst + (c0 + c) * plane + yq * W + xq;
          if (vec) {
            store4(o, a.x * inv_c, a.y * inv_c, a.z * inv_c, a.w * inv_c);
          } else {
            const float sv[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (xq + e < W) store1(o + e, sv[e] * inv_c);
          }
        }
      }
    }
    if (kc == nk) break;

    const R* st = pr + (kc % BSTAGES) * (BCC * L::SL);
    float* const rb = red + (kc & 1) * L::RED;
    // channels past the split's end hold stale values: their sums are never
    // stored
#pragma unroll 2
    for (int c = 0; c < BCC; ++c) {
      float v[BPX + 2 * MD];
#pragma unroll
      for (int q = 0; q < (BPX + 2 * MD) / 4; ++q)
        load4(st + c * L::SL + 4 * q, v + 4 * q);
#pragma unroll
      for (int i = 0; i < BDR; ++i) {
        float acc[BPX];
#pragma unroll
        for (int p = 0; p < BPX; ++p) acc[p] = 0.f;
#pragma unroll
        for (int ti = 0; ti < ND; ++ti)
#pragma unroll
          for (int p = 0; p < BPX; ++p)
            acc[p] = fmaf(wk[i][ti][p], v[ROLE2 ? p + 2 * MD - ti : p + ti],
                          acc[p]);
        if (BDR == 1 || (tjr[i] >= 0 && tjr[i] < ND)) {
          float* o = rb + ((tjr[i] * BCC + c) * TR + BDR * u + i) * TW +
                     BPX * tx;
#pragma unroll
          for (int q = 0; q < BPX / 4; ++q)
            *reinterpret_cast<float4*>(o + 4 * q) =
                make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                            acc[4 * q + 3]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// grid (tiles, nsplit, 2B), block (TW/BPX, TR/BDR, BNZ), dynamic shared
// memory BTile::SMEM (the ring, then two buffers of partial sums).  Split r
// owns channels [r*cper, min(C, (r+1)*cper)).
template <typename T, int TW>
__global__ void __launch_bounds__(BTile<T, TW>::NT, BTile<T, TW>::MINB)
corr_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                const T* __restrict__ g, T* __restrict__ d1,
                T* __restrict__ d2, int C, int H, int W, int tiles_x,
                int cper, int vec, float inv_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TR = BTile<T, TW>::TR;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int y0 = (blockIdx.x / tiles_x) * TR;
  const int b = blockIdx.z >> 1;
  const int cbeg = min(C, blockIdx.y * cper), cend = min(C, cbeg + cper);
  if (cbeg >= cend) return;   // past the last channel: forced splits only
  const long long plane = (long long)H * W;
  const long long fb = (long long)b * C * plane;
  const T* gb = g + (long long)b * ND2 * plane;
  if (blockIdx.z & 1) {
    corr_bwd_role<T, TW, true>(f1 + fb, gb, d2 + fb, smem_raw, H, W, x0, y0,
                               cbeg, cend, vec, inv_c);
  } else {
    corr_bwd_role<T, TW, false>(f2 + fb, gb, d1 + fb, smem_raw, H, W, x0, y0,
                                cbeg, cend, vec, inv_c);
  }
}

// ---- the launch plan -------------------------------------------------------

struct BwdPlan {
  int tile_h, tile_w;
  int tiles, tiles_x;
  int split, cper;
  int threads, smem;
  int per_sm;   // blocks of this instantiation an SM holds
  int regs;     // registers a thread
};

// Once per instantiation and device: allow its dynamic shared memory, and
// read how many of its blocks an SM holds and its registers a thread.
template <typename T, int TW>
cudaError_t prepare(int device, int* per_sm, int* regs) {
  using L = BTile<T, TW>;
  static int n_of[MAX_DEVICES] = {0};
  static int r_of[MAX_DEVICES] = {0};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (n_of[device] == 0) {
    auto kernel = corr_bwd_kernel<T, TW>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return e;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, L::NT,
                                                      L::SMEM);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidConfiguration;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return e;
    r_of[device] = a.numRegs;
    n_of[device] = n;
  }
  *per_sm = n_of[device];
  *regs = r_of[device];
  return cudaSuccess;
}

template <typename T, int TW>
cudaError_t fill_plan(int H, int W, int device, BwdPlan* p) {
  using L = BTile<T, TW>;
  p->tile_h = L::TR;
  p->tile_w = TW;
  p->tiles_x = (W + TW - 1) / TW;
  p->tiles = ((H + L::TR - 1) / L::TR) * p->tiles_x;
  p->threads = L::NT;
  p->smem = L::SMEM;
  return prepare<T, TW>(device, &p->per_sm, &p->regs);
}

// tile, split: 0 lets the rule choose; else the tile width (16 or 32) and
// 1..64 channel splits (the card tests force them, to reach at small shapes
// what large ones choose).  The rule, set from scripts/sweep_corr.py --bwd
// (PERF.md): the narrow tile, unless the wide one's blocks fill the card's
// slots for them (blocks an SM, from the occupancy API, times SMs) four
// times over; then the smallest power-of-two split whose blocks fill half
// the chosen tile's slots, each split keeping at least BMIN_CHANNELS
// channels (every split re-reads g and starts its blocks anew).
template <typename T>
cudaError_t make_bwd_plan(int B, int C, int H, int W, int tile, int split,
                          int device, BwdPlan* p) {
  if (!(tile == 0 || tile == 16 || tile == 32) || split < 0 ||
      split > BMAX_SPLIT || 2LL * B > 65535 ||
      (long long)(C > ND2 ? C : ND2) * H * W >= (1LL << 31)) {
    return cudaErrorInvalidValue;   // the kernel's offsets are 32-bit
  }
  const long long sms = sm_count(device);
  cudaError_t e;
  if (tile == 0) {
    e = fill_plan<T, 32>(H, W, device, p);
    if (e != cudaSuccess) return e;
    tile = 2LL * B * p->tiles >= 4 * sms * p->per_sm ? 32 : 16;
  }
  e = tile == 32 ? fill_plan<T, 32>(H, W, device, p)
                 : fill_plan<T, 16>(H, W, device, p);
  if (e != cudaSuccess) return e;
  if (split == 0) {
    const long long blocks = 2LL * B * p->tiles;
    split = 1;
    while (split * 2 <= BMAX_SPLIT && C / (split * 2) >= BMIN_CHANNELS &&
           2 * blocks * split < sms * p->per_sm) {
      split *= 2;
    }
  }
  p->split = split;
  p->cper = (C + split - 1) / split;
  return cudaSuccess;
}

template <typename T, int TW>
cudaError_t launch(const void* f1, const void* f2, const void* g, void* d1,
                   void* d2, int B, int C, int H, int W, const BwdPlan& p,
                   cudaStream_t stream) {
  using L = BTile<T, TW>;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(f1) | reinterpret_cast<uintptr_t>(f2) |
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(d1) |
      reinterpret_cast<uintptr_t>(d2);
  const int vec = (W % 4 == 0 && bits % (4 * sizeof(T)) == 0) ? 1 : 0;
  corr_bwd_kernel<T, TW><<<dim3(p.tiles, p.split, 2 * B),
                           dim3(L::QX, L::TR / BDR, BNZ), L::SMEM,
                           stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const T*>(g), static_cast<T*>(d1), static_cast<T*>(d2), C,
      H, W, p.tiles_x, p.cper, vec, 1.0f / C);
  return cudaGetLastError();
}

template <typename T>
int run(const void* f1, const void* f2, const void* g, void* d1, void* d2,
        int B, int C, int H, int W, int tile, int split, int device,
        cudaStream_t stream) {
  BwdPlan p;
  cudaError_t e = make_bwd_plan<T>(B, C, H, W, tile, split, device, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = p.tile_w == 32
          ? launch<T, 32>(f1, f2, g, d1, d2, B, C, H, W, p, stream)
          : launch<T, 16>(f1, f2, g, d1, d2, B, C, H, W, p, stream);
  return static_cast<int>(e);
}

}  // namespace

// f1, f2: (B, C, H, W) contiguous; g: (B, 81, H, W) contiguous; d1, d2:
// (B, C, H, W) contiguous, all of one dtype (0 = float32, 1 = bfloat16) on
// `device`.  md must be 4.  tile and split are 0 (the plan chooses) or a
// tile width of 16 or 32 and 1..64 channel splits.  Launches on `stream` of
// `device` and returns the cudaError_t of the launch (cudaErrorInvalidValue
// for an unsupported md, dtype, tile, split or size).
extern "C" int corr_bwd(const void* f1, const void* f2, const void* g,
                        void* d1, void* d2, int B, int C, int H, int W,
                        int md, int dtype, int tile, int split, int device,
                        void* stream) {
  if (!shape_ok(B, C, H, W, md) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? run<float>(f1, f2, g, d1, d2, B, C, H, W, tile, split, device, s)
      : run<__nv_bfloat16>(f1, f2, g, d1, d2, B, C, H, W, tile, split,
                           device, s);
}

// The plan corr_bwd would follow, without launching: plan[0..8] = tile
// height, tile width, tiles per batch item, channel splits, channels per
// split, threads per block, dynamic shared memory in bytes, blocks of that
// instantiation an SM holds (the occupancy API's answer), registers a
// thread.  Returns 0, or the error corr_bwd would return.
extern "C" int corr_bwd_plan(int B, int C, int H, int W, int md, int dtype,
                             int tile, int split, int device, int* plan) {
  if (!shape_ok(B, C, H, W, md) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  BwdPlan p;
  const cudaError_t e =
      dtype == 0
          ? make_bwd_plan<float>(B, C, H, W, tile, split, device, &p)
          : make_bwd_plan<__nv_bfloat16>(B, C, H, W, tile, split, device, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  plan[0] = p.tile_h; plan[1] = p.tile_w; plan[2] = p.tiles;
  plan[3] = p.split; plan[4] = p.cper; plan[5] = p.threads;
  plan[6] = p.smem; plan[7] = p.per_sm; plan[8] = p.regs;
  return 0;
}
