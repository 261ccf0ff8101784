// Row gather, out[i, :] = x[idx[i], :], for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of scripts/probe_gather.py (k_take,
// k_takealong and k_loop: three Mosaic formulations of one function, which
// probed whether a TPU kernel can gather rows at all).  Semantics are
// jnp.take(x, idx, axis=0)'s: an index in [-N, 0) counts from the end, and
// any other index outside [0, N) gives a row of NaN.  x is read only inside
// its N rows.
//
// Bound on this card: memory.  It computes nothing.  Counting each input
// once, it must read the distinct rows the indices name and the M*4 bytes of
// indices, and write M*C*4 bytes; at the probe's shape (N=2048, M=4096,
// C=128, float32; 1756 distinct rows) that is 3.0 MB, 0.90 us at the H100
// SXM's 3.35 TB/s.  At that shape one launch costs more than the copy.
//
// Design: one warp per output row, ROWS warps per block.  Lane 0 reads the
// row's index once and broadcasts it with a shuffle.  The warp then copies
// the row with 16-byte loads and stores (float4) when the row is 16-byte
// aligned in x and out (C a multiple of 4, aligned base pointers), so a warp
// moves 512 contiguous bytes per step; otherwise, and for no other reason,
// it copies 4-byte scalars.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int ROWS = 8;  // warps, and so output rows, per block

__global__ void __launch_bounds__(32 * ROWS)
row_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  float* __restrict__ out, int N, int M, int C, bool vec4) {
  const int lane = threadIdx.x;
  const long long row = (long long)blockIdx.x * ROWS + threadIdx.y;
  if (row >= M) return;
  int i = 0;
  if (lane == 0) i = __ldg(idx + row);
  i = __shfl_sync(0xffffffffu, i, 0);
  if (i < 0) i += N;                     // wrap [-N, 0)
  const bool inside = i >= 0 && i < N;   // else a NaN row
  float* o = out + row * C;
  if (vec4) {
    const int c4 = C / 4;
    float4* o4 = reinterpret_cast<float4*>(o);
    if (inside) {
      const float4* s4 = reinterpret_cast<const float4*>(x + (long long)i * C);
      for (int c = lane; c < c4; c += 32) o4[c] = __ldg(s4 + c);
    } else {
      const float nan = __int_as_float(0x7fc00000);
      const float4 nan4 = make_float4(nan, nan, nan, nan);
      for (int c = lane; c < c4; c += 32) o4[c] = nan4;
    }
  } else {
    if (inside) {
      const float* s = x + (long long)i * C;
      for (int c = lane; c < C; c += 32) o[c] = __ldg(s + c);
    } else {
      for (int c = lane; c < C; c += 32) o[c] = __int_as_float(0x7fc00000);
    }
  }
}

}  // namespace

// x: (N, C) float32 contiguous; idx: (M,) int32; out: (M, C) float32
// contiguous, all on `device`.  Launches on `stream` of `device` and returns
// the cudaError_t of the launch (cudaErrorInvalidValue for an empty problem).
extern "C" int row_gather(const void* x, const void* idx, void* out, int N,
                          int M, int C, int device, void* stream) {
  if (N < 1 || M < 1 || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const bool vec4 = C % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  const dim3 block(32, ROWS);
  const dim3 grid((M + ROWS - 1) / ROWS);
  row_gather_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), N, M, C, vec4);
  return static_cast<int>(cudaGetLastError());
}
