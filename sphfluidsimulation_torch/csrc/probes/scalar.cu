// The per-tile scalar prologue probe: what does the scalar work of deriving
// a tile's walk in the kernel cost (9 table lookups, a <= 16-entry worklist,
// a walk addressed by it), beside a vector payload that costs almost
// nothing? It bears on K5's host-side span derivation (ops/compact.py).
//
// Replaces the TPU probe kernel scripts/probe_scalar_tpu.py:99 (build's
// pallas_call of kernel(variant, ...)), with its inputs: a sorted slice
// i32[2048] (copied into fast memory for every group of 16 tiles), spans
// i32[T, 2], the payload x f32[T, 8, 128]; out f32[T, 8, 128]:
//   S0  acc = x * 1.000001
//   S1  + 9 clamped lookups a tile: a = slc[lo + 7 line], b = slc[hi + 7 line
//       + 2], each made monotone, k0 = a / 128, k1 = min(ceil(b / 128),
//       k0 + 2); acc += k0(line 0) * 1e-30
//   S2  + the worklist: k0 .. k1 - 1 of each line (at most 2), at most 16
//       entries; acc += count * 1e-30
//   S3  + the walk instead: acc += x[group's tile e % 16] * 1e-30 for each
//       worklist entry e
//
// On the H100 a block is a group of 16 tiles, 16 warps, the slice in shared
// memory, each warp one tile: the prologue is warp-uniform scalar work that
// every lane repeats (the scalar core's work on the TPU), the worklist lives
// in shared memory (lane 0 writes it), and each lane owns 32 of the tile's
// 1024 payload values.
//
// What bounds it on the H100: the payload's bytes (the 16 MB read and the
// 16 MB written) for S0; S1-S3 add scalar latency chains a tile.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kTpg = 16;
constexpr int kMaxC = 16;
constexpr int kSlice = 2048;
constexpr int kTile = 8 * kLanes;
constexpr int kPer = kTile / 32;

template <int kVariant>
__global__ void __launch_bounds__(kTpg * 32)
scalar_kernel(const int* __restrict__ slc_in, const int* __restrict__ spans,
              const float* __restrict__ x, float* __restrict__ out) {
  __shared__ int slc[kSlice];
  __shared__ int wl[kTpg][kMaxC];
  for (int k = threadIdx.x; k < kSlice; k += blockDim.x) slc[k] = slc_in[k];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = blockIdx.x;
  const int tile = group * kTpg + warp;
  const float* __restrict__ xt = x + (size_t)tile * kTile;
  float acc[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) acc[m] = xt[lane + 32 * m] * 1.000001f;

  if constexpr (kVariant >= 1) {
    const int lo = __ldg(spans + 2 * tile), hi = __ldg(spans + 2 * tile + 1);
    int prev_b = 0, k0s[9], k1s[9];
#pragma unroll
    for (int line = 0; line < 9; ++line) {
      const int qa = min(max(lo + line * 7, 0), kSlice - 1);
      const int qb = min(max(hi + line * 7 + 2, 0), kSlice - 1);
      int a = slc[qa], b = slc[qb];
      a = max(a, prev_b);
      b = max(b, a);
      prev_b = b;
      k0s[line] = a / kLanes;
      k1s[line] = min((b + kLanes - 1) / kLanes, k0s[line] + 2);
    }
    int cnt = 0;
    if constexpr (kVariant >= 2) {
#pragma unroll
      for (int line = 0; line < 9; ++line) {
#pragma unroll 1
        for (int i = 0; i < min(k1s[line] - k0s[line], 2); ++i) {
          if (lane == 0) wl[warp][min(cnt, kMaxC - 1)] = k0s[line] + i;
          ++cnt;
        }
      }
      __syncwarp();
    }
    if constexpr (kVariant >= 3) {
#pragma unroll 1
      for (int it = 0; it < min(cnt, kMaxC); ++it) {
        const int e = wl[warp][min(it, kMaxC - 1)];
        const float* __restrict__ blk =
            x + ((size_t)group * kTpg + e % kTpg) * kTile;
#pragma unroll
        for (int m = 0; m < kPer; ++m)
          acc[m] = acc[m] + blk[lane + 32 * m] * 1e-30f;
      }
    } else {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        acc[m] = acc[m] + (float)k0s[0] * 1e-30f;
        if constexpr (kVariant >= 2) acc[m] = acc[m] + (float)cnt * 1e-30f;
      }
    }
  }
  float* __restrict__ ot = out + (size_t)tile * kTile;
#pragma unroll
  for (int m = 0; m < kPer; ++m) ot[lane + 32 * m] = acc[m];
}

}  // namespace

// variant 0-3: S0-S3 over n_tiles tiles (a multiple of 16) of x f32[n_tiles,
// 8, 128], with the slice i32[2048] and spans i32[n_tiles, 2].
extern "C" int probe_scalar(int variant, const int* slc_in, const int* spans,
                            const float* x, float* out, int n_tiles,
                            void* stream) {
  using Kernel = void (*)(const int*, const int*, const float*, float*);
  static const Kernel kernels[4] = {scalar_kernel<0>, scalar_kernel<1>,
                                    scalar_kernel<2>, scalar_kernel<3>};
  if (variant < 0 || variant > 3 || n_tiles % kTpg != 0)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0)
    kernels[variant]<<<n_tiles / kTpg, kTpg * 32, 0, (cudaStream_t)stream>>>(
        slc_in, spans, x, out);
  return (int)cudaGetLastError();
}
