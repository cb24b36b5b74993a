// The integer-op probes: each stage of scripts/probe_intops_tpu.py:43 (the
// pallas_call of its run()) and scripts/probe_intcell_fix_tpu.py:41 as a
// kernel instance of its own, each output f32 and held bit for bit to the
// scripts' numpy truth (probes/intops.py).
//
// The question the TPU scripts asked: which of the in-kernel int ops behind
// the packed-key membership test (f32<->i32 bitcast, arithmetic shifts and
// masks, the truncating f32->i32 convert, shifts on a (64, 1) column, the
// (64, 1) + (1, 128) broadcast) a compiler gets wrong. On the card each
// stage is one thread per output element, so the (64, 1) column and the
// broadcast are an index choice: what a stage checks is the arithmetic.
//
// Stages (the scripts' names and truths):
//   1 t1  bitcast, (v >> 10) & 1023                    x f32[8, 128]
//   2 t2  trunc f32 -> i32 (negatives too)             x f32[8, 128]
//   3 t3  row key ix + (iy << s) + (iz << 2s), s = 10  rc f32[64, 3]
//   4 t4  membership digit test, enc (1, 128) + rkey (64, 1)
//   5 a   convert at (64, 1)      6 b  iy << 10        7 c  iy * 1024
//   8 d   t3's key computed per element ("broadcast first")
//   9 e   the row key by multiplies
//  10 f   membership with the multiply-built key from cells f32[64, 3]
// Stage 3 takes the shift s as an argument: the smoke run's planted control
// launches it with s = 9, which must disagree with the truth.
//
// What bounds it on the H100: the launch (at most 40 KB moved).
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kBias = 1 + (1 << 10) + (1 << 20);

// left shift of a possibly negative int as two's complement
__device__ __forceinline__ int shl(int v, int s) {
  return (int)((unsigned)v << s);
}

__device__ __forceinline__ bool digits_within_2(int vj, int rk) {
  const int t = (int)((unsigned)vj + (unsigned)rk);
  return vj >= 0 && (t & 1023) <= 2 && ((t >> 10) & 1023) <= 2 &&
         ((t >> 20) & 1023) <= 2;
}

// a, b: the stage's inputs (see above); one block per output row.
template <int kStage>
__global__ void intops_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ out, int shift) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const int k = row * kLanes + lane;
  // the (64, 3) inputs' columns, truncated toward zero
  const auto col = [&](int c) { return (int)a[3 * row + c]; };
  float o = 0.f;
  if constexpr (kStage == 1) {
    o = (float)((__float_as_int(a[k]) >> 10) & 1023);
  } else if constexpr (kStage == 2) {
    o = (float)(int)a[k];
  } else if constexpr (kStage == 3) {
    o = (float)(col(0) + shl(col(1), shift) + shl(col(2), 2 * shift));
  } else if constexpr (kStage == 4) {
    o = digits_within_2(__float_as_int(a[lane]), __float_as_int(b[row]))
            ? 1.f : 0.f;
  } else if constexpr (kStage == 5) {
    o = (float)col(0);
  } else if constexpr (kStage == 6) {
    o = (float)shl(col(1), 10);
  } else if constexpr (kStage == 7) {
    o = (float)(col(1) * 1024);
  } else if constexpr (kStage == 8) {
    o = (float)(col(0) + shl(col(1), 10) + shl(col(2), 20));
  } else if constexpr (kStage == 9) {
    o = (float)(col(0) + col(1) * (1 << 10) + col(2) * (1 << 20));
  } else {
    const int ix = (int)b[3 * row], iy = (int)b[3 * row + 1],
              iz = (int)b[3 * row + 2];
    const int rk = kBias - (ix + iy * (1 << 10) + iz * (1 << 20));
    o = digits_within_2(__float_as_int(a[lane]), rk) ? 1.f : 0.f;
  }
  out[k] = o;
}

using StageKernel = void (*)(const float*, const float*, float*, int);

}  // namespace

// stage 1-10 as above; rows: the output's rows (8 for stages 1 and 2, else
// 64); shift: stage 3's shift (10 reproduces the script).
extern "C" int probe_intops(int stage, const float* a, const float* b,
                            float* out, int rows, int shift, void* stream) {
  static const StageKernel stages[10] = {
      intops_kernel<1>, intops_kernel<2>, intops_kernel<3>, intops_kernel<4>,
      intops_kernel<5>, intops_kernel<6>, intops_kernel<7>, intops_kernel<8>,
      intops_kernel<9>, intops_kernel<10>};
  if (stage < 1 || stage > 10) return (int)cudaErrorInvalidValue;
  stages[stage - 1]<<<rows, kLanes, 0, (cudaStream_t)stream>>>(a, b, out,
                                                                 shift);
  return (int)cudaGetLastError();
}
