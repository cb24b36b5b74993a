// The tensor-core probe of the force pair: can the six per-pair accumulates
// (and the Gram form of r^2) move onto the matrix unit, what does it cost in
// time, and what in accuracy?
//
// Replaces the TPU probe kernel scripts/probe_mxu_tpu.py:217 (build_call's
// pallas_call of kernel(variant, rows_n, tpg, ...)), on the script's inputs
// (probes/mxu.py::synth_inputs): tiles of 64 or 128 rows, each walking its
// flat list of fcnt 128-candidate chunks of a window f32[97, 8, 128] (entry
// min(k, 15) for k < fcnt, as the script's loop reads it), with the real
// membership gate (the row's fresh cell against the candidate's cell).
//   D  direct pair, the six sums accumulated by the FP32 units
//   G  D with r^2 = |x_i|^2 + |x_j|^2 - 2 x_i.x_j, the Gram term on the
//      tensor cores (k = 3 padded to 8)
//   A  direct r^2; the accumulates as two products on the tensor cores,
//      Fp[rows, 4] += PC[rows, 128] [x_j y_j z_j 1] and Fv += VC [v_j 1],
//      finished as f = x_i sum(pc) - (PC X_j) and v = (VC V_j) - v_i sum(vc)
//   M  G's r^2 and A's accumulates
// (D128, A128, M128: the same with 128-row tiles.)
//
// The tensor-core instruction is mma.sync.aligned.m16n8k8.row.col.f32.tf32.
// tf32.f32 (inline PTX; wgmma is a later design's). Each warp owns 16 rows.
// For each 8-candidate slice of a chunk, thread (g = lane / 4, t = lane % 4)
// computes the pair for rows g and g + 8 and candidates 2t and 2t + 1: the
// four values of its A fragment (rows g, g + 8; columns t, t + 4, which the
// B operand maps to candidates 2t, 2t + 1: the product sums over k, so the
// order of k is free), and the four values of the Gram product's C fragment
// (rows g, g + 8; columns 2t, 2t + 1), so both forms meet in registers. The
// B operands, the ones-augmented [x_j y_j z_j 1 0 0 0 0] and [v_j 1 0 0 0 0]
// (n padded to 8), are staged in shared memory with the chunk, each chunk
// once per block. Inputs are converted with cvt.rna.tf32.f32: kPrec 1 is one
// pass on the rounded inputs (the analogue of the TPU's default one-pass f32
// dot); kPrec 3 splits each input into hi + lo and sums lo*hi, hi*lo, hi*hi
// (the analogue of Precision.HIGHEST). D, and D's sums in G, use no tensor
// core; D has one instance.
//
// What bounds it on the H100: the FP32 pair arithmetic (about 40 operations
// a candidate, every candidate of a chunk computed, as in the script) and,
// for A and M, the tensor-core products; the accumulate form trades the six
// FP32 accumulates a pair (12 operations) for 16 dense TF32 multiply-adds a
// pair (48 with kPrec 3).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kFeat = 8;
constexpr int kMaxC = 16;
constexpr int kR = 47;
// the planted controls (fault), each a wrong kernel its rule must fail:
// the augmenting ones column zeroed (A, M), the tile's first chunk dropped,
// the velocity accumulate negated (the product VC V_j in A and M, the sums
// of vc (v_j - v_i) in D and G)
constexpr int kZeroOnes = 1, kDropChunk = 2, kNegateVc = 3;

// x rounded to tf32 (nearest, ties away from zero), low 13 bits zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// d += a b on one warp: a 16x8 (row), b 8x8 (col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b from f32 fragments: one tf32 pass (kPrec 1), or the hi/lo split
// with its three products, the small ones first (kPrec 3)
template <int kPrec>
__device__ __forceinline__ void mma_f32(float (&d)[4], const float (&a)[4],
                                        const float (&b)[2]) {
  uint32_t ah[4], bh[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) ah[k] = to_tf32(a[k]);
#pragma unroll
  for (int k = 0; k < 2; ++k) bh[k] = to_tf32(b[k]);
  if constexpr (kPrec == 3) {
    uint32_t al[4], bl[2];
#pragma unroll
    for (int k = 0; k < 4; ++k) al[k] = to_tf32(a[k] - __uint_as_float(ah[k]));
#pragma unroll
    for (int k = 0; k < 2; ++k) bl[k] = to_tf32(b[k] - __uint_as_float(bh[k]));
    mma_tf32(d, al, bh);
    mma_tf32(d, ah, bl);
  }
  mma_tf32(d, ah, bh);
}

struct Args {
  const float* __restrict__ win;    // f32[w_rows, 8, 128]
  const int* __restrict__ flat;     // i32[T, 16]
  const int* __restrict__ fcnt;     // i32[T]
  const float* __restrict__ rows;   // f32[T, rows_n, 8]
  float* __restrict__ out;          // f32[T, rows_n, 8]
  int fault;                        // a planted control (probe_mxu), or 0
};

// One row's values: position, velocity, pressure, fresh cell, |x|^2.
struct Row {
  float x, y, z, vx, vy, vz, press, fx, fy, fz, nrm;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ p) {
  Row w;
  w.x = p[0];
  w.y = p[1];
  w.z = p[2];
  w.vx = p[3];
  w.vy = p[4];
  w.vz = p[5];
  w.press = 150.f * (p[6] - 1.5f);
  w.fx = (float)(int)(w.x * (float)(kR - 1));
  w.fy = (float)(int)(w.y * (float)(kR - 1));
  w.fz = (float)(int)(w.z * (float)(kR - 1));
  w.nrm = __fadd_rn(__fadd_rn(__fmul_rn(w.x, w.x), __fmul_rn(w.y, w.y)),
                    __fmul_rn(w.z, w.z));
  return w;
}

// kMode 0 D, 1 G, 2 A, 3 M; kRowsN 64 or 128 (kRowsN / 16 warps, one tile
// per block).
template <int kRowsN, int kMode, int kPrec>
__global__ void __launch_bounds__(kRowsN * 2) mxu_kernel(Args a) {
  constexpr bool kGram = kMode == 1 || kMode == 3;
  constexpr bool kMma = kMode >= 2;
  __shared__ __align__(16) float chunk[kFeat][kLanes];
  __shared__ __align__(16) float bx[kLanes][8];
  __shared__ __align__(16) float bv[kLanes][8];

  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* __restrict__ rows = a.rows + (size_t)tile * kRowsN * kFeat;
  const Row w[2] = {load_row(rows + (warp * 16 + g) * kFeat),
                    load_row(rows + (warp * 16 + g + 8) * kFeat)};
  const float h = (float)(1.0 / (kR - 1));
  const float h2 = h * h;
  const float cgh6 = (float)(45.0 / 3.14159265358979323846) / (h2 * h2 * h2);

  float acc[2][6] = {};                 // D, G: the six sums of each row
  float cp[4] = {}, cv[4] = {};         // A, M: the C fragments
  // the Gram product's A fragment: coordinate t of rows g, g + 8 (k < 3)
  const auto coord = [&](const Row& p) {
    return t == 0 ? p.x : t == 1 ? p.y : t == 2 ? p.z : 0.f;
  };
  const float xi_t[2] = {coord(w[0]), coord(w[1])};

  const int n_chunks = __ldg(a.fcnt + tile);
#pragma unroll 1
  for (int k = 0; k < n_chunks; ++k) {
    const int e = __ldg(a.flat + tile * kMaxC + min(k, kMaxC - 1));
    // the same for the whole block
    if (e < 0 || (a.fault == kDropChunk && k == 0)) continue;
    __syncthreads();                    // the last chunk's readers are done
    if (threadIdx.x < kLanes) {
      const int c = threadIdx.x;
      const float* __restrict__ src = a.win + (size_t)e * kFeat * kLanes + c;
      float f[kFeat];
#pragma unroll
      for (int q = 0; q < kFeat; ++q) {
        f[q] = __ldg(src + q * kLanes);
        chunk[q][c] = f[q];
      }
      if constexpr (kMma) {
        const float ones = a.fault == kZeroOnes ? 0.f : 1.f;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        float4* const x4 = reinterpret_cast<float4*>(bx[c]);
        float4* const v4 = reinterpret_cast<float4*>(bv[c]);
        x4[0] = make_float4(f[0], f[1], f[2], ones);
        x4[1] = zero;
        v4[0] = make_float4(f[4], f[5], f[6], ones);
        v4[1] = zero;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int s = 0; s < kLanes / 8; ++s) {
      const int c0 = s * 8 + 2 * t;   // this thread's candidates c0, c0 + 1
      // the Gram dot of (g, c0), (g, c0 + 1), (g + 8, c0), (g + 8, c0 + 1)
      float g2[4];
      if constexpr (kGram) {
        const float ga[4] = {xi_t[0], xi_t[1], 0.f, 0.f};
        const float gb[2] = {t < 3 ? chunk[t][s * 8 + g] : 0.f, 0.f};
        g2[0] = g2[1] = g2[2] = g2[3] = 0.f;
        mma_f32<kPrec>(g2, ga, gb);
      }
      const float2 xj = *reinterpret_cast<const float2*>(&chunk[0][c0]);
      const float2 yj = *reinterpret_cast<const float2*>(&chunk[1][c0]);
      const float2 zj = *reinterpret_cast<const float2*>(&chunk[2][c0]);
      const float2 cj = *reinterpret_cast<const float2*>(&chunk[3][c0]);
      const float2 vxj = *reinterpret_cast<const float2*>(&chunk[4][c0]);
      const float2 vyj = *reinterpret_cast<const float2*>(&chunk[5][c0]);
      const float2 vzj = *reinterpret_cast<const float2*>(&chunk[6][c0]);
      const float2 rj = *reinterpret_cast<const float2*>(&chunk[7][c0]);
      // the A fragments: (g, c0) (g + 8, c0) (g, c0 + 1) (g + 8, c0 + 1)
      float pa[4], va[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int q = m & 1, cc = m >> 1;      // row g + 8q, candidate c0 + cc
        const Row& p = w[q];
        const float x = cc ? xj.y : xj.x, y = cc ? yj.y : yj.x,
                    z = cc ? zj.y : zj.x, cid = cc ? cj.y : cj.x,
                    rho_j = cc ? rj.y : rj.x;
        const float cz = floorf((cid + 0.5f) / (float)(kR * kR));
        const float rem = cid - cz * (float)(kR * kR);
        const float cy = floorf((rem + 0.5f) / (float)kR);
        const float cx = rem - cy * (float)kR;
        const bool gate = cid >= 0.f && fabsf(cx - p.fx) <= 1.f &&
                          fabsf(cy - p.fy) <= 1.f && fabsf(cz - p.fz) <= 1.f;
        const float dx = p.x - x, dy = p.y - y, dz = p.z - z;
        float r2;
        if constexpr (kGram) {
          const float nrm_j = __fadd_rn(__fadd_rn(__fmul_rn(x, x),
                                                  __fmul_rn(y, y)),
                                        __fmul_rn(z, z));
          r2 = fmaxf(__fsub_rn(__fadd_rn(p.nrm, nrm_j),
                               __fmul_rn(2.f, g2[2 * q + cc])), 0.f);
        } else {
          r2 = dx * dx + dy * dy + dz * dz;
        }
        const bool rho_ok = rho_j > 1e-6f;
        const float inv_rho = (rho_ok ? 1.f : 0.f) / (rho_ok ? rho_j : 1.f);
        const float abs_r = sqrtf(r2);
        const float rs = rsqrtf(fmaxf(r2, 1e-30f));
        const float diff = h - abs_r;
        const bool valid = diff > 1e-6f && abs_r > 1e-6f;
        const float gwp = valid ? cgh6 * diff * diff * diff * rs : 0.f;
        const float gwv = abs_r < h ? cgh6 * diff : 0.f;
        const float press_j = 150.f * (rho_j - 1.5f);
        const float pc =
            gate ? (p.press + press_j) * 0.5f * inv_rho * gwp : 0.f;
        const float vc = gate ? gwv * inv_rho : 0.f;
        if constexpr (kMma) {
          pa[q + 2 * cc] = pc;
          va[q + 2 * cc] = vc;
        } else {
          acc[q][0] += pc * dx;
          acc[q][1] += pc * dy;
          acc[q][2] += pc * dz;
          acc[q][3] += vc * ((cc ? vxj.y : vxj.x) - p.vx);
          acc[q][4] += vc * ((cc ? vyj.y : vyj.x) - p.vy);
          acc[q][5] += vc * ((cc ? vzj.y : vzj.x) - p.vz);
        }
      }
      if constexpr (kMma) {
        const float b_x[2] = {bx[c0][g], bx[c0 + 1][g]};
        const float b_v[2] = {bv[c0][g], bv[c0 + 1][g]};
        mma_f32<kPrec>(cp, pa, b_x);
        mma_f32<kPrec>(cv, va, b_v);
      }
    }
  }

  const unsigned full = 0xffffffffu;
  const float vsign = a.fault == kNegateVc ? -1.f : 1.f;
  float sums[2][6];
  if constexpr (kMma) {
    // cp: (g, n = 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1); columns
    // 0-2 are (PC X_j), column 3 is sum(pc): t = 0 holds 0-1, t = 1 holds 2-3
    float up_p[4], up_v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      up_p[k] = __shfl_down_sync(full, cp[k], 1);
      up_v[k] = __shfl_down_sync(full, cv[k], 1);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const Row& p = w[q];
      const float px = cp[2 * q], py = cp[2 * q + 1], pz = up_p[2 * q],
                  spc = up_p[2 * q + 1];
      const float vx = vsign * cv[2 * q], vy = vsign * cv[2 * q + 1],
                  vz = vsign * up_v[2 * q], svc = up_v[2 * q + 1];
      sums[q][0] = __fsub_rn(__fmul_rn(p.x, spc), px);
      sums[q][1] = __fsub_rn(__fmul_rn(p.y, spc), py);
      sums[q][2] = __fsub_rn(__fmul_rn(p.z, spc), pz);
      sums[q][3] = __fsub_rn(vx, __fmul_rn(p.vx, svc));
      sums[q][4] = __fsub_rn(vy, __fmul_rn(p.vy, svc));
      sums[q][5] = __fsub_rn(vz, __fmul_rn(p.vz, svc));
    }
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        float v = k < 3 ? acc[q][k] : vsign * acc[q][k];
        v += __shfl_xor_sync(full, v, 1);
        v += __shfl_xor_sync(full, v, 2);
        sums[q][k] = v;
      }
    }
  }
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float4* __restrict__ o = reinterpret_cast<float4*>(
          a.out + ((size_t)tile * kRowsN + warp * 16 + g + 8 * q) * kFeat);
      o[0] = make_float4(sums[q][0], sums[q][1], sums[q][2], sums[q][3]);
      o[1] = make_float4(sums[q][4], sums[q][5], 0.f, 0.f);
    }
  }
}

using Kernel = void (*)(Args);

template <int kRowsN>
Kernel pick(int mode, int prec) {
  switch (mode * 4 + prec) {
    case 0 * 4 + 1: return mxu_kernel<kRowsN, 0, 1>;
    case 1 * 4 + 1: return mxu_kernel<kRowsN, 1, 1>;
    case 1 * 4 + 3: return mxu_kernel<kRowsN, 1, 3>;
    case 2 * 4 + 1: return mxu_kernel<kRowsN, 2, 1>;
    case 2 * 4 + 3: return mxu_kernel<kRowsN, 2, 3>;
    case 3 * 4 + 1: return mxu_kernel<kRowsN, 3, 1>;
    case 3 * 4 + 3: return mxu_kernel<kRowsN, 3, 3>;
    default: return nullptr;
  }
}

}  // namespace

// mode 0 D, 1 G, 2 A, 3 M; prec 1 or 3 tf32 passes (D: 1); rows_n 64 or
// 128; fault: 0, or a planted control (kZeroOnes, kDropChunk, kNegateVc).
extern "C" int probe_mxu(int mode, int prec, const float* win, const int* flat,
                         const int* fcnt, const float* rows, float* out,
                         int n_tiles, int rows_n, int fault, void* stream) {
  const Kernel kernel = rows_n == 64    ? pick<64>(mode, prec)
                        : rows_n == 128 ? pick<128>(mode, prec)
                                        : nullptr;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (fault < 0 || fault > kNegateVc) return (int)cudaErrorInvalidValue;
  const Args a{win, flat, fcnt, rows, out, fault};
  if (n_tiles > 0)
    kernel<<<n_tiles, rows_n * 2, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
