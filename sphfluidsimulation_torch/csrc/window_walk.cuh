// The window walk and the pair function of K2 (fused_substep.cu) and K3
// (forces.cu): one thread per sorted row, which walks its 27-cell window in
// global memory in the order of for_each_candidate (z outer, y, x, then
// slot order, which is ascending sorted index), as ranges of consecutive
// slots, and sums the pair terms of add_pair_pj. The j-side pressure and
// guarded 1/rho come precomputed (pj, sph_kernels.pj_cols).
#pragma once

#include "sph_common.cuh"

namespace sph {

// The pair terms of add_pair with no IEEE division: press_j and the guarded
// reciprocal inv_j = [rho_j > eps] / rho_j come precomputed (the formulas of
// sph_kernels.pj_cols and pallas_sph.py::_pj_cols), 1/|r| is rsqrt under the
// `valid` select and the pressure coefficient is (p_i + p_j) * 0.5 * inv_j,
// as in the JAX kernel (pallas_sph.py:1213-1233). |r| stays an IEEE sqrt,
// because h - |r| cancels at the support edge. The extension terms use one
// correctly rounded reciprocal of rho_i + rho_j, which gives both 2 / (rho_i
// + rho_j) and 1 / rho_bar (rho_bar = (rho_i + rho_j) / 2 exactly), and one
// of r^2 + 0.01 h^2.
//
// Every gate is a whole-term select, as in the JAX kernel, never a product
// with a 0/1 mask: `use` (the pair is a candidate, j != i) keeps or drops
// all the terms, the rho_j > eps guard (on rho_j itself) the pressure and
// viscosity terms only. With no branch, the compiler can overlap two calls.
template <bool kExt>
__device__ __forceinline__ void add_pair_pj(const Scalars& s,
                                            const Particle& p, float press_i,
                                            float4 qa, float4 qb,
                                            float press_j, float inv_j,
                                            bool use, PairSums& acc) {
  // qa = (x, y, z, vx), qb = (vy, vz, rho, -)
  const bool pv = use && qb.z > kEps;
  const float dx = p.px - qa.x, dy = p.py - qa.y, dz = p.pz - qa.z;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float abs_r = sqrtf(r2);
  const float diff_r = s.h - abs_r;
  const bool ok = diff_r > kEps && abs_r > kEps;
  const float g =
      ok ? s.c_grad * (diff_r * diff_r * diff_r) * rsqrtf(fmaxf(r2, 1e-30f))
         : 0.f;
  const float dvx = qa.w - p.vx, dvy = qb.x - p.vy, dvz = qb.y - p.vz;
  const float gwv = abs_r < s.h ? s.c_grad * diff_r : 0.f;
  const float pc = (press_i + press_j) * 0.5f * inv_j;
  const float vc = gwv * inv_j;
  acc.px = pv ? acc.px + pc * (g * dx) : acc.px;
  acc.py = pv ? acc.py + pc * (g * dy) : acc.py;
  acc.pz = pv ? acc.pz + pc * (g * dz) : acc.pz;
  acc.vx = pv ? acc.vx + vc * dvx : acc.vx;
  acc.vy = pv ? acc.vy + vc * dvy : acc.vy;
  acc.vz = pv ? acc.vz + vc * dvz : acc.vz;
  if constexpr (kExt) {
    const float d2 = s.h2 - r2;
    const float w6 = d2 > 0.f ? s.c_poly6 * d2 * d2 * d2 : 0.f;
    const float denom = p.rho + qb.z;
    const float two_over = 2.f * __frcp_rn(denom);   // 2 / denom = 1 / rho_bar
    const float xc = denom > kEps ? two_over * w6 : 0.f;
    acc.xx = use ? acc.xx + xc * dvx : acc.xx;
    acc.xy = use ? acc.xy + xc * dvy : acc.xy;
    acc.xz = use ? acc.xz + xc * dvz : acc.xz;
    const float vr = -(dvx * dx) - dvy * dy - dvz * dz;
    const float mu = s.h * vr * __frcp_rn(r2 + 0.01f * s.h2);
    const bool pi_ok = vr < 0.f && 0.5f * denom > kEps;
    const float ac = (pi_ok ? -s.cs * mu * two_over : 0.f) * g;
    acc.ax = use ? acc.ax + ac * dx : acc.ax;
    acc.ay = use ? acc.ay + ac * dy : acc.ay;
    acc.az = use ? acc.az + ac * dz : acc.az;
  }
}

// The inputs of K2 and K3, as one kernel parameter: rows f32[N, 8], pj
// f32[N, 2] (press_j, [rho_j > eps] / rho_j), the scalar block and the
// frame's start, raw and occ.
struct WalkArgs {
  const float4* __restrict__ rows;
  const float2* __restrict__ pj;
  const int* __restrict__ start;
  const int* __restrict__ raw;
  const uint8_t* __restrict__ occ;
  const float* __restrict__ scal;
  int n, r, cap;
};

// Row i's pair sums (j == i skipped), in the order of for_each_candidate
// (ascending sorted index). The walk runs over ranges of consecutive slots:
// a line's cells are consecutive in sorted order, so a cell whose run the
// capacity does not cut continues into the next one, and a line without a
// cut cell is one range. One loop takes the row's ranges in turn, two slots
// a step without the extensions, each gated by a select: j in the bucket,
// its raw cell in the window (a raw cell among the line's window cells
// passes without decoding), j != i.
template <bool kExt>
__device__ __forceinline__ void window_pair_sums(const Scalars& s,
                                                 const Particle& p, int i,
                                                 const WalkArgs& a,
                                                 PairSums& acc) {
  const int r = a.r, cap = a.cap;
  const int cx = fresh_coord(p.px, r);
  const int cy = fresh_coord(p.py, r);
  const int cz = fresh_coord(p.pz, r);
  const int x0 = max(cx - 1, 0), x1 = min(cx + 1, r - 1);
  const int y0 = max(cy - 1, 0), y1 = min(cy + 1, r - 1);
  const int z0 = max(cz - 1, 0), z1 = min(cz + 1, r - 1);
  if (x0 > x1 || y0 > y1 || z0 > z1) return;
  const float press_i = s.gas_k * (p.rho - s.rho0);
  int x = x0, y = y0, z = z0, line = (z0 * r + y0) * r;
  bool more = true;
  int q = 0, e = 0, range_line = line;
  const auto member = [&](int j) {
    if (!__ldg(a.occ + j) || j == i) return false;
    const int rj = __ldg(a.raw + j);
    return (unsigned)(rj - range_line - x0) <= (unsigned)(x1 - x0)
           || raw_near(rj, cx, cy, cz, r);
  };
  while (true) {
    while (q >= e && more) {              // the next range of slots
      range_line = line;
      q = __ldg(a.start + line + x);
      int end = __ldg(a.start + line + x + 1);
      e = cap >= 0 ? min(end, q + cap) : end;
      while (e == end && x < x1) {        // the cell is not cut: go on
        ++x;
        end = __ldg(a.start + line + x + 1);
        e = cap >= 0 ? min(end, e + cap) : end;
      }
      if (++x > x1) {
        x = x0;
        if (++y > y1) {
          y = y0;
          more = ++z <= z1;
        }
        line = (z * r + y) * r;
      }
    }
    if (q >= e) break;
    const float2 pj1 = __ldg(a.pj + q);
    add_pair_pj<kExt>(s, p, press_i, __ldg(a.rows + 2 * q),
                      __ldg(a.rows + 2 * q + 1), pj1.x, pj1.y, member(q), acc);
    if constexpr (!kExt) {
      // two slots a step without the extensions (with them, the second
      // pair's registers cost more occupancy than the overlap gains)
      const int q2 = min(q + 1, e - 1);
      const float2 pj2 = __ldg(a.pj + q2);
      add_pair_pj<kExt>(s, p, press_i, __ldg(a.rows + 2 * q2),
                        __ldg(a.rows + 2 * q2 + 1), pj2.x, pj2.y,
                        q2 > q && member(q2), acc);
      ++q;
    }
    ++q;
  }
}

// The body of K2 and K3: the pair sums of row blockIdx.x * blockDim.x +
// threadIdx.x, passed to done(s, p, i, acc).
template <bool kExt, typename Done>
__device__ __forceinline__ void walk_row(const WalkArgs& a, Done&& done) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Scalars s = load_scalars(a.scal);
  const Particle p = load_particle(a.rows, i);
  PairSums acc;
  window_pair_sums<kExt>(s, p, i, a, acc);
  done(s, p, i, acc);
}

// Launches K2 or K3, one thread per row in blocks of kBlock, on stream st.
template <typename Kernel>
inline int launch_walk(Kernel kernel, const WalkArgs& a, float4* out,
                       cudaStream_t st) {
  if (a.n > 0)
    kernel<<<(a.n + kBlock - 1) / kBlock, kBlock, 0, st>>>(a, out);
  return (int)cudaGetLastError();
}

}  // namespace sph
