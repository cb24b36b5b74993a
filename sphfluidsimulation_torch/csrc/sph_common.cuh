// Shared device code of the sorted-frame SPH kernels (density.cu,
// fused_substep.cu, forces.cu, compact.cu): the scalar block, the fresh-cell
// computation, the pair terms that every walk sums (add_density for K1 and
// K5's density, add_pair_pj for K2, K3 and K5's force modes) and the fused
// integrate tail of K2 and K5. The window walk of K1-K3 is window_walk.cuh;
// K5's tile stream is in compact.cu.
//
// Layout (ops/frame.py): particles are sorted by anchor cell (the flat id of
// the clamped 3D cell); start[c] .. start[c+1] is cell c's run; occ[j] says
// j is in the reference bucket (raw id in range, rank in its run below the
// voxel capacity, so no slot past a run's first `capacity` slots is ever
// occupied); raw[j] is the reference's unchecked flat id, which equals the
// anchor id for every in-cube position.
//
// Tuning variants (ops/sph_kernels.py::SortedTuning, the JAX PallasTuning's
// semantic knobs) are compile-time switches, one library per set
// (ops/cuda_build.py): SPH_FACC (fuse_acc, default 1: pressure and
// viscosity in one accumulator triple, K2 and K3), SPH_KAHAN (kahan,
// default 0: compensated running sums, K1-K3) and SPH_BF16 (bf16, default
// 0: candidate values rounded to bfloat16, K2, K3 and K5's force modes). K5
// reads only SPH_BF16, as JAX's compact kernel has neither of the others.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SPH_FACC
#define SPH_FACC 1
#endif
#ifndef SPH_KAHAN
#define SPH_KAHAN 0
#endif
#ifndef SPH_BF16
#define SPH_BF16 0
#endif

namespace sph {

constexpr float kEps = 1e-6f;   // VelPos.compute:5
constexpr int kBlock = 128;
constexpr bool kFacc = SPH_FACC != 0;
constexpr bool kKahan = SPH_KAHAN != 0;
constexpr bool kBf16 = SPH_BF16 != 0;

// One running sum. With kKahan it carries its compensation c and adds a
// term as the JAX kernel's accum does (pallas_sph.py:1118-1130):
//   y = term - c;  t = s + y;  c = (t - s) - y;  s = t.
// nvcc does not reassociate without fast math, so (t - s) - y stays.
struct Acc {
  float s = 0.f, c = 0.f;
};

// Adds term to a when use, as a whole-term select (a failed gate leaves the
// sum, and its compensation, as they were).
__device__ __forceinline__ void accum(Acc& a, float term, bool use) {
  if constexpr (kKahan) {
    const float y = term - a.c;
    const float t = a.s + y;
    const float c = (t - a.s) - y;
    a.s = use ? t : a.s;
    a.c = use ? c : a.c;
  } else {
    a.s = use ? a.s + term : a.s;
  }
}

// The sum's value. With kKahan the compensation is folded in as the JAX
// kernel folds it, s + c (pallas_sph.py:1392-1394). With c = (t - s) - y
// the textbook correction would be s - c; the port computes what JAX
// computes (tests/test_torch_variants.py pins the sign).
__device__ __forceinline__ float total(const Acc& a) {
  if constexpr (kKahan) {
    return a.s + a.c;
  } else {
    return a.s;
  }
}

// x rounded to bfloat16 and back, as JAX's astype(bfloat16) rounds
// (pallas_sph.py::_pack_pair_bf16): to nearest, ties to even, subnormals
// and infinities kept, a NaN made the quiet NaN of its sign. Integer
// arithmetic on the bits, as ops/sph_kernels.py::bf16_round does it.
__device__ __forceinline__ float bf16_round(float x) {
  const unsigned u = __float_as_uint(x);
  const unsigned r = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  return __uint_as_float((u & 0x7fffffffu) > 0x7f800000u
                             ? (u & 0x80000000u) | 0x7fc00000u
                             : r);
}

// Scalar block written by ops/sph_kernels.py::scal_block (N_SCAL lanes, in
// this order; the two must change together).
struct Scalars {
  float h, h2, c_poly6, c_grad, mass, gas_k, rho0, visc, stiff, damping,
      grav_y, dt, xsph, alpha_visc, cs;
};

__device__ __forceinline__ Scalars load_scalars(const float* __restrict__ s) {
  return Scalars{__ldg(s + 0),  __ldg(s + 1),  __ldg(s + 2),  __ldg(s + 3),
                 __ldg(s + 4),  __ldg(s + 5),  __ldg(s + 6),  __ldg(s + 7),
                 __ldg(s + 8),  __ldg(s + 9),  __ldg(s + 10), __ldg(s + 11),
                 __ldg(s + 12), __ldg(s + 13), __ldg(s + 14)};
}

// One particle of the rows state f32[N, 8] = (x, y, z, vx, vy, vz, rho,
// nan_count): two float4 loads.
struct Particle {
  float px, py, pz, vx, vy, vz, rho, aux;
};

__device__ __forceinline__ Particle load_particle(
    const float4* __restrict__ rows, int i) {
  const float4 a = __ldg(rows + 2 * i);
  const float4 b = __ldg(rows + 2 * i + 1);
  return Particle{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// Fresh cell coordinate trunc(p * (R-1)) (VelPos.compute:58). The float to
// int conversion rounds toward zero, saturates and maps NaN to 0, as XLA's
// and ops/sph_math.py::trunc_i32 do. The clamp to [-2, R+1] only moves
// cells whose whole window lies outside the grid.
__device__ __forceinline__ int fresh_coord(float p, int r) {
  const int c = (int)(p * (float)(r - 1));
  return min(max(c, -2), r + 1);
}

// j's raw cell, decoded, within Chebyshev distance 1 of (cx, cy, cz).
__device__ __forceinline__ bool raw_near(int raw, int cx, int cy, int cz,
                                         int r) {
  const int rr = r * r;
  const int z = raw / rr;
  const int rem = raw - z * rr;
  const int y = rem / r;
  const int x = rem - y * r;
  return abs(x - cx) <= 1 && abs(y - cy) <= 1 && abs(z - cz) <= 1;
}

// Adds candidate (qx, qy, qz)'s poly6 weight to the density sum of the
// particle at (px, py, pz) when `use` (Density.compute:42-54), as a
// whole-term select; the mass is applied after the walk.
__device__ __forceinline__ void add_density(const Scalars& s, float px,
                                            float py, float pz, float qx,
                                            float qy, float qz, bool use,
                                            Acc& acc) {
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float d = s.h2 - r2;
  accum(acc, s.c_poly6 * d * d * d, use && d > 0.f);
}

// Raw force-side pair sums of one particle: pressure, viscosity, and the
// XSPH and Monaghan artificial-viscosity sums (zero without extensions).
// With fuse_acc (kFacc) the pressure triple holds pressure and viscosity
// together and the viscosity triple stays unused.
struct PairSums {
  Acc px, py, pz;   // (p_i + p_j) / (2 rho_j) gradW r [+ mu_i visc]
  Acc vx, vy, vz;   // lapW (v_j - v_i) / rho_j
  Acc xx, xy, xz;   // 2 / (rho_i + rho_j) W (v_j - v_i)
  Acc ax, ay, az;   // PI gradW r
};

// The j-side values a force pair reads: with kBf16 the candidate's vx and
// vy rounded to bfloat16 and, where JAX reads rho_j from the candidate
// (kRho: the window route with extensions, and K5), also vz and rho_j, and
// press_j and 1/rho_j computed from the rounded rho_j (pallas_sph.py:
// 855-861, :1191-1203; pallas_compact.py:249, :416-418); else press_j and
// inv_j are the precomputed pj columns, which the caller loads (pj_load).
template <bool kRho, typename PjLoad>
__device__ __forceinline__ void candidate(const Scalars& s, float4& qa,
                                         float4& qb, float& press_j,
                                         float& inv_j, PjLoad&& pj_load) {
  if constexpr (kBf16) {
    qa.w = bf16_round(qa.w);
    qb.x = bf16_round(qb.x);
  }
  if constexpr (kBf16 && kRho) {
    qb.y = bf16_round(qb.y);
    qb.z = bf16_round(qb.z);
    press_j = s.gas_k * (qb.z - s.rho0);            // sph_kernels.pj_cols
    inv_j = qb.z > kEps ? __frcp_rn(qb.z) : 0.f;   // = 1.f / qb.z
  } else {
    const float2 pj = pj_load();
    press_j = pj.x;
    inv_j = pj.y;
  }
}

// Adds the pair terms of candidate q = (qa, qb) to particle p's sums
// (VelPos.compute:64-99; the extension sums of pallas_sph.py:1255-1283),
// with no IEEE division: press_j and the guarded reciprocal inv_j =
// [rho_j > eps] / rho_j come precomputed (the formulas of
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
//
// With kFacc (fuse_acc) each pair adds pc gradW r + lapW inv_j vmu (v_j -
// v_i) to the one triple, vmu the row's viscosity factor (mu where rho_i >
// eps, else 1: pallas_sph.py:1106-1115, :1234-1245), and the extension sums
// are the triples after it.
template <bool kExt, bool kFacc>
__device__ __forceinline__ void add_pair_pj(const Scalars& s,
                                            const Particle& p, float press_i,
                                            float vmu, float4 qa, float4 qb,
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
  if constexpr (kFacc) {
    const float vcm = vc * vmu;
    accum(acc.px, pc * (g * dx) + vcm * dvx, pv);
    accum(acc.py, pc * (g * dy) + vcm * dvy, pv);
    accum(acc.pz, pc * (g * dz) + vcm * dvz, pv);
  } else {
    accum(acc.px, pc * (g * dx), pv);
    accum(acc.py, pc * (g * dy), pv);
    accum(acc.pz, pc * (g * dz), pv);
    accum(acc.vx, vc * dvx, pv);
    accum(acc.vy, vc * dvy, pv);
    accum(acc.vz, vc * dvz, pv);
  }
  if constexpr (kExt) {
    const float d2 = s.h2 - r2;
    const float w6 = d2 > 0.f ? s.c_poly6 * d2 * d2 * d2 : 0.f;
    const float denom = p.rho + qb.z;
    const float two_over = 2.f * __frcp_rn(denom);   // 2 / denom = 1 / rho_bar
    const float xc = denom > kEps ? two_over * w6 : 0.f;
    accum(acc.xx, xc * dvx, use);
    accum(acc.xy, xc * dvy, use);
    accum(acc.xz, xc * dvz, use);
    const float vr = -(dvx * dx) - dvy * dy - dvz * dz;
    const float mu = s.h * vr * __frcp_rn(r2 + 0.01f * s.h2);
    const bool pi_ok = vr < 0.f && 0.5f * denom > kEps;
    const float ac = (pi_ok ? -s.cs * mu * two_over : 0.f) * g;
    accum(acc.ax, ac * dx, use);
    accum(acc.ay, ac * dy, use);
    accum(acc.az, ac * dz, use);
  }
}

// Stores particle i's raw sums in the f32[N, 12] layout of K3, three float4
// stores: (press 3, visc 3, xsph 3, avisc 3), or with kFacc (combined 3,
// xsph 3, avisc 3, 0 3), as forces_pallas reads them (xb = 3,
// pallas_sph.py:1740-1748).
template <bool kFacc>
__device__ __forceinline__ void store_sums(float4* __restrict__ out, int i,
                                           const PairSums& a) {
  if constexpr (kFacc) {
    out[3 * i] = make_float4(total(a.px), total(a.py), total(a.pz),
                             total(a.xx));
    out[3 * i + 1] = make_float4(total(a.xy), total(a.xz), total(a.ax),
                                 total(a.ay));
    out[3 * i + 2] = make_float4(total(a.az), 0.f, 0.f, 0.f);
  } else {
    out[3 * i] = make_float4(total(a.px), total(a.py), total(a.pz),
                             total(a.vx));
    out[3 * i + 1] = make_float4(total(a.vy), total(a.vz), total(a.xx),
                                 total(a.xy));
    out[3 * i + 2] = make_float4(total(a.xz), total(a.ax), total(a.ay),
                                 total(a.az));
  }
}

__device__ __forceinline__ float wall_depth(float p, float h) {
  return p < h ? h - p : (p > 1.f - h ? 1.f - p - h : 0.f);
}

// clamp to [0, 1] that keeps NaN, as torch.clamp and jnp.clip do
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

// The fused tail of one substep for particle i (pallas_sph.py:1404-1489,
// VelPos.compute:101-157), from its pair sums: the guarded m^2/rho_i scaling
// (raw sums pass through when rho_i <= eps), with kExt the XSPH and
// artificial-viscosity fold of the JAX tail (:1440-1450), the wall penalty
// with the scalar dot(damp, v) quirk, gravity, the NaN trap, semi-implicit
// Euler and the [0, 1] clamp; writes the new rows entry, the NaN-trap count
// in lane 7. The XSPH correction dv moves the position only, after the NaN
// trap, so a trapped particle still moves by dt * dv (stepper.py:57-59).
// With kFacc the combined triple takes the m^2/rho_i scale alone (the
// viscosity is already in it; :1420-1430).
template <bool kExt, bool kFacc>
__device__ __forceinline__ void fused_tail(const Scalars& s,
                                           const Particle& p,
                                           const PairSums& acc,
                                           float4* __restrict__ out, int i) {
  const float px = p.px, py = p.py, pz = p.pz;
  const float vx = p.vx, vy = p.vy, vz = p.vz;
  const float rho = p.rho;

  // final scaling, guarded by rho_i > eps (VelPos.compute:101-105)
  const bool i_ok = rho > kEps;
  const float safe = i_ok ? rho : 1.f;
  const float sp = s.mass * s.mass / safe;
  const float px_ = total(acc.px), py_ = total(acc.py), pz_ = total(acc.pz);
  float ffx, ffy, ffz;
  if constexpr (kFacc) {
    ffx = i_ok ? px_ * sp : px_;
    ffy = i_ok ? py_ * sp : py_;
    ffz = i_ok ? pz_ * sp : pz_;
  } else {
    const float sv = s.visc * s.mass * s.mass / safe;
    const float vx_ = total(acc.vx), vy_ = total(acc.vy),
                vz_ = total(acc.vz);
    ffx = (i_ok ? px_ * sp : px_) + (i_ok ? vx_ * sv : vx_);
    ffy = (i_ok ? py_ * sp : py_) + (i_ok ? vy_ * sv : vy_);
    ffz = (i_ok ? pz_ * sp : pz_) + (i_ok ? vz_ * sv : vz_);
  }
  float dvx = 0.f, dvy = 0.f, dvz = 0.f;
  if constexpr (kExt) {
    const float xs = s.xsph * s.mass;
    dvx = xs * total(acc.xx);
    dvy = xs * total(acc.xy);
    dvz = xs * total(acc.xz);
    const float av = s.alpha_visc * s.mass * s.mass;
    ffx = ffx + av * total(acc.ax);
    ffy = ffy + av * total(acc.ay);
    ffz = ffz + av * total(acc.az);
  }

  // wall penalty (VelPos.compute:107-137): the damping term is the SCALAR
  // dot(damp, v) subtracted from all components
  const float rwx = wall_depth(px, s.h);
  const float rwy = wall_depth(py, s.h);
  const float rwz = wall_depth(pz, s.h);
  const float damp_dot = ((rwx != 0.f ? s.damping : 0.f) * vx
                          + (rwy != 0.f ? s.damping : 0.f) * vy)
                         + (rwz != 0.f ? s.damping : 0.f) * vz;
  const bool active = fmaxf(fabsf(rwx), fmaxf(fabsf(rwy), fabsf(rwz))) > 0.f;
  const float fwx = active ? (rwx * s.stiff - damp_dot) * s.mass : 0.f;
  const float fwy = active ? (rwy * s.stiff - damp_dot) * s.mass : 0.f;
  const float fwz = active ? (rwz * s.stiff - damp_dot) * s.mass : 0.f;

  // a = g + f/m; the NaN trap zeroes acceleration AND velocity
  // (VelPos.compute:139-147); semi-implicit Euler + clamp (:150-154)
  const float ax = (ffx + fwx) / s.mass;
  const float ay = s.grav_y + (ffy + fwy) / s.mass;
  const float az = (ffz + fwz) / s.mass;
  const bool nan_hit = isnan(ax) || isnan(ay) || isnan(az);
  const float nvx = nan_hit ? 0.f : vx + ax * s.dt;
  const float nvy = nan_hit ? 0.f : vy + ay * s.dt;
  const float nvz = nan_hit ? 0.f : vz + az * s.dt;
  if constexpr (kExt) {
    out[2 * i] = make_float4(clamp01(px + s.dt * (nvx + dvx)),
                             clamp01(py + s.dt * (nvy + dvy)),
                             clamp01(pz + s.dt * (nvz + dvz)), nvx);
  } else {
    out[2 * i] = make_float4(clamp01(px + s.dt * nvx),
                             clamp01(py + s.dt * nvy),
                             clamp01(pz + s.dt * nvz), nvx);
  }
  out[2 * i + 1] = make_float4(nvy, nvz, rho, p.aux + (nan_hit ? 1.f : 0.f));
}

}  // namespace sph
