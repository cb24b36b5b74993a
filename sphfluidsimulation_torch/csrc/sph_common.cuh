// Shared device code of the sorted-frame SPH kernels (density.cu,
// fused_substep.cu, forces.cu, compact.cu): the scalar block, the fresh-cell
// computation, the reference's 27-cell candidate walk over the anchor-sorted
// particle array, the density and force-side pair terms that K1/K2/K3 and
// K5 all sum, and the fused integrate tail of K2 and K5.
//
// Layout (ops/frame.py): particles are sorted by anchor cell (the flat id of
// the clamped 3D cell); start[c] .. start[c+1] is cell c's run; occ[j] says
// j is in the reference bucket (raw id in range, rank in its run below the
// voxel capacity); raw[j] is the reference's unchecked flat id, which equals
// the anchor id for every in-cube position.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sph {

constexpr float kEps = 1e-6f;   // VelPos.compute:5
constexpr int kBlock = 128;

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

// Calls visit(j) for every j of the reference candidate set of a particle
// whose fresh cell is (cx, cy, cz): the anchor cells of the 3x3x3 window
// that lie in the grid, z outer, y middle, x inner, each run in sorted
// order and cut to its first `cap` slots (cap < 0: uncapped; slots past the
// capacity are never occupied, so the cut is exact). The membership gate is
// the JAX kernels' (pallas_sph.py:1145-1164): j occupied and its RAW cell
// within distance 1. A j whose raw id equals the walked cell passes without
// decoding; only aliased out-of-cube spawns reach the decode.
template <typename Visit>
__device__ __forceinline__ void for_each_candidate(
    int cx, int cy, int cz, int r, int cap, const int* __restrict__ start,
    const int* __restrict__ raw, const uint8_t* __restrict__ occ,
    Visit&& visit) {
  const int x0 = max(cx - 1, 0), x1 = min(cx + 1, r - 1);
  const int y0 = max(cy - 1, 0), y1 = min(cy + 1, r - 1);
  const int z0 = max(cz - 1, 0), z1 = min(cz + 1, r - 1);
  for (int z = z0; z <= z1; ++z) {
    for (int y = y0; y <= y1; ++y) {
      const int line = (z * r + y) * r;
      for (int x = x0; x <= x1; ++x) {
        const int cell = line + x;
        const int s = __ldg(start + cell);
        int e = __ldg(start + cell + 1);
        if (cap >= 0) e = min(e, s + cap);
        for (int j = s; j < e; ++j) {
          if (!__ldg(occ + j)) continue;
          const int rj = __ldg(raw + j);
          if (rj != cell && !raw_near(rj, cx, cy, cz, r)) continue;
          visit(j);
        }
      }
    }
  }
}

// Adds candidate (qx, qy, qz)'s poly6 weight to the density sum of the
// particle at (px, py, pz) (Density.compute:42-54); the mass is applied after
// the walk.
__device__ __forceinline__ void add_density(const Scalars& s, float px,
                                            float py, float pz, float qx,
                                            float qy, float qz, float& acc) {
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float d = s.h2 - r2;
  if (d > 0.f) acc += s.c_poly6 * d * d * d;
}

// Raw force-side pair sums of one particle: pressure, viscosity, and the
// XSPH and Monaghan artificial-viscosity sums (zero without extensions).
struct PairSums {
  float px = 0.f, py = 0.f, pz = 0.f;   // (p_i + p_j) / (2 rho_j) gradW r
  float vx = 0.f, vy = 0.f, vz = 0.f;   // lapW (v_j - v_i) / rho_j
  float xx = 0.f, xy = 0.f, xz = 0.f;   // 2 / (rho_i + rho_j) W (v_j - v_i)
  float ax = 0.f, ay = 0.f, az = 0.f;   // PI gradW r
};

// Adds the pair terms of candidate j to particle p's sums
// (VelPos.compute:64-99; the extension sums of pallas_sph.py:1255-1283).
// The rho_j > eps guard (VelPos.compute:91) gates pressure and viscosity
// only: the JAX kernel keeps such j in the XSPH and artificial-viscosity
// sums, each of which guards its own denominator. Without extensions this
// is the code of the faithful K2: a j with rho_j <= eps contributes nothing.
// No gate multiplies: every select is a branch, so an inf on a
// non-contributing term never turns into 0 * inf.
template <bool kExt>
__device__ __forceinline__ void add_pair(const Scalars& s, const Particle& p,
                                         float press_i, const Particle& q,
                                         PairSums& acc) {
  const bool rho_ok = q.rho > kEps;
  if (!kExt && !rho_ok) return;
  const float dx = p.px - q.px, dy = p.py - q.py, dz = p.pz - q.pz;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float abs_r = sqrtf(r2);
  const float diff_r = s.h - abs_r;
  const bool ok = diff_r > kEps && abs_r > kEps;
  const float g = ok ? s.c_grad * (diff_r * diff_r * diff_r) / abs_r : 0.f;
  if (rho_ok) {
    const float gwv = abs_r < s.h ? s.c_grad * diff_r : 0.f;
    const float press_j = s.gas_k * (q.rho - s.rho0);
    const float pc = (press_i + press_j) / (2.f * q.rho);
    acc.px += pc * (g * dx);
    acc.py += pc * (g * dy);
    acc.pz += pc * (g * dz);
    const float vc = gwv / q.rho;
    acc.vx += vc * (q.vx - p.vx);
    acc.vy += vc * (q.vy - p.vy);
    acc.vz += vc * (q.vz - p.vz);
  }
  if constexpr (kExt) {
    // XSPH: 2 / (rho_i + rho_j) W_poly6 (v_j - v_i); eps and mass are
    // folded in after the walk
    const float d2 = s.h2 - r2;
    const float w6 = d2 > 0.f ? s.c_poly6 * d2 * d2 * d2 : 0.f;
    const float denom = p.rho + q.rho;
    const float xc = denom > kEps ? 2.f / denom * w6 : 0.f;
    acc.xx += xc * (q.vx - p.vx);
    acc.xy += xc * (q.vy - p.vy);
    acc.xz += xc * (q.vz - p.vz);
    // Monaghan PI for approaching pairs; alpha and m^2 are folded in after
    // the walk, cs = sqrt(gas_k)
    const float vr = (p.vx - q.vx) * dx + (p.vy - q.vy) * dy
                     + (p.vz - q.vz) * dz;
    const float rho_bar = 0.5f * (p.rho + q.rho);
    const float mu = s.h * vr / (r2 + 0.01f * s.h2);
    const bool pi_ok = vr < 0.f && rho_bar > kEps;
    const float ac = (pi_ok ? -s.cs * mu / rho_bar : 0.f) * g;
    acc.ax += ac * dx;
    acc.ay += ac * dy;
    acc.az += ac * dz;
  }
}

// Particle i's pair sums over its candidates, j == i skipped
// (VelPos.compute:82). Candidates are read from `rows`, the state before
// the substep.
template <bool kExt>
__device__ __forceinline__ PairSums pair_sums(
    const Scalars& s, const Particle& p, int i, int r, int cap,
    const float4* __restrict__ rows, const int* __restrict__ start,
    const int* __restrict__ raw, const uint8_t* __restrict__ occ) {
  const int cx = fresh_coord(p.px, r);
  const int cy = fresh_coord(p.py, r);
  const int cz = fresh_coord(p.pz, r);
  const float press_i = s.gas_k * (p.rho - s.rho0);
  PairSums acc;
  for_each_candidate(cx, cy, cz, r, cap, start, raw, occ, [&](int j) {
    if (j == i) return;
    add_pair<kExt>(s, p, press_i, load_particle(rows, j), acc);
  });
  return acc;
}

// Stores particle i's raw sums in the f32[N, 12] layout of K3: (press 3,
// visc 3, xsph 3, avisc 3), three float4 stores.
__device__ __forceinline__ void store_sums(float4* __restrict__ out, int i,
                                           const PairSums& a) {
  out[3 * i] = make_float4(a.px, a.py, a.pz, a.vx);
  out[3 * i + 1] = make_float4(a.vy, a.vz, a.xx, a.xy);
  out[3 * i + 2] = make_float4(a.xz, a.ax, a.ay, a.az);
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
template <bool kExt>
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
  const float sv = s.visc * s.mass * s.mass / safe;
  float ffx = (i_ok ? acc.px * sp : acc.px) + (i_ok ? acc.vx * sv : acc.vx);
  float ffy = (i_ok ? acc.py * sp : acc.py) + (i_ok ? acc.vy * sv : acc.vy);
  float ffz = (i_ok ? acc.pz * sp : acc.pz) + (i_ok ? acc.vz * sv : acc.vz);
  float dvx = 0.f, dvy = 0.f, dvz = 0.f;
  if constexpr (kExt) {
    const float xs = s.xsph * s.mass;
    dvx = xs * acc.xx;
    dvy = xs * acc.xy;
    dvz = xs * acc.xz;
    const float av = s.alpha_visc * s.mass * s.mass;
    ffx = ffx + av * acc.ax;
    ffy = ffy + av * acc.ay;
    ffz = ffz + av * acc.az;
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
