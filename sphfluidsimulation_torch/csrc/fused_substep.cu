// K2: one whole integration substep over the sorted rows state.
//
// Replaces the TPU kernel sphfluidsimulation_tpu/ops/pallas_sph.py::
// _sph_kernel (:961) with force=True, fused=True, as called by
// fused_substep (:1835) through _call_kernel (pallas_call at :1513): the
// pressure and viscosity pair sums over the reference's 27-cell window with
// j == i skipped (VelPos.compute:64-105), the guarded m^2/rho_i scaling, then
// the fused tail (:1404-1489, VelPos.compute:107-157): wall penalty with the
// scalar dot(damp, v) quirk, gravity, the NaN trap, semi-implicit Euler and
// the [0, 1] clamp. The NaN-trap count rides lane 7 of the rows.
//
// Rows are f32[N, 8] = (x, y, z, vx, vy, vz, rho, nan_count): two float4
// loads per particle. rho is the frame-start density for i and for j.
// Candidates are read from the state as it was before the substep and the
// result goes to a separate buffer (an in-place update would race).
//
// What bounds it on the H100: the same gather walk as K1 with 32 bytes per
// candidate and ~45 flops, an IEEE sqrt and two IEEE divisions per pair
// (no fast math: h - |r| cancels at the support edge, pallas_sph.py:1213).
// Loads are served by L1/L2 because a warp's particles share window cells;
// the divisions and the sqrt set the issue rate.
//
// What the design does about it: one thread per sorted particle, separate
// pressure and viscosity accumulators in registers as in ops/brute.py, the
// walk cut at the voxel capacity, and every gate a branch, so the inf
// velocities of exploding scenes reach only real candidates.
#include "sph_common.cuh"

namespace {

__device__ __forceinline__ float wall_depth(float p, float h) {
  return p < h ? h - p : (p > 1.f - h ? 1.f - p - h : 0.f);
}

// clamp to [0, 1] that keeps NaN, as torch.clamp and jnp.clip do
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

__global__ void __launch_bounds__(sph::kBlock)
fused_substep_kernel(const float4* __restrict__ rows,
                     const int* __restrict__ start,
                     const int* __restrict__ raw,
                     const uint8_t* __restrict__ occ,
                     const float* __restrict__ scal,
                     float4* __restrict__ out, int n, int r, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const sph::Scalars s = sph::load_scalars(scal);
  const float4 a = rows[2 * i];
  const float4 b = rows[2 * i + 1];
  const float px = a.x, py = a.y, pz = a.z;
  const float vx = a.w, vy = b.x, vz = b.y;
  const float rho = b.z;
  const int cx = sph::fresh_coord(px, r);
  const int cy = sph::fresh_coord(py, r);
  const int cz = sph::fresh_coord(pz, r);
  const float press_i = s.gas_k * (rho - s.rho0);

  float fpx = 0.f, fpy = 0.f, fpz = 0.f;
  float fvx = 0.f, fvy = 0.f, fvz = 0.f;
  sph::for_each_candidate(cx, cy, cz, r, cap, start, raw, occ, [&](int j) {
    if (j == i) return;                          // VelPos.compute:82
    const float4 ja = __ldg(rows + 2 * j);
    const float4 jb = __ldg(rows + 2 * j + 1);
    const float rho_j = jb.z;
    if (!(rho_j > sph::kEps)) return;            // VelPos.compute:91
    const float dx = px - ja.x, dy = py - ja.y, dz = pz - ja.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    const float abs_r = sqrtf(r2);
    const float diff_r = s.h - abs_r;
    const bool ok = diff_r > sph::kEps && abs_r > sph::kEps;
    const float g = ok ? s.c_grad * (diff_r * diff_r * diff_r) / abs_r : 0.f;
    const float gwv = abs_r < s.h ? s.c_grad * diff_r : 0.f;
    const float press_j = s.gas_k * (rho_j - s.rho0);
    const float pc = (press_i + press_j) / (2.f * rho_j);
    fpx += pc * (g * dx);
    fpy += pc * (g * dy);
    fpz += pc * (g * dz);
    const float vc = gwv / rho_j;
    fvx += vc * (ja.w - vx);
    fvy += vc * (jb.x - vy);
    fvz += vc * (jb.y - vz);
  });

  // final scaling, guarded by rho_i > eps (VelPos.compute:101-105)
  const bool i_ok = rho > sph::kEps;
  const float safe = i_ok ? rho : 1.f;
  const float sp = s.mass * s.mass / safe;
  const float sv = s.visc * s.mass * s.mass / safe;
  const float ffx = (i_ok ? fpx * sp : fpx) + (i_ok ? fvx * sv : fvx);
  const float ffy = (i_ok ? fpy * sp : fpy) + (i_ok ? fvy * sv : fvy);
  const float ffz = (i_ok ? fpz * sp : fpz) + (i_ok ? fvz * sv : fvz);

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
  out[2 * i] = make_float4(clamp01(px + s.dt * nvx), clamp01(py + s.dt * nvy),
                           clamp01(pz + s.dt * nvz), nvx);
  out[2 * i + 1] = make_float4(nvy, nvz, rho, b.w + (nan_hit ? 1.f : 0.f));
}

}  // namespace

extern "C" int sph_fused_substep(const float* rows, const int* start,
                                 const int* raw, const uint8_t* occ,
                                 const float* scal, float* out, int n, int r,
                                 int cap, void* stream) {
  if (n > 0) {
    const int blocks = (n + sph::kBlock - 1) / sph::kBlock;
    fused_substep_kernel<<<blocks, sph::kBlock, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(rows), start, raw, occ, scal,
        reinterpret_cast<float4*>(out), n, r, cap);
  }
  return (int)cudaGetLastError();
}
