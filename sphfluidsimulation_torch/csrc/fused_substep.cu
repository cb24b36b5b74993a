// K2: one whole integration substep over the sorted rows state.
//
// Replaces the TPU kernel sphfluidsimulation_tpu/ops/pallas_sph.py::
// _sph_kernel (:961) with force=True, fused=True, as called by
// fused_substep (:1835) through _call_kernel (pallas_call at :1513): the
// pressure and viscosity pair sums over the reference's 27-cell window with
// j == i skipped (VelPos.compute:64-105), the guarded m^2/rho_i scaling, then
// the fused tail (:1404-1489, VelPos.compute:107-157): wall penalty with the
// scalar dot(damp, v) quirk, gravity, the NaN trap, semi-implicit Euler and
// the [0, 1] clamp. The NaN-trap count rides lane 7 of the rows. The tail is
// sph_common.cuh::fused_tail, which K5 (compact.cu) shares.
//
// With kExt (xsph or alpha_visc nonzero) the walk also sums the XSPH and
// Monaghan artificial-viscosity terms, folded in as the JAX tail does
// (:1440-1450): the artificial viscosity joins the force, and the XSPH
// correction dv moves the position only, after the NaN trap, so a trapped
// particle still moves by dt * dv (stepper.py:57-59). The instance without
// extensions is the faithful K2. The banded instances (a slab's frame,
// fused_substep(band=) :1835-1887) are the same kernels with the band's
// (zbase, z_span); they copy dead rows through.
//
// Variants (compile-time switches, sph_common.cuh; one library per set):
// fuse_acc (SPH_FACC, the default, as in JAX: pressure and viscosity in
// one accumulator triple with the row's viscosity factor, the tail scaling
// it by m^2/rho_i alone, :1106-1115, :1420-1430; SPH_FACC=0 is the
// two-accumulator kernel), kahan (compensated sums) and bf16 (candidate
// values rounded where JAX rounds them; with extensions rho_j comes from
// the rows and press_j and 1/rho_j are computed from it, pj is not read).
//
// Rows are f32[N, 8] = (x, y, z, vx, vy, vz, rho, nan_count); pj is f32[N, 2]
// = (press_j, [rho_j > eps] / rho_j) of the frame-start density, which is
// rho for i and for j in all five substeps (sph_kernels.pj_cols, once a
// frame). Candidates are read from the state as it was before the substep
// and the result goes to a separate buffer (an in-place update would race).
//
// What bounds it on the H100: the gather walk, about 100 candidate slots
// per row at the golden occupancy (257 at config 3), each a chain of loads
// (occ, raw, two float4 of rows, pj) served by L1, at well under one issued
// instruction per cycle per scheduler, and the per-pair arithmetic. The
// IEEE divisions of the per-pair terms (three, six with the extensions)
// were the part of that arithmetic the walk could shed.
//
// What the design does about it: the pair function add_pair_pj
// (sph_common.cuh, shared with K3 and K5) has no IEEE division without the
// extensions (press_j and 1/rho_j precomputed, 1/|r| from rsqrt; one
// correctly rounded reciprocal for 2/(rho_i + rho_j) and 1/rho_bar, one for
// the Monaghan mu) and gates by whole-term selects, so two calls overlap;
// each row walks its window as ranges of consecutive slots (window_walk.cuh's
// range walk, shared with K1 and K3), two slots a step without the
// extensions. Staging a tile's window union in shared memory was measured slower on
// the H100 at every shape (it costs occupancy; PERF.md), so the walk reads
// global memory through L1.
#include "window_walk.cuh"

namespace {

template <bool kExt, bool kBand>
__global__ void __launch_bounds__(sph::kBlock)
fused_substep_kernel(sph::WalkArgs a, float4* __restrict__ out) {
  sph::walk_row<kExt, kBand>(
      a,
      [&](const sph::Scalars& s, const sph::Particle& p, int i,
          const sph::PairSums& acc) {
        sph::fused_tail<kExt, sph::kFacc>(s, p, acc, out, i);
      },
      [&](int i) {   // a dead row is copied through
        out[2 * i] = __ldg(a.rows + 2 * i);
        out[2 * i + 1] = __ldg(a.rows + 2 * i + 1);
      });
}

}  // namespace

// (zbase, z_span) is the frame's band of z-planes, (0, r) for the whole
// grid; ext != 0 selects the instance with the extension sums.
extern "C" int sph_fused_substep(const float* rows, const float* pj,
                                 const int* start, const int* raw,
                                 const uint8_t* occ, const float* scal,
                                 float* out, int n, int r, int cap, int zbase,
                                 int z_span, int ext, void* stream) {
  const sph::WalkArgs a{reinterpret_cast<const float4*>(rows),
                        reinterpret_cast<const float2*>(pj),
                        start, raw, occ, scal, n, r, cap, zbase, z_span};
  static const sph::WalkKernel instances[2][2] = {
      {fused_substep_kernel<false, false>, fused_substep_kernel<false, true>},
      {fused_substep_kernel<true, false>, fused_substep_kernel<true, true>}};
  return sph::launch_walk(instances, ext != 0, a,
                          reinterpret_cast<float4*>(out),
                          (cudaStream_t)stream);
}
