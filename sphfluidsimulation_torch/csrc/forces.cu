// K3: raw force-side pair sums per sorted particle.
//
// Replaces the TPU kernel sphfluidsimulation_tpu/ops/pallas_sph.py::
// _sph_kernel (:961) with force=True, fused=False, as called by
// forces_pallas (:1702) through _call_kernel (pallas_call at :1513): for each
// sorted particle i, the pressure and viscosity sums over the reference's
// 27-cell window with j == i skipped (VelPos.compute:64-99) and, with kExt,
// the XSPH and Monaghan artificial-viscosity sums (pallas_sph.py:1255-1283).
// The m^2/rho_i scaling and the extension constants are folded in by the
// caller (ops/sph_kernels.py::fold_forces, forces_pallas :1737-1770), and
// the integration is a host pass (sim/stepper.py::integrate_substep). The
// corrected mode runs it every substep, after rebuilding the frame and the
// density, and packs pj (sph_kernels.pj_cols) beside the rows.
//
// Input rows f32[N, 8] = (x, y, z, vx, vy, vz, rho, aux) and pj f32[N, 2] =
// (press_j, [rho_j > eps] / rho_j), the layout K2 reads; output f32[N, 12] =
// (press 3, visc 3, xsph 3, avisc 3), three float4 stores per particle.
// Without kExt the last six lanes are zero.
//
// What bounds it on the H100: the gather walk of K2 (a chain of L1 loads
// per candidate slot, about 257 slots a row at config 3) and its per-pair
// arithmetic; the 48-byte store per particle is small beside the walk.
//
// What the design does about it: K2's pair function (sph_common.cuh's
// add_pair_pj) and window walk (window_walk.cuh): no IEEE division in the
// pair terms without the extensions, whole-term selects, ranges of
// consecutive slots. The two kernels share every line of the walk, so they
// cannot drift apart.
#include "window_walk.cuh"

namespace {

template <bool kExt>
__global__ void __launch_bounds__(sph::kBlock)
forces_kernel(sph::WalkArgs a, float4* __restrict__ out) {
  sph::walk_row<kExt>(
      a, [&](const sph::Scalars&, const sph::Particle&, int i,
             const sph::PairSums& acc) { sph::store_sums(out, i, acc); });
}

}  // namespace

// ext != 0 selects the instance with the extension sums.
extern "C" int sph_forces(const float* rows, const float* pj,
                          const int* start, const int* raw,
                          const uint8_t* occ, const float* scal, float* out,
                          int n, int r, int cap, int ext, void* stream) {
  const sph::WalkArgs a{reinterpret_cast<const float4*>(rows),
                        reinterpret_cast<const float2*>(pj),
                        start, raw, occ, scal, n, r, cap};
  return sph::launch_walk(ext ? forces_kernel<true> : forces_kernel<false>,
                          a, reinterpret_cast<float4*>(out),
                          (cudaStream_t)stream);
}
