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
// extensions is the faithful K2.
//
// Rows are f32[N, 8] = (x, y, z, vx, vy, vz, rho, nan_count): two float4
// loads per particle. rho is the frame-start density for i and for j.
// Candidates are read from the state as it was before the substep and the
// result goes to a separate buffer (an in-place update would race).
//
// What bounds it on the H100: the same gather walk as K1 with 32 bytes per
// candidate and ~45 flops, an IEEE sqrt and two IEEE divisions per pair
// (no fast math: h - |r| cancels at the support edge, pallas_sph.py:1213);
// the extensions add ~30 flops and two divisions. Loads are served by L1/L2
// because a warp's particles share window cells; the divisions and the sqrt
// set the issue rate.
//
// What the design does about it: one thread per sorted particle, separate
// accumulators in registers as in ops/brute.py, the pair terms shared with
// K3 (sph_common.cuh::add_pair), the walk cut at the voxel capacity, and
// every gate a branch, so the inf velocities of exploding scenes reach only
// real candidates.
#include "sph_common.cuh"

namespace {

template <bool kExt>
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
  const sph::Particle p = sph::load_particle(rows, i);
  const sph::PairSums acc =
      sph::pair_sums<kExt>(s, p, i, r, cap, rows, start, raw, occ);
  sph::fused_tail<kExt>(s, p, acc, out, i);
}

}  // namespace

// ext != 0 selects the instance with the extension sums.
extern "C" int sph_fused_substep(const float* rows, const int* start,
                                 const int* raw, const uint8_t* occ,
                                 const float* scal, float* out, int n, int r,
                                 int cap, int ext, void* stream) {
  if (n > 0) {
    const int blocks = (n + sph::kBlock - 1) / sph::kBlock;
    auto kernel = ext ? fused_substep_kernel<true>
                      : fused_substep_kernel<false>;
    kernel<<<blocks, sph::kBlock, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(rows), start, raw, occ, scal,
        reinterpret_cast<float4*>(out), n, r, cap);
  }
  return (int)cudaGetLastError();
}
