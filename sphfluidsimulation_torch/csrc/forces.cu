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
// density.
//
// Input rows f32[N, 8] = (x, y, z, vx, vy, vz, rho, aux), the layout K2
// reads; output f32[N, 12] = (press 3, visc 3, xsph 3, avisc 3), three
// float4 stores per particle. Without kExt the last six lanes are zero.
//
// What bounds it on the H100: the gather walk of K2 (32 bytes and ~45
// flops, an IEEE sqrt and two IEEE divisions per pair, ~30 flops and two
// more divisions with the extensions), served by L1/L2 because a warp's
// particles share window cells; the 48-byte store per particle is small
// beside the walk.
//
// What the design does about it: one thread per sorted particle, and the
// pair terms are K2's own device function (sph_common.cuh::add_pair), so
// the two kernels cannot drift apart; the walk is cut at the voxel capacity
// and every gate is a branch.
#include "sph_common.cuh"

namespace {

template <bool kExt>
__global__ void __launch_bounds__(sph::kBlock)
forces_kernel(const float4* __restrict__ rows, const int* __restrict__ start,
              const int* __restrict__ raw, const uint8_t* __restrict__ occ,
              const float* __restrict__ scal, float4* __restrict__ out, int n,
              int r, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const sph::Scalars s = sph::load_scalars(scal);
  const sph::Particle p = sph::load_particle(rows, i);
  const sph::PairSums a =
      sph::pair_sums<kExt>(s, p, i, r, cap, rows, start, raw, occ);
  sph::store_sums(out, i, a);
}

}  // namespace

// ext != 0 selects the instance with the extension sums.
extern "C" int sph_forces(const float* rows, const int* start, const int* raw,
                          const uint8_t* occ, const float* scal, float* out,
                          int n, int r, int cap, int ext, void* stream) {
  if (n > 0) {
    const int blocks = (n + sph::kBlock - 1) / sph::kBlock;
    auto kernel = ext ? forces_kernel<true> : forces_kernel<false>;
    kernel<<<blocks, sph::kBlock, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(rows), start, raw, occ, scal,
        reinterpret_cast<float4*>(out), n, r, cap);
  }
  return (int)cudaGetLastError();
}
