// K1: per-particle SPH density over the anchor-sorted frame.
//
// Replaces the TPU kernel sphfluidsimulation_tpu/ops/pallas_sph.py::
// _sph_kernel (:961) as called with force=False by density_pallas (:1663)
// through _call_kernel (pallas_call at :1513):
//     rho_i = m * sum_j W_poly6(|x_i - x_j|^2)
// over the reference's 27-cell window (Density.compute:32-60), self included.
// Its banded instance (a slab's frame, a band of z-planes with dead rows
// past the live ones; density_pass(band=) :1682-1697) is the same kernel
// with the band's (zbase, z_span); dead rows get 0. Built with SPH_KAHAN=1
// it is the kahan instance (PallasTuning.kahan, pallas_sph.py:1118-1130):
// the same walk, the running sum compensated (sph_common.cuh::accum) and
// the compensation folded in before the mass.
//
// What bounds it on the H100: the neighbour walk is a gather. Each thread
// reads, per candidate slot, the occupancy byte, the raw id and 12 bytes of
// position, about 100-140 slots per particle at the golden occupancy, and
// does 13 flops with each member. Device memory sees each particle once
// (consecutive threads hold consecutive sorted particles, which share their
// window cells), so the limit is the issue of that load chain from L1 and
// its latency, not HBM or the arithmetic.
//
// What the design does about it: the range walk of K2 and K3
// (window_walk.cuh), with the self pair kept: one thread per sorted
// particle, so a warp walks nearly the same runs and its loads coalesce into
// few cache lines; each (z, y) line a loop of its own, so the lanes stay in
// step; a line's cells as ranges of consecutive slots, cut at the voxel
// capacity (which bounds wall piles at 27 * capacity slots); one slot a
// step, gated by a whole-term select, so the step has no branch (two slots
// a step, as K2 takes them, measured slower for K1's 13-operation pair:
// PERF.md).
#include "window_walk.cuh"

namespace {

template <bool kBand>
__global__ void __launch_bounds__(sph::kBlock)
density_kernel(const float* __restrict__ pos, const int* __restrict__ start,
               const int* __restrict__ raw, const uint8_t* __restrict__ occ,
               const float* __restrict__ scal, float* __restrict__ rho,
               int n, int r, int cap, int zbase, int z_span) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (kBand && sph::dead_row(i, start, r, z_span)) {
    rho[i] = 0.f;
    return;
  }
  const sph::Scalars s = sph::load_scalars(scal);
  const float px = __ldg(pos + 3 * i), py = __ldg(pos + 3 * i + 1),
              pz = __ldg(pos + 3 * i + 2);
  sph::Acc acc;
  sph::range_walk<1, false, kBand>(
      sph::fresh_coord(px, r), sph::fresh_coord(py, r),
      sph::fresh_coord(pz, r), i, r, cap, zbase, z_span, start, raw, occ,
      [&](int q, bool use) {
        sph::add_density(s, px, py, pz, __ldg(pos + 3 * q),
                         __ldg(pos + 3 * q + 1), __ldg(pos + 3 * q + 2), use,
                         acc);
      });
  rho[i] = s.mass * sph::total(acc);
}

}  // namespace

// (zbase, z_span) is the frame's band of z-planes; (0, r) for the whole
// grid.
extern "C" int sph_density(const float* pos, const int* start, const int* raw,
                           const uint8_t* occ, const float* scal, float* rho,
                           int n, int r, int cap, int zbase, int z_span,
                           void* stream) {
  if (n > 0) {
    const int blocks = (n + sph::kBlock - 1) / sph::kBlock;
    const auto kernel = sph::banded(zbase, z_span, r) ? density_kernel<true>
                                                      : density_kernel<false>;
    kernel<<<blocks, sph::kBlock, 0, (cudaStream_t)stream>>>(
        pos, start, raw, occ, scal, rho, n, r, cap, zbase, z_span);
  }
  return (int)cudaGetLastError();
}
