// K1: per-particle SPH density over the anchor-sorted frame.
//
// Replaces the TPU kernel sphfluidsimulation_tpu/ops/pallas_sph.py::
// _sph_kernel (:961) as called with force=False by density_pallas (:1663)
// through _call_kernel (pallas_call at :1513):
//     rho_i = m * sum_j W_poly6(|x_i - x_j|^2)
// over the reference's 27-cell window (Density.compute:32-60), self included.
//
// What bounds it on the H100: the neighbour walk is a gather. Each thread
// reads, per candidate, 12 bytes of position plus the raw id and occupancy
// bytes, about 135 candidates per particle at the golden occupancy, and does
// ~12 flops with each. Device memory sees each particle once (consecutive
// threads hold consecutive sorted particles, which share their window
// cells), so the limit is L1/L2 load throughput and latency, not HBM.
//
// What the design does about it: one thread per sorted particle, so a warp
// walks nearly the same 27 runs and its loads coalesce into few cache lines;
// the walk is cut at the voxel capacity, which bounds the work of wall piles
// at 27 * capacity candidates; gating is a branch (a select), so no
// multiply by a 0/1 mask ever meets an inf.
#include "sph_common.cuh"

namespace {

__global__ void __launch_bounds__(sph::kBlock)
density_kernel(const float* __restrict__ pos, const int* __restrict__ start,
               const int* __restrict__ raw, const uint8_t* __restrict__ occ,
               const float* __restrict__ scal, float* __restrict__ rho,
               int n, int r, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const sph::Scalars s = sph::load_scalars(scal);
  const float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
  const int cx = sph::fresh_coord(px, r);
  const int cy = sph::fresh_coord(py, r);
  const int cz = sph::fresh_coord(pz, r);
  float acc = 0.f;
  sph::for_each_candidate(cx, cy, cz, r, cap, start, raw, occ, [&](int j) {
    sph::add_density(s, px, py, pz, __ldg(pos + 3 * j), __ldg(pos + 3 * j + 1),
                     __ldg(pos + 3 * j + 2), acc);
  });
  rho[i] = s.mass * acc;
}

}  // namespace

extern "C" int sph_density(const float* pos, const int* start, const int* raw,
                           const uint8_t* occ, const float* scal, float* rho,
                           int n, int r, int cap, void* stream) {
  if (n > 0) {
    const int blocks = (n + sph::kBlock - 1) / sph::kBlock;
    density_kernel<<<blocks, sph::kBlock, 0, (cudaStream_t)stream>>>(
        pos, start, raw, occ, scal, rho, n, r, cap);
  }
  return (int)cudaGetLastError();
}
