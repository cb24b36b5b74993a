// K1: per-particle SPH density over the anchor-sorted frame.
//
// Replaces the TPU kernel sphfluidsimulation_tpu/ops/pallas_sph.py::
// _sph_kernel (:961) as called with force=False by density_pallas (:1663)
// through _call_kernel (pallas_call at :1513):
//     rho_i = m * sum_j W_poly6(|x_i - x_j|^2)
// over the reference's 27-cell window (Density.compute:32-60), self included.
// Its banded instance (a slab's frame, a band of z-planes with dead rows
// past the live ones; density_pass(band=) :1682-1697) is the same kernel
// with the band's (zbase, z_span); dead rows get 0. Its scene-axis
// instance (sph_density_scenes) is density_pass under JAX's vmap of the
// frame step (parallel/batch.py:42-46): one launch over the stacked frames
// of S scenes, blockIdx.y the scene (window_walk.cuh::scene_args). Built
// with SPH_KAHAN=1
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
//
// The scene-axis instance (config 5's sweep: the grid is full and the walk
// is bound by issued instructions) reads each slot from one 16-byte density
// record (x, y, z, and a gate word that is raw where occ, else -1;
// sph_kernels.density_record_scenes; window_walk.cuh's kDensityRecord) in
// place of the five loads of occ, raw and the position, one slot a step;
// the sums are those of the walk that reads occ, raw and pos, bit for bit.
// That walk stays built as the reference instance (reference != 0).
//
// The banded instance keeps the one-thread walk: lane groups (several
// lanes of a warp walking one live row, as K2's banded instance does) were
// measured slower in both libraries (PERF.md; scripts/torch_k1band_ab.py
// --sweep builds them from a patched copy): each lane of a group still adds
// every term of its row and hands on two factors a slot, so K1's cheap slot
// costs about half as many instructions again.
#include "window_walk.cuh"

namespace {

// Row i of a frame's density: the thread of density_kernel and of
// density_scenes_kernel.
template <bool kBand>
__device__ __forceinline__ void density_row(
    int i, const float* __restrict__ pos, const int* __restrict__ start,
    const int* __restrict__ raw, const uint8_t* __restrict__ occ,
    const float* __restrict__ scal, float* __restrict__ rho, int r, int cap,
    int zbase, int z_span) {
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

template <bool kBand>
__global__ void __launch_bounds__(sph::kBlock)
density_kernel(const float* __restrict__ pos, const int* __restrict__ start,
               const int* __restrict__ raw, const uint8_t* __restrict__ occ,
               const float* __restrict__ scal, float* __restrict__ rho,
               int n, int r, int cap, int zbase, int z_span) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  density_row<kBand>(i, pos, start, raw, occ, scal, rho, r, cap, zbase,
                     z_span);
}

// The scene-axis reference walk (window_walk.cuh::scene_args): blockIdx.y
// is the scene, whose inputs are the scene's blocks of the stacked arrays;
// each thread is the unbanded kernel's thread of that scene.
__global__ void __launch_bounds__(sph::kBlock)
density_scenes_kernel(const float* __restrict__ pos,
                      const int* __restrict__ start,
                      const int* __restrict__ raw,
                      const uint8_t* __restrict__ occ,
                      const float* __restrict__ scal, float* __restrict__ rho,
                      int n, int r, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t rows = (size_t)blockIdx.y * n;
  const size_t cells = (size_t)blockIdx.y * ((size_t)r * r * r + 1);
  density_row<false>(i, pos + 3 * rows, start + cells, raw + rows,
                     occ + rows, scal + (size_t)blockIdx.y * sph::kScalLanes,
                     rho + rows, r, cap, 0, r);
}

// The scene-axis record walk: the thread of density_scenes_kernel, reading
// its own position and each slot's from the scene's density records rec
// f32[S, N, 4], one slot a step: the same sums, bit for bit.
__global__ void __launch_bounds__(sph::kBlock)
density_record_scenes_kernel(const float4* __restrict__ rec,
                             const int* __restrict__ start,
                             const float* __restrict__ scal,
                             float* __restrict__ rho, int n, int r,
                             int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t rows = (size_t)blockIdx.y * n;
  const size_t cells = (size_t)blockIdx.y * ((size_t)r * r * r + 1);
  const float4* const rs = rec + rows;
  const sph::Scalars s =
      sph::load_scalars(scal + (size_t)blockIdx.y * sph::kScalLanes);
  const float4 p = __ldg(rs + i);
  sph::Acc acc;
  sph::range_walk<1, false, false, 1, sph::kDensityRecord>(
      sph::fresh_coord(p.x, r), sph::fresh_coord(p.y, r),
      sph::fresh_coord(p.z, r), i, r, cap, 0, r, start + cells, nullptr,
      nullptr,
      [&](int, const auto& use, float4 g) {
        sph::add_density(s, p.x, p.y, p.z, g.x, g.y, g.z, sph::gate_of(use),
                         acc);
      },
      0, rs);
  rho[rows + i] = s.mass * sph::total(acc);
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

// K1 over `scenes` scenes of n rows each, every input stacked scene after
// scene (window_walk.cuh::scene_args): one launch, grid (row blocks,
// scenes), reading the density records rec f32[S, N, 4]
// (sph_kernels.density_record_scenes) in place of pos, raw and occ, or with
// reference != 0 the reference walk, which reads pos, raw and occ.
extern "C" int sph_density_scenes(const float* pos, const int* start,
                                  const int* raw, const uint8_t* occ,
                                  const float* rec, const float* scal,
                                  float* rho, int n, int r, int cap,
                                  int scenes, int reference, void* stream) {
  if (n > 0 && scenes > 0) {
    const dim3 grid((n + sph::kBlock - 1) / sph::kBlock, scenes);
    if (reference != 0)
      density_scenes_kernel<<<grid, sph::kBlock, 0, (cudaStream_t)stream>>>(
          pos, start, raw, occ, scal, rho, n, r, cap);
    else
      density_record_scenes_kernel<<<grid, sph::kBlock, 0,
                                     (cudaStream_t)stream>>>(
          reinterpret_cast<const float4*>(rec), start, scal, rho, n, r, cap);
  }
  return (int)cudaGetLastError();
}
