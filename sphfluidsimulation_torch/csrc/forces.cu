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
// density, and packs pj (sph_kernels.pj_cols) beside the rows. The
// scene-axis instances (sph_forces_scenes) are forces_pallas under JAX's
// vmap of the frame step (parallel/batch.py:42-46: sweep --corrected and the
// unfused route): one launch over the stacked rows of S scenes, blockIdx.y
// the scene (window_walk.cuh::scene_args), each scene's sums bit for bit its
// solo launch's.
//
// Input rows f32[N, 8] = (x, y, z, vx, vy, vz, rho, aux) and pj f32[N, 2] =
// (press_j, [rho_j > eps] / rho_j), the layout K2 reads; output f32[N, 12] =
// (press 3, visc 3, xsph 3, avisc 3), three float4 stores per particle.
// Without kExt the last six lanes are zero. The variants are K2's
// (fused_substep.cu): with fuse_acc (SPH_FACC, the default) the output is
// (pressure + mu_i viscosity 3, xsph 3, avisc 3, 0 3), the layout of
// forces_pallas under fuse_acc (xb = 3, pallas_sph.py:1740-1748); kahan and
// bf16 as in K2.
//
// What bounds it on the H100: the gather walk of K2 (a chain of L1 loads
// per candidate slot, about 257 slots a row at config 3) and its per-pair
// arithmetic; the 48-byte store per particle is small beside the walk.
//
// What the design does about it: K2's pair function (sph_common.cuh's
// add_pair_pj) and window walk (window_walk.cuh): no IEEE division in the
// pair terms without the extensions, whole-term selects, ranges of
// consecutive slots. The two kernels share every line of the walk, so they
// cannot drift apart. The scene-axis instances read the frame record, as
// K2's do (fused_substep.cu); the walk that reads occ, raw and pj stays
// built as the reference instance. The Kahan and the facc0 library's
// K3-ext over the whole grid (config 3's corrected and unfused Kahan and
// two-accumulator rollouts) run the same record walk over one scene, as
// their K2-ext do: the stepper builds the record (sph_frame_record) in
// place of pj, once a corrected substep, once an unfused frame; the walk
// that reads occ, raw and pj (sph_forces) stays built as its reference.
//
// The bf16 instance with extensions, unbanded (config 3's corrected and
// unfused bf16 rollouts): as K2's (fused_substep.cu), the candidates are
// rounded once, by the pass sph_bf16_candidates of the bf16 library of
// fused_substep.cu, into the half-width copy (24 bytes a row, window_walk.cuh
// CandArgs), and the walk (forces_cand_kernel) reads row i from the rows and
// every candidate from the copy, with press_j computed in the walk as
// candidate<true> computes it: the sums of the walk that rounds every slot
// in its registers, bit for bit. That walk (forces_kernel in the bf16
// library) stays built as the reference instance.
#include "window_walk.cuh"

namespace {

template <bool kExt, bool kBand>
__global__ void __launch_bounds__(sph::kBlock)
forces_kernel(sph::WalkArgs a, float4* __restrict__ out) {
  sph::walk_row<kExt, kBand>(
      a,
      [&](const sph::Scalars&, const sph::Particle&, int i,
          const sph::PairSums& acc) {
        sph::store_sums<sph::kFacc>(out, i, acc);
      },
      [&](int i) { sph::store_sums<sph::kFacc>(out, i, sph::PairSums{}); });
}

// The scene-axis instance (window_walk.cuh::scene_args): blockIdx.y is the
// scene, and each thread is the unbanded kernel's thread of that scene;
// kRec as in K2's (fused_substep.cu).
template <bool kExt, bool kRec>
__global__ void __launch_bounds__(sph::kBlock)
forces_scenes_kernel(sph::SceneArgs a, float4* __restrict__ out) {
  float4* const out_s = out + 3 * (size_t)blockIdx.y * a.n;
  sph::walk_row<kExt, false, 1, kRec || kExt ? 1 : 2, kRec>(
      sph::scene_args(a, blockIdx.y),
      [&](const sph::Scalars&, const sph::Particle&, int i,
          const sph::PairSums& acc) {
        sph::store_sums<sph::kFacc>(out_s, i, acc);
      },
      [](int) {});   // no dead rows without a band
}

// The Kahan library's record walk with the extension sums (its K3-ext over
// the whole grid, launched over one scene, and its K3-ext-scenes):
// forces_scenes_kernel<true, true> bounded to 7 blocks an SM, which gives
// 72 registers with 16 bytes spilled in place of 80 without, 28 warps an
// SM in place of 24: 2% faster, and faster than the walk of occ, raw and
// pj, which the unbounded record walk was not (PERF.md). (A
// template, so that only the Kahan library's sph_forces_scenes
// instantiates it.)
template <bool kOn>
__global__ void __launch_bounds__(sph::kBlock, 7)
forces_scenes_kahan_kernel(sph::SceneArgs a, float4* __restrict__ out) {
  float4* const out_s = out + 3 * (size_t)blockIdx.y * a.n;
  sph::walk_row<true, false, 1, 1, true>(
      sph::scene_args(a, blockIdx.y),
      [&](const sph::Scalars&, const sph::Particle&, int i,
          const sph::PairSums& acc) {
        sph::store_sums<sph::kFacc>(out_s, i, acc);
      },
      [](int) {});   // no dead rows without a band
}

// The record walk with the extension sums of this library.
sph::SceneKernel ext_record_walk() {
  if constexpr (sph::kKahan) {
    return forces_scenes_kahan_kernel<true>;
  } else {
    return forces_scenes_kernel<true, true>;
  }
}

// The bf16 K3 with extensions over the whole grid, reading its candidates
// from the copy of sph_bf16_candidates (fused_substep.cu; CandArgs), as
// fused_substep_cand_kernel does: the same pair sums as forces_kernel<true,
// false> in the bf16 library, bit for bit. (A template, so that only the
// bf16 library's sph_forces_cand instantiates it.)
template <bool kOn>
__global__ void __launch_bounds__(sph::kBlock)
forces_cand_kernel(sph::CandArgs a, float4* __restrict__ out) {
  sph::walk_row<true, false>(
      a,
      [&](const sph::Scalars&, const sph::Particle&, int i,
          const sph::PairSums& acc) {
        sph::store_sums<sph::kFacc>(out, i, acc);
      },
      [](int) {});   // no dead rows without a band
}

}  // namespace

// (zbase, z_span) is the frame's band of z-planes, (0, r) for the whole
// grid (the walk is K2's; the slab step does not launch K3, so its callers
// pass (0, r)); ext != 0 selects the instance with the extension sums.
extern "C" int sph_forces(const float* rows, const float* pj,
                          const int* start, const int* raw,
                          const uint8_t* occ, const float* scal, float* out,
                          int n, int r, int cap, int zbase, int z_span,
                          int ext, void* stream) {
  const sph::WalkArgs a{reinterpret_cast<const float4*>(rows),
                        reinterpret_cast<const float2*>(pj),
                        start, raw, occ, scal, n, r, cap, zbase, z_span};
  static const sph::WalkKernel instances[2][2] = {
      {forces_kernel<false, false>, forces_kernel<false, true>},
      {forces_kernel<true, false>, forces_kernel<true, true>}};
  return sph::launch_walk(instances, ext != 0, a,
                          reinterpret_cast<float4*>(out),
                          (cudaStream_t)stream);
}

// K3 over `scenes` scenes of n rows each, every input stacked scene after
// scene (window_walk.cuh::scene_args), the sums f32[S, N, 12]: one launch,
// grid (row blocks, scenes), reading the frame records rec or, with
// reference != 0, pj, raw and occ, as sph_fused_substep_scenes
// (fused_substep.cu); ext != 0 selects the instance with the extension
// sums.
extern "C" int sph_forces_scenes(const float* rows, const float* pj,
                                 const int* start, const int* raw,
                                 const uint8_t* occ, const float* rec,
                                 const float* scal, float* out, int n, int r,
                                 int cap, int scenes, int ext, int reference,
                                 void* stream) {
  const sph::SceneArgs a{{reinterpret_cast<const float4*>(rows),
                          reinterpret_cast<const float2*>(pj), start, raw,
                          occ, scal, n, r, cap, 0, r},
                         reinterpret_cast<const float4*>(rec)};
  static const sph::SceneKernel instances[2][2] = {
      {forces_scenes_kernel<false, true>, ext_record_walk()},
      {forces_scenes_kernel<false, false>, forces_scenes_kernel<true, false>}};
  return sph::launch_walk_scenes(instances[reference != 0 ? 1 : 0],
                                 ext != 0, a, scenes,
                                 reinterpret_cast<float4*>(out),
                                 (cudaStream_t)stream);
}

// The bf16 library's K3 with extensions over the whole grid, reading its
// candidates from sph_bf16_candidates' copy cand (fused_substep.cu: f32[6N],
// rounded once a substep); the rows, frame and scalar block as in
// sph_forces. Another library returns cudaErrorInvalidValue.
extern "C" int sph_forces_cand(const float* rows, const float* cand,
                               const int* start, const int* raw,
                               const uint8_t* occ, const float* scal,
                               float* out, int n, int r, int cap,
                               void* stream) {
  if constexpr (!sph::kBf16) {
    return (int)cudaErrorInvalidValue;
  } else {
    const float4* const c = reinterpret_cast<const float4*>(cand);
    const sph::CandArgs a{{reinterpret_cast<const float4*>(rows), nullptr,
                           start, raw, occ, scal, n, r, cap, 0, r},
                          c, reinterpret_cast<const float2*>(c + n)};
    if (n > 0)
      forces_cand_kernel<true>
          <<<(n + sph::kBlock - 1) / sph::kBlock, sph::kBlock, 0,
             (cudaStream_t)stream>>>(a, reinterpret_cast<float4*>(out));
    return (int)cudaGetLastError();
  }
}
