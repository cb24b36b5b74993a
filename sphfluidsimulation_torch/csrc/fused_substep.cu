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
// (zbase, z_span); they copy dead rows through. The scene-axis instances
// (sph_fused_substep_scenes) are fused_substep under JAX's vmap of the
// frame step (parallel/batch.py:42-46): one launch over the stacked rows
// of S scenes, blockIdx.y the scene (window_walk.cuh::scene_args).
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
//
// The banded instances walk each live row with a group of kBandLanes lanes,
// kBandSlots slots a lane a step (window_walk.cuh's lane groups): a slab's
// shard holds a quarter of the particles, too few rows at one thread a row
// to keep the card's warps busy. The result is the one-thread walk's, bit
// for bit; that walk (one lane a row, two slots a step without the
// extensions, one with them) stays built as the reference instance,
// launched through sph_fused_substep_lanes with lanes = 1, slots = 0.
// -DSPH_LANE_SWEEP=1 builds every shape of 1, 2, 4 or 8 lanes a row and 1,
// 2 or 4 slots a lane, for the band and the whole grid: the measurement that
// chose kBandLanes and kBandSlots (scripts/torch_k2band_ab.py).
//
// The bf16 instance with extensions, unbanded (config 3's bf16 rollout):
// JAX rounds the candidates once, when it packs the window (pallas_sph.py:
// 855-861), but rounding in the walk costs every slot of every row four
// bf16_rounds, press_j and a reciprocal. Each substep, one pass
// (bf16_candidates_kernel, sph_bf16_candidates) writes the rows' candidate
// values with vx, vy, vz and rho rounded by candidate<true> itself, as
// bfloat16 pairs in one word each (the packing of JAX's _pack_pair_bf16,
// pallas_sph.py:293), and the rounded rho's guarded reciprocal inv_j: 24
// bytes a row (window_walk.cuh CandArgs); the walk
// (fused_substep_cand_kernel) reads row i from the rows and every candidate
// from the copy, and computes press_j as candidate<true> does (a press_j
// rounded ahead of the walk changed the sums where the compiler fuses its
// product into press_i + press_j), so each pair sees the values the
// in-register walk computes, and the result is its bits. The copy at full
// width (32 bytes a row) measured 1.3% slower with its pass (PERF.md).
// The in-register walk stays built as the reference instance
// (sph_fused_substep in the bf16 library).
//
// The scene-axis instances (config 5's sweep: the grid is full and the walk
// is bound by issued instructions) read each slot's gate and j-side values
// from one 16-byte frame record (window_walk.cuh's kRec), one slot a step;
// the sums are those of the walk that reads occ, raw and pj, bit for bit.
// That walk stays built as the reference instance (reference != 0).
// The Kahan library's K2-ext over the whole grid (config 3's Kahan rollout)
// runs the same record walk: its launch is sph_fused_substep_scenes over
// one scene, whose thread is the unbanded kernel's thread with the record's
// one load a slot in place of occ, raw and pj (a solo record instance would
// be the same machine code again); the stepper builds the record where it
// builds pj, once a frame. The walk that reads occ, raw and pj
// (sph_fused_substep) stays built as its reference instance. Measured and
// not built (PERF.md): the Kahan sums of each gate updated under one
// predicate in place of a select a sum (2 more instructions a slot here,
// +6.7%), and a launch bound of 7 blocks an SM (72 registers, 16 bytes
// spilled: −1.7%, short of a bound without spills).
// The facc0 library's K2-ext over the whole grid (config 3's
// two-accumulator rollout) and the Kahan, the facc0 and the bf16 library's
// K2 without the extensions (their faithful rollouts at 262k and 1M) run
// the same one-scene record walk.
// Taking two or four rows a thread, with each loaded candidate evaluated
// for every row of a shared window, measured slower in every instance
// (PERF.md).
//
// The frame record itself (sph_frame_record, every library) is built in
// one pass, one thread a row and one 16-byte store: the frame's raw and
// occ and the pj of the row's density, computed as sph_kernels.pj_cols
// computes them (press_j = k (rho - rho0), then [rho > eps] / rho with the
// IEEE reciprocal), so the record is the torch build's, bit for bit. It
// serves every reader: the scene-axis K2 and K3 and the one-scene walks of
// the Kahan and the facc0 K2, K2-ext and K3-ext and of the bf16 K2, so
// that a corrected substep, which builds it anew, pays one launch for it.
#include "window_walk.cuh"

#ifndef SPH_LANE_SWEEP
#define SPH_LANE_SWEEP 0
#endif

namespace {

// the banded instances' lanes a row and slots a lane a step, without and
// with the extensions (scripts/torch_k2band_ab.py --sweep on an H100 80GB
// HBM3 at 700 W; PERF.md): without them 4 lanes of one slot take 0.315 ms on
// 4 slabs at 262k against the one-thread walk's 0.400; with them every
// group lost (2 lanes 1.53 ms against 1.26 at config 3: each slot hands on
// 11 values, not 3), so the one-thread walk stays launched there
constexpr int kBandLanes[2] = {4, 1};
constexpr int kBandSlots[2] = {1, 1};

template <bool kExt, bool kBand, int kLanes, int kSlots>
__global__ void __launch_bounds__(sph::kBlock)
fused_substep_kernel(sph::WalkArgs a, float4* __restrict__ out) {
  sph::walk_row<kExt, kBand, kLanes, kSlots>(
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

// The scene-axis instance (window_walk.cuh::scene_args): blockIdx.y is the
// scene, and each thread is the unbanded kernel's thread of that scene;
// with kRec it reads the frame record, one slot a step, else (the
// reference) occ, raw and pj as the unbanded kernel does.
template <bool kExt, bool kRec>
__global__ void __launch_bounds__(sph::kBlock)
fused_substep_scenes_kernel(sph::SceneArgs a, float4* __restrict__ out) {
  const int scene = blockIdx.y;
  float4* const out_s = out + 2 * (size_t)scene * a.n;
  sph::walk_row<kExt, false, 1, kRec || kExt ? 1 : 2, kRec>(
      sph::scene_args(a, scene),
      [&](const sph::Scalars& s, const sph::Particle& p, int i,
          const sph::PairSums& acc) {
        sph::fused_tail<kExt, sph::kFacc>(s, p, acc, out_s, i);
      },
      [](int) {});   // no dead rows without a band
}

// The bf16 candidates of K2 with extensions, one thread a row, rounded by
// sph_common.cuh::candidate<true> (its press_j is the walk's): cand[j] =
// (x, y, z, vx | vy) and cand2[j] = (vz | rho, inv_j), a | b the high
// halves of a and b's bits in one word, a's high (CandArgs).
// (a template, so that only the bf16 library's sph_bf16_candidates
// instantiates it)
template <bool kOn>
__global__ void __launch_bounds__(sph::kBlock)
bf16_candidates_kernel(const float4* __restrict__ rows,
                       float4* __restrict__ cand, float2* __restrict__ cand2,
                       int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float4 qa = __ldg(rows + 2 * j), qb = __ldg(rows + 2 * j + 1);
  float press_j, inv_j;
  sph::candidate<true>(sph::Scalars{}, qa, qb, press_j, inv_j,
                       [] { return make_float2(0.f, 0.f); });
  const auto pair = [](float hi, float lo) {
    return __uint_as_float((__float_as_uint(hi) & 0xffff0000u)
                           | __float_as_uint(lo) >> 16);
  };
  cand[j] = make_float4(qa.x, qa.y, qa.z, pair(qa.w, qb.x));
  cand2[j] = make_float2(pair(qb.y, qb.z), inv_j);
}

// The bf16 K2 with extensions over the whole grid, reading its candidates
// from the copy (CandArgs; a template, as bf16_candidates_kernel).
template <bool kOn>
__global__ void __launch_bounds__(sph::kBlock)
fused_substep_cand_kernel(sph::CandArgs a, float4* __restrict__ out) {
  sph::walk_row<true, false>(
      a,
      [&](const sph::Scalars& s, const sph::Particle& p, int i,
          const sph::PairSums& acc) {
        sph::fused_tail<true, sph::kFacc>(s, p, acc, out, i);
      },
      [](int) {});   // no dead rows without a band
}

// The frame record rec[s, i] = (k_s (rho - rho0_s), [rho > eps] / rho,
// raw as int bits, occ as int 0 or 1) of row i of scene s (blockIdx.y),
// each scene's k and rho0 its own.
__global__ void __launch_bounds__(sph::kBlock)
frame_record_kernel(const float* __restrict__ rho,
                    const int* __restrict__ raw,
                    const uint8_t* __restrict__ occ,
                    const float* __restrict__ gas_k,
                    const float* __restrict__ rho0,
                    float4* __restrict__ rec, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t q = (size_t)blockIdx.y * n + i;
  const float p = __ldg(rho + q);
  const float k = __ldg(gas_k + blockIdx.y), r0 = __ldg(rho0 + blockIdx.y);
  const float press = k * (p - r0);
  const float inv = p > sph::kEps ? __frcp_rn(p) : 0.f;   // = 1.f / p
  rec[q] = make_float4(press, inv, __int_as_float(__ldg(raw + q)),
                       __int_as_float(__ldg(occ + q) != 0 ? 1 : 0));
}

// Sets k to the instance of kSlots slots a lane and `lanes` lanes a row if
// `lanes` is one of kLanes and `slots` is kSlots.
template <bool kExt, bool kBand, int kSlots, int... kLanes>
void find(int lanes, int slots, sph::WalkKernel& k) {
  ((k = lanes == kLanes && slots == kSlots
            ? fused_substep_kernel<kExt, kBand, kLanes, kSlots>
            : k),
   ...);
}

// The instance of K2 with `lanes` lanes a row and `slots` slots a lane a
// step, or nullptr where this library has none: the one-thread walk (lanes
// 1, slots 0) everywhere, the band's kBandLanes and kBandSlots, and with
// SPH_LANE_SWEEP every shape of 1, 2, 4, 8 lanes and 1, 2, 4 slots.
template <bool kExt, bool kBand>
sph::WalkKernel instance(int lanes, int slots) {
  if (lanes == 1 && slots == 0)
    return fused_substep_kernel<kExt, kBand, 1, kExt ? 1 : 2>;
  sph::WalkKernel k = nullptr;
  if constexpr (SPH_LANE_SWEEP != 0) {
    find<kExt, kBand, 1, 1, 2, 4, 8>(lanes, slots, k);
    find<kExt, kBand, 2, 1, 2, 4, 8>(lanes, slots, k);
    find<kExt, kBand, 4, 1, 2, 4, 8>(lanes, slots, k);
  } else if constexpr (kBand) {
    find<kExt, kBand, kBandSlots[kExt ? 1 : 0], kBandLanes[kExt ? 1 : 0]>(
        lanes, slots, k);
  }
  return k;
}

int launch(const sph::WalkArgs& a, bool ext, int lanes, int slots,
           float* out, void* stream) {
  const bool band = sph::banded(a.zbase, a.z_span, a.r);
  const sph::WalkKernel kernel =
      ext ? (band ? instance<true, true>(lanes, slots)
                  : instance<true, false>(lanes, slots))
          : (band ? instance<false, true>(lanes, slots)
                  : instance<false, false>(lanes, slots));
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return sph::launch_walk(kernel, lanes, a, reinterpret_cast<float4*>(out),
                          (cudaStream_t)stream);
}

sph::WalkArgs walk_args(const float* rows, const float* pj, const int* start,
                        const int* raw, const uint8_t* occ, const float* scal,
                        int n, int r, int cap, int zbase, int z_span) {
  return sph::WalkArgs{reinterpret_cast<const float4*>(rows),
                       reinterpret_cast<const float2*>(pj),
                       start, raw, occ, scal, n, r, cap, zbase, z_span};
}

}  // namespace

// (zbase, z_span) is the frame's band of z-planes, (0, r) for the whole
// grid; ext != 0 selects the instance with the extension sums. A band
// launches the instance of kBandLanes lanes a row and kBandSlots slots a
// lane, the whole grid the one-thread walk.
extern "C" int sph_fused_substep(const float* rows, const float* pj,
                                 const int* start, const int* raw,
                                 const uint8_t* occ, const float* scal,
                                 float* out, int n, int r, int cap, int zbase,
                                 int z_span, int ext, void* stream) {
  const int e = ext != 0 ? 1 : 0;
  const bool band = sph::banded(zbase, z_span, r);
  return launch(walk_args(rows, pj, start, raw, occ, scal, n, r, cap, zbase,
                          z_span),
                ext != 0, band ? kBandLanes[e] : 1, band ? kBandSlots[e] : 0,
                out, stream);
}

// sph_fused_substep with `lanes` lanes a row and `slots` slots a lane a
// step: (1, 0) the one-thread walk, the reference instance; the band's
// (kBandLanes, kBandSlots); with SPH_LANE_SWEEP any of 1, 2, 4, 8 lanes and
// 1, 2, 4 slots. Another shape returns cudaErrorInvalidValue.
extern "C" int sph_fused_substep_lanes(const float* rows, const float* pj,
                                       const int* start, const int* raw,
                                       const uint8_t* occ, const float* scal,
                                       float* out, int n, int r, int cap,
                                       int zbase, int z_span, int ext,
                                       int lanes, int slots, void* stream) {
  return launch(walk_args(rows, pj, start, raw, occ, scal, n, r, cap, zbase,
                          z_span),
                ext != 0, lanes, slots, out, stream);
}

// K2 over `scenes` scenes of n rows each, every input stacked scene after
// scene (window_walk.cuh::scene_args): one launch, grid (row blocks,
// scenes), reading the frame records rec f32[S, N, 4]
// (sph_kernels.frame_record_scenes) in place of pj, raw and occ, or with
// reference != 0 the reference walk, which reads pj, raw and occ; ext != 0
// selects the instance with the extension sums.
extern "C" int sph_fused_substep_scenes(const float* rows, const float* pj,
                                        const int* start, const int* raw,
                                        const uint8_t* occ, const float* rec,
                                        const float* scal, float* out, int n,
                                        int r, int cap, int scenes, int ext,
                                        int reference, void* stream) {
  const sph::SceneArgs a{{reinterpret_cast<const float4*>(rows),
                          reinterpret_cast<const float2*>(pj), start, raw,
                          occ, scal, n, r, cap, 0, r},
                         reinterpret_cast<const float4*>(rec)};
  static const sph::SceneKernel instances[2][2] = {
      {fused_substep_scenes_kernel<false, true>,
       fused_substep_scenes_kernel<true, true>},
      {fused_substep_scenes_kernel<false, false>,
       fused_substep_scenes_kernel<true, false>}};
  return sph::launch_walk_scenes(instances[reference != 0 ? 1 : 0],
                                 ext != 0, a, scenes,
                                 reinterpret_cast<float4*>(out),
                                 (cudaStream_t)stream);
}

// The shape of sph_fused_substep's banded instance, with ext != 0 the one
// with the extension sums: its lanes a row (slots = 0) or its slots a lane
// a step (slots != 0).
extern "C" int sph_fused_substep_band_walk(int ext, int slots) {
  const int e = ext != 0 ? 1 : 0;
  return slots != 0 ? kBandSlots[e] : kBandLanes[e];
}

// The frame record of `scenes` scenes of n rows each, f32[S, N, 4]
// (sph_kernels.frame_record_scenes): rho f32[S, N], raw i32[S, N], occ
// u8[S, N] and each scene's k and rho0 (f32[S] each) -> rec; one launch,
// grid (row blocks, scenes).
extern "C" int sph_frame_record(const float* rho, const int* raw,
                                const uint8_t* occ, const float* gas_k,
                                const float* rho0, float* rec, int n,
                                int scenes, void* stream) {
  if (n > 0 && scenes > 0)
    frame_record_kernel<<<dim3((n + sph::kBlock - 1) / sph::kBlock, scenes),
                          sph::kBlock, 0, (cudaStream_t)stream>>>(
        rho, raw, occ, gas_k, rho0, reinterpret_cast<float4*>(rec), n);
  return (int)cudaGetLastError();
}

// The bf16 library's candidates of K2 with extensions, once a substep:
// rows f32[N, 8] -> cand f32[6N], the float4[N] of (x, y, z, vx | vy) then
// the float2[N] of (vz | rho, [rho > eps] / rho), vx, vy, vz and rho
// rounded to bfloat16 and a | b their bits' halves in one word. Another
// library returns cudaErrorInvalidValue.
extern "C" int sph_bf16_candidates(const float* rows, float* cand, int n,
                                   void* stream) {
  if constexpr (!sph::kBf16) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (n > 0)
      bf16_candidates_kernel<true>
          <<<(n + sph::kBlock - 1) / sph::kBlock, sph::kBlock, 0,
             (cudaStream_t)stream>>>(
              reinterpret_cast<const float4*>(rows),
              reinterpret_cast<float4*>(cand),
              reinterpret_cast<float2*>(reinterpret_cast<float4*>(cand) + n),
              n);
    return (int)cudaGetLastError();
  }
}

// The bf16 library's K2 with extensions over the whole grid, reading its
// candidates from sph_bf16_candidates' copy cand; the rows, frame and
// scalar block as in sph_fused_substep. Another library returns
// cudaErrorInvalidValue.
extern "C" int sph_fused_substep_cand(const float* rows, const float* cand,
                                      const int* start, const int* raw,
                                      const uint8_t* occ, const float* scal,
                                      float* out, int n, int r, int cap,
                                      void* stream) {
  if constexpr (!sph::kBf16) {
    return (int)cudaErrorInvalidValue;
  } else {
    const float4* const c = reinterpret_cast<const float4*>(cand);
    const sph::CandArgs a{walk_args(rows, nullptr, start, raw, occ, scal, n,
                                    r, cap, 0, r),
                          c, reinterpret_cast<const float2*>(c + n)};
    if (n > 0)
      fused_substep_cand_kernel<true>
          <<<(n + sph::kBlock - 1) / sph::kBlock, sph::kBlock, 0,
             (cudaStream_t)stream>>>(a, reinterpret_cast<float4*>(out));
    return (int)cudaGetLastError();
  }
}
