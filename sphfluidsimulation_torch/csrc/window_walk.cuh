// The window walk of K1 (density.cu), K2 (fused_substep.cu) and K3
// (forces.cu): one thread per sorted row walks the reference's 27-cell
// window of its fresh cell in global memory, z outer, y, x, then slot order,
// which is ascending sorted index, as ranges of consecutive slots, and hands
// each slot to the kernel's pair step with its membership gate. K1's step is
// add_density (self pair kept); K2's and K3's is add_pair_pj (j == i
// skipped), reading the j-side pressure and guarded 1/rho precomputed (pj,
// sph_kernels.pj_cols).
//
// What the design does about the H100: the walk is a gather served by L1,
// a chain of loads (occ, raw, then the candidate) per slot, and the lanes of
// a warp walk nearly the same cells. Each (z, y) line is a loop of its own,
// so the lanes meet again at every line's end; inside a line, the cells the
// capacity does not cut form one range of consecutive slots, taken two slots
// a step by K2 and K3 without the extensions (two independent load chains
// for the scheduler; K1's cheap pair and the extension pair measured faster
// one a step), each gated by a select, so the step has no branch. A single
// loop over all of a row's ranges let the lanes drift apart and measured
// slower for all three kernels (PERF.md).
//
// Bands: a slab's frame (parallel/slab_pallas.py) covers a band of z-planes
// (zbase, z_span) and holds dead rows past its live ones, whose threads
// return before walking (K1 writes 0, K2 copies the row through). That is
// the kBand instance of each kernel; a frame over the whole grid, the band
// (0, r), launches the instance without it, which compiles to the walk of
// the unbanded kernels (reading the band at run time made K2-ext and K3
// 7-8% slower on the H100: PERF.md).
//
// The records (kRec, the scene-axis instances of K1, K2 and K3): there the
// grid is full and the walk is bound by issued instructions (PERF.md: the
// L1 wavefronts of a warp's scattered loads cost under a fifth of it), so
// each slot reads one 16-byte record in place of several loads, one slot a
// step. K2's and K3's frame record (kFrameRecord: press_j, inv_j, raw, occ;
// sph_kernels.frame_record_scenes) replaces the three loads of occ, raw and
// pj; K1's density record (kDensityRecord: x, y, z, and one gate word that
// is raw where occ, else -1; sph_kernels.density_record_scenes) replaces
// five, occ, raw and the three position floats. The gate and the pair are
// the range walk's, so the sums are bit for bit those of the walk that
// reads occ, raw, pj and the positions, which stays built as the reference
// instance.
//
// Lane groups (kLanes > 1, K2's banded instance without the extensions): a
// slab's quarter of the particles fills only part of the card at one
// thread a row (about 18 of 64 warps an SM at 262k on 4 slabs), and each
// launch waits for its slowest warps, those whose rows walk the deepest
// windows. There a group of kLanes consecutive lanes of one warp walks one
// live row: the group takes the row's ranges as the one-thread walk does,
// kLanes * kSlots consecutive slots a step, kSlots a lane, each lane
// evaluating its slots' gates and pair terms (so a deep window's walk is
// shared by the group, and the group's loads of occ, raw and the rows are
// adjacent). The lanes hand the
// terms round the group by __shfl_sync, and every lane adds them in
// ascending slot order with the one-thread walk's operations
// (add_group_terms): each row's sums, and K2's output, are bit for bit the
// one-thread walk's, with no atomics and no tree of partial sums. kLanes =
// 1 compiles to the one-thread walk.
#pragma once

#include "sph_common.cuh"

namespace sph {

// The record a range walk reads in place of occ and raw (kRec): none, K2's
// and K3's frame record (press_j, inv_j, raw, occ as int bits) or K1's
// density record (x, y, z, and the gate word as int bits: raw where occ,
// else -1; occ implies 0 <= raw < r^3, ops/frame.py, so a gate word below
// 0 is exactly an unoccupied slot).
constexpr int kNoRecord = 0, kFrameRecord = 1, kDensityRecord = 2;

// Calls pair(j, use) for every slot j of the window of a row whose fresh
// cell is (cx, cy, cz): the anchor cells of the 3x3x3 window that lie in
// the grid and in the frame's band of z-planes [zbase, zbase + z_span) (the
// whole grid is the band (0, r); a slab's band is its owned planes and
// halos, ops/frame.py), each run cut to its first `cap` slots (cap < 0:
// uncut; slots past the capacity are never occupied, so the cut is exact),
// in walk order (without kBand the band is the whole grid). start[] is
// indexed by the local cell id x + y*r + (z - zbase)*r*r. `use` is the
// membership gate of the JAX kernels
// (pallas_sph.py:1145-1164), on GLOBAL raw ids: j occupied, its RAW cell
// within Chebyshev 1 of (cx, cy, cz) (a raw cell among the line's window
// cells passes without decoding; only aliased out-of-cube spawns reach the
// decode), and, with kSkipSelf, j != i. The (z, y) lines are loops of their
// own, so the lanes of a warp meet again at each line's end; within a line,
// whose cells are consecutive in sorted order, a cell whose run the
// capacity does not cut continues into the next one, and a line without a
// cut cell is one range of consecutive slots. kStep slots a step (1, 2 or
// 4): a later call of a step may repeat the range's last slot with use =
// false. With kLanes > 1 the calling thread is lane `lane` of a group of
// kLanes that walk one row: each step the group takes kLanes * kStep
// consecutive slots from q, this lane the kStep from j0 = q + lane * kStep,
// and pair(j0, e, member) evaluates them (the slots from e on are past the
// range; member(j) is the gate above). With kRec (one lane, one slot a
// step) the gate reads occ and raw from the record rec[j] in place of
// occ[] and raw[]: pair(j, gate, v) gets it as a callable (gate_of) and,
// from the frame record, v = (press_j, inv_j), from the density record the
// record itself (its x, y, z).
template <int kStep, bool kSkipSelf, bool kBand, int kLanes = 1,
          int kRec = kNoRecord, typename Pair>
__device__ __forceinline__ void range_walk(int cx, int cy, int cz, int i,
                                           int r, int cap, int zbase,
                                           int z_span,
                                           const int* __restrict__ start,
                                           const int* __restrict__ raw,
                                           const uint8_t* __restrict__ occ,
                                           Pair&& pair, int lane = 0,
                                           const float4* __restrict__ rec =
                                               nullptr) {
  static_assert(kRec == kNoRecord || (kLanes == 1 && kStep == 1),
                "the record walk takes one lane a row, one slot a step");
  const int x0 = max(cx - 1, 0), x1 = min(cx + 1, r - 1);
  const int y0 = max(cy - 1, 0), y1 = min(cy + 1, r - 1);
  const int z0 = kBand ? max(max(cz - 1, 0), zbase) : max(cz - 1, 0);
  const int z1 = kBand ? min(min(cz + 1, r - 1), zbase + z_span - 1)
                       : min(cz + 1, r - 1);
  for (int z = z0; z <= z1; ++z) {
    for (int y = y0; y <= y1; ++y) {
      const int line = (z * r + y) * r;              // global: the raw gate
      const int* const sl =                          // local: start[]
          kBand ? start + ((z - zbase) * r + y) * r : start + line;
      const auto member = [&](int j) {
        if (!__ldg(occ + j) || (kSkipSelf && j == i)) return false;
        const int rj = __ldg(raw + j);
        return (unsigned)(rj - line - x0) <= (unsigned)(x1 - x0)
               || raw_near(rj, cx, cy, cz, r);
      };
      int end = __ldg(sl + x0);
      for (int x = x0; x <= x1; ++x) {
        // the next range: from cell x on while no cell is cut
        int q = end;
        end = __ldg(sl + x + 1);
        int e = cap >= 0 ? min(end, q + cap) : end;
        while (e == end && x < x1) {
          ++x;
          end = __ldg(sl + x + 1);
          e = cap >= 0 ? min(end, e + cap) : end;
        }
        if constexpr (kLanes > 1) {
          for (; q < e; q += kLanes * kStep)
            pair(q + lane * kStep, e, member);
        } else if constexpr (kRec != kNoRecord) {
          // the gate goes to pair as a callable, which it evaluates after
          // issuing the candidate's loads: the record's load and the
          // candidate's are then in flight together, not one after the
          // other (gating first made K2-scenes 8% slower on the H100)
          constexpr bool kFrame = kRec == kFrameRecord;
          for (; q < e; ++q) {
            const float4 g = __ldg(rec + q);
            const auto gate = [&] {
              const int rj = __float_as_int(kFrame ? g.z : g.w);
              const bool occupied =
                  kFrame ? __float_as_int(g.w) != 0 : rj >= 0;
              return occupied && !(kSkipSelf && q == i)
                     && ((unsigned)(rj - line - x0) <= (unsigned)(x1 - x0)
                         || raw_near(rj, cx, cy, cz, r));
            };
            if constexpr (kFrame) {
              pair(q, gate, make_float2(g.x, g.y));
            } else {
              pair(q, gate, g);     // the density record is the candidate
            }
          }
        } else {
          for (; q < e; q += kStep) {
            pair(q, member(q));
#pragma unroll
            for (int k = 1; k < kStep; ++k) {
              const int qk = min(q + k, e - 1);
              pair(qk, qk > q + k - 1 && member(qk));
            }
          }
        }
      }
    }
  }
}

// Whether sorted row i is a dead row of a slab row buffer: dead rows sort
// past every live cell, so they start at start[z_span * r * r], the live
// row count (n without a band, so no row is dead there).
__device__ __forceinline__ bool dead_row(int i, const int* __restrict__ start,
                                         int r, int z_span) {
  return i >= __ldg(start + z_span * r * r);
}

// The inputs of K2 and K3, as one kernel parameter: rows f32[N, 8], pj
// f32[N, 2] (press_j, [rho_j > eps] / rho_j; not read by the bf16 instance
// with extensions), the scalar block, the frame's start, raw and occ, and
// its band.
struct WalkArgs {
  const float4* __restrict__ rows;
  const float2* __restrict__ pj;
  const int* __restrict__ start;
  const int* __restrict__ raw;
  const uint8_t* __restrict__ occ;
  const float* __restrict__ scal;
  int n, r, cap, zbase, z_span;
  // the candidates are read from the rows and rounded in the walk (bf16)
  static constexpr bool kRounded = false;
};

// The inputs of the bf16 K2 with extensions that reads its candidates
// rounded once a substep (fused_substep.cu, sph_bf16_candidates): WalkArgs
// (pj not read) and the half-width copy of the rows' candidate values,
// cand (x, y, z, and vx, vy rounded to bfloat16 as the two halves of one
// word) and cand2 (vz, rho rounded as the two halves of one word, then the
// rounded rho's guarded reciprocal inv_j), 24 bytes a row. Row i itself is
// read from the rows, unrounded.
struct CandArgs : WalkArgs {
  const float4* __restrict__ cand;
  const float2* __restrict__ cand2;
  static constexpr bool kRounded = true;
};

// Candidate q of the half-width copy: qa = (x, y, z, vx), qb = (vy, vz, rho,
// inv_j), each bfloat16 half widened to the float it was rounded to (its
// bits shifted into the high half: exact).
__device__ __forceinline__ void unpack_candidate(const CandArgs& a, int q,
                                                 float4& qa, float4& qb) {
  const float4 w = __ldg(a.cand + q);
  const float2 v = __ldg(a.cand2 + q);
  const unsigned pa = __float_as_uint(w.w), pb = __float_as_uint(v.x);
  qa = make_float4(w.x, w.y, w.z, __uint_as_float(pa & 0xffff0000u));
  qb = make_float4(__uint_as_float(pa << 16),
                   __uint_as_float(pb & 0xffff0000u),
                   __uint_as_float(pb << 16), v.y);
}

// The inputs of K2's and K3's scene-axis instances: WalkArgs and the frame
// records f32[S, N, 4] (pj, raw, occ; read in place of pj, raw and occ by
// the kRec instances, null for the reference). The record rides in the one
// kernel parameter: as a parameter of its own, the record walk measured
// 1-4% slower on the H100 (PERF.md).
struct SceneArgs : WalkArgs {
  const float4* __restrict__ rec;
};

// The frame record of a walk's inputs: none for WalkArgs.
__device__ __forceinline__ const float4* record_of(const WalkArgs&) {
  return nullptr;
}
__device__ __forceinline__ const float4* record_of(const SceneArgs& a) {
  return a.rec;
}

// The scene axis (the batched step of parallel/batch.py, the counterpart
// of JAX's vmap of the frame step, whose batching rule prepends the scene
// to the Pallas grid): S scenes of n rows each, every input stacked scene
// after scene (rows, pj, raw, occ and the output by n rows, start by
// r^3 + 1 entries, the scalar block by its kScalLanes lanes), one launch
// over a grid of (row blocks, S). blockIdx.y is the scene, so a block lies
// in one scene and its threads are the solo kernel's threads of that
// scene, on the scene's arrays, in the same walk order: the same sums, bit
// for bit. A flat grid over S * n rows would split a block between two
// scenes whenever n is not a multiple of kBlock, and cost each thread a
// division to find its scene. The scene axis walks the whole grid: no
// band, no dead rows.

// Scene s's inputs of a launch over the scene axis.
__device__ __forceinline__ WalkArgs scene_args(const WalkArgs& a, int s) {
  const size_t rows = (size_t)s * a.n;
  const size_t cells = (size_t)s * ((size_t)a.r * a.r * a.r + 1);
  return WalkArgs{a.rows + 2 * rows,
                  a.pj != nullptr ? a.pj + rows : nullptr, a.start + cells,
                  a.raw + rows, a.occ + rows,
                  a.scal + (size_t)s * kScalLanes,
                  a.n, a.r, a.cap, 0, a.r};
}
__device__ __forceinline__ SceneArgs scene_args(const SceneArgs& a, int s) {
  return SceneArgs{scene_args(static_cast<const WalkArgs&>(a), s),
                   a.rec != nullptr ? a.rec + (size_t)s * a.n : nullptr};
}

// The lane-group fold: the terms of the group's step, kSlots slots a lane
// (t), added by every lane of the group in lane order, each lane's slots in
// order, which is ascending slot order, with the one-thread walk's
// operations. Each value the variant adds travels as one __shfl_sync from
// its lane; a term that is one product, x * y, travels as its two factors,
// so the add contracts with it as it does in the one-thread walk. Without
// Kahan's sums a failed gate is applied by the lane that evaluated the
// slot: it zeroes the values (both factors of a product, since a factor
// the gate drops may be inf and 0 * inf is NaN), and the sums add them
// unselected. That is the same sum bit for bit: a sum starts at +0 and is
// never -0, so s + 0 and fma(0, 0, s) are s, and a NaN sum stays the one
// NaN the card's arithmetic gives. The two-accumulator form with the
// extensions adds v_j - v_i under both gates (pv: viscosity, use: XSPH), so
// there the gates travel as the group's ballots and each add is the
// one-thread walk's select, as with Kahan's sums.
template <bool kExt, bool kFacc, int kLanes, int kSlots>
__device__ __forceinline__ void add_group_terms(const PairTerms (&t)[kSlots],
                                                PairSums& acc) {
  constexpr bool kZero = !kKahan && (kFacc || !kExt);
  const int base = (threadIdx.x & 31) & ~(kLanes - 1);
  const unsigned group = ((1u << kLanes) - 1u) << base;
  PairTerms z[kSlots];
  unsigned use[kSlots], pv[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    z[k] = t[k];
    if constexpr (kZero) {
      if (!t[k].pv) {
        z[k].fx = z[k].fy = z[k].fz = 0.f;
        z[k].pc = z[k].gx = z[k].gy = z[k].gz = z[k].vc = 0.f;
        if (!kFacc) z[k].dvx = z[k].dvy = z[k].dvz = 0.f;
      }
      if (kExt && !t[k].use)
        z[k].xc = z[k].ac = z[k].dx = z[k].dy = z[k].dz = z[k].dvx =
            z[k].dvy = z[k].dvz = 0.f;
    } else {
      use[k] = __ballot_sync(group, t[k].use) >> base;
      pv[k] = __ballot_sync(group, t[k].pv) >> base;
    }
  }
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const auto from = [&](float v) {
        return __shfl_sync(group, v, l, kLanes);
      };
      PairTerms u;
      u.use = kZero || ((use[k] >> l) & 1u);
      u.pv = kZero || ((pv[k] >> l) & 1u);
      if constexpr (kFacc) {
        u.fx = from(z[k].fx), u.fy = from(z[k].fy), u.fz = from(z[k].fz);
      } else {
        u.pc = from(z[k].pc), u.gx = from(z[k].gx), u.gy = from(z[k].gy);
        u.gz = from(z[k].gz), u.vc = from(z[k].vc);
      }
      if constexpr (!kFacc || kExt) {
        u.dvx = from(z[k].dvx), u.dvy = from(z[k].dvy);
        u.dvz = from(z[k].dvz);
      }
      if constexpr (kExt) {
        u.dx = from(z[k].dx), u.dy = from(z[k].dy), u.dz = from(z[k].dz);
        u.xc = from(z[k].xc), u.ac = from(z[k].ac);
      }
      add_terms<kExt, kFacc>(u, acc);
    }
  }
}

// A pair's gate as range_walk passes it: a bool, or (the record walk) a
// callable.
__device__ __forceinline__ bool gate_of(bool use) { return use; }
template <typename Gate>
__device__ __forceinline__ bool gate_of(const Gate& use) {
  return use();
}

// The (press_j, inv_j) of slot q: pj[q], or the frame record's where the
// walk loaded it.
__device__ __forceinline__ float2 pj_of(const float2* __restrict__ pj,
                                        int q) {
  return __ldg(pj + q);
}
__device__ __forceinline__ float2 pj_of(const float2*, int, float2 rec_pj) {
  return rec_pj;
}

// Row i's pair sums (j == i skipped) in walk order (ascending sorted
// index), kSlots slots a step: two without the extensions, one with them
// (the second pair's registers cost more occupancy than the overlap gains),
// in the library's variant (sph_common.cuh: kFacc, kKahan, kBf16). The bf16
// instance with extensions reads rho_j from the rows and not from pj, as
// JAX's window kernel does there (pallas_sph.py:1191-1203). With kLanes > 1
// the thread is lane `lane` of the row's group, which walks kSlots slots a
// lane a step and adds the group's terms in slot order (add_group_terms):
// every lane ends with the row's sums, bit for bit those of kLanes = 1.
// With kRec each slot's gate and (press_j, inv_j) come from the frame
// record (SceneArgs; range_walk), bit for bit the same sums. With CandArgs
// (Args::kRounded) each candidate comes from the rounded copy
// (unpack_candidate), with its inv_j, and press_j is computed in the walk by
// candidate<true>'s expression: the compiler fuses its product into the
// pair's press_i + press_j, so a press_j rounded ahead of the walk would
// change the sums (scenes whose rest density has a long mantissa: PERF.md);
// the same sums, bit for bit.
template <bool kExt, bool kBand, int kLanes = 1, int kSlots = kExt ? 1 : 2,
          bool kRec = false, typename Args>
__device__ __forceinline__ void window_pair_sums(const Scalars& s,
                                                 const Particle& p, int i,
                                                 const Args& a,
                                                 PairSums& acc,
                                                 int lane = 0) {
  const int r = a.r;
  const float press_i = s.gas_k * (p.rho - s.rho0);
  const float vmu = p.rho > kEps ? s.visc : 1.f;   // fuse_acc's row factor
  const int cx = fresh_coord(p.px, r), cy = fresh_coord(p.py, r),
            cz = fresh_coord(p.pz, r);
  if constexpr (kLanes == 1) {
    range_walk<kSlots, true, kBand, 1, kRec ? kFrameRecord : kNoRecord>(
        cx, cy, cz, i, r, a.cap, a.zbase, a.z_span, a.start, a.raw, a.occ,
        [&](int q, const auto& use, auto... rec_pj) {   // rec_pj: kRec's
          float4 qa, qb;
          if constexpr (Args::kRounded) {
            unpack_candidate(a, q, qa, qb);
          } else {
            qa = __ldg(a.rows + 2 * q);
            qb = __ldg(a.rows + 2 * q + 1);
          }
          float press_j, inv_j;
          if constexpr (Args::kRounded) {
            press_j = s.gas_k * (qb.z - s.rho0);   // as candidate<true>
            inv_j = qb.w;
          } else {
            candidate<kExt>(s, qa, qb, press_j, inv_j,
                            [&] { return pj_of(a.pj, q, rec_pj...); });
          }
          add_pair_pj<kExt, kFacc>(s, p, press_i, vmu, qa, qb, press_j,
                                   inv_j, gate_of(use), acc);
        },
        0, record_of(a));
  } else {
    range_walk<kSlots, true, kBand, kLanes>(
        cx, cy, cz, i, r, a.cap, a.zbase, a.z_span, a.start, a.raw, a.occ,
        [&](int j0, int e, const auto& member) {
          PairTerms t[kSlots];
#pragma unroll
          for (int k = 0; k < kSlots; ++k) {
            const int q = min(j0 + k, e - 1);
            const bool use = j0 + k < e && member(q);
            float4 qa = __ldg(a.rows + 2 * q), qb = __ldg(a.rows + 2 * q + 1);
            float press_j, inv_j;
            candidate<kExt>(s, qa, qb, press_j, inv_j,
                            [&] { return __ldg(a.pj + q); });
            t[k] = pair_terms<kExt, kFacc>(s, p, press_i, vmu, qa, qb,
                                           press_j, inv_j, use);
          }
          add_group_terms<kExt, kFacc, kLanes, kSlots>(t, acc);
        },
        lane);
  }
}

// The body of K2 and K3: the pair sums of row blockIdx.x * blockDim.x +
// threadIdx.x, passed to done(s, p, i, acc); with kBand a dead row is
// passed to dead(i) instead, and walks nothing. With kLanes > 1 each row
// takes a group of kLanes consecutive threads (a launch of n * kLanes
// threads), whose first lane calls done or dead; kSlots and kRec are
// window_pair_sums', and `a` is WalkArgs or (kRec) SceneArgs.
template <bool kExt, bool kBand, int kLanes = 1, int kSlots = kExt ? 1 : 2,
          bool kRec = false, typename Args, typename Done, typename Dead>
__device__ __forceinline__ void walk_row(const Args& a, Done&& done,
                                         Dead&& dead) {
  static_assert(kLanes >= 1 && kLanes <= 32 && !(kLanes & (kLanes - 1)),
                "a lane group is a power of two within a warp");
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t / kLanes, lane = t % kLanes;
  if (i >= a.n) return;
  if (kBand && dead_row(i, a.start, a.r, a.z_span)) {
    if (lane == 0) dead(i);
    return;
  }
  const Scalars s = load_scalars(a.scal);
  const Particle p = load_particle(a.rows, i);
  PairSums acc;
  window_pair_sums<kExt, kBand, kLanes, kSlots, kRec>(s, p, i, a, acc, lane);
  if (lane == 0) done(s, p, i, acc);
}

// Whether a launch over band (zbase, z_span) takes the kBand instance: any
// band but the whole grid.
inline bool banded(int zbase, int z_span, int r) {
  return zbase != 0 || z_span != r;
}

// Launches a walk kernel whose rows take `lanes` threads each, in blocks of
// kBlock, on stream st.
using WalkKernel = void (*)(WalkArgs, float4*);
inline int launch_walk(WalkKernel kernel, int lanes, const WalkArgs& a,
                       float4* out, cudaStream_t st) {
  if (a.n > 0)
    kernel<<<(a.n * lanes + kBlock - 1) / kBlock, kBlock, 0, st>>>(a, out);
  return (int)cudaGetLastError();
}

// Launches the instance of K2 or K3 for the extension switch and the band,
// one thread per row. Kernel<kExt, kBand> is given as its four instances.
inline int launch_walk(const WalkKernel (&instances)[2][2], bool ext,
                       const WalkArgs& a, float4* out, cudaStream_t st) {
  return launch_walk(
      instances[ext ? 1 : 0][banded(a.zbase, a.z_span, a.r) ? 1 : 0], 1, a,
      out, st);
}

// A scene-axis kernel of K2 or K3: (inputs over every scene, the output).
using SceneKernel = void (*)(SceneArgs, float4*);

// Launches the scene-axis instance of K2 or K3 for the extension switch
// over `scenes` scenes of a.n rows (scene_args), grid (row blocks, scenes),
// on stream st; `instances` is the kernel without and with kExt.
inline int launch_walk_scenes(const SceneKernel (&instances)[2], bool ext,
                              const SceneArgs& a, int scenes, float4* out,
                              cudaStream_t st) {
  if (a.n > 0 && scenes > 0)
    instances[ext ? 1 : 0]<<<dim3((a.n + kBlock - 1) / kBlock, scenes),
                             kBlock, 0, st>>>(a, out);
  return (int)cudaGetLastError();
}

}  // namespace sph
