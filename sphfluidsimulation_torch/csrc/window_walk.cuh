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
#pragma once

#include "sph_common.cuh"

namespace sph {

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
// cut cell is one range of consecutive slots. kStep slots a step (1 or 2):
// the second call of a step may repeat the first slot with use = false.
template <int kStep, bool kSkipSelf, bool kBand, typename Pair>
__device__ __forceinline__ void range_walk(int cx, int cy, int cz, int i,
                                           int r, int cap, int zbase,
                                           int z_span,
                                           const int* __restrict__ start,
                                           const int* __restrict__ raw,
                                           const uint8_t* __restrict__ occ,
                                           Pair&& pair) {
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
        for (; q < e; q += kStep) {
          pair(q, member(q));
          if constexpr (kStep == 2) {
            const int q2 = min(q + 1, e - 1);
            pair(q2, q2 > q && member(q2));
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
};

// Row i's pair sums (j == i skipped) in walk order (ascending sorted
// index), two slots a step without the extensions (with them, the second
// pair's registers cost more occupancy than the overlap gains), in the
// library's variant (sph_common.cuh: kFacc, kKahan, kBf16). The bf16
// instance with extensions reads rho_j from the rows and not from pj, as
// JAX's window kernel does there (pallas_sph.py:1191-1203).
template <bool kExt, bool kBand>
__device__ __forceinline__ void window_pair_sums(const Scalars& s,
                                                 const Particle& p, int i,
                                                 const WalkArgs& a,
                                                 PairSums& acc) {
  const int r = a.r;
  const float press_i = s.gas_k * (p.rho - s.rho0);
  const float vmu = p.rho > kEps ? s.visc : 1.f;   // fuse_acc's row factor
  range_walk<kExt ? 1 : 2, true, kBand>(
      fresh_coord(p.px, r), fresh_coord(p.py, r), fresh_coord(p.pz, r), i, r,
      a.cap, a.zbase, a.z_span, a.start, a.raw, a.occ,
      [&](int q, bool use) {
        float4 qa = __ldg(a.rows + 2 * q), qb = __ldg(a.rows + 2 * q + 1);
        float press_j, inv_j;
        candidate<kExt>(s, qa, qb, press_j, inv_j,
                        [&] { return __ldg(a.pj + q); });
        add_pair_pj<kExt, kFacc>(s, p, press_i, vmu, qa, qb, press_j, inv_j,
                                 use, acc);
      });
}

// The body of K2 and K3: the pair sums of row blockIdx.x * blockDim.x +
// threadIdx.x, passed to done(s, p, i, acc); with kBand a dead row is
// passed to dead(i) instead, and walks nothing.
template <bool kExt, bool kBand, typename Done, typename Dead>
__device__ __forceinline__ void walk_row(const WalkArgs& a, Done&& done,
                                         Dead&& dead) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  if (kBand && dead_row(i, a.start, a.r, a.z_span)) {
    dead(i);
    return;
  }
  const Scalars s = load_scalars(a.scal);
  const Particle p = load_particle(a.rows, i);
  PairSums acc;
  window_pair_sums<kExt, kBand>(s, p, i, a, acc);
  done(s, p, i, acc);
}

// Whether a launch over band (zbase, z_span) takes the kBand instance: any
// band but the whole grid.
inline bool banded(int zbase, int z_span, int r) {
  return zbase != 0 || z_span != r;
}

// Launches the instance of K2 or K3 for the extension switch and the band,
// one thread per row in blocks of kBlock, on stream st. Kernel<kExt, kBand>
// is given as its four instances.
using WalkKernel = void (*)(WalkArgs, float4*);
inline int launch_walk(const WalkKernel (&instances)[2][2], bool ext,
                       const WalkArgs& a, float4* out, cudaStream_t st) {
  const WalkKernel kernel =
      instances[ext ? 1 : 0][banded(a.zbase, a.z_span, a.r) ? 1 : 0];
  if (a.n > 0)
    kernel<<<(a.n + kBlock - 1) / kBlock, kBlock, 0, st>>>(a, out);
  return (int)cudaGetLastError();
}

}  // namespace sph
