// K5: the compact-lane route, one warp per tile of 32 sorted rows.
//
// Replaces the TPU kernel sphfluidsimulation_tpu/ops/pallas_compact.py::
// _compact_kernel (:237), launched by _call_compact (pallas_call at :577)
// from density_compact (:622), compact_substep (:648) and forces_compact
// (:681). Three modes share one body:
//   density  rho_i = m * sum_j W_poly6, self included, over the tile's stale
//            segments (pos f32[N, 3] -> rho f32[N]);
//   forces   the raw pair sums of K3 without extensions, j == i skipped
//            (rows f32[N, 8] + pj f32[N, 2] -> f32[N, 12], lanes 6-11 zero);
//   fused    one whole substep, the tail of K2 (rows + pj -> rows), with kExt
//            the XSPH and artificial-viscosity sums.
// The tile's cell span is the min/max of its rows' anchor cells (density)
// or of their fresh cells clipped to the grid, clamped to that stale span
// +- one cell plane; rows outside the band are the drift count, added to
// *cert (ops/compact.py::fresh_spans computes the same). Each (dz, dy) line
// gives the cells [lo + off - 1, hi + off + 2), the nine deduplicated so
// that their union holds each cell once (ops/compact.py::tile_cells). Every
// row evaluates every candidate of the union under the exact gate of K1-K3:
// occupied, raw cell within Chebyshev 1 of the row's fresh cell, and j != i
// for the force modes. The pair terms are sph_common.cuh's add_density and
// add_pair_pj, and the fused tail is fused_tail, so K5 cannot drift from
// K1-K3. A row sums its candidates in ascending sorted order, as K1-K3 do.
//
// Scene-axis instances (compact_scenes_kernel, sph_compact_scenes): the
// three modes under JAX's vmap of the frame step (parallel/batch.py:42-46,
// the SPH_PALLAS_COMPACT=1 sweep), one launch over S stacked frames,
// blockIdx.y the scene, each scene with its own drift count.
//
// Banded instances (kBand; density_compact(band=) :622-629 and
// compact_substep(band=) :648-665, for the slab step's frame): the cells
// are the band's local ids (z_span * R^2 of them from plane zbase, cid and
// start[] local; a fresh cell's z is clipped into the band as
// fresh_spans(band=) :147-186 does), the gate reads global raw ids, and
// the rows from start[s_cells] on are dead: their density is 0, the
// substep copies them through, and they enter neither a span nor the drift
// count. The band is a template argument, as K1's and K2's are: reading it
// at run time cost K2-ext and K3 7-8% (PERF.md). With SPH_BF16=1 the force
// modes read the candidates' vx, vy, vz and rho rounded to bfloat16, and
// press_j and 1/rho_j computed from the rounded rho, as JAX's compact
// kernel reads its bf16 window (pallas_compact.py:249, :416-418); density
// reads positions only.
//
// What bounds it on the H100: every row evaluates every candidate the tile
// keeps, a few times its own member pairs where the tile's rows share their
// cells, and far more where they spread over many (a tile's span widens
// within a frame as rows cross cell planes: at 262k, two substeps into
// frame 10, the union of a tenth of the tiles spans some 6,700 cells), so it
// does several times K2's pair operations; before those, the warp must find
// the candidates among the union's slots. Wall piles hold runs far longer
// than the capacity, all of whose slots past it are unoccupied: at the
// start of frame 10 at 262k a tile's union holds about 15,000 slots, of
// which about 300 are occupied.
//
// What the design does about it: the warp streams only each union cell's
// capacity-cut prefix, the only slots that can be occupied, in slot order,
// so empty cells cost nothing. The union is nine disjoint slot segments
// (the lines deduplicated at cell level by a warp prefix max); lane l reads
// slot base + l with coalesced loads of occ and raw. A slot that is
// unoccupied and past its cell's capacity stops the round there (a ballot
// finds the first), and the next round starts at the next cell's first
// slot, so the rest of a pile is never read. A second ballot keeps the
// occupied slots whose raw cell lies within 1 of the tile's fresh-cell
// bounding box and writes them densely to shared memory (48-byte slots,
// 1.5 KB a warp); each lane walks that list with its own gate as a branch,
// so the warp skips whole a candidate near none of its rows (a warp vote,
// or whole-term selects, there measured slower: PERF.md). The force pair is
// add_pair_pj, with no IEEE division; its own guards are selects, so no
// 0 * inf reaches a sum. Enumerating the union's cells 32 at a time with a
// prefix sum of their capped lengths, the other way to the same stream,
// measured slower: most cells of a wide union are empty.
#include <climits>

#include "sph_common.cuh"

namespace {

constexpr int kWarps = 4;            // tiles per block
constexpr int kLines = 9;            // (dz, dy) candidate lines per tile
constexpr int kMaxR = 1024;          // raw cells pack 10 bits a coordinate
constexpr unsigned kAll = 0xffffffffu;
enum Mode { kDensity = 0, kForces = 1, kFused = 2 };

// One compacted candidate: its rows entry (a.xyz only in density mode), its
// pj entry (force modes), its sorted index and its decoded raw cell packed
// as x | y << 10 | z << 20.
struct Slot {
  float4 a, b;
  float2 pj;
  int j, cell;
};

__device__ __forceinline__ int warp_scan_max(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kAll, v, d);
    if (lane >= d) v = max(v, t);
  }
  return v;
}

__device__ __forceinline__ int warp_min(bool live, int v) {
  return __reduce_min_sync(kAll, live ? v : INT_MAX);
}

__device__ __forceinline__ int warp_max(bool live, int v) {
  return __reduce_max_sync(kAll, live ? v : INT_MIN);
}

// c within Chebyshev 1 of (cx, cy, cz) on each axis, c packed as in Slot
__device__ __forceinline__ bool cell_near(int c, int cx, int cy, int cz) {
  return (unsigned)((c & 1023) - cx + 1) <= 2u
         && (unsigned)(((c >> 10) & 1023) - cy + 1) <= 2u
         && (unsigned)((c >> 20) - cz + 1) <= 2u;
}

// The tile of warp threadIdx.x / 32 of block blockIdx.x over one frame's
// arrays: the body of compact_kernel and of compact_scenes_kernel.
template <int kMode, bool kExt, bool kBand>
__device__ __forceinline__ void compact_tile(
    const float* __restrict__ in, const float2* __restrict__ pj,
    const int* __restrict__ cid, const int* __restrict__ start,
    const int* __restrict__ raw, const uint8_t* __restrict__ occ,
    const float* __restrict__ scal, float* __restrict__ out,
    int* __restrict__ cert, int n, int r, int cap, int zbase, int z_span) {
  __shared__ Slot slots[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile * 32 >= n) return;              // the whole warp leaves
  const int i = tile * 32 + lane;
  const int s_cells = kBand ? z_span * r * r : r * r * r;
  // the live rows: all n, or in a slab's frame those before the dead rows
  const int n_live = kBand ? __ldg(start + s_cells) : n;
  const bool live = i < n_live;            // the last tile is ragged
  const float4* __restrict__ rows4 = reinterpret_cast<const float4*>(in);
  float4* __restrict__ out4 = reinterpret_cast<float4*>(out);
  const auto dead = [&] {                  // row i of a slab's dead rows
    if constexpr (kMode == kDensity) {
      out[i] = 0.f;
    } else if constexpr (kMode == kForces) {
      sph::store_sums<false>(out4, i, sph::PairSums{});
    } else {
      out4[2 * i] = __ldg(rows4 + 2 * i);
      out4[2 * i + 1] = __ldg(rows4 + 2 * i + 1);
    }
  };
  if (kBand && tile * 32 >= n_live) {      // a tile of dead rows
    if (i < n) dead();
    return;
  }
  const sph::Scalars s = sph::load_scalars(scal);

  sph::Particle p{};
  if (live) {
    if constexpr (kMode == kDensity) {
      p.px = __ldg(in + 3 * i);
      p.py = __ldg(in + 3 * i + 1);
      p.pz = __ldg(in + 3 * i + 2);
    } else {
      p = sph::load_particle(rows4, i);
    }
  }
  const int cx = sph::fresh_coord(p.px, r);
  const int cy = sph::fresh_coord(p.py, r);
  const int cz = sph::fresh_coord(p.pz, r);

  // the tile's cell span (stale_spans; fresh_spans in the force modes)
  const int c = live ? __ldg(cid + i) : 0;
  int lo = warp_min(live, c), hi = warp_max(live, c);
  if constexpr (kMode != kDensity) {
    const int lz = kBand ? min(max(min(max(cz, 0), r - 1) - zbase, 0),
                               z_span - 1)
                         : min(max(cz, 0), r - 1);
    const int fcid = min(max(cx, 0), r - 1) + min(max(cy, 0), r - 1) * r
                     + lz * r * r;
    const int band = r * r + r + 1;
    const int lo_allow = lo - band, hi_allow = hi + band;
    const unsigned drift =
        __ballot_sync(kAll, live && (fcid < lo_allow || fcid > hi_allow));
    if (lane == 0 && drift) atomicAdd(cert, __popc(drift));
    lo = min(max(min(max(warp_min(live, fcid), lo_allow), hi_allow), 0),
             s_cells - 1);
    hi = min(max(min(max(warp_max(live, fcid), lo_allow), hi_allow), 0),
             s_cells - 1);
  }

  // the nine lines' cells [ca, cb), deduplicated: cb'_k is the running max
  // of max(ca, cb) over lines 0..k, ca'_k = max(ca_k, cb'_{k-1}); start[] is
  // monotone, so their slots [start[ca'], start[cb']) are disjoint and
  // ascending, and their union is that of the nine lines' slots
  int ca = 0, cb = 0;
  if (lane < kLines) {
    const int off = (lane / 3 - 1) * r * r + (lane % 3 - 1) * r;
    ca = min(max(lo + off - 1, 0), s_cells);
    cb = min(max(hi + off + 2, 0), s_cells);
  }
  const int cb_run = warp_scan_max(max(ca, cb), lane);
  const int prev = __shfl_up_sync(kAll, cb_run, 1);
  ca = max(ca, lane == 0 ? 0 : prev);
  int seg_a = 0, seg_b = 0;
  if (lane < kLines) {
    seg_a = __ldg(start + ca);
    seg_b = __ldg(start + cb_run);
  }
  // the ballot's filter: within 1 of the tile's fresh-cell bounding box
  const int x0 = warp_min(live, cx) - 1, x1 = warp_max(live, cx) + 1;
  const int y0 = warp_min(live, cy) - 1, y1 = warp_max(live, cy) + 1;
  const int z0 = warp_min(live, cz) - 1, z1 = warp_max(live, cz) + 1;

  const float press_i = s.gas_k * (p.rho - s.rho0);
  sph::PairSums acc;
  sph::Acc dens;
  for (int k = 0; k < kLines; ++k) {
    int base = __shfl_sync(kAll, seg_a, k);
    const int seg_end = __shfl_sync(kAll, seg_b, k);
    while (base < seg_end) {
      // lane l reads slot base + l: occupied, or past its cell's capacity
      // (then the round stops there and the next starts at the next cell)
      const int j = base + lane;
      bool keep = false, over = false;
      int packed = 0, skip_to = 0;
      if (j < seg_end) {
        if (__ldg(occ + j)) {               // occupied: raw is in the grid
          const int rj = __ldg(raw + j);
          const int z = rj / (r * r);
          const int rem = rj - z * r * r;
          const int y = rem / r;
          const int x = rem - y * r;
          keep = x >= x0 && x <= x1 && y >= y0 && y <= y1 && z >= z0 &&
                 z <= z1;
          packed = x | y << 10 | z << 20;
        } else if (cap >= 0) {
          const int cj = __ldg(cid + j);
          over = j - __ldg(start + cj) >= cap;
          skip_to = __ldg(start + cj + 1);
        }
      }
      const unsigned overs = __ballot_sync(kAll, over);
      const int stop = overs ? __ffs(overs) - 1 : 32;
      base = overs ? __shfl_sync(kAll, skip_to, stop) : base + 32;
      const unsigned mask = __ballot_sync(kAll, keep && lane < stop);
      if (keep && lane < stop) {
        Slot& e = slots[warp][__popc(mask & ((1u << lane) - 1u))];
        if constexpr (kMode == kDensity) {
          e.a = make_float4(__ldg(in + 3 * j), __ldg(in + 3 * j + 1),
                            __ldg(in + 3 * j + 2), 0.f);
        } else {
          e.a = __ldg(rows4 + 2 * j);
          e.b = __ldg(rows4 + 2 * j + 1);
          float press_j, inv_j;
          sph::candidate<true>(s, e.a, e.b, press_j, inv_j,
                               [&] { return __ldg(pj + j); });
          e.pj = make_float2(press_j, inv_j);
        }
        e.j = j;
        e.cell = packed;
      }
      __syncwarp();
      // each row's own gate, a branch: where the tile's rows spread over
      // many cells, most of what the box keeps is near none of them, and
      // the warp then skips the candidate whole
      const int count = __popc(mask);
      if (live) {
        for (int t = 0; t < count; ++t) {
          const Slot& e = slots[warp][t];
          if (!cell_near(e.cell, cx, cy, cz)) continue;
          if constexpr (kMode == kDensity) {
            sph::add_density(s, p.px, p.py, p.pz, e.a.x, e.a.y, e.a.z, true,
                             dens);
          } else {
            if (e.j == i) continue;        // VelPos.compute:82
            sph::add_pair_pj<kExt, false>(s, p, press_i, 1.f, e.a, e.b,
                                          e.pj.x, e.pj.y, true, acc);
          }
        }
      }
      __syncwarp();                        // the slots are rewritten next
    }
  }

  if (!live) {
    if (kBand && i < n) dead();
    return;
  }
  if constexpr (kMode == kDensity) {
    out[i] = s.mass * sph::total(dens);
  } else if constexpr (kMode == kForces) {
    sph::store_sums<false>(out4, i, acc);
  } else {
    sph::fused_tail<kExt, false>(s, p, acc, out4, i);
  }
}

template <int kMode, bool kExt, bool kBand>
__global__ void __launch_bounds__(kWarps * 32)
compact_kernel(const float* __restrict__ in, const float2* __restrict__ pj,
               const int* __restrict__ cid, const int* __restrict__ start,
               const int* __restrict__ raw, const uint8_t* __restrict__ occ,
               const float* __restrict__ scal, float* __restrict__ out,
               int* __restrict__ cert, int n, int r, int cap, int zbase,
               int z_span) {
  compact_tile<kMode, kExt, kBand>(in, pj, cid, start, raw, occ, scal, out,
                                   cert, n, r, cap, zbase, z_span);
}

// The scene-axis instance (JAX's vmap of _call_compact): blockIdx.y is the
// scene, whose inputs are the scene's blocks of the stacked arrays (n rows
// of in, pj, cid, raw, occ and out, R^3 + 1 entries of start, one scalar
// block) and whose drift count is cert[scene]; a tile is scene-local, so
// each warp is the solo kernel's warp of that scene. The whole grid only.
template <int kMode, bool kExt>
__global__ void __launch_bounds__(kWarps * 32)
compact_scenes_kernel(const float* __restrict__ in,
                      const float2* __restrict__ pj,
                      const int* __restrict__ cid,
                      const int* __restrict__ start,
                      const int* __restrict__ raw,
                      const uint8_t* __restrict__ occ,
                      const float* __restrict__ scal, float* __restrict__ out,
                      int* __restrict__ cert, int n, int r, int cap) {
  constexpr int kIn = kMode == kDensity ? 3 : 8;      // floats a row
  constexpr int kOut = kMode == kDensity ? 1 : kMode == kForces ? 12 : 8;
  const size_t scene = blockIdx.y;
  const size_t rows = scene * n;
  const size_t cells = scene * ((size_t)r * r * r + 1);
  compact_tile<kMode, kExt, false>(
      in + kIn * rows, kMode == kDensity ? pj : pj + rows, cid + rows,
      start + cells, raw + rows, occ + rows, scal + scene * sph::kScalLanes,
      out + kOut * rows, cert + scene, n, r, cap, 0, r);
}

}  // namespace

// mode: 0 density (in = pos f32[N, 3], out = rho f32[N]; pj unused, may be
// null), 1 forces without extensions (in = rows f32[N, 8], pj f32[N, 2], out
// = f32[N, 12]), 2 fused substep (in = rows, pj, out = rows; ext != 0 adds
// the extension sums). *cert (zeroed by the caller) receives the drift count
// of the force modes. cap is the voxel capacity of the frame (< 0: uncut);
// r is at most 1024. (zbase, z_span) is the frame's band of z-planes, (0, r)
// for the whole grid; density and the fused substep have banded instances
// (the slab step's), the forces mode has none.
extern "C" int sph_compact(int mode, int ext, const float* in, const float* pj,
                           const int* cid, const int* start, const int* raw,
                           const uint8_t* occ, const float* scal, float* out,
                           int* cert, int n, int r, int cap, int zbase,
                           int z_span, void* stream) {
  const bool band = zbase != 0 || z_span != r;
  if (mode < kDensity || mode > kFused || (ext && mode != kFused) ||
      r > kMaxR || (mode != kDensity && pj == nullptr) ||
      (band && mode == kForces))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int tiles = (n + 31) / 32;
    const int blocks = (tiles + kWarps - 1) / kWarps;
    auto kernel =
        mode == kDensity ? (band ? compact_kernel<kDensity, false, true>
                                 : compact_kernel<kDensity, false, false>)
        : mode == kForces ? compact_kernel<kForces, false, false>
        : ext ? (band ? compact_kernel<kFused, true, true>
                      : compact_kernel<kFused, true, false>)
              : (band ? compact_kernel<kFused, false, true>
                      : compact_kernel<kFused, false, false>);
    kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        in, reinterpret_cast<const float2*>(pj), cid, start, raw, occ, scal,
        out, cert, n, r, cap, zbase, z_span);
  }
  return (int)cudaGetLastError();
}

// K5 over `scenes` scenes of n rows each (JAX's vmap of density_compact,
// compact_substep and forces_compact): every input stacked scene after
// scene as compact_scenes_kernel reads it, cert i32[scenes] (zeroed by the
// caller) each scene's drift count; mode, ext, cap and r as in sph_compact,
// over the whole grid. One launch, grid (tile blocks, scenes).
extern "C" int sph_compact_scenes(int mode, int ext, const float* in,
                                  const float* pj, const int* cid,
                                  const int* start, const int* raw,
                                  const uint8_t* occ, const float* scal,
                                  float* out, int* cert, int n, int r,
                                  int cap, int scenes, void* stream) {
  if (mode < kDensity || mode > kFused || (ext && mode != kFused) ||
      r > kMaxR || (mode != kDensity && pj == nullptr) || scenes < 0 ||
      scenes > 65535)
    return (int)cudaErrorInvalidValue;
  if (n > 0 && scenes > 0) {
    const int tiles = (n + 31) / 32;
    const dim3 grid((tiles + kWarps - 1) / kWarps, scenes);
    auto kernel = mode == kDensity ? compact_scenes_kernel<kDensity, false>
                  : mode == kForces ? compact_scenes_kernel<kForces, false>
                  : ext             ? compact_scenes_kernel<kFused, true>
                                    : compact_scenes_kernel<kFused, false>;
    kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
        in, reinterpret_cast<const float2*>(pj), cid, start, raw, occ, scal,
        out, cert, n, r, cap);
  }
  return (int)cudaGetLastError();
}
