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
// blockIdx.y the scene, each scene with its own drift count. Density there
// reads occ, raw and the positions as the solo launch does: a 16-byte
// density record a slot (K1's scene walk's) measured slower with its build
// counted, and decoding raw ids by multiply-highs in place of the two
// divisions gained 1.4% there and cost solo density up to 2% (PERF.md;
// scripts/torch_k5_ab.py compiles both from patched copies).
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
//
// The forces mode's two walks (Tile::walk): the tiles are frame-start tiles
// (K5 forces runs on rows re-sorted just before it), and the warp runs the
// pair for nearly every kept slot, with only the lanes whose rows are near
// it. Mode kForcesOwn (the lanes' own lists): each live lane first sets a
// bit for each of the round's slots near its own cell and not itself
// (broadcast reads of the slots' cells and indices), then walks only its
// set bits in ascending order, so that the warp's pair steps are the
// largest of its lanes' counts, not the round's kept slots
// (ops/compact.py::walk_counts counts both). Mode kForces steps every lane
// through the round's list. Each row adds the same candidates in the same
// order in both, so its sums are the same bits. The mask costs a loop over
// the round's slots, which pays where lanes own few of them (2.5 rows a
// cell: 0.69 of the round's pairs, −17%) and not where one lane owns
// nearly all (5 rows a cell: 0.93, +1% solo, +8% over the scene axis), so
// the wrappers take the own lists below compact.OWN_LISTS_ROWS_PER_CELL
// rows a cell (PERF.md). Density and the fused substep walk the list.
//
// Splitting a wide tile (the split launch, sph_compact_split, of the fused
// substep and of density over one frame, which the slab step's banded
// density takes; ops/compact.py): one warp walking a wide union alone makes
// a launch wait on its slowest tile; a slab's launch is less than one wave
// of warps, so it lasts as long as its widest union. In the split launch
// each warp first counts its tile's cost, the occupied slots of its union,
// from occ_cum (the frame's prefix count of occupied slots, so the cost and
// the cuts do not depend on the capacity argument). A tile at or below the
// threshold `split` is walked whole, as above. A heavier one is cut into
// k = min(16, ceil(cost / split)) chunks of about equal cost, each a range
// of cells, so that each starts at a cell's first slot and the capacity
// stop works unchanged; the warp queues the k chunks and leaves. The second
// kernel (compact_chunk_kernel; compact_density_chunk_kernel), a wave of
// resident warps, starts beside the first one's last blocks (programmatic
// dependent launch) once every tile is seen: each warp takes the next
// queued chunk, walks it with the stream above, and stores its rows'
// partial sums; the last of a tile's chunks to finish (a per-tile counter)
// adds the k partials in ascending chunk order (no float atomics) and runs
// the tail (density: one partial sum a row, then rho). A tile past the
// queue's end (4 chunks a tile on average) is walked by one warp, chunk
// after chunk, its sums added in the same order. A tile's result is then
// the same bits whichever warps walk its chunks, in every instance of the
// same frame (solo, scenes, a replayed graph). The drift count stays a
// per-tile fact, added once, by the first kernel. SPH_TILE_CLOCK=1 builds
// an instance that writes each chunk's (each whole tile's) %globaltimer
// span and clock64 cycles.
#include <climits>

#include "sph_common.cuh"

#ifndef SPH_TILE_CLOCK
#define SPH_TILE_CLOCK 0
#endif

namespace {

constexpr int kWarps = 4;            // tiles (chunks) per block
constexpr int kChunks = 16;          // the most chunks of a split tile
constexpr int kQueued = 4;           // the queue's chunks a tile
// blocks an SM holds of the chunk kernel without extensions: its registers
// capped at 65536 / (128 * 9) = 56, as the whole-tile kernel's (measured
// faster, with extensions slower: PERF.md)
constexpr int kChunkBlocks = 9;
constexpr int kLines = 9;            // (dz, dy) candidate lines per tile
constexpr int kMaxR = 1024;          // raw cells pack 10 bits a coordinate
constexpr unsigned kAll = 0xffffffffu;
constexpr bool kClock = SPH_TILE_CLOCK != 0;
constexpr int kClockLanes = 4;       // start ns, end ns, cycles, cells
// kForcesOwn: the forces mode through the lanes' own lists
enum Mode { kDensity = 0, kForces = 1, kFused = 2, kForcesOwn = 3 };

// One compacted candidate: its rows entry (a.xyz only in density mode), its
// pj entry (force modes), its sorted index and its decoded raw cell packed
// as x | y << 10 | z << 20.
struct Slot {
  float4 a, b;
  float2 pj;
  int j, cell;
};

// One frame's arrays (a scene's blocks of them on the scene axis).
struct Frame {
  const float* in;
  const float2* pj;
  const int* cid;
  const int* start;
  const int* raw;
  const uint8_t* occ;
  const int* occ_cum;      // occupied slots before each sorted index [n + 1]
  const float* scal;
  float* out;
  int* cert;
};

struct Geom {
  int n, r, cap, zbase, z_span;
};

// The split launch's queue over S scenes of T tiles (ops/compact.py::
// _split_scratch), count zero before the launch; `slot` numbers the split
// tiles. split 0: no split (the whole-tile launch), only clock is read.
struct Queue {
  int split;               // occupied union slots past which a tile splits
  int tiles;               // S * T
  int cap;                 // chunks the queue holds: kQueued * S * T
  int* count;              // [6]: slots, chunks reserved, chunks taken,
                           // tiles past the end, those taken, tiles seen
  int* owner;              // [S * T] each slot's scene * T + tile
  int* first;              // [S * T] each slot's first chunk in the queue
  int* done;               // [S * T] each slot's chunks finished
  int* rest;               // [S * T] the tiles past the queue's end
  int* item;               // [cap] slot * kChunks + chunk, or -1
  float* part;             // [cap, fields, 32] each chunk's partial sums
  long long* clock;        // SPH_TILE_CLOCK [S, T, kChunks, kClockLanes]
};

__device__ __forceinline__ int warp_scan_max(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kAll, v, d);
    if (lane >= d) v = max(v, t);
  }
  return v;
}

__device__ __forceinline__ int warp_scan_add(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kAll, v, d);
    if (lane >= d) v += t;
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

// the chunks of a tile of `cost` occupied slots past the threshold
__device__ __forceinline__ int chunks_of(int cost, int split) {
  return min(kChunks, (cost + split - 1) / split);
}

// the warp's compacted candidates (one shared array a kernel)
__device__ __forceinline__ Slot* warp_slots() {
  __shared__ Slot slots[kWarps][32];
  return slots[threadIdx.x >> 5];
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// SPH_TILE_CLOCK: a scene's entries of the clock buffer, or null
__device__ __forceinline__ long long* tile_clock(long long* clock, int scene,
                                                 int tiles) {
  return kClock && clock != nullptr
             ? clock + (size_t)scene * tiles * kChunks * kClockLanes
             : nullptr;
}

// SPH_TILE_CLOCK: a warp's span over one chunk of one tile
struct Clock {
  long long t0 = 0, c0 = 0;
  __device__ void start() {
    if constexpr (kClock) {
      t0 = global_ns();
      c0 = clock64();
    }
  }
  __device__ void stop(long long* clk, int tile, int chunk, int cell0,
                       int cell1) const {
    if constexpr (kClock) {
      if (clk != nullptr && (threadIdx.x & 31) == 0) {
        long long* e = clk + ((size_t)tile * kChunks + chunk) * kClockLanes;
        e[0] = t0;
        e[1] = global_ns();
        e[2] = clock64() - c0;
        e[3] = (long long)(unsigned)cell0 | (long long)cell1 << 32;
      }
    }
  }
};

// Scene `scene`'s blocks of the stacked arrays (n rows of in, pj, cid, raw,
// occ and out, R^3 + 1 entries of start, n + 1 of occ_cum, one scalar block,
// one drift count); scene 0 is the solo launch's frame.
template <int kMode>
__device__ __forceinline__ Frame scene_block(Frame f, int scene, int n,
                                             int r) {
  constexpr int kIn = kMode == kDensity ? 3 : 8;      // floats a row
  constexpr int kOut = kMode == kDensity ? 1 : kMode == kForces ? 12 : 8;
  const size_t rows = (size_t)scene * n;
  const auto at = [](auto* a, size_t k) { return a ? a + k : a; };
  f.in += kIn * rows;
  f.pj = at(f.pj, rows);
  f.cid += rows;
  f.start += (size_t)scene * ((size_t)r * r * r + 1);
  f.raw += rows;
  f.occ += rows;
  f.occ_cum = at(f.occ_cum, (size_t)scene * (n + 1));
  f.scal += (size_t)scene * sph::kScalLanes;
  f.out += kOut * rows;
  f.cert += scene;
  return f;
}

// One warp's view of one tile: its row, the tile's span, lines and filter
// box, and the row's sums over the cells this warp walks. kOwn: the forces
// mode walks the lanes' own lists.
template <int kMode, bool kExt, bool kBand, bool kOwn = false>
struct Tile {
  // the sums one chunk hands on, per row
  static constexpr int kFields = kMode == kDensity ? 1 : kExt ? 12 : 6;

  const Frame& f;
  const Geom& g;
  int lane, i;
  bool live;
  sph::Particle p{};
  int cx, cy, cz;
  int ca, cb, seg_a, seg_b;     // lane k < 9: line k's cells and slots
  int x0, x1, y0, y1, z0, z1;
  sph::Scalars s;               // loaded by walk
  sph::PairSums acc;
  sph::Acc dens;

  __device__ Tile(const Frame& fr, const Geom& geom)
      : f(fr), g(geom), lane(threadIdx.x & 31) {}

  // cells of the frame's start table: R^3, or z_span * R^2 in a band
  __device__ int s_cells() const {
    return kBand ? g.z_span * g.r * g.r : g.r * g.r * g.r;
  }

  // row i of a slab's dead rows: density 0, the forces' sums 0, the
  // substep's row copied through
  __device__ void dead() {
    float4* __restrict__ out4 = reinterpret_cast<float4*>(f.out);
    if constexpr (kMode == kDensity) {
      f.out[i] = 0.f;
    } else if constexpr (kMode == kForces) {
      sph::store_sums<false>(out4, i, sph::PairSums{});
    } else {
      const float4* __restrict__ rows4 = reinterpret_cast<const float4*>(f.in);
      out4[2 * i] = __ldg(rows4 + 2 * i);
      out4[2 * i + 1] = __ldg(rows4 + 2 * i + 1);
    }
  }

  // The row, the tile's span (stale_spans; fresh_spans in the force modes)
  // with the drift count added to *cert when `count`, the nine lines and
  // the filter box. False for a tile of a slab's dead rows.
  __device__ bool begin(int tile, bool count) {
    i = tile * 32 + lane;
    // the live rows: all n, or in a slab's frame those before the dead rows
    const int r = g.r, s_cells = this->s_cells();
    const int n_live = kBand ? __ldg(f.start + s_cells) : g.n;
    live = i < n_live;                     // the last tile is ragged
    if (kBand && tile * 32 >= n_live) return false;   // a tile of dead rows
    if (live) {
      if constexpr (kMode == kDensity) {
        p.px = __ldg(f.in + 3 * i);
        p.py = __ldg(f.in + 3 * i + 1);
        p.pz = __ldg(f.in + 3 * i + 2);
      } else {
        p = sph::load_particle(reinterpret_cast<const float4*>(f.in), i);
      }
    }
    cx = sph::fresh_coord(p.px, r);
    cy = sph::fresh_coord(p.py, r);
    cz = sph::fresh_coord(p.pz, r);

    const int c = live ? __ldg(f.cid + i) : 0;
    int lo = warp_min(live, c), hi = warp_max(live, c);
    if constexpr (kMode != kDensity) {
      const int lz = kBand ? min(max(min(max(cz, 0), r - 1) - g.zbase, 0),
                                 g.z_span - 1)
                           : min(max(cz, 0), r - 1);
      const int fcid = min(max(cx, 0), r - 1) + min(max(cy, 0), r - 1) * r
                       + lz * r * r;
      const int band = r * r + r + 1;
      const int lo_allow = lo - band, hi_allow = hi + band;
      const unsigned drift =
          __ballot_sync(kAll, live && (fcid < lo_allow || fcid > hi_allow));
      if (count && lane == 0 && drift) atomicAdd(f.cert, __popc(drift));
      lo = min(max(min(max(warp_min(live, fcid), lo_allow), hi_allow), 0),
               s_cells - 1);
      hi = min(max(min(max(warp_max(live, fcid), lo_allow), hi_allow), 0),
               s_cells - 1);
    }

    // the nine lines' cells [ca, cb), deduplicated: cb'_k is the running
    // max of max(ca, cb) over lines 0..k, ca'_k = max(ca_k, cb'_{k-1});
    // start[] is monotone, so their slots [start[ca'], start[cb']) are
    // disjoint and ascending, and their union is that of the nine lines'
    ca = 0;
    cb = 0;
    if (lane < kLines) {
      const int off = (lane / 3 - 1) * r * r + (lane % 3 - 1) * r;
      ca = min(max(lo + off - 1, 0), s_cells);
      cb = min(max(hi + off + 2, 0), s_cells);
    }
    cb = warp_scan_max(max(ca, cb), lane);
    const int prev = __shfl_up_sync(kAll, cb, 1);
    ca = max(ca, lane == 0 ? 0 : prev);
    seg_a = 0;
    seg_b = 0;
    if (lane < kLines) {
      seg_a = __ldg(f.start + ca);
      seg_b = __ldg(f.start + cb);
    }
    // the ballot's filter: within 1 of the tile's fresh-cell bounding box
    x0 = warp_min(live, cx) - 1;
    x1 = warp_max(live, cx) + 1;
    y0 = warp_min(live, cy) - 1;
    y1 = warp_max(live, cy) + 1;
    z0 = warp_min(live, cz) - 1;
    z1 = warp_max(live, cz) + 1;
    return true;
  }

  // The tile's cost, the occupied slots of its union (every lane); lane
  // k < 9 gets its line's count `len`, the count before the line `before`
  // and before its first cell `o_a`.
  __device__ int cost(int& len, int& before, int& o_a) const {
    o_a = lane < kLines ? __ldg(f.occ_cum + seg_a) : 0;
    len = lane < kLines ? __ldg(f.occ_cum + seg_b) - o_a : 0;
    const int upto = warp_scan_add(len, lane);
    before = upto - len;
    return __shfl_sync(kAll, upto, 31);
  }

  // The first union cell at or past stream position t (0 < t < cost): the
  // smallest cell c of the first line whose count reaches t with the
  // occupied slots of the union before c at least t, by a 32-way search
  // (ops/compact.py::chunk_cells computes the same).
  __device__ int cut(int t, int len, int before, int o_a) const {
    const int k = __ffs(__ballot_sync(kAll, lane < kLines &&
                                                before + len >= t)) - 1;
    int lo = __shfl_sync(kAll, ca, k), hi = __shfl_sync(kAll, cb, k);
    const int need = __shfl_sync(kAll, o_a - before, k) + t;
    while (hi - lo > 1) {                  // need is not met at lo, at hi
      const int step = (hi - lo + 31) >> 5;
      const int c = min(lo + (lane + 1) * step, hi);
      const bool ok = __ldg(f.occ_cum + __ldg(f.start + c)) >= need;
      const int first = __ffs(__ballot_sync(kAll, ok)) - 1;
      const int below = __shfl_sync(kAll, c, max(first - 1, 0));
      hi = __shfl_sync(kAll, c, first);
      lo = first == 0 ? lo : below;
    }
    return hi;
  }

  // Streams the union's slots in [a, b) of lane k's line (k < 9) and adds
  // each candidate's terms to the rows' sums, in slot order.
  __device__ void walk(int a, int b, Slot* slots) {
    s = sph::load_scalars(f.scal);
    const float4* __restrict__ rows4 = reinterpret_cast<const float4*>(f.in);
    const float press_i = s.gas_k * (p.rho - s.rho0);
    const int r = g.r;
    for (int k = 0; k < kLines; ++k) {
      int base = __shfl_sync(kAll, a, k);
      const int seg_end = __shfl_sync(kAll, b, k);
      while (base < seg_end) {
        // lane l reads slot base + l: occupied, or past its cell's capacity
        // (then the round stops there and the next starts at the next cell)
        const int j = base + lane;
        bool keep = false, over = false;
        int packed = 0, skip_to = 0;
        if (j < seg_end) {
          if (__ldg(f.occ + j)) {            // occupied: raw is in the grid
            const int rj = __ldg(f.raw + j);
            const int z = rj / (r * r);
            const int rem = rj - z * r * r;
            const int y = rem / r;
            const int x = rem - y * r;
            keep = x >= x0 && x <= x1 && y >= y0 && y <= y1 && z >= z0 &&
                   z <= z1;
            packed = x | y << 10 | z << 20;
          } else if (g.cap >= 0) {
            const int cj = __ldg(f.cid + j);
            over = j - __ldg(f.start + cj) >= g.cap;
            skip_to = __ldg(f.start + cj + 1);
          }
        }
        const unsigned overs = __ballot_sync(kAll, over);
        const int stop = overs ? __ffs(overs) - 1 : 32;
        base = overs ? __shfl_sync(kAll, skip_to, stop) : base + 32;
        const unsigned mask = __ballot_sync(kAll, keep && lane < stop);
        if (keep && lane < stop) {
          Slot& e = slots[__popc(mask & ((1u << lane) - 1u))];
          if constexpr (kMode == kDensity) {
            e.a = make_float4(__ldg(f.in + 3 * j), __ldg(f.in + 3 * j + 1),
                              __ldg(f.in + 3 * j + 2), 0.f);
          } else {
            e.a = __ldg(rows4 + 2 * j);
            e.b = __ldg(rows4 + 2 * j + 1);
            float press_j, inv_j;
            sph::candidate<true>(s, e.a, e.b, press_j, inv_j,
                                 [&] { return __ldg(f.pj + j); });
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
        if constexpr (kMode == kForces && kOwn) {
          // the forces mode: the row's own slots as a mask, then only those
          unsigned own = 0;
          if (live) {
            for (int t = 0; t < count; ++t) {
              const Slot& e = slots[t];
              own |= (cell_near(e.cell, cx, cy, cz) && e.j != i ? 1u : 0u)
                     << t;
            }
          }
          while (own) {
            const Slot& e = slots[__ffs(own) - 1];
            own &= own - 1;
            sph::add_pair_pj<kExt, false>(s, p, press_i, 1.f, e.a, e.b,
                                          e.pj.x, e.pj.y, true, acc);
          }
        } else if (live) {
          for (int t = 0; t < count; ++t) {
            const Slot& e = slots[t];
            if (!cell_near(e.cell, cx, cy, cz)) continue;
            if constexpr (kMode == kDensity) {
              sph::add_density(s, p.px, p.py, p.pz, e.a.x, e.a.y, e.a.z,
                               true, dens);
            } else {
              if (e.j == i) continue;      // VelPos.compute:82
              sph::add_pair_pj<kExt, false>(s, p, press_i, 1.f, e.a, e.b,
                                            e.pj.x, e.pj.y, true, acc);
            }
          }
        }
        __syncwarp();                      // the slots are rewritten next
      }
    }
  }

  // Streams the union's cells in [c0, c1) (one chunk).
  __device__ void walk_cells(int c0, int c1, Slot* slots) {
    int a = 0, b = 0;
    if (lane < kLines) {
      a = __ldg(f.start + min(max(ca, c0), c1));
      b = __ldg(f.start + min(max(cb, c0), c1));
    }
    walk(a, b, slots);
  }

  // sum `k` of the row (k < kFields), in PairSums' member order
  __device__ float& sum(int k) {
    if constexpr (kMode == kDensity) {
      return dens.s;
    } else {
      return reinterpret_cast<sph::Acc*>(&acc)[k].s;
    }
  }

  // a chunk's partial sums of the row, [kFields][32] at dst
  __device__ void store(float* dst) {
#pragma unroll
    for (int k = 0; k < kFields; ++k) dst[k * 32 + lane] = sum(k);
  }

  // the partial sums at src added to the row's, or with `first` in place of
  // them: over a tile's chunks in ascending order, each row's sums add up in
  // chunk order. kGlobal: src was stored by other warps of the grid.
  template <bool kGlobal>
  __device__ void fold(const float* src, bool first) {
#pragma unroll
    for (int k = 0; k < kFields; ++k) {
      const float v = kGlobal ? __ldcg(src + k * 32 + lane)
                              : src[k * 32 + lane];
      sum(k) = first ? v : sum(k) + v;
    }
  }

  // the row's result from its sums: rho, the raw sums or the substep
  __device__ void finish() {
    if (!live) {
      if (kBand && i < g.n) dead();
      return;
    }
    float4* __restrict__ out4 = reinterpret_cast<float4*>(f.out);
    if constexpr (kMode == kDensity) {
      f.out[i] = s.mass * sph::total(dens);
    } else if constexpr (kMode == kForces) {
      sph::store_sums<false>(out4, i, acc);
    } else {
      sph::fused_tail<kExt, false>(s, p, acc, out4, i);
    }
  }
};

// A split tile (owner = scene * T + tile) of k chunks: its slot and its k
// chunks on the queue, or, past the queue's end, on the rest list (the
// chunks it reserved there marked -1).
__device__ __forceinline__ void enqueue(const Queue& q, int owner, int k) {
  const int lane = threadIdx.x & 31;
  int slot = -1, base = 0;
  if (lane == 0) {
    base = atomicAdd(q.count + 1, k);
    if (base + k <= q.cap) {
      slot = atomicAdd(q.count, 1);
      q.owner[slot] = owner;
      q.first[slot] = base;
      q.done[slot] = 0;
    } else {
      q.rest[atomicAdd(q.count + 3, 1)] = owner;
    }
  }
  slot = __shfl_sync(kAll, slot, 0);
  base = __shfl_sync(kAll, base, 0);
  if (lane < k && base + lane < q.cap)
    q.item[base + lane] = slot < 0 ? -1 : slot * kChunks + lane;
}

// Tile `tile` of scene `scene` walked whole by its warp: the body of the
// whole-tile kernels. With kSplit (the split launch of the fused substep
// and of banded density) a tile whose cost passes q.split is queued in
// chunks instead.
template <int kMode, bool kExt, bool kBand, bool kSplit, bool kOwn = false>
__device__ __forceinline__ void whole_tile(const Frame& f, const Geom& g,
                                           const Queue& q, int scene,
                                           int tile) {
  Clock clk;
  clk.start();
  if (tile * 32 >= g.n) return;            // the whole warp leaves
  const int tiles = (g.n + 31) >> 5;
  long long* clock = tile_clock(q.clock, scene, tiles);
  Tile<kMode, kExt, kBand, kOwn> t(f, g);
  const bool live = t.begin(tile, true);
  if constexpr (kSplit) {
    // a tile whose union holds more than q.split occupied slots is queued
    // (a union of at most q.split slots is light without a look at
    // occ_cum); then the tile counts as seen, and once every block has
    // seen its tiles the chunk kernel may start beside this one's last
    bool queued = false;
    if (live) {
      const int slots = __reduce_add_sync(
          kAll, t.lane < kLines ? t.seg_b - t.seg_a : 0);
      if (slots > q.split) {
        int len, before, o_a;
        const int cost = t.cost(len, before, o_a);
        if (cost > q.split) {
          enqueue(q, scene * tiles + tile, chunks_of(cost, q.split));
          queued = true;
        }
      }
    }
    __threadfence();
    __syncwarp();
    if (t.lane == 0) atomicAdd(q.count + 5, 1);
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    if (queued) return;
  }
  if (!live) {                             // a tile of a slab's dead rows
    if (t.i < g.n) t.dead();
    clk.stop(clock, tile, 0, 0, t.s_cells());
    return;
  }
  t.walk(t.seg_a, t.seg_b, warp_slots());
  t.finish();
  clk.stop(clock, tile, 0, 0, t.s_cells());   // lane 0 is live here
}

// One warp a tile over one frame (banded with kBand).
template <int kMode, bool kExt, bool kBand, bool kSplit>
__global__ void __launch_bounds__(kWarps * 32)
compact_kernel(Frame f, Geom g, Queue q) {
  whole_tile<kMode, kExt, kBand, kSplit>(
      f, g, q, 0, blockIdx.x * kWarps + (threadIdx.x >> 5));
}

// The scene-axis instance (JAX's vmap of _call_compact): blockIdx.y is the
// scene, whose inputs are the scene's blocks of the stacked arrays
// (scene_block) and whose drift count is cert[scene]; a tile is
// scene-local, so each warp is the solo kernel's warp of that scene.
template <int kMode, bool kExt, bool kSplit>
__global__ void __launch_bounds__(kWarps * 32)
compact_scenes_kernel(Frame f, Geom g, Queue q) {
  const int scene = blockIdx.y;
  whole_tile<kMode, kExt, false, kSplit>(
      scene_block<kMode>(f, scene, g.n, g.r), g, q, scene,
      blockIdx.x * kWarps + (threadIdx.x >> 5));
}

// The forces mode through the lanes' own lists (kForcesOwn), over one
// frame and over the scene axis.
__global__ void __launch_bounds__(kWarps * 32)
compact_forces_own_kernel(Frame f, Geom g, Queue q) {
  whole_tile<kForces, false, false, false, true>(
      f, g, q, 0, blockIdx.x * kWarps + (threadIdx.x >> 5));
}

__global__ void __launch_bounds__(kWarps * 32)
compact_forces_own_scenes_kernel(Frame f, Geom g, Queue q) {
  const int scene = blockIdx.y;
  whole_tile<kForces, false, false, false, true>(
      scene_block<kForces>(f, scene, g.n, g.r), g, q, scene,
      blockIdx.x * kWarps + (threadIdx.x >> 5));
}

// Chunk m of tile `tile` of a split launch's frame: its cells [c0, c1),
// walked into t's sums; returns the tile's chunk count.
template <int kMode, bool kExt, bool kBand>
__device__ __forceinline__ int walk_chunk(Tile<kMode, kExt, kBand>& t,
                                          int split, int tile, int m,
                                          int& c0, int& c1) {
  t.begin(tile, false);
  int len, before, o_a;
  const int cost = t.cost(len, before, o_a);
  const int k = chunks_of(cost, split);
  c0 = m == 0 ? 0 : t.cut(m * cost / k, len, before, o_a);
  c1 = m == k - 1 ? t.s_cells() : t.cut((m + 1) * cost / k, len, before, o_a);
  t.walk_cells(c0, c1, warp_slots());
  return k;
}

// The split launch's second kernel's body, one wave of resident warps,
// launched to start beside the first kernel's last tiles (programmatic
// dependent launch) once every tile is seen, so the queue is whole: each
// warp takes the next queued chunk, walks its cells and stores its partial
// sums; the last of a tile's chunks to finish adds the tile's partials in
// chunk order and runs the tail (density: rho). Then the tiles past the
// queue's end, a warp each, chunk after chunk. It ends after the first
// kernel. Scene 0 of scene_block is the solo frame.
template <int kMode, bool kExt, bool kBand>
__device__ __forceinline__ void chunk_body(Frame fr, Geom g, Queue q) {
  using T = Tile<kMode, kExt, kBand>;
  constexpr int kPart = T::kFields * 32;
  const int lane = threadIdx.x & 31;
  const int tiles = (g.n + 31) >> 5;
  const auto seen = [](const int* c) { return *(volatile const int*)c; };
  if (lane == 0)
    while (seen(q.count + 5) < q.tiles) __nanosleep(128);
  __syncwarp();
  __threadfence();
  const int queued = min(seen(q.count + 1), q.cap);
  const int rest = seen(q.count + 3);
  for (;;) {
    int h = 0;
    if (lane == 0) h = atomicAdd(q.count + 2, 1);
    h = __shfl_sync(kAll, h, 0);
    if (h >= queued) break;
    const int item = __ldcg(q.item + h);
    if (item < 0) continue;             // reserved by a tile past the end
    Clock clk;
    clk.start();
    const int slot = item / kChunks, m = item - slot * kChunks;
    const int owner = __ldcg(q.owner + slot);
    const int scene = owner / tiles, tile = owner - scene * tiles;
    const Frame f = scene_block<kMode>(fr, scene, g.n, g.r);
    T t(f, g);
    int c0, c1;
    const int k = walk_chunk(t, q.split, tile, m, c0, c1);
    t.store(q.part + (size_t)h * kPart);
    __threadfence();
    __syncwarp();
    int seen = 0;
    if (lane == 0) seen = atomicAdd(q.done + slot, 1);
    if (__shfl_sync(kAll, seen, 0) == k - 1) {   // the tile's last chunk
      __threadfence();
      const float* part = q.part + (size_t)__ldcg(q.first + slot) * kPart;
      for (int c = 0; c < k; ++c)
        t.template fold<true>(part + c * kPart, c == 0);
      t.finish();
    }
    clk.stop(tile_clock(q.clock, scene, tiles), tile, m, c0, c1);
  }
  __shared__ float sums[kWarps][T::kFields * 32];
  float* total = sums[threadIdx.x >> 5];
  for (;;) {
    int h = 0;
    if (lane == 0) h = atomicAdd(q.count + 4, 1);
    h = __shfl_sync(kAll, h, 0);
    if (h >= rest) break;
    const int owner = __ldcg(q.rest + h);
    const int scene = owner / tiles, tile = owner - scene * tiles;
    const Frame f = scene_block<kMode>(fr, scene, g.n, g.r);
    for (int m = 0, k = 1; m < k; ++m) {
      Clock clk;
      clk.start();
      T t(f, g);
      int c0, c1;
      k = walk_chunk(t, q.split, tile, m, c0, c1);
      if (m > 0) t.template fold<false>(total, false);
      if (m < k - 1) {
        t.store(total);
      } else {
        t.finish();
      }
      __syncwarp();
      clk.stop(tile_clock(q.clock, scene, tiles), tile, m, c0, c1);
    }
  }
  // the stream's next work waits on this kernel: it ends after the first
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The fused substep's chunk kernel.
template <bool kExt, bool kBand>
__global__ void __launch_bounds__(kWarps * 32, kExt ? 1 : kChunkBlocks)
compact_chunk_kernel(Frame fr, Geom g, Queue q) {
  chunk_body<kFused, kExt, kBand>(fr, g, q);
}

// Density's chunk kernel (one partial sum a row a chunk).
template <bool kBand>
__global__ void __launch_bounds__(kWarps * 32, kChunkBlocks)
compact_density_chunk_kernel(Frame fr, Geom g, Queue q) {
  chunk_body<kDensity, false, kBand>(fr, g, q);
}

template <bool kSplit>
auto fused_kernel(bool ext, bool band) {
  return ext ? (band ? compact_kernel<kFused, true, true, kSplit>
                     : compact_kernel<kFused, true, false, kSplit>)
             : (band ? compact_kernel<kFused, false, true, kSplit>
                     : compact_kernel<kFused, false, false, kSplit>);
}

// the blocks of a kernel the card holds at once
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kWarps * 32, 0);
  return sms * max(per_sm, 1);
}

template <bool kSplit>
auto density_kernel(bool band) {
  return band ? compact_kernel<kDensity, false, true, kSplit>
              : compact_kernel<kDensity, false, false, kSplit>;
}

// K5 over `scenes` frames: compact_kernel (banded or not) for one frame,
// compact_scenes_kernel for more, or for -scenes (the scene-axis entry
// point, whatever the count); with q.split > 0 (the fused substep; density
// over one frame) the split launch, its whole-tile kernel then the chunk
// kernel.
int launch(int mode, int ext, const Frame& f, const Geom& g, const Queue& q,
           int scenes, cudaStream_t stream) {
  if (g.n <= 0) return (int)cudaGetLastError();
  const bool band = g.zbase != 0 || g.z_span != g.r;
  const bool split = q.split > 0;
  const int tiles = (g.n + 31) / 32;
  const dim3 grid((tiles + kWarps - 1) / kWarps, scenes < 0 ? -scenes : 1);
  if (scenes == 1) {
    auto kernel =
        mode == kDensity ? (split ? density_kernel<true>(band)
                                  : density_kernel<false>(band))
        : mode == kForces ? compact_kernel<kForces, false, false, false>
        : mode == kForcesOwn ? compact_forces_own_kernel
        : split           ? fused_kernel<true>(ext, band)
                          : fused_kernel<false>(ext, band);
    kernel<<<grid, kWarps * 32, 0, stream>>>(f, g, q);
  } else {
    auto kernel =
        mode == kDensity  ? compact_scenes_kernel<kDensity, false, false>
        : mode == kForces ? compact_scenes_kernel<kForces, false, false>
        : mode == kForcesOwn ? compact_forces_own_scenes_kernel
        : split ? (ext ? compact_scenes_kernel<kFused, true, true>
                       : compact_scenes_kernel<kFused, false, true>)
        : ext   ? compact_scenes_kernel<kFused, true, false>
                : compact_scenes_kernel<kFused, false, false>;
    kernel<<<grid, kWarps * 32, 0, stream>>>(f, g, q);
  }
  if (split) {
    auto chunks = mode == kDensity
                      ? (band ? compact_density_chunk_kernel<true>
                              : compact_density_chunk_kernel<false>)
                  : ext ? (band ? compact_chunk_kernel<true, true>
                                : compact_chunk_kernel<true, false>)
                        : (band ? compact_chunk_kernel<false, true>
                                : compact_chunk_kernel<false, false>);
    cudaLaunchAttribute early;
    early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    early.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(resident_blocks(chunks));
    cfg.blockDim = dim3(kWarps * 32);
    cfg.stream = stream;
    cfg.attrs = &early;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, chunks, f, g, q);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

bool bad_args(int mode, int ext, const float* pj, int r, bool band) {
  return mode < kDensity || mode > kForcesOwn ||
         (ext && mode != kFused) || r > kMaxR ||
         (mode != kDensity && pj == nullptr) ||
         (band && (mode == kForces || mode == kForcesOwn));
}

Frame frame_of(const float* in, const float* pj, const int* cid,
               const int* start, const int* raw, const uint8_t* occ,
               const int* occ_cum, const float* scal, float* out,
               int* cert) {
  return Frame{in,  reinterpret_cast<const float2*>(pj), cid, start, raw,
               occ, occ_cum, scal, out, cert};
}

}  // namespace

// mode: 0 density (in = pos f32[N, 3], out = rho f32[N]; pj unused, may be
// null), 1 forces without extensions (in = rows f32[N, 8], pj f32[N, 2], out
// = f32[N, 12]), 2 fused substep (in = rows, pj, out = rows; ext != 0 adds
// the extension sums), 3 mode 1 through the lanes' own lists (the same
// bits). *cert (zeroed by the caller) receives the drift count of the force
// modes. cap is the voxel capacity of the frame (< 0: uncut);
// r is at most 1024. (zbase, z_span) is the frame's band of z-planes, (0, r)
// for the whole grid; density and the fused substep have banded instances
// (the slab step's), the forces mode has none. Every tile is walked whole.
// clock (the SPH_TILE_CLOCK=1 build; else ignored, may be null) receives
// i64[T, 16, 4] as in sph_compact_split.
extern "C" int sph_compact(int mode, int ext, const float* in, const float* pj,
                           const int* cid, const int* start, const int* raw,
                           const uint8_t* occ, const float* scal, float* out,
                           int* cert, long long* clock, int n, int r, int cap,
                           int zbase, int z_span, void* stream) {
  if (bad_args(mode, ext, pj, r, zbase != 0 || z_span != r))
    return (int)cudaErrorInvalidValue;
  return launch(mode, ext,
                frame_of(in, pj, cid, start, raw, occ, nullptr, scal, out,
                         cert),
                Geom{n, r, cap, zbase, z_span},
                Queue{0, 0, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, clock},
                1, (cudaStream_t)stream);
}

// K5 over `scenes` scenes of n rows each (JAX's vmap of density_compact,
// compact_substep and forces_compact): every input stacked scene after
// scene as compact_scenes_kernel reads it, cert i32[scenes] (zeroed by the
// caller) each scene's drift count, clock i64[scenes, T, 16, 4]; mode, ext,
// cap and r as in sph_compact, over the whole grid. One launch, grid (tile
// blocks, scenes), every tile walked whole.
extern "C" int sph_compact_scenes(int mode, int ext, const float* in,
                                  const float* pj, const int* cid,
                                  const int* start, const int* raw,
                                  const uint8_t* occ, const float* scal,
                                  float* out, int* cert, long long* clock,
                                  int n, int r, int cap, int scenes,
                                  void* stream) {
  if (bad_args(mode, ext, pj, r, false) || scenes < 0 || scenes > 65535)
    return (int)cudaErrorInvalidValue;
  if (scenes == 0) return (int)cudaGetLastError();
  return launch(mode, ext,
                frame_of(in, pj, cid, start, raw, occ, nullptr, scal, out,
                         cert),
                Geom{n, r, cap, 0, r},
                Queue{0, 0, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, clock},
                -scenes, (cudaStream_t)stream);
}

// Mode 2, the fused substep, with wide tiles split, over `scenes` stacked
// scenes (1: the solo frame, banded with (zbase, z_span) as in sph_compact;
// more: the whole grid as in sph_compact_scenes), or mode 0, density, over
// one frame (banded or not): a tile whose union holds more than `split`
// (> 0) occupied slots is walked in min(16, ceil(cost / split)) chunks, a
// warp each. occ_cum i32[scenes, n + 1]: each scene's occupied slots before
// each sorted index. cert i32[scenes + 6]: each scene's drift count, then
// the queue's counters, all zero; queue i32[8 * scenes * T] (T = ceil(n /
// 32)), part f32[4 * scenes * T, fields, 32], fields 6 (12 with ext; 1 in
// density). clock (the SPH_TILE_CLOCK=1 build; else ignored, may be null)
// receives i64[scenes, T, 16, 4]: each chunk's (each whole tile's)
// globaltimer start and end, clock64 cycles and cells (c0 | c1 << 32).
extern "C" int sph_compact_split(
    int mode, int ext, const float* in, const float* pj, const int* cid,
    const int* start, const int* raw, const uint8_t* occ, const int* occ_cum,
    const float* scal, float* out, int* cert, int* queue, float* part,
    long long* clock, int n, int r, int cap, int zbase, int z_span,
    int scenes, int split, void* stream) {
  const bool band = zbase != 0 || z_span != r;
  if ((mode != kFused && mode != kDensity) ||
      bad_args(mode, ext, pj, r, band) || split <= 0 || scenes < 1 ||
      scenes > 65535 || ((band || mode == kDensity) && scenes != 1) ||
      occ_cum == nullptr || queue == nullptr || part == nullptr)
    return (int)cudaErrorInvalidValue;
  const int slots = scenes * ((n + 31) / 32);
  return launch(mode, ext,
                frame_of(in, pj, cid, start, raw, occ, occ_cum, scal, out,
                         cert),
                Geom{n, r, cap, zbase, z_span},
                Queue{split, slots, kQueued * slots, cert + scenes, queue,
                      queue + slots, queue + 2 * slots, queue + 3 * slots,
                      queue + 4 * slots, part, clock},
                scenes > 1 ? -scenes : 1, (cudaStream_t)stream);
}
