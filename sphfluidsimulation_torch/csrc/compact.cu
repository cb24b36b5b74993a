// K5: the compact-lane route, one warp per tile of 32 sorted rows.
//
// Replaces the TPU kernel sphfluidsimulation_tpu/ops/pallas_compact.py::
// _compact_kernel (:237), launched by _call_compact (pallas_call at :577)
// from density_compact (:622), compact_substep (:648) and forces_compact
// (:681). Three modes share one body:
//   density  rho_i = m * sum_j W_poly6, self included, over the tile's stale
//            segments (pos f32[N, 3] -> rho f32[N]);
//   forces   the raw pair sums of K3 without extensions, j == i skipped
//            (rows f32[N, 8] -> f32[N, 12], lanes 6-11 zero);
//   fused    one whole substep, the tail of K2 (rows -> rows), with kExt the
//            XSPH and artificial-viscosity sums.
// The tile's cell span is the min/max of its rows' anchor cells (density)
// or of their fresh cells clipped to the grid, clamped to that stale span
// +- one cell plane; rows outside the band are the drift count, added to
// *cert (ops/compact.py::fresh_spans computes the same). Each (dz, dy) line
// gives the segment [start[lo + off - 1], start[hi + off + 2]), the nine
// deduplicated so that their union holds each slot once. Every row
// evaluates every slot of the union under the exact gate of K1-K3: occupied,
// raw cell within Chebyshev 1 of the row's fresh cell, and j != i for the
// force modes. The pair terms are sph_common.cuh's add_density and add_pair,
// and the fused tail is fused_tail, so K5 cannot drift from K1-K3. A row
// sums its candidates in ascending sorted order, as K1-K3 do.
//
// What bounds it on the H100: every row evaluates the whole union, about
// 356 slots at the golden occupancy against K2's ~103 candidates per row,
// so it does about three times K2's pair operations (an IEEE sqrt and two
// IEEE divisions per force pair); its device-memory traffic is one read of
// each candidate per warp instead of one per thread, served by L1/L2 either
// way.
//
// What the design does about it: lanes 0-8 load their line's two start[]
// entries; a warp prefix max applies the dedup and a prefix sum gives the
// segment offsets. The warp then streams the union 32 slots at a time with
// coalesced loads of occ and raw, keeps (__ballot_sync + __popc) the slots
// that are occupied and whose raw cell lies within 1 of the tile's
// fresh-cell bounding box, and writes them densely to shared memory with
// their two float4s; each lane then walks that dense list with its own
// gate. Wall piles make segments far longer than the capacity; the ballot
// keeps their unoccupied slots out of the pair math. No capacity cut, no TMA
// or cp.async: a simple kernel that is right first.
#include <climits>

#include "sph_common.cuh"

namespace {

constexpr int kWarps = 4;            // tiles per block
constexpr int kLines = 9;            // (dz, dy) candidate lines per tile
constexpr unsigned kAll = 0xffffffffu;
enum Mode { kDensity = 0, kForces = 1, kFused = 2 };

// One compacted candidate: its rows entry (a.xyz only in density mode), its
// sorted index and its decoded raw cell.
struct Slot {
  float4 a, b;
  int j, x, y, z;
};

__device__ __forceinline__ int warp_scan_max(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kAll, v, d);
    if (lane >= d) v = max(v, t);
  }
  return v;
}

__device__ __forceinline__ int warp_scan_sum(int v, int lane) {
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

template <int kMode, bool kExt>
__global__ void __launch_bounds__(kWarps * 32)
compact_kernel(const float* __restrict__ in, const int* __restrict__ cid,
               const int* __restrict__ start, const int* __restrict__ raw,
               const uint8_t* __restrict__ occ,
               const float* __restrict__ scal, float* __restrict__ out,
               int* __restrict__ cert, int n, int r) {
  __shared__ Slot slots[kWarps][32];
  __shared__ int seg[kWarps][3][kLines];   // a, first offset, end offset
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile * 32 >= n) return;              // the whole warp leaves
  const int i = tile * 32 + lane;
  const bool live = i < n;                 // the last tile is ragged
  const int s_cells = r * r * r;
  const sph::Scalars s = sph::load_scalars(scal);
  const float4* __restrict__ rows4 = reinterpret_cast<const float4*>(in);

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
    const int fcid = min(max(cx, 0), r - 1) + min(max(cy, 0), r - 1) * r
                     + min(max(cz, 0), r - 1) * r * r;
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

  // the nine line segments, deduplicated: b'_k is the running max of
  // max(a, b) over lines 0..k, a'_k = max(a_k, b'_{k-1})
  int a = 0, b = 0;
  if (lane < kLines) {
    const int off = (lane / 3 - 1) * r * r + (lane % 3 - 1) * r;
    a = __ldg(start + min(max(lo + off - 1, 0), s_cells));
    b = __ldg(start + min(max(hi + off + 2, 0), s_cells));
  }
  const int b_run = warp_scan_max(max(a, b), lane);
  const int prev = __shfl_up_sync(kAll, b_run, 1);
  a = max(a, lane == 0 ? 0 : prev);
  const int len = lane < kLines ? b_run - a : 0;
  const int end = warp_scan_sum(len, lane);
  const int total = __shfl_sync(kAll, end, kLines - 1);
  if (lane < kLines) {
    seg[warp][0][lane] = a;
    seg[warp][1][lane] = end - len;
    seg[warp][2][lane] = end;
  }
  // the ballot's filter: within 1 of the tile's fresh-cell bounding box
  const int x0 = warp_min(live, cx) - 1, x1 = warp_max(live, cx) + 1;
  const int y0 = warp_min(live, cy) - 1, y1 = warp_max(live, cy) + 1;
  const int z0 = warp_min(live, cz) - 1, z1 = warp_max(live, cz) + 1;
  __syncwarp();

  const float press_i = s.gas_k * (p.rho - s.rho0);
  sph::PairSums acc;
  float dens = 0.f;
  for (int base = 0; base < total; base += 32) {
    const int q = base + lane;
    bool keep = false;
    int j = 0, x = 0, y = 0, z = 0;
    if (q < total) {
      int k = 0;
      while (seg[warp][2][k] <= q) ++k;
      j = seg[warp][0][k] + (q - seg[warp][1][k]);
      if (__ldg(occ + j)) {                // occupied: raw is in the grid
        const int rj = __ldg(raw + j);
        z = rj / (r * r);
        const int rem = rj - z * r * r;
        y = rem / r;
        x = rem - y * r;
        keep = x >= x0 && x <= x1 && y >= y0 && y <= y1 && z >= z0 &&
               z <= z1;
      }
    }
    const unsigned mask = __ballot_sync(kAll, keep);
    if (keep) {
      Slot& e = slots[warp][__popc(mask & ((1u << lane) - 1u))];
      if constexpr (kMode == kDensity) {
        e.a = make_float4(__ldg(in + 3 * j), __ldg(in + 3 * j + 1),
                          __ldg(in + 3 * j + 2), 0.f);
      } else {
        e.a = __ldg(rows4 + 2 * j);
        e.b = __ldg(rows4 + 2 * j + 1);
      }
      e.j = j;
      e.x = x;
      e.y = y;
      e.z = z;
    }
    __syncwarp();
    const int count = __popc(mask);
    if (live) {
      for (int t = 0; t < count; ++t) {
        const Slot& e = slots[warp][t];
        if (abs(e.x - cx) > 1 || abs(e.y - cy) > 1 || abs(e.z - cz) > 1)
          continue;
        if constexpr (kMode == kDensity) {
          sph::add_density(s, p.px, p.py, p.pz, e.a.x, e.a.y, e.a.z, dens);
        } else {
          if (e.j == i) continue;          // VelPos.compute:82
          const sph::Particle qj{e.a.x, e.a.y, e.a.z, e.a.w,
                                 e.b.x, e.b.y, e.b.z, e.b.w};
          sph::add_pair<kExt>(s, p, press_i, qj, acc);
        }
      }
    }
    __syncwarp();                          // the slots are rewritten next
  }

  if (!live) return;
  if constexpr (kMode == kDensity) {
    out[i] = s.mass * dens;
  } else if constexpr (kMode == kForces) {
    sph::store_sums(reinterpret_cast<float4*>(out), i, acc);
  } else {
    sph::fused_tail<kExt>(s, p, acc, reinterpret_cast<float4*>(out), i);
  }
}

}  // namespace

// mode: 0 density (in = pos f32[N, 3], out = rho f32[N]), 1 forces without
// extensions (in = rows f32[N, 8], out = f32[N, 12]), 2 fused substep (in =
// rows, out = rows; ext != 0 adds the extension sums). *cert (zeroed by the
// caller) receives the drift count of the force modes.
extern "C" int sph_compact(int mode, int ext, const float* in, const int* cid,
                           const int* start, const int* raw,
                           const uint8_t* occ, const float* scal, float* out,
                           int* cert, int n, int r, void* stream) {
  if (mode < kDensity || mode > kFused || (ext && mode != kFused))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int tiles = (n + 31) / 32;
    const int blocks = (tiles + kWarps - 1) / kWarps;
    auto kernel = mode == kDensity ? compact_kernel<kDensity, false>
                  : mode == kForces ? compact_kernel<kForces, false>
                  : ext ? compact_kernel<kFused, true>
                        : compact_kernel<kFused, false>;
    kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        in, cid, start, raw, occ, scal, out, cert, n, r);
  }
  return (int)cudaGetLastError();
}
