"""K5, the compact-lane route: density, fused substep and forces over each
32-row tile's merged candidate list. CUDA kernel and plain PyTorch versions.

Counterpart of ``sphfluidsimulation_tpu/ops/pallas_compact.py``:
``stale_spans`` (:121), ``fresh_spans`` (:147), the segment derivation and
membership gate of ``_compact_kernel`` (:237; segments :326-339, gate
:394-402) and the entry points ``density_compact`` (:622),
``compact_substep`` (:648) and ``forces_compact`` (:681), each with the
slab step's band (``band=(zbase, z_span)``, density and the substep) and
the bf16 candidates of ``PallasTuning.bf16`` (the force modes).

Semantics. The sorted rows are cut into tiles of ``CROWS`` = 32 rows (the
last one ragged). A tile's cell span [lo, hi] is the min and max of its
rows' anchor cells (density) or of their fresh cells clipped to the grid
(substep, forces), the latter clamped to the stale span ± one cell plane
(R² + R + 1). Rows whose fresh cell falls outside that band are counted:
the drift count, the route's certificate. For each of the nine (dz, dy)
lines the tile takes the sorted segment [start[lo + off − 1],
start[hi + off + 2]), off = dz·R² + dy·R, with the cells clipped to [0, R³];
a monotone dedup (a = max(a, prev_b), b = max(b, a)) makes the nine
segments disjoint. Every row of the tile evaluates every j of the union
under the gate of the other kernels: j occupied, j's raw cell within
Chebyshev 1 of the row's unclipped fresh cell, and j ≠ i for the forces.
The gate makes the candidate set that of K1/K2/K3 for every row inside
the band; a drifted row may miss candidates, which the certificate counts.
The kernel reads the union's slots in order but only each cell's first
``capacity`` of them, the only ones that can be occupied: a round of 32
slots stops at the first slot past its cell's capacity and the next round
starts at the next cell (:func:`stream_slots` counts the slots it reads).
The plain versions gather the occupied slots of the union directly, so
their result does not depend on the capacity argument.
The JAX kernel keeps the self pair in its force sums; the port drops it,
as JAX's other kernels and the reference (VelPos.compute:82) do, which
changes nothing for finite rows.

Bands (``band=(zbase, z_span)``, the slab step's frame, ``ops/frame.py``):
the cells are the band's z_span·R² local ids (``start[]`` and ``cid``
local), a fresh cell's z is clipped into the band before it enters a span,
the gate reads global raw ids, and the rows past ``start[-1]`` are dead:
they enter no span and no drift count, their density is 0 and the substep
copies them through (JAX ``fresh_spans(band=)``, :147-186). A tile of dead
rows takes the JAX pad sentinel as its span and walks nothing.

Variants: K5 reads only ``SortedTuning.bf16`` (``SortedTuning.k5()``), as
JAX's compact kernel does: its force modes then read the candidates' vx,
vy, vz and ρⱼ rounded to bfloat16 and compute press_j and 1/ρⱼ from the
rounded ρⱼ (``pallas_compact.py:249``, :416-418), whatever the extensions.

What is not ported, and why. ``slice_cells``, ``group_slice_bases``,
``padded_start``, ``_table_len`` and ``_pad_cell`` size and place the
start-table slice that the TPU copies into its scalar memory;
``compact_chunks`` sizes the 128-lane compact buffer and the group window
(``win_f``) the DMA. The CUDA kernel reads ``start[]`` and the candidates
straight from device memory, so none of them has a counterpart, and neither
have the three layout truncations JAX adds to the certificate (``out_slice``,
``clip_w``, ``ovf``, :334-352): the certificate here is the drift count
alone.

Scene axis (the batched step of ``parallel/batch.py``, JAX's ``vmap`` of
the frame step under ``SPH_PALLAS_COMPACT=1``): :func:`density_compact_scenes`,
:func:`compact_substep_scenes` and :func:`forces_compact_scenes` take a
frame over a leading scene axis (``frame.build_frame_scenes``) and a
stacked ``PhysParams`` and launch K5 once over all scenes (grid (tile
blocks, scenes)); each scene's result and drift count, i32[S], are its
solo pass's, bit for bit.

Wide tiles (the split launch of the fused substep and of banded density):
a tile's cost is the occupied slots of its union (:func:`tile_cost`, from
:func:`occ_prefix`, which the stepper and the slab step compute once a
frame and pass as ``occ_cum``; it does not depend on the capacity
argument). A tile whose cost passes :data:`SPLIT_SLOTS` (the substep) or
:data:`DENSITY_SPLIT_SLOTS` (banded density) is cut into at most
:data:`CHUNKS` chunks of about equal cost, each a range of the union's
cells (:func:`n_chunks`, :func:`chunk_cells`), walked by a warp each, and
the rows' sums are added in chunk order before the tail, so every instance
of a frame gives the same bits. The kernel decides and queues on the
device, with no plan launch and no host sync. The plain versions do not
split: they sum each row's candidates in one tree. Density over the whole
grid (solo and on the scene axis) and the forces walk every tile whole.

Routing: a CPU tensor goes to the plain version; a CUDA tensor launches
``csrc/compact.cu`` or raises. Each entry point returns ``(out, cert)``.
"""

from __future__ import annotations

import ctypes
import torch

from ..params import PhysParams
from . import cuda_build, sph_math
from .frame import SortedFrame, scene_frame
from .sph_kernels import (N_FIELDS, N_SCAL, N_SUMS, _CHUNK_PAIRS,
                          SortedTuning, _band_args, _cap_arg, _check,
                          _check_scenes, _count, _ptr, _raise_on_error,
                          density_sums_plain, fold_forces, force_sums_plain,
                          fresh_cell, fused_substep_plain, member_gate,
                          pj_cols, pj_cols_scenes, scal_block, scal_blocks,
                          scene_params, scene_view, uses_extensions,
                          variant_tag)

CROWS = 32               # rows per tile: one warp
N_LINES = 9              # (dz, dy) ∈ [−1, 1]² candidate lines per tile
CHUNKS = 16              # the most chunks of a split tile (compact.cu kChunks)
# occupied union slots past which the fused substep splits a tile (PERF.md)
SPLIT_SLOTS = 1024
# occupied union slots past which banded density splits a tile (PERF.md)
DENSITY_SPLIT_SLOTS = 640
CLOCK_LANES = 4          # a chunk's tile-clock entry (compact.cu kClockLanes)
_BIG = 1 << 30
# the forces mode's lanes walk their own slots of a round (in place of the
# round's list) below this many rows a cell, n / R³ (PERF.md: −17% at 2.5,
# −5% at 4.1, even at 5.0 and +8% there over the scene axis)
OWN_LISTS_ROWS_PER_CELL = 4.5
# the kernel's mode argument (csrc/compact.cu; _FORCES_OWN: the forces
# through the lanes' own lists)
_DENSITY, _FORCES, _FUSED, _FORCES_OWN = 0, 1, 2, 3


# ------------------------------------------------------- tile geometry --

def n_tiles(n: int) -> int:
    return -(-n // CROWS)


def _tiled(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x [n] → [T, CROWS], the ragged last tile padded with ``fill``."""
    n = x.shape[0]
    pad = n_tiles(n) * CROWS - n
    if pad:
        x = torch.cat([x, x.new_full((pad,), fill)])
    return x.reshape(-1, CROWS)


def s_cells_of(r: int, band: tuple[int, int] | None) -> int:
    """Cells of the frame's start table: R³, or z_span·R² in a band."""
    return r * r * r if band is None else band[1] * r * r


def pad_cell(s_cells: int, r: int) -> int:
    """A dead tile's span (JAX ``_pad_cell``): every line of it lies past
    the table's end, so it walks nothing."""
    return s_cells + r * r + r + 2


def live_rows(frame: SortedFrame) -> torch.Tensor:
    """bool[N]: the rows before a slab buffer's dead rows (all rows without
    a band), from the start table on the device."""
    return torch.arange(frame.cid.shape[0], device=frame.cid.device) \
        < frame.start[-1]


def stale_spans(frame: SortedFrame, band: tuple[int, int] | None = None,
                r: int | None = None) -> torch.Tensor:
    """Per-tile stale cell spans i32[T, 2] = (min, max) of the live rows'
    anchor cells; a tile without live rows (in a band) takes
    :func:`pad_cell` (``r`` is needed then). Rows past ``n`` in the last
    tile never enter them."""
    live = _tiled(live_rows(frame), False)
    lo = torch.where(live, _tiled(frame.cid, _BIG), _BIG).amin(1)
    hi = torch.where(live, _tiled(frame.cid, -_BIG), -_BIG).amax(1)
    if band is not None:
        dead = ~live.any(1)
        pad = pad_cell(s_cells_of(r, band), r)
        lo, hi = torch.where(dead, pad, lo), torch.where(dead, pad, hi)
    return torch.stack([lo, hi], 1)


def fresh_spans(stale: torch.Tensor, pos_s: torch.Tensor, r: int,
                band: tuple[int, int] | None = None,
                live: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile fresh cell spans i32[T, 2] and the drift count i32[].

    The fresh cells trunc(pos·(R−1)) are clipped to [0, R−1] here (in a
    band, z then into the band's planes, as local ids); the gate uses them
    unclipped. A span is clamped to the stale span ± one cell plane
    (R² + R + 1); each live row outside that band counts once. ``live``
    (bool[N], :func:`live_rows`; None: every row) marks the rows that
    enter; a tile without them keeps its stale (pad) span."""
    s_cells = s_cells_of(r, band)
    cell = sph_math.cell_index(pos_s, r).clamp(0, r - 1)
    cz = cell[:, 2]
    if band is not None:
        cz = (cz - band[0]).clamp(0, band[1] - 1)
    fcid = cell[:, 0] + cell[:, 1] * r + cz * (r * r)
    if live is None:
        live = torch.ones_like(fcid, dtype=torch.bool)
    lt = _tiled(live, False)
    ft = _tiled(fcid, _BIG)
    m_allow = r * r + r + 1
    lo_allow = stale[:, 0:1] - m_allow
    hi_allow = stale[:, 1:2] + m_allow
    out_of_band = ((ft < lo_allow) | (ft > hi_allow)) & lt
    drift = out_of_band.sum(dtype=torch.int32)
    lo = torch.where(lt, ft, _BIG).amin(1, keepdim=True)
    hi = torch.where(lt, ft, -_BIG).amax(1, keepdim=True)
    lo = torch.minimum(torch.maximum(lo, lo_allow), hi_allow)
    hi = torch.minimum(torch.maximum(hi, lo_allow), hi_allow)
    spans = torch.cat([lo, hi], 1).clamp(0, s_cells - 1)
    if band is not None:
        spans = torch.where(lt.any(1, keepdim=True), spans, stale)
    return spans, drift


def tile_cells(spans: torch.Tensor, r: int,
               band: tuple[int, int] | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The nine disjoint line cell ranges of each tile, (ca, cb) i32[T, 9]:
    cells [ca, cb) in (dz, dy) order, dz outer, cells clipped to the
    table [0, S] (S = R³, or z_span·R² in a band)."""
    s_cells = s_cells_of(r, band)
    offs = torch.tensor([dz * r * r + dy * r for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1)], dtype=torch.int32,
                        device=spans.device)
    ca = (spans[:, 0:1] + offs - 1).clamp(0, s_cells)
    cb = (spans[:, 1:2] + offs + 2).clamp(0, s_cells)
    # offsets increase strictly with (dz, dy), so one running bound makes
    # the ranges disjoint and keeps their union
    prev = torch.zeros_like(ca[:, 0])
    for k in range(N_LINES):
        ca[:, k] = torch.maximum(ca[:, k], prev)
        cb[:, k] = torch.maximum(cb[:, k], ca[:, k])
        prev = cb[:, k]
    return ca, cb


def tile_segments(spans: torch.Tensor, start: torch.Tensor, r: int,
                  band: tuple[int, int] | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The nine disjoint line segments of each tile, (a, b) i32[T, 9]:
    sorted ranges [a, b) in (dz, dy) order, the slots of
    :func:`tile_cells` (``start`` is monotone, so deduplicating cells
    deduplicates their slots)."""
    ca, cb = tile_cells(spans, r, band)
    return start[ca.long()], start[cb.long()]


def stream_slots(spans: torch.Tensor, start: torch.Tensor, r: int,
                 capacity: int | None,
                 band: tuple[int, int] | None = None) -> torch.Tensor:
    """Slots i64[T] the kernel streams for each tile: every union cell's
    run cut at ``capacity`` (None: uncut, the length of the segments)."""
    ca, cb = tile_cells(spans, r, band)
    runs = start[1:] - start[:-1]
    if capacity is not None:
        runs = runs.clamp(max=capacity)
    cum = torch.cat([runs.new_zeros(1, dtype=torch.long),
                     runs.cumsum(0, dtype=torch.long)])
    return (cum[cb.long()] - cum[ca.long()]).sum(1)


def spans_of(frame: SortedFrame, pos_s: torch.Tensor, r: int, fresh: bool,
             band: tuple[int, int] | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(spans, drift count) of the tiles: the stale spans (density; drift
    0) or the fresh ones of ``pos_s`` (the force modes)."""
    stale = stale_spans(frame, band, r)
    if not fresh:
        return stale, torch.zeros((), dtype=torch.int32,
                                  device=pos_s.device)
    live = None if band is None else live_rows(frame)
    return fresh_spans(stale, pos_s, r, band, live)


# ------------------------------------------------------ the split plan --

def occ_prefix(occ: torch.Tensor) -> torch.Tensor:
    """i32[..., n + 1]: the occupied slots before each sorted index, per
    scene along the last axis (one scan over all scenes, each less the
    scenes' before it: the batched scan measured ten times slower)."""
    cum = occ.reshape(-1).cumsum(0, dtype=torch.int32).reshape(occ.shape)
    if occ.dim() > 1:
        cum = cum - torch.nn.functional.pad(cum[:-1, -1:], (0, 0, 1, 0))
    return torch.nn.functional.pad(cum, (1, 0))


def _cell_occ(start: torch.Tensor, occ_cum: torch.Tensor) -> torch.Tensor:
    """i64[S + 1]: the occupied slots before each cell's first slot."""
    return occ_cum[start.long()].long()


def tile_cost(spans: torch.Tensor, start: torch.Tensor, occ_cum: torch.Tensor,
              r: int, band: tuple[int, int] | None = None) -> torch.Tensor:
    """i32[T]: each tile's cost, the occupied slots of its union (the
    kernel's; 0 for a tile of dead rows)."""
    ca, cb = tile_cells(spans, r, band)
    o = _cell_occ(start, occ_cum)
    return (o[cb.long()] - o[ca.long()]).sum(1).int()


def n_chunks(cost: torch.Tensor, slots: int = SPLIT_SLOTS) -> torch.Tensor:
    """The chunks of each tile: 1 at or below ``slots``, else
    ``min(CHUNKS, ceil(cost / slots))``."""
    k = torch.div(cost + slots - 1, slots, rounding_mode="floor")
    return torch.where(cost > slots, k.clamp(max=CHUNKS), 1)


def chunk_cells(spans: torch.Tensor, start: torch.Tensor,
                occ_cum: torch.Tensor, r: int, slots: int = SPLIT_SLOTS,
                band: tuple[int, int] | None = None) -> torch.Tensor:
    """i32[T, CHUNKS + 1] cell bounds b: chunk m of a tile is the union's
    cells [b[m], b[m + 1]), b[0] = 0 and b[m] = S (the table's cells) from
    m = k on, k from :func:`n_chunks`. Inner bound m is the first union
    cell c at which the union's occupied slots before c reach m·cost // k
    (``compact.cu`` ``Tile::cut``): each chunk starts at a cell's first
    slot, and a light tile is one chunk, [0, S)."""
    s_cells = s_cells_of(r, band)
    ca, cb = tile_cells(spans, r, band)
    o = _cell_occ(start, occ_cum)
    o_a = o[ca.long()]
    length = o[cb.long()] - o_a
    before = length.cumsum(1) - length
    cost = length.sum(1)
    k = n_chunks(cost, slots)
    m = torch.arange(CHUNKS + 1, device=spans.device)
    t = torch.div(m * cost[:, None], k[:, None], rounding_mode="floor")
    # the first line whose count reaches t, then the first cell in it
    line = ((before + length)[:, None, :] >= t[..., None]).int().argmax(-1)
    need = (o_a - before).gather(1, line) + t
    cut = torch.searchsorted(o, need)
    cut = torch.where(m == 0, 0, torch.where(m >= k[:, None], s_cells, cut))
    return cut.int()


def clock_buffer(n: int, device, scenes: int = 1) -> torch.Tensor:
    """The tile clock's output of a launch over ``scenes`` frames of n rows:
    i64[S, T, CHUNKS, CLOCK_LANES], zero where no warp ran."""
    return torch.zeros((scenes, n_tiles(n), CHUNKS, CLOCK_LANES),
                       dtype=torch.int64, device=device)


def clock_stats(clocks: list[torch.Tensor]) -> dict:
    """The tile-time distribution of launches' clocks (one buffer a launch):
    each tile's time is its chunks' last end less their first start
    (``%globaltimer``, ns); p50, p99 and max in µs over all tiles, the mean
    tile time, the launches' makespans (each its last end less its first
    start) summed, the mean over launches of makespan / mean tile time, the
    warps busy on average (the chunks' spans summed over the makespans),
    and the tiles split with their chunks."""
    tiles, spans, ratios, split, chunks, busy = [], 0.0, [], 0, 0, 0.0
    for c in clocks:
        c = c.reshape(-1, CHUNKS, CLOCK_LANES).cpu()
        ran = c[..., 1] > 0
        used = ran.any(1)
        busy += float((c[..., 1] - c[..., 0])[ran].sum()) / 1e3
        big = torch.iinfo(torch.int64).max
        t0 = torch.where(ran, c[..., 0], big).amin(1)
        t1 = torch.where(ran, c[..., 1], 0).amax(1)
        tiles.append((t1 - t0)[used].double() / 1e3)
        span = float(t1[used].max() - t0[used].min()) / 1e3
        spans += span
        ratios.append(span / float(tiles[-1].mean()))
        n_ran = ran.sum(1)
        split += int((n_ran > 1).sum())
        chunks += int(n_ran[n_ran > 1].sum())
    us = torch.cat(tiles)
    return {"tiles": int(us.numel()), "p50_us": float(us.quantile(0.5)),
            "p99_us": float(us.quantile(0.99)), "max_us": float(us.max()),
            "mean_us": float(us.mean()), "makespan_us": spans,
            "makespan_over_mean": sum(ratios) / len(ratios),
            "busy_warps": busy / spans, "split_tiles": split,
            "split_chunks": chunks}


# ------------------------------------------------------ plain versions --

def _tile_slots(frame: SortedFrame, spans: torch.Tensor, r: int,
                band: tuple[int, int] | None = None):
    """Yields (tiles i64[t], j i64[t, W], valid bool[t, W]) over chunks of
    tiles: each tile's occupied union slots in sorted order, padded to W,
    the power of two at or above its count (``valid`` marks the real
    slots)."""
    dev = frame.start.device
    a, b = tile_segments(spans, frame.start, r, band)
    # occupied slots: the k-th occupied sorted index is occ_idx[k] (one
    # more entry, for the padding to index), and occ_cum[i] of them lie
    # before sorted index i
    occ_idx = torch.cat([frame.occ.nonzero()[:, 0],
                         torch.zeros(1, dtype=torch.long, device=dev)])
    occ_cum = torch.cat([frame.occ.new_zeros(1, dtype=torch.long),
                         frame.occ.long().cumsum(0)])
    oa, ob = occ_cum[a.long()], occ_cum[b.long()]
    ends = (ob - oa).cumsum(1)
    first = ends - (ob - oa)                 # offset of each segment
    total = ends[:, -1]
    width = torch.ones_like(total)
    while bool((width < total).any()):
        width = torch.where(width < total, width * 2, width)
    for w in torch.unique(width).tolist():
        tiles = (width == w).nonzero()[:, 0]
        per = max(1, _CHUNK_PAIRS // (CROWS * w))
        for t0 in range(0, tiles.shape[0], per):
            tl = tiles[t0:t0 + per]
            p = torch.arange(w, device=dev).expand(tl.shape[0], w)
            k = torch.searchsorted(ends[tl], p.contiguous(), right=True)
            k = k.clamp(max=N_LINES - 1)
            valid = p < total[tl, None]
            rank = torch.where(valid, oa[tl].gather(1, k) + p
                               - first[tl].gather(1, k), 0)
            yield tl, occ_idx[rank], valid


def _tile_candidates(frame: SortedFrame, spans: torch.Tensor,
                     pos_s: torch.Tensor, r: int,
                     band: tuple[int, int] | None = None):
    """Yields (ids i64[m], j i64[m, W], member bool[m, W]) over chunks of
    live rows: each row's candidates are the occupied slots of its tile's
    segments in sorted order (the gate drops every other slot, and wall
    piles make a segment hold thousands of them), padded to W, the power
    of two at or above the tile's count, so a row's tree sum does not
    depend on the chunking. Dead rows (in a band) are not yielded."""
    n = int(frame.start[-1])
    lane = torch.arange(CROWS, device=pos_s.device)
    for tl, j, valid in _tile_slots(frame, spans, r, band):
        ids = (tl[:, None] * CROWS + lane).reshape(-1)
        live = ids < n
        ids = ids[live]
        j = j.repeat_interleave(CROWS, 0)[live]
        valid = valid.repeat_interleave(CROWS, 0)[live]
        yield ids, j, member_gate(frame, j, valid, fresh_cell(pos_s[ids], r),
                                  r)


def member_pairs(frame: SortedFrame, pos_s: torch.Tensor, r: int,
                 fresh: bool,
                 band: tuple[int, int] | None = None) -> tuple[int, int]:
    """(member pairs, self pairs) of K5's tile candidates at these
    positions, over the stale spans (density) or the fresh ones (``fresh``,
    the force modes); as ``sph_kernels.member_pairs``. Waits for the
    card."""
    spans, _ = spans_of(frame, pos_s, r, fresh, band)
    total = own = 0
    for ids, j, member in _tile_candidates(frame, spans, pos_s, r, band):
        total += int(member.sum())
        own += int((member & (j == ids[:, None])).sum())
    return total, own


def walk_counts(frame: SortedFrame, pos_s: torch.Tensor, r: int,
                capacity: int | None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The row-loop steps of K5's forces mode for each tile over the fresh
    spans of ``pos_s``, (kept, paired, own) i64[T] (``compact.cu``
    Tile::walk):

    - kept: the slots its rounds keep (occupied, raw cell within 1 of the
      tile's fresh-cell box), each of which the walk of the round's list
      steps through on every live lane;
    - paired: those of them near some live row's fresh cell and not that
      row, for which that walk's warp runs the pair;
    - own: over its rounds, the sum of the largest count among the tile's
      live rows of the round's slots near the row's fresh cell and not the
      row itself: the steps of the lanes' own lists, each running the
      pair.

    A round is the kernel's 32 streamed slots: each union line's cells
    read up to ``capacity`` slots (None: uncut), a round starting at the
    line's first slot, 32 slots after the round before, or at the first
    slot of the cell after one the capacity cut (:func:`stream_slots`). Over
    the whole grid (the forces mode has no band); waits for the card."""
    spans, _ = spans_of(frame, pos_s, r, True)
    dev = pos_s.device
    n = pos_s.shape[0]
    cell = fresh_cell(pos_s, r)                     # the kernel's cx, cy, cz
    tiled = [_tiled(cell[:, a], 0) for a in range(3)]
    live = _tiled(torch.ones(n, dtype=torch.bool, device=dev), False)
    box_lo = torch.stack([torch.where(live, c, _BIG).amin(1) - 1
                          for c in tiled], 1)       # [T, 3]
    box_hi = torch.stack([torch.where(live, c, -_BIG).amax(1) + 1
                          for c in tiled], 1)
    ca, _ = tile_cells(spans, r)
    start = frame.start.long()
    runs = start[1:] - start[:-1]
    cells = torch.arange(runs.shape[0], device=dev)
    if capacity is None:
        reset = torch.zeros_like(cells)
    else:
        # the last cell at or before each whose cell before it was cut
        after_cut = torch.nn.functional.pad(runs[:-1] > capacity, (1, 0))
        reset = torch.cummax(torch.where(after_cut, cells, 0), 0).values
    kept = torch.zeros(spans.shape[0], dtype=torch.long, device=dev)
    paired, own = torch.zeros_like(kept), torch.zeros_like(kept)
    lane = torch.arange(CROWS, device=dev)
    rr = r * r
    for tl, j, valid in _tile_slots(frame, spans, r):
        raw = frame.raw[j]
        z = torch.div(raw, rr, rounding_mode="floor")
        y = torch.div(raw - z * rr, r, rounding_mode="floor")
        xyz = torch.stack([raw - z * rr - y * r, y, z], -1)   # [t, W, 3]
        in_box = valid & ((xyz >= box_lo[tl, None]) &
                          (xyz <= box_hi[tl, None])).all(-1)
        kept.index_add_(0, tl, in_box.sum(1))
        # each slot's round: its line's first cell, or the cell after the
        # last cut one, then 32 slots a round from that cell's first slot
        c = frame.cid[j].long()
        k = torch.searchsorted(ca[tl].contiguous(), c.int().contiguous(),
                               right=True) - 1
        first = torch.maximum(reset[c], ca[tl].long().gather(1, k.clamp(0)))
        s0 = start[first]
        base = s0 + torch.div(j - s0, CROWS, rounding_mode="floor") * CROWS
        new = torch.ones_like(valid)
        new[:, 1:] = base[:, 1:] != base[:, :-1]
        rnd = new.long().cumsum(1) - 1                         # [t, W]
        ids = tl[:, None] * CROWS + lane                       # [t, 32]
        rows = ids.clamp(max=n - 1)
        near = ((xyz[:, None] - cell[rows][:, :, None]).abs() <= 1).all(-1)
        mine = (near & valid[:, None] & (j[:, None] != ids[..., None])
                & (ids < n)[..., None])                        # [t, 32, W]
        paired.index_add_(0, tl, mine.any(1).sum(1))
        steps = torch.zeros(mine.shape, dtype=torch.long, device=dev)
        steps.scatter_add_(2, rnd[:, None].expand(mine.shape), mine.long())
        own.index_add_(0, tl, steps.amax(1).sum(1))
    return kept, paired, own


def density_compact_plain(frame: SortedFrame, pos_s: torch.Tensor,
                          phys: PhysParams, r: int,
                          band: tuple[int, int] | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ρ, cert) per sorted particle over the tiles' stale segments, self
    included (Density.compute:32-60), 0 for dead rows; the certificate is
    0."""
    w_sum = pos_s.new_zeros(pos_s.shape[0])
    spans, cert = spans_of(frame, pos_s, r, False, band)
    for ids, j, member in _tile_candidates(frame, spans, pos_s, r, band):
        w_sum[ids] = density_sums_plain(pos_s, phys, ids, j, member)
    return phys.mass * w_sum, cert


def compact_sums_plain(frame: SortedFrame, rows: torch.Tensor,
                       phys: PhysParams, r: int, capacity: int | None = None,
                       ext: bool = False, magnitude: bool = False,
                       band: tuple[int, int] | None = None,
                       tune: SortedTuning | None = None) -> torch.Tensor:
    """K5's raw force-side pair sums f[N, 12] in the layout of K3's
    ``facc0`` instance (press 3, visc 3, xsph 3, avisc 3), over the tiles'
    fresh segments, in the variant ``tune`` reduced to K5's
    (``SortedTuning.k5()``: bf16 only). Dead rows' sums are 0.
    ``capacity`` is not used: the segments are not cut, and ``frame.occ``
    already drops the slots past it. It keeps ``forces_plain``'s signature
    for the accuracy rules (``sums_fn``)."""
    del capacity
    tune = (tune or SortedTuning()).k5()
    pos_s = rows[:, 0:3]
    spans, _ = spans_of(frame, pos_s, r, True, band)
    out = rows.new_zeros((rows.shape[0], N_SUMS))
    for ids, j, member in _tile_candidates(frame, spans, pos_s, r, band):
        sums = force_sums_plain(rows, phys, ids, j, member, ext, magnitude,
                                tune)
        out[ids, :sums.shape[1]] = sums
    return out


# the variant and the layout of K5's sums under a tuning (sph_kernels.SumsFn)
compact_sums_plain.variant = SortedTuning.k5


def compact_substep_plain(frame: SortedFrame, rows: torch.Tensor,
                          phys: PhysParams, r: int, xsph: float = 0.0,
                          alpha_visc: float = 0.0,
                          band: tuple[int, int] | None = None,
                          tune: SortedTuning | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows', cert): one whole substep on K5's candidates, folded and
    integrated as K2's plain version does; dead rows copied through."""
    out = fused_substep_plain(frame, rows, phys, r, None, xsph, alpha_visc,
                              compact_sums_plain, band, tune)
    return out, spans_of(frame, rows[:, 0:3], r, True, band)[1]


def forces_compact_plain(frame: SortedFrame, rows: torch.Tensor,
                         phys: PhysParams, r: int,
                         tune: SortedTuning | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(raw sums f[N, 12], cert) without extensions on K5's candidates."""
    return compact_sums_plain(frame, rows, phys, r, tune=tune), \
        spans_of(frame, rows[:, 0:3], r, True)[1]


# ---------------------------------------------------------- CUDA route --

_MAX_R = 1024            # the kernel packs a raw cell in 10 bits an axis


def _split_scratch(n_scenes: int, tiles: int, fields: int,
                   dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The split launch's queue, i32[8·S·T], and its chunks' partial sums,
    f32[4·S·T, fields, CROWS], ``fields`` the sums a row hands on (density
    1, the substep 6, 12 with extensions) (``compact.cu`` Queue: the queue
    holds 4 chunks a tile; its 6 counters follow the drift counts)."""
    slots = n_scenes * tiles
    queue = torch.empty(8 * slots, dtype=torch.int32, device=dev)
    part = torch.empty((4 * slots, fields, CROWS), dtype=torch.float32,
                       device=dev)
    return queue, part


def _launch(mode: int, ext: bool, inp: torch.Tensor, pj: torch.Tensor | None,
            frame: SortedFrame, scal: torch.Tensor, out: torch.Tensor, r: int,
            capacity: int | None, band: tuple[int, int] | None,
            tune: SortedTuning, n_scenes: int | None = None, split: int = 0,
            occ_cum: torch.Tensor | None = None,
            clock: torch.Tensor | None = None) -> torch.Tensor:
    """Launches the K5 instance ``mode`` over ``band`` in ``tune``'s
    variant, over one frame or (``n_scenes``) a scene axis, every tile
    walked whole, or with ``split`` > 0 (the fused substep; density over
    one frame) the tiles past ``split`` occupied union slots split
    (``occ_cum``: :func:`occ_prefix` of ``frame.occ``, built here when
    None); returns the drift count, i32[] or i32[S] (accumulated by the
    kernel for the force modes, 0 for density). ``clock``
    (:func:`clock_buffer`) launches the tile-clock instance, which writes
    it."""
    stacked = n_scenes is not None
    n_scenes = n_scenes or 1
    n = inp.shape[1] if stacked else inp.shape[0]
    dev = inp.device
    if r > _MAX_R:
        raise ValueError(f"K5 takes R <= {_MAX_R}; got {r}")
    if stacked:
        _check_scenes(frame, n_scenes, n, r, scal, dev)
        _check("frame.cid", frame.cid, torch.int32, (n_scenes, n), dev)
        if pj is not None:
            _check("pj", pj, torch.float32, (n_scenes, n, 2), dev)
    else:
        _check("frame.cid", frame.cid, torch.int32, (n,), dev)
        _check("frame.start", frame.start, torch.int32,
               (s_cells_of(r, band) + 1,), dev)
        _check("frame.raw", frame.raw, torch.int32, (n,), dev)
        _check("frame.occ", frame.occ, torch.bool, (n,), dev)
        _check("phys", scal, torch.float32, (N_SCAL,), dev)
        if pj is not None:
            _check("pj", pj, torch.float32, (n, 2), dev)
    if clock is not None:
        _check("clock", clock, torch.int64,
               (n_scenes, n_tiles(n), CHUNKS, CLOCK_LANES), dev)
    # the drift counts, then (the split launch) the queue's 6 counters: one
    # zeroed buffer
    counts = torch.zeros(n_scenes + 6, dtype=torch.int32, device=dev)
    cert = counts[:n_scenes] if stacked else counts[0]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    args = (_ptr(inp), None if pj is None else _ptr(pj), _ptr(frame.cid),
            _ptr(frame.start), _ptr(frame.raw), _ptr(frame.occ))
    tail = (_ptr(scal), _ptr(out), _ptr(counts))
    clk = None if clock is None else _ptr(clock)

    def lib(name):
        return cuda_build.function("compact.cu", name, tune,
                                   clock=clock is not None)

    if split > 0 and n > 0:
        if occ_cum is None:
            occ_cum = occ_prefix(frame.occ)
        _check("occ_cum", occ_cum, torch.int32,
               (n_scenes, n + 1) if stacked else (n + 1,), dev)
        fields = 1 if mode == _DENSITY else 12 if ext else 6
        queue, part = _split_scratch(n_scenes, n_tiles(n), fields, dev)
        err = lib("sph_compact_split")(
            mode, int(ext), *args, _ptr(occ_cum), *tail, _ptr(queue),
            _ptr(part), clk, n, r, _cap_arg(capacity), *_band_args(band, r),
            n_scenes, split, stream)
    elif stacked:
        err = lib("sph_compact_scenes")(mode, int(ext), *args, *tail, clk, n,
                                        r, _cap_arg(capacity), n_scenes,
                                        stream)
    else:
        err = lib("sph_compact")(mode, int(ext), *args, *tail, clk, n, r,
                                 _cap_arg(capacity), *_band_args(band, r),
                                 stream)
    _raise_on_error("compact", err)
    return cert


def _name(base: str, band: tuple[int, int] | None,
          tune: SortedTuning) -> str:
    """The launch counter of K5 instance ``base``."""
    return (base + ("" if band is None else "_band")
            + variant_tag("compact.cu", tune))


def density_compact_cuda(frame: SortedFrame, pos_s: torch.Tensor,
                         phys: PhysParams, r: int, capacity: int | None,
                         scal: torch.Tensor | None = None,
                         band: tuple[int, int] | None = None,
                         occ_cum: torch.Tensor | None = None,
                         split: int | None = None,
                         clock: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 density (``csrc/compact.cu``) on the card, banded with ``band``.
    ``capacity`` is the frame's voxel capacity (None: each union cell
    streamed uncut); ``scal`` is ``scal_block(phys)`` (built here when
    None). A tile whose union holds more than ``split`` occupied slots is
    split (None: :data:`DENSITY_SPLIT_SLOTS` over a band, and 0 over the
    whole grid, where the solo launch keeps the scene axis's bits; 0: every
    tile walked whole), given ``occ_cum`` as :func:`compact_substep_cuda`;
    ``clock`` (:func:`clock_buffer`) runs the tile-clock instance. Density
    reads no variant switch: the default instance."""
    n = pos_s.shape[0]
    _check("pos_s", pos_s, torch.float32, (n, 3), pos_s.device)
    rho = torch.empty(n, dtype=torch.float32, device=pos_s.device)
    if scal is None:
        scal = scal_block(phys)
    if split is None:
        split = 0 if band is None else DENSITY_SPLIT_SLOTS
    k5 = SortedTuning().k5()
    cert = _launch(_DENSITY, False, pos_s, None, frame, scal, rho, r,
                   capacity, band, k5, split=split, occ_cum=occ_cum,
                   clock=clock)
    _count(_name("compact_density", band, k5))
    return rho, cert


def compact_substep_cuda(frame: SortedFrame, rows: torch.Tensor,
                         phys: PhysParams, r: int, capacity: int | None,
                         xsph: float = 0.0, alpha_visc: float = 0.0,
                         pj: torch.Tensor | None = None,
                         scal: torch.Tensor | None = None,
                         band: tuple[int, int] | None = None,
                         tune: SortedTuning | None = None,
                         occ_cum: torch.Tensor | None = None,
                         split: int = SPLIT_SLOTS,
                         clock: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 fused substep on the card, banded with ``band``, in ``tune``'s
    variant (``bf16``; None: the default instance); nonzero coefficients
    select the instance with the extension sums. ``capacity`` as in
    :func:`density_compact_cuda`; ``pj`` is ``pj_cols`` of the rows' ρ
    (the bf16 instance reads ρⱼ from the rows instead), ``scal`` is
    ``scal_block`` of ``phys`` and the coefficients and ``occ_cum`` is
    ``occ_prefix(frame.occ)`` (each built here when None). A tile whose
    union holds more than ``split`` occupied slots is split (0: every tile
    walked whole, the route's body before the split); ``clock``
    (:func:`clock_buffer`) runs the tile-clock instance, which fills it."""
    n = rows.shape[0]
    _check("rows", rows, torch.float32, (n, N_FIELDS), rows.device)
    k5 = (tune or SortedTuning()).k5()
    ext = uses_extensions(xsph, alpha_visc)
    out = torch.empty_like(rows)
    if pj is None:
        pj = pj_cols(rows[:, 6], phys)
    if scal is None:
        scal = scal_block(phys, xsph, alpha_visc)
    cert = _launch(_FUSED, ext, rows, pj, frame, scal, out, r, capacity,
                   band, k5, split=split, occ_cum=occ_cum, clock=clock)
    _count(_name("compact_substep_ext" if ext else "compact_substep", band,
                 k5))
    return out, cert


def forces_compact_cuda(frame: SortedFrame, rows: torch.Tensor,
                        phys: PhysParams, r: int, capacity: int | None,
                        pj: torch.Tensor | None = None,
                        scal: torch.Tensor | None = None,
                        tune: SortedTuning | None = None,
                        own: bool | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 forces without extensions on the card: (raw sums f32[N, 12] in
    the layout of K3's ``facc0`` instance, cert), in ``tune``'s variant,
    every tile walked whole. ``capacity``, ``pj`` and ``scal`` as in
    :func:`compact_substep_cuda`. ``own`` chooses the walk, each lane
    through its own slots of a round or every lane through the round's
    list, the same bits; None: :func:`own_lists`.
    It walks the whole grid: the slab step never launches it."""
    n = rows.shape[0]
    _check("rows", rows, torch.float32, (n, N_FIELDS), rows.device)
    k5 = (tune or SortedTuning()).k5()
    sums = torch.empty((n, N_SUMS), dtype=torch.float32, device=rows.device)
    if pj is None:
        pj = pj_cols(rows[:, 6], phys)
    if scal is None:
        scal = scal_block(phys)
    cert = _launch(_forces_mode(own, n, r), False, rows, pj, frame, scal,
                   sums, r, capacity, None, k5)
    _count(_name("compact_forces", None, k5))
    return sums, cert


def own_lists(n: int, r: int) -> bool:
    """Whether K5 forces over frames of ``n`` rows at ``r`` cells an axis
    walks the lanes' own lists: below :data:`OWN_LISTS_ROWS_PER_CELL` rows
    a cell."""
    return n < OWN_LISTS_ROWS_PER_CELL * r ** 3


def _forces_mode(own: bool | None, n: int, r: int) -> int:
    return _FORCES_OWN if (own_lists(n, r) if own is None else own) \
        else _FORCES


# ------------------------------------------------------------- routing --
# ``capacity``, ``pj``, ``scal`` and ``occ_cum`` are read by the kernels
# only: the plain versions do not depend on them.

def density_compact(frame: SortedFrame, pos_s: torch.Tensor,
                    phys: PhysParams, r: int, capacity: int | None,
                    scal: torch.Tensor | None = None,
                    band: tuple[int, int] | None = None,
                    occ_cum: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ρ, cert) per sorted particle over ``band``: K5 for a CUDA tensor,
    the plain version for a CPU one. The certificate is 0."""
    if pos_s.is_cuda:
        return density_compact_cuda(frame, pos_s, phys, r, capacity, scal,
                                    band, occ_cum)
    return density_compact_plain(frame, pos_s, phys, r, band)


def compact_substep(frame: SortedFrame, rows: torch.Tensor,
                    phys: PhysParams, r: int, capacity: int | None,
                    xsph: float = 0.0, alpha_visc: float = 0.0,
                    pj: torch.Tensor | None = None,
                    scal: torch.Tensor | None = None,
                    band: tuple[int, int] | None = None,
                    tune: SortedTuning | None = None,
                    occ_cum: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows', drift count): one whole substep over the rows state and
    ``band``, in ``tune``'s variant, K5 for a CUDA tensor, the plain version
    for a CPU one."""
    if rows.is_cuda:
        return compact_substep_cuda(frame, rows, phys, r, capacity, xsph,
                                    alpha_visc, pj, scal, band, tune,
                                    occ_cum)
    return compact_substep_plain(frame, rows, phys, r, xsph, alpha_visc,
                                 band, tune)


def forces_compact(frame: SortedFrame, rows: torch.Tensor, phys: PhysParams,
                   r: int, capacity: int | None,
                   pj: torch.Tensor | None = None,
                   scal: torch.Tensor | None = None,
                   tune: SortedTuning | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(force f[N, 3], drift count) without extensions: the raw sums from
    K5 for a CUDA tensor or from the plain version for a CPU one, in
    ``tune``'s variant, then ``fold_forces`` (K5's layout). With extensions
    the stepper takes K3, as JAX's ``forces_pallas`` does
    (pallas_sph.py:1720)."""
    if rows.is_cuda:
        sums, cert = forces_compact_cuda(frame, rows, phys, r, capacity, pj,
                                         scal, tune)
    else:
        sums, cert = forces_compact_plain(frame, rows, phys, r, tune)
    return fold_forces(sums, rows[:, 6], phys, fuse_acc=False)[0], cert


# ---------------------------------------------------------- scene axis --
# Each scene's frame is ``scene_frame(frame, s)``, its physics row s of the
# stacked params; the plain versions run the solo plain versions scene by
# scene, the kernel's warps are the solo kernel's warps of their scene
# (``compact.cu::compact_kernel``, blockIdx.y the scene; each scene's tiles
# ranked and split as its solo launch's), and each scene has its own drift
# count, as JAX's vmapped certificate has.

def _stacked(outs: list[tuple[torch.Tensor, torch.Tensor]]
             ) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def density_compact_scenes_plain(frame: SortedFrame, pos_s: torch.Tensor,
                                 params: PhysParams, r: int
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ρ f32[S, N], cert i32[S]): :func:`density_compact_plain` of each
    scene."""
    return _stacked([density_compact_plain(scene_frame(frame, s), pos_s[s],
                                           scene_params(params, s), r)
                     for s in range(pos_s.shape[0])])


def compact_substep_scenes_plain(frame: SortedFrame, rows: torch.Tensor,
                                 params: PhysParams, r: int,
                                 xsph: float = 0.0, alpha_visc: float = 0.0,
                                 tune: SortedTuning | None = None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows' f32[S, N, 8], cert i32[S]): :func:`compact_substep_plain` of
    each scene."""
    return _stacked([compact_substep_plain(scene_frame(frame, s), rows[s],
                                           scene_params(params, s), r, xsph,
                                           alpha_visc, tune=tune)
                     for s in range(rows.shape[0])])


def forces_compact_scenes_plain(frame: SortedFrame, rows: torch.Tensor,
                                params: PhysParams, r: int,
                                tune: SortedTuning | None = None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(raw sums f32[S, N, 12], cert i32[S]): :func:`forces_compact_plain`
    of each scene."""
    return _stacked([forces_compact_plain(scene_frame(frame, s), rows[s],
                                          scene_params(params, s), r, tune)
                     for s in range(rows.shape[0])])


def density_compact_scenes_cuda(frame: SortedFrame, pos_s: torch.Tensor,
                                params: PhysParams, r: int,
                                capacity: int | None,
                                scal: torch.Tensor | None = None,
                                clock: torch.Tensor | None = None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 density over the scene axis on the card: (ρ f32[S, N], cert
    i32[S]) in one launch, every tile walked whole. ``scal`` is
    ``scal_blocks(params)`` (built here when None); ``clock``
    (``clock_buffer(N, dev, S)``) runs the tile-clock instance. The default
    instance, as :func:`density_compact_cuda`."""
    n_scenes, n = pos_s.shape[:2]
    _check("pos_s", pos_s, torch.float32, (n_scenes, n, 3), pos_s.device)
    rho = torch.empty((n_scenes, n), dtype=torch.float32,
                      device=pos_s.device)
    if scal is None:
        scal = scal_blocks(params)
    k5 = SortedTuning().k5()
    cert = _launch(_DENSITY, False, pos_s, None, frame, scal, rho, r,
                   capacity, None, k5, n_scenes, clock=clock)
    _count("compact_density_scenes")
    return rho, cert


def compact_substep_scenes_cuda(frame: SortedFrame, rows: torch.Tensor,
                                params: PhysParams, r: int,
                                capacity: int | None, xsph: float = 0.0,
                                alpha_visc: float = 0.0,
                                pj: torch.Tensor | None = None,
                                scal: torch.Tensor | None = None,
                                tune: SortedTuning | None = None,
                                occ_cum: torch.Tensor | None = None,
                                split: int = SPLIT_SLOTS,
                                clock: torch.Tensor | None = None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 fused substep over the scene axis on the card, in ``tune``'s
    variant: (rows' f32[S, N, 8], cert i32[S]) in one launch. ``pj`` is
    ``pj_cols_scenes`` of the rows' ρ, ``scal`` ``scal_blocks`` of
    ``params`` and the coefficients and ``occ_cum`` ``occ_prefix(frame.occ)``
    (i32[S, N + 1]; each built here when None); ``split`` and ``clock``
    (``clock_buffer(N, dev, S)``) as in :func:`compact_substep_cuda`."""
    n_scenes, n = rows.shape[:2]
    _check("rows", rows, torch.float32, (n_scenes, n, N_FIELDS),
           rows.device)
    k5 = (tune or SortedTuning()).k5()
    ext = uses_extensions(xsph, alpha_visc)
    out = torch.empty_like(rows)
    if pj is None:
        pj = pj_cols_scenes(rows[..., 6], params)
    if scal is None:
        scal = scal_blocks(params, xsph, alpha_visc)
    cert = _launch(_FUSED, ext, rows, pj, frame, scal, out, r, capacity,
                   None, k5, n_scenes, split, occ_cum, clock)
    base = "compact_substep_ext" if ext else "compact_substep"
    _count(base + "_scenes" + variant_tag("compact.cu", k5))
    return out, cert


def forces_compact_scenes_cuda(frame: SortedFrame, rows: torch.Tensor,
                               params: PhysParams, r: int,
                               capacity: int | None,
                               pj: torch.Tensor | None = None,
                               scal: torch.Tensor | None = None,
                               tune: SortedTuning | None = None,
                               clock: torch.Tensor | None = None,
                               own: bool | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 forces without extensions over the scene axis on the card: (raw
    sums f32[S, N, 12] in K5's layout, cert i32[S]) in one launch, in
    ``tune``'s variant, each scene through the walk its solo launch takes;
    ``pj``, ``scal`` and ``clock`` as in :func:`compact_substep_scenes_cuda`,
    ``own`` as in :func:`forces_compact_cuda`."""
    n_scenes, n = rows.shape[:2]
    _check("rows", rows, torch.float32, (n_scenes, n, N_FIELDS),
           rows.device)
    k5 = (tune or SortedTuning()).k5()
    sums = torch.empty((n_scenes, n, N_SUMS), dtype=torch.float32,
                       device=rows.device)
    if pj is None:
        pj = pj_cols_scenes(rows[..., 6], params)
    if scal is None:
        scal = scal_blocks(params)
    cert = _launch(_forces_mode(own, n, r), False, rows, pj, frame, scal,
                   sums, r, capacity, None, k5, n_scenes, clock=clock)
    _count("compact_forces_scenes" + variant_tag("compact.cu", k5))
    return sums, cert


def density_compact_scenes(frame: SortedFrame, pos_s: torch.Tensor,
                           params: PhysParams, r: int, capacity: int | None,
                           scal: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ρ f32[S, N], cert i32[S]) of every scene: K5's scene-axis instance
    for a CUDA tensor, the plain version for a CPU one."""
    if pos_s.is_cuda:
        return density_compact_scenes_cuda(frame, pos_s, params, r,
                                           capacity, scal)
    return density_compact_scenes_plain(frame, pos_s, params, r)


def compact_substep_scenes(frame: SortedFrame, rows: torch.Tensor,
                           params: PhysParams, r: int, capacity: int | None,
                           xsph: float = 0.0, alpha_visc: float = 0.0,
                           pj: torch.Tensor | None = None,
                           scal: torch.Tensor | None = None,
                           tune: SortedTuning | None = None,
                           occ_cum: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows' f32[S, N, 8], cert i32[S]): one substep of every scene in
    ``tune``'s variant, K5's scene-axis instance for a CUDA tensor, the
    plain version for a CPU one."""
    if rows.is_cuda:
        return compact_substep_scenes_cuda(frame, rows, params, r, capacity,
                                           xsph, alpha_visc, pj, scal, tune,
                                           occ_cum)
    return compact_substep_scenes_plain(frame, rows, params, r, xsph,
                                        alpha_visc, tune)


def forces_compact_scenes(frame: SortedFrame, rows: torch.Tensor,
                          params: PhysParams, r: int, capacity: int | None,
                          pj: torch.Tensor | None = None,
                          scal: torch.Tensor | None = None,
                          tune: SortedTuning | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(force f[S, N, 3], cert i32[S]) without extensions:
    :func:`forces_compact` of every scene, the raw sums from K5's
    scene-axis instance for a CUDA tensor or from the plain version for a
    CPU one, folded over the scenes (``sph_kernels.scene_view``)."""
    if rows.is_cuda:
        sums, cert = forces_compact_scenes_cuda(frame, rows, params, r,
                                                capacity, pj, scal, tune)
    else:
        sums, cert = forces_compact_scenes_plain(frame, rows, params, r,
                                                 tune)
    return fold_forces(sums, rows[..., 6], scene_view(params),
                       fuse_acc=False)[0], cert
