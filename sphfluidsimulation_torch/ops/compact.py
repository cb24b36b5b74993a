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

Routing: a CPU tensor goes to the plain version; a CUDA tensor launches
``csrc/compact.cu`` or raises. Each entry point returns ``(out, cert)``.
"""

from __future__ import annotations

import ctypes

import torch

from ..params import PhysParams
from . import cuda_build, sph_math
from .frame import SortedFrame
from .sph_kernels import (N_FIELDS, N_SCAL, N_SUMS, _CHUNK_PAIRS,
                          SortedTuning, _band_args, _cap_arg, _check, _count,
                          _ptr, _raise_on_error, density_sums_plain,
                          fold_forces, force_sums_plain, fresh_cell,
                          fused_substep_plain, member_gate, pj_cols,
                          scal_block, uses_extensions, variant_tag)

CROWS = 32               # rows per tile: one warp
N_LINES = 9              # (dz, dy) ∈ [−1, 1]² candidate lines per tile
_BIG = 1 << 30
# the kernel's mode argument (csrc/compact.cu)
_DENSITY, _FORCES, _FUSED = 0, 1, 2


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


# ------------------------------------------------------ plain versions --

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
    dev = pos_s.device
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
    lane = torch.arange(CROWS, device=dev)
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
            j = occ_idx[rank]
            ids = (tl[:, None] * CROWS + lane).reshape(-1)
            live = ids < n
            ids = ids[live]
            j = j.repeat_interleave(CROWS, 0)[live]
            valid = valid.repeat_interleave(CROWS, 0)[live]
            yield ids, j, member_gate(frame, j, valid,
                                      fresh_cell(pos_s[ids], r), r)


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


def _launch(mode: int, ext: bool, inp: torch.Tensor, pj: torch.Tensor | None,
            frame: SortedFrame, scal: torch.Tensor, out: torch.Tensor, r: int,
            capacity: int | None, band: tuple[int, int] | None,
            tune: SortedTuning) -> torch.Tensor:
    """Launches the K5 instance ``mode`` over ``band`` in ``tune``'s
    variant; returns the drift count i32[] (accumulated by the kernel for
    the force modes, 0 for density)."""
    n = inp.shape[0]
    dev = inp.device
    if r > _MAX_R:
        raise ValueError(f"K5 takes R <= {_MAX_R}; got {r}")
    _check("frame.cid", frame.cid, torch.int32, (n,), dev)
    _check("frame.start", frame.start, torch.int32,
           (s_cells_of(r, band) + 1,), dev)
    _check("frame.raw", frame.raw, torch.int32, (n,), dev)
    _check("frame.occ", frame.occ, torch.bool, (n,), dev)
    _check("phys", scal, torch.float32, (N_SCAL,), dev)
    if pj is not None:
        _check("pj", pj, torch.float32, (n, 2), dev)
    cert = torch.zeros((), dtype=torch.int32, device=dev)
    fn = cuda_build.function("compact.cu", "sph_compact", tune)
    err = fn(mode, int(ext), _ptr(inp), None if pj is None else _ptr(pj),
             _ptr(frame.cid), _ptr(frame.start), _ptr(frame.raw),
             _ptr(frame.occ), _ptr(scal), _ptr(out), _ptr(cert), n, r,
             _cap_arg(capacity), *_band_args(band, r),
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
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
                         band: tuple[int, int] | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 density (``csrc/compact.cu``) on the card, banded with ``band``.
    ``capacity`` is the frame's voxel capacity (None: each union cell
    streamed uncut); ``scal`` is ``scal_block(phys)`` (built here when
    None). Density reads no variant switch: the default instance."""
    n = pos_s.shape[0]
    _check("pos_s", pos_s, torch.float32, (n, 3), pos_s.device)
    rho = torch.empty(n, dtype=torch.float32, device=pos_s.device)
    if scal is None:
        scal = scal_block(phys)
    k5 = SortedTuning().k5()
    cert = _launch(_DENSITY, False, pos_s, None, frame, scal, rho, r,
                   capacity, band, k5)
    _count(_name("compact_density", band, k5))
    return rho, cert


def compact_substep_cuda(frame: SortedFrame, rows: torch.Tensor,
                         phys: PhysParams, r: int, capacity: int | None,
                         xsph: float = 0.0, alpha_visc: float = 0.0,
                         pj: torch.Tensor | None = None,
                         scal: torch.Tensor | None = None,
                         band: tuple[int, int] | None = None,
                         tune: SortedTuning | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 fused substep on the card, banded with ``band``, in ``tune``'s
    variant (``bf16``; None: the default instance); nonzero coefficients
    select the instance with the extension sums. ``capacity`` as in
    :func:`density_compact_cuda`; ``pj`` is ``pj_cols`` of the rows' ρ
    (the bf16 instance reads ρⱼ from the rows instead) and ``scal`` is
    ``scal_block`` of ``phys`` and the coefficients (each built here when
    None)."""
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
                   band, k5)
    _count(_name("compact_substep_ext" if ext else "compact_substep", band,
                 k5))
    return out, cert


def forces_compact_cuda(frame: SortedFrame, rows: torch.Tensor,
                        phys: PhysParams, r: int, capacity: int | None,
                        pj: torch.Tensor | None = None,
                        scal: torch.Tensor | None = None,
                        tune: SortedTuning | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 forces without extensions on the card: (raw sums f32[N, 12] in
    the layout of K3's ``facc0`` instance, cert), in ``tune``'s variant.
    ``capacity``, ``pj`` and ``scal`` as in :func:`compact_substep_cuda`.
    It walks the whole grid: the slab step never launches it."""
    n = rows.shape[0]
    _check("rows", rows, torch.float32, (n, N_FIELDS), rows.device)
    k5 = (tune or SortedTuning()).k5()
    sums = torch.empty((n, N_SUMS), dtype=torch.float32, device=rows.device)
    if pj is None:
        pj = pj_cols(rows[:, 6], phys)
    if scal is None:
        scal = scal_block(phys)
    cert = _launch(_FORCES, False, rows, pj, frame, scal, sums, r, capacity,
                   None, k5)
    _count(_name("compact_forces", None, k5))
    return sums, cert


# ------------------------------------------------------------- routing --
# ``capacity``, ``pj`` and ``scal`` are read by the kernels only: the plain
# versions do not depend on them.

def density_compact(frame: SortedFrame, pos_s: torch.Tensor,
                    phys: PhysParams, r: int, capacity: int | None,
                    scal: torch.Tensor | None = None,
                    band: tuple[int, int] | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ρ, cert) per sorted particle over ``band``: K5 for a CUDA tensor,
    the plain version for a CPU one. The certificate is 0."""
    if pos_s.is_cuda:
        return density_compact_cuda(frame, pos_s, phys, r, capacity, scal,
                                    band)
    return density_compact_plain(frame, pos_s, phys, r, band)


def compact_substep(frame: SortedFrame, rows: torch.Tensor,
                    phys: PhysParams, r: int, capacity: int | None,
                    xsph: float = 0.0, alpha_visc: float = 0.0,
                    pj: torch.Tensor | None = None,
                    scal: torch.Tensor | None = None,
                    band: tuple[int, int] | None = None,
                    tune: SortedTuning | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows', drift count): one whole substep over the rows state and
    ``band``, in ``tune``'s variant, K5 for a CUDA tensor, the plain version
    for a CPU one."""
    if rows.is_cuda:
        return compact_substep_cuda(frame, rows, phys, r, capacity, xsph,
                                    alpha_visc, pj, scal, band, tune)
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
