"""K5, the compact-lane route: density, fused substep and forces over each
32-row tile's merged candidate list. CUDA kernel and plain PyTorch versions.

Counterpart of ``sphfluidsimulation_tpu/ops/pallas_compact.py``:
``stale_spans`` (:121), ``fresh_spans`` (:147), the segment derivation and
membership gate of ``_compact_kernel`` (:237; segments :326-339, gate
:394-402) and the entry points ``density_compact`` (:622),
``compact_substep`` (:648) and ``forces_compact`` (:681).

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
The JAX kernel keeps the self pair in its force sums; the port drops it,
as JAX's other kernels and the reference (VelPos.compute:82) do, which
changes nothing for finite rows.

What is not ported, and why. ``slice_cells``, ``group_slice_bases``,
``padded_start``, ``_table_len`` and ``_pad_cell`` size and place the
start-table slice that the TPU copies into its scalar memory;
``compact_chunks`` sizes the 128-lane compact buffer and the group window
(``win_f``) the DMA. The CUDA kernel reads ``start[]`` and the candidates
straight from device memory, so none of them has a counterpart, and neither
have the three layout truncations JAX adds to the certificate (``out_slice``,
``clip_w``, ``ovf``, :334-352): the certificate here is the drift count
alone. The slab band (``band=``) and bf16 candidates are not ported.

Routing: a CPU tensor goes to the plain version; a CUDA tensor launches
``csrc/compact.cu`` or raises. Each entry point returns ``(out, cert)``.
"""

from __future__ import annotations

import ctypes

import torch

from ..params import PhysParams
from . import cuda_build, sph_math
from .frame import SortedFrame
from .sph_kernels import (N_FIELDS, N_SCAL, N_SUMS, _CHUNK_PAIRS, _check,
                          _ptr, _raise_on_error, density_sums_plain,
                          fold_forces, force_sums_plain, fresh_cell,
                          fused_substep_plain, launch_counts, member_gate,
                          scal_block, uses_extensions)

CROWS = 32               # rows per tile: one warp
N_LINES = 9              # (dz, dy) ∈ [−1, 1]² candidate lines per tile
_BIG = 1 << 30
# the kernel's mode argument (csrc/compact.cu)
_DENSITY, _FORCES, _FUSED = 0, 1, 2


# ------------------------------------------------------- tile geometry --

def n_tiles(n: int) -> int:
    return -(-n // CROWS)


def _tiled(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x i32[n] → i32[T, CROWS], the ragged last tile padded with ``fill``."""
    n = x.shape[0]
    pad = n_tiles(n) * CROWS - n
    if pad:
        x = torch.cat([x, x.new_full((pad,), fill)])
    return x.reshape(-1, CROWS)


def stale_spans(frame: SortedFrame) -> torch.Tensor:
    """Per-tile stale cell spans i32[T, 2] = (min, max) of the rows' anchor
    cells. Rows past ``n`` in the last tile never enter them."""
    lo = _tiled(frame.cid, _BIG).amin(1)
    hi = _tiled(frame.cid, -_BIG).amax(1)
    return torch.stack([lo, hi], 1)


def fresh_spans(stale: torch.Tensor, pos_s: torch.Tensor, r: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile fresh cell spans i32[T, 2] and the drift count i32[].

    The fresh cells trunc(pos·(R−1)) are clipped to [0, R−1] here; the gate
    uses them unclipped. A span is clamped to the stale span ± one cell
    plane (R² + R + 1); each row outside that band counts once."""
    s_cells = r * r * r
    cell = sph_math.cell_index(pos_s, r).clamp(0, r - 1)
    fcid = cell[:, 0] + cell[:, 1] * r + cell[:, 2] * (r * r)
    ft = _tiled(fcid, _BIG)
    live = _tiled(torch.ones_like(fcid, dtype=torch.bool), False)
    m_allow = r * r + r + 1
    lo_allow = stale[:, 0:1] - m_allow
    hi_allow = stale[:, 1:2] + m_allow
    out_of_band = ((ft < lo_allow) | (ft > hi_allow)) & live
    drift = out_of_band.sum(dtype=torch.int32)
    lo = ft.amin(1, keepdim=True)
    hi = _tiled(fcid, -_BIG).amax(1, keepdim=True)
    lo = torch.minimum(torch.maximum(lo, lo_allow), hi_allow)
    hi = torch.minimum(torch.maximum(hi, lo_allow), hi_allow)
    spans = torch.cat([lo, hi], 1).clamp(0, s_cells - 1)
    return spans, drift


def tile_segments(spans: torch.Tensor, start: torch.Tensor, r: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The nine disjoint line segments of each tile, (a, b) i32[T, 9]:
    sorted ranges [a, b) in (dz, dy) order, dz outer."""
    s_cells = r * r * r
    offs = torch.tensor([dz * r * r + dy * r for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1)], dtype=torch.int32,
                        device=spans.device)
    qa = (spans[:, 0:1] + offs - 1).clamp(0, s_cells)
    qb = (spans[:, 1:2] + offs + 2).clamp(0, s_cells)
    a, b = start[qa.long()], start[qb.long()]
    # offsets increase strictly with (dz, dy), so one running bound makes
    # the segments disjoint and keeps their union
    prev = torch.zeros_like(a[:, 0])
    for k in range(N_LINES):
        a[:, k] = torch.maximum(a[:, k], prev)
        b[:, k] = torch.maximum(b[:, k], a[:, k])
        prev = b[:, k]
    return a, b


# ------------------------------------------------------ plain versions --

def _tile_candidates(frame: SortedFrame, spans: torch.Tensor,
                     pos_s: torch.Tensor, r: int):
    """Yields (ids i64[m], j i64[m, W], member bool[m, W]) over chunks of
    rows: each row's candidates are the occupied slots of its tile's
    segments in sorted order (the gate drops every other slot, and wall
    piles make a segment hold thousands of them), padded to W, the power
    of two at or above the tile's count, so a row's tree sum does not
    depend on the chunking."""
    n = pos_s.shape[0]
    dev = pos_s.device
    a, b = tile_segments(spans, frame.start, r)
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
                 fresh: bool) -> tuple[int, int]:
    """(member pairs, self pairs) of K5's tile candidates at these
    positions, over the stale spans (density) or the fresh ones (``fresh``,
    the force modes); as ``sph_kernels.member_pairs``. Waits for the
    card."""
    spans = stale_spans(frame)
    if fresh:
        spans, _ = fresh_spans(spans, pos_s, r)
    total = own = 0
    for ids, j, member in _tile_candidates(frame, spans, pos_s, r):
        total += int(member.sum())
        own += int((member & (j == ids[:, None])).sum())
    return total, own


def density_compact_plain(frame: SortedFrame, pos_s: torch.Tensor,
                          phys: PhysParams, r: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ρ, cert) per sorted particle over the tiles' stale segments, self
    included (Density.compute:32-60); the certificate is 0."""
    n = pos_s.shape[0]
    w_sum = torch.empty(n, dtype=pos_s.dtype, device=pos_s.device)
    spans = stale_spans(frame)
    for ids, j, member in _tile_candidates(frame, spans, pos_s, r):
        w_sum[ids] = density_sums_plain(pos_s, phys, ids, j, member)
    return phys.mass * w_sum, torch.zeros((), dtype=torch.int32,
                                          device=pos_s.device)


def compact_sums_plain(frame: SortedFrame, rows: torch.Tensor,
                       phys: PhysParams, r: int, capacity: int | None = None,
                       ext: bool = False,
                       magnitude: bool = False) -> torch.Tensor:
    """K5's raw force-side pair sums f[N, 12], the layout of
    ``sph_kernels.forces_plain``, over the tiles' fresh segments.
    ``capacity`` is not used: the segments are not cut, and ``frame.occ``
    already drops the slots past it. It keeps ``forces_plain``'s signature
    for the accuracy rules (``sums_fn``)."""
    del capacity
    n = rows.shape[0]
    pos_s = rows[:, 0:3]
    spans, _ = fresh_spans(stale_spans(frame), pos_s, r)
    out = rows.new_zeros((n, N_SUMS))
    for ids, j, member in _tile_candidates(frame, spans, pos_s, r):
        sums = force_sums_plain(rows, phys, ids, j, member, ext, magnitude)
        out[ids, :sums.shape[1]] = sums
    return out


def _drift(frame: SortedFrame, pos_s: torch.Tensor, r: int) -> torch.Tensor:
    return fresh_spans(stale_spans(frame), pos_s, r)[1]


def compact_substep_plain(frame: SortedFrame, rows: torch.Tensor,
                          phys: PhysParams, r: int, xsph: float = 0.0,
                          alpha_visc: float = 0.0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows', cert): one whole substep on K5's candidates, folded and
    integrated as K2's plain version does."""
    out = fused_substep_plain(frame, rows, phys, r, None, xsph, alpha_visc,
                              compact_sums_plain)
    return out, _drift(frame, rows[:, 0:3], r)


def forces_compact_plain(frame: SortedFrame, rows: torch.Tensor,
                         phys: PhysParams, r: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(raw sums f[N, 12], cert) without extensions on K5's candidates."""
    return compact_sums_plain(frame, rows, phys, r), \
        _drift(frame, rows[:, 0:3], r)


# ---------------------------------------------------------- CUDA route --

def _launch(mode: int, ext: bool, inp: torch.Tensor, frame: SortedFrame,
            scal: torch.Tensor, out: torch.Tensor, r: int) -> torch.Tensor:
    """Launches the K5 instance ``mode``; returns the drift count i32[]
    (accumulated by the kernel for the force modes, 0 for density)."""
    n = inp.shape[0]
    dev = inp.device
    _check("frame.cid", frame.cid, torch.int32, (n,), dev)
    _check("frame.start", frame.start, torch.int32, (r * r * r + 1,), dev)
    _check("frame.raw", frame.raw, torch.int32, (n,), dev)
    _check("frame.occ", frame.occ, torch.bool, (n,), dev)
    _check("phys", scal, torch.float32, (N_SCAL,), dev)
    cert = torch.zeros((), dtype=torch.int32, device=dev)
    err = cuda_build.load().sph_compact(
        mode, int(ext), _ptr(inp), _ptr(frame.cid), _ptr(frame.start),
        _ptr(frame.raw), _ptr(frame.occ), _ptr(scal), _ptr(out), _ptr(cert),
        n, r, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on_error("compact", err)
    return cert


def density_compact_cuda(frame: SortedFrame, pos_s: torch.Tensor,
                         phys: PhysParams, r: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 density (``csrc/compact.cu``) on the card."""
    n = pos_s.shape[0]
    _check("pos_s", pos_s, torch.float32, (n, 3), pos_s.device)
    rho = torch.empty(n, dtype=torch.float32, device=pos_s.device)
    cert = _launch(_DENSITY, False, pos_s, frame, scal_block(phys), rho, r)
    launch_counts["compact_density"] += 1
    return rho, cert


def compact_substep_cuda(frame: SortedFrame, rows: torch.Tensor,
                         phys: PhysParams, r: int, xsph: float = 0.0,
                         alpha_visc: float = 0.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 fused substep on the card; nonzero coefficients select the
    instance with the extension sums."""
    n = rows.shape[0]
    _check("rows", rows, torch.float32, (n, N_FIELDS), rows.device)
    ext = uses_extensions(xsph, alpha_visc)
    out = torch.empty_like(rows)
    cert = _launch(_FUSED, ext, rows, frame,
                   scal_block(phys, xsph, alpha_visc), out, r)
    launch_counts["compact_substep_ext" if ext else "compact_substep"] += 1
    return out, cert


def forces_compact_cuda(frame: SortedFrame, rows: torch.Tensor,
                        phys: PhysParams, r: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 forces without extensions on the card: (raw sums f32[N, 12] in
    K3's layout, cert)."""
    n = rows.shape[0]
    _check("rows", rows, torch.float32, (n, N_FIELDS), rows.device)
    sums = torch.empty((n, N_SUMS), dtype=torch.float32, device=rows.device)
    cert = _launch(_FORCES, False, rows, frame, scal_block(phys), sums, r)
    launch_counts["compact_forces"] += 1
    return sums, cert


# ------------------------------------------------------------- routing --

def density_compact(frame: SortedFrame, pos_s: torch.Tensor,
                    phys: PhysParams, r: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ρ, cert) per sorted particle: K5 for a CUDA tensor, the plain
    version for a CPU one. The certificate is 0."""
    if pos_s.is_cuda:
        return density_compact_cuda(frame, pos_s, phys, r)
    return density_compact_plain(frame, pos_s, phys, r)


def compact_substep(frame: SortedFrame, rows: torch.Tensor,
                    phys: PhysParams, r: int, xsph: float = 0.0,
                    alpha_visc: float = 0.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows', drift count): one whole substep over the rows state, K5 for
    a CUDA tensor, the plain version for a CPU one."""
    if rows.is_cuda:
        return compact_substep_cuda(frame, rows, phys, r, xsph, alpha_visc)
    return compact_substep_plain(frame, rows, phys, r, xsph, alpha_visc)


def forces_compact(frame: SortedFrame, rows: torch.Tensor, phys: PhysParams,
                   r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(force f[N, 3], drift count) without extensions: the raw sums from
    K5 for a CUDA tensor or from the plain version for a CPU one, then
    ``fold_forces``. With extensions the stepper takes K3, as JAX's
    ``forces_pallas`` does (pallas_sph.py:1720)."""
    if rows.is_cuda:
        sums, cert = forces_compact_cuda(frame, rows, phys, r)
    else:
        sums, cert = forces_compact_plain(frame, rows, phys, r)
    return fold_forces(sums, rows[:, 6], phys)[0], cert
