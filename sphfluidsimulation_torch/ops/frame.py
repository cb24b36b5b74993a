"""Per-frame sorted neighbour structure.

Counterpart of the sort half of ``sphfluidsimulation_tpu/ops/pallas_sph.py::
build_frame`` (:429-528); the run starts of ``ops/grid.py::run_starts`` come
from the start table. The fields are the JAX ``SortedFrame``'s ``order``,
``cid``, ``raw``, ``occ`` and ``start``, value for value, and the band part
of its ``clip_count``; the TPU-only fields (DMA window bases, chunk
worklists, tile spans) have no counterpart here, because the CUDA kernels
walk ``start[]`` per cell.

Slab mode (``parallel/slab_pallas.py``): ``band=(zbase, z_span)`` restricts
the cell-id space to the ``z_span`` z-planes from plane ``zbase`` on, so a
local anchor id is x + y·R + (clip(z − zbase, 0, z_span − 1))·R² and the
start table has z_span·R² + 1 entries; ``raw`` stays the GLOBAL raw id, so
the kernels' membership gate is unchanged. ``valid`` marks the live rows of a
row buffer: dead rows take the sentinel id z_span·R² (they sort past every
live cell, in local row order) and are never occupied. Live rows whose stale
anchor lies outside the band are clamped in and counted in ``clip_count``.

Semantics (Bucket.compute:18-36): particles sort by their ANCHOR cell (the
flat id of the clamped 3D cell), ties broken by the original particle id;
each particle's capacity rank is its index within its anchor run; a particle
is in the reference bucket (``occ``) iff its RAW flat id x + y·R + z·R² is
in range and, under a capacity, its rank is below it. For in-cube positions
(every position after the first clamp) raw == anchor; out-of-cube spawns
alias to a raw cell at least R−4 cells from their position, so their pair
terms are exactly zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sph_math


class SortedFrame(NamedTuple):
    """Per-frame sorted structure (all tensors in sorted order but ``start``).

    order: i32[N]   original particle id of each sorted slot
    cid:   i32[N]   anchor flat cell id (the sort key)
    raw:   i32[N]   reference raw flat id (may alias or be out of range)
    occ:   bool[N]  in the reference bucket (raw in range, rank < capacity)
    start: i32[S+1] first sorted index of each anchor cell, S = R³ (or
                    z_span·R² in a band); start[S] is the live row count
    clip_count: i32[] live rows whose stale anchor lay outside the band
                    (clamped in); 0 without a band
    """

    order: torch.Tensor
    cid: torch.Tensor
    raw: torch.Tensor
    occ: torch.Tensor
    start: torch.Tensor
    clip_count: torch.Tensor


def build_frame(pos: torch.Tensor, r: int, capacity: int | None,
                extras: tuple[torch.Tensor, ...] = (),
                gid: torch.Tensor | None = None, *,
                n_ids: int | None = None,
                band: tuple[int, int] | None = None,
                valid: torch.Tensor | None = None
                ) -> tuple[SortedFrame, tuple[torch.Tensor, ...]]:
    """Sort by anchor cell and derive ranks, occupancy and the start table.

    ``extras`` are per-particle tensors (first dimension N) returned in sorted
    order. ``gid`` is the original particle id of each input row (default
    the identity), unique among the live rows: it is the sort's tie-break,
    so capacity ranks stay keyed to original ids whatever order the caller
    holds its state in, and ``frame.order`` is the sorted ``gid``.
    ``n_ids`` bounds the ids (every live gid < n_ids); None takes
    ``gid.max() + 1``, which waits for the card, so callers on the frame
    loop pass it. ``capacity=None`` disables the rank drop. ``band`` (a
    Python ``(zbase, z_span)``) and ``valid`` are the slab mode of the
    module docstring.
    """
    n = pos.shape[0]
    dev = pos.device
    cell = sph_math.cell_index(pos, r)
    # int32 arithmetic wraps exactly as the JAX version's does
    cid_raw = cell[:, 0] + cell[:, 1] * r + cell[:, 2] * (r * r)
    in_range = (cid_raw >= 0) & (cid_raw < r * r * r)
    anchor = cell.clamp(0, r - 1)
    if band is None:
        s_cells = r * r * r
        lz = anchor[:, 2]
        clip_count = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        zbase, z_span = band
        s_cells = z_span * r * r
        lz = anchor[:, 2] - zbase
        outside = (lz < 0) | (lz >= z_span)
        if valid is not None:
            outside = outside & valid
        clip_count = outside.sum().to(torch.int32)
        lz = lz.clamp(0, z_span - 1)
    cid_key = anchor[:, 0] + anchor[:, 1] * r + lz * (r * r)
    if gid is None:
        gid = torch.arange(n, dtype=torch.int32, device=dev)
        n_ids = n
    elif n_ids is None:
        n_ids = int(gid.max()) + 1 if n else 1
    key_gid = gid
    if valid is not None:
        in_range = in_range & valid
        # dead rows: the sentinel cell past every live one, one shared id,
        # so the stable sort keeps them in local row order
        cid_key = torch.where(valid, cid_key, s_cells)
        key_gid = torch.where(valid, gid, 0)

    # (anchor, gid) is unique among live rows
    key = cid_key.to(torch.int64) * n_ids + key_gid.to(torch.int64)
    perm = torch.sort(key, stable=True).indices
    order = gid[perm].to(torch.int32)
    cid_s = cid_key[perm]
    raw_s = cid_raw[perm]

    cells = torch.arange(s_cells + 1, dtype=torch.int32, device=dev)
    start = torch.searchsorted(cid_s, cells, out_int32=True)

    # rank within the anchor run; start[cid_s] is the run's first index
    # (the value grid.run_starts computes with a cummax scan, which costs
    # more than the whole sort on the card)
    occ = in_range[perm]
    if capacity is not None:
        rank = torch.arange(n, dtype=torch.int32, device=dev) \
            - start[cid_s.long()]
        occ = occ & (rank < capacity)
    frame = SortedFrame(order=order, cid=cid_s, raw=raw_s, occ=occ,
                        start=start, clip_count=clip_count)
    return frame, tuple(e[perm] for e in extras)
