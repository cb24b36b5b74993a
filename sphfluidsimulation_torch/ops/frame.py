"""Per-frame sorted neighbour structure.

Counterpart of the sort half of ``sphfluidsimulation_tpu/ops/pallas_sph.py::
build_frame`` (:459-528); the run starts of ``ops/grid.py::run_starts`` come
from the start table. The fields are the JAX ``SortedFrame``'s ``order``,
``cid``, ``raw``, ``occ`` and ``start``, value for value; the TPU-only
fields (DMA window bases, chunk worklists, tile spans, the clip
certificate) have no counterpart here, because the CUDA kernels walk
``start[]`` per cell.

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
    start: i32[R³+1] first sorted index of each anchor cell; start[R³] = N
    """

    order: torch.Tensor
    cid: torch.Tensor
    raw: torch.Tensor
    occ: torch.Tensor
    start: torch.Tensor


def build_frame(pos: torch.Tensor, r: int, capacity: int | None,
                extras: tuple[torch.Tensor, ...] = (),
                gid: torch.Tensor | None = None
                ) -> tuple[SortedFrame, tuple[torch.Tensor, ...]]:
    """Sort by anchor cell and derive ranks, occupancy and the start table.

    ``extras`` are per-particle tensors (first dimension N) returned in sorted
    order. ``gid`` is the original particle id of each input row (a
    permutation of 0..N−1; default the identity): it is the sort's tie-break,
    so capacity ranks stay keyed to original ids whatever order the caller
    holds its state in, and ``frame.order`` is the sorted ``gid``.
    ``capacity=None`` disables the rank drop.
    """
    n = pos.shape[0]
    dev = pos.device
    cell = sph_math.cell_index(pos, r)
    # int32 arithmetic wraps exactly as the JAX version's does
    cid_raw = cell[:, 0] + cell[:, 1] * r + cell[:, 2] * (r * r)
    in_range = (cid_raw >= 0) & (cid_raw < r * r * r)
    anchor = cell.clamp(0, r - 1)
    cid_key = anchor[:, 0] + anchor[:, 1] * r + anchor[:, 2] * (r * r)
    if gid is None:
        gid = torch.arange(n, dtype=torch.int32, device=dev)

    # (anchor, gid) is unique, so the sort needs no stability
    key = cid_key.to(torch.int64) * n + gid.to(torch.int64)
    perm = torch.sort(key).indices
    order = gid[perm].to(torch.int32)
    cid_s = cid_key[perm]
    raw_s = cid_raw[perm]

    cells = torch.arange(r * r * r + 1, dtype=torch.int32, device=dev)
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
                        start=start)
    return frame, tuple(e[perm] for e in extras)
