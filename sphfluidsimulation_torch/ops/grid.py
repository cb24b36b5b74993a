"""Uniform-grid bucket: the reference structure the brute oracle reads.

Counterpart of ``sphfluidsimulation_tpu/ops/grid.py`` (``Bucket``,
``flat_cell_id``, ``run_starts``, ``build_bucket``, ``overflow_count``,
``neighborhood_offsets``), integer for integer. The reference builds a dense
voxel table of ``R³ × 32`` particle-id slots with atomic compare-exchange
insertion (Bucket.compute:18-36); insertion order is a GPU race and overflow
beyond 32 slots per voxel is silently dropped. The rebuild is sort-based and
deterministic: particles rank within their RAW flat cell by a stable sort
(ties broken by particle index), which keeps the reference's capacity and
drop semantics. The sorted tier (``ops/frame.py``) ranks within anchor runs
instead; the two differ only for aliased frame-0 inserts into a full cell.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sph_math


class Bucket(NamedTuple):
    """Sorted uniform-grid structure for one frame.

    table:    i32[R³·C] particle ids, sentinel == n for empty slots
              (empty when the capacity is None).
    cell:     i32[N, 3] frame-start voxel coordinates per particle.
    in_table: bool[N] — False for particles dropped by voxel overflow or out
              of the table's range.
    rank:     i32[N] — deterministic slot index within the particle's voxel.
    order:    i32[N] — particle ids sorted by (cell id, particle id).
    cell_id:  i32[N] flat voxel index per particle (unsorted order).
    """

    table: torch.Tensor
    cell: torch.Tensor
    in_table: torch.Tensor
    rank: torch.Tensor
    order: torch.Tensor
    cell_id: torch.Tensor


def flat_cell_id(cell: torch.Tensor, r: int) -> torch.Tensor:
    """x + y·R + z·R² (Bucket.compute:28), in int32 as the reference."""
    return cell[..., 0] + cell[..., 1] * r + cell[..., 2] * (r * r)


def run_starts(sorted_vals: torch.Tensor) -> torch.Tensor:
    """First index of each equal-value run in an ascending-sorted array."""
    n = sorted_vals.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=sorted_vals.device)
    new = torch.ones(n, dtype=torch.bool, device=sorted_vals.device)
    new[1:] = sorted_vals[1:] != sorted_vals[:-1]
    return torch.cummax(torch.where(new, idx, 0), 0).values


def build_bucket(pos: torch.Tensor, r: int, capacity: int | None
                 ) -> tuple[Bucket, int]:
    """Build the frame's bucket from positions; returns (bucket,
    capacity_used), 0 for ``capacity=None``, which means "no reference-style
    drop": every in-range particle is in the table.

    A particle whose flat cell id falls outside the table is never inserted
    (the reference's out-of-bounds write is dropped); ids that alias INTO
    range (x = R wraps to (0, y+1, z)) are kept, as in the reference.
    """
    n = pos.shape[0]
    dev = pos.device
    cell = sph_math.cell_index(pos, r)
    cid = flat_cell_id(cell, r)
    order = torch.sort(cid, stable=True).indices.to(torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    rank_sorted = idx - run_starts(cid[order.long()])
    rank = torch.empty_like(rank_sorted)
    rank[order.long()] = rank_sorted
    in_range = (cid >= 0) & (cid < r * r * r)

    if capacity is None:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return Bucket(table=empty, cell=cell, in_table=in_range, rank=rank,
                      order=order, cell_id=cid), 0

    in_table = (rank < capacity) & in_range
    n_slots = r * r * r * capacity
    # dropped particles write to one extra slot, cut off afterwards
    slot = torch.where(in_table, cid * capacity + rank, n_slots).long()
    table = torch.full((n_slots + 1,), n, dtype=torch.int32, device=dev)
    table[slot] = idx
    return Bucket(table=table[:n_slots], cell=cell, in_table=in_table,
                  rank=rank, order=order, cell_id=cid), capacity


def overflow_count(bucket: Bucket) -> torch.Tensor:
    """Number of particles silently dropped by voxel capacity (or out of
    range) — a metric instead of the reference's silent drop
    (Bucket.compute:30-35)."""
    return (~bucket.in_table).sum().to(torch.int32)


def neighborhood_offsets(device: torch.device | str | None = None
                         ) -> torch.Tensor:
    """The 27-cell neighbourhood offsets i32[27, 3] in the reference's loop
    order (x outer, y middle, z inner — Density.compute:42-44)."""
    offs = [(dx, dy, dz)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    return torch.tensor(offs, dtype=torch.int32, device=device)
