"""The exact tiers: grid-gathered ("gather") and packed-slot ("slotted")
density and force passes over the voxel table.

Counterpart of ``sphfluidsimulation_tpu/ops/cellops.py``. Both tiers walk the
reference's per-thread 27-voxel × C-slot window (Density.compute:42-57,
VelPos.compute:67-98) as a loop over the 27 cell offsets in the reference's
order (``grid.neighborhood_offsets``), each offset gathering one voxel's C
candidate slots for every row; the JAX package folds over the same offsets
with ``lax.scan``, so the per-offset partial sums come in the same order.
Out-of-range cells and empty slots are gated out by a select, reproducing
the reference's bounds check (Density.compute:46) and sentinel break (:52).
The sum over a voxel's C slots is ``sph_kernels._tree_sum``: elementwise
adds in a fixed order, so a frame is bit-reproducible on its device.

The gather tier gathers each candidate's position, velocity and density per
(row, offset, slot). The slotted tier packs them once a frame (positions and
velocities again each substep) into cell-major rows of 4C lanes:

    posocc[c] = [ x·C | y·C | z·C | occ·C ]
    velrho[c] = [ vx·C | vy·C | vz·C | ρ·C ]

so a window cell is one row gather per array. The occupancy lane holds the
slot's particle id + 1 (0 for an empty slot; exact in f32 for ids < 2²⁴),
which is both the occupancy gate (> 0) and the reference's j == i skip
(VelPos.compute:82: the lane equal to the row's id + 1 is dropped). The skip
matters beyond speed: a particle with ±inf velocity would otherwise evaluate
its own inf − inf = NaN self pair, which the reference never does.

The ``*_rows`` forms compute a block of rows against the full candidate
arrays. No hand-written kernel runs here: these are plain PyTorch ops on the
device of their inputs, the correctness tier that the JAX tests hold every
other tier to.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EPSILON
from ..params import PhysParams
from . import sph_math
from .grid import Bucket, flat_cell_id, neighborhood_offsets
from .sph_kernels import _tree_sum


def _window_cells(cell_rows: torch.Tensor, off: torch.Tensor, r: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat cell id, 0 where out of range; validity) of the window cell at
    ``off`` of each row."""
    ncell = cell_rows + off
    valid = ((ncell >= 0) & (ncell < r)).all(-1)
    ncid = torch.where(valid, flat_cell_id(ncell, r), 0)
    return ncid, valid


def _offset_candidates(table: torch.Tensor, cell_rows: torch.Tensor,
                       off: torch.Tensor, r: int, capacity: int,
                       n: int) -> torch.Tensor:
    """Candidate particle ids in voxel (cell_rows + off), i32[rows, C], with
    the sentinel n for an empty slot or an out-of-range cell (the bounds
    check of Density.compute:46)."""
    ncid, valid = _window_cells(cell_rows, off, r)
    slots = ncid[:, None] * capacity + torch.arange(
        capacity, dtype=torch.int32, device=ncid.device)
    return torch.where(valid[:, None], table[slots.long()], n)


def _r2(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor
        ) -> torch.Tensor:
    return dx * dx + dy * dy + dz * dz


def density_grid_rows(pos_rows: torch.Tensor, cell_rows: torch.Tensor,
                      pos_all: torch.Tensor, table: torch.Tensor,
                      capacity: int, p: PhysParams,
                      bucket_resolution: int) -> torch.Tensor:
    """ρ for a row block through the voxel table (Density.compute:32-60;
    the self term is included: no j == i skip)."""
    n = pos_all.shape[0]
    h2, h9 = p.h * p.h, p.h ** 9
    offs = neighborhood_offsets(pos_rows.device)
    rho = torch.zeros(pos_rows.shape[0], dtype=torch.float32,
                      device=pos_rows.device)
    for k in range(offs.shape[0]):
        cand = _offset_candidates(table, cell_rows, offs[k],
                                  bucket_resolution, capacity, n)
        pj = pos_all[cand.clamp(max=n - 1).long()]            # [rows, C, 3]
        d = pos_rows[:, None, :] - pj
        w = sph_math.w_poly6(_r2(d[..., 0], d[..., 1], d[..., 2]), h2, h9)
        rho = rho + _tree_sum(torch.where(cand < n, p.mass * w, 0.0))
    return rho


def fluid_forces_grid_rows(pos_rows: torch.Tensor, vel_rows: torch.Tensor,
                           ids_rows: torch.Tensor, rho_rows: torch.Tensor,
                           pos_all: torch.Tensor, vel_all: torch.Tensor,
                           rho_all: torch.Tensor, table: torch.Tensor,
                           capacity: int, p: PhysParams,
                           bucket_resolution: int) -> torch.Tensor:
    """Pressure + viscosity for a row block (VelPos.compute:49-105).

    ``pos``/``vel`` are fresh (this substep's); ``rho`` and the table are
    the frame start's. The window is centred on each row's FRESH cell
    (VelPos.compute:57-58 recomputes idx_3d every substep). ``ids_rows``
    are the rows' global particle ids, for the j == i skip (VelPos:82)."""
    n = pos_all.shape[0]
    h6 = p.h ** 6
    cell_fresh = sph_math.cell_index(pos_rows, bucket_resolution)
    press_rows = sph_math.eos_pressure(rho_rows, p.gas_constant,
                                       p.rest_density)
    press_all = sph_math.eos_pressure(rho_all, p.gas_constant,
                                      p.rest_density)
    offs = neighborhood_offsets(pos_rows.device)
    f_press = torch.zeros_like(pos_rows)
    f_vis = torch.zeros_like(pos_rows)
    for k in range(offs.shape[0]):
        cand = _offset_candidates(table, cell_fresh, offs[k],
                                  bucket_resolution, capacity, n)
        j = cand.clamp(max=n - 1).long()
        rho_j = rho_all[j]
        ok = ((cand < n) & (cand != ids_rows[:, None])      # VelPos:82
              & (rho_j > EPSILON))[..., None]               # VelPos:91
        safe_rho = torch.where(rho_j > EPSILON, rho_j, 1.0)
        diff = pos_rows[:, None, :] - pos_all[j]
        gwp = sph_math.grad_w_press(diff, p.h, h6)
        gwv = sph_math.grad_w_vis(diff, p.h, h6)
        press_coef = (press_rows[:, None] + press_all[j]) / (2.0 * safe_rho)
        f_press = f_press + _tree_sum(
            torch.where(ok, press_coef[..., None] * gwp, 0.0))
        dvel = vel_all[j] - vel_rows[:, None, :]
        f_vis = f_vis + _tree_sum(
            torch.where(ok, (gwv / safe_rho)[..., None] * dvel, 0.0))
    return _scale_forces(f_press, f_vis, rho_rows, p)


def _scale_forces(f_press: torch.Tensor, f_vis: torch.Tensor,
                  rho_rows: torch.Tensor, p: PhysParams) -> torch.Tensor:
    """The final m²/ρᵢ scaling, guarded by ρᵢ > ε (VelPos.compute:101-105):
    where the guard fails the raw sums pass through unscaled."""
    i_ok = (rho_rows > EPSILON)[:, None]
    safe_rho_i = torch.where(rho_rows > EPSILON, rho_rows, 1.0)[:, None]
    f_press = torch.where(i_ok, f_press * (p.mass * p.mass / safe_rho_i),
                          f_press)
    f_vis = torch.where(i_ok, f_vis * (p.viscosity * p.mass * p.mass
                                       / safe_rho_i), f_vis)
    return f_press + f_vis


def density_grid(pos: torch.Tensor, bucket: Bucket, capacity: int,
                 p: PhysParams, bucket_resolution: int) -> torch.Tensor:
    """Full-array form of :func:`density_grid_rows`."""
    return density_grid_rows(pos, bucket.cell, pos, bucket.table, capacity,
                             p, bucket_resolution)


def fluid_forces_grid(pos: torch.Tensor, vel: torch.Tensor,
                      rho: torch.Tensor, bucket: Bucket, capacity: int,
                      p: PhysParams, bucket_resolution: int) -> torch.Tensor:
    """Full-array form of :func:`fluid_forces_grid_rows`."""
    ids = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    return fluid_forces_grid_rows(pos, vel, ids, rho, pos, vel, rho,
                                  bucket.table, capacity, p,
                                  bucket_resolution)


class PackedSlots(NamedTuple):
    """A frame's packed slot rows.

    posocc: f32[R³, 4C], positions and the occupancy lane (id + 1, 0 for an
            empty slot); repacked every substep from fresh positions over
            the frame-start table (VelPos reads fresh textures through
            stale ids).
    velrho: f32[R³, 4C], fresh velocities and the frame-start density.
    """

    posocc: torch.Tensor
    velrho: torch.Tensor


def _slot_lanes(x: torch.Tensor, j: torch.Tensor, occ_b: torch.Tensor
                ) -> torch.Tensor:
    """f32[R³, 3C]: the three components of ``x`` at the slots' particles,
    component-major, 0 in an empty slot. A select, not a product: on an
    exploding scene a particle can hold inf, and 0·inf = NaN would poison
    the EMPTY slots, which the reference never walks (Bucket.compute:30-35).
    """
    lanes = torch.where(occ_b[..., None], x[j], 0.0)       # [R³, C, 3]
    return lanes.permute(0, 2, 1).reshape(lanes.shape[0], -1)


def _slot_ids(table: torch.Tensor, capacity: int, n: int):
    ids = table.reshape(-1, capacity)
    occ_b = ids < n
    occ = torch.where(occ_b, (ids + 1).to(torch.float32), 0.0)
    return ids.clamp(max=n - 1).long(), occ_b, occ


def pack_slots(table: torch.Tensor, capacity: int, n: int, pos: torch.Tensor,
               vel: torch.Tensor | None, rho: torch.Tensor | None
               ) -> PackedSlots:
    """Scatter each particle's values into the packed slot layout (``vel``
    None: the velocity and density lanes are 0)."""
    j, occ_b, occ = _slot_ids(table, capacity, n)
    posocc = torch.cat([_slot_lanes(pos, j, occ_b), occ], -1)
    if vel is None:
        return PackedSlots(posocc=posocc, velrho=torch.zeros_like(posocc))
    rr = torch.where(occ_b, rho[j], 0.0)
    return PackedSlots(posocc=posocc,
                       velrho=torch.cat([_slot_lanes(vel, j, occ_b), rr], -1))


def repack_fresh(slots: PackedSlots, table: torch.Tensor, capacity: int,
                 n: int, pos: torch.Tensor, vel: torch.Tensor
                 ) -> PackedSlots:
    """Refresh the position and velocity lanes for a new substep; keep the
    frame-start density lanes."""
    j, occ_b, occ = _slot_ids(table, capacity, n)
    posocc = torch.cat([_slot_lanes(pos, j, occ_b), occ], -1)
    velrho = torch.cat([_slot_lanes(vel, j, occ_b),
                        slots.velrho[:, 3 * capacity:]], -1)
    return PackedSlots(posocc=posocc, velrho=velrho)


def slot_window(slots: PackedSlots, cell_rows: torch.Tensor,
                off: torch.Tensor, r: int, capacity: int, velocities: bool):
    """The window cell at ``off`` of each row, as per-slot lanes
    f32[rows, C]: (x, y, z, occ, vx, vy, vz, ρ) (the last four only with
    ``velocities``), and the cell's validity bool[rows]."""
    ncid, valid = _window_cells(cell_rows, off, r)
    ncid = ncid.long()
    lanes = slots.posocc[ncid].split(capacity, -1)
    if velocities:
        lanes += slots.velrho[ncid].split(capacity, -1)
    return lanes, valid


def density_slotted_rows(pos_rows: torch.Tensor, cell_rows: torch.Tensor,
                         slots: PackedSlots, capacity: int, p: PhysParams,
                         bucket_resolution: int) -> torch.Tensor:
    """ρ for a row block through packed-row gathers (Density.compute:32-60:
    self term included, bounds check per window cell)."""
    h2, h9 = p.h * p.h, p.h ** 9
    offs = neighborhood_offsets(pos_rows.device)
    rho = torch.zeros(pos_rows.shape[0], dtype=torch.float32,
                      device=pos_rows.device)
    for k in range(offs.shape[0]):
        (cx, cy, cz, occ), valid = slot_window(
            slots, cell_rows, offs[k], bucket_resolution, capacity, False)
        w = sph_math.w_poly6(_r2(pos_rows[:, 0:1] - cx,
                                 pos_rows[:, 1:2] - cy,
                                 pos_rows[:, 2:3] - cz), h2, h9)
        gate = (occ > 0.0) & valid[:, None]
        rho = rho + p.mass * _tree_sum(torch.where(gate, w, 0.0))
    return rho


def fluid_forces_slotted_rows(pos_rows: torch.Tensor, vel_rows: torch.Tensor,
                              ids_rows: torch.Tensor, rho_rows: torch.Tensor,
                              slots: PackedSlots, capacity: int,
                              p: PhysParams,
                              bucket_resolution: int) -> torch.Tensor:
    """Pressure + viscosity for a row block through packed-row gathers
    (VelPos.compute:49-105: fresh window centre, frame-start table and ρ,
    the ρ guards, the final m²/ρᵢ scaling). ``ids_rows`` are the rows'
    global particle ids for the j == i skip (VelPos.compute:82)."""
    h6 = p.h ** 6
    cell_fresh = sph_math.cell_index(pos_rows, bucket_resolution)
    press_rows = sph_math.eos_pressure(rho_rows, p.gas_constant,
                                       p.rest_density)[:, None]
    self_occ = (ids_rows.to(torch.float32) + 1.0)[:, None]
    offs = neighborhood_offsets(pos_rows.device)
    acc = torch.zeros(pos_rows.shape[0], 6, dtype=torch.float32,
                      device=pos_rows.device)
    for k in range(offs.shape[0]):
        (cx, cy, cz, occ, vx, vy, vz, rho_j), valid = slot_window(
            slots, cell_fresh, offs[k], bucket_resolution, capacity, True)
        # select-gating, not multiplicative: 0·inf = NaN would leak NaN
        # from empty slots and out-of-range cells, which the reference never
        # evaluates (Bucket.compute:30-35, VelPos:73); occ ≠ idᵢ + 1 is
        # VelPos:82's `if (j == id_1d) continue`
        gate = ((occ > 0.0) & valid[:, None] & (occ != self_occ)
                & (rho_j > EPSILON))                          # VelPos:91
        safe_rho = torch.where(rho_j > EPSILON, rho_j, 1.0)
        dx = pos_rows[:, 0:1] - cx
        dy = pos_rows[:, 1:2] - cy
        dz = pos_rows[:, 2:3] - cz
        abs_r = torch.sqrt(_r2(dx, dy, dz))
        gwp = sph_math.grad_w_press_over_r(abs_r, p.h, h6)
        gwv = sph_math.grad_w_vis_r(abs_r, p.h, h6)
        press_j = sph_math.eos_pressure(rho_j, p.gas_constant,
                                        p.rest_density)
        # whole-term selects: a candidate position can faithfully be NaN
        # (inf velocities pass the acceleration-only NaN trap), so a
        # selected coefficient times a NaN dx would leak NaN again
        pc = (press_rows + press_j) / (2.0 * safe_rho) * gwp
        vc = gwv / safe_rho
        terms = torch.stack([pc * dx, pc * dy, pc * dz,
                             vc * (vx - vel_rows[:, 0:1]),
                             vc * (vy - vel_rows[:, 1:2]),
                             vc * (vz - vel_rows[:, 2:3])], -1)
        acc = acc + _tree_sum(torch.where(gate[..., None], terms, 0.0))
    return _scale_forces(acc[:, 0:3], acc[:, 3:6], rho_rows, p)
