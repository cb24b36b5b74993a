"""Brute-force O(N²) density and force passes — the behavioural oracle.

Counterpart of ``sphfluidsimulation_tpu/ops/brute.py``, formula for formula.
The machine with the card has no JAX, so this is the oracle the port holds
its sorted tier to there (``chip_smoke.py``); on the CPU the tests hold it to
the JAX oracle. It reproduces the reference's semantics exactly:

* the 27-cell candidate window: a pair (i, j) is considered iff j's
  frame-start ("stale") voxel lies in the 3×3×3 window around i's *current*
  voxel (Density.compute:42-52, VelPos.compute:67-81);
* self-interaction included in density (Density.compute:50-55) but excluded
  from forces (VelPos.compute:82);
* the per-voxel capacity drop, through ``bucket_mask`` (Bucket.compute:30-35);
* the ρⱼ > ε guard inside the pair loop and the ρᵢ > ε guard on the final
  scaling (VelPos.compute:91-105).

Every pass builds [N, N] pair tensors: it is meant for a few thousand
particles.
"""

from __future__ import annotations

import torch

from ..config import EPSILON
from ..params import PhysParams
from . import sph_math


def _decompose_cell(cell_id: torch.Tensor, r: int) -> torch.Tensor:
    """Invert the flat index x + y·R + z·R² (Bucket.compute:28).

    The reference stores particles by FLAT id with no 3D bounds check on
    insertion, so an out-of-range component aliases into a neighbouring cell
    (x = R wraps to (0, y+1, z)); the oracle compares against the
    decomposed flat id, not the raw 3D cell.
    """
    x = cell_id % r
    y = torch.div(cell_id, r, rounding_mode="floor") % r
    z = torch.div(cell_id, r * r, rounding_mode="floor")
    return torch.stack([x, y, z], dim=-1)


def window_mask(cell_i: torch.Tensor, cell_id_j: torch.Tensor,
                visible_j: torch.Tensor, r: int) -> torch.Tensor:
    """[N_i, N_j] bool — j's bucket cell lies in the 3×3×3 window around i's
    (possibly out-of-range) cell, and j is in the bucket. Window cells
    outside [0, R)³ are dropped by the reference's bounds check
    (Density.compute:46); decomposed j cells are always in range, so plain
    Chebyshev distance on the decomposed cell realises exactly that."""
    cell_j = _decompose_cell(cell_id_j.clamp(0, r * r * r - 1), r)
    d = cell_i[:, None, :] - cell_j[None, :, :]
    return (d.abs().amax(dim=-1) <= 1) & visible_j[None, :]


def density_bruteforce(pos: torch.Tensor, stale_cell_id: torch.Tensor,
                       bucket_mask: torch.Tensor, p: PhysParams,
                       bucket_resolution: int) -> torch.Tensor:
    """ρᵢ = Σⱼ m·W_poly6(posᵢ − posⱼ) over bucket-visible window pairs
    (Density.compute:32-60, self term included). ``stale_cell_id`` is the
    FLAT frame-start cell id per particle."""
    h2 = p.h * p.h
    h9 = p.h ** 9
    cell_i = sph_math.cell_index(pos, bucket_resolution)
    mask = window_mask(cell_i, stale_cell_id, bucket_mask, bucket_resolution)
    diff = pos[:, None, :] - pos[None, :, :]
    r2 = (diff * diff).sum(-1)
    w = sph_math.w_poly6(r2, h2, h9)
    return torch.where(mask, p.mass * w, 0.0).sum(-1)


def fluid_forces_bruteforce(pos: torch.Tensor, vel: torch.Tensor,
                            rho: torch.Tensor, stale_cell_id: torch.Tensor,
                            bucket_mask: torch.Tensor, p: PhysParams,
                            bucket_resolution: int) -> torch.Tensor:
    """Pressure + viscosity forces, all pairs (VelPos.compute:64-105).

    ``rho`` is the frame-start (stale) density; ``pos``/``vel`` are fresh.
    Returns f32[N, 3] = f_press + f_vis after the m²/ρᵢ scaling.
    """
    n = pos.shape[0]
    h6 = p.h ** 6
    cell_i = sph_math.cell_index(pos, bucket_resolution)
    pair_ok = window_mask(cell_i, stale_cell_id, bucket_mask,
                          bucket_resolution)
    pair_ok = pair_ok & ~torch.eye(n, dtype=torch.bool, device=pos.device)

    pressure = sph_math.eos_pressure(rho, p.gas_constant, p.rest_density)
    rho_ok = rho > EPSILON                              # per-j guard (:91)
    safe_rho = torch.where(rho_ok, rho, 1.0)

    diff = pos[:, None, :] - pos[None, :, :]            # pos_i − pos_j
    gwp = sph_math.grad_w_press(diff, p.h, h6)          # [N, N, 3]
    gwv = sph_math.grad_w_vis(diff, p.h, h6)            # [N, N]

    m = (pair_ok & rho_ok[None, :])[..., None]
    press_coef = (pressure[:, None] + pressure[None, :]) \
        / (2.0 * safe_rho[None, :])
    f_press = torch.where(m, press_coef[..., None] * gwp, 0.0).sum(1)

    dvel = vel[None, :, :] - vel[:, None, :]            # v_j − v_i
    vis_coef = gwv / safe_rho[None, :]
    f_vis = torch.where(m, vis_coef[..., None] * dvel, 0.0).sum(1)

    # final scaling, guarded by ρᵢ > ε (VelPos.compute:101-105): when the
    # guard fails the raw sums pass through unscaled, as in the reference
    i_ok = (rho > EPSILON)[:, None]
    s_i = safe_rho[:, None]
    f_press = torch.where(i_ok, f_press * (p.mass * p.mass / s_i), f_press)
    f_vis = torch.where(i_ok, f_vis * (p.viscosity * p.mass * p.mass / s_i),
                        f_vis)
    return f_press + f_vis
