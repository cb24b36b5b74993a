"""Optional SPH stabilisation terms: XSPH and Monaghan artificial viscosity,
over the packed slot layout and as all-pairs oracles.

Counterpart of ``sphfluidsimulation_tpu/ops/extensions.py`` (``xsph_slotted``
:38, ``artificial_viscosity_slotted`` :78 and the oracles
``xsph_bruteforce``, ``artificial_viscosity_bruteforce``, :123-152). The
reference has neither term (BASELINE config 3 asks for them):

* XSPH (Monaghan 1989), applied to the position update only:
      dvᵢ = ε Σⱼ (2m / (ρᵢ + ρⱼ)) W_poly6(rᵢⱼ) (vⱼ − vᵢ)
* artificial viscosity (Monaghan 1992), for approaching pairs (v·r < 0):
      Πᵢⱼ = −α c h (v·r) / (|r|² + 0.01 h²) / ρ̄,   fᵢ += m² Πᵢⱼ ∇W_press(rᵢⱼ)
  with sound speed c = √k.

The slotted forms walk the same 27 window cells as the slotted force pass
(``ops/cellops.py``: fresh window centre, frame-start table and density)
and, as in JAX, keep the self pair, whose terms are 0 for finite values.
The oracles' pair mask is the caller's (``sim.stepper``: the brute window,
which keeps the self pair, as the JAX oracle does). On the sorted tier the
same sums run inside the force kernels (``ops/sph_kernels.py``).
"""

from __future__ import annotations

import torch

from ..config import EPSILON
from ..params import PhysParams
from . import sph_math
from .cellops import PackedSlots, slot_window
from .grid import neighborhood_offsets
from .sph_kernels import _tree_sum


def xsph_slotted(pos: torch.Tensor, vel: torch.Tensor, rho: torch.Tensor,
                 slots: PackedSlots, capacity: int, p: PhysParams, r: int,
                 eps: float) -> torch.Tensor:
    """XSPH velocity correction dv f32[N, 3] over the packed slot layout."""
    h2, h9 = p.h * p.h, p.h ** 9
    cell_fresh = sph_math.cell_index(pos, r)
    offs = neighborhood_offsets(pos.device)
    acc = torch.zeros_like(pos)
    for k in range(offs.shape[0]):
        (cx, cy, cz, occ, vx, vy, vz, rho_j), valid = slot_window(
            slots, cell_fresh, offs[k], r, capacity, True)
        # select-gating, not multiplicative (0·inf = NaN would leak NaN
        # from empty slots and out-of-range cells; see ops/cellops.py)
        gate = (occ > 0.0) & valid[:, None]
        dx = pos[:, 0:1] - cx
        dy = pos[:, 1:2] - cy
        dz = pos[:, 2:3] - cz
        w = sph_math.w_poly6(dx * dx + dy * dy + dz * dz, h2, h9)
        denom = rho[:, None] + rho_j
        coef = torch.where(denom > EPSILON,
                           2.0 * p.mass / denom.clamp(min=EPSILON), 0.0) * w
        terms = torch.stack([coef * (vx - vel[:, 0:1]),
                             coef * (vy - vel[:, 1:2]),
                             coef * (vz - vel[:, 2:3])], -1)
        acc = acc + _tree_sum(torch.where(gate[..., None], terms, 0.0))
    return eps * acc


def artificial_viscosity_slotted(pos: torch.Tensor, vel: torch.Tensor,
                                 rho: torch.Tensor, slots: PackedSlots,
                                 capacity: int, p: PhysParams, r: int,
                                 alpha: float) -> torch.Tensor:
    """Monaghan artificial-viscosity force f32[N, 3] over the packed slot
    layout."""
    h6 = p.h ** 6
    cs = torch.sqrt(p.gas_constant)
    cell_fresh = sph_math.cell_index(pos, r)
    offs = neighborhood_offsets(pos.device)
    acc = torch.zeros_like(pos)
    for k in range(offs.shape[0]):
        (cx, cy, cz, occ, vx, vy, vz, rho_j), valid = slot_window(
            slots, cell_fresh, offs[k], r, capacity, True)
        gate = (occ > 0.0) & valid[:, None]
        dx = pos[:, 0:1] - cx
        dy = pos[:, 1:2] - cy
        dz = pos[:, 2:3] - cz
        vr = ((vel[:, 0:1] - vx) * dx + (vel[:, 1:2] - vy) * dy
              + (vel[:, 2:3] - vz) * dz)
        r2 = dx * dx + dy * dy + dz * dz
        rho_bar = 0.5 * (rho[:, None] + rho_j)
        mu = p.h * vr / (r2 + 0.01 * p.h * p.h)
        pi = torch.where((vr < 0) & (rho_bar > EPSILON),
                         -alpha * cs * mu / rho_bar.clamp(min=EPSILON), 0.0)
        gwp = sph_math.grad_w_press_over_r(torch.sqrt(r2), p.h, h6)
        coef = p.mass * p.mass * pi * gwp
        terms = torch.stack([coef * dx, coef * dy, coef * dz], -1)
        acc = acc + _tree_sum(torch.where(gate[..., None], terms, 0.0))
    return acc


def xsph_bruteforce(pos: torch.Tensor, vel: torch.Tensor, rho: torch.Tensor,
                    pair_mask: torch.Tensor, p: PhysParams,
                    eps: float) -> torch.Tensor:
    """XSPH velocity correction dv f32[N, 3] over the masked pairs."""
    h2, h9 = p.h * p.h, p.h ** 9
    diff = pos[:, None, :] - pos[None, :, :]
    w = sph_math.w_poly6((diff * diff).sum(-1), h2, h9)
    denom = rho[:, None] + rho[None, :]
    coef = torch.where(pair_mask & (denom > EPSILON),
                       2.0 * p.mass / denom.clamp(min=EPSILON) * w, 0.0)
    dvel = vel[None, :, :] - vel[:, None, :]
    return eps * (coef[..., None] * dvel).sum(1)


def artificial_viscosity_bruteforce(pos: torch.Tensor, vel: torch.Tensor,
                                    rho: torch.Tensor,
                                    pair_mask: torch.Tensor, p: PhysParams,
                                    alpha: float) -> torch.Tensor:
    """Monaghan artificial-viscosity force f32[N, 3] over the masked pairs."""
    h6 = p.h ** 6
    cs = torch.sqrt(p.gas_constant)
    diff = pos[:, None, :] - pos[None, :, :]
    dvel = vel[:, None, :] - vel[None, :, :]
    vr = (dvel * diff).sum(-1)
    r2 = (diff * diff).sum(-1)
    rho_bar = 0.5 * (rho[:, None] + rho[None, :])
    mu = p.h * vr / (r2 + 0.01 * p.h * p.h)
    pi = torch.where((vr < 0) & (rho_bar > EPSILON) & pair_mask,
                     -alpha * cs * mu / rho_bar.clamp(min=EPSILON), 0.0)
    gwp = sph_math.grad_w_press_over_r(torch.sqrt(r2), p.h, h6)
    coef = p.mass * p.mass * pi * gwp
    return (coef[..., None] * diff).sum(1)
