"""Optional SPH stabilisation terms: XSPH and Monaghan artificial viscosity,
as all-pairs oracles.

Counterpart of the oracles of ``sphfluidsimulation_tpu/ops/extensions.py``
(``xsph_bruteforce``, ``artificial_viscosity_bruteforce``, :123-152). The
reference has neither term (BASELINE config 3 asks for them):

* XSPH (Monaghan 1989), applied to the position update only:
      dvᵢ = ε Σⱼ (2m / (ρᵢ + ρⱼ)) W_poly6(rᵢⱼ) (vⱼ − vᵢ)
* artificial viscosity (Monaghan 1992), for approaching pairs (v·r < 0):
      Πᵢⱼ = −α c h (v·r) / (|r|² + 0.01 h²) / ρ̄,   fᵢ += m² Πᵢⱼ ∇W_press(rᵢⱼ)
  with sound speed c = √k.

The pair mask is the caller's (``sim.stepper``: the brute window, which
keeps the self pair, as the JAX oracle does). On the sorted tier the same
sums run inside the force kernels (``ops/sph_kernels.py``). The JAX slotted
forms (:38-120) read the packed slot layout of ``ops/cellops.py``, which is
not ported yet (ROADMAP.md queue A item 8); they come with it.
"""

from __future__ import annotations

import torch

from ..config import EPSILON
from ..params import PhysParams
from . import sph_math


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
