"""Physics parameters as 0-d float32 tensors.

Counterpart of ``sphfluidsimulation_tpu/params.py`` (``PhysParams``,
``stack_params``). The reference
uploads its physics constants as shader uniforms each dispatch
(SphFluidSimulation.cs:229-265); here they are 0-d float32 tensors on the
simulation device, so the frame loop reads them without a host round trip.

Structural quantities that determine array shapes (particle count, bucket
resolution, voxel capacity, substep count) stay in ``SimConfig``.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from .config import GRAVITY_Y, SimConfig


class PhysParams(NamedTuple):
    """Per-scene physics scalars (all 0-d float32 tensors)."""

    h: torch.Tensor               # smoothing length = 1/(R-1) (cs:159)
    mass: torch.Tensor            # damFillRate / N (cs:176)
    gas_constant: torch.Tensor    # EOS k (VelPos.compute:61)
    rest_density: torch.Tensor    # rho_0
    viscosity: torch.Tensor       # mu
    stiffness: torch.Tensor       # wall spring (VelPos.compute:135)
    damping: torch.Tensor         # wall damping coefficient
    dt: torch.Tensor              # substep timestep = frame_dt/25 (cs:102)
    gravity_y: torch.Tensor       # hardcoded -9.8 in the reference (VelPos:7)

    @classmethod
    def from_config(cls, cfg: SimConfig,
                    device: torch.device | str | None = None) -> "PhysParams":
        # torch.tensor rounds the Python double to float32 exactly as
        # jnp.float32 does
        def f(x: float) -> torch.Tensor:
            return torch.tensor(x, dtype=torch.float32, device=device)

        return cls(
            h=f(cfg.effective_radius),
            mass=f(cfg.particle_mass),
            gas_constant=f(cfg.gas_constant),
            rest_density=f(cfg.rest_density),
            viscosity=f(cfg.viscosity),
            stiffness=f(cfg.stiffness_coefficient),
            damping=f(cfg.damping_coefficient),
            dt=f(cfg.substep_dt),
            gravity_y=f(GRAVITY_Y),
        )

    @classmethod
    def from_numpy(cls, d: Mapping[str, np.ndarray],
                   device: torch.device | str | None = None) -> "PhysParams":
        """Carry parameters across from the JAX package: ``d`` is the JAX
        ``PhysParams._asdict()`` with each value converted to numpy."""
        return cls(**{k: torch.tensor(np.asarray(d[k], np.float32),
                                      device=device)
                      for k in cls._fields})


def stack_params(params: list[PhysParams]) -> PhysParams:
    """Per-scene params stacked along a leading scene axis: each field a
    float32 tensor [S] (JAX ``stack_params``, params.py:53-55)."""
    return PhysParams(*(torch.stack(xs) for xs in zip(*params)))

