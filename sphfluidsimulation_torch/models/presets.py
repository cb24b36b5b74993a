"""Particle spawn presets.

Counterpart of ``sphfluidsimulation_tpu/models/presets.py`` (``preset1``,
``preset2``, ``preset3``, ``init_positions``): the three lattice spawn kernels
of ``Assets/Resources/InitParticles.compute``.

* ``preset1`` (kernel 0, :10-41) — dam against the x-wall.
* ``preset2`` (kernel 1, :43-74) — centered column; the canonical scene
  value ``preset: 1`` selects it (SphFluidSimulation.cs:182-184).
* ``preset3`` (kernel 2, :76-107) — corner column.

Each preset decomposes the particle index into a jittered lattice via
integer division (:28-35) and adds scalar 4D simplex noise
``snoise(pos + i) * particleCubeSize`` to all components (:37, :70, :103).
The lattice sizes are numpy float32 exactly as the JAX version computes
them; lattice math is int32 and the float math float32 in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..ops.noise import snoise4


def _lattice_sizes(n: int, fill: float, squared_fill: bool
                   ) -> tuple[int, int, int, float]:
    """particlePerDim / axis sizes in f32 exactly as the HLSL computes them.

    InitParticles.compute:20-24 (preset1, squared_fill=False) and :53-57
    (presets 2/3, squared_fill=True).
    """
    fill32 = np.float32(fill)
    denom = fill32 * fill32 if squared_fill else fill32
    ppd = np.uint32(np.ceil(np.power(np.float32(n) / denom,
                                     np.float32(1.0 / 3.0),
                                     dtype=np.float32)))
    x_size = np.uint32(np.ceil(np.float32(ppd) * fill32))
    y_size = ppd
    z_size = np.uint32(np.ceil(np.float32(ppd) * fill32)) if squared_fill \
        else ppd
    cube = np.float32(1.0) / np.float32(ppd)
    return int(x_size), int(y_size), int(z_size), float(cube)


def _lattice(n: int, x_size: int, y_size: int, z_size: int, device):
    """Decompose particle index into integer lattice coords
    (InitParticles.compute:31-33)."""
    i = torch.arange(n, dtype=torch.int32, device=device)
    xi = torch.div(i, z_size * y_size, rounding_mode="floor")
    yi = torch.div(i, z_size, rounding_mode="floor") % y_size
    zi = i % z_size
    return i, xi.float(), yi.float(), zi.float()


def _jitter(pos3: torch.Tensor, i: torch.Tensor, cube: float,
            seed: int) -> torch.Tensor:
    """pos += snoise(pos4 + i) * particleCubeSize (InitParticles.compute:37)."""
    fi = i.float() + float(np.float32(seed))
    pos4 = torch.cat([pos3, torch.ones_like(pos3[..., :1])], -1)
    noise = snoise4(pos4 + fi[..., None])
    return pos3 + noise[..., None] * cube


def _f32(x) -> float:
    return float(np.float32(x))


def preset1(n: int, fill: float, seed: int = 0, device=None) -> torch.Tensor:
    """Dam against the x-wall (InitParticles.compute:13-41)."""
    x_size, y_size, z_size, cube = _lattice_sizes(n, fill, squared_fill=False)
    i, xi, yi, zi = _lattice(n, x_size, y_size, z_size, device)
    half = _f32(cube / 2.0)
    fill32 = _f32(fill)
    pos = torch.stack([
        half + xi * fill32 / x_size,
        half + yi * _f32(0.9) / y_size,
        half + zi * 1.0 / z_size,
    ], -1)
    return _jitter(pos, i, cube, seed)


def preset2(n: int, fill: float, seed: int = 0, device=None) -> torch.Tensor:
    """Centered column (InitParticles.compute:46-74) — the canonical scene
    spawn (scene preset field 1 → kernel index 1)."""
    x_size, y_size, z_size, cube = _lattice_sizes(n, fill, squared_fill=True)
    i, xi, yi, zi = _lattice(n, x_size, y_size, z_size, device)
    half = _f32(cube / 2.0)
    fill32 = _f32(fill)
    # (half + offset) is a float32 sum in the JAX version (two numpy
    # scalars), not a double one
    base = _f32(np.float32(half) + np.float32(fill) / np.float32(2.0))
    pos = torch.stack([
        base + xi * fill32 / x_size,
        half + yi * _f32(0.9) / y_size,
        base + zi * fill32 / z_size,
    ], -1)
    return _jitter(pos, i, cube, seed)


def preset3(n: int, fill: float, seed: int = 0, device=None) -> torch.Tensor:
    """Corner column (InitParticles.compute:79-107)."""
    x_size, y_size, z_size, cube = _lattice_sizes(n, fill, squared_fill=True)
    i, xi, yi, zi = _lattice(n, x_size, y_size, z_size, device)
    half = _f32(cube / 2.0)
    fill32 = _f32(fill)
    pos = torch.stack([
        half + xi * fill32 / x_size,
        half + yi * _f32(0.9) / y_size,
        half + zi * fill32 / z_size,
    ], -1)
    return _jitter(pos, i, cube, seed)


_PRESETS = (preset1, preset2, preset3)


def init_positions(cfg: SimConfig, device=None) -> torch.Tensor:
    """Spawn positions per the config's preset field (kernel dispatch index —
    SphFluidSimulation.cs:182-184)."""
    fn = _PRESETS[cfg.preset]
    return fn(cfg.n_particles, cfg.dam_fill_rate, cfg.seed, device)
