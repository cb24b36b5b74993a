"""SPH kernel functions, equation of state, and wall forces.

Counterpart of ``sphfluidsimulation_tpu/ops/sph_math.py``: exact functional
transcriptions of the reference's HLSL formulas (not the Müller-03 textbook
forms):

* poly6 density kernel          — Density.compute:22-27
* pressure gradient kernel      — VelPos.compute:33-38 (profile (h−r)³)
* viscosity Laplacian kernel    — VelPos.compute:40-44
* equation of state             — VelPos.compute:61,87 (p can be negative)
* wall penalty force            — VelPos.compute:107-137, including the quirk
  that the damping term is the SCALAR dot(damp, v) subtracted from all three
  force components

All functions are elementwise over leading dimensions and float32.
"""

from __future__ import annotations

import math

import torch

from ..config import EPSILON

_PI = math.pi
_I32_MAX = 2**31 - 1


def trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 rounding toward zero, saturating, NaN → 0.

    These are the semantics of XLA's convert and of the GPU's ``cvt.rzi``
    instruction. A bare ``.to(torch.int32)`` truncates toward zero as well,
    but on x86 turns NaN and out-of-range values into INT_MIN.
    """
    big = x >= 2.0**31
    xi = torch.where(torch.isnan(x) | big, 0.0, x).clamp(min=-2.0**31)
    return torch.where(big, _I32_MAX, xi.to(torch.int32))


def w_poly6(r2, h2, h9):
    """Density kernel W(r) = 315/(64π) · (h²−|r|²)³ / h⁹ for |r|² < h².

    Density.compute:22-27. Takes squared distance ``r2``.
    """
    c = 315.0 / (64.0 * _PI)
    diff = h2 - r2
    w = c * (diff * diff * diff) / h9
    return torch.where(diff > 0, w, 0.0)


def grad_w_press_over_r(abs_r, h, h6):
    """Scalar radial factor of the pressure kernel gradient: multiply by the
    displacement components (pos_i − pos_j) to get the vector gradient.

    grad_W_press(r) = 45/π / h⁶ · (h−|r|)³ · r/|r|, valid only when both
    |r| > ε and (h−|r|) > ε (VelPos.compute:33-38).
    """
    c = 45.0 / _PI
    diff_r = h - abs_r
    valid = (diff_r > EPSILON) & (abs_r > EPSILON)
    safe_abs = torch.where(valid, abs_r, 1.0)
    mag = (c / h6) * (diff_r * diff_r * diff_r) / safe_abs
    return torch.where(valid, mag, 0.0)


def grad_w_press(r_vec, h, h6):
    """Vector form of the pressure gradient (the brute oracle's)."""
    abs_r = torch.linalg.vector_norm(r_vec, dim=-1)
    return grad_w_press_over_r(abs_r, h, h6)[..., None] * r_vec


def grad_w_vis_r(abs_r, h, h6):
    """Viscosity Laplacian kernel: 45/π / h⁶ · (h−|r|) for |r| < h.

    VelPos.compute:40-44 (standard Müller viscosity Laplacian). Scalar.
    """
    c = 45.0 / _PI
    return torch.where(abs_r < h, (c / h6) * (h - abs_r), 0.0)


def grad_w_vis(r_vec, h, h6):
    """Vector-displacement wrapper of :func:`grad_w_vis_r`."""
    return grad_w_vis_r(torch.linalg.vector_norm(r_vec, dim=-1), h, h6)


def eos_pressure(rho, gas_constant, rest_density):
    """p = k·(ρ − ρ₀) (VelPos.compute:61,87). May be negative."""
    return gas_constant * (rho - rest_density)


def wall_force(pos, vel, h, stiffness, damping, mass):
    """Box-boundary penalty force (VelPos.compute:107-137).

    Per axis: penetration depth r = h−p if p < h, r = 1−p−h if p > 1−h
    (note the second is negative), else 0. Then

        f_wall = r·stiffness − dot(damp, v)        (VelPos.compute:135)

    where damp.axis = damping iff r.axis ≠ 0 and the dot product is a SCALAR
    subtracted from ALL components — a reference quirk reproduced exactly.
    The force is scaled by mass (:136) and applied only if max|r| > 0 (:133).

    pos, vel: f32[..., 3]. Returns f32[..., 3].
    """
    low = h - pos                 # r when pos < h
    high = 1.0 - pos - h          # r when pos > 1 − h (negative)
    r = torch.where(pos < h, low, torch.where(pos > 1.0 - h, high, 0.0))
    damp = torch.where(r != 0.0, damping, 0.0)
    dv = damp * vel
    # summed left to right, as the JAX reduction over three lanes does
    damp_dot = (dv[..., 0:1] + dv[..., 1:2]) + dv[..., 2:3]
    f = (r * stiffness - damp_dot) * mass
    active = r.abs().amax(dim=-1, keepdim=True) > 0.0
    return torch.where(active, f, 0.0)


def cell_index(pos, bucket_resolution: int):
    """Voxel coordinates int3(pos · (R−1)) (Bucket.compute:27).

    The HLSL int cast truncates toward zero (:func:`trunc_i32`);
    slightly-out-of-range positions (jittered spawns before the first
    clamp) land in edge cells exactly as in the reference.
    """
    return trunc_i32(pos * (bucket_resolution - 1))
