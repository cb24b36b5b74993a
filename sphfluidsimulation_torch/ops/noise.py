"""Textureless 4D simplex noise (Ashima Arts / Stefan Gustavson algorithm).

Counterpart of ``sphfluidsimulation_tpu/ops/noise.py::snoise4``: the
public-domain (MIT) Ashima ``webgl-noise`` 4D simplex algorithm, matching the
overload the reference's spawn presets call, ``snoise(float4 v)``
(Assets/Resources/noiseSimplex.cginc:296-425, used at InitParticles.compute:37,
70, 103).

All arithmetic is float32 in the JAX version's operation order, so the spawn
positions agree bit for bit (the dam-break is chaotic; init noise must match).
Four-lane dot products are summed left to right, as the JAX reduction does.
"""

from __future__ import annotations

import numpy as np
import torch

_INV_289 = float(np.float32(0.00346020761245674740484429065744))
_C = [float(c) for c in np.array([0.138196601125011, 0.276393202250021,
                                   0.414589803375032, -0.447213595499958],
                                  np.float32)]
_F4 = float(np.float32(0.309016994374947451))  # (sqrt(5)−1)/4
_IP = [float(c) for c in np.array([0.003401360544217687075,   # 1/294
                                    0.020408163265306122449,   # 1/49
                                    0.142857142857142857143],  # 1/7
                                   np.float32)]
_TAYLOR_A = float(np.float32(1.79284291400159))
_TAYLOR_B = float(np.float32(0.85373472095314))


def _mod289(x):
    """x − floor(x/289)·289 (noiseSimplex.cginc:62-76)."""
    return x - torch.floor(x * _INV_289) * 289.0


def _permute(x):
    """mod289(x²·34 + x) (noiseSimplex.cginc:81-97)."""
    return _mod289(x * x * 34.0 + x)


def _taylor_inv_sqrt(r):
    """1.79284291400159 − 0.85373472095314·r (noiseSimplex.cginc:101-107)."""
    return _TAYLOR_A - _TAYLOR_B * r


def _step(edge, x):
    """HLSL step(edge, x) = x >= edge ? 1 : 0."""
    return (x >= edge).to(torch.float32)


def _dot(a, b):
    """Left-to-right sum over the last axis (length 3 or 4)."""
    p = a * b
    s = p[..., 0] + p[..., 1]
    for k in range(2, p.shape[-1]):
        s = s + p[..., k]
    return s


def _grad4(j):
    """Gradient on the 4-cross polytope (noiseSimplex.cginc:111-126).

    j: f32[...]. Returns f32[..., 4].
    """
    ip = torch.tensor(_IP, dtype=torch.float32, device=j.device)
    p_xyz = torch.floor(torch.remainder(j[..., None] * ip, 1.0) * 7.0) \
        * _IP[2] - 1.0
    a = p_xyz.abs()
    p_w = 1.5 - ((a[..., 0:1] + a[..., 1:2]) + a[..., 2:3])
    s = 1.0 - _step(0.0, torch.cat([p_xyz, p_w], -1))
    p_xyz = p_xyz + (s[..., :3] * 2.0 - 1.0) * s[..., 3:4]
    return torch.cat([p_xyz, p_w], -1)


def snoise4(v: torch.Tensor) -> torch.Tensor:
    """Scalar 4D simplex noise of f32[..., 4] input → f32[...].

    Transcribes noiseSimplex.cginc:296-425 (the float4 overload).
    """
    v = v.to(torch.float32)
    c0, c1, c2, c3 = _C

    # First corner
    i = torch.floor(v + _dot(v, torch.full_like(v, _F4))[..., None])
    x0 = v - i + _dot(i, torch.full_like(i, c0))[..., None]

    # Rank-sort the simplex corner traversal order
    x0x, x0y, x0z, x0w = (x0[..., k] for k in range(4))
    is_x = torch.stack([_step(x0y, x0x), _step(x0z, x0x), _step(x0w, x0x)], -1)
    is_yz = torch.stack([_step(x0z, x0y), _step(x0w, x0y), _step(x0w, x0z)],
                        -1)
    i0x = is_x[..., 0] + is_x[..., 1] + is_x[..., 2]
    i0y = 1.0 - is_x[..., 0] + is_yz[..., 0] + is_yz[..., 1]
    i0z = (1.0 - is_x[..., 1]) + (1.0 - is_yz[..., 0]) + is_yz[..., 2]
    i0w = (1.0 - is_x[..., 2]) + (1.0 - is_yz[..., 1]) + (1.0 - is_yz[..., 2])
    i0 = torch.stack([i0x, i0y, i0z, i0w], -1)

    i3 = i0.clamp(0.0, 1.0)
    i2 = (i0 - 1.0).clamp(0.0, 1.0)
    i1 = (i0 - 2.0).clamp(0.0, 1.0)

    x1 = x0 - i1 + c0
    x2 = x0 - i2 + c1
    x3 = x0 - i3 + c2
    x4 = x0 + c3

    # Permutations
    i = _mod289(i)
    ix, iy, iz, iw = (i[..., k] for k in range(4))
    j0 = _permute(_permute(_permute(_permute(iw) + iz) + iy) + ix)
    ones = torch.ones_like(i1[..., :1])

    def corner(k):
        return torch.cat([i1[..., k:k + 1], i2[..., k:k + 1],
                          i3[..., k:k + 1], ones], -1)

    j1 = _permute(
        _permute(
            _permute(
                _permute(iw[..., None] + corner(3)) + iz[..., None]
                + corner(2)
            ) + iy[..., None] + corner(1)
        ) + ix[..., None] + corner(0)
    )

    p0 = _grad4(j0)
    p1 = _grad4(j1[..., 0])
    p2 = _grad4(j1[..., 1])
    p3 = _grad4(j1[..., 2])
    p4 = _grad4(j1[..., 3])

    norm = _taylor_inv_sqrt(torch.stack(
        [_dot(p0, p0), _dot(p1, p1), _dot(p2, p2), _dot(p3, p3)], -1))
    p0 = p0 * norm[..., 0:1]
    p1 = p1 * norm[..., 1:2]
    p2 = p2 * norm[..., 2:3]
    p3 = p3 * norm[..., 3:4]
    p4 = p4 * _taylor_inv_sqrt(_dot(p4, p4))[..., None]

    m0 = torch.clamp(0.6 - torch.stack(
        [_dot(x0, x0), _dot(x1, x1), _dot(x2, x2)], -1), min=0.0)
    m1 = torch.clamp(0.6 - torch.stack([_dot(x3, x3), _dot(x4, x4)], -1),
                     min=0.0)
    m0 = m0 * m0
    m1 = m1 * m1

    d0 = torch.stack([_dot(p0, x0), _dot(p1, x1), _dot(p2, x2)], -1)
    d1 = torch.stack([_dot(p3, x3), _dot(p4, x4)], -1)
    return 49.0 * (_dot(m0 * m0, d0) + _dot(m1 * m1, d1))
