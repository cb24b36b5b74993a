"""Octahedron-sphere particle mesh (host-side, vectorized numpy).

Counterpart of ``sphfluidsimulation_tpu/render/sphere.py``, copied verbatim
(numpy only): importing the JAX package's module would import jax.

Capability parity with the reference's mesh generator
(``Assets/Scripts/OctahedronSphereCreator.cs``: subdivided octahedron
normalized to a sphere, with normals, spherical UVs and tangents; the sim
uses ``Create(1, 1f)`` — SphFluidSimulation.cs:162). This is an independent
vectorized construction, not a port of the C# strip-walking code: each of
the 8 octahedron faces is subdivided in barycentric coordinates and shared
edge vertices are deduplicated, which yields a watertight index mesh
(4·res² + 2 unique vertices) instead of the reference's duplicated UV-seam
layout — equivalent geometry, cleaner topology.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Mesh(NamedTuple):
    vertices: np.ndarray   # f32[V, 3]
    normals: np.ndarray    # f32[V, 3]
    uv: np.ndarray         # f32[V, 2]
    tangents: np.ndarray   # f32[V, 4]
    triangles: np.ndarray  # i32[T, 3]


# The 8 octahedron faces as (corner_a, corner_b, corner_c) unit vectors,
# wound counter-clockwise viewed from outside.
_CORNERS = np.array([
    [0, -1, 0], [0, 1, 0],                     # down, up
    [1, 0, 0], [-1, 0, 0],                     # right, left
    [0, 0, 1], [0, 0, -1],                     # forward, back
], np.float32)
_FACES = [
    (0, 4, 2), (0, 2, 5), (0, 5, 3), (0, 3, 4),   # lower hemisphere
    (1, 2, 4), (1, 5, 2), (1, 3, 5), (1, 4, 3),   # upper hemisphere
]


def octahedron_sphere(subdivisions: int = 1, radius: float = 1.0) -> Mesh:
    """Build the sphere mesh. ``subdivisions`` clamps to [0, 21] like the
    reference (OctahedronSphereCreator.cs:16-25); face resolution is
    2**subdivisions."""
    subdivisions = int(np.clip(subdivisions, 0, 21))
    res = 1 << subdivisions

    # Barycentric lattice on one face: all (i, j) with i + j <= res.
    ii, jj = np.meshgrid(np.arange(res + 1), np.arange(res + 1),
                         indexing="ij")
    keep = (ii + jj) <= res
    bi, bj = ii[keep], jj[keep]
    bk = res - bi - bj
    bary = np.stack([bk, bi, bj], -1).astype(np.float32) / np.float32(res)

    verts: dict[tuple, int] = {}
    positions: list[np.ndarray] = []
    tris: list[list[int]] = []

    # Per-face local index of lattice point (i, j).
    local_index = -np.ones((res + 1, res + 1), np.int64)
    local_index[keep] = np.arange(keep.sum())

    for fa, fb, fc in _FACES:
        corners = _CORNERS[[fa, fb, fc]]
        pts = bary @ corners                      # [P, 3] on the face plane
        # Deduplicate via exact rational keys (i, j scaled ints per corner).
        face_ids = np.empty(len(pts), np.int64)
        for p in range(len(pts)):
            key = (fa, fb, fc)
            # canonical key: sorted (corner, weight) pairs with int weights
            w = (int(bk[p]), int(bi[p]), int(bj[p]))
            items = tuple(sorted((c, wt) for c, wt in zip(key, w) if wt))
            idx = verts.get(items)
            if idx is None:
                idx = len(positions)
                verts[items] = idx
                positions.append(pts[p])
            face_ids[p] = idx
        # Triangulate the lattice: for each cell (i, j) two triangles.
        for i in range(res):
            for j in range(res - i):
                a = local_index[i, j]
                b = local_index[i + 1, j]
                c = local_index[i, j + 1]
                tris.append([face_ids[a], face_ids[b], face_ids[c]])
                if j < res - i - 1:
                    d = local_index[i + 1, j + 1]
                    tris.append([face_ids[b], face_ids[d], face_ids[c]])

    v = np.asarray(positions, np.float32)
    norm = v / np.linalg.norm(v, axis=-1, keepdims=True)

    # Spherical UVs (same convention as OctahedronSphereCreator.cs:166-193).
    u = np.arctan2(norm[:, 0], norm[:, 2]) / (-2.0 * np.pi)
    u = np.where(u < 0, u + 1.0, u) - 0.25
    w = np.arcsin(np.clip(norm[:, 1], -1, 1)) / np.pi + 0.5
    uv = np.stack([u, w], -1).astype(np.float32)

    # Tangents: equatorial direction (OctahedronSphereCreator.cs:196-218).
    eq = norm.copy()
    eq[:, 1] = 0
    ln = np.linalg.norm(eq, axis=-1, keepdims=True)
    pole = ln[:, 0] < 1e-8
    eq = np.where(pole[:, None], np.array([[-1.0, 0.0, -1.0]]) / np.sqrt(2),
                  eq / np.maximum(ln, 1e-8))
    tangents = np.stack([-eq[:, 2], np.zeros(len(eq), np.float32), eq[:, 0],
                         -np.ones(len(eq), np.float32)], -1).astype(np.float32)

    return Mesh(vertices=(norm * np.float32(radius)).astype(np.float32),
                normals=norm.astype(np.float32),
                uv=uv,
                tangents=tangents,
                triangles=np.asarray(tris, np.int32))
