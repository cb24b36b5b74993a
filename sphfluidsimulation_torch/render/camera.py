"""Orbit camera (host-side, numpy).

Counterpart of ``sphfluidsimulation_tpu/render/camera.py``, copied verbatim
(numpy only): importing the JAX package's module would import jax.

Parity with ``Assets/Scripts/CameraOrbit.cs``: yaw/pitch angles with pitch
clamping (:76-81), camera position = R(pitch, yaw) · (0, 0, −distance) +
target (:54-56), minimum distance 2 (:33), scroll zoom (:34). The mouse/DPI
plumbing of the MonoBehaviour is UI glue with no simulation meaning; the
orbit math itself is reproduced as a pure object usable by the frame
exporter.
"""

from __future__ import annotations

import numpy as np


def _rot_euler_yx(pitch_deg: float, yaw_deg: float) -> np.ndarray:
    """Unity Quaternion.Euler(pitch, yaw, 0) as a 3x3 matrix (left-handed
    Y-up convention: yaw about +Y then pitch about +X)."""
    p = np.deg2rad(pitch_deg)
    y = np.deg2rad(yaw_deg)
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return ry @ rx


class OrbitCamera:
    """Mouse-free orbit camera with the reference's orbit kinematics."""

    def __init__(self, target=(0.0, 0.0, 0.0), distance: float = 8.0,
                 yaw: float = 0.0, pitch: float = 20.0,
                 pitch_limits=(-20.0, 80.0), fov_deg: float = 60.0):
        self.target = np.asarray(target, np.float32)
        self.distance = float(distance)
        self.yaw = float(yaw)
        self.pitch = float(pitch)
        self.pitch_limits = pitch_limits
        self.fov_deg = float(fov_deg)

    # -- the three orbit controls (CameraOrbit.cs:49-56, 33-34) --
    def orbit(self, dyaw: float, dpitch: float) -> "OrbitCamera":
        self.yaw += dyaw
        lo, hi = self.pitch_limits
        self.pitch = float(np.clip(self.pitch + dpitch, lo, hi))
        return self

    def zoom(self, scroll: float) -> "OrbitCamera":
        self.distance = max(2.0, self.distance - 2.0 * scroll)
        return self

    # -- derived frames --
    @property
    def rotation(self) -> np.ndarray:
        return _rot_euler_yx(self.pitch, self.yaw)

    @property
    def position(self) -> np.ndarray:
        return self.rotation @ np.array([0.0, 0.0, -self.distance],
                                        np.float32) + self.target

    def view_matrix(self) -> np.ndarray:
        """World → camera (camera looks along +Z toward the target)."""
        r = self.rotation
        t = self.position
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = r.T
        m[:3, 3] = -(r.T @ t)
        return m

    def project(self, points: np.ndarray, width: int, height: int
                ) -> tuple[np.ndarray, np.ndarray]:
        """World points → (pixel xy f32[N,2], camera depth f32[N]).

        Perspective with vertical fov; points behind the camera get depth<=0.
        """
        pts = np.asarray(points, np.float32)
        cam = (self.view_matrix() @ np.concatenate(
            [pts, np.ones((len(pts), 1), np.float32)], -1).T).T[:, :3]
        z = cam[:, 2]
        f = (height / 2.0) / np.tan(np.deg2rad(self.fov_deg) / 2.0)
        safe_z = np.where(np.abs(z) < 1e-6, 1e-6, z)
        x = cam[:, 0] * f / safe_z + width / 2.0
        y = height / 2.0 - cam[:, 1] * f / safe_z
        return np.stack([x, y], -1), z
