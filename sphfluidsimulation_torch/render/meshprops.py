"""Per-instance render properties, on the device of the state.

Counterpart of ``sphfluidsimulation_tpu/render/meshprops.py``. Transcribes
``Assets/Resources/UpdateMeshProperties.compute``:

* world position = unit-cube position · simScale − simScale/2
  (UpdateMeshProperties.compute:34-40 — the SimTRS translation is extracted
  at :37 but never applied, so only the diagonal scale matters; the host
  passes transform.localToWorldMatrix with the scene's uniform scale 5,
  SphFluidSimulation.cs:284, SampleScene.unity:461)
* per-instance matrix = translation(worldPos) · scale(particleRadius)
  (:43-59; the host passes particleRadius on all three axes,
  SphFluidSimulation.cs:280)
* color = lerp(blue → red, saturate((|v| − low)/(high − low))) (:62-63)

The MeshProperties struct (float4x4 + float4, :3-6) becomes a pair of
tensors (mat f32[N, 4, 4], color f32[N, 4]).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig


class RenderParams(NamedTuple):
    low_speed: torch.Tensor       # _LowSpeed
    high_speed: torch.Tensor      # _HighSpeed
    particle_scale: torch.Tensor  # _ParticleScale (= particleRadius, cs:280)
    sim_scale: torch.Tensor       # diagonal of _SimTRS (scene scale 5)

    @classmethod
    def from_config(cls, cfg: SimConfig,
                    device: torch.device | str | None = None
                    ) -> "RenderParams":
        def f(x: float) -> torch.Tensor:
            return torch.tensor(x, dtype=torch.float32, device=device)

        return cls(low_speed=f(cfg.low_speed), high_speed=f(cfg.high_speed),
                   particle_scale=f(cfg.particle_radius),
                   sim_scale=f(cfg.sim_scale))


def world_positions(pos: torch.Tensor, rp: RenderParams) -> torch.Tensor:
    """unit cube → world: pos·simScale − simScale/2
    (UpdateMeshProperties.compute:40)."""
    return pos * rp.sim_scale - rp.sim_scale * 0.5


# Alpha written to a NaN-trapped particle's velocity w channel
# (VelPos.compute:146: vel = float4(0, 0, 0, 0.003)).
NAN_MARKER_ALPHA = 0.003


def speed_colors(vel: torch.Tensor, rp: RenderParams,
                 nan_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Blue→red speed ramp, RGBA f32[..., 4]
    (UpdateMeshProperties.compute:62-63).

    ``nan_mask`` (optional bool[...]) marks NaN-trapped particles with
    alpha 0.003, the reference's only visual failure signal
    (VelPos.compute:146), selected into the instance colour so trapped
    particles are render-visible; without it alpha stays the reference's
    constant 1 (UpdateMeshProperties.compute:63). Callers typically pass
    ``state.nan_count > 0``.
    """
    speed = torch.linalg.vector_norm(vel, dim=-1)
    t = ((speed - rp.low_speed)
         / (rp.high_speed - rp.low_speed)).clamp(0.0, 1.0)
    blue = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float32,
                        device=vel.device)
    red = torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=torch.float32,
                       device=vel.device)
    rgba = blue + (red - blue) * t[..., None]
    if nan_mask is not None:
        alpha = torch.where(nan_mask, NAN_MARKER_ALPHA, rgba[..., 3])
        rgba = torch.cat([rgba[..., :3], alpha[..., None]], -1)
    return rgba


def mesh_properties(pos: torch.Tensor, vel: torch.Tensor, rp: RenderParams,
                    nan_mask: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mat f32[N, 4, 4], color f32[N, 4]): the MeshProperties buffer."""
    wp = world_positions(pos, rp)
    n = pos.shape[0]
    mat = torch.eye(4, dtype=torch.float32,
                    device=pos.device).repeat(n, 1, 1)
    idx = torch.arange(3, device=pos.device)
    mat[:, idx, idx] = rp.particle_scale
    mat[:, 0:3, 3] = wp
    return mat, speed_colors(vel, rp, nan_mask)
