"""Scene — the user-facing simulation handle.

Counterpart of ``sphfluidsimulation_tpu/models/scene.py::Scene``. Plays the
role of the reference's ``SphFluidSimulation`` MonoBehaviour
(Assets/Scripts/SphFluidSimulation.cs): owns the config, spawns the initial
state (``Start``, :82-94) and advances frames (``Update``, :96-108).

The default backend is ``"sorted"`` (the JAX package defaults to
``"slotted"``, which is not ported yet: ROADMAP.md queue A item 8);
``"brute"`` is the O(N²) oracle. ``faithful=False`` selects the corrected
mode, and the config's ``xsph`` and ``artificial_viscosity`` reach every
backend through the frame step.
"""

from __future__ import annotations

from typing import Iterator

import torch

from ..config import SimConfig
from ..sim.stepper import initial_state, make_frame_step
from ..state import ParticleState, StepMetrics


class Scene:
    def __init__(self, cfg: SimConfig | None = None, *,
                 neighbor: str = "sorted", faithful: bool = True,
                 device: torch.device | str = "cpu"):
        self.cfg = (cfg or SimConfig()).validate()
        self.neighbor = neighbor
        self.device = torch.device(device)
        self._step = make_frame_step(self.cfg, neighbor=neighbor,
                                     faithful=faithful, device=self.device)
        self.state: ParticleState = initial_state(self.cfg, self.device)
        self.last_metrics: StepMetrics | None = None
        self.frame = 0

    def reset(self) -> ParticleState:
        self.state = initial_state(self.cfg, self.device)
        self.frame = 0
        return self.state

    def step(self, n: int = 1) -> ParticleState:
        for _ in range(n):
            self.state, self.last_metrics = self._step(self.state)
            self.frame += 1
        return self.state

    def frames(self, n: int) -> Iterator[ParticleState]:
        for _ in range(n):
            yield self.step()
