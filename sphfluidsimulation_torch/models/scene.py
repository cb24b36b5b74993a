"""Scene — the user-facing simulation handle.

Counterpart of ``sphfluidsimulation_tpu/models/scene.py::Scene``. Plays the
role of the reference's ``SphFluidSimulation`` MonoBehaviour
(Assets/Scripts/SphFluidSimulation.cs): owns the config, spawns the initial
state (``Start``, :82-94) and advances frames (``Update``, :96-108).

The default backend is ``"sorted"``, the tier that runs the hand-written
CUDA kernels. This differs from the JAX package on purpose: its default is
``"slotted"``, which the port runs too (with ``"gather"``, the exact tiers
of ``ops/cellops.py``, and ``"sites"``, the site grids of ``ops/sites.py``,
plain PyTorch); ``"brute"`` is the O(N²) oracle. ``faithful=False`` selects the corrected
mode, ``tune=SortedTuning(compact=True)`` the compact-lane route (K5)
(``SortedTuning``'s other fields the unfused route and the kernels'
variants), and
the config's ``xsph`` and ``artificial_viscosity`` reach every backend
through the frame step. The scene runs on the card unless ``device`` names
the CPU; without a card it raises.
"""

from __future__ import annotations

from typing import Iterator

import torch

from ..config import SimConfig
from ..ops.sph_kernels import SortedTuning
from ..sim.stepper import initial_state, make_frame_step, resolve_device
from ..state import ParticleState, StepMetrics


class Scene:
    def __init__(self, cfg: SimConfig | None = None, *,
                 neighbor: str = "sorted", faithful: bool = True,
                 tune: SortedTuning | None = None,
                 device: torch.device | str | None = None):
        self.cfg = (cfg or SimConfig()).validate()
        self.neighbor = neighbor
        self.device = resolve_device(device)
        self._step = make_frame_step(self.cfg, neighbor=neighbor,
                                     faithful=faithful, tune=tune,
                                     device=self.device)
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
