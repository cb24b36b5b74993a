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

``jit=True`` (JAX's keyword and default, scene.py:22-27, which jits the
frame step) records the sorted tier's frame on the card once, at the
first ``step``, as a CUDA graph (``sim/graph.py``: one eager warm-up,
then the capture; a failed capture raises) and replays it once a frame:
its carry holds the state in the caller's order and the last frame's
metrics, so ``state`` and ``last_metrics`` are copies and setting
``state`` loads the carry. Every mode, route and variant records, and the
result is the eager step's bit for bit. ``jit=False``, the other tiers
and the CPU step eagerly (``host_loop`` says which runs).
"""

from __future__ import annotations

from typing import Iterator

import torch

from ..config import SimConfig
from ..ops.sph_kernels import SortedTuning
from ..params import PhysParams
from ..sim import graph
from ..sim.stepper import (_check_supported, initial_state, make_param_step,
                           resolve_device)
from ..state import ParticleState, StepMetrics


class Scene:
    def __init__(self, cfg: SimConfig | None = None, *,
                 neighbor: str = "sorted", faithful: bool = True,
                 tune: SortedTuning | None = None,
                 device: torch.device | str | None = None,
                 jit: bool = True):
        self.cfg = (cfg or SimConfig()).validate()
        self.neighbor = neighbor
        self.device = resolve_device(device)
        # JAX jits the frame step; the port records the sorted tier's
        # frame on the card (the other tiers and the CPU step eagerly)
        self.host_loop = not jit or graph.choose_host_loop(
            _check_supported(neighbor), self.device, None)
        step = make_param_step(self.cfg, neighbor=neighbor,
                               faithful=faithful, tune=tune)
        phys = PhysParams.from_config(self.cfg, self.device)
        state = initial_state(self.cfg, self.device)
        self._graph: graph.RecordedStep | None = None
        if self.host_loop:
            self._step = lambda st: step(st, phys)
            self._state = state
        else:
            self._carry = graph.StepCarry(state, phys,
                                          graph.metric_lanes((), self.device))
            self._graph = graph.RecordedStep(graph.step_body(step),
                                             self._carry, self.device)
        self._metrics: StepMetrics | None = None
        self.frame = 0

    @property
    def state(self) -> ParticleState:
        """The scene's state; with the recorded frame a copy of its carry,
        which the next frame changes."""
        if self._graph is None:
            return self._state
        return ParticleState(*(x.clone() for x in self._carry.state))

    @state.setter
    def state(self, state: ParticleState) -> None:
        if self._graph is None:
            self._state = state
            return
        for dst, src in zip(self._carry.state, state):
            if src.shape != dst.shape:
                raise ValueError(f"state tensor of shape "
                                 f"{tuple(src.shape)}; the scene holds "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

    @property
    def last_metrics(self) -> StepMetrics | None:
        """The last frame's metrics (None before the first frame); with the
        recorded frame a copy of its carry's lanes."""
        if self._graph is None or self._metrics is None:
            return self._metrics
        return StepMetrics(*(x.clone() for x in self._metrics))

    def reset(self) -> ParticleState:
        self.state = initial_state(self.cfg, self.device)
        self.frame = 0
        return self.state

    def step(self, n: int = 1) -> ParticleState:
        for _ in range(n):
            if self._graph is None:
                self._state, self._metrics = self._step(self._state)
            else:
                self._graph.replay()
                self._metrics = self._carry.metrics
            self.frame += 1
        return self.state

    def frames(self, n: int) -> Iterator[ParticleState]:
        for _ in range(n):
            yield self.step()
