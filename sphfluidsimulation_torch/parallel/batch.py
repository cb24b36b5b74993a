"""Batched multi-scene simulation (data parallelism over scenes).

Counterpart of ``sphfluidsimulation_tpu/parallel/batch.py``: BASELINE config
5, a sweep of scenes with varied physics (rest density, stiffness,
viscosity, ...) advanced in lockstep. All scenes of a batch share structure
(particle count, bucket resolution, capacity, substeps); the physics
scalars ride a stacked ``PhysParams`` with one row a scene, and the states
a leading scene axis.

JAX ``vmap``s the frame step over the scene axis. The port runs each
scene's frame step in turn on its row of the stacked state and params: on
the sorted tier that is 1 K1 and 5 K2 launches (K2-ext with extensions) a
scene and frame, so each scene's result is bit for bit the result of
stepping that scene alone. Folding the scene axis into the kernels' launch
grid is performance work (ROADMAP.md queue A). JAX's ``mesh=`` scatters the
scenes over devices; here ``devices=`` gives each device a contiguous block
of scenes, as ``P(axis)`` does, with no traffic between devices.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Sequence

import torch

from ..config import SimConfig
from ..ops.sph_kernels import SortedTuning
from ..params import PhysParams, stack_params
from ..sim.stepper import initial_state, make_param_step, resolve_device
from ..state import ParticleState, StepMetrics, stack_states


def batch_configs(base: SimConfig,
                  overrides: Sequence[dict]) -> list[SimConfig]:
    """One config per scene; all must share structural fields (JAX
    batch.py:28-39, the same ``ValueError``)."""
    cfgs = [base.replace(**ov) for ov in overrides]
    for c in cfgs:
        if (c.n_particles, c.bucket_resolution, c.voxel_capacity,
                c.substeps) != (base.n_particles, base.bucket_resolution,
                                base.voxel_capacity, base.substeps):
            raise ValueError(
                "batched scenes must share structural config (particle "
                "count, bucket resolution, capacity, substeps); vary only "
                "physics scalars / presets / seeds")
    return cfgs


def over_scenes(step):
    """``(states, params) → (states, metrics)`` over a leading scene axis
    from a one-scene ``step``: each scene's step on its row (of a
    ``ParticleState`` or a ``SlabState`` and of the stacked params), one
    scene after another, the results stacked again."""

    def batched(states, params: PhysParams):
        outs = [step(type(states)(*(x[i] for x in states)),
                     PhysParams(*(x[i] for x in params)))
                for i in range(states[0].shape[0])]
        return (stack_states([o[0] for o in outs]),
                stack_states([o[1] for o in outs]))

    return batched


def make_batched_step(base: SimConfig, *, neighbor: str = "sorted",
                      faithful: bool = True,
                      tune: SortedTuning | None = None):
    """``(states, params) → (states, metrics)`` over a leading scene axis:
    each scene's frame step on its row, one scene after another (JAX's
    ``vmap`` of ``make_param_step``). ``neighbor`` and ``tune`` are
    ``make_param_step``'s (the port's default tier, ``"sorted"``)."""
    return over_scenes(make_param_step(base, neighbor=neighbor,
                                       faithful=faithful, tune=tune))


class BatchedScenes:
    """A sweep of scenes advanced in lockstep.

    ``devices`` (None: the card; without one it raises) holds the scenes in
    contiguous blocks, one a device, as JAX's ``mesh=`` shards them
    (``P(axis)``): the scene count must divide by the device count. Each
    block steps on its own device. ``states`` and ``last_metrics`` are the
    whole batch on the first device (a copy when there are several).
    """

    def __init__(self, base: SimConfig, overrides: Sequence[dict], *,
                 neighbor: str = "sorted", faithful: bool = True,
                 tune: SortedTuning | None = None,
                 devices: Sequence[torch.device | str] | torch.device
                 | str | None = None):
        self.configs = batch_configs(base, overrides)
        if devices is None or isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = [resolve_device(d) for d in devices]
        n_scenes, n_dev = len(self.configs), len(self.devices)
        if n_scenes % n_dev:
            raise ValueError(f"{n_scenes} scenes do not divide over "
                             f"{n_dev} devices")
        per = n_scenes // n_dev
        self._step = make_batched_step(base, neighbor=neighbor,
                                       faithful=faithful, tune=tune)
        # (states, params) of each device's block of scenes
        self.blocks = []
        for k, dev in enumerate(self.devices):
            cfgs = self.configs[k * per:(k + 1) * per]
            self.blocks.append((
                stack_states([initial_state(c, dev) for c in cfgs]),
                stack_params([PhysParams.from_config(c, dev)
                              for c in cfgs])))
        self.last_metrics: StepMetrics | None = None
        self.frame = 0

    @staticmethod
    def _gather(parts, dev):
        if len(parts) == 1:
            return parts[0]
        return type(parts[0])(*(torch.cat([x.to(dev) for x in xs])
                                for xs in zip(*parts)))

    @property
    def states(self) -> ParticleState:
        return self._gather([b[0] for b in self.blocks], self.devices[0])

    @property
    def params(self) -> PhysParams:
        return self._gather([b[1] for b in self.blocks], self.devices[0])

    def step(self, n: int = 1) -> ParticleState:
        for _ in range(n):
            ms = []
            for k, (dev, (states, params)) in enumerate(
                    zip(self.devices, self.blocks)):
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else nullcontext()):
                    states, m = self._step(states, params)
                self.blocks[k] = (states, params)
                ms.append(m)
            self.last_metrics = self._gather(ms, self.devices[0])
            self.frame += 1
        return self.states

