"""Batched multi-scene simulation (data parallelism over scenes).

Counterpart of ``sphfluidsimulation_tpu/parallel/batch.py``: BASELINE config
5, a sweep of scenes with varied physics (rest density, stiffness,
viscosity, ...) advanced in lockstep. All scenes of a batch share structure
(particle count, bucket resolution, capacity, substeps); the physics
scalars ride a stacked ``PhysParams`` with one row a scene, and the states
a leading scene axis.

JAX ``vmap``s the frame step over the scene axis under one ``jit``: one
program a frame, whose Pallas kernels take the scene as a grid axis. The
port's batched step (:func:`make_batched_step`) has that shape on the
sorted tier, in both modes and on every route and variant
(``stepper.scene_axis``, ``stepper.make_scenes_step``): each frame build
over all scenes, and each kernel launch over all scenes. A faithful frame
is 1 K1 + 5 K2 launches (K2-ext with extensions), an unfused one 1 K1 +
5 K3, a corrected one 6 K1 + 5 K3, and on the compact route 1 K5 density
+ 5 K5 substeps, or 6 K5 density + 5 K5 forces corrected (K3 with
extensions), each in the variant's library. The slotted, gather, brute
and sites tiers have no kernel to batch: they run each scene's frame step
in turn on its row (:func:`over_scenes`). Either way each scene's result
is bit for bit the result of stepping that scene alone.

On the card :class:`BatchedScenes` of the sorted tier records one batched
frame as a CUDA graph and replays it each frame (``sim/graph.py``
``RecordedStep``; ``host_loop=True`` keeps the Python loop). JAX's
``mesh=`` scatters the scenes over devices; here ``devices=`` gives each
device a contiguous block of scenes, as ``P(axis)`` does, with no traffic
between devices, and each block its own graph.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Sequence

import torch

from ..config import SimConfig
from ..ops.sph_kernels import SortedTuning, default_tuning
from ..params import PhysParams, stack_params
from ..sim import graph, stepper
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
    """``(states, params) → (states, metrics)`` over a leading scene axis
    (JAX's ``vmap`` of ``make_param_step``): the scene-axis step on the
    sorted tier, else each scene's frame step on its row, one scene after
    another (the module docstring). ``neighbor``, ``faithful`` and ``tune``
    are ``make_param_step``'s (the port's default tier, ``"sorted"``; None
    reads the ``SPH_PALLAS_*`` variables)."""
    tune = default_tuning() if tune is None else tune
    if stepper.scene_axis(neighbor):
        return stepper.make_scenes_step(base, faithful, tune)
    return over_scenes(make_param_step(base, neighbor=neighbor,
                                       faithful=faithful, tune=tune))


class BatchedScenes:
    """A sweep of scenes advanced in lockstep.

    ``devices`` (None: the card; without one it raises) holds the scenes in
    contiguous blocks, one a device, as JAX's ``mesh=`` shards them
    (``P(axis)``): the scene count must divide by the device count. Each
    block steps on its own device. ``states`` and ``last_metrics`` are the
    whole batch on the first device (a copy when there are several, or
    when the frames replay a graph).

    ``host_loop`` has ``make_rollout``'s meaning, and the ``.host_loop``
    attribute says which mode runs:
    - None (the default): on the card, a recorded graph for the sorted
      tier (every route, mode and variant), one replay a frame; the host
      loop for the other tiers and on the CPU;
    - False: the graph; it raises on the CPU and, as
      ``NotImplementedError``, on the slotted, gather, brute and sites
      tiers;
    - True: the batched step called from Python each frame, each phase in
      its profiler range.
    Each block's graph (``sim/graph.py`` ``RecordedStep``) is recorded on
    its device at the first frame, after one eager warm-up frame on a copy
    of the block; a capture that fails raises, and nothing runs in its
    place. The launch counters after a replay equal the host loop's.
    """

    def __init__(self, base: SimConfig, overrides: Sequence[dict], *,
                 neighbor: str = "sorted", faithful: bool = True,
                 tune: SortedTuning | None = None,
                 devices: Sequence[torch.device | str] | torch.device
                 | str | None = None,
                 host_loop: bool | None = None):
        self.configs = batch_configs(base, overrides)
        if devices is None or isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = [resolve_device(d) for d in devices]
        n_scenes, n_dev = len(self.configs), len(self.devices)
        if n_scenes % n_dev:
            raise ValueError(f"{n_scenes} scenes do not divide over "
                             f"{n_dev} devices")
        tier = stepper._check_supported(neighbor)
        self.host_loop = any([graph.choose_host_loop(tier, d, host_loop)
                              for d in self.devices])
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
        # each block's recorded frame, whose carry holds its states
        self._graphs = []
        if not self.host_loop:
            for dev, (states, params) in zip(self.devices, self.blocks):
                carry = graph.StepCarry(states, params,
                                        graph.metric_lanes((per,), dev))
                self._graphs.append((carry, graph.RecordedStep(
                    graph.step_body(self._step), carry, dev)))
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
        parts = [b[0] for b in self.blocks]
        if self._graphs:
            # the carries change at the next replay
            parts = [type(p)(*(x.clone() for x in p)) for p in parts]
        return self._gather(parts, self.devices[0])

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
                    if self._graphs:
                        carry, recorded = self._graphs[k]
                        recorded.replay()
                        m = StepMetrics(*(x.clone() for x in carry.metrics))
                    else:
                        states, m = self._step(states, params)
                        self.blocks[k] = (states, params)
                ms.append(m)
            self.last_metrics = self._gather(ms, self.devices[0])
            self.frame += 1
        return self.states
