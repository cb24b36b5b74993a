"""Particle state and per-frame metrics.

Counterpart of ``sphfluidsimulation_tpu/state.py`` (``ParticleState``,
``FrameAux``, ``StepMetrics``, ``make_state``). The reference stores particle state in
ping-ponged float4 textures (SphFluidSimulation.cs:138-155); the port keeps
flat ``[N, 3]`` float32 tensors. Particle index ``i`` corresponds to
reference texel ``(i % res, i / res)`` (Density.compute:53).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ParticleState(NamedTuple):
    """Positions in the unit cube [0,1]³ and velocities (unit-cube units/s).

    ``nan_count`` replaces the reference's per-particle NaN alpha marker
    (VelPos.compute:143-147): it counts trapped-NaN events per particle.
    """

    pos: torch.Tensor        # f32[N, 3]
    vel: torch.Tensor        # f32[N, 3]
    nan_count: torch.Tensor  # i32[N]

    @property
    def n(self) -> int:
        return self.pos.shape[-2]


def make_state(pos: torch.Tensor, vel: torch.Tensor | None = None
               ) -> ParticleState:
    pos = torch.as_tensor(pos, dtype=torch.float32)
    if vel is None:
        # Velocities are zero-initialized (SphFluidSimulation.cs:189).
        vel = torch.zeros_like(pos)
    nan_count = torch.zeros(pos.shape[:-1], dtype=torch.int32,
                            device=pos.device)
    return ParticleState(pos=pos, vel=torch.as_tensor(vel, dtype=torch.float32,
                                                      device=pos.device),
                         nan_count=nan_count)


def stack_states(states: list) -> "ParticleState":
    """Per-scene states (``ParticleState``, a slab ``SlabState`` or
    ``StepMetrics``) stacked along a leading scene axis, as the JAX
    package's ``jax.tree.map(jnp.stack, *states)``."""
    return type(states[0])(*(torch.stack(xs) for xs in zip(*states)))


def state_from_numpy(pos: np.ndarray, vel: np.ndarray, nan_count: np.ndarray,
                     device: torch.device | str | None = None
                     ) -> ParticleState:
    """Carry a JAX ``ParticleState`` (as numpy arrays) across to the port."""
    return ParticleState(
        pos=torch.tensor(np.asarray(pos, np.float32), device=device),
        vel=torch.tensor(np.asarray(vel, np.float32), device=device),
        nan_count=torch.tensor(np.asarray(nan_count, np.int32),
                               device=device))


def state_to_numpy(state: ParticleState
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pos, vel, nan_count) as numpy arrays, ready for the JAX package."""
    return (state.pos.detach().cpu().numpy(),
            state.vel.detach().cpu().numpy(),
            state.nan_count.detach().cpu().numpy())


def slab_state_from_numpy(pos: np.ndarray, vel: np.ndarray,
                          nan_count: np.ndarray, pid: np.ndarray,
                          valid: np.ndarray,
                          device: torch.device | str | None = None):
    """Carry a JAX ``parallel.slab.SlabState`` (as numpy arrays) across to
    the port's (``parallel/slab.py``)."""
    from .parallel.slab import SlabState
    return SlabState(
        pos=torch.tensor(np.asarray(pos, np.float32), device=device),
        vel=torch.tensor(np.asarray(vel, np.float32), device=device),
        nan_count=torch.tensor(np.asarray(nan_count, np.int32),
                               device=device),
        pid=torch.tensor(np.asarray(pid, np.int32), device=device),
        valid=torch.tensor(np.asarray(valid, bool), device=device))


def slab_state_to_numpy(st) -> tuple[np.ndarray, ...]:
    """(pos, vel, nan_count, pid, valid) of a port ``SlabState`` as numpy
    arrays, ready for the JAX package."""
    return tuple(t.detach().cpu().numpy() for t in st)


class FrameAux(NamedTuple):
    """Per-frame quantities reused across the five substeps.

    The reference builds the bucket once a frame and computes the density
    once a frame, then reuses both for all five integration substeps
    (SphFluidSimulation.cs:98-102). ``cell`` is each particle's voxel at the
    frame start (the "stale" cell of the neighbour lookup), ``rho`` the
    frame-start density.
    """

    rho: torch.Tensor   # f32[N]
    cell: torch.Tensor  # i32[N, 3] — frame-start voxel coordinates


class StepMetrics(NamedTuple):
    """Per-frame observability (the same six fields as the JAX package)."""

    max_speed: torch.Tensor       # f32[]
    mean_density: torch.Tensor    # f32[]
    kinetic_energy: torch.Tensor  # f32[]
    nan_events: torch.Tensor      # i32[] — total NaN traps this frame
    overflow: torch.Tensor        # i32[] — particles dropped by voxel capacity
    exact_cert: torch.Tensor      # i32[] — under-covered candidate windows:
                                  # identically 0 on the K1-K3 route, the
                                  # drift count on K5's (sim/stepper.py)
