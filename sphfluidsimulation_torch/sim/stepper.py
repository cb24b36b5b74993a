"""Frame stepper and rollout engine — the sorted-frame tier.

Counterpart of ``sphfluidsimulation_tpu/sim/stepper.py``: ``integrate_substep``
(:40-60), ``_metrics`` (:63-75), the faithful branch of ``_make_pallas_step``
(:339-391), ``_make_pallas_rollout`` (:405-516), ``make_param_step``,
``make_frame_step``, ``make_rollout`` and ``initial_state``.

Each frame reproduces the reference pipeline in faithful mode
(SphFluidSimulation.cs:96-108): the neighbour structure and the density are
computed ONCE from the frame-start positions and reused by all five
substeps, while each substep reads fresh positions and velocities:

    build_frame (sort by anchor cell) → density (K1) → pack rows
    → 5 × fused substep (K2) → metrics

The only backend is ``neighbor="sorted"``, the counterpart of the JAX
``"pallas"`` tier. The kernels walk ``start[]`` cell by cell with no static
window and no per-line cap, so their candidate set is exactly the
reference's: ``StepMetrics.exact_cert`` is identically 0 here. In the JAX
pallas tier the same field counts intervals cut by the kernel's static DMA
window or line cap and rows that drifted more than one cell within the frame
(its drift/clip certificate); a zero there means "equal to this tier's
candidate set". ``overflow`` counts particles dropped by the voxel capacity,
as in JAX.

The frame loop never waits for the device (no ``.item()``, ``.cpu()`` or
data-dependent shapes on the CUDA path); metrics stay on the device. Each
phase runs inside a profiler range named in ``FRAME_PHASES``
(``utils.profiling.span``: free when no profiler runs), which
``scripts/torch_frame_breakdown.py`` reads.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import SimConfig
from ..ops import sph_kernels, sph_math
from ..ops.frame import SortedFrame, build_frame
from ..params import PhysParams
from ..state import ParticleState, StepMetrics, make_state
from ..utils.profiling import span

StepFn = Callable[[ParticleState], tuple[ParticleState, StepMetrics]]
ParamStepFn = Callable[[ParticleState, PhysParams],
                       tuple[ParticleState, StepMetrics]]

NEIGHBORS = ("sorted",)
# the profiler ranges of one frame, in order; fused_substep opens once per
# substep
FRAME_PHASES = ("build_frame", "density", "pack_rows", "fused_substep",
                "unpack+metrics")
# JAX backends and modes not ported yet, with the ROADMAP.md item that
# ports them
_NOT_PORTED = {
    "brute": "queue A item 3 (oracle slice: ops/brute.py)",
    "slotted": "queue A item 8 (exact tiers: ops/cellops.py)",
    "gather": "queue A item 8 (exact tiers: ops/cellops.py)",
    "sites": "queue A item 9 (sites tier: ops/sites.py)",
    "pallas": "queue A item 5 (its port is neighbor='sorted')",
}


def _check_supported(cfg: SimConfig, neighbor: str, faithful: bool) -> None:
    if neighbor in _NOT_PORTED:
        raise NotImplementedError(
            f"neighbor={neighbor!r} is not ported to torch yet: ROADMAP.md "
            f"{_NOT_PORTED[neighbor]}; use neighbor='sorted'")
    if neighbor not in NEIGHBORS:
        raise ValueError(f"unknown neighbor backend {neighbor!r}")
    if not faithful:
        raise NotImplementedError(
            "faithful=False (per-substep rebuild) needs the unfused force "
            "kernel K3: ROADMAP.md queue A item 5 / queue B K3")
    if cfg.xsph != 0.0 or cfg.artificial_viscosity != 0.0:
        raise NotImplementedError(
            "xsph / artificial_viscosity are not ported yet: ROADMAP.md "
            "queue A item 7 (extensions)")


def integrate_substep(pos: torch.Tensor, vel: torch.Tensor,
                      f_fluid: torch.Tensor, p: PhysParams
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wall penalty + gravity + NaN guard + semi-implicit Euler + clamp.

    Transcribes VelPos.compute:107-157. Returns (pos', vel', nan_mask).
    """
    f_wall = sph_math.wall_force(pos, vel, p.h, p.stiffness, p.damping,
                                 p.mass)
    zero = torch.zeros_like(p.gravity_y)
    gravity = torch.stack([zero, p.gravity_y, zero])
    a = gravity + (f_fluid + f_wall) / p.mass

    # NaN trap (VelPos.compute:143-147): zero the acceleration AND the
    # velocity of any particle whose acceleration went NaN.
    nan_mask = torch.isnan(a).any(dim=-1)
    vel_new = torch.where(nan_mask[..., None], 0.0, vel + a * p.dt)
    pos_new = torch.clamp(pos + p.dt * vel_new, 0.0, 1.0)  # VelPos:153-154
    return pos_new, vel_new, nan_mask


def _metrics(vel: torch.Tensor, rho: torch.Tensor, nan_events: torch.Tensor,
             overflow: torch.Tensor, p: PhysParams) -> StepMetrics:
    speed2 = (vel * vel).sum(dim=-1)
    return StepMetrics(
        max_speed=torch.sqrt(speed2.max()),
        mean_density=rho.mean(),
        kinetic_energy=0.5 * p.mass * speed2.sum(),
        nan_events=nan_events.sum().to(torch.int32),
        overflow=overflow,
        exact_cert=torch.zeros((), dtype=torch.int32, device=vel.device),
    )


def _sorted_frame(frame: SortedFrame, pos_s: torch.Tensor,
                  vel_s: torch.Tensor, phys: PhysParams, cfg: SimConfig):
    """One frame in sorted space: density once, then the fused substeps.
    Returns (pos_s, vel_s, nan_hits_s, metrics)."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    with span("density"):
        rho_s = sph_kernels.density_pass(frame, pos_s, phys, r, cap)
    with span("pack_rows"):
        rows = sph_kernels.pack_rows(pos_s, vel_s, rho_s)
    for _ in range(cfg.substeps):
        with span("fused_substep"):
            rows = sph_kernels.fused_substep(frame, rows, phys, r, cap)
    with span("unpack+metrics"):
        pos_s, vel_s, _, nan_hits = sph_kernels.unpack_rows(rows)
        # matches grid.overflow_count: rank-overflow + out-of-range drops
        ovf = (~frame.occ).sum().to(torch.int32)
        m = _metrics(vel_s, rho_s, nan_hits, ovf, phys)
    return pos_s, vel_s, nan_hits, m


def _unsort(order: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(a)
    out[order.long()] = a
    return out


def make_param_step(cfg: SimConfig, *, neighbor: str = "sorted",
                    faithful: bool = True) -> ParamStepFn:
    """Build the per-frame step ``(state, phys) → (state, metrics)``.

    ``cfg`` contributes only structure (particle count, bucket resolution,
    voxel capacity, substep count); the physics scalars come from ``phys``.
    State comes in and goes out in the caller's particle order.
    """
    cfg = cfg.validate()
    _check_supported(cfg, neighbor, faithful)
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity

    def step(state: ParticleState, phys: PhysParams
             ) -> tuple[ParticleState, StepMetrics]:
        with span("build_frame"):
            frame, (pos_s, vel_s) = build_frame(
                state.pos, r, cap, extras=(state.pos, state.vel))
        pos_s, vel_s, nan_hits, m = _sorted_frame(frame, pos_s, vel_s, phys,
                                                  cfg)
        new_state = ParticleState(
            pos=_unsort(frame.order, pos_s), vel=_unsort(frame.order, vel_s),
            nan_count=state.nan_count + _unsort(frame.order, nan_hits))
        return new_state, m

    return step


def make_frame_step(cfg: SimConfig, *, neighbor: str = "sorted",
                    faithful: bool = True,
                    device: torch.device | str = "cpu") -> StepFn:
    """Single-scene step with the config's own physics on ``device``."""
    param_step = make_param_step(cfg, neighbor=neighbor, faithful=faithful)
    phys = PhysParams.from_config(cfg, device)
    return lambda state: param_step(state, phys)


def make_rollout(cfg: SimConfig, n_frames: int, *, neighbor: str = "sorted",
                 faithful: bool = True,
                 device: torch.device | str = "cpu"):
    """Build ``state → (state, metrics)`` over ``n_frames`` frames, with
    ``metrics`` a ``StepMetrics`` of per-frame tensors ``[n_frames]``.

    State stays in SORTED order across frames: the rollout carries the
    particle-id column ``pid`` and passes it to the sort as the tie-break,
    so capacity ranks stay keyed to original ids and the result is bit-equal
    to stepping frame by frame; it unsorts once at the end
    (``_make_pallas_rollout``, stepper.py:405-516 of the JAX package).
    """
    cfg = cfg.validate()
    _check_supported(cfg, neighbor, faithful)
    r, cap, n = cfg.bucket_resolution, cfg.voxel_capacity, cfg.n_particles
    phys = PhysParams.from_config(cfg, device)

    def rollout(state: ParticleState
                ) -> tuple[ParticleState, StepMetrics]:
        pos, vel, nan_count = state
        pid = torch.arange(n, dtype=torch.int32, device=pos.device)
        ms = []
        for _ in range(n_frames):
            with span("build_frame"):
                frame, (pos, vel, nan_count) = build_frame(
                    pos, r, cap, extras=(pos, vel, nan_count), gid=pid)
            pid = frame.order
            pos, vel, nan_hits, m = _sorted_frame(frame, pos, vel, phys, cfg)
            nan_count = nan_count + nan_hits
            ms.append(m)
        final = ParticleState(pos=_unsort(pid, pos), vel=_unsort(pid, vel),
                              nan_count=_unsort(pid, nan_count))
        metrics = StepMetrics(*(torch.stack(x) for x in zip(*ms))) \
            if ms else None
        return final, metrics

    return rollout


def initial_state(cfg: SimConfig,
                  device: torch.device | str = "cpu") -> ParticleState:
    """Spawn per the config preset with zero velocities
    (SphFluidSimulation.cs:157-190)."""
    from ..models.presets import init_positions
    return make_state(init_positions(cfg, device))
