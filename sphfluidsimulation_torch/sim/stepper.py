"""Frame stepper and rollout engine — the sorted-frame tier and the brute
oracle.

Counterpart of ``sphfluidsimulation_tpu/sim/stepper.py``: ``integrate_substep``
(:40-60), ``_metrics`` (:63-75), the brute branch of ``make_param_step``
(:87-207), ``_make_pallas_step`` in both modes (:269-393),
``_make_pallas_rollout`` (:405-516), ``make_frame_step``, ``make_rollout``
(:569-634) and ``initial_state``.

Each frame reproduces the reference pipeline (SphFluidSimulation.cs:96-108).
In faithful mode the neighbour structure and the density are computed ONCE
from the frame-start positions and reused by all five substeps, while each
substep reads fresh positions and velocities:

    build_frame (sort by anchor cell) → density (K1) → pack rows and pj
    → 5 × fused substep (K2) → metrics

``faithful=False`` is the physically corrected mode: every substep rebuilds
the frame and the density from the current state, runs the force kernel
(K3) and integrates on the host (``integrate_substep``), keeping the state in
the caller's order between substeps:

    5 × (build_frame → density (K1) → pack rows and pj → forces (K3)
         → integrate_substep → unsort)

plus one frame-start build and density for the overflow and density
metrics. ``cfg.xsph`` and ``cfg.artificial_viscosity`` turn on the extension
sums in K2 and K3 (and the XSPH correction of the position update).
K2, K3 and K5's force modes read pj (the j-side pressure and guarded
1/ρ), built once a frame (corrected mode: every substep); the kernels'
scalar block is built once a frame.

``tune=SortedTuning(compact=True)`` (the JAX ``pallas_tune``; by default
read from ``SPH_PALLAS_COMPACT``) takes the compact-lane route, K5
(``ops/compact.py``), for the density, the fused substep and the corrected
mode's forces without extensions; with extensions the corrected forces stay
on K3, as in JAX (pallas_sph.py:1720).

Backends: ``neighbor="sorted"``, the counterpart of the JAX ``"pallas"``
tier, and ``neighbor="brute"``, the O(N²) oracle (``ops/brute.py``,
``ops/extensions.py``), which is the oracle on the card, where there is no
JAX. K1-K3 walk ``start[]`` cell by cell with no static window and no
per-line cap, so their candidate set is exactly the reference's and
certifies nothing. ``StepMetrics.exact_cert`` sums the certificates of the
passes as JAX does (stepper.py:312, 390, 479): identically 0 on the K1-K3
route, and on the K5 route the rows of each substep whose fresh cell
drifted past their tile's band (``compact.fresh_spans``). In the JAX pallas
tier the same field also counts intervals cut by the kernel's static DMA
window or line cap, which the port has no counterpart of. ``overflow``
counts particles dropped by the voxel capacity, as in JAX.

The sorted frame loop never waits for the device (no ``.item()``, ``.cpu()``
or data-dependent shapes on the CUDA path); metrics stay on the device. Each
phase runs inside a profiler range named in ``FRAME_PHASES`` or
``CORRECTED_PHASES`` (``utils.profiling.span``: free when no profiler runs),
which ``scripts/torch_frame_breakdown.py`` reads.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import SimConfig
from ..ops import brute, compact, extensions, grid, sph_kernels, sph_math
from ..ops.frame import SortedFrame, build_frame
from ..ops.sph_kernels import SortedTuning, default_tuning
from ..params import PhysParams
from ..state import ParticleState, StepMetrics, make_state
from ..utils.profiling import span

StepFn = Callable[[ParticleState], tuple[ParticleState, StepMetrics]]
ParamStepFn = Callable[[ParticleState, PhysParams],
                       tuple[ParticleState, StepMetrics]]

NEIGHBORS = ("sorted", "brute")
# the profiler ranges of one sorted frame, in order: faithful mode
# (fused_substep opens once per substep) and corrected mode (the ranges
# from build_frame to integrate+unsort open once per substep, after one
# frame-start build_frame and density)
FRAME_PHASES = ("build_frame", "density", "pack_rows", "fused_substep",
                "unpack+metrics")
CORRECTED_PHASES = ("build_frame", "density", "pack_rows", "forces",
                    "integrate+unsort", "metrics")
# JAX backends not ported yet, with the ROADMAP.md item that ports them
_NOT_PORTED = {
    "slotted": "queue A item 8 (exact tiers: ops/cellops.py)",
    "gather": "queue A item 8 (exact tiers: ops/cellops.py)",
    "sites": "queue A item 9 (sites tier: ops/sites.py)",
    "pallas": "queue A item 5 (its port is neighbor='sorted')",
}


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The entry points' device: None is the card. Without a card a CUDA
    device raises: the port never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for the CPU with device='cpu'")
    return dev


def _check_supported(neighbor: str) -> None:
    if neighbor in _NOT_PORTED:
        raise NotImplementedError(
            f"neighbor={neighbor!r} is not ported to torch yet: ROADMAP.md "
            f"{_NOT_PORTED[neighbor]}; use neighbor='sorted' or 'brute'")
    if neighbor not in NEIGHBORS:
        raise ValueError(f"unknown neighbor backend {neighbor!r}")


def integrate_substep(pos: torch.Tensor, vel: torch.Tensor,
                      f_fluid: torch.Tensor, p: PhysParams,
                      xsph_dv: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wall penalty + gravity + NaN guard + semi-implicit Euler + clamp.

    Transcribes VelPos.compute:107-157. ``xsph_dv`` (optional) is the XSPH
    advection-velocity correction, applied to the position update only,
    after the NaN trap: a trapped particle still moves by dt·dv.
    Returns (pos', vel', nan_mask).
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
    adv = vel_new if xsph_dv is None else vel_new + xsph_dv
    pos_new = torch.clamp(pos + p.dt * adv, 0.0, 1.0)  # VelPos:153-154
    return pos_new, vel_new, nan_mask


def _metrics(vel: torch.Tensor, rho: torch.Tensor, nan_events: torch.Tensor,
             overflow: torch.Tensor, p: PhysParams,
             exact_cert: torch.Tensor | None = None) -> StepMetrics:
    speed2 = (vel * vel).sum(dim=-1)
    if exact_cert is None:
        exact_cert = torch.zeros((), dtype=torch.int32, device=vel.device)
    return StepMetrics(
        max_speed=torch.sqrt(speed2.max()),
        mean_density=rho.mean(),
        kinetic_energy=0.5 * p.mass * speed2.sum(),
        nan_events=nan_events.sum().to(torch.int32),
        overflow=overflow,
        exact_cert=exact_cert,
    )


def _add_cert(cert: torch.Tensor | None, c: torch.Tensor) -> torch.Tensor:
    return c if cert is None else cert + c


def _density(frame: SortedFrame, pos_s: torch.Tensor, phys: PhysParams,
             cfg: SimConfig, tune: SortedTuning,
             scal: torch.Tensor | None = None) -> torch.Tensor:
    """ρ: K5 on the compact route, else K1 (each with the frame's capacity
    and scalar block ``scal``). K5's density certificate is 0 by
    construction (its spans are the stale ones), so it is not summed."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    if tune.compact:
        return compact.density_compact(frame, pos_s, phys, r, cap, scal)[0]
    return sph_kernels.density_pass(frame, pos_s, phys, r, cap, scal)


def _sorted_frame(frame: SortedFrame, pos_s: torch.Tensor,
                  vel_s: torch.Tensor, phys: PhysParams, cfg: SimConfig,
                  tune: SortedTuning):
    """One frame in sorted space: density once, then the fused substeps
    (K2, or K5 on the compact route). Returns (pos_s, vel_s, nan_hits_s,
    metrics)."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    xsph, alpha = cfg.xsph, cfg.artificial_viscosity
    # the scalar block of the frame's kernels, once a frame
    scal = sph_kernels.scal_block(phys, xsph, alpha)
    with span("density"):
        rho_s = _density(frame, pos_s, phys, cfg, tune, scal)
    cert = None
    with span("pack_rows"):
        rows = sph_kernels.pack_rows(pos_s, vel_s, rho_s)
        # the substeps' j-side columns, once a frame: rho is the
        # frame-start density of every substep
        pj = sph_kernels.pj_cols(rho_s, phys)
    for _ in range(cfg.substeps):
        with span("fused_substep"):
            if tune.compact:
                rows, c = compact.compact_substep(frame, rows, phys, r, cap,
                                                  xsph, alpha, pj, scal)
                cert = _add_cert(cert, c)
            else:
                rows = sph_kernels.fused_substep(frame, rows, phys, r, cap,
                                                 xsph, alpha, pj, scal)
    with span("unpack+metrics"):
        pos_s, vel_s, _, nan_hits = sph_kernels.unpack_rows(rows)
        # matches grid.overflow_count: rank-overflow + out-of-range drops
        ovf = (~frame.occ).sum().to(torch.int32)
        m = _metrics(vel_s, rho_s, nan_hits, ovf, phys, cert)
    return pos_s, vel_s, nan_hits, m


def _unsort(order: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(a)
    out[order.long()] = a
    return out


def _sorted_step(cfg: SimConfig, tune: SortedTuning) -> ParamStepFn:
    """Faithful frame step on the sorted tier; state in caller order."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity

    def step(state: ParticleState, phys: PhysParams
             ) -> tuple[ParticleState, StepMetrics]:
        with span("build_frame"):
            frame, (pos_s, vel_s) = build_frame(
                state.pos, r, cap, extras=(state.pos, state.vel))
        pos_s, vel_s, nan_hits, m = _sorted_frame(frame, pos_s, vel_s, phys,
                                                  cfg, tune)
        new_state = ParticleState(
            pos=_unsort(frame.order, pos_s), vel=_unsort(frame.order, vel_s),
            nan_count=state.nan_count + _unsort(frame.order, nan_hits))
        return new_state, m

    return step


def _corrected_step(cfg: SimConfig, tune: SortedTuning) -> ParamStepFn:
    """Corrected frame step on the sorted tier (``_make_pallas_step``,
    faithful=False, stepper.py:289-337): every substep rebuilds the frame
    and the density, runs the forces and integrates, with the state in the
    caller's order between substeps. ``build_frame`` gets no ``gid``, so
    capacity ranks key to the caller's index. ``rho`` and ``overflow`` come
    from an extra frame-start build and density, as in JAX: a frame launches
    the density kernel 1 + substeps times and the forces kernel substeps
    times. On the compact route density and, without extensions, the forces
    are K5; the certificate sums the forces' drift counts."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    xsph, alpha = cfg.xsph, cfg.artificial_viscosity
    k5_forces = tune.compact and not sph_kernels.uses_extensions(xsph, alpha)

    def step(state: ParticleState, phys: PhysParams
             ) -> tuple[ParticleState, StepMetrics]:
        pos, vel = state.pos, state.vel
        # the scalar block of the frame's kernels, once a frame
        scal = sph_kernels.scal_block(phys)
        with span("build_frame"):
            frame0, (pos0_s,) = build_frame(pos, r, cap, extras=(pos,))
        with span("density"):
            rho0_s = _density(frame0, pos0_s, phys, cfg, tune, scal)
        nan_hits = torch.zeros_like(state.nan_count)
        cert = None
        for _ in range(cfg.substeps):
            with span("build_frame"):
                frame, (pos_s, vel_s) = build_frame(pos, r, cap,
                                                    extras=(pos, vel))
            with span("density"):
                rho_s = _density(frame, pos_s, phys, cfg, tune, scal)
            with span("pack_rows"):
                rows = sph_kernels.pack_rows(pos_s, vel_s, rho_s)
                pj = sph_kernels.pj_cols(rho_s, phys)
            with span("forces"):
                if k5_forces:
                    f, c = compact.forces_compact(frame, rows, phys, r, cap,
                                                  pj, scal)
                    dv, cert = None, _add_cert(cert, c)
                else:
                    f, dv = sph_kernels.forces_pass(frame, rows, phys, r, cap,
                                                    xsph, alpha, pj, scal)
            with span("integrate+unsort"):
                pos_s, vel_s, nan_mask = integrate_substep(pos_s, vel_s, f,
                                                           phys, dv)
                pos = _unsort(frame.order, pos_s)
                vel = _unsort(frame.order, vel_s)
                nan_hits = nan_hits + _unsort(frame.order,
                                              nan_mask.to(torch.int32))
        with span("metrics"):
            ovf = (~frame0.occ).sum().to(torch.int32)
            m = _metrics(vel, _unsort(frame0.order, rho0_s), nan_hits, ovf,
                         phys, cert)
        return ParticleState(pos=pos, vel=vel,
                             nan_count=state.nan_count + nan_hits), m

    return step


def _brute_step(cfg: SimConfig, faithful: bool) -> ParamStepFn:
    """Frame step on the O(N²) oracle (the brute branch of JAX
    ``make_param_step``, stepper.py:87-207): bucket and density from the
    frame start (every substep when not ``faithful``), all-pairs forces,
    the extension oracles over the brute window, which keeps the self pair
    (JAX ``_brute_pair_mask``)."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    xsph, alpha = cfg.xsph, cfg.artificial_viscosity

    def frame_aux(pos, phys):
        bucket, _ = grid.build_bucket(pos, r, cap)
        rho = brute.density_bruteforce(pos, bucket.cell_id, bucket.in_table,
                                       phys, r)
        return bucket, rho

    def forces(pos, vel, rho, bucket, phys):
        f = brute.fluid_forces_bruteforce(pos, vel, rho, bucket.cell_id,
                                          bucket.in_table, phys, r)
        if not sph_kernels.uses_extensions(xsph, alpha):
            return f, None
        pair_mask = brute.window_mask(sph_math.cell_index(pos, r),
                                      bucket.cell_id, bucket.in_table, r)
        if alpha != 0.0:
            f = f + extensions.artificial_viscosity_bruteforce(
                pos, vel, rho, pair_mask, phys, alpha)
        dv = (extensions.xsph_bruteforce(pos, vel, rho, pair_mask, phys, xsph)
              if xsph != 0.0 else None)
        return f, dv

    def step(state: ParticleState, phys: PhysParams
             ) -> tuple[ParticleState, StepMetrics]:
        pos, vel = state.pos, state.vel
        bucket, rho0 = frame_aux(pos, phys)
        ovf = grid.overflow_count(bucket)
        bucket_s, rho = bucket, rho0
        nan_hits = torch.zeros_like(state.nan_count)
        for _ in range(cfg.substeps):
            if not faithful:
                bucket_s, rho = frame_aux(pos, phys)
            f, dv = forces(pos, vel, rho, bucket_s, phys)
            pos, vel, nan_mask = integrate_substep(pos, vel, f, phys, dv)
            nan_hits = nan_hits + nan_mask.to(torch.int32)
        return (ParticleState(pos=pos, vel=vel,
                              nan_count=state.nan_count + nan_hits),
                _metrics(vel, rho0, nan_hits, ovf, phys))

    return step


def make_param_step(cfg: SimConfig, *, neighbor: str = "sorted",
                    faithful: bool = True,
                    tune: SortedTuning | None = None) -> ParamStepFn:
    """Build the per-frame step ``(state, phys) → (state, metrics)``.

    ``cfg`` contributes the structure (particle count, bucket resolution,
    voxel capacity, substep count) and the extension coefficients; the
    physics scalars come from ``phys``. State comes in and goes out in the
    caller's particle order; it runs on the device its tensors are on.

    neighbor: 'sorted' (the CUDA kernels on the card) or 'brute' (O(N²)
              oracle).
    faithful: reuse the frame-start bucket + density across all substeps
              (reference semantics); False rebuilds them every substep.
    tune:     the sorted tier's route (``SortedTuning``; None reads
              ``SPH_PALLAS_COMPACT``), the JAX ``pallas_tune``.
    """
    cfg = cfg.validate()
    _check_supported(neighbor)
    if neighbor == "brute":
        return _brute_step(cfg, faithful)
    tune = default_tuning() if tune is None else tune
    return _sorted_step(cfg, tune) if faithful else _corrected_step(cfg, tune)


def make_frame_step(cfg: SimConfig, *, neighbor: str = "sorted",
                    faithful: bool = True,
                    tune: SortedTuning | None = None,
                    device: torch.device | str | None = None) -> StepFn:
    """Single-scene step with the config's own physics on ``device`` (None:
    the card; without one it raises)."""
    device = resolve_device(device)
    param_step = make_param_step(cfg, neighbor=neighbor, faithful=faithful,
                                 tune=tune)
    phys = PhysParams.from_config(cfg, device)
    return lambda state: param_step(state, phys)


def _stack(ms: list[StepMetrics]) -> StepMetrics | None:
    return StepMetrics(*(torch.stack(x) for x in zip(*ms))) if ms else None


def make_rollout(cfg: SimConfig, n_frames: int, *, neighbor: str = "sorted",
                 faithful: bool = True, tune: SortedTuning | None = None,
                 device: torch.device | str | None = None):
    """Build ``state → (state, metrics)`` over ``n_frames`` frames, with
    ``metrics`` a ``StepMetrics`` of per-frame tensors ``[n_frames]``, on
    ``device`` (None: the card; without one it raises). ``tune`` selects the
    route as in :func:`make_param_step`.

    Faithful sorted rollouts keep the state in SORTED order across frames:
    the rollout carries the particle-id column ``pid`` and passes it to the
    sort as the tie-break, so capacity ranks stay keyed to original ids and
    the result is bit-equal to stepping frame by frame; it unsorts once at
    the end (``_make_pallas_rollout``, stepper.py:405-516 of the JAX
    package). Every other rollout loops over the frame step
    (stepper.py:610-634).
    """
    cfg = cfg.validate()
    _check_supported(neighbor)
    device = resolve_device(device)
    tune = default_tuning() if tune is None else tune
    if neighbor != "sorted" or not faithful:
        step = make_frame_step(cfg, neighbor=neighbor, faithful=faithful,
                               tune=tune, device=device)

        def loop(state: ParticleState
                 ) -> tuple[ParticleState, StepMetrics]:
            ms = []
            for _ in range(n_frames):
                state, m = step(state)
                ms.append(m)
            return state, _stack(ms)

        return loop

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
            pos, vel, nan_hits, m = _sorted_frame(frame, pos, vel, phys, cfg,
                                                  tune)
            nan_count = nan_count + nan_hits
            ms.append(m)
        final = ParticleState(pos=_unsort(pid, pos), vel=_unsort(pid, vel),
                              nan_count=_unsort(pid, nan_count))
        return final, _stack(ms)

    return rollout


def initial_state(cfg: SimConfig,
                  device: torch.device | str | None = None) -> ParticleState:
    """Spawn per the config preset with zero velocities
    (SphFluidSimulation.cs:157-190), on ``device`` (None: the card; without
    one it raises)."""
    from ..models.presets import init_positions
    return make_state(init_positions(cfg, resolve_device(device)))
