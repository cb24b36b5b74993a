"""Frame stepper and rollout engine — the sorted-frame tier, the exact
tiers and the brute oracle.

Counterpart of ``sphfluidsimulation_tpu/sim/stepper.py``: ``integrate_substep``
(:40-60), ``_metrics`` (:63-75), the brute, slotted and gather branches of
``make_param_step`` (:87-207), ``_make_sites_step`` (:210-266),
``_make_pallas_step`` in both modes
(:269-393), ``_make_pallas_rollout`` (:405-516), ``make_frame_step``,
``make_dt_rollout`` (:519-566), ``make_rollout`` (:569-634) and
``initial_state``. The sorted tier's rollouts run as a CUDA graph on the
card by default (``sim/graph.py``, JAX's one dispatch a rollout); this
module holds their host loops, JAX's ``host_loop=True``.

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
on K3, as in JAX (pallas_sph.py:1720). ``tune.fused=False``
(``SPH_PALLAS_FUSED=0``) is the unfused faithful route (JAX stepper.py:
361-376, :459-473): density once, then each substep the forces kernel (K3,
or K5's forces mode on the compact route without extensions) on the
frame-start ρ and ``integrate_substep``, all in sorted space:

    build_frame → density (K1) → pj → 5 × (pack rows → forces (K3)
         → integrate) → metrics

The other fields of ``tune`` (``kahan``, ``bf16``, ``fuse_acc``) select
each kernel's variant, and every kernel of a frame is launched in it.

Backends: ``neighbor="sorted"``, the counterpart of the JAX ``"pallas"``
tier (``"pallas"``, the JAX name, selects it too); the exact tiers
``"slotted"`` (the JAX package's default) and ``"gather"``
(``ops/cellops.py``, plain PyTorch over the voxel table); the site grids,
``"sites"`` (``ops/sites.py``, plain PyTorch, ``exact_cert`` the candidates
and sites beyond the site capacity); and
``neighbor="brute"``, the O(N²) oracle (``ops/brute.py``,
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
or data-dependent shapes on the CUDA path); metrics stay on the device, and
so a frame can be recorded as a CUDA graph. Each phase of the host loop runs
inside a profiler range named in ``FRAME_PHASES`` or ``CORRECTED_PHASES``
(``utils.profiling.span``: free when no profiler runs), which
``scripts/torch_frame_breakdown.py`` reads; a graph replay opens none.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import SimConfig
from ..ops import (brute, cellops, compact, extensions, grid, sites,
                   sph_kernels, sph_math)
from ..ops.frame import SortedFrame, build_frame
from ..ops.sph_kernels import SortedTuning, default_tuning
from ..params import PhysParams
from ..state import ParticleState, StepMetrics, make_state, stack_states
from ..utils.profiling import span

StepFn = Callable[[ParticleState], tuple[ParticleState, StepMetrics]]
ParamStepFn = Callable[[ParticleState, PhysParams],
                       tuple[ParticleState, StepMetrics]]

NEIGHBORS = ("sorted", "slotted", "gather", "brute", "sites")
# JAX backend names that the port runs under another name
_ALIASES = {"pallas": "sorted"}
# the profiler ranges of one sorted frame, in order: faithful mode
# (fused_substep opens once per substep; on the unfused route "forces" and
# "integrate" open once per substep in its place) and corrected mode (the
# ranges from build_frame to integrate+unsort open once per substep, after
# one frame-start build_frame and density)
FRAME_PHASES = ("build_frame", "density", "pack_rows", "fused_substep",
                "unpack+metrics")
CORRECTED_PHASES = ("build_frame", "density", "pack_rows", "forces",
                    "integrate+unsort", "metrics")


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The entry points' device: None is the card. Without a card a CUDA
    device raises: the port never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for the CPU with device='cpu'")
    return dev


def _check_supported(neighbor: str) -> str:
    """The port's name of backend ``neighbor``; raises for an unknown one."""
    neighbor = _ALIASES.get(neighbor, neighbor)
    if neighbor not in NEIGHBORS:
        raise ValueError(f"unknown neighbor backend {neighbor!r}")
    return neighbor


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
    return sph_kernels.density_pass(frame, pos_s, phys, r, cap, scal,
                                    tune=tune)


def _forces(frame: SortedFrame, rows: torch.Tensor, phys: PhysParams,
            cfg: SimConfig, tune: SortedTuning, pj: torch.Tensor,
            scal: torch.Tensor):
    """(force, XSPH dv or None, certificate or None) of the rows state:
    K5's forces mode on the compact route without extensions (its drift
    count the certificate), else K3 (``forces_pallas`` routes so,
    pallas_sph.py:1720-1725)."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    xsph, alpha = cfg.xsph, cfg.artificial_viscosity
    if tune.compact and not sph_kernels.uses_extensions(xsph, alpha):
        f, c = compact.forces_compact(frame, rows, phys, r, cap, pj, scal,
                                      tune)
        return f, None, c
    f, dv = sph_kernels.forces_pass(frame, rows, phys, r, cap, xsph, alpha,
                                    pj, scal, tune)
    return f, dv, None


def _sorted_frame(frame: SortedFrame, pos_s: torch.Tensor,
                  vel_s: torch.Tensor, phys: PhysParams, cfg: SimConfig,
                  tune: SortedTuning):
    """One frame in sorted space: density once, then the fused substeps
    (K2, or K5 on the compact route), or with ``tune.fused`` False the
    forces kernel and ``integrate_substep`` a substep. Returns (pos_s,
    vel_s, nan_hits_s, metrics)."""
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
    if not tune.fused:
        nan_hits = torch.zeros(rho_s.shape, dtype=torch.int32,
                               device=rho_s.device)
        for k in range(cfg.substeps):
            if k:
                with span("pack_rows"):
                    rows = sph_kernels.pack_rows(pos_s, vel_s, rho_s)
            with span("forces"):
                f, dv, c = _forces(frame, rows, phys, cfg, tune, pj, scal)
                if c is not None:
                    cert = _add_cert(cert, c)
            with span("integrate"):
                pos_s, vel_s, nan_mask = integrate_substep(pos_s, vel_s, f,
                                                           phys, dv)
                nan_hits = nan_hits + nan_mask.to(torch.int32)
    else:
        for _ in range(cfg.substeps):
            with span("fused_substep"):
                if tune.compact:
                    rows, c = compact.compact_substep(
                        frame, rows, phys, r, cap, xsph, alpha, pj, scal,
                        tune=tune)
                    cert = _add_cert(cert, c)
                else:
                    rows = sph_kernels.fused_substep(
                        frame, rows, phys, r, cap, xsph, alpha, pj, scal,
                        tune=tune)
    with span("unpack+metrics"):
        if tune.fused:
            pos_s, vel_s, _, nan_hits = sph_kernels.unpack_rows(rows)
        # matches grid.overflow_count: rank-overflow + out-of-range drops
        ovf = (~frame.occ).sum().to(torch.int32)
        m = _metrics(vel_s, rho_s, nan_hits, ovf, phys, cert)
    return pos_s, vel_s, nan_hits, m


def _carried_frame(state: ParticleState, pid: torch.Tensor,
                   phys: PhysParams, cfg: SimConfig, tune: SortedTuning):
    """One faithful frame of the rollout's sorted carry: ``state`` is in
    the order of the particle ids ``pid``, which key the sort's tie-break,
    so the frame is the per-frame step's bit for bit. Returns (state,
    pid, metrics), the state in the frame's sorted order."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    pos, vel, nan_count = state
    with span("build_frame"):
        frame, (pos, vel, nan_count) = build_frame(
            pos, r, cap, extras=(pos, vel, nan_count), gid=pid,
            n_ids=cfg.n_particles)
    pos, vel, nan_hits, m = _sorted_frame(frame, pos, vel, phys, cfg, tune)
    return ParticleState(pos, vel, nan_count + nan_hits), frame.order, m


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
                f, dv, c = _forces(frame, rows, phys, cfg, tune, pj, scal)
                if c is not None:
                    cert = _add_cert(cert, c)
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


def _table_step(cfg: SimConfig, neighbor: str, faithful: bool
                ) -> ParamStepFn:
    """Frame step over the voxel table: the brute, slotted and gather
    branches of JAX ``make_param_step`` (stepper.py:87-207). The bucket and
    the density come from the frame start (every substep when not
    ``faithful``); the slotted tier packs the slot rows with that density
    once a frame and repacks the positions and velocities each substep.
    Brute's extension oracles run over the brute window, which keeps the
    self pair (JAX ``_brute_pair_mask``)."""
    r, n, cap = cfg.bucket_resolution, cfg.n_particles, cfg.voxel_capacity
    xsph, alpha = cfg.xsph, cfg.artificial_viscosity
    if cap is None and neighbor != "brute":
        # the exact tiers hold static [R³, capacity] slot arrays: an
        # uncapped table would need capacity N (JAX stepper.py:110-119)
        raise ValueError(
            "voxel_capacity=None (no reference drop) is supported by the "
            "'brute' and 'sorted' backends only; pick a finite capacity "
            f"for neighbor={neighbor!r}")
    use_ext = sph_kernels.uses_extensions(xsph, alpha)
    if use_ext and neighbor == "gather":
        raise NotImplementedError(
            "xsph/artificial viscosity are implemented for the 'slotted', "
            "'sorted' and 'brute' backends")

    def frame_aux(pos, phys):
        """(bucket, packed slots or None, ρ) from the current positions."""
        bucket, _ = grid.build_bucket(pos, r, cap)
        if neighbor == "brute":
            return bucket, None, brute.density_bruteforce(
                pos, bucket.cell_id, bucket.in_table, phys, r)
        if neighbor == "gather":
            return bucket, None, cellops.density_grid(pos, bucket, cap, phys,
                                                      r)
        slots = cellops.pack_slots(bucket.table, cap, n, pos, None, None)
        rho = cellops.density_slotted_rows(pos, bucket.cell, slots, cap,
                                           phys, r)
        return bucket, cellops.pack_slots(bucket.table, cap, n, pos,
                                          torch.zeros_like(pos), rho), rho

    def forces(pos, vel, bucket, frame, rho, phys):
        """(force, XSPH dv or None) of the fresh state."""
        if neighbor == "gather":
            return cellops.fluid_forces_grid(pos, vel, rho, bucket, cap,
                                             phys, r), None
        if neighbor == "slotted":
            slots = cellops.repack_fresh(frame, bucket.table, cap, n, pos,
                                         vel)
            ids = torch.arange(n, dtype=torch.int32, device=pos.device)
            f = cellops.fluid_forces_slotted_rows(pos, vel, ids, rho, slots,
                                                  cap, phys, r)
            if alpha != 0.0:
                f = f + extensions.artificial_viscosity_slotted(
                    pos, vel, rho, slots, cap, phys, r, alpha)
            dv = (extensions.xsph_slotted(pos, vel, rho, slots, cap, phys, r,
                                          xsph)
                  if xsph != 0.0 else None)
            return f, dv
        f = brute.fluid_forces_bruteforce(pos, vel, rho, bucket.cell_id,
                                          bucket.in_table, phys, r)
        if not use_ext:
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
        aux = frame_aux(pos, phys)
        ovf = grid.overflow_count(aux[0])
        rho0 = aux[2]
        nan_hits = torch.zeros_like(state.nan_count)
        for _ in range(cfg.substeps):
            if not faithful:
                aux = frame_aux(pos, phys)
            f, dv = forces(pos, vel, *aux, phys)
            pos, vel, nan_mask = integrate_substep(pos, vel, f, phys, dv)
            nan_hits = nan_hits + nan_mask.to(torch.int32)
        return (ParticleState(pos=pos, vel=vel,
                              nan_count=state.nan_count + nan_hits),
                _metrics(vel, rho0, nan_hits, ovf, phys))

    return step


def _sites_step(cfg: SimConfig, faithful: bool) -> ParamStepFn:
    """Frame step on the site-grid tier (JAX ``_make_sites_step``,
    stepper.py:210-266), plain PyTorch (``ops/sites.py``): the frame
    binding (the stale bucket's membership) and the site-grid density once
    a frame, then five × (site-grid forces + ``integrate_substep``), all
    state in particle order; the grids are rebuilt every substep from fresh
    values, the reference's fresh reads through stale lists
    (VelPos.compute:57-58, 86-94). ``faithful=False`` rebuilds the binding
    and the density every substep. ``exact_cert`` counts candidates and
    sites dropped by the site capacity (``cfg.site_capacity``,
    ``site_capacity_i``); ``cfg.site_bands`` (0: ``sites.bands_for`` the
    state's device, each frame) runs the passes over z-bands,
    bit-identical to the one-piece pass."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    kj = cfg.site_capacity
    ki = cfg.site_capacity_i or kj
    xsph, alpha = cfg.xsph, cfg.artificial_viscosity

    def frame_aux(pos, phys, nb):
        stale_cid, in_cap, ovf = sites.frame_binding(pos, r, cap)
        rho, cert = sites.density_sites(pos, stale_cid, in_cap, phys, r, ki,
                                        kj, z_bands=nb)
        return stale_cid, in_cap, ovf, rho, cert

    def step(state: ParticleState, phys: PhysParams
             ) -> tuple[ParticleState, StepMetrics]:
        pos, vel = state.pos, state.vel
        nb = cfg.site_bands or sites.bands_for(r, cfg.n_particles, ki, kj,
                                               pos.device)
        stale_cid, in_cap, ovf, rho0, cert = frame_aux(pos, phys, nb)
        rho = rho0
        nan_hits = torch.zeros_like(state.nan_count)
        for _ in range(cfg.substeps):
            if not faithful:
                stale_cid, in_cap, _, rho, c = frame_aux(pos, phys, nb)
                cert = cert + c
            f, dv, c = sites.fluid_forces_sites(
                pos, vel, rho, stale_cid, in_cap, phys, r, ki, kj,
                xsph=xsph, alpha_visc=alpha, z_bands=nb)
            pos, vel, nan_mask = integrate_substep(pos, vel, f, phys, dv)
            nan_hits = nan_hits + nan_mask.to(torch.int32)
            cert = cert + c
        return (ParticleState(pos=pos, vel=vel,
                              nan_count=state.nan_count + nan_hits),
                _metrics(vel, rho0, nan_hits, ovf, phys, cert))

    return step


def make_param_step(cfg: SimConfig, *, neighbor: str = "sorted",
                    faithful: bool = True,
                    tune: SortedTuning | None = None) -> ParamStepFn:
    """Build the per-frame step ``(state, phys) → (state, metrics)``.

    ``cfg`` contributes the structure (particle count, bucket resolution,
    voxel capacity, substep count) and the extension coefficients; the
    physics scalars come from ``phys``. State comes in and goes out in the
    caller's particle order; it runs on the device its tensors are on.

    neighbor: 'sorted' (the CUDA kernels on the card; 'pallas', the JAX
              name, is the same tier), 'slotted' (packed slot rows, the
              JAX default), 'gather' (per-candidate gathers), 'sites'
              (the site grids) or 'brute' (O(N²) oracle).
    faithful: reuse the frame-start bucket + density across all substeps
              (reference semantics); False rebuilds them every substep.
    tune:     the sorted tier's route and variant (``SortedTuning``; None
              reads the ``SPH_PALLAS_*`` variables), the JAX
              ``pallas_tune``: with ``tune.fused`` False the faithful
              mode takes the unfused route.
    """
    cfg = cfg.validate()
    neighbor = _check_supported(neighbor)
    if neighbor == "sites":
        return _sites_step(cfg, faithful)
    if neighbor != "sorted":
        return _table_step(cfg, neighbor, faithful)
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
    return stack_states(ms) if ms else None


def _check_snapshots(n_frames: int, snapshot_every: int) -> None:
    if snapshot_every < 0 or (snapshot_every and n_frames % snapshot_every):
        raise ValueError("snapshot_every must be 0 or divide n_frames")


def _result(final: ParticleState, ms: list[StepMetrics],
            snaps: list[torch.Tensor], snapshot_every: int):
    """(final, metrics), and the stacked snapshots when they were asked
    for."""
    if not snapshot_every:
        return final, _stack(ms)
    return final, _stack(ms), (torch.stack(snaps) if snaps else
                               final.pos.new_zeros((0,) + final.pos.shape))


def _frame_loop(state: ParticleState, n_frames: int, snapshot_every: int,
                step: Callable[[ParticleState, int],
                               tuple[ParticleState, StepMetrics]]):
    """``step(state, f)`` for each frame f, with the positions of frames
    k−1, 2k−1, ... kept for ``snapshot_every`` = k > 0."""
    ms, snaps = [], []
    for f in range(n_frames):
        state, m = step(state, f)
        ms.append(m)
        if snapshot_every and (f + 1) % snapshot_every == 0:
            snaps.append(state.pos)
    return _result(state, ms, snaps, snapshot_every)


def make_dt_rollout(cfg: SimConfig, n_frames: int, *,
                    neighbor: str = "sorted", faithful: bool = True,
                    snapshot_every: int = 0,
                    tune: SortedTuning | None = None,
                    device: torch.device | str | None = None,
                    host_loop: bool | None = None):
    """Variable frame-dt rollout ``(state, dt_schedule) → (state, metrics[,
    snapshots])`` on ``device`` (None: the card; without one it raises).

    The reference's timestep depends on the frame rate: each substep
    advances ``Time.deltaTime / 25`` (SphFluidSimulation.cs:101-102), so
    replaying a recorded run needs a dt per frame, not the fixed
    ``frame_dt`` that :func:`make_rollout` bakes. ``dt_schedule`` holds
    ``n_frames`` FRAME deltas (Unity's ``Time.deltaTime``); frame f's
    substep dt is the float32 ``dt_schedule[f] / substep_divisor``, and the
    rest of the physics comes from the config. The result is bit-equal to
    stepping frame by frame through :func:`make_param_step` with
    ``phys._replace(dt=dt_f / divisor)``; on the sorted tier each frame is
    one density launch and five fused substeps. ``snapshot_every`` and
    ``host_loop`` are :func:`make_rollout`'s; the graph reads frame f's dt
    from a device copy of the schedule, filled before the first replay.
    """
    _check_snapshots(n_frames, snapshot_every)
    cfg = cfg.validate()
    neighbor = _check_supported(neighbor)
    device = resolve_device(device)
    from . import graph       # here: graph.py imports this module
    if not graph.choose_host_loop(neighbor, device, host_loop):
        return graph.GraphRollout(graph.FrameBody(
            cfg, n_frames, faithful=faithful, snapshot_every=snapshot_every,
            tune=default_tuning() if tune is None else tune, device=device,
            dt=True))
    param_step = make_param_step(cfg, neighbor=neighbor, faithful=faithful,
                                 tune=tune)
    base = PhysParams.from_config(cfg, device)
    div = torch.tensor(cfg.substep_divisor, dtype=torch.float32,
                       device=device)

    def rollout(state: ParticleState, dt_schedule):
        dts = torch.as_tensor(dt_schedule, dtype=torch.float32,
                              device=device).reshape(n_frames) / div
        return _frame_loop(
            state, n_frames, snapshot_every,
            lambda st, f: param_step(st, base._replace(dt=dts[f])))

    rollout.host_loop = True
    return rollout


def make_rollout(cfg: SimConfig, n_frames: int, *, neighbor: str = "sorted",
                 faithful: bool = True, snapshot_every: int = 0,
                 tune: SortedTuning | None = None,
                 device: torch.device | str | None = None,
                 host_loop: bool | None = None):
    """Build ``state → (state, metrics[, snapshots])`` over ``n_frames``
    frames, with ``metrics`` a ``StepMetrics`` of per-frame tensors
    ``[n_frames]``, on ``device`` (None: the card; without one it raises).
    ``tune`` selects the route as in :func:`make_param_step`.

    ``snapshot_every=k`` (k > 0) also returns the positions of every k-th
    frame (frames k−1, 2k−1, ... counted from 0), stacked as
    ``f32[n_frames // k, N, 3]``, in the caller's particle order; k must
    divide ``n_frames``; 0 returns no snapshots.

    ``host_loop`` chooses how the frames run, and the rollout's
    ``.host_loop`` attribute says which ran:
    - None (the default): the graph for the sorted tier on the card, in
      both modes, on every route and variant of ``tune``; the host loop
      for the other tiers and on the CPU;
    - False: the graph, JAX's one dispatch a rollout (``sim/graph.py``):
      the frame recorded once as a CUDA graph and replayed, bit for bit the
      host loop's result. It raises on the CPU and, as
      ``NotImplementedError``, on the slotted, gather, brute and sites
      tiers, whose rollouts loop on the host (ROADMAP.md A16);
    - True: a loop over frames on the host, each phase in its profiler
      range (``FRAME_PHASES``), JAX's ``run_bench(host_loop=True)``.

    Faithful sorted rollouts keep the state in SORTED order across frames:
    the rollout carries the particle-id column ``pid`` and passes it to the
    sort as the tie-break, so capacity ranks stay keyed to original ids and
    the result is bit-equal to stepping frame by frame; it unsorts once at
    the end and once for each snapshot (``_make_pallas_rollout``,
    stepper.py:405-516 of the JAX package). Every other rollout loops over
    the frame step (stepper.py:610-634). JAX refuses multi-frame rollouts
    of the banded sites step (stepper.py:588-605), whose ``lax.scan``
    faults the TPU worker; this rollout is a host loop and runs them, equal
    to stepping frame by frame. For a recorded dt per frame, see
    :func:`make_dt_rollout`.
    """
    _check_snapshots(n_frames, snapshot_every)
    cfg = cfg.validate()
    neighbor = _check_supported(neighbor)
    device = resolve_device(device)
    tune = default_tuning() if tune is None else tune
    from . import graph       # here: graph.py imports this module
    if not graph.choose_host_loop(neighbor, device, host_loop):
        return graph.GraphRollout(graph.FrameBody(
            cfg, n_frames, faithful=faithful, snapshot_every=snapshot_every,
            tune=tune, device=device))
    if neighbor != "sorted" or not faithful:
        step = make_frame_step(cfg, neighbor=neighbor, faithful=faithful,
                               tune=tune, device=device)

        def rollout(state: ParticleState):
            return _frame_loop(state, n_frames, snapshot_every,
                               lambda st, _: step(st))

        rollout.host_loop = True
        return rollout

    phys = PhysParams.from_config(cfg, device)

    def rollout(state: ParticleState):
        pid = torch.arange(cfg.n_particles, dtype=torch.int32,
                           device=state.pos.device)
        ms, snaps = [], []
        for f in range(n_frames):
            state, pid, m = _carried_frame(state, pid, phys, cfg, tune)
            ms.append(m)
            if snapshot_every and (f + 1) % snapshot_every == 0:
                snaps.append(_unsort(pid, state.pos))
        final = ParticleState(*(_unsort(pid, x) for x in state))
        return _result(final, ms, snaps, snapshot_every)

    rollout.host_loop = True
    return rollout


def initial_state(cfg: SimConfig,
                  device: torch.device | str | None = None) -> ParticleState:
    """Spawn per the config preset with zero velocities
    (SphFluidSimulation.cs:157-190), on ``device`` (None: the card; without
    one it raises)."""
    from ..models.presets import init_positions
    return make_state(init_positions(cfg, resolve_device(device)))
