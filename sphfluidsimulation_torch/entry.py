"""The entry points of the repo's ``__graft_entry__.py``, for torch.

``entry``            — the single-device frame step on the flagship scene's
                       structure and its example arguments, on the card by
                       default.
``dryrun_multichip`` — one 2-D (scenes × slabs) step of each decomposition
                       at tiny shapes, on ``LocalRing``: the sites tier's
                       slab step, the sorted tier's slab step and the
                       row-sharded domain step, with JAX's asserts.
"""

from __future__ import annotations

import torch

from .config import SimConfig
from .params import PhysParams, stack_params
from .parallel import domain, slab, slab_pallas
from .parallel.ring import LocalRing
from .sim.stepper import initial_state, make_param_step, resolve_device
from .state import stack_states


def _check(ok: bool, what: str) -> None:
    """JAX's asserts, kept under ``python -O``."""
    if not ok:
        raise AssertionError(what)


def entry(device: torch.device | str | None = None):
    """``(step, (state, phys))``: the frame step ``step(state, phys) →
    (state, metrics)`` and its example arguments on ``device`` (None: the
    card; without one it raises). The flagship scene's structure at a
    compile-check size, 65,536 particles and R = 31, as JAX's
    (``__graft_entry__.py:14-28``); the tier is the port's default,
    ``"sorted"`` (JAX's is ``"slotted"``)."""
    device = resolve_device(device)
    cfg = SimConfig(particle_number=65536, bucket_resolution=31)
    return make_param_step(cfg), (initial_state(cfg, device),
                                  PhysParams.from_config(cfg, device))


def dryrun_multichip(n_devices: int,
                     device: torch.device | str | None = None) -> None:
    """One 2-D parallel (scenes × slabs) frame of each decomposition on
    ``device`` (None: the card; without one it raises), JAX
    ``__graft_entry__.py:31-120``: 2 scenes of 1,024 particles, the slab
    axis a ``LocalRing`` of n_devices / 2 shards (n_devices when odd)."""
    device = resolve_device(device)
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    sp = n_devices // dp
    ring = LocalRing(sp)

    cfg = SimConfig(particle_number=1024, bucket_resolution=9,
                    site_capacity=24)
    scenes = [cfg.replace(rest_density=1.2), cfg.replace(rest_density=1.8)]
    states = [initial_state(c, device) for c in scenes]
    phys = stack_params([PhysParams.from_config(c, device) for c in scenes])

    # -- primary path: the sites tier's slab decomposition (per-shard
    # memory O(N/sp + halo), halo exchange + migration over the ring)
    step, spec = slab.make_batched_slab_step(cfg, ring, row_slack=6.0,
                                             device=device)
    ssts = [slab.distribute(s, cfg, spec) for s in states]
    sst, metrics = step(stack_states(ssts), phys)
    for i in range(2):
        out, lost = slab.collect(slab.SlabState(*(x[i] for x in sst)),
                                 cfg.n_particles)
        _check(lost == 0 and bool(torch.isfinite(out.pos).all()),
               f"sites slab step, scene {i}: {lost} rows lost or a "
               f"non-finite position")

    # -- throughput-tier path: the slab decomposition of the sorted tier
    pstep, pspec = slab_pallas.make_pallas_slab_step(cfg, ring,
                                                     row_slack=6.0,
                                                     device=device)
    psst = slab.distribute(states[0], cfg, pspec)
    psst, pm = pstep(psst, PhysParams.from_config(scenes[0], device))
    pout, plost = slab.collect(psst, cfg.n_particles)
    _check(plost == 0 and bool(torch.isfinite(pout.pos).all()),
           f"sorted slab step: {plost} rows lost or a non-finite position")

    # -- secondary path: the row-sharded all-gather domain step
    gstep = domain.make_batched_sharded_step(cfg, ring, device=device)
    new_state, _ = gstep(stack_states(states), phys)
    _check(new_state.pos.shape == (2, cfg.n_particles, 3)
           and bool(torch.isfinite(new_state.pos).all()),
           "domain step: wrong shape or a non-finite position")
    print(f"dryrun_multichip ok: mesh dp={dp} sp={sp} "
          f"(slab + pallas-slab + domain), "
          f"mean_rho={[round(float(r), 3) for r in metrics.mean_density]}, "
          f"pallas_cert={int(pm.exact_cert)}")
