"""Row-sharded domain step over the slab axis (all-gather neighbours).

Counterpart of ``sphfluidsimulation_tpu/parallel/domain.py``: each shard of a
ring (``parallel/ring.py``) owns a contiguous block of N/D particle rows,
computes their density, forces and integration, and sees the candidate
neighbours through an all-gather of the source arrays:

* 1 × gather(pos) at the frame start: the bucket and the density pass;
* 1 × gather(ρ): the stale density every substep reuses;
* substeps × gather(pos), gather(vel): the fresh state of the forces.

The bucket (``grid.build_bucket``) is built on every shard from the gathered
positions, and the rows go through the gather tier's row functions
(``ops/cellops.py``: ``density_grid_rows``, ``fluid_forces_grid_rows``), plain
PyTorch, so a frame is the single-device gather tier's frame row block by
row block. Semantics are always faithful, without the extension sums, as in
JAX (:48-98). Metrics are reduced over the ring (pmax, pmean, psum);
``overflow`` is the replicated bucket's.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..ops import cellops, grid
from ..params import PhysParams
from ..sim.stepper import integrate_substep, resolve_device
from ..state import ParticleState, StepMetrics
from .batch import over_scenes
from .ring import Ring, ShardStep


def shard_state(state: ParticleState, ring: Ring) -> ParticleState:
    """The rows of the shards held here: all of them on a ``LocalRing``,
    the rank's block of N/D on a ``DistRing`` (JAX ``shard_state``, :41-45,
    places the state sharded over its N axis)."""
    rows = state.pos.shape[0] // ring.d
    lo, hi = ring.indices[0] * rows, (ring.indices[-1] + 1) * rows
    return ParticleState(*(t[lo:hi] for t in state))


def _local_step(cfg: SimConfig, ring: Ring):
    """A shard's frame step over its row block (JAX :48-98), a generator
    that yields its exchanges: ``(my, pos, vel, nan_count, phys)`` →
    ``(pos, vel, nan_count, metrics)``."""
    r = cfg.bucket_resolution
    cap = cfg.voxel_capacity if cfg.voxel_capacity is not None else 32

    def step(my: int, pos_sh, vel_sh, nan_sh, phys: PhysParams) -> ShardStep:
        rows = pos_sh.shape[0]
        ids = my * rows + torch.arange(rows, dtype=torch.int32,
                                       device=pos_sh.device)
        # -- frame start: bucket + stale density (SphFluidSimulation.cs:98-99)
        pos_all = yield ring.gather(pos_sh)
        bucket, _ = grid.build_bucket(pos_all, r, cap)
        rho_sh = cellops.density_grid_rows(pos_sh, bucket.cell[ids.long()],
                                           pos_all, bucket.table, cap, phys,
                                           r)
        rho_all = yield ring.gather(rho_sh)
        ovf = (~bucket.in_table).sum().to(torch.int32)     # replicated
        nan_hits = torch.zeros_like(nan_sh)
        for _ in range(cfg.substeps):
            pos_all = yield ring.gather(pos_sh)
            vel_all = yield ring.gather(vel_sh)
            f = cellops.fluid_forces_grid_rows(
                pos_sh, vel_sh, ids, rho_sh, pos_all, vel_all, rho_all,
                bucket.table, cap, phys, r)
            pos_sh, vel_sh, nan_mask = integrate_substep(pos_sh, vel_sh, f,
                                                         phys)
            nan_hits = nan_hits + nan_mask.to(torch.int32)
        # -- metrics (replicated scalars through the ring)
        speed2 = (vel_sh * vel_sh).sum(-1)
        max_sp2 = yield ring.pmax(speed2.max())
        mean_rho = yield ring.pmean(rho_sh.mean())
        ke = yield ring.psum(speed2.sum())
        nan_events = yield ring.psum(nan_hits.sum().to(torch.int32))
        m = StepMetrics(max_speed=torch.sqrt(max_sp2),
                        mean_density=mean_rho,
                        kinetic_energy=0.5 * phys.mass * ke,
                        nan_events=nan_events, overflow=ovf,
                        exact_cert=torch.zeros((), dtype=torch.int32,
                                               device=pos_sh.device))
        return pos_sh, vel_sh, nan_sh + nan_hits, m

    return step


def make_sharded_frame_step(cfg: SimConfig, ring: Ring, *,
                            device: torch.device | str | None = None):
    """Frame step over row-sharded state: ``(state, phys) → (state,
    metrics)`` (JAX :101-132). ``state`` holds the rows of the shards held
    here (``shard_state``; all N rows on a ``LocalRing``), on ``device``
    (None: the card; without one it raises); ``n_particles`` must divide by
    the shard count. Metrics are the same on every shard."""
    cfg = cfg.validate()
    device = resolve_device(device)
    if cfg.n_particles % ring.d:
        raise ValueError(f"n_particles {cfg.n_particles} not divisible by "
                         f"the ring's {ring.d} shards")
    local = _local_step(cfg, ring)
    rows = cfg.n_particles // ring.d

    def step(state: ParticleState, phys: PhysParams
             ) -> tuple[ParticleState, StepMetrics]:
        if state.pos.device.type != device.type:
            raise ValueError(f"state on {state.pos.device}; this step runs "
                             f"on {device}")
        n_held = len(ring.indices)
        if state.pos.shape[0] != n_held * rows:
            raise ValueError(f"state of {state.pos.shape[0]} rows; the ring "
                             f"holds {n_held} shards of {rows} rows here")
        outs = ring.run(local, [tuple(t[k * rows:(k + 1) * rows]
                                      for t in state) + (phys,)
                                for k in range(n_held)])
        return (ParticleState(*(torch.cat([o[k] for o in outs])
                                for k in range(3))), outs[0][3])

    return step


def make_batched_sharded_step(cfg: SimConfig, ring: Ring, *,
                              device: torch.device | str | None = None):
    """The 2-D step (JAX :135-169): scenes (data parallelism) × row shards
    over ``ring``. ``states`` are [B, N, ...] (each scene's rows held
    here), ``params`` stacked [B]; the scenes run one after another, each
    over the whole ring."""
    return over_scenes(make_sharded_frame_step(cfg, ring, device=device))
