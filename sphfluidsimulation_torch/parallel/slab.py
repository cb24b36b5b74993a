"""Slab decomposition: row buffers, the migration ring, and the slab step
of the sites tier.

Counterpart of ``sphfluidsimulation_tpu/parallel/slab.py``: ``SlabState``
and ``SlabSpec`` (:62-82), ``make_spec`` (:84-93), ``_owner_of`` (:96-98),
the migration ring ``_migrate`` (:106-161, whose ``_compact`` is
the indexing ``rows[front(mask)]``), the slab-local
binding, i-sites and halo exchange (:169-302), the sharded frame step of the
sites tier ``_make_local_step``/``make_slab_step``/``make_batched_slab_step``
(:310-443), the host-side ``distribute`` and ``collect`` (:451-514) and
``make_slab_rollout`` (:517-533). The sorted tier's slab step
(``slab_pallas.py``) uses the row buffers and the migration ring too.

The unit cube is cut into z-slabs of the bucket grid, one per shard of the
slab axis (``parallel/ring.py``); a shard owns the particles whose stale
cell lies in its slab. Its rows live in a buffer of ``cap_rows`` rows: its
particles front-compacted, then dead rows. At each frame start the
migration ring delivers every row to its owner, ``hops`` hops in each
direction; rows that find no room are dropped and counted (``lost``).

The sites step (JAX :1-43): keyed by the STALE cell, a particle's
j-contribution stays on one shard for the whole frame, so each substep
needs a j-site build over the shard's own rows in a slab-local grid of
``(slab_z + 2·halo)·R²`` cells (``ops/sites.py``) and a halo exchange of
the ``halo`` boundary z-planes of the stacked j-fields with the two
neighbours (``ring.up``/``ring.down``). The i-side (fresh-cell windows)
covers drift of up to ``halo − 1`` planes past the slab; further drift and
out-of-cube spawns are clamped into the band and counted in
``exact_cert``, as JAX counts them. The shards of a ``LocalRing`` run one
after another on one device; no array of global size N or R³ appears in a
shard's step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SimConfig
from ..ops import grid, sites, sph_math
from ..params import PhysParams
from ..sim.stepper import integrate_substep, resolve_device
from ..state import ParticleState, StepMetrics, stack_states
from ..utils.profiling import span
from .batch import over_scenes
from .ring import Ring, ShardStep


class SlabState(NamedTuple):
    """Row-buffered particle state of D shards: shard d holds rows
    [d·C, (d+1)·C), its particles front-compacted, then dead padding (a
    process of a ``DistRing`` holds its own C rows)."""

    pos: torch.Tensor        # f32[D·C, 3]
    vel: torch.Tensor        # f32[D·C, 3]
    nan_count: torch.Tensor  # i32[D·C]
    pid: torch.Tensor        # i32[D·C] — global particle id
    valid: torch.Tensor      # bool[D·C]


class SlabSpec(NamedTuple):
    d: int        # shards along the slab axis
    slab_z: int   # owned z-planes per shard (= ceil(R / D))
    halo: int     # exchanged boundary planes per side
    cap_rows: int  # per-shard particle row capacity C
    hops: int     # migration ring hops per direction


def make_spec(cfg: SimConfig, n_dev: int, *, halo: int = 2,
              row_slack: float = 2.0, hops: int | None = None) -> SlabSpec:
    r = cfg.bucket_resolution
    slab_z = -(-r // n_dev)
    halo = min(halo, slab_z)
    if halo < 1:
        raise ValueError("halo must be >= 1")
    cap = -(-int(cfg.n_particles * row_slack) // n_dev)
    return SlabSpec(d=n_dev, slab_z=slab_z, halo=halo, cap_rows=cap,
                    hops=n_dev - 1 if hops is None else hops)


def _owner_of(pos_z: torch.Tensor, r: int, slab_z: int,
              d: int) -> torch.Tensor:
    """The shard that owns each row: its stale z-plane's slab."""
    z = sph_math.cell_index(pos_z, r).clamp(0, r - 1)
    return torch.div(z, slab_z, rounding_mode="floor").clamp(0, d - 1)


def front(mask: torch.Tensor) -> torch.Tensor:
    """The row order that puts the rows where ``mask`` holds first, each
    group in row order (a stable sort, as the JAX ``lax.sort`` with
    ``is_stable=True``)."""
    return torch.sort((~mask).to(torch.int32), stable=True).indices


def _migrate(frows: torch.Tensor, irows: torch.Tensor, valid: torch.Tensor,
             my: int, r: int, spec: SlabSpec,
             ring: Ring) -> ShardStep:
    """Delivers every valid row of shard ``my`` to its owner slab through
    ring hops (a shard step: ``yield from`` it). Its work between the
    exchanges runs in the profiler range ``migrate``.

    frows f32[C, Ff] (positions in columns 0:3), irows i32[C, Fi]. Returns
    (frows, irows, valid, lost): ``lost`` i32[] counts the rows dropped by
    the row capacity in flight plus the rows still stranded after all
    hops (none with hops = D − 1 and enough slack).
    """
    c = frows.shape[0]
    dev = frows.device
    iota = torch.arange(c, device=dev)
    lost = torch.zeros((), dtype=torch.int32, device=dev)
    if spec.d > 1:
        for dirn, send in ((1, ring.up), (-1, ring.down)):
            for _ in range(spec.hops):
                with span("migrate"):
                    own = _owner_of(frows[:, 2], r, spec.slab_z, spec.d)
                    want = valid & ((own - my) * dirn > 0)
                    # send buffer: the rows to send front-compacted
                    sorder = front(want)
                    sent = (frows[sorder], irows[sorder], want[sorder])
                rf = yield send(sent[0])
                ri = yield send(sent[1])
                rv = yield send(sent[2])      # edge shards: all False
                with span("migrate"):
                    # the rows kept front-compacted, the received appended
                    keep = valid & ~want
                    korder = front(keep)
                    n_keep = keep.sum()
                    ridx = torch.where(rv, n_keep + torch.cumsum(rv, 0) - 1,
                                       c)
                    ridx = ridx.clamp(max=c)  # row c: a scratch row, cut
                    mf = torch.cat([frows[korder], frows[:1]])
                    mi = torch.cat([irows[korder], irows[:1]])
                    mf[ridx] = rf
                    mi[ridx] = ri
                    n_tot = n_keep + rv.sum()
                    lost = lost + (n_tot - c).clamp(min=0).to(torch.int32)
                    frows, irows = mf[:c], mi[:c]
                    valid = iota < n_tot.clamp(max=c)
    with span("migrate"):
        own = _owner_of(frows[:, 2], r, spec.slab_z, spec.d)
        stranded = valid & (own != my)
        return (frows, irows, valid & ~stranded,
                lost + stranded.sum().to(torch.int32))


# ---------------------------------------------------------------------------
# slab-local binding / i-sites / halo exchange
# ---------------------------------------------------------------------------


def _bind_local_capped(pos, pid, valid, my: int, r: int, cap: int | None,
                       spec: SlabSpec):
    """The frame binding (``sites.frame_binding``) on one slab's rows, JAX
    :169-199. Capacity ranks are tie-broken by global particle id (rows
    arrive migration-permuted; pid order makes the reference's capacity
    drop independent of the shard count). Returns (lcid, member, in_cap,
    ovf): slab-local flat cell (sentinel S_loc for non-members), site
    membership, bucket membership, and the capacity/range drop count."""
    c = pos.shape[0]
    s_loc = (spec.slab_z + 2 * spec.halo) * r * r
    zbase = my * spec.slab_z - spec.halo
    cid = grid.flat_cell_id(sph_math.cell_index(pos, r), r)
    member = valid & (cid >= 0) & (cid < r * r * r)
    lcid = torch.where(member, cid - zbase * (r * r), s_loc)
    if cap is None:
        return lcid, member, member, (valid & ~member).sum().to(torch.int32)
    order = sites._lex_order([lcid, pid])
    rank_sorted = (torch.arange(c, dtype=torch.int32, device=pos.device)
                   - grid.run_starts(lcid[order]))
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    in_cap = member & (rank < cap)
    return lcid, member, in_cap, (valid & ~in_cap).sum().to(torch.int32)


def _build_i_local(pos, vel, rho, pid, valid, my: int, r: int, ki: int,
                   spec: SlabSpec, *, avisc: bool = False) -> sites.ISites:
    """Evaluation sites keyed by the fresh voxel, slab-local (JAX
    :202-245). Up to ``halo − 1`` z-planes of drift past the owned slab
    are covered exactly (the halo'd j-grid spans the radius-1 window of the
    whole band); further drift and out-of-cube spawn jitter are clamped
    into the band and certified."""
    c = pos.shape[0]
    zl, hw = spec.slab_z, spec.halo
    s_loc = (zl + 2 * hw) * r * r
    zbase = my * zl - hw
    cell = sph_math.cell_index(pos, r)
    cl = cell.clamp(0, r - 1)
    jitter = valid & (cell != cl).any(-1)
    lz = cl[:, 2] - zbase
    lz_c = lz.clamp(1, zl + 2 * hw - 2)
    drift = valid & (lz != lz_c)
    lcid = torch.where(valid, cl[:, 0] + cl[:, 1] * r + lz_c * (r * r),
                       s_loc)
    keys = [pos[:, 0], pos[:, 1], pos[:, 2]]
    if rho is not None:
        keys.append(rho)
    if avisc:
        keys += [vel[:, 0], vel[:, 1], vel[:, 2]]
    runs = sites._site_runs(keys, lcid, s_loc, ki, valid)
    slot_of = torch.empty_like(runs.slot)
    slot_of[runs.order] = runs.slot
    order = runs.order
    occ = sites._put(runs, torch.ones(c, dtype=torch.bool,
                                      device=pos.device), ki, s_loc, False)
    cert = ((valid & (slot_of >= ki * s_loc)).sum() + drift.sum()
            + jitter.sum()).to(torch.int32)
    return sites.ISites(
        pos=sites._put(runs, pos[order], ki, s_loc, sites.FAR),
        rho=None if rho is None else sites._put(runs, rho[order], ki, s_loc),
        vel=sites._put(runs, vel[order], ki, s_loc) if avisc else None,
        delta=torch.zeros((3, ki, s_loc), dtype=torch.int32,
                          device=pos.device),
        dmax=torch.zeros((), dtype=torch.int32, device=pos.device),
        slot_of=slot_of, cert=cert, occ=occ)


def _halo_exchange(jarrs: list[torch.Tensor], n_pos: int, r: int,
                   spec: SlabSpec, my: int, ring: Ring) -> ShardStep:
    """Replaces the halo z-planes of the stacked j-fields [K, S_loc] with
    the slab neighbours' boundary planes (two exchanges, up then down; a
    shard step: ``yield from`` it); the domain-edge halos get the empty
    fill (FAR for the first ``n_pos`` fields). JAX :248-275."""
    zl, hw, d = spec.slab_z, spec.halo, spec.d
    ks = [a.shape[0] for a in jarrs]
    x = torch.cat(jarrs, 0).reshape(-1, zl + 2 * hw, r * r)
    fill = torch.cat([torch.full((k, 1, 1), sites.FAR if f < n_pos else 0.0,
                                 dtype=torch.float32, device=x.device)
                      for f, k in enumerate(ks)], 0).expand(-1, hw, r * r)
    if d > 1:
        bot = yield ring.up(x[:, zl:zl + hw].contiguous())
        top = yield ring.down(x[:, hw:2 * hw].contiguous())
        bot = fill if my == 0 else bot
        top = fill if my == d - 1 else top
    else:
        bot = top = fill
    x = torch.cat([bot, x[:, hw:hw + zl], top], 1).reshape(
        -1, (zl + 2 * hw) * r * r)
    return list(torch.split(x, ks, 0))


def _exchange_j(j: sites.JSites, r: int, spec: SlabSpec, my: int,
                ring: Ring) -> ShardStep:
    """The halo exchange of every j-field of ``j`` (JAX :278-302)."""
    fields, arrs = [], []
    for name in ("pos", "a", "bp", "dv", "rho", "mult", "cv", "vsum", "vel"):
        v = getattr(j, name)
        if v is not None:
            fields.append((name, v.dim() == 3))
            arrs += list(v) if v.dim() == 3 else [v]
    # pos first: its three fields are the n_pos filled with FAR
    arrs = yield from _halo_exchange(arrs, 3, r, spec, my, ring)
    got, o = {}, 0
    for name, vec in fields:
        got[name] = torch.stack(arrs[o:o + 3]) if vec else arrs[o]
        o += 3 if vec else 1
    return j._replace(**got)


# ---------------------------------------------------------------------------
# the sharded frame step of the sites tier
# ---------------------------------------------------------------------------


def _make_local_step(cfg: SimConfig, spec: SlabSpec, ring: Ring):
    """A shard's faithful frame step (JAX :310-390), a generator that
    yields its exchanges: ``(my, pos, vel, nan_count, pid, valid, phys)``
    → ``(pos, vel, nan_count, pid, valid, metrics)``."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    kj = cfg.site_capacity
    ki = cfg.site_capacity_i or kj
    xsph, alpha = cfg.xsph, cfg.artificial_viscosity
    use_x, use_a = xsph != 0.0, alpha != 0.0
    s_loc = (spec.slab_z + 2 * spec.halo) * r * r

    def local_step(my: int, pos, vel, nan_count, pid, valid,
                   phys: PhysParams) -> ShardStep:
        zbase = my * spec.slab_z - spec.halo
        dens_pass = sites.make_density_pass(r, s_loc, 1, zbase=zbase)
        force_pass = sites.make_force_pass(r, s_loc, 1, xsph=xsph,
                                           alpha_visc=alpha, zbase=zbase)

        # -- frame boundary: deliver every particle to its owner slab
        frows, irows, valid, lost = yield from _migrate(
            torch.cat([pos, vel], 1), torch.stack([nan_count, pid], 1),
            valid, my, r, spec, ring)
        pos, vel = frows[:, 0:3], frows[:, 3:6]
        nan_count, pid = irows[:, 0], irows[:, 1]

        # -- frame binding + stale density (SphFluidSimulation.cs:98-100)
        lcid, member, in_cap, ovf = _bind_local_capped(pos, pid, valid, my,
                                                       r, cap, spec)
        j0 = sites.build_j_sites(lcid, in_cap, pos, None, None, r, kj, phys,
                                 grid_s=s_loc, member=member)
        j0 = yield from _exchange_j(j0, r, spec, my, ring)
        i0 = _build_i_local(pos, None, None, pid, valid, my, r, ki, spec)
        rho = sites._gather_site(i0, dens_pass(i0, j0, phys), 0.0)
        cert = i0.cert + j0.cert + lost

        nan_hits = torch.zeros_like(nan_count)
        for _ in range(cfg.substeps):
            j = sites.build_j_sites(lcid, in_cap, pos, vel, rho, r, kj,
                                    phys, grid_s=s_loc, member=member,
                                    xsph=use_x, avisc=use_a)
            j = yield from _exchange_j(j, r, spec, my, ring)
            i = _build_i_local(pos, vel if use_a else None, rho, pid, valid,
                               my, r, ki, spec, avisc=use_a)
            f, dv = sites._forces_of(i, force_pass(i, j, phys), vel, phys,
                                     xsph, alpha)
            f = torch.where(valid[:, None], f, 0.0)
            pos2, vel2, nan_mask = integrate_substep(pos, vel, f, phys, dv)
            pos = torch.where(valid[:, None], pos2, pos)
            vel = torch.where(valid[:, None], vel2, vel)
            nan_hits = nan_hits + (nan_mask & valid).to(torch.int32)
            cert = cert + i.cert + j.cert
        nan_count = nan_count + nan_hits

        # -- metrics (the same scalars on every shard)
        vmask = valid.to(torch.float32)
        speed2 = (vel * vel).sum(-1) * vmask
        n_valid = yield ring.psum(vmask.sum())
        max_sp2 = yield ring.pmax(speed2.max())
        rho_sum = yield ring.psum((rho * vmask).sum())
        ke = yield ring.psum(speed2.sum())
        nan_events = yield ring.psum(nan_hits.sum().to(torch.int32))
        overflow = yield ring.psum(ovf)
        exact_cert = yield ring.psum(cert)
        m = StepMetrics(max_speed=torch.sqrt(max_sp2),
                        mean_density=rho_sum / n_valid.clamp(min=1.0),
                        kinetic_energy=0.5 * phys.mass * ke,
                        nan_events=nan_events, overflow=overflow,
                        exact_cert=exact_cert)
        return pos, vel, nan_count, pid, valid, m

    return local_step


def _shards(st: SlabState, n_held: int, c: int) -> list[tuple]:
    """The rows of each shard held here, as the tuples a shard step takes."""
    if st.pos.shape[0] != n_held * c:
        raise ValueError(f"slab state of {st.pos.shape[0]} rows; the ring "
                         f"holds {n_held} shards of {c} rows here")
    return [tuple(t[k * c:(k + 1) * c] for t in st) for k in range(n_held)]


def _ring_step(local, ring: Ring, cap_rows: int, device: torch.device):
    """``(SlabState, phys) → (SlabState, metrics)`` of a shard step run
    over the shards the ring holds here."""
    n_held = len(ring.indices)

    def step(st: SlabState, phys: PhysParams
             ) -> tuple[SlabState, StepMetrics]:
        if st.pos.device.type != device.type:
            raise ValueError(f"slab state on {st.pos.device}; this step "
                             f"runs on {device}")
        outs = ring.run(local, [a + (phys,) for a in
                                _shards(st, n_held, cap_rows)])
        return (SlabState(*(torch.cat([o[k] for o in outs])
                            for k in range(5))), outs[0][5])

    return step


def make_slab_step(cfg: SimConfig, ring: Ring, *, halo: int = 2,
                   row_slack: float = 2.0, hops: int | None = None,
                   device: torch.device | str | None = None):
    """The faithful frame step of the sites tier decomposed into z-slabs
    over ``ring`` (JAX :393-417): ``(SlabState, phys) → (SlabState,
    metrics)``, and its spec. Build the state with :func:`distribute` and
    read it back with :func:`collect`; with a ``DistRing`` each process
    passes its own shard's C rows. The state must lie on ``device`` (None:
    the card; without one it raises)."""
    cfg = cfg.validate()
    device = resolve_device(device)
    spec = make_spec(cfg, ring.d, halo=halo, row_slack=row_slack, hops=hops)
    return (_ring_step(_make_local_step(cfg, spec, ring), ring,
                       spec.cap_rows, device), spec)


def make_batched_slab_step(cfg: SimConfig, ring: Ring, *, halo: int = 2,
                           row_slack: float = 2.0, hops: int | None = None,
                           device: torch.device | str | None = None):
    """The 2-D step (JAX :420-443): scenes × slabs. SlabState fields are
    [B, D·C, ...] and the params stacked [B]; each scene's step runs over
    the whole ring, one scene after another."""
    step, spec = make_slab_step(cfg, ring, halo=halo, row_slack=row_slack,
                                hops=hops, device=device)
    return over_scenes(step), spec


# ---------------------------------------------------------------------------
# host-side entry / exit
# ---------------------------------------------------------------------------


def distribute(state: ParticleState, cfg: SimConfig, spec) -> SlabState:
    """Global [N] state → slab row buffers, on the state's device (host-side
    numpy, as JAX's). ``spec`` is a ``SlabSpec`` or a ``PallasSlabSpec``.

    Raises if a slab's population exceeds the row capacity: pick a larger
    ``row_slack`` (while stepping, the counterpart is the certified
    ``lost`` count, never an exception).
    """
    r = cfg.bucket_resolution
    dev = state.pos.device
    pos = state.pos.detach().cpu().numpy()
    vel = state.vel.detach().cpu().numpy()
    nan = state.nan_count.detach().cpu().numpy()
    own = _owner_of(torch.from_numpy(pos[:, 2]), r, spec.slab_z,
                    spec.d).numpy()
    c = spec.cap_rows
    buf_pos = np.zeros((spec.d, c, 3), np.float32)
    buf_vel = np.zeros((spec.d, c, 3), np.float32)
    buf_nan = np.zeros((spec.d, c), np.int32)
    buf_pid = np.zeros((spec.d, c), np.int32)
    buf_valid = np.zeros((spec.d, c), bool)
    for d in range(spec.d):
        rows = np.nonzero(own == d)[0]
        if rows.size > c:
            raise ValueError(
                f"slab {d} holds {rows.size} particles > row capacity {c}; "
                f"increase row_slack")
        buf_pos[d, :rows.size] = pos[rows]
        buf_vel[d, :rows.size] = vel[rows]
        buf_nan[d, :rows.size] = nan[rows]
        buf_pid[d, :rows.size] = rows
        buf_valid[d, :rows.size] = True
    return SlabState(*(torch.from_numpy(a.reshape((spec.d * c,)
                                                  + a.shape[2:])).to(dev)
                       for a in (buf_pos, buf_vel, buf_nan, buf_pid,
                                 buf_valid)))


def collect(st: SlabState, n: int) -> tuple[ParticleState, int]:
    """Slab buffers → global state in particle-id order (host-side).

    Returns (state, n_lost), on the buffers' device; the rows of lost
    particles (certified drops) are zero.
    """
    dev = st.pos.device
    valid = st.valid.cpu().numpy()
    pid = st.pid.cpu().numpy()[valid]
    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    nan = np.zeros(n, np.int32)
    pos[pid] = st.pos.cpu().numpy()[valid]
    vel[pid] = st.vel.cpu().numpy()[valid]
    nan[pid] = st.nan_count.cpu().numpy()[valid]
    return (ParticleState(pos=torch.from_numpy(pos).to(dev),
                          vel=torch.from_numpy(vel).to(dev),
                          nan_count=torch.from_numpy(nan).to(dev)),
            n - pid.size)


def make_slab_rollout(cfg: SimConfig, ring: Ring, n_frames: int, *,
                      halo: int = 2, row_slack: float = 2.0,
                      hops: int | None = None,
                      device: torch.device | str | None = None):
    """``(SlabState, phys) → (SlabState, metrics [n_frames])`` over
    ``n_frames`` frames, and the spec (JAX :517-533, whose ``lax.scan`` is
    a host loop here)."""
    step, spec = make_slab_step(cfg, ring, halo=halo, row_slack=row_slack,
                                hops=hops, device=device)

    def rollout(st: SlabState, phys: PhysParams):
        ms = []
        for _ in range(n_frames):
            st, m = step(st, phys)
            ms.append(m)
        return st, stack_states(ms)

    return rollout, spec
