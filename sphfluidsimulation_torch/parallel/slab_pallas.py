"""Slab decomposition composed with the sorted tier's kernels.

Counterpart of ``sphfluidsimulation_tpu/parallel/slab_pallas.py``: each shard
of the slab axis (``parallel/ring.py``) holds cell-sorted row buffers of its
owned z-slab plus halo rows, exchanges boundary particle rows with its two
neighbours, and runs the banded K1 and K2 (``ops/sph_kernels.py``,
``csrc/window_walk.cuh``), or on the compact route the banded K5
(``ops/compact.py``), on its local frame.

Decomposition (slab_pallas.py:15-30): ownership is keyed by the STALE anchor
cell's z-plane, so the rows a shard must see from its neighbours (their rows
whose stale z lies within ``halo`` planes of the boundary) are fixed for all
five substeps. A frame is:

- the migration ring (``slab._migrate``);
- the boundary-row exchange (positions, velocities, ids), keyed by stale z;
- the banded frame over the shard's ``z_span`` planes with ``gid = pid``,
  so owner and halo copies rank a shared cell's rows alike and the 32-slot
  capacity drop does not depend on the shard count;
- K1 (K5 density) once, then the owner's ρ overwrites the halo copies'
  (one exchange);
- ``pack_rows`` and ``pj_cols`` once;
- five × (K2 (the K5 substep) over the band, then the fresh (pos, vel) of
  the boundary rows sent to their halo copies, written into frame-constant
  sorted slots);
- the own rows unsorted back into the buffer; metrics summed over the ring.

Exactness (slab_pallas.py:32-39): an own row whose fresh window stays in the
band sees exactly the candidates it sees on one device. The certificate
``exact_cert`` counts what the band hides: per substep, the own valid rows
whose fresh 3-plane window leaves the band (a torch reduction over the
substep's input positions, so K2 stays the one kernel of every path), plus
the frame's ``clip_count``, the boundary rows the halo buffers dropped and
the migration's ``lost``; on the compact route also K5's drift count of
every live row, as JAX sums it (:205-216). Halo rows are integrated over truncated windows,
but the owner overwrites each of their values before anything reads it, so
their windows are not counted. This differs from JAX's tile-granular drift
count by design (ROADMAP.md queue C, "Certificates differ by design").

On the card with a ``LocalRing`` the whole frame, every shard's work and
every exchange, is recorded once as a CUDA graph and replayed once a call
(:class:`GraphSlabStep`): JAX jits the ``shard_map``, one dispatch a frame
(slab_pallas.py:251-278). ``host_loop=True`` drives the shards from
Python each call, its phases in the profiler ranges of ``SLAB_PHASES``;
a ``DistRing`` always does.

The step always takes the fused route (K2, or K5's fused substep on the
compact route, as JAX's ``density_pass`` and ``fused_substep`` route it,
pallas_sph.py:1694), as JAX does (:263-264); the variants of ``tune``
(``kahan``, ``bf16``, ``fuse_acc``) select the kernels' instances.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig
from ..ops import compact, sph_math
from ..ops import sph_kernels as sk
from ..ops.frame import SortedFrame, build_frame
from ..ops.sph_kernels import SortedTuning, default_tuning
from ..params import PhysParams
from ..sim import graph
from ..sim.stepper import resolve_device
from ..state import StepMetrics
from ..utils.profiling import span
from .ring import LocalRing, Ring, ShardStep
from .slab import (SlabSpec, SlabState, _migrate, _ring_step, _shards,
                   front)


# the profiler ranges of a shard's frame (the host loop's), in order; the
# migration's, the two exchanges' of each substep and the substep's own
# open more than once. No range holds an exchange, so the ranges of the
# shards that a LocalRing interleaves never overlap.
SLAB_PHASES = ("migrate", "boundary_exchange", "build_frame", "density",
               "rho_exchange", "pack_rows", "fused_substep",
               "fresh_row_exchange", "unpack+metrics")


class PallasSlabSpec(NamedTuple):
    d: int         # shards along the slab axis
    slab_z: int    # owned z-planes per shard (= ceil(R / D))
    halo: int      # boundary planes per side (>= 2: the force window)
    cap_rows: int  # per-shard particle row capacity C
    halo_cap: int  # boundary-row buffer capacity per side
    hops: int      # migration ring hops per direction
    z_span: int    # local band planes = slab_z + 2·halo

    @property
    def c_loc(self) -> int:
        return self.cap_rows + 2 * self.halo_cap


def make_pallas_spec(cfg: SimConfig, n_dev: int, *, halo: int = 2,
                     row_slack: float = 2.0, halo_slack: float = 4.0,
                     hops: int | None = None) -> PallasSlabSpec:
    """The JAX spec number for number (slab_pallas.py:72-88): capacities
    rounded up to 128 rows, since they decide what is dropped."""
    r = cfg.bucket_resolution
    slab_z = -(-r // n_dev)
    halo = min(halo, slab_z)
    if halo < 1:
        raise ValueError("halo must be >= 1")
    cap = -(-int(cfg.n_particles * row_slack) // n_dev)
    cap = ((cap + 127) // 128) * 128
    occ = cfg.n_particles / float(r ** 3)
    hcap = int(halo * r * r * occ * halo_slack) + 128
    hcap = min(((hcap + 127) // 128) * 128, cap)
    return PallasSlabSpec(d=n_dev, slab_z=slab_z, halo=halo, cap_rows=cap,
                          halo_cap=hcap,
                          hops=n_dev - 1 if hops is None else hops,
                          z_span=slab_z + 2 * halo)


def _gather_compact(mask: torch.Tensor, cap: int, *cols: torch.Tensor):
    """Front-compacts the rows where ``mask`` holds into [cap]-buffers.

    Returns (bufs…, idx, valid, dropped): ``idx`` are the source row indices
    (arbitrary rows for slots past the mask's population; ``valid`` marks
    the real ones), ``dropped`` i32[] counts mask rows beyond ``cap``.
    """
    idx = front(mask)[:cap]
    dropped = (mask.sum() - cap).clamp(min=0).to(torch.int32)
    return tuple(c0[idx] for c0 in cols) + (idx, mask[idx], dropped)


def _band_leaks(z: torch.Tensor, own: torch.Tensor, r: int,
                band: tuple[int, int]) -> torch.Tensor:
    """i32[]: the rows where ``own`` holds whose fresh window (the planes
    within 1 of the fresh cell's, in the grid) leaves the band."""
    zbase, z_span = band
    cz = sph_math.cell_index(z, r)
    lo = (cz - 1).clamp(min=0)
    hi = (cz + 1).clamp(max=r - 1)
    leak = (lo < zbase) | (hi > zbase + z_span - 1)
    return (own & leak).sum().to(torch.int32)


class ShardFrame(NamedTuple):
    """A shard's frame after the migration and the boundary-row exchange:
    what its K1 and K2 read, and how its local rows map to sorted slots.
    Local rows are the shard's own C rows, then the bottom and the top halo
    (``halo_cap`` rows each)."""

    band: tuple[int, int]      # (zbase, z_span)
    frame: SortedFrame         # banded, dead rows last
    pos_s: torch.Tensor        # f32[c_loc, 3] sorted
    vel_s: torch.Tensor        # f32[c_loc, 3] sorted
    nan_s: torch.Tensor        # i32[c_loc] sorted
    lidx_s: torch.Tensor       # i64[c_loc]: the local row of each slot
    inv: torch.Tensor          # i64[c_loc]: the slot of each local row
    own_s: torch.Tensor        # bool[c_loc]: the slot holds a valid own row
    dn_idx: torch.Tensor       # i64[halo_cap]: own rows sent down
    up_idx: torch.Tensor       # i64[halo_cap]: own rows sent up
    cert: torch.Tensor         # i32[]: clip_count + halo drops + lost


def _shard_frame(cfg: SimConfig, spec: PallasSlabSpec, ring: Ring, my: int,
                 pos, vel, nan_count, pid, valid) -> ShardStep:
    """The first half of shard ``my``'s step (a shard step: ``yield from``
    it): the migration ring, the boundary-row exchange and the banded
    frame. Returns (``ShardFrame``, (pos, vel, nan_count, pid, valid)), the
    latter the shard's own rows after the migration."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    hc, c_loc = spec.halo_cap, spec.c_loc
    dev = pos.device
    band = (my * spec.slab_z - spec.halo, spec.z_span)

    # -- frame boundary: deliver every particle to its owner slab
    mig_spec = SlabSpec(d=spec.d, slab_z=spec.slab_z, halo=spec.halo,
                        cap_rows=spec.cap_rows, hops=spec.hops)
    with span("migrate"):
        frows = torch.cat([pos, vel], 1)
        irows = torch.stack([nan_count, pid], 1)
    frows, irows, valid, lost = yield from _migrate(frows, irows, valid, my,
                                                    r, mig_spec, ring)

    # -- boundary-row exchange (frame-stable sets, keyed by stale z)
    with span("boundary_exchange"):
        pos, vel = frows[:, 0:3], frows[:, 3:6]
        nan_count, pid = irows[:, 0], irows[:, 1]
        az = sph_math.cell_index(pos[:, 2], r).clamp(0, r - 1)
        own_lo = my * spec.slab_z
        bnd_dn = valid & (az < own_lo + spec.halo)
        bnd_up = valid & (az >= own_lo + spec.slab_z - spec.halo)
        dn_f, dn_pid, dn_idx, dn_valid, dn_drop = _gather_compact(
            bnd_dn, hc, frows, pid)
        up_f, up_pid, up_idx, up_valid, up_drop = _gather_compact(
            bnd_up, hc, frows, pid)
    # my bottom halo = the slab below's top boundary rows (sent up);
    # my top halo = the slab above's bottom boundary rows (sent down)
    hb_f = yield ring.up(up_f)
    hb_pid = yield ring.up(up_pid)
    hb_valid = yield ring.up(up_valid)
    ht_f = yield ring.down(dn_f)
    ht_pid = yield ring.down(dn_pid)
    ht_valid = yield ring.down(dn_valid)

    with span("build_frame"):
        pos_l = torch.cat([pos, hb_f[:, 0:3], ht_f[:, 0:3]])
        vel_l = torch.cat([vel, hb_f[:, 3:6], ht_f[:, 3:6]])
        pid_l = torch.cat([pid, hb_pid, ht_pid])
        nan_l = torch.cat([nan_count, nan_count.new_zeros(2 * hc)])
        valid_l = torch.cat([valid, hb_valid, ht_valid])
        lidx = torch.arange(c_loc, dtype=torch.int32, device=dev)

        # -- the banded frame; gid = pid ranks a shared cell's rows alike
        # on owner and halo, so the capacity drop (Bucket.compute:30-35)
        # does not depend on the shard count
        frame, (pos_s, vel_s, nan_s, lidx_s) = build_frame(
            pos_l, r, cap, extras=(pos_l, vel_l, nan_l, lidx), gid=pid_l,
            n_ids=cfg.n_particles, band=band, valid=valid_l)
        lidx_s = lidx_s.long()
        inv = torch.empty_like(lidx_s)
        inv[lidx_s] = torch.arange(c_loc, device=dev)
        own_s = (lidx_s < spec.cap_rows) & valid_l[lidx_s]
        sf = ShardFrame(band=band, frame=frame, pos_s=pos_s, vel_s=vel_s,
                        nan_s=nan_s, lidx_s=lidx_s, inv=inv, own_s=own_s,
                        dn_idx=dn_idx, up_idx=up_idx,
                        cert=frame.clip_count + lost + dn_drop + up_drop)
    return sf, (pos, vel, nan_count, pid, valid)


def _local_step(cfg: SimConfig, spec: PallasSlabSpec, ring: Ring,
                tune: SortedTuning):
    """The step of one shard, a generator that yields its exchanges
    (``parallel/ring.py``): ``(my, pos, vel, nan_count, pid, valid, phys)``
    → ``(pos, vel, nan_count, pid, valid, metrics)``. ``tune`` is fused.
    Its work between the exchanges runs in the ranges of ``SLAB_PHASES``."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    xsph, alpha = cfg.xsph, cfg.artificial_viscosity
    c0, hc = spec.cap_rows, spec.halo_cap

    def step(my: int, pos, vel, nan_count, pid, valid,
             phys: PhysParams) -> ShardStep:
        sf, (pos, vel, nan_count, pid, valid) = yield from _shard_frame(
            cfg, spec, ring, my, pos, vel, nan_count, pid, valid)
        frame, band, inv, lidx_s = sf.frame, sf.band, sf.inv, sf.lidx_s

        # -- the stale density, once a frame; the halo rows' own estimate
        # is edge-truncated, so the owner's value overwrites it
        with span("density"):
            scal = sk.scal_block(phys, xsph, alpha)
            if tune.compact:
                rho_s, _ = compact.density_compact(frame, sf.pos_s, phys, r,
                                                   cap, scal, band)
            else:
                rho_s = sk.density_pass(frame, sf.pos_s, phys, r, cap, scal,
                                        band, tune)
        with span("rho_exchange"):
            rho_l = rho_s[inv]
            up_rho, dn_rho = rho_l[sf.up_idx], rho_l[sf.dn_idx]
        hb_rho = yield ring.up(up_rho)
        ht_rho = yield ring.down(dn_rho)
        with span("rho_exchange"):
            rho_l = torch.cat([rho_l[:c0], hb_rho, ht_rho])
            rho_s = rho_l[lidx_s]

        with span("pack_rows"):
            rows = sk.pack_rows(sf.pos_s, sf.vel_s, rho_s,
                                sf.nan_s.to(torch.float32))
            pj = sk.pj_cols(rho_s, phys)
            # frame-constant sorted slots of the exchanged rows
            dn_spos, up_spos = inv[sf.dn_idx], inv[sf.up_idx]
            hb_spos, ht_spos = inv[c0:c0 + hc], inv[c0 + hc:]

        cert = sf.cert
        for _ in range(cfg.substeps):
            with span("fused_substep"):
                cert = cert + _band_leaks(rows[:, 2], sf.own_s, r, band)
                if tune.compact:
                    rows, drift = compact.compact_substep(
                        frame, rows, phys, r, cap, xsph, alpha, pj, scal,
                        band, tune)
                    cert = cert + drift
                else:
                    rows = sk.fused_substep(frame, rows, phys, r, cap, xsph,
                                            alpha, pj, scal, band, tune)
            # the owners' fresh values for the halo copies, which the next
            # substep reads through the frame's stale candidate structure
            with span("fresh_row_exchange"):
                up_new, dn_new = rows[up_spos, 0:6], rows[dn_spos, 0:6]
            hb_new = yield ring.up(up_new)
            ht_new = yield ring.down(dn_new)
            with span("fresh_row_exchange"):
                rows[hb_spos, 0:6] = hb_new
                rows[ht_spos, 0:6] = ht_new

        with span("unpack+metrics"):
            # -- frame end: sorted rows → local row order, own rows only
            back = rows[inv[:c0]]
            pos_n = torch.where(valid[:, None], back[:, 0:3], pos)
            vel_n = torch.where(valid[:, None], back[:, 3:6], vel)
            nan_hits = torch.where(valid,
                                   back[:, 7].to(torch.int32) - nan_count, 0)
            nan_n = nan_count + nan_hits
            # -- metrics over own valid rows, the same on every shard
            speed2 = torch.where(valid, (vel_n * vel_n).sum(-1), 0.0)
            ovf = (valid & ~frame.occ[inv[:c0]]).sum().to(torch.int32)
            own = (valid.sum().to(torch.float32), speed2.max(),
                   torch.where(valid, rho_l[:c0], 0.0).sum(), speed2.sum(),
                   nan_hits.sum().to(torch.int32))
        n_valid = yield ring.psum(own[0])
        max_sp2 = yield ring.pmax(own[1])
        rho_sum = yield ring.psum(own[2])
        ke = yield ring.psum(own[3])
        nan_events = yield ring.psum(own[4])
        overflow = yield ring.psum(ovf)
        exact_cert = yield ring.psum(cert)
        with span("unpack+metrics"):
            m = StepMetrics(max_speed=torch.sqrt(max_sp2),
                            mean_density=rho_sum / n_valid.clamp(min=1.0),
                            kinetic_energy=0.5 * phys.mass * ke,
                            nan_events=nan_events, overflow=overflow,
                            exact_cert=exact_cert)
        return pos_n, vel_n, nan_n, pid, valid, m

    return step


def shard_frames(cfg: SimConfig, spec: PallasSlabSpec, ring: Ring,
                 st: SlabState) -> list[ShardFrame]:
    """The ``ShardFrame`` of each shard held here, as a step of ``st``
    builds it before its K1 launch (the migration and the exchange run
    first; ``st`` is not changed). It shows what the banded kernels read,
    for checks and timings."""
    cfg = cfg.validate()
    outs = ring.run(lambda my, *a: _shard_frame(cfg, spec, ring, my, *a),
                    _shards(st, len(ring.indices), spec.cap_rows))
    return [o[0] for o in outs]


def choose_host_loop(ring: Ring, device: torch.device,
                     host_loop: bool | None) -> bool:
    """Whether the slab step runs its shards from the host, with
    ``sim.graph.choose_host_loop``'s meaning of ``host_loop``: None records
    the frame on the card with a ``LocalRing`` and loops on the host
    otherwise; False asks for the recorded frame and raises on the CPU and,
    as ``NotImplementedError``, with a ``DistRing``."""
    local = isinstance(ring, LocalRing)
    if host_loop is False and not local:
        raise NotImplementedError(
            "the slab step over a DistRing runs only as a host loop: "
            "recording it needs NCCL capture, one card a rank (ROADMAP.md "
            "A15); pass host_loop=True or None")
    return graph.choose_host_loop("sorted", device, host_loop) or not local


class GraphSlabStep:
    """The slab step on a ``LocalRing`` as one recorded frame on the card,
    the port's form of JAX's jitted ``shard_map``: ``step(st, phys)``
    copies the state and the physics into its carry (``graph.StepCarry``),
    replays the frame (``graph.RecordedStep``: every shard's migration,
    exchanges, banded kernels and metrics, recorded at the first call after
    one eager warm-up) and returns fresh tensors. The frame is the host
    loop's step over the carry (``graph.step_body``), so its result is the
    host loop's bit for bit; on the CPU ``advance`` runs it eagerly."""

    host_loop = False

    def __init__(self, step, rows: int, device: torch.device):
        self.device = device
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.carry = graph.StepCarry(
            SlabState(torch.zeros(rows, 3, **f32),
                      torch.zeros(rows, 3, **f32), torch.zeros(rows, **i32),
                      torch.zeros(rows, **i32),
                      torch.zeros(rows, dtype=torch.bool, device=device)),
            PhysParams(*(torch.zeros((), **f32) for _ in PhysParams._fields)),
            graph.metric_lanes((), device))
        self.advance = graph.step_body(step)
        self._recorded = graph.RecordedStep(self.advance, self.carry, device)

    def load(self, st: SlabState, phys: PhysParams) -> None:
        """The caller's state and physics into the carry (JAX traces
        ``phys``: another ``dt`` or viscosity takes effect)."""
        if st.pos.device.type != self.device.type:
            raise ValueError(f"slab state on {st.pos.device}; this step "
                             f"runs on {self.device}")
        for dst, src in zip((*self.carry.state, *self.carry.phys),
                            (*st, *phys)):
            if src.shape != dst.shape:
                raise ValueError(f"tensor of shape {tuple(src.shape)}; the "
                                 f"step holds {tuple(dst.shape)}")
            dst.copy_(src)

    def result(self) -> tuple[SlabState, StepMetrics]:
        """The carry's state and metrics as fresh tensors (the carry
        changes at the next replay)."""
        c = self.carry
        return (SlabState(*(x.clone() for x in c.state)),
                StepMetrics(*(x.clone() for x in c.metrics)))

    def __call__(self, st: SlabState, phys: PhysParams
                 ) -> tuple[SlabState, StepMetrics]:
        self.load(st, phys)
        self._recorded.replay()
        return self.result()


def make_pallas_slab_step(cfg: SimConfig, ring: Ring, *, halo: int = 2,
                          row_slack: float = 2.0, halo_slack: float = 4.0,
                          hops: int | None = None,
                          tune: SortedTuning | None = None,
                          device: torch.device | str | None = None,
                          host_loop: bool | None = None):
    """The faithful frame step of the sorted tier, decomposed into z-slabs
    over ``ring``: ``(SlabState, phys) → (SlabState, metrics)``, and its
    spec. Build the state with ``slab.distribute(state, cfg, spec)`` and
    read it back with ``slab.collect``; with a ``DistRing`` each process
    passes its own shard's C rows. Particle ids (``pid``) stay below
    ``cfg.n_particles``, as ``distribute`` gives them: the frame's sort key
    counts on it.

    The state must lie on ``device`` (None: the card; without one it
    raises). ``tune`` (None: the ``SPH_PALLAS_*`` variables) selects the
    route, K1 and K2 or K5 (``compact``), and the kernels' variants; like
    JAX (slab_pallas.py:263-264) the step always takes the fused route.

    ``host_loop`` has ``make_rollout``'s meaning, and the step's
    ``.host_loop`` attribute says which runs (:func:`choose_host_loop`):
    None (the default) replays one recorded frame a call on the card with
    a ``LocalRing`` (:class:`GraphSlabStep`, every route and variant), and
    drives the shards from the host on the CPU and with a ``DistRing``;
    True is the host loop, each phase in a profiler range of
    ``SLAB_PHASES``; False is the recorded frame, and raises where it
    cannot run. The launch counters after a replay equal the host loop's.
    """
    cfg = cfg.validate()
    tune = (default_tuning() if tune is None else tune)._replace(fused=True)
    device = resolve_device(device)
    loop = choose_host_loop(ring, device, host_loop)
    spec = make_pallas_spec(cfg, ring.d, halo=halo, row_slack=row_slack,
                            halo_slack=halo_slack, hops=hops)
    step = _ring_step(_local_step(cfg, spec, ring, tune), ring,
                      spec.cap_rows, device)
    if loop:
        step.host_loop = True
        return step, spec
    return GraphSlabStep(step, ring.d * spec.cap_rows, device), spec
