"""Slab row buffers and the migration ring.

Counterpart of the part of ``sphfluidsimulation_tpu/parallel/slab.py`` that
the slab step of the sorted tier (``parallel/slab_pallas.py``) imports:
``SlabState`` and ``SlabSpec`` (:62-82), ``make_spec`` (:84-93),
``_owner_of`` (:96-98), the migration ring ``_migrate`` (:110-161), and the
host-side ``distribute`` and ``collect`` (:451-514). The sites step of that
module (``_make_local_step``, ``make_slab_step``) is ROADMAP.md queue A,
items A9/A11.

The unit cube is cut into z-slabs of the bucket grid, one per shard of the
slab axis (``parallel/ring.py``); a shard owns the particles whose stale
anchor cell lies in its slab. Its rows live in a buffer of ``cap_rows``
rows: its particles front-compacted, then dead rows. At each frame start the
migration ring delivers every row to its owner, ``hops`` hops in each
direction; rows that find no room are dropped and counted (``lost``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SimConfig
from ..ops import sph_math
from ..state import ParticleState
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
    ring hops (a shard step: ``yield from`` it).

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
                own = _owner_of(frows[:, 2], r, spec.slab_z, spec.d)
                want = valid & ((own - my) * dirn > 0)
                # send buffer: the rows to send front-compacted
                sorder = front(want)
                rf = yield send(frows[sorder])
                ri = yield send(irows[sorder])
                rv = yield send(want[sorder])      # edge shards: all False
                # the rows kept front-compacted, the received appended
                keep = valid & ~want
                korder = front(keep)
                n_keep = keep.sum()
                ridx = torch.where(rv, n_keep + torch.cumsum(rv, 0) - 1, c)
                ridx = ridx.clamp(max=c)      # row c: a scratch row, cut
                mf = torch.cat([frows[korder], frows[:1]])
                mi = torch.cat([irows[korder], irows[:1]])
                mf[ridx] = rf
                mi[ridx] = ri
                n_tot = n_keep + rv.sum()
                lost = lost + (n_tot - c).clamp(min=0).to(torch.int32)
                frows, irows = mf[:c], mi[:c]
                valid = iota < n_tot.clamp(max=c)
    own = _owner_of(frows[:, 2], r, spec.slab_z, spec.d)
    stranded = valid & (own != my)
    return (frows, irows, valid & ~stranded,
            lost + stranded.sum().to(torch.int32))


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
