"""The slab step of the sorted tier (``parallel/``) against the JAX package
and against the port's single-device step, on the CPU.

- The banded frame is integer-equal to JAX ``pallas_sph.build_frame(band=,
  valid=)``; the spec, the migration ring and the front compaction are
  integer-equal to JAX's (the ring under ``jax.shard_map`` on the conftest's
  8-device CPU mesh).
- The slab step (plain versions, ``LocalRing``) meets the tolerances and
  the certificate contracts of ``tests/test_slab_pallas.py`` against the
  port's single-device sorted step.
- ``DistRing`` over gloo, two processes, equals ``LocalRing(2)`` bit for bit.
- The faults repaired with it: the bench window (C1), the tuning variables
  (C2), the frame's sort key, and ``neighbor="pallas"``.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.ops import pallas_sph
from sphfluidsimulation_tpu.parallel import slab as jslab
from sphfluidsimulation_tpu.parallel import slab_pallas as jsp
from sphfluidsimulation_tpu.sim.stepper import initial_state as jinit
from sphfluidsimulation_torch import SimConfig, bench
from sphfluidsimulation_torch.ops import sph_kernels as sk
from sphfluidsimulation_torch.ops.frame import build_frame
from sphfluidsimulation_torch.params import PhysParams
from sphfluidsimulation_torch.parallel import (LocalRing, collect, distribute,
                                               make_pallas_slab_step,
                                               make_pallas_spec, slab,
                                               slab_pallas)
from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                  make_frame_step,
                                                  make_rollout)
from sphfluidsimulation_torch.state import (ParticleState, StepMetrics,
                                            slab_state_from_numpy,
                                            slab_state_to_numpy)

# one intra-op thread, as in the port's other test modules
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# tests/test_slab_pallas.py:20-22 and :138
_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
CALM = SimConfig(**_CALM)
VIOLENT = SimConfig(particle_number=4096, bucket_resolution=17)
# the tolerances of tests/test_slab_pallas.py:50-55
POS_ATOL, VEL_ATOL = 2e-5, 2e-4
FRAME_FIELDS = ("order", "cid", "raw", "occ", "start", "clip_count")


def _mesh(n_dev):
    return Mesh(np.array(jax.devices()[:n_dev]), ("sp",))


# ---------------------------------------------------------- banded frame --

def _band_scene(band_case, dead, planted, seed=5):
    """(pos, gid, valid, band, r) of a banded frame: rows spread over the
    band's planes (a few beyond them when ``planted``), out-of-cube spawns
    among them, with or without dead rows; the dead rows' ids ascend with
    their row index (the JAX sort orders dead rows by id, the port by row
    index)."""
    rng = np.random.default_rng(seed)
    n, r = 900, 9
    zbase, z_span = {"below": (-2, 6), "inside": (3, 4),
                     "above": (6, 5)}[band_case]
    lo = max(zbase, 0) / (r - 1)
    hi = min(zbase + z_span - 1, r - 1) / (r - 1)
    pos = rng.uniform(-0.15, 1.2, (n, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(lo, hi + 0.99 / (r - 1), n)
    pos[:150] = rng.uniform(0.0, 0.08, (150, 3))      # a pile past capacity
    pos[:150, 2] += lo
    if planted:
        # live rows whose stale anchor lies outside the band
        out = [0.0, 1.0] if zbase + z_span <= r - 1 else [0.0]
        pos[150:160, 2] = np.resize(np.array(out, np.float32), 10)
    gid = rng.permutation(n).astype(np.int32)
    valid = np.ones(n, bool)
    if dead:
        valid[rng.choice(n, 250, replace=False)] = False
        valid[150:160] = True
        gid[~valid] = np.sort(gid[~valid])
    return pos, gid, valid, (zbase, z_span), r


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("cap", [4, 32, None])
@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("band_case", ["below", "inside", "above"])
def test_banded_frame_matches_jax(band_case, dead, cap, planted):
    pos, gid, valid, band, r = _band_scene(band_case, dead, planted)
    extra = np.arange(pos.shape[0] * 2, dtype=np.float32).reshape(-1, 2)
    jf, (jx,) = pallas_sph.build_frame(
        jnp.asarray(pos), r, cap, extras=(jnp.asarray(extra),),
        gid=jnp.asarray(gid), tune=pallas_sph.PallasTuning(compact=True),
        band=(jnp.int32(band[0]), band[1]), valid=jnp.asarray(valid))
    tf, (tx,) = build_frame(
        torch.from_numpy(pos), r, cap, extras=(torch.from_numpy(extra),),
        gid=torch.from_numpy(gid), band=band, valid=torch.from_numpy(valid))
    for f in FRAME_FIELDS:
        got, want = getattr(tf, f).numpy(), np.asarray(getattr(jf, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    s_cells = band[1] * r * r
    assert tf.start.shape == (s_cells + 1,)
    assert int(tf.start[-1]) == int(valid.sum())
    assert (int(tf.clip_count) > 0) == planted
    if cap == 4:
        assert int((~tf.occ[:int(valid.sum())]).sum()) > 0


def test_frame_sort_key_is_unique_for_sparse_ids():
    # ids unique but far above the row count (a slab's global particle
    # ids): the key must not collide, so the order is JAX's
    rng = np.random.default_rng(11)
    n, r = 600, 7
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    pos[:200] = rng.uniform(0, 0.1, (200, 3))
    gid = rng.choice(50_000, n, replace=False).astype(np.int32)
    jf, _ = pallas_sph.build_frame(jnp.asarray(pos), r, 32,
                                   gid=jnp.asarray(gid))
    for kw in ({}, {"n_ids": 50_000}):
        tf, _ = build_frame(torch.from_numpy(pos), r, 32,
                            gid=torch.from_numpy(gid), **kw)
        for f in ("order", "cid", "raw", "occ", "start"):
            np.testing.assert_array_equal(getattr(tf, f).numpy(),
                                          np.asarray(getattr(jf, f)), f)


def test_dead_rows_sort_last_in_row_order():
    rng = np.random.default_rng(12)
    n, r = 300, 7
    pos = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) < 0.6)
    gid = torch.where(valid, torch.arange(n, dtype=torch.int32), 0)
    rows = torch.arange(n)
    tf, (rs,) = build_frame(pos, r, 32, extras=(rows,), gid=gid, n_ids=n,
                            band=(1, 4), valid=valid)
    n_live = int(valid.sum())
    assert int(tf.start[-1]) == n_live
    assert torch.equal(rs[n_live:], rows[~valid])
    assert not bool(tf.occ[n_live:].any())
    assert bool((tf.cid[n_live:] == 4 * r * r).all())


# ------------------------------------------------- banded plain versions --

def _slab_frame(cfg, state, d, shard):
    """The banded frame and sorted rows of shard ``shard`` of a CALM-like
    scene, as the slab step builds them (own rows and both halos)."""
    spec = make_pallas_spec(cfg, d, row_slack=4.0)
    r = cfg.bucket_resolution
    zbase = shard * spec.slab_z - spec.halo
    az = (state.pos[:, 2] * (r - 1)).to(torch.int32).clamp(0, r - 1)
    live = (az >= zbase) & (az < zbase + spec.z_span)
    # a row buffer: the band's rows, then dead rows
    n_dead = 40
    pos = torch.cat([state.pos, state.pos[:n_dead]])
    vel = torch.cat([state.vel, state.vel[:n_dead]])
    valid = torch.cat([live, torch.zeros(n_dead, dtype=torch.bool)])
    gid = torch.arange(pos.shape[0], dtype=torch.int32) % cfg.n_particles
    frame, (ps, vs) = build_frame(pos, r, cfg.voxel_capacity,
                                  extras=(pos, vel), gid=gid,
                                  n_ids=cfg.n_particles,
                                  band=(zbase, spec.z_span), valid=valid)
    return frame, ps, vs, (zbase, spec.z_span), spec


@pytest.mark.parametrize("cap", [4, 32, None])
def test_banded_density_and_substep_keep_own_rows_exact(cap):
    # rows whose window lies inside the band get, value for value, the
    # single-device frame's density and substep; dead rows get density 0
    # and are copied through by the substep
    cfg = CALM.replace(voxel_capacity=cap)
    st, _ = make_rollout(cfg, 2, device="cpu")(initial_state(cfg, "cpu"))
    phys = PhysParams.from_config(cfg)
    r = cfg.bucket_resolution
    gf, (gps, gvs) = build_frame(st.pos, r, cap, extras=(st.pos, st.vel))
    g_rho = sk.density_plain(gf, gps, phys, r, cap)
    g_rows = sk.fused_substep_plain(gf, sk.pack_rows(gps, gvs, g_rho), phys,
                                    r, cap)
    frame, ps, vs, band, _ = _slab_frame(cfg, st, 4, 1)
    rho = sk.density_pass(frame, ps, phys, r, cap, band=band)
    n_live = int(frame.start[-1])
    assert bool((rho[n_live:] == 0).all()) and n_live < ps.shape[0]
    rows = sk.pack_rows(ps, vs, rho)
    out = sk.fused_substep(frame, rows, phys, r, cap, band=band)
    assert torch.equal(out[n_live:], rows[n_live:])
    # own rows: the frame's live rows whose window stays inside the band
    cz = (ps[:n_live, 2] * (r - 1)).to(torch.int32)
    inner = ((cz - 1).clamp(min=0) >= band[0]) & \
        ((cz + 1).clamp(max=r - 1) <= band[0] + band[1] - 1)
    slots = torch.nonzero(inner).squeeze(1)
    g_slot = torch.empty(cfg.n_particles, dtype=torch.long)
    g_slot[gf.order.long()] = torch.arange(cfg.n_particles)
    at = g_slot[frame.order[slots].long()]
    assert slots.numel() > 100
    # the dense gathers pad the local and the global frame differently, so
    # their tree sums pair terms differently: the slab tolerances
    torch.testing.assert_close(rho[slots], g_rho[at], rtol=1e-6, atol=0)
    torch.testing.assert_close(out[slots, 0:3], g_rows[at, 0:3], rtol=0,
                               atol=POS_ATOL)
    torch.testing.assert_close(out[slots, 3:6], g_rows[at, 3:6], rtol=0,
                               atol=VEL_ATOL)
    assert torch.equal(out[slots, 6:], g_rows[at, 6:])
    # the accuracy rule of the card holds the banded plain version itself
    acc = sk.substep_accuracy(frame, rows, out, phys, r, cap, band=band)
    assert acc.ok, acc
    pairs, own = sk.member_pairs(frame, ps, r, cap, band)
    assert 0 < own <= n_live < pairs


@pytest.mark.parametrize("d", [2, 4])
def test_shard_frames_hold_every_row_once_with_the_single_device_density(d):
    # the frames a step builds before K1: every particle is an own row of
    # exactly one shard, no anchor leaves its band, and K1's plain version
    # gives each own row its single-device density (the calm scene's own
    # rows keep their windows inside the band)
    spec = make_pallas_spec(CALM, d, row_slack=4.0)
    s0 = initial_state(CALM, "cpu")
    sfs = slab_pallas.shard_frames(CALM, spec, LocalRing(d),
                                   distribute(s0, CALM, spec))
    phys = PhysParams.from_config(CALM)
    r, cap = CALM.bucket_resolution, CALM.voxel_capacity
    gf, (gps,) = build_frame(s0.pos, r, cap, extras=(s0.pos,))
    g_rho = torch.empty(CALM.n_particles)
    g_rho[gf.order.long()] = sk.density_plain(gf, gps, phys, r, cap)
    seen = []
    for sf in sfs:
        assert int(sf.cert) == 0 and sf.frame.start.shape == (
            spec.z_span * r * r + 1,)
        rho = sk.density_plain(sf.frame, sf.pos_s, phys, r, cap, sf.band)
        ids = sf.frame.order[sf.own_s].long()
        torch.testing.assert_close(rho[sf.own_s], g_rho[ids], rtol=1e-6,
                                   atol=0)
        seen.append(ids)
    assert torch.equal(torch.sort(torch.cat(seen)).values,
                       torch.arange(CALM.n_particles))


# -------------------------------------------------------- spec and ring --

@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_spec_matches_jax(d):
    for kw in (_CALM, dict(particle_number=262144, bucket_resolution=47),
               dict(particle_number=1 << 20, bucket_resolution=75),
               dict(particle_number=524288, preset=2)):
        for extra in (dict(), dict(row_slack=4.0, halo_slack=0.001),
                      dict(halo=3, hops=1, row_slack=0.5)):
            jspec = jsp.make_pallas_spec(JConfig(**kw), d, **extra)
            spec = make_pallas_spec(SimConfig(**kw), d, **extra)
            assert tuple(spec) == tuple(jspec)
            assert spec.c_loc == jspec.c_loc
            base = {k: v for k, v in extra.items() if k != "halo_slack"}
            assert tuple(slab.make_spec(SimConfig(**kw), d, **base)) == \
                tuple(jslab.make_spec(JConfig(**kw), d, **base))


def test_gather_compact_matches_jax():
    rng = np.random.default_rng(3)
    mask = rng.random(700) < 0.3
    cols = (rng.random((700, 6)).astype(np.float32),
            rng.integers(0, 1 << 20, 700).astype(np.int32))
    for cap in (128, int(mask.sum()) - 20, 700):
        want = jsp._gather_compact(jnp.asarray(mask), cap,
                                   *map(jnp.asarray, cols))
        got = slab_pallas._gather_compact(torch.from_numpy(mask), cap,
                                          *map(torch.from_numpy, cols))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[-1]) == 0 and int(want[-1]) == 0
    assert int(slab_pallas._gather_compact(torch.from_numpy(mask), 128,
                                           *map(torch.from_numpy,
                                                cols))[-1]) > 0


def _migration_inputs(d, c, r, seed, crowd):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (d * c, 3)).astype(np.float32)
    vel = rng.normal(size=(d * c, 3)).astype(np.float32)
    if crowd:
        # most rows belong to shard 0: its buffer overflows
        pos[: d * c * 3 // 4, 2] = rng.uniform(0, 0.15, d * c * 3 // 4)
    frows = np.concatenate([pos, vel], 1)
    irows = np.stack([rng.integers(0, 3, d * c),
                      np.arange(d * c)], 1).astype(np.int32)
    valid = rng.random(d * c) < 0.4
    return frows, irows, valid


@pytest.mark.parametrize("crowd", [False, True])
def test_migration_matches_jax_under_shard_map(crowd):
    d, c, r = 4, 256, 11
    spec = slab.SlabSpec(d=d, slab_z=3, halo=2, cap_rows=c, hops=d - 1)
    frows, irows, valid = _migration_inputs(d, c, r, 9, crowd)

    def local(f, i, v):
        my = lax.axis_index("sp")
        f, i, v, lost = jslab._migrate(f, i, v, my, r,
                                       jslab.SlabSpec(*spec), "sp")
        return f, i, v, lost[None]

    want = jax.shard_map(local, mesh=_mesh(d), in_specs=(P("sp"),) * 3,
                         out_specs=(P("sp"),) * 4, check_vma=False)(
        *map(jnp.asarray, (frows, irows, valid)))
    ring = LocalRing(d)
    t = [torch.from_numpy(a) for a in (frows, irows, valid)]
    got = ring.run(lambda my, f, i, v: slab._migrate(f, i, v, my, r, spec,
                                                     ring),
                   [tuple(x[k * c:(k + 1) * c] for x in t)
                    for k in range(d)])
    for k, w in enumerate(want):
        g = torch.cat([torch.atleast_1d(o[k]) for o in got]).numpy()
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(k))
    lost = int(sum(o[3] for o in got))
    assert (lost > 0) == crowd
    # every row is delivered to its owner or counted lost
    assert sum(int(o[2].sum()) for o in got) + lost == int(valid.sum())


# ------------------------------------------------------------ slab step --

def _run_slab(cfg, d, frames, ring=None, **kw):
    """(collected state, lost, per-frame metrics) of the slab step on the
    CPU, and the same frames on the single-device sorted step."""
    ring = LocalRing(d) if ring is None else ring
    step, spec = make_pallas_slab_step(cfg, ring, device="cpu", **kw)
    phys = PhysParams.from_config(cfg)
    s0 = initial_state(cfg, "cpu")
    sst = distribute(s0, cfg, spec)
    ref_step = make_frame_step(cfg, neighbor="pallas", device="cpu")
    ref, ms, mrs = s0, [], []
    for _ in range(frames):
        sst, m = step(sst, phys)
        ref, mr = ref_step(ref)
        ms.append(m)
        mrs.append(mr)
    out, lost = collect(sst, cfg.n_particles)
    return out, lost, sst, ms, ref, mrs, spec


@pytest.mark.parametrize("d", [2, 4])
def test_slab_step_matches_single_device(d):
    out, lost, _, ms, ref, mrs, _ = _run_slab(CALM, d, 3, row_slack=4.0)
    assert lost == 0
    assert [int(m.exact_cert) for m in ms] == [0, 0, 0]
    assert [int(m.overflow) for m in ms] == [int(m.overflow) for m in mrs]
    torch.testing.assert_close(out.pos, ref.pos, rtol=0, atol=POS_ATOL)
    torch.testing.assert_close(out.vel, ref.vel, rtol=0, atol=VEL_ATOL)
    assert torch.equal(out.nan_count, ref.nan_count)
    for m, mr in zip(ms, mrs):
        for a, b in zip(m, mr):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)


def test_slab_step_extensions_match_single_device():
    cfg = CALM.replace(xsph=0.1, artificial_viscosity=0.05)
    out, lost, _, ms, ref, _, _ = _run_slab(cfg, 4, 2, row_slack=4.0)
    assert lost == 0 and int(ms[-1].exact_cert) == 0
    torch.testing.assert_close(out.pos, ref.pos, rtol=0, atol=POS_ATOL)


def _own_rows_bounded(sst):
    p = sst.pos[sst.valid]
    assert bool(torch.isfinite(p).all())
    assert float(p.min()) >= 0.0 and float(p.max()) <= 1.0


def test_slab_step_violent_degrades_certified():
    # tests/test_slab_pallas.py:151-192: inf velocities carry rows across
    # the box within a substep, so own rows' windows leave the band: the
    # certificate fires on every frame, positions stay finite and in the
    # cube, and every particle is a valid row or counted lost. (The port's
    # single-device window route is exact: its certificate stays 0.)
    out, lost, sst, ms, _, mrs, _ = _run_slab(VIOLENT, 4, 4, row_slack=4.0)
    certs = [int(m.exact_cert) for m in ms]
    assert certs[0] > 0 and min(certs) > 0, certs
    assert all(int(m.exact_cert) == 0 for m in mrs)
    torch.testing.assert_close(ms[0].max_speed, mrs[0].max_speed, rtol=1e-5,
                               atol=0)
    _own_rows_bounded(sst)
    assert int(sst.valid.sum()) + lost == VIOLENT.n_particles
    assert bool(torch.isfinite(out.pos).all())
    assert float(out.pos.min()) >= 0.0 and float(out.pos.max()) <= 1.0


def test_slab_step_halo_starvation_is_certified():
    # tests/test_slab_pallas.py:195-210
    step, spec = make_pallas_slab_step(CALM, LocalRing(4), row_slack=4.0,
                                       halo_slack=0.001, device="cpu")
    assert spec.halo_cap == 128
    sst = distribute(initial_state(CALM, "cpu"), CALM, spec)
    sst, m = step(sst, PhysParams.from_config(CALM))
    assert int(m.exact_cert) > 0
    _own_rows_bounded(sst)


def test_slab_step_migration_overflow_is_certified():
    # tests/test_slab_pallas.py:213-252: every row belongs to slab 0, so
    # the migration ring delivers 4 × 128 rows into a 128-row buffer
    step, spec = make_pallas_slab_step(CALM, LocalRing(4), row_slack=0.5,
                                       device="cpu")
    c = spec.cap_rows
    assert c < CALM.n_particles // 2
    n = 4 * c
    rng = np.random.RandomState(7)
    pos = np.empty((n, 3), np.float32)
    pos[:, 0] = rng.uniform(0.1, 0.9, n)
    pos[:, 1] = rng.uniform(0.1, 0.9, n)
    pos[:, 2] = rng.uniform(0.05, (spec.slab_z - 1)
                            / (CALM.bucket_resolution - 1), n)
    sst = slab_state_from_numpy(pos, np.zeros((n, 3)), np.zeros(n),
                                np.arange(n), np.ones(n, bool))
    sst, m = step(sst, PhysParams.from_config(CALM))
    _own_rows_bounded(sst)
    _, lost = collect(sst, n)
    assert int(sst.valid.sum()) + lost == n
    assert lost > 0
    assert int(m.exact_cert) >= lost


def test_slab_step_rejects_the_compact_route_and_needs_the_card(
        monkeypatch):
    # the compact route runs on the CPU through the banded K5's plain
    # versions (the name is kept from when it raised); without a card the
    # default device raises
    step, spec = make_pallas_slab_step(CALM, LocalRing(2), device="cpu",
                                       row_slack=4.0,
                                       tune=sk.SortedTuning(compact=True))
    s0 = initial_state(CALM, "cpu")
    sst, m = step(distribute(s0, CALM, spec), PhysParams.from_config(CALM))
    out, lost = collect(sst, CALM.n_particles)
    ref, _ = make_rollout(CALM, 1, tune=sk.SortedTuning(compact=True),
                          device="cpu")(s0)
    assert int(m.exact_cert) == 0 and lost == 0
    assert float((out.pos - ref.pos).abs().max()) < 2e-5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        make_pallas_slab_step(CALM, LocalRing(2))


def test_slab_state_round_trips_through_numpy():
    spec = make_pallas_spec(CALM, 2, row_slack=4.0)
    sst = distribute(initial_state(CALM, "cpu"), CALM, spec)
    back = slab_state_from_numpy(*slab_state_to_numpy(sst))
    for a, b in zip(sst, back):
        assert torch.equal(a, b) and a.dtype == b.dtype
    # the JAX distribute gives the same buffers
    jc = JConfig(**_CALM)
    jst = jslab.distribute(jinit(jc), jc,
                           jsp.make_pallas_spec(jc, 2, row_slack=4.0))
    for a, b in zip(slab_state_to_numpy(sst), jst):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["host_loop", "eager_body"])
def test_slab_step_matches_jax_slab_step(mode):
    # the JAX slab step itself (its kernels in interpret mode, under
    # jax.jit as JAX's tests run it), CALM, two shards, one frame, from the
    # same slab state; the port's host loop, and the body its graph records
    # (slab_pallas.GraphSlabStep) run eagerly on its carry
    from sphfluidsimulation_tpu.params import PhysParams as JPhys
    jc = JConfig(**_CALM)
    jstep, jspec = jsp.make_pallas_slab_step(jc, _mesh(2), row_slack=4.0)
    jst = jslab.distribute(jinit(jc), jc, jspec, _mesh(2))
    jst, jm = jax.jit(jstep)(jst, JPhys.from_config(jc))
    step, spec = make_pallas_slab_step(CALM, LocalRing(2), row_slack=4.0,
                                       device="cpu")
    assert tuple(spec) == tuple(jspec)
    sst = distribute(initial_state(CALM, "cpu"), CALM, spec)
    if mode == "host_loop":
        sst, m = step(sst, PhysParams.from_config(CALM))
    else:
        body = slab_pallas.GraphSlabStep(step, 2 * spec.cap_rows,
                                         torch.device("cpu"))
        body.load(sst, PhysParams.from_config(CALM))
        body.advance(body.carry)
        sst, m = body.result()
    got, want = slab_state_to_numpy(sst), [np.asarray(x) for x in jst]
    for k in (2, 3, 4):                 # nan_count, pid, valid
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=VEL_ATOL)
    assert int(m.exact_cert) == 0 == int(jm.exact_cert)
    assert int(m.overflow) == int(jm.overflow)


# ------------------------------------------------------- DistRing / gloo --

_RANK = """
import datetime, sys, torch
import torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from sphfluidsimulation_torch import SimConfig
from sphfluidsimulation_torch.params import PhysParams
from sphfluidsimulation_torch.parallel import (DistRing, distribute,
                                               make_pallas_slab_step)
from sphfluidsimulation_torch.sim.stepper import initial_state
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={store!r}, rank=rank,
                        world_size=2,
                        timeout=datetime.timedelta(seconds=60))
cfg = SimConfig(**{cfg!r})
ring = DistRing()
step, spec = make_pallas_slab_step(cfg, ring, row_slack=4.0, device="cpu")
st = distribute(initial_state(cfg, "cpu"), cfg, spec)
c = spec.cap_rows
st = type(st)(*(t[rank * c:(rank + 1) * c] for t in st))
ms = []
for _ in range({frames}):
    st, m = step(st, PhysParams.from_config(cfg))
    ms.append(m)
torch.save((tuple(st), [tuple(m) for m in ms]), {out!r} + str(rank))
dist.destroy_process_group()
"""


def test_dist_ring_over_gloo_equals_local_ring(tmp_path):
    frames = 2
    out = str(tmp_path / "rank")
    code = _RANK.format(root=str(ROOT), cfg=_CALM, frames=frames, out=out,
                        store=f"file://{tmp_path / 'store'}")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(k)],
                              cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for k in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0, 0], logs
    _, _, sst, ms, _, _, _ = _run_slab(CALM, 2, frames, row_slack=4.0)
    shards = [torch.load(out + str(k)) for k in range(2)]
    for k in range(5):
        got = torch.cat([s[0][k] for s in shards])
        assert torch.equal(got, sst[k]), k
    for f in range(frames):
        for s in shards:
            for a, b in zip(s[1][f], ms[f]):
                assert torch.equal(a, b)


# ------------------------------------------------------ repaired faults --

class _FrameClock:
    """A stub rollout that counts frames: the clock reads the number of
    frames simulated so far, so an elapsed time is a count of frames."""

    def __init__(self):
        self.frame = 0
        self.reads = []

    def perf_counter(self):
        self.reads.append(self.frame)
        return float(self.frame)

    def make_rollout(self, cfg, n, **kw):
        def roll(state):
            self.frame += n
            f, i = torch.zeros(n), torch.zeros(n, dtype=torch.int32)
            return state, StepMetrics(f, f, f, i, i, i)
        return roll


def test_bench_times_the_jax_window_and_a_steady_window(monkeypatch):
    clock = _FrameClock()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "stub")
    monkeypatch.setattr(bench.time, "perf_counter", clock.perf_counter)
    monkeypatch.setattr(bench, "make_rollout", clock.make_rollout)
    monkeypatch.setattr(bench, "initial_state", lambda cfg, dev: None)
    monkeypatch.setattr(bench, "device_sync", lambda *a: None)
    monkeypatch.setattr(bench, "gpu_identity", lambda: "stub, 700.00 W")
    out = bench.run_bench(1024, frames=3, warmup_frames=2, steady_frames=9)
    # warm-up [0, 2); the timed length once untimed [2, 5); timed [5, 8);
    # rolled on [8, 14); the steady window timed [14, 17)
    assert clock.reads == [0, 2, 5, 8, 14, 17]
    assert out["elapsed_s"] == 3.0 and out["frames_timed"] == 3
    assert out["steady_state_frames_window"] == [14, 17]
    assert out["steady_state_elapsed_s"] == 3.0
    cfg = bench.scaled_config(1024)
    assert out["steady_state_value"] == round(
        cfg.n_particles * cfg.substeps * 3 / 3.0, 1)
    clock2 = _FrameClock()
    monkeypatch.setattr(bench.time, "perf_counter", clock2.perf_counter)
    monkeypatch.setattr(bench, "make_rollout", clock2.make_rollout)
    out = bench.run_bench(1024, frames=4, warmup_frames=1)
    assert clock2.reads == [0, 1, 5, 9]          # timed [5, 9)
    assert "steady_state_value" not in out


@pytest.mark.parametrize("var,value,field", [
    ("SPH_PALLAS_FUSED", "0", "fused"), ("SPH_PALLAS_KAHAN", "1", "kahan"),
    ("SPH_PALLAS_BF16", "1", "bf16"), ("SPH_PALLAS_FACC", "0", "fuse_acc"),
    (None, None, None)])
def test_tuning_variables_raise_unless_default(monkeypatch, var, value,
                                               field):
    # each semantic variable selects its variant (they raised until the
    # variants were ported; the test keeps its name), and the stepper and
    # the slab step take it from the environment
    for v in ("SPH_PALLAS_FUSED", "SPH_PALLAS_KAHAN", "SPH_PALLAS_BF16",
              "SPH_PALLAS_FACC", "SPH_PALLAS_COMPACT"):
        monkeypatch.delenv(v, raising=False)
    if var is None:
        # the defaults, spelled out, and the layout variables, ignored
        for v, default in (("SPH_PALLAS_FUSED", "1"),
                           ("SPH_PALLAS_KAHAN", "0"),
                           ("SPH_PALLAS_BF16", "0"), ("SPH_PALLAS_FACC", "1"),
                           ("SPH_PALLAS_ROWS", "32"), ("SPH_PALLAS_IKI", "1")):
            monkeypatch.setenv(v, default)
        assert sk.SortedTuning.from_env() == sk.SortedTuning()
        monkeypatch.setenv("SPH_PALLAS_COMPACT", "1")
        assert sk.default_tuning() == sk.SortedTuning(compact=True)
        return
    monkeypatch.setenv(var, value)
    want = sk.SortedTuning()._replace(**{field: value == "1"})
    assert want != sk.SortedTuning()
    assert sk.SortedTuning.from_env() == want
    s0 = initial_state(CALM, "cpu")
    got = make_rollout(CALM, 1, device="cpu")(s0)
    same = make_rollout(CALM, 1, tune=want, device="cpu")(s0)
    for x, y in zip((*got[0], *got[1]), (*same[0], *same[1])):
        assert torch.equal(x, y)


def test_neighbor_pallas_is_the_sorted_tier():
    s0 = initial_state(CALM, "cpu")
    a, ma = make_rollout(CALM, 2, neighbor="pallas", device="cpu")(s0)
    b, mb = make_rollout(CALM, 2, neighbor="sorted", device="cpu")(s0)
    for x, y in zip((*a, *ma), (*b, *mb)):
        assert torch.equal(x, y)
    fa, _ = make_frame_step(CALM, neighbor="pallas", device="cpu")(s0)
    fb, _ = make_frame_step(CALM, neighbor="sorted", device="cpu")(s0)
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))
    assert isinstance(fa, ParticleState)
