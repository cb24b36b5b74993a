"""The torch port's exact tiers (``ops/cellops.py``: the gather and slotted
passes, and the slotted and gather frame steps) against the JAX package's
on the same numpy-seeded inputs, the contracts of tests/test_equivalence.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.ops import cellops as jcell
from sphfluidsimulation_tpu.ops.grid import build_bucket as jbucket
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_tpu.sim.stepper import (initial_state as jinit,
                                                make_frame_step as jstep)
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import brute, cellops
from sphfluidsimulation_torch.ops.grid import build_bucket
from sphfluidsimulation_torch.params import PhysParams
from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                  make_frame_step,
                                                  make_rollout)

# one intra-op thread: the suite runs in several worker processes on
# shared cores, where each worker's spinning OpenMP threads slowed the
# port's many small CPU ops about fivefold
torch.set_num_threads(1)

# tests/test_equivalence.py:25-38
CASES = [(512, 9, 32), (1024, 13, 8), (2048, 17, 32)]
# the port against JAX on the same inputs: both sum the same terms per
# window offset in the same offset order, so they differ by the rounding of
# the sums over a voxel's slots and of the three-lane norms; density
# elementwise within rtol 2e-6 (+ 1e-7 absolute), forces within 1e-6 of
# the largest force (the bounds of tests/test_equivalence.py against brute
# are 2e-5 and 3e-6)
RHO_RTOL, RHO_ATOL, F_ATOL = 2e-6, 1e-7, 1e-6


def _cloud(n, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (n, 3)).astype(np.float32),
            rng.normal(0, 0.3, (n, 3)).astype(np.float32))


def _both(n, r, cap, seed):
    """(port bucket, JAX bucket, port phys, JAX phys, pos, vel) of a
    seeded cloud."""
    kw = dict(particle_number=n, bucket_resolution=r, voxel_capacity=cap)
    pos, vel = _cloud(n, seed)
    tb, _ = build_bucket(torch.from_numpy(pos), r, cap)
    jb, _ = jbucket(jnp.asarray(pos), r, cap)
    return (tb, jb, PhysParams.from_config(SimConfig(**kw)),
            JPhys.from_config(JConfig(**kw)), pos, vel)


def _close_forces(got, want):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=F_ATOL)


@pytest.mark.parametrize("n,r,cap", CASES + [(1024, 5, 4)])
def test_pack_slots_and_repack_fresh_are_integer_equal_to_jax(n, r, cap):
    # the occupancy lanes (id + 1) and the slot order exactly; the value
    # lanes are copies, so they are exact too. (1024, 5, 4) drops
    # particles past the capacity
    tb, jb, tp, jp, pos, vel = _both(n, r, cap, seed=n + r)
    rho = np.random.default_rng(1).uniform(1, 2, n).astype(np.float32)
    t0 = cellops.pack_slots(tb.table, cap, n, torch.from_numpy(pos), None,
                            None)
    j0 = jcell.pack_slots(jb.table, cap, n, jnp.asarray(pos), None, None)
    t1 = cellops.pack_slots(tb.table, cap, n, torch.from_numpy(pos),
                            torch.from_numpy(vel), torch.from_numpy(rho))
    j1 = jcell.pack_slots(jb.table, cap, n, jnp.asarray(pos),
                          jnp.asarray(vel), jnp.asarray(rho))
    pos2, vel2 = _cloud(n, seed=99)
    t2 = cellops.repack_fresh(t1, tb.table, cap, n, torch.from_numpy(pos2),
                              torch.from_numpy(vel2))
    j2 = jcell.repack_fresh(j1, jb.table, cap, n, jnp.asarray(pos2),
                            jnp.asarray(vel2))
    for t, j in ((t0, j0), (t1, j1), (t2, j2)):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    occ = t1.posocc[:, 3 * cap:]
    assert int((occ > 0).sum()) == int(tb.in_table.sum())
    if cap == 4:
        assert int((~tb.in_table).sum()) > 0


@pytest.mark.parametrize("n,r,cap", CASES)
def test_gather_and_slotted_density_match_jax(n, r, cap):
    tb, jb, tp, jp, pos, _ = _both(n, r, cap, seed=n)
    tpos, jpos = torch.from_numpy(pos), jnp.asarray(pos)
    want = np.asarray(jcell.density_grid(jpos, jb, cap, jp, r))
    got = cellops.density_grid(tpos, tb, cap, tp, r).numpy()
    np.testing.assert_allclose(got, want, rtol=RHO_RTOL, atol=RHO_ATOL)
    slots = cellops.pack_slots(tb.table, cap, n, tpos, None, None)
    want_s = np.asarray(jcell.density_slotted_rows(
        jpos, jb.cell, jcell.pack_slots(jb.table, cap, n, jpos, None, None),
        cap, jp, r))
    got_s = cellops.density_slotted_rows(tpos, tb.cell, slots, cap, tp,
                                         r).numpy()
    np.testing.assert_allclose(got_s, want_s, rtol=RHO_RTOL, atol=RHO_ATOL)


@pytest.mark.parametrize("n,r,cap", CASES)
def test_gather_and_slotted_forces_match_jax(n, r, cap):
    tb, jb, tp, jp, pos, vel = _both(n, r, cap, seed=n + 7)
    tpos, tvel = torch.from_numpy(pos), torch.from_numpy(vel)
    rho = brute.density_bruteforce(tpos, tb.cell_id, tb.in_table, tp, r)
    jpos, jvel, jrho = jnp.asarray(pos), jnp.asarray(vel), \
        jnp.asarray(rho.numpy())
    want = np.asarray(jcell.fluid_forces_grid(jpos, jvel, jrho, jb, cap, jp,
                                              r))
    _close_forces(cellops.fluid_forces_grid(tpos, tvel, rho, tb, cap, tp,
                                            r).numpy(), want)
    ids = np.arange(n, dtype=np.int32)
    jslots = jcell.pack_slots(jb.table, cap, n, jpos, jvel, jrho)
    want_s = np.asarray(jcell.fluid_forces_slotted_rows(
        jpos, jvel, jnp.asarray(ids), jrho, jslots, cap, jp, r))
    slots = cellops.pack_slots(tb.table, cap, n, tpos, tvel, rho)
    got_s = cellops.fluid_forces_slotted_rows(
        tpos, tvel, torch.from_numpy(ids), rho, slots, cap, tp, r).numpy()
    _close_forces(got_s, want_s)
    # and the brute oracle, at test_equivalence.py's bound
    f_b = brute.fluid_forces_bruteforce(tpos, tvel, rho, tb.cell_id,
                                        tb.in_table, tp, r).numpy()
    scale = float(np.abs(f_b).max())
    np.testing.assert_allclose(got_s / scale, f_b / scale, rtol=0, atol=3e-6)


def test_capacity_truncation_changes_density():
    # tests/test_equivalence.py:73-86: the voxel capacity drop is semantic
    # (Bucket.compute:30-35), and the cut density is JAX's
    n, r = 1024, 5
    p = PhysParams.from_config(SimConfig(particle_number=n,
                                         bucket_resolution=r))
    jp = JPhys.from_config(JConfig(particle_number=n, bucket_resolution=r))
    pos, _ = _cloud(n, seed=3, lo=0.4, hi=0.6)
    tpos = torch.from_numpy(pos)
    full = cellops.density_grid(tpos, build_bucket(tpos, r, 1024)[0], 1024,
                                p, r)
    cut = cellops.density_grid(tpos, build_bucket(tpos, r, 4)[0], 4, p, r)
    assert float((full - cut).abs().max()) > 1e-3
    want = jcell.density_grid(jnp.asarray(pos),
                              jbucket(jnp.asarray(pos), r, 4)[0], 4, jp, r)
    np.testing.assert_allclose(cut.numpy(), np.asarray(want), rtol=RHO_RTOL,
                               atol=RHO_ATOL)


@pytest.mark.parametrize("neighbor", ["gather", "slotted"])
def test_window_uses_fresh_cell_stale_bucket(neighbor):
    # tests/test_equivalence.py:89-106: the window is centred on the FRESH
    # cell (VelPos.compute:57-58) over the frame-start bucket; shifting
    # every particle by two cells changes the windows, and the tier still
    # matches the brute oracle and JAX there
    n, r, cap = 1024, 9, 32
    tb, jb, tp, jp, pos, vel = _both(n, r, cap, seed=11)
    tpos, tvel = torch.from_numpy(pos), torch.from_numpy(vel)
    rho = brute.density_bruteforce(tpos, tb.cell_id, tb.in_table, tp, r)
    pos2 = np.clip(pos + 2.0 / 8.0, 0.0, 1.0).astype(np.float32)
    tpos2 = torch.from_numpy(pos2)
    if neighbor == "gather":
        got = cellops.fluid_forces_grid(tpos2, tvel, rho, tb, cap, tp, r)
    else:
        slots = cellops.pack_slots(tb.table, cap, n, tpos2, tvel, rho)
        got = cellops.fluid_forces_slotted_rows(
            tpos2, tvel, torch.arange(n, dtype=torch.int32), rho, slots, cap,
            tp, r)
    f_b = brute.fluid_forces_bruteforce(tpos2, tvel, rho, tb.cell_id,
                                        tb.in_table, tp, r).numpy()
    scale = float(np.abs(f_b).max())
    np.testing.assert_allclose(got.numpy() / scale, f_b / scale, atol=3e-6)
    want = jcell.fluid_forces_grid(jnp.asarray(pos2), jnp.asarray(vel),
                                   jnp.asarray(rho.numpy()), jb, cap, jp, r)
    _close_forces(got.numpy(), np.asarray(want))
    # the unshifted forces differ: the windows moved
    unshifted = cellops.fluid_forces_grid(tpos, tvel, rho, tb, cap, tp, r)
    assert float((unshifted - got).abs().max()) > 1e-3 * scale


_GOLDEN_1K = dict(particle_number=1024, bucket_resolution=11)


def test_slotted_step_matches_gather_brute_and_jax():
    # tests/test_equivalence.py:107-120 on the port, and the port's
    # slotted frame against JAX's (golden physics, one frame: the EOS
    # explodes, so positions only)
    cfg = SimConfig(**_GOLDEN_1K)
    st = initial_state(cfg, "cpu")
    outs = {}
    for nb in ("slotted", "gather", "brute"):
        s, m = make_frame_step(cfg, neighbor=nb, device="cpu")(st)
        outs[nb] = (s.pos.numpy(), float(m.mean_density), int(m.overflow))
    np.testing.assert_allclose(outs["slotted"][0], outs["gather"][0],
                               atol=1e-6)
    np.testing.assert_allclose(outs["slotted"][0], outs["brute"][0],
                               atol=1e-5)
    assert outs["slotted"][1] == pytest.approx(outs["gather"][1], rel=1e-6)
    assert outs["slotted"][2] == outs["gather"][2] == outs["brute"][2]
    js, jm = jax.jit(jstep(JConfig(**_GOLDEN_1K), neighbor="slotted"))(
        jinit(JConfig(**_GOLDEN_1K)))
    np.testing.assert_allclose(outs["slotted"][0], np.asarray(js.pos),
                               atol=1e-6)
    assert outs["slotted"][2] == int(jm.overflow)


def test_self_pair_skip_on_inf_velocities():
    """VelPos.compute:82: a particle with ±inf velocity must not evaluate
    its own inf − inf = NaN self pair. tests/test_equivalence.py:123 holds
    JAX's slotted rollout to brute on this state; the port's slotted
    rollout is held to the port's sorted tier (whose kernels skip j == i by
    id), and both must trap: the same NaN-trap population and events, and
    the positions within 5e-5, over 3 frames (15 substeps)."""
    cfg = SimConfig(**_GOLDEN_1K)
    st0 = initial_state(cfg, "cpu")
    vel = st0.vel.clone()
    vel[::37, 0] = float("inf")
    vel[5::53, 1] = -float("inf")
    st0 = st0._replace(vel=vel)
    out = {}
    for nb in ("sorted", "slotted"):
        out[nb] = make_rollout(cfg, 3, neighbor=nb, device="cpu")(st0)
    (ss, ms), (ts, mt) = out["sorted"], out["slotted"]
    assert int(ss.nan_count.sum()) > 0
    assert torch.equal(ts.nan_count, ss.nan_count)
    assert int(mt.nan_events[-1]) == int(ms.nan_events[-1])
    np.testing.assert_allclose(ts.pos.numpy(), ss.pos.numpy(), atol=5e-5)
    # on this state the trap fires on the inf rows with or without the
    # skip: a window candidate beyond h adds ∇²W = 0 times (vⱼ − inf), NaN,
    # as in the reference. So the skip is pinned at the pass level too, on
    # a pair alone in its corner, closer than h: the +inf row sums −inf
    # viscosity, where its own pair would add inf − inf = NaN; the same
    # non-finite pattern as JAX's
    n, r, cap = 512, 9, 32
    tb, jb, tp, jp, pos, vel = _both(n, r, cap, seed=4)
    pos = np.where(pos < 0.4, pos + 0.4, pos).astype(np.float32)
    pos[0] = (0.05, 0.05, 0.05)
    pos[1] = (0.05 + 0.3 / (r - 1), 0.05, 0.05)
    vel[0, 0] = np.inf
    tb, _ = build_bucket(torch.from_numpy(pos), r, cap)
    jb, _ = jbucket(jnp.asarray(pos), r, cap)
    tpos, tvel = torch.from_numpy(pos), torch.from_numpy(vel)
    rho = brute.density_bruteforce(tpos, tb.cell_id, tb.in_table, tp, r)
    ids = np.arange(n, dtype=np.int32)
    got = cellops.fluid_forces_slotted_rows(
        tpos, tvel, torch.from_numpy(ids), rho,
        cellops.pack_slots(tb.table, cap, n, tpos, tvel, rho), cap, tp,
        r).numpy()
    jrho = jnp.asarray(rho.numpy())
    want = np.asarray(jcell.fluid_forces_slotted_rows(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(ids), jrho,
        jcell.pack_slots(jb.table, cap, n, jnp.asarray(pos),
                         jnp.asarray(vel), jrho), cap, jp, r))
    assert got[0, 0] == -np.inf and not np.isnan(got).any()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))


@pytest.mark.parametrize("neighbor", ["slotted", "gather"])
def test_capacity_none_raises(neighbor):
    cfg = SimConfig(**_GOLDEN_1K, voxel_capacity=None)
    with pytest.raises(ValueError, match="voxel_capacity=None"):
        make_frame_step(cfg, neighbor=neighbor, device="cpu")
    with pytest.raises(ValueError, match="voxel_capacity=None"):
        jstep(JConfig(**_GOLDEN_1K, voxel_capacity=None), neighbor=neighbor)


def test_gather_with_extensions_raises():
    # tests/test_extensions.py:80-82
    cfg = SimConfig(**_GOLDEN_1K, xsph=0.5)
    with pytest.raises(NotImplementedError):
        make_frame_step(cfg, neighbor="gather", device="cpu")
    with pytest.raises(NotImplementedError):
        make_rollout(cfg.replace(xsph=0.0, artificial_viscosity=0.2), 1,
                     neighbor="gather", device="cpu")
