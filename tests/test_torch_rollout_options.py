"""The torch port's rollout options against the contracts of
tests/test_rollout.py:94-191: snapshots (``make_rollout(snapshot_every=)``)
and the recorded-dt replay (``make_dt_rollout``), on the brute, slotted and
sorted tiers, and the replay against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.sim.stepper import (initial_state as jinit,
                                                make_dt_rollout as jdt)
from sphfluidsimulation_torch import (PhysParams, SimConfig, initial_state,
                                      make_dt_rollout, make_param_step,
                                      make_rollout)

# one intra-op thread: the suite runs in several worker processes on
# shared cores, where each worker's spinning OpenMP threads slowed the
# port's many small CPU ops about fivefold
torch.set_num_threads(1)

# tests/test_rollout.py:17 (golden physics) and the calm scene of
# tests/test_pallas.py:18-21
CFG = SimConfig(particle_number=1024, bucket_resolution=11)
_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
CALM = SimConfig(**_CALM)
TIERS = ["brute", "slotted", "sorted"]
# a jittery 120-480 FPS trace (tests/test_rollout.py:138-141)
DTS = np.array([1 / 240, 1 / 120, 1 / 360, 1 / 180, 1 / 480, 1 / 240],
               np.float32)


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("neighbor", TIERS)
def test_snapshots_every_frame(neighbor):
    # tests/test_rollout.py:94-98
    final, m, snaps = make_rollout(CALM, 3, neighbor=neighbor,
                                   snapshot_every=1, device="cpu")(
        initial_state(CALM, "cpu"))
    assert snaps.shape == (3, CALM.n_particles, 3)
    assert torch.equal(snaps[-1], final.pos)
    assert m.max_speed.shape == (3,)


@pytest.mark.parametrize("neighbor", TIERS)
def test_snapshots_every_n(neighbor):
    # tests/test_rollout.py:101-116: every-N keeps frames N-1, 2N-1, ...
    # and matches the every-1 frames; the final state and the metrics are
    # those of the rollout without snapshots, bit for bit
    st = initial_state(CALM, "cpu")
    _, m1, s1 = make_rollout(CALM, 4, neighbor=neighbor, snapshot_every=1,
                             device="cpu")(st)
    f2, m2, s2 = make_rollout(CALM, 4, neighbor=neighbor, snapshot_every=2,
                              device="cpu")(st)
    f0, m0 = make_rollout(CALM, 4, neighbor=neighbor, device="cpu")(st)
    assert s2.shape == (2, CALM.n_particles, 3)
    assert torch.equal(s2[0], s1[1]) and torch.equal(s2[1], s1[3])
    _equal(m2, m1)
    _equal(m2, m0)
    _equal(f2, f0)
    assert torch.equal(s2[1], f0.pos)


@pytest.mark.parametrize("snapshot_every", [2, -1])
def test_snapshot_every_must_divide_the_frames(snapshot_every):
    with pytest.raises(ValueError, match="snapshot_every"):
        make_rollout(CALM, 3, snapshot_every=snapshot_every, device="cpu")
    with pytest.raises(ValueError, match="snapshot_every"):
        make_dt_rollout(CALM, 3, snapshot_every=snapshot_every,
                        device="cpu")


def _step_frames(cfg, neighbor, st, dts):
    step = make_param_step(cfg, neighbor=neighbor)
    base = PhysParams.from_config(cfg, "cpu")
    div = torch.tensor(cfg.substep_divisor, dtype=torch.float32)
    for dt in dts:
        st, _ = step(st, base._replace(
            dt=torch.tensor(dt, dtype=torch.float32) / div))
    return st


@pytest.mark.parametrize("neighbor", TIERS)
def test_dt_schedule_is_bit_equal_to_per_frame_stepping(neighbor):
    # tests/test_rollout.py:124-158 pins JAX's replay to stepping within a
    # tolerance (XLA compiles the two differently); the port runs the same
    # frame step either way, so the contract here is bit-equality
    st = initial_state(CFG, "cpu")
    final, m = make_dt_rollout(CFG, len(DTS), neighbor=neighbor,
                               device="cpu")(st, DTS)
    _equal(final, _step_frames(CFG, neighbor, st, DTS))
    assert m.max_speed.shape == (len(DTS),)
    # snapshots ride the same loop
    f2, _, snaps = make_dt_rollout(CFG, len(DTS), neighbor=neighbor,
                                   snapshot_every=3, device="cpu")(
        st, torch.from_numpy(DTS))
    _equal(f2, final)
    assert snaps.shape == (2, CFG.n_particles, 3)
    assert torch.equal(snaps[1], final.pos)


@pytest.mark.parametrize("neighbor", ["slotted", "sorted"])
def test_dt_schedule_split_trace_is_bit_equal(neighbor):
    # tests/test_rollout.py:161-178: a 6-frame trace in one call equals 3 + 3
    # with the state carried across, bit for bit
    st = initial_state(CFG, "cpu")
    dts = np.array([1 / 60, 1 / 30, 1 / 90, 1 / 45, 1 / 120, 1 / 60],
                   np.float32)
    f6, _ = make_dt_rollout(CFG, 6, neighbor=neighbor, device="cpu")(st,
                                                                     dts)
    r3 = make_dt_rollout(CFG, 3, neighbor=neighbor, device="cpu")
    mid, _ = r3(st, dts[:3])
    f33, _ = r3(mid, dts[3:])
    _equal(f6, f33)


@pytest.mark.parametrize("neighbor", ["slotted", "sorted"])
def test_dt_schedule_constant_matches_fixed_rollout(neighbor):
    """tests/test_rollout.py:181-191: a constant schedule at frame_dt gives
    the fixed-dt rollout up to the rounding of the substep dt. The fixed
    rollout rounds frame_dt / 25 once from float64; the replay divides in
    float32, which can land one ulp away (it does at 1/240 and 1/60). JAX's
    XLA turns that division into a product with 1/25 and lands on the fixed
    dt, so JAX's test can run golden physics; the golden EOS moves the
    positions by 1.6e-5 in 4 frames for one ulp of dt (this CPU), so here
    the scene is the calm one, at JAX's bound of 2e-6 (measured 3.7e-9)."""
    div = torch.tensor(CALM.substep_divisor, dtype=torch.float32)
    dt_replay = torch.tensor(CALM.frame_dt, dtype=torch.float32) / div
    dt_fixed = PhysParams.from_config(CALM).dt
    assert abs(float(dt_replay) - float(dt_fixed)) <= float(
        torch.finfo(torch.float32).eps * dt_fixed)
    st = initial_state(CALM, "cpu")
    f1, _ = make_rollout(CALM, 4, neighbor=neighbor, device="cpu")(st)
    f2, _ = make_dt_rollout(CALM, 4, neighbor=neighbor, device="cpu")(
        st, np.full(4, CALM.frame_dt, np.float32))
    np.testing.assert_allclose(f1.pos.numpy(), f2.pos.numpy(), atol=2e-6)


def test_dt_rollout_matches_jax_on_slotted():
    """``make_dt_rollout`` on the slotted tier against JAX's on the calm
    scene over the jittery trace: positions within 2e-6, velocities within
    1e-4 (the bounds of tests/test_rollout.py:153-156), the overflow per
    frame equal."""
    jc = JConfig(**_CALM)
    jf, jm = jdt(jc, len(DTS), neighbor="slotted")(jinit(jc),
                                                    jnp.asarray(DTS))
    tf, tm = make_dt_rollout(CALM, len(DTS), neighbor="slotted",
                             device="cpu")(initial_state(CALM, "cpu"), DTS)
    np.testing.assert_allclose(tf.pos.numpy(), np.asarray(jf.pos), atol=2e-6)
    np.testing.assert_allclose(tf.vel.numpy(), np.asarray(jf.vel), rtol=1e-4,
                               atol=1e-4)
    assert tm.overflow.tolist() == np.asarray(jm.overflow).tolist()
