"""The torch port's faithful dam-break rollout (sorted tier) against the
JAX package: the pinned golden trajectory, calm-config tracking of the
brute oracle, bit-equality of the sorted rollout with per-frame stepping,
and the uncapped bucket."""

import os

import numpy as np
import jax
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.sim.stepper import (initial_state as jinit,
                                                make_frame_step as jstep)
from sphfluidsimulation_torch import Scene, SimConfig
from sphfluidsimulation_torch.bench import run_bench, scaled_config
from sphfluidsimulation_torch.ops.frame import build_frame
from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                  make_frame_step,
                                                  make_rollout)

DATA = os.path.join(os.path.dirname(__file__), "data",
                    "golden_dambreak_1k.npz")
_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)


def test_golden_1k_trajectory():
    # bounds of tests/test_golden.py:63-66 (the pallas tier's)
    cfg = SimConfig(particle_number=1024, bucket_resolution=11, preset=1)
    s1, _ = make_rollout(cfg, 1)(initial_state(cfg))
    s5, m = make_rollout(cfg, 4)(s1)
    with np.load(DATA) as z:
        g1, g5 = z["pos_1"], z["pos_5"]
    assert np.abs(s1.pos.numpy() - g1).max() < 1e-5
    assert np.sqrt(np.mean((s5.pos.numpy() - g5) ** 2)) < 1e-3
    assert int(m.exact_cert.sum()) == 0


def test_calm_rollout_tracks_brute():
    jc, tc = JConfig(**_CALM), SimConfig(**_CALM)
    bstep = jax.jit(jstep(jc, neighbor="brute"))
    sb = jinit(jc)
    ovf = []
    for _ in range(5):
        sb, mb = bstep(sb)
        ovf.append(int(mb.overflow))
    final, m = make_rollout(tc, 5)(initial_state(tc))
    np.testing.assert_allclose(final.pos.numpy(), np.asarray(sb.pos),
                               rtol=0, atol=5e-4)
    assert m.exact_cert.tolist() == [0] * 5
    assert m.overflow.tolist() == ovf
    assert m.overflow.dtype == torch.int32 and m.max_speed.shape == (5,)


def test_sorted_rollout_bit_equal_to_per_frame_stepping():
    cfg = SimConfig(**_CALM)
    st = initial_state(cfg)
    final, _ = make_rollout(cfg, 3)(st)
    step = make_frame_step(cfg)
    s = st
    for _ in range(3):
        s, _ = step(s)
    for a, b in zip(final, s):
        assert torch.equal(a, b)


def test_capacity_none_never_drops_and_matches_brute():
    rng = np.random.default_rng(7)
    # 256 particles crammed into one corner cell: far beyond any cap
    pos = torch.from_numpy(rng.uniform(0, 0.05, (256, 3)).astype(np.float32))
    frame, _ = build_frame(pos, 9, None)
    assert bool(frame.occ.all())

    kw = dict(_CALM, voxel_capacity=None)
    jc, tc = JConfig(**kw), SimConfig(**kw)
    sb, mb = jax.jit(jstep(jc, neighbor="brute"))(jinit(jc))
    st, m = make_frame_step(tc)(initial_state(tc))
    assert int(m.overflow) == 0 and int(mb.overflow) == 0
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(sb.pos),
                               rtol=0, atol=1e-6)


def test_scene_steps():
    scene = Scene(SimConfig(**_CALM))
    st = scene.step(2)
    assert scene.frame == 2 and st.pos.shape == (1024, 3)
    assert bool(torch.isfinite(st.pos).all())
    assert scene.last_metrics.exact_cert.item() == 0
    scene.reset()
    assert scene.frame == 0


@pytest.mark.parametrize("neighbor",
                         ["brute", "slotted", "gather", "sites", "pallas"])
def test_unported_backends_raise(neighbor):
    cfg = SimConfig(**_CALM)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_frame_step(cfg, neighbor=neighbor)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_rollout(cfg, 2, neighbor=neighbor)


def test_unported_modes_raise():
    cfg = SimConfig(**_CALM)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_frame_step(cfg, faithful=False)
    for kw in (dict(xsph=0.1), dict(artificial_viscosity=0.5)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_rollout(cfg.replace(**kw), 1)
    with pytest.raises(ValueError):
        make_frame_step(cfg, neighbor="nope")


def test_scaled_config_occupancy():
    assert scaled_config(262144).bucket_resolution == 47
    assert scaled_config(1 << 20).bucket_resolution == 75
    assert scaled_config(1 << 20).n_particles == 1 << 20


def test_run_bench_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_bench(1024, frames=1, warmup_frames=1)


def test_rollout_opens_its_profiler_ranges():
    # scripts/torch_frame_breakdown.py reads each phase's device time from
    # these ranges, so they must wrap the path make_rollout really runs
    from sphfluidsimulation_torch.sim.stepper import FRAME_PHASES
    cfg = SimConfig(**_CALM)
    roll = make_rollout(cfg, 2)
    st = initial_state(cfg)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        final, _ = roll(st)
    counts = dict.fromkeys(FRAME_PHASES, 0)
    for e in prof.events():
        if e.name in counts:
            counts[e.name] += 1
    assert counts == {"build_frame": 2, "density": 2, "pack_rows": 2,
                      "fused_substep": 2 * cfg.substeps,
                      "unpack+metrics": 2}
    # the ranges do not change the result
    for a, b in zip(final, roll(st)[0]):
        assert torch.equal(a, b)
