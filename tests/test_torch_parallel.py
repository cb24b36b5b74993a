"""Scene batching (``parallel/batch.py``), the row-sharded domain step
(``parallel/domain.py``), the sites tier's slab step (``parallel/slab.py``)
and the entry points of ``entry.py`` against the JAX package, on the
CPU.

- ``BatchedScenes`` against JAX's on the slotted tier and (``slow``, JAX
  Pallas in interpret mode) on the sorted tier, each scene bit-equal to
  stepping it alone, over one device and over two.
- The domain step and the 2-D scenes × shards step against JAX's under
  ``jax.shard_map`` on the conftest's virtual CPU mesh (the tolerances of
  ``tests/test_parallel.py``).
- The sites slab step against the port's single-device sites step at the
  tolerances and certificate contracts of ``tests/test_slab.py`` (pos 2e-6,
  vel 2e-4), and against JAX's slab step.
- ``DistRing`` over gloo, two processes, equals ``LocalRing(2)`` bit for
  bit for the all-gather and the mean.
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
from jax.sharding import Mesh

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_tpu.params import stack_params as jstack_params
from sphfluidsimulation_tpu.parallel import domain as jdomain
from sphfluidsimulation_tpu.parallel import slab as jslab
from sphfluidsimulation_tpu.parallel.batch import BatchedScenes as JBatched
from sphfluidsimulation_tpu.sim.stepper import initial_state as jinit
from sphfluidsimulation_torch import entry as tentry
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.params import PhysParams, stack_params
from sphfluidsimulation_torch.parallel import (BatchedScenes, LocalRing,
                                               batch_configs, collect,
                                               distribute, domain,
                                               make_batched_slab_step,
                                               make_batched_sharded_step,
                                               make_sharded_frame_step,
                                               make_slab_rollout,
                                               make_slab_step, shard_state)
from sphfluidsimulation_torch.parallel import slab
from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                  make_frame_step)
from sphfluidsimulation_torch.state import (make_state, slab_state_to_numpy,
                                            stack_states)

# one intra-op thread, as in the port's other test modules
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_CFG = dict(particle_number=1024, bucket_resolution=11)      # test_parallel
# the calm physics of tests/test_pallas.py:18-21
_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, viscosity=0.05, stiffness_coefficient=1000.0,
             frame_dt=1 / 240)
# tests/test_slab.py:123-141: gentle physics, drift within the halo band
_SLAB = dict(particle_number=1024, bucket_resolution=11, site_capacity=24,
             gas_constant=1.0, viscosity=0.05)
SLAB_POS, SLAB_VEL = 2e-6, 2e-4           # tests/test_slab.py:164-167


def _mesh(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                names)


def _same_state(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- batching --

def _solo(cfg, neighbor, frames):
    step = make_frame_step(cfg, neighbor=neighbor, device="cpu")
    s = initial_state(cfg, "cpu")
    for _ in range(frames):
        s, m = step(s)
    return s, m


@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"]])
@pytest.mark.parametrize("neighbor", ["slotted", "sorted"])
def test_batched_scenes_bit_equal_to_each_scene_alone(neighbor, devices):
    cfg = SimConfig(particle_number=512, bucket_resolution=9)
    overrides = [{"rest_density": 1.0 + 0.2 * i, "seed": i}
                 for i in range(4)]
    bs = BatchedScenes(cfg, overrides, neighbor=neighbor, devices=devices)
    assert len(bs.blocks) == len(devices)
    bs.step(2)
    assert bs.frame == 2 and bs.last_metrics.max_speed.shape == (4,)
    for i, ov in enumerate(overrides):
        s, m = _solo(cfg.replace(**ov), neighbor, 2)
        _same_state([x[i] for x in bs.states], s)
        for a, b in zip(bs.last_metrics, m):
            assert torch.equal(a[i], b)


def test_batched_scenes_match_jax_slotted():
    # tests/test_parallel.py:60-72 without the mesh: the JAX batch and the
    # port's on the calm physics, 2 frames, each scene within 1e-5, the
    # tolerance of the slotted step against JAX's
    # (tests/test_torch_cellops.py:188-201; on the golden physics two
    # summation orders part by more, from the inf velocities on)
    overrides = [{"rest_density": 1.5 + 0.1 * i} for i in range(3)]
    jb = JBatched(JConfig(**_CALM), overrides)
    jb.step(2)
    bs = BatchedScenes(SimConfig(**_CALM), overrides, neighbor="slotted",
                       devices="cpu")
    bs.step(2)
    np.testing.assert_allclose(bs.states.pos.numpy(),
                               np.asarray(jb.states.pos), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(bs.last_metrics.overflow.numpy(),
                                  np.asarray(jb.last_metrics.overflow))
    torch.testing.assert_close(bs.params.rest_density,
                               torch.tensor([1.5, 1.6, 1.7]))


@pytest.mark.slow
def test_batched_scenes_match_jax_pallas():
    # JAX's sorted tier in interpret mode, two scenes of 512 particles on
    # the calm physics of tests/test_pallas.py, one frame (the tolerance
    # of the port's sorted tier against JAX pallas, test_torch_slab.py)
    calm = dict(_CALM, particle_number=512, bucket_resolution=9)
    overrides = [{"rest_density": 1.7}, {"rest_density": 1.9}]
    jb = JBatched(JConfig(**calm), overrides, neighbor="pallas")
    jb.step()
    bs = BatchedScenes(SimConfig(**calm), overrides, neighbor="pallas",
                       devices="cpu")
    bs.step()
    np.testing.assert_allclose(bs.states.pos.numpy(),
                               np.asarray(jb.states.pos), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(bs.last_metrics.overflow.numpy(),
                                  np.asarray(jb.last_metrics.overflow))


def test_batched_scenes_rejects_structural_mismatch():
    # the JAX ValueError (tests/test_parallel.py:75-77)
    with pytest.raises(ValueError, match="structural"):
        BatchedScenes(SimConfig(**_CFG), [{"particle_number": 4096}],
                      devices="cpu")
    with pytest.raises(ValueError, match="structural"):
        batch_configs(SimConfig(**_CFG), [{"bucket_resolution": 9}])
    with pytest.raises(ValueError, match="divide"):
        BatchedScenes(SimConfig(**_CFG), [{}] * 3, devices=["cpu", "cpu"])


def test_stack_params_matches_jax():
    cfgs = [dict(_CFG, rest_density=1.0 + 0.25 * i) for i in range(3)]
    got = stack_params([PhysParams.from_config(SimConfig(**c))
                        for c in cfgs])
    want = jstack_params([JPhys.from_config(JConfig(**c)) for c in cfgs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------ domain step --

@pytest.mark.parametrize("d", [4, 8])
def test_sharded_domain_matches_jax(d):
    # tests/test_parallel.py:29-41 (8 shards) and :44-57 (4 shards)
    jc, cfg = JConfig(**_CFG), SimConfig(**_CFG)
    mesh = _mesh((d,), ("sp",))
    jst, m_j = jax.jit(jdomain.make_sharded_frame_step(jc, mesh))(
        jdomain.shard_state(jinit(jc), mesh), JPhys.from_config(jc))
    ring = LocalRing(d)
    st, m = make_sharded_frame_step(cfg, ring, device="cpu")(
        shard_state(initial_state(cfg, "cpu"), ring),
        PhysParams.from_config(cfg))
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(jst.pos), rtol=0,
                               atol=2e-6)
    assert float(m.mean_density) == pytest.approx(float(m_j.mean_density),
                                                  rel=1e-5)
    assert int(m.overflow) == int(m_j.overflow)
    assert int(m.nan_events) == int(m_j.nan_events)
    # the same rows as the single-device gather tier, row block by block
    ref, _ = make_frame_step(cfg, neighbor="gather", device="cpu")(
        initial_state(cfg, "cpu"))
    np.testing.assert_allclose(st.pos.numpy(), ref.pos.numpy(), rtol=0,
                               atol=2e-6)


def test_2d_dp_sp_step_matches_jax():
    # tests/test_parallel.py:80-94: 2 scenes × 4 row shards
    jc, cfg = JConfig(**_CFG), SimConfig(**_CFG)
    dens = [1.2, 1.8]
    jstates = [jinit(jc.replace(rest_density=x)) for x in dens]
    jphys = jstack_params([JPhys.from_config(jc.replace(rest_density=x))
                           for x in dens])
    jnew, jm = jax.jit(jdomain.make_batched_sharded_step(
        jc, _mesh((2, 4), ("dp", "sp"))))(
        jax.tree.map(lambda *xs: jnp.stack(xs), *jstates), jphys)
    states = stack_states([initial_state(cfg.replace(rest_density=x), "cpu")
                           for x in dens])
    phys = stack_params([PhysParams.from_config(cfg.replace(rest_density=x))
                         for x in dens])
    new, m = make_batched_sharded_step(cfg, LocalRing(4), device="cpu")(
        states, phys)
    assert new.pos.shape == (2, cfg.n_particles, 3)
    assert m.mean_density.shape == (2,)
    np.testing.assert_allclose(new.pos.numpy(), np.asarray(jnew.pos),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(m.mean_density.numpy(),
                               np.asarray(jm.mean_density), rtol=1e-5)


def test_ring_gather_and_mean():
    ring = LocalRing(3)

    def step(my, x):
        g = yield ring.gather(x)
        mean = yield ring.pmean(x.sum())
        return g, mean

    xs = [torch.arange(4.0) + 10 * k for k in range(3)]
    outs = ring.run(step, [(x,) for x in xs])
    for g, mean in outs:
        assert torch.equal(g, torch.cat(xs))
        assert float(mean) == sum(float(x.sum()) for x in xs) / 3


# --------------------------------------------------------- sites slab step --

def _calm_state(cfg, seed=0, vscale=0.02):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, 0.95, (cfg.n_particles, 3)).astype(np.float32)
    vel = rng.normal(0.0, vscale, (cfg.n_particles, 3)).astype(np.float32)
    return make_state(torch.from_numpy(pos), torch.from_numpy(vel))


def _slab_vs_single(cfg, d, st, frames=1, **kw):
    step, spec = make_slab_step(cfg, LocalRing(d), device="cpu", **kw)
    phys = PhysParams.from_config(cfg)
    ref_step = make_frame_step(cfg, neighbor="sites", device="cpu")
    sst, ref, ms, mrs = distribute(st, cfg, spec), st, [], []
    for _ in range(frames):
        sst, m = step(sst, phys)
        ref, mr = ref_step(ref)
        ms.append(m)
        mrs.append(mr)
    out, lost = collect(sst, cfg.n_particles)
    return out, lost, sst, ms, ref, mrs


@pytest.mark.parametrize("d", [2, 4])
def test_sites_slab_matches_single_device(d):
    # tests/test_slab.py:144-169
    cfg = SimConfig(**_SLAB)
    out, lost, _, (m,), ref, (mr,) = _slab_vs_single(cfg, d,
                                                     _calm_state(cfg))
    assert lost == 0 and int(m.exact_cert) == 0
    assert int(m.overflow) == int(mr.overflow)
    torch.testing.assert_close(out.pos, ref.pos, rtol=0, atol=SLAB_POS)
    torch.testing.assert_close(out.vel, ref.vel, rtol=0, atol=SLAB_VEL)
    assert float(m.mean_density) == pytest.approx(float(mr.mean_density),
                                                  rel=1e-5)


@pytest.mark.slow
def test_sites_slab_multi_frame_migration():
    # tests/test_slab.py:172-196: particles cross slab boundaries; ids are
    # conserved, nothing is lost, positions track the single-device step
    cfg = SimConfig(**_SLAB)
    out, lost, sst, ms, ref, _ = _slab_vs_single(
        cfg, 8, _calm_state(cfg, seed=3, vscale=0.05), frames=3)
    assert lost == 0 and [int(m.exact_cert) for m in ms] == [0, 0, 0]
    pid = np.sort(sst.pid[sst.valid].numpy())
    assert np.array_equal(pid, np.arange(cfg.n_particles))
    torch.testing.assert_close(out.pos, ref.pos, rtol=0, atol=1e-5)


def test_sites_slab_memory_is_decomposed():
    # tests/test_slab.py:199-208, and the spec equal to JAX's
    cfg = SimConfig(**_SLAB)
    _, spec = make_slab_step(cfg, LocalRing(8), device="cpu")
    r = cfg.bucket_resolution
    assert spec.cap_rows == -(-2 * cfg.n_particles // 8)
    assert spec.slab_z == -(-r // 8)
    assert spec.slab_z + 2 * spec.halo < r
    assert tuple(spec) == tuple(jslab.make_spec(JConfig(**_SLAB), 8))


def test_sites_slab_cert_fires_on_overdrift():
    # tests/test_slab.py:211-227
    cfg = SimConfig(**_SLAB)
    rng = np.random.default_rng(7)
    pos = rng.uniform(0.05, 0.95, (cfg.n_particles, 3)).astype(np.float32)
    vel = np.zeros((cfg.n_particles, 3), np.float32)
    vel[:, 2] = 60.0
    st = make_state(torch.from_numpy(pos), torch.from_numpy(vel))
    step, spec = make_slab_step(cfg, LocalRing(8), device="cpu")
    _, m = step(distribute(st, cfg, spec), PhysParams.from_config(cfg))
    assert int(m.exact_cert) > 0


def test_sites_slab_preset_spawn_jitter_certifies_frame_1():
    # tests/test_slab.py:230-259: a slab run clamps out-of-cube evaluation
    # cells into its band and certifies them, one count per particle
    cfg = SimConfig(**dict(_SLAB, preset=1))
    st = initial_state(cfg, "cpu")
    r = cfg.bucket_resolution
    cell = (st.pos.numpy() * (r - 1)).astype(np.int32)
    n_jitter = int((cell != np.clip(cell, 0, r - 1)).any(-1).sum())
    assert n_jitter > 0
    step, spec = make_slab_step(cfg, LocalRing(2), device="cpu")
    sst, m = step(distribute(st, cfg, spec), PhysParams.from_config(cfg))
    out, lost = collect(sst, cfg.n_particles)
    assert lost == 0 and int(m.exact_cert) >= n_jitter
    assert bool(torch.isfinite(out.pos).all())


def test_batched_slab_dp_sp():
    # tests/test_slab.py:262-285: 2 scenes × 4 slabs, each scene as its own
    # single-device step
    base = SimConfig(**_SLAB)
    cfgs = [base.replace(rest_density=1.2), base.replace(rest_density=1.6)]
    states = [_calm_state(c, seed=10 + i) for i, c in enumerate(cfgs)]
    step, spec = make_batched_slab_step(base, LocalRing(4), device="cpu")
    ssts = [distribute(s, base, spec) for s in states]
    sst = slab.SlabState(*(torch.stack(xs) for xs in zip(*ssts)))
    sst, m = step(sst, stack_params([PhysParams.from_config(c)
                                     for c in cfgs]))
    for i, (c, st) in enumerate(zip(cfgs, states)):
        ref, mr = make_frame_step(c, neighbor="sites", device="cpu")(st)
        out, lost = collect(slab.SlabState(*(x[i] for x in sst)),
                            c.n_particles)
        assert lost == 0
        torch.testing.assert_close(out.pos, ref.pos, rtol=0, atol=SLAB_POS)
        assert float(m.mean_density[i]) == pytest.approx(
            float(mr.mean_density), rel=1e-5)


def test_sites_slab_extensions_match_single_device():
    # tests/test_slab.py:288-305
    cfg = SimConfig(**dict(_SLAB, xsph=0.1, artificial_viscosity=0.2))
    out, lost, _, (m,), ref, _ = _slab_vs_single(cfg, 4,
                                                 _calm_state(cfg, seed=11))
    assert lost == 0 and int(m.exact_cert) == 0
    torch.testing.assert_close(out.pos, ref.pos, rtol=0, atol=SLAB_POS)


def test_sites_slab_rollout_equals_stepping():
    cfg = SimConfig(**_SLAB)
    roll, spec = make_slab_rollout(cfg, LocalRing(2), 2, device="cpu")
    step, _ = make_slab_step(cfg, LocalRing(2), device="cpu")
    phys = PhysParams.from_config(cfg)
    sst0 = distribute(_calm_state(cfg), cfg, spec)
    got, ms = roll(sst0, phys)
    want = sst0
    for _ in range(2):
        want, _ = step(want, phys)
    _same_state(got, want)
    assert ms.exact_cert.shape == (2,)


def test_sites_slab_matches_jax_slab_step():
    # JAX's slab step under shard_map on 2 virtual devices, one frame, from
    # the same slab state: ids, validity and NaN counts equal, positions and
    # velocities within the slab tolerances, the certificate equal
    jc, cfg = JConfig(**_SLAB), SimConfig(**_SLAB)
    st = _calm_state(cfg)
    jstep, jspec = jslab.make_slab_step(jc, _mesh((2,), ("sp",)))
    from sphfluidsimulation_tpu.state import make_state as jmake
    jst = jslab.distribute(jmake(jnp.asarray(st.pos.numpy()),
                                 jnp.asarray(st.vel.numpy())), jc, jspec)
    jst, jm = jax.jit(jstep)(jst, JPhys.from_config(jc))
    step, spec = make_slab_step(cfg, LocalRing(2), device="cpu")
    assert tuple(spec) == tuple(jspec)
    sst, m = step(distribute(st, cfg, spec), PhysParams.from_config(cfg))
    got, want = slab_state_to_numpy(sst), [np.asarray(x) for x in jst]
    for k in (2, 3, 4):                   # nan_count, pid, valid
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=SLAB_POS)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SLAB_VEL)
    assert int(m.exact_cert) == int(jm.exact_cert)
    assert int(m.overflow) == int(jm.overflow)


def test_sites_slab_local_binding_and_halo_match_jax():
    # the slab-local binding (capacity ranks by pid) and i-sites of one
    # shard, integer-equal to JAX's, on rows that crowd one voxel
    cfg = SimConfig(**_SLAB)
    spec = slab.make_spec(cfg, 4)
    jspec = jslab.make_spec(JConfig(**_SLAB), 4)
    rng = np.random.default_rng(2)
    c = spec.cap_rows
    pos = rng.uniform(0.2, 0.5, (c, 3)).astype(np.float32)
    pos[:80] = [0.31, 0.32, 0.33]
    pid = rng.permutation(c).astype(np.int32)
    valid = rng.random(c) < 0.7
    r = cfg.bucket_resolution
    t = [torch.from_numpy(a) for a in (pos, pid, valid)]
    got = slab._bind_local_capped(*t, 1, r, 32, spec)
    want = jslab._bind_local_capped(*map(jnp.asarray, (pos, pid, valid)), 1,
                                    r, 32, jspec)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rho = rng.uniform(1, 2, c).astype(np.float32)
    i = slab._build_i_local(t[0], None, torch.from_numpy(rho), t[1], t[2], 1,
                            r, 8, spec)
    ji = jslab._build_i_local(jnp.asarray(pos), None, jnp.asarray(rho),
                              jnp.asarray(pid), jnp.asarray(valid), 1, r, 8,
                              jspec)
    for f in ("slot_of", "occ", "cert"):
        np.testing.assert_array_equal(getattr(i, f).numpy(),
                                      np.asarray(getattr(ji, f)), err_msg=f)


# ---------------------------------------------------------- entry points --

def test_dryrun_multichip_8(capsys):
    tentry.dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh dp=2 sp=4" in out


def test_entry_returns_the_frame_step_and_its_arguments():
    step, (state, phys) = tentry.entry("cpu")
    assert state.pos.shape == (65536, 3) and state.pos.device.type == "cpu"
    assert float(phys.h) == pytest.approx(1 / 30)
    # the step is the configuration's frame step (a 512-particle state of
    # the same structure would not fit it: shapes come from the config)
    assert callable(step)


@pytest.mark.parametrize("call", ["BatchedScenes", "make_slab_step",
                                  "make_sharded_frame_step", "entry",
                                  "dryrun_multichip"])
def test_new_entry_points_need_the_card(monkeypatch, call):
    # the port runs on the card unless the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(**_SLAB)
    fn = {"BatchedScenes": lambda: BatchedScenes(cfg, [{}]),
          "make_slab_step": lambda: make_slab_step(cfg, LocalRing(2)),
          "make_sharded_frame_step": lambda: domain.make_sharded_frame_step(
              cfg, LocalRing(2)),
          "entry": tentry.entry,
          "dryrun_multichip": lambda: tentry.dryrun_multichip(8)}[call]
    with pytest.raises(RuntimeError, match="CUDA device"):
        fn()


# ------------------------------------------------------- DistRing / gloo --

_RANK = """
import datetime, sys, torch
import torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from sphfluidsimulation_torch import SimConfig
from sphfluidsimulation_torch.params import PhysParams
from sphfluidsimulation_torch.parallel import (DistRing, distribute,
                                               make_sharded_frame_step,
                                               make_slab_step, shard_state)
from sphfluidsimulation_torch.sim.stepper import initial_state
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={store!r}, rank=rank,
                        world_size=2,
                        timeout=datetime.timedelta(seconds=60))
cfg = SimConfig(**{cfg!r})
ring = DistRing()
phys = PhysParams.from_config(cfg)
step = make_sharded_frame_step(cfg, ring, device="cpu")
st = shard_state(initial_state(cfg, "cpu"), ring)
st, m = step(st, phys)
sstep, spec = make_slab_step(cfg, ring, device="cpu")
sst = distribute(initial_state(cfg, "cpu"), cfg, spec)
c = spec.cap_rows
sst = type(sst)(*(t[rank * c:(rank + 1) * c] for t in sst))
sst, sm = sstep(sst, phys)
torch.save((tuple(st), tuple(m), tuple(sst), tuple(sm)),
           {out!r} + str(rank))
dist.destroy_process_group()
"""


def test_dist_ring_over_gloo_equals_local_ring(tmp_path):
    # two processes, one shard each: the domain step (all-gather, pmean)
    # and the sites slab step (halo exchange, migration) bit for bit as
    # LocalRing(2)
    out = str(tmp_path / "rank")
    kw = dict(_SLAB, particle_number=512, bucket_resolution=9)
    code = _RANK.format(root=str(ROOT), cfg=kw, out=out,
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
    cfg = SimConfig(**kw)
    phys = PhysParams.from_config(cfg)
    ring = LocalRing(2)
    st, m = make_sharded_frame_step(cfg, ring, device="cpu")(
        initial_state(cfg, "cpu"), phys)
    sstep, spec = make_slab_step(cfg, ring, device="cpu")
    sst, sm = sstep(distribute(initial_state(cfg, "cpu"), cfg, spec), phys)
    shards = [torch.load(out + str(k)) for k in range(2)]
    for k in range(3):
        assert torch.equal(torch.cat([s[0][k] for s in shards]), st[k])
    for k in range(5):
        assert torch.equal(torch.cat([s[2][k] for s in shards]), sst[k])
    for s in shards:
        for a, b in zip(s[1], m):
            assert torch.equal(a, b)
        for a, b in zip(s[3], sm):
            assert torch.equal(a, b)
