"""The recorded frames of the slab step and of ``Scene`` on the CPU.

On the card ``make_pallas_slab_step`` with a ``LocalRing`` replays one
recorded frame a call (``slab_pallas.GraphSlabStep``) and ``Scene(jit=True)``
one a frame (``graph.RecordedStep`` over ``graph.step_body``). The graph
needs the card; on the CPU these tests run the recorded body eagerly on its
carry, either directly (``GraphSlabStep.load/advance/result``) or through the
entry points with ``RecordedStep.replay`` running the body eagerly in place
of a capture (the ``eager_replay`` fixture), and hold it to the host loop
bit for bit: on two and four slabs, with the extension sums, on the compact
route, on the violent scene whose certificate fires every frame, and
``Scene`` in faithful, corrected and compact modes. They also pin the choice
of host loop or graph, that the carry takes each call's state and physics,
and that ``Scene.state`` and ``last_metrics`` are copies. The body against
JAX's jitted ``Scene`` (its pallas tier in interpret mode) is ``slow``; the
host loops themselves are held to JAX in ``tests/test_torch_slab.py`` and
``tests/test_torch_rollout.py``. The card's side is in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.models.scene import Scene as JScene
from sphfluidsimulation_torch import Scene, SimConfig
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning
from sphfluidsimulation_torch.params import PhysParams
from sphfluidsimulation_torch.parallel import (DistRing, LocalRing,
                                               distribute,
                                               make_pallas_slab_step,
                                               slab_pallas)
from sphfluidsimulation_torch.sim import graph
from sphfluidsimulation_torch.sim.stepper import initial_state
from sphfluidsimulation_torch.state import state_from_numpy

# one intra-op thread, as in the port's other test modules
torch.set_num_threads(1)

CPU, CUDA = torch.device("cpu"), torch.device("cuda")
# tests/test_slab_pallas.py:20-22
_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
CALM = SimConfig(**_CALM)
EXT = dict(xsph=0.1, artificial_viscosity=0.05)
COMPACT = SortedTuning(compact=True)
# the tolerances of tests/test_slab_pallas.py:50-55, as
# tests/test_torch_slab.py states them
POS_ATOL, VEL_ATOL = 2e-5, 2e-4
# each route of the slab step the graph records: (config, shards, keywords)
SLAB_CASES = {
    "2-slabs": (CALM, 2, {}),
    "4-slabs": (CALM, 4, {}),
    "extensions": (CALM.replace(**EXT), 4, {}),
    "compact": (CALM, 4, dict(tune=COMPACT)),
    # tests/test_torch_slab.py::test_slab_step_violent_degrades_certified
    "violent": (SimConfig(particle_number=4096, bucket_resolution=17), 4,
                {}),
}
SCENE_MODES = {"faithful": {}, "corrected": dict(faithful=False),
               "compact": dict(tune=COMPACT)}


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def _same_bits(a, b):
    """Equal tensors, NaNs and signed zeros bit for bit."""
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(_bits(x), _bits(y))


@pytest.fixture
def eager_replay(monkeypatch):
    """The entry points take their recorded route on the CPU, and a replay
    runs the recorded body eagerly on the carry (no capture)."""
    monkeypatch.setattr(slab_pallas, "choose_host_loop",
                        lambda ring, device, host_loop: bool(host_loop))
    monkeypatch.setattr(graph, "choose_host_loop",
                        lambda neighbor, device, host_loop: bool(host_loop))
    monkeypatch.setattr(graph.RecordedStep, "replay",
                        lambda self: self._advance(self._carry))


def _slab(case, **kw):
    cfg, d, opts = SLAB_CASES[case]
    step, spec = make_pallas_slab_step(cfg, LocalRing(d), row_slack=4.0,
                                       device="cpu", **opts, **kw)
    return cfg, step, spec


def _host_frames(step, sst, phys, n):
    """(state, metrics) after each of ``n`` frames of the host loop."""
    out = []
    for _ in range(n):
        sst, m = step(sst, phys)
        out.append((sst, m))
    return out


@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_slab_body_is_bit_equal_to_the_host_loop(case):
    # the recorded frame is the host loop's step over the carry: the state
    # and every metric lane after each of 3 frames, bit for bit
    cfg, step, spec = _slab(case)
    assert step.host_loop is True
    phys = PhysParams.from_config(cfg)
    sst = distribute(initial_state(cfg, "cpu"), cfg, spec)
    want = _host_frames(step, sst, phys, 3)
    body = slab_pallas.GraphSlabStep(step, spec.d * spec.cap_rows, CPU)
    body.load(sst, phys)
    for w_st, w_m in want:
        body.advance(body.carry)
        st, m = body.result()
        _same_bits((*st, *m), (*w_st, *w_m))
    if case == "violent":
        assert min(int(m.exact_cert) for _, m in want) > 0


def test_slab_carry_takes_each_calls_state_and_physics():
    # one carry, reused: a call with another state and another dt gives the
    # host loop's step of that state with that dt (JAX traces phys)
    cfg, step, spec = _slab("2-slabs")
    phys = PhysParams.from_config(cfg)
    fast = phys._replace(dt=phys.dt * 2, viscosity=phys.viscosity * 0.5)
    s0 = distribute(initial_state(cfg, "cpu"), cfg, spec)
    s1, _ = step(s0, phys)
    body = slab_pallas.GraphSlabStep(step, spec.d * spec.cap_rows, CPU)
    for st, ph in ((s0, phys), (s1, fast), (s0, fast), (s1, phys)):
        body.load(st, ph)
        body.advance(body.carry)
        (got, m), (want, wm) = body.result(), step(st, ph)
        _same_bits((*got, *m), (*want, *wm))
    with pytest.raises(ValueError, match="shape"):
        body.load(slab_pallas.SlabState(*(x[:8] for x in s0)), phys)


def test_slab_graph_entry_point_returns_fresh_tensors(eager_replay):
    # through the entry point (replay run eagerly): the caller's state may
    # be the previous call's output; each call returns new tensors that the
    # next call leaves as they were
    cfg, step, spec = _slab("2-slabs")
    host, _ = make_pallas_slab_step(cfg, LocalRing(2), row_slack=4.0,
                                    device="cpu", host_loop=True)
    assert isinstance(step, slab_pallas.GraphSlabStep)
    assert step.host_loop is False and host.host_loop is True
    phys = PhysParams.from_config(cfg)
    sst = distribute(initial_state(cfg, "cpu"), cfg, spec)
    want = _host_frames(host, sst, phys, 3)
    outs, st = [], sst
    for _ in range(3):
        st, m = step(st, phys)
        outs.append((st, m))
    for (st, m), (w_st, w_m) in zip(outs, want):
        _same_bits((*st, *m), (*w_st, *w_m))
        assert all(x.data_ptr() != c.data_ptr() for x, c in
                   zip(st, step.carry.state))


def _dist_ring(d=2):
    # a DistRing without a process group: the choice reads only its type
    ring = DistRing.__new__(DistRing)
    ring.d, ring.rank, ring.group = d, 0, None
    return ring


@pytest.mark.parametrize("local,device,host_loop,want", [
    (True, CUDA, None, False), (True, CUDA, False, False),
    (True, CUDA, True, True), (True, CPU, None, True),
    (True, CPU, True, True), (True, CPU, False, RuntimeError),
    (False, CUDA, None, True), (False, CUDA, True, True),
    (False, CPU, None, True), (False, CUDA, False, NotImplementedError),
    (False, CPU, False, NotImplementedError)])
def test_slab_choice_of_graph_or_host_loop(local, device, host_loop, want):
    # None: the graph on the card with a LocalRing, else the host loop;
    # False never falls back: on the CPU it raises as choose_host_loop
    # does, and over a DistRing (NCCL capture, ROADMAP A15)
    ring = LocalRing(2) if local else _dist_ring()
    if isinstance(want, bool):
        assert slab_pallas.choose_host_loop(ring, device, host_loop) is want
        if local:
            assert want is graph.choose_host_loop("sorted", device,
                                                  host_loop)
        return
    with pytest.raises(want, match="A15" if want is NotImplementedError
                       else "card"):
        slab_pallas.choose_host_loop(ring, device, host_loop)


def test_slab_step_reports_its_host_loop_on_the_cpu():
    for host_loop in (None, True):
        step, _ = make_pallas_slab_step(CALM, LocalRing(2), device="cpu",
                                        row_slack=4.0, host_loop=host_loop)
        assert step.host_loop is True
    with pytest.raises(RuntimeError, match="card"):
        make_pallas_slab_step(CALM, LocalRing(2), device="cpu",
                              host_loop=False)
    with pytest.raises(NotImplementedError, match="A15"):
        make_pallas_slab_step(CALM, _dist_ring(), device="cpu",
                              host_loop=False)


# ------------------------------------------------------------ Scene(jit) --

@pytest.mark.parametrize("mode", sorted(SCENE_MODES))
def test_scene_body_is_bit_equal_to_the_eager_step(eager_replay, mode):
    # Scene(jit=True)'s recorded route, each replay run eagerly, against
    # jit=False: the state and every metric lane after each of 3 frames
    cfg = CALM.replace(**EXT) if mode == "corrected" else CALM
    kw = SCENE_MODES[mode]
    rec = Scene(cfg, device="cpu", **kw)
    eager = Scene(cfg, device="cpu", jit=False, **kw)
    assert rec.host_loop is False and eager.host_loop is True
    assert rec.last_metrics is None
    for f in range(3):
        got, want = rec.step(), eager.step()
        _same_bits(got, want)
        _same_bits(rec.last_metrics, eager.last_metrics)
        assert rec.frame == eager.frame == f + 1


def test_scene_state_and_metrics_are_copies(eager_replay):
    scene = Scene(CALM, device="cpu")
    s0 = scene.state
    assert s0.pos.data_ptr() != scene.state.pos.data_ptr()
    scene.step()
    m1, s1 = scene.last_metrics, scene.state
    _same_bits(s0, initial_state(CALM, "cpu"))   # the carry moved on alone
    s1.pos.fill_(0.5)
    m1.max_speed.fill_(-1.0)
    scene.step()
    eager = Scene(CALM, device="cpu", jit=False)
    eager.step(2)
    _same_bits(scene.state, eager.state)
    _same_bits(scene.last_metrics, eager.last_metrics)
    # reset loads the spawn into the carry; setting the state loads it too
    _same_bits(scene.reset(), initial_state(CALM, "cpu"))
    assert scene.frame == 0
    scene.state = eager.state
    _same_bits(scene.state, eager.state)
    with pytest.raises(ValueError, match="shape"):
        scene.state = type(s0)(*(x[:8] for x in s0))


@pytest.mark.parametrize("jit", [True, False])
@pytest.mark.parametrize("neighbor", ["sorted", "slotted", "sites"])
def test_scene_steps_eagerly_on_the_cpu_and_off_the_sorted_tier(neighbor,
                                                                jit):
    # as choose_host_loop(None): only the sorted tier on the card records;
    # the CPU and the other tiers step eagerly whatever jit says
    scene = Scene(CALM, neighbor=neighbor, device="cpu", jit=jit)
    assert scene.host_loop is True
    st = scene.step()
    assert scene.state is st and scene.frame == 1


@pytest.mark.slow
def test_scene_body_matches_jax_jitted_scene(eager_replay):
    # JAX's jitted Scene on its pallas tier (interpret mode on the CPU)
    # against the recorded Scene's body, 2 frames of the calm scene from
    # JAX's spawn, within the slab tests' POS_ATOL / VEL_ATOL
    jscene = JScene(JConfig(**_CALM), neighbor="pallas", jit=True)
    scene = Scene(CALM, device="cpu")
    js = jscene.state
    scene.state = state_from_numpy(np.asarray(js.pos), np.asarray(js.vel),
                                   np.asarray(js.nan_count))
    for _ in range(2):
        jst = jscene.step()
        st = scene.step()
        np.testing.assert_allclose(st.pos.numpy(), np.asarray(jst.pos),
                                   rtol=0, atol=POS_ATOL)
        np.testing.assert_allclose(st.vel.numpy(), np.asarray(jst.vel),
                                   rtol=0, atol=VEL_ATOL)
        jm, m = jscene.last_metrics, scene.last_metrics
        assert int(m.overflow) == int(jm.overflow)
        assert int(m.nan_events) == int(jm.nan_events)
