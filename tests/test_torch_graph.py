"""The sorted tier's graph rollout (``sim/graph.py``) on the CPU.

The graph replays ``FrameBody``; on the CPU the same body runs eagerly, and
these tests hold it to the host loop of ``make_rollout`` /
``make_dt_rollout`` bit for bit on every route and variant it records
(faithful and corrected, the window and compact routes, unfused,
``fuse_acc`` off, ``kahan``, ``bf16``, snapshots, a dt schedule), check that
each metric lane and snapshot slot lands at its frame, and hold the port's
rollout from a JAX state to JAX's scanned ``make_rollout(neighbor="pallas")``
(``slow``: JAX Pallas in interpret mode). They also pin the choice between
the graph and the host loop (``host_loop``), and that ``run_bench`` and
``bench --host-loop`` record and pass on the mode. The card's side, the
recorded graph itself, is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.sim.stepper import initial_state as jinit
from sphfluidsimulation_tpu.sim.stepper import make_rollout as jrollout
from sphfluidsimulation_torch import (SimConfig, bench, cli, initial_state,
                                      make_dt_rollout, make_rollout)
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning
from sphfluidsimulation_torch.sim import graph
from sphfluidsimulation_torch.state import StepMetrics, state_from_numpy

# one intra-op thread, as in the port's other test modules
torch.set_num_threads(1)

CPU = torch.device("cpu")
# tests/test_pallas.py:18-21 and tests/test_rollout.py:17
_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
SCENES = {"calm": _CALM,
          "golden": dict(particle_number=1024, bucket_resolution=11)}
EXT = dict(xsph=0.3, artificial_viscosity=0.4)
# a jittery 120-480 FPS trace (tests/test_rollout.py:138-141)
DTS = [1 / 240, 1 / 120, 1 / 360]
# each route and variant the body records: (rollout keywords, extension
# coefficients, frames)
CASES = {
    "faithful": (dict(), {}, 2),
    "corrected": (dict(faithful=False), EXT, 2),
    "compact": (dict(tune=SortedTuning(compact=True)), {}, 2),
    "compact-corrected": (dict(faithful=False,
                               tune=SortedTuning(compact=True)), {}, 2),
    "unfused": (dict(tune=SortedTuning(fused=False)), {}, 2),
    "facc0": (dict(tune=SortedTuning(fuse_acc=False)), EXT, 2),
    "kahan": (dict(tune=SortedTuning(kahan=True)), {}, 2),
    "bf16": (dict(tune=SortedTuning(bf16=True)), EXT, 2),
    "snapshots": (dict(snapshot_every=2), {}, 4),
    "dt": (dict(dts=DTS), {}, len(DTS)),
}


def _body(cfg, n_frames, faithful=True, snapshot_every=0, tune=None,
          dts=None):
    return graph.FrameBody(cfg, n_frames, faithful=faithful,
                           snapshot_every=snapshot_every,
                           tune=tune or SortedTuning(), device=CPU,
                           dt=dts is not None)


def _eager(body, state, dts=None):
    """The body run eagerly in a loop, as the graph replays it."""
    carry = body.new_carry()
    body.load(carry, state, dts)
    for _ in range(body.replays):
        body.advance(carry)
    return body.result(carry)


def _host_loop(cfg, n_frames, state, dts=None, **kw):
    if dts is None:
        roll = make_rollout(cfg, n_frames, device="cpu", host_loop=True,
                            **kw)
        out = roll(state)
    else:
        roll = make_dt_rollout(cfg, n_frames, device="cpu", host_loop=True,
                               **kw)
        out = roll(state, dts)
    assert roll.host_loop is True
    return out


def _flat(out):
    return [t for x in out for t in (x if isinstance(x, tuple) else (x,))]


def _same_bits(a, b):
    """Equal tensors, NaNs and signed zeros bit for bit."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_body_is_bit_equal_to_the_host_loop(scene, case):
    kw, ext, n_frames = CASES[case]
    cfg = SimConfig(**SCENES[scene], **ext)
    st = initial_state(cfg, "cpu")
    want = _host_loop(cfg, n_frames, st, **kw)
    got = _eager(_body(cfg, n_frames, **kw), st, kw.get("dts"))
    assert len(got) == len(want)
    _same_bits(_flat(got), _flat(want))


@pytest.mark.parametrize("faithful", [True, False])
def test_metric_lanes_and_snapshot_slots_land_at_their_frame(faithful):
    # lanes and slots start as sentinels; after step s (two frames each)
    # lanes [0, 2s + 2) and slots [0, s] hold the host loop's frames and the
    # rest still the sentinels: the device counter, not a Python int, picks
    # them
    cfg = SimConfig(**_CALM)
    st = initial_state(cfg, "cpu")
    _, m_want, s_want = _host_loop(cfg, 6, st, faithful=faithful,
                                   snapshot_every=2)
    body = _body(cfg, 6, faithful=faithful, snapshot_every=2)
    c = body.new_carry()
    for lane in c.metrics:
        lane.fill_(-7)
    c.snaps.fill_(float("nan"))
    body.load(c, st)
    assert int(c.counter) == 0
    for s in range(body.replays):
        body.advance(c)
        done = 2 * s + 2
        assert int(c.counter) == done
        for lane, want in zip(c.metrics, m_want):
            _same_bits([lane[:done]], [want[:done]])
            assert bool((lane[done:] == -7).all())
        _same_bits([c.snaps[:s + 1]], [s_want[:s + 1]])
        assert bool(c.snaps[s + 1:].isnan().all())
    assert isinstance(body.result(c)[1], StepMetrics)


def _jax_calm_512():
    kw = dict(_CALM, particle_number=512, bucket_resolution=9)
    jc = JConfig(**kw)
    js = jinit(jc)
    return jc, js, SimConfig(**kw), state_from_numpy(
        np.asarray(js.pos), np.asarray(js.vel), np.asarray(js.nan_count))


def test_rollout_from_a_jax_state_is_the_host_loop():
    # a JAX state carried across: the body and the host loop agree bit for
    # bit (JAX's own scanned rollout is the slow test below)
    _, _, cfg, st = _jax_calm_512()
    _same_bits(_flat(_eager(_body(cfg, 2), st)),
               _flat(_host_loop(cfg, 2, st)))


@pytest.mark.slow
def test_rollout_from_a_jax_state_matches_jax_scanned_pallas_rollout():
    # JAX's one-dispatch rollout (its pallas tier, interpret mode on the
    # CPU) against the body from the same state: the tolerance of the
    # port's sorted tier against JAX pallas (test_torch_parallel.py)
    jc, js, cfg, st = _jax_calm_512()
    jfinal, jm = jrollout(jc, 2, neighbor="pallas")(js)
    final, m = _eager(_body(cfg, 2), st)
    np.testing.assert_allclose(final.pos.numpy(), np.asarray(jfinal.pos),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(final.vel.numpy(), np.asarray(jfinal.vel),
                               rtol=0, atol=2e-5)
    np.testing.assert_array_equal(m.overflow.numpy(),
                                  np.asarray(jm.overflow))
    np.testing.assert_array_equal(m.nan_events.numpy(),
                                  np.asarray(jm.nan_events))


CUDA = torch.device("cuda")


@pytest.mark.parametrize("neighbor,device,host_loop,want", [
    ("sorted", CUDA, None, False), ("sorted", CUDA, False, False),
    ("sorted", CUDA, True, True), ("sorted", CPU, None, True),
    ("sorted", CPU, True, True), ("sorted", CPU, False, RuntimeError),
    ("slotted", CUDA, None, True), ("gather", CUDA, True, True),
    ("brute", CPU, None, True), ("sites", CUDA, None, True),
    ("slotted", CUDA, False, NotImplementedError),
    ("gather", CUDA, False, NotImplementedError),
    ("brute", CUDA, False, NotImplementedError),
    ("sites", CPU, False, NotImplementedError)])
def test_choice_of_graph_or_host_loop(neighbor, device, host_loop, want):
    # None: the graph for the sorted tier on the card, else the host loop;
    # False never falls back: it raises where no graph can run
    if isinstance(want, bool):
        assert graph.choose_host_loop(neighbor, device, host_loop) is want
        return
    with pytest.raises(want, match="A16" if want is NotImplementedError
                       else "card"):
        graph.choose_host_loop(neighbor, device, host_loop)


@pytest.mark.parametrize("neighbor", ["sorted", "slotted", "brute"])
@pytest.mark.parametrize("dt", [False, True])
def test_rollouts_report_their_host_loop(neighbor, dt):
    # on the CPU every rollout is a host loop; asking for the graph raises,
    # as NotImplementedError on the tiers that have none
    cfg = SimConfig(**_CALM)
    make = make_dt_rollout if dt else make_rollout
    for host_loop in (None, True):
        assert make(cfg, 2, neighbor=neighbor, device="cpu",
                    host_loop=host_loop).host_loop is True
    with pytest.raises(RuntimeError if neighbor == "sorted"
                       else NotImplementedError):
        make(cfg, 2, neighbor=neighbor, device="cpu", host_loop=False)


@pytest.mark.parametrize("host_loop", [False, True])
def test_run_bench_records_the_mode_that_ran(monkeypatch, host_loop):
    # every rollout of the bench takes the mode, and the result records it
    asked = []

    def fake_rollout(cfg, n, **kw):
        asked.append(kw["host_loop"])
        f, i = torch.zeros(n), torch.zeros(n, dtype=torch.int32)
        return lambda state: (state, StepMetrics(f, f, f, i, i, i))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "stub")
    monkeypatch.setattr(bench, "make_rollout", fake_rollout)
    monkeypatch.setattr(bench, "initial_state", lambda cfg, dev: None)
    monkeypatch.setattr(bench, "device_sync", lambda *a: None)
    monkeypatch.setattr(bench, "gpu_identity", lambda: "stub, 700.00 W")
    out = bench.run_bench(1024, frames=2, warmup_frames=1,
                          host_loop=host_loop)
    assert out["host_loop"] is host_loop
    assert asked == [host_loop, host_loop]


def test_cli_bench_host_loop_flag_reaches_run_bench(monkeypatch, capsys):
    # --host-loop times the host loop; without it the graph, and a tier
    # with no graph exits 2 with the reason
    seen = []

    def fake_bench(**kw):
        seen.append(kw["host_loop"])
        graph.choose_host_loop(kw["neighbor"], CUDA, kw["host_loop"])
        return {"host_loop": kw["host_loop"]}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "run_bench", fake_bench)
    assert cli.main(["bench", "--particles", "1024", "--host-loop"]) == 0
    assert cli.main(["bench", "--particles", "1024"]) == 0
    assert seen == [True, False]
    assert cli.main(["bench", "--neighbor", "sites"]) == 2
    assert cli.main(["bench", "--neighbor", "sites", "--host-loop"]) == 0
    out = capsys.readouterr()
    assert '"host_loop": true' in out.out and "A16" in out.err
