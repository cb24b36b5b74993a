"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; on a CPU-only host they skip. They
include the banded K1, K2 and K5 of the slab step and the slab step itself,
each tuning variant's instance (fuse_acc off, kahan, bf16), the probes'
kernels (sphfluidsimulation_torch/probes), and the paths around the
kernels that run on the card: the graph rollout against the host loop,
the recorded slab frame and ``Scene(jit=True)`` against their host
loops, the exact tiers, the dt replay,
the snapshots of the sorted rollout, the render properties, the scene
batch (the scene-axis K1, K2 and K3 at config 5's shape and K5 over three
small scenes, each scene bit-equal to its solo launch; the scene-axis K2
and K3, which read the frame record, bit-equal to the reference walk, and
planted frame records; K1-scenes, which reads the density record,
bit-equal to its reference walk and to each scene's solo K1; the batch's
graph against its host loop on every route; the density record the
batched step passes to K1-scenes), the sites tier, its slab step, the
domain step
and the CLI's
``sweep`` and ``run --shards``. They
import no JAX (the machine with the card has none), so run them without the
JAX test conftest, from the root of a checkout:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import compact, sph_kernels as sk
from sphfluidsimulation_torch.ops.frame import build_frame
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning
from sphfluidsimulation_torch.params import PhysParams
from sphfluidsimulation_torch.sim.stepper import initial_state, make_rollout

# tests/test_pallas.py:18-21
_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
_GOLDENISH = dict(particle_number=1024, bucket_resolution=11)
CONFIGS = {"calm": _CALM, "goldenish": _GOLDENISH,
           "tiny": dict(particle_number=4096, bucket_resolution=17)}
CAP = 32
XSPH, ALPHA = 0.3, 0.4
COMPACT = SortedTuning(compact=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels are built with "
                    "nvcc and run only on the card")
    return torch.device("cuda")


def _card_inputs(name, device, frames=0, **ext):
    cfg = SimConfig(**CONFIGS[name], **ext)
    st = initial_state(cfg, device)
    if frames:
        st, _ = make_rollout(cfg, frames, device=device)(st)
    r = cfg.bucket_resolution
    tf, (ps, vs) = build_frame(st.pos, r, CAP, extras=(st.pos, st.vel))
    return tf, ps, vs, PhysParams.from_config(cfg, device), r


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_density_kernel_matches_plain_on_card(cuda_device, name):
    tf, ps, _, tp, r = _card_inputs(name, cuda_device)
    before = sk.launch_counts["density"]
    got = sk.density_pass(tf, ps, tp, r, CAP)
    assert sk.launch_counts["density"] == before + 1
    want = sk.density_plain(tf, ps, tp, r, CAP)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_substep_kernel_matches_plain_on_card(cuda_device, name):
    tf, ps, vs, tp, r = _card_inputs(name, cuda_device, frames=2)
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    before = sk.launch_counts["fused_substep"]
    got = sk.fused_substep(tf, rows, tp, r, CAP)
    assert sk.launch_counts["fused_substep"] == before + 1
    # particle by particle as accurate as the plain version
    acc = sk.substep_accuracy(tf, rows, got, tp, r, CAP)
    assert acc.ok, acc


def _capped_inputs(cap, device):
    """The goldenish scene two frames on, its frame built with capacity
    ``cap`` (4 leaves deep piles past it)."""
    cfg = SimConfig(**CONFIGS["goldenish"])
    st, _ = make_rollout(cfg, 2, device=device)(initial_state(cfg, device))
    r = cfg.bucket_resolution
    tf, (ps, vs) = build_frame(st.pos, r, cap, extras=(st.pos, st.vel))
    return tf, ps, vs, PhysParams.from_config(cfg, device), r


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [4, CAP, None])
def test_density_kernel_matches_plain_for_each_capacity(cuda_device, cap):
    # K1's range walk with the self pair kept, held to its plain version;
    # the capacity cut drops only unoccupied slots, so walking the frame
    # uncut sums the same members in the same order: the same bits
    tf, ps, _, tp, r = _capped_inputs(cap, cuda_device)
    got = sk.density_cuda(tf, ps, tp, r, cap)
    torch.testing.assert_close(got, sk.density_plain(tf, ps, tp, r, cap),
                               rtol=1e-5, atol=1e-6)
    assert _same_bits(sk.density_cuda(tf, ps, tp, r, None), got)


@pytest.mark.cuda
def test_substep_rule_rejects_kernel_without_viscosity(cuda_device):
    tf, ps, vs, tp, r = _card_inputs("tiny", cuda_device, frames=2)
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    no_visc = tp._replace(viscosity=torch.zeros_like(tp.viscosity))
    bad = sk.fused_substep_cuda(tf, rows, no_visc, r, CAP)
    assert not sk.substep_accuracy(tf, rows, bad, tp, r, CAP).ok


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["calm", "goldenish"])
def test_fused_substep_ext_kernel_matches_plain_on_card(cuda_device, name):
    tf, ps, vs, tp, r = _card_inputs(name, cuda_device, frames=2, xsph=XSPH,
                                     artificial_viscosity=ALPHA)
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    before = dict(sk.launch_counts)
    got = sk.fused_substep(tf, rows, tp, r, CAP, XSPH, ALPHA)
    assert sk.launch_counts["fused_substep_ext"] == \
        before["fused_substep_ext"] + 1
    assert sk.launch_counts["fused_substep"] == before["fused_substep"]
    acc = sk.substep_accuracy(tf, rows, got, tp, r, CAP, XSPH, ALPHA)
    assert acc.ok, acc
    bad = sk.fused_substep_cuda(tf, rows, tp, r, CAP, XSPH, 0.0)
    assert not sk.substep_accuracy(tf, rows, bad, tp, r, CAP, XSPH,
                                   ALPHA).ok


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["calm", "goldenish"])
def test_forces_kernel_matches_plain_on_card(cuda_device, name):
    tf, ps, vs, tp, r = _card_inputs(name, cuda_device, frames=2, xsph=XSPH,
                                     artificial_viscosity=ALPHA)
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    before = sk.launch_counts["forces"]
    f, dv = sk.forces_pass(tf, rows, tp, r, CAP, XSPH, ALPHA)
    assert sk.launch_counts["forces"] == before + 1
    assert sk.forces_accuracy(tf, rows, f, dv, tp, r, CAP, XSPH, ALPHA).ok
    # the instance without extensions: the last six lanes are zero
    plain = sk.forces_cuda(tf, rows, tp, r, CAP, ext=False)
    assert not plain[:, 6:].any()
    f_p, dv_p = sk.fold_forces(plain, rows[:, 6], tp)
    assert dv_p is None
    assert sk.forces_accuracy(tf, rows, f_p, None, tp, r, CAP).ok
    # the planted control: the XSPH coefficient folded in as 0
    sums = sk.forces_cuda(tf, rows, tp, r, CAP, ext=True)
    f0, dv0 = sk.fold_forces(sums, rows[:, 6], tp, 0.0, ALPHA)
    assert not sk.forces_accuracy(tf, rows, f0, dv0, tp, r, CAP, XSPH,
                                  ALPHA).ok


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["goldenish", "tiny"])
def test_window_walk_matches_plain_with_drifted_rows_on_card(cuda_device,
                                                             name):
    # both instances of K2 and of K3 on rows moved 1.5 cells up in z, so
    # that some leave their frame-start cell, each held to the rule; pj and
    # the scalar block passed in give the same bits as built in the wrapper,
    # and K1 reads K2's scalar block as its own (the stepper shares it)
    tf, ps, vs, tp, r = _card_inputs(name, cuda_device, frames=2)
    rho = sk.density_cuda(tf, ps, tp, r, CAP)
    assert torch.equal(sk.density_cuda(tf, ps, tp, r, CAP,
                                       sk.scal_block(tp, XSPH, ALPHA)), rho)
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    rows[100:111, 2] = (rows[100:111, 2] + 1.5 / (r - 1)).clamp(max=1.0)
    pj = sk.pj_cols(rows[:, 6], tp)
    for xs, al in ((0.0, 0.0), (XSPH, ALPHA)):
        out = sk.fused_substep_cuda(tf, rows, tp, r, CAP, xs, al)
        acc = sk.substep_accuracy(tf, rows, out, tp, r, CAP, xs, al)
        assert acc.ok, acc
        again = sk.fused_substep_cuda(tf, rows, tp, r, CAP, xs, al, pj,
                                      sk.scal_block(tp, xs, al))
        assert torch.equal(again.view(torch.int32), out.view(torch.int32))
        ext = sk.uses_extensions(xs, al)
        sums = sk.forces_cuda(tf, rows, tp, r, CAP, ext)
        f, dv = sk.fold_forces(sums, rows[:, 6], tp, xs, al)
        acc = sk.forces_accuracy(tf, rows, f, dv, tp, r, CAP, xs, al)
        assert acc.ok, acc
        again = sk.forces_cuda(tf, rows, tp, r, CAP, ext, pj,
                               sk.scal_block(tp))
        assert torch.equal(again.view(torch.int32), sums.view(torch.int32))


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_layout(cuda_device):
    tf, ps, vs, tp, r = _card_inputs("calm", cuda_device)
    rows = sk.pack_rows(ps, vs, sk.density_cuda(tf, ps, tp, r, CAP))
    with pytest.raises(ValueError):
        sk.fused_substep(tf, rows[:, :7], tp, r, CAP)
    with pytest.raises(ValueError):
        sk.density_pass(tf, ps.double(), tp, r, CAP)
    with pytest.raises(ValueError):
        sk.forces_pass(tf, rows[:, :7], tp, r, CAP)


@pytest.mark.cuda
def test_rollout_on_card_tracks_cpu(cuda_device):
    # calm physics: the card's kernels and the CPU plain versions walk the
    # same candidates; rounding stays below the oracle-tracking bound of
    # tests/test_pallas.py::test_calm_rollout_tracks_oracle_with_zero_cert
    cfg = SimConfig(**_CALM)
    sk.reset_launch_counts()
    gpu, m = make_rollout(cfg, 5, device=cuda_device)(
        initial_state(cfg, cuda_device))
    assert sk.launch_counts == dict(dict.fromkeys(sk.launch_counts, 0),
                                    density=5, fused_substep=25)
    cpu, mc = make_rollout(cfg, 5, device="cpu")(initial_state(cfg, "cpu"))
    torch.testing.assert_close(gpu.pos.cpu(), cpu.pos, rtol=0, atol=5e-4)
    assert torch.equal(m.overflow.cpu(), mc.overflow)
    assert int(m.exact_cert.sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["window", "compact"])
@pytest.mark.parametrize("host_loop", [True, False])
@pytest.mark.parametrize("faithful", [True, False])
def test_rollout_never_waits_for_the_card(cuda_device, faithful, host_loop,
                                          route):
    # the frame loop keeps metrics on the device: no .item(), .cpu() or
    # data-dependent shapes; torch raises on any synchronising call. The
    # corrected mode with both extensions too: its per-substep frame build,
    # K3 and host integration need no sync either. The same holds for the
    # graph rollout's copies in and out around its replays, and on the
    # compact route's kernels (K5), whose drift counts stay on the device
    cfg = SimConfig(**CONFIGS["tiny"])
    if not faithful:
        cfg = cfg.replace(xsph=XSPH, artificial_viscosity=ALPHA)
    state = initial_state(cfg, cuda_device)
    roll = make_rollout(cfg, 3, faithful=faithful, device=cuda_device,
                        tune=SortedTuning(compact=route == "compact"),
                        host_loop=host_loop)
    assert roll.host_loop is host_loop
    roll(state)                       # builds the kernels, records the graph
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        final, m = roll(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert final.pos.is_cuda and m.exact_cert.is_cuda


# ---------------------------------------------- the graph rollout (A12) --

GRAPH_CASES = {
    "faithful": dict(),
    "corrected": dict(faithful=False, xsph=XSPH, artificial_viscosity=ALPHA),
    "compact": dict(tune=COMPACT),
    "compact-corrected": dict(faithful=False, tune=COMPACT),
    "unfused": dict(tune=SortedTuning(fused=False)),
    "snapshots": dict(snapshot_every=2),
    "dt": dict(dts=[1 / 240, 1 / 120, 1 / 360, 1 / 180]),
    # the bf16 K2-ext: its candidates' pass and its walk in the graph
    "bf16-ext": dict(tune=SortedTuning(bf16=True), xsph=XSPH,
                     artificial_viscosity=ALPHA),
    # the record walks: the Kahan K3-ext with its frame record's pass
    # every substep, the facc0 K2-ext with it once a frame
    "kahan-corrected-ext": dict(faithful=False, tune=SortedTuning(kahan=True),
                                xsph=XSPH, artificial_viscosity=ALPHA),
    "facc0-ext": dict(tune=SortedTuning(fuse_acc=False), xsph=XSPH,
                      artificial_viscosity=ALPHA),
    # the facc0 K3-ext with its record's pass every substep, the bf16 K2
    # without extensions with it once a frame
    "facc0-corrected-ext": dict(faithful=False,
                                tune=SortedTuning(fuse_acc=False), xsph=XSPH,
                                artificial_viscosity=ALPHA),
    "bf16": dict(tune=SortedTuning(bf16=True)),
    # the Kahan and the facc0 K2 without extensions with it once a frame
    "kahan": dict(tune=SortedTuning(kahan=True)),
    "facc0": dict(tune=SortedTuning(fuse_acc=False)),
}


def _graph_and_loop(case, device, n_frames=4):
    """The host loop's rollout of ``case`` (GRAPH_CASES) on the goldenish
    scene from the spawn, then the graph's twice (its first call records
    it): (outputs flattened, the launch counts, ``.host_loop``) of each,
    the counters reset before each."""
    from sphfluidsimulation_torch import make_dt_rollout
    kw = dict(GRAPH_CASES[case])
    dts = kw.pop("dts", None)
    ext = {k: kw.pop(k) for k in ("xsph", "artificial_viscosity") if k in kw}
    cfg = SimConfig(**_GOLDENISH, **ext)
    s0 = initial_state(cfg, device)

    def call(host_loop):
        if dts is None:
            roll = make_rollout(cfg, n_frames, device=device,
                                host_loop=host_loop, **kw)
            return roll, lambda: roll(s0)
        roll = make_dt_rollout(cfg, len(dts), device=device,
                               host_loop=host_loop, **kw)
        return roll, lambda: roll(s0, dts)

    loop, graph = call(True), call(False)
    runs = []
    for roll, run in (loop, graph, graph):
        sk.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        flat = [t for x in out
                for t in (x if isinstance(x, tuple) else (x,))]
        runs.append((flat, dict(sk.launch_counts), roll.host_loop))
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_rollout_is_bit_equal_to_the_host_loop_on_card(cuda_device,
                                                             case):
    # JAX's one dispatch a rollout: the frame recorded once and replayed
    # gives the host loop's state, every metric lane and every snapshot,
    # bit for bit, through the same launches, on its first call (which
    # records it) and again on a replay
    (loop, loop_counts, h), *graphs = _graph_and_loop(case, cuda_device)
    assert h is True and sum(loop_counts.values()) > 0
    for out, counts, host_loop in graphs:
        assert host_loop is False
        assert counts == loop_counts
        assert len(out) == len(loop)
        for x, y in zip(loop, out):
            assert x.shape == y.shape and x.dtype == y.dtype
            assert (_same_bits(x, y) if x.is_floating_point()
                    else torch.equal(x, y))


@pytest.mark.cuda
def test_failed_capture_raises_and_runs_no_loop_on_card(cuda_device,
                                                         monkeypatch):
    # no fallback: a frame that cannot be recorded (here it reads a value
    # back to the host, which a capture forbids) raises, counts nothing,
    # leaves the caller's stream current and runs no host loop in its place
    from sphfluidsimulation_torch.sim import graph, stepper
    real = stepper._sorted_frame

    def reads_back(*args):
        out = real(*args)
        float(out[3].max_speed)
        return out

    cfg = SimConfig(**_GOLDENISH)
    s0 = initial_state(cfg, cuda_device)
    roll = make_rollout(cfg, 2, device=cuda_device, host_loop=False)
    assert isinstance(roll, graph.GraphRollout)
    monkeypatch.setattr(stepper, "_sorted_frame", reads_back)
    stream = torch.cuda.current_stream(cuda_device)
    sk.reset_launch_counts()
    with pytest.raises(RuntimeError):
        roll(s0)
    assert sk.launch_counts == dict.fromkeys(sk.launch_counts, 0)
    assert torch.cuda.current_stream(cuda_device) == stream
    assert roll._step.graph is None
    monkeypatch.setattr(stepper, "_sorted_frame", real)
    final, _ = roll(s0)
    ref, _ = make_rollout(cfg, 2, device=cuda_device, host_loop=True)(s0)
    for a, b in zip(final, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_scene_and_bench_on_card(cuda_device):
    from sphfluidsimulation_torch import Scene
    from sphfluidsimulation_torch.bench import run_bench
    scene = Scene(SimConfig(**_CALM))                  # the card by default
    st = scene.step(2)
    assert st.pos.is_cuda and scene.frame == 2
    assert bool(torch.isfinite(st.pos).all())
    out = run_bench(4096, frames=2, warmup_frames=1,
                    tune=SortedTuning(compact=False))
    assert out["value"] > 0 and out["exact_cert_total"] == 0
    assert out["device_name"] == torch.cuda.get_device_name(0)
    assert out["pallas_tuning"] == SortedTuning()._asdict()
    sk.reset_launch_counts()
    out = run_bench(4096, frames=2, warmup_frames=1, tune=COMPACT)
    assert out["pallas_tuning"] == COMPACT._asdict() and out["value"] > 0
    # the warm-up frame, the timed length once untimed, then timed
    assert sk.launch_counts["compact_substep"] == (1 + 2 * 2) * 5
    assert sk.launch_counts["fused_substep"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["goldenish", "tiny"])
def test_compact_kernel_matches_plain_on_card(cuda_device, name):
    # each K5 instance against its plain version, on rows moved 2.5 cells
    # up in z after the frame build, so that some leave their tile's band:
    # the drift count equals the plain version's
    tf, ps, vs, tp, r = _card_inputs(name, cuda_device, frames=2)
    before = dict(sk.launch_counts)
    rho, c = compact.density_compact(tf, ps, tp, r, CAP)
    rho_p, c_p = compact.density_compact_plain(tf, ps, tp, r)
    torch.testing.assert_close(rho, rho_p, rtol=1e-5, atol=1e-6)
    assert int(c) == int(c_p) == 0
    rows = sk.pack_rows(ps, vs, rho_p)
    rows[100:111, 2] += 2.5 / (r - 1)
    for xs, al in ((0.0, 0.0), (XSPH, ALPHA)):
        out, c = compact.compact_substep(tf, rows, tp, r, CAP, xs, al)
        _, c_p = compact.compact_substep_plain(tf, rows, tp, r, xs, al)
        assert int(c) == int(c_p)
        acc = sk.substep_accuracy(tf, rows, out, tp, r, None, xs, al,
                                  sums_fn=compact.compact_sums_plain)
        assert acc.ok, acc
    f, c = compact.forces_compact(tf, rows, tp, r, CAP)
    assert int(c) == int(c_p)
    assert sk.forces_accuracy(tf, rows, f, None, tp, r, None,
                              sums_fn=compact.compact_sums_plain).ok
    # the planted control: the substep without viscosity fails the rule
    no_visc = tp._replace(viscosity=torch.zeros_like(tp.viscosity))
    bad, _ = compact.compact_substep_cuda(tf, rows, no_visc, r, CAP)
    assert not sk.substep_accuracy(tf, rows, bad, tp, r, None,
                                   sums_fn=compact.compact_sums_plain).ok
    for k in ("compact_density", "compact_substep", "compact_substep_ext",
              "compact_forces"):
        assert sk.launch_counts[k] > before[k]


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [4, CAP, None])
def test_compact_kernel_streams_capacity_cut_cells_exactly(cuda_device, cap):
    # the four K5 instances on a frame built with capacity 4, 32 and None,
    # with rows drifted past their band, each held to its plain version;
    # streaming only each cell's capacity-cut prefix keeps every occupied
    # slot in order, so the bits equal those of the uncut stream, and pj
    # passed in equals pj built in the wrapper
    tf, ps, vs, tp, r = _capped_inputs(cap, cuda_device)
    rho, c = compact.density_compact(tf, ps, tp, r, cap)
    rho_p, c_p = compact.density_compact_plain(tf, ps, tp, r)
    torch.testing.assert_close(rho, rho_p, rtol=1e-5, atol=1e-6)
    assert int(c) == int(c_p) == 0
    assert _same_bits(compact.density_compact_cuda(tf, ps, tp, r, None)[0],
                      rho)
    rows = sk.pack_rows(ps, vs, rho_p)
    rows[100:111, 2] += 2.5 / (r - 1)
    pj = sk.pj_cols(rows[:, 6], tp)
    for xs, al in ((0.0, 0.0), (XSPH, ALPHA)):
        out, c = compact.compact_substep(tf, rows, tp, r, cap, xs, al, pj)
        _, c_p = compact.compact_substep_plain(tf, rows, tp, r, xs, al)
        assert int(c) == int(c_p)
        acc = sk.substep_accuracy(tf, rows, out, tp, r, None, xs, al,
                                  sums_fn=compact.compact_sums_plain)
        assert acc.ok, acc
        uncut, _ = compact.compact_substep_cuda(tf, rows, tp, r, None, xs,
                                                al)
        assert _same_bits(uncut, out)
    f, c = compact.forces_compact(tf, rows, tp, r, cap, pj)
    assert int(c) == int(c_p)
    assert sk.forces_accuracy(tf, rows, f, None, tp, r, None,
                              sums_fn=compact.compact_sums_plain).ok
    assert _same_bits(compact.forces_compact_cuda(tf, rows, tp, r, cap)[0],
                      compact.forces_compact_cuda(tf, rows, tp, r, None)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("faithful", [True, False])
def test_compact_rollout_never_waits_for_the_card(cuda_device, faithful):
    # the compact route keeps its drift counts on the device too
    cfg = SimConfig(**CONFIGS["tiny"])
    state = initial_state(cfg, cuda_device)
    roll = make_rollout(cfg, 3, faithful=faithful, tune=COMPACT,
                        device=cuda_device)
    sk.reset_launch_counts()
    roll(state)                                # builds the kernels
    torch.cuda.synchronize()
    want = (dict(compact_density=3, compact_substep=15) if faithful else
            dict(compact_density=18, compact_forces=15))
    assert sk.launch_counts == dict(dict.fromkeys(sk.launch_counts, 0),
                                    **want)
    torch.cuda.set_sync_debug_mode("error")
    try:
        final, m = roll(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert final.pos.is_cuda and m.exact_cert.is_cuda


# ------------------------------------------------- banded K1 / K2 (slab) --

def _banded_inputs(cap, device, band=(1, 6), frames=2, **ext):
    """A slab shard's frame on the card: the goldenish scene ``frames`` on,
    the rows of ``band``'s planes live and 300 dead rows after them, built
    with capacity ``cap``; some rows then moved 1.5 cells up in z, so that
    their windows leave the band."""
    cfg = SimConfig(**CONFIGS["goldenish"], **ext)
    st, _ = make_rollout(cfg, frames, device=device)(
        initial_state(cfg, device))
    r = cfg.bucket_resolution
    pos = torch.cat([st.pos, st.pos[:300]])
    vel = torch.cat([st.vel, st.vel[:300]])
    az = (pos[:, 2] * (r - 1)).to(torch.int32).clamp(0, r - 1)
    valid = (az >= band[0]) & (az < band[0] + band[1])
    valid[cfg.n_particles:] = False
    gid = torch.arange(pos.shape[0], dtype=torch.int32,
                       device=device) % cfg.n_particles
    tf, (ps, vs) = build_frame(pos, r, cap, extras=(pos, vel), gid=gid,
                               n_ids=cfg.n_particles, band=band, valid=valid)
    n_live = int(tf.start[-1])
    assert 0 < n_live < pos.shape[0] - 300
    return tf, ps, vs, PhysParams.from_config(cfg, device), r, n_live


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [4, CAP, None])
def test_banded_kernels_match_plain_on_card(cuda_device, cap):
    # K1, K2 and K2-ext over a band with dead rows, each held to its banded
    # plain version; dead rows: density 0, the substep copies them through;
    # walking the capped frame uncut gives the same bits
    band = (1, 6)
    tf, ps, vs, tp, r, n_live = _banded_inputs(cap, cuda_device, band)
    before = dict(sk.launch_counts)
    rho = sk.density_pass(tf, ps, tp, r, cap, band=band)
    assert sk.launch_counts["density_band"] == before["density_band"] + 1
    assert sk.launch_counts["density"] == before["density"]
    torch.testing.assert_close(
        rho, sk.density_plain(tf, ps, tp, r, cap, band), rtol=1e-5,
        atol=1e-6)
    assert not rho[n_live:].any()
    assert _same_bits(sk.density_cuda(tf, ps, tp, r, None, band=band), rho)
    rows = sk.pack_rows(ps, vs, rho)
    rows[100:400:3, 2] = (rows[100:400:3, 2] + 1.5 / (r - 1)).clamp(max=1.0)
    for xs, al in ((0.0, 0.0), (XSPH, ALPHA)):
        out = sk.fused_substep(tf, rows, tp, r, cap, xs, al, band=band)
        assert torch.equal(out[n_live:], rows[n_live:])
        acc = sk.substep_accuracy(tf, rows, out, tp, r, cap, xs, al,
                                  band=band)
        assert acc.ok, acc
        uncut = sk.fused_substep_cuda(tf, rows, tp, r, None, xs, al,
                                      band=band)
        assert _same_bits(uncut, out)
    # the planted control: the banded substep without viscosity fails
    no_visc = tp._replace(viscosity=torch.zeros_like(tp.viscosity))
    bad = sk.fused_substep_cuda(tf, rows, no_visc, r, cap, band=band)
    assert not sk.substep_accuracy(tf, rows, bad, tp, r, cap,
                                   band=band).ok
    for k in ("fused_substep_band", "fused_substep_ext_band"):
        assert sk.launch_counts[k] > before[k]
    assert sk.launch_counts["fused_substep"] == before["fused_substep"]


@pytest.mark.cuda
def test_whole_grid_band_is_the_unbanded_launch_on_card(cuda_device):
    # band (0, r) walks what the unbanded instance walks: the same bits
    tf, ps, vs, tp, r = _card_inputs("goldenish", cuda_device, frames=2)
    whole = (0, r)
    assert _same_bits(sk.density_cuda(tf, ps, tp, r, CAP, band=whole),
                      sk.density_cuda(tf, ps, tp, r, CAP))
    rows = sk.pack_rows(ps, vs, sk.density_cuda(tf, ps, tp, r, CAP))
    for xs, al in ((0.0, 0.0), (XSPH, ALPHA)):
        assert _same_bits(
            sk.fused_substep_cuda(tf, rows, tp, r, CAP, xs, al, band=whole),
            sk.fused_substep_cuda(tf, rows, tp, r, CAP, xs, al))
    with pytest.raises(ValueError):         # start[] too short for a band
        sk.density_cuda(tf, ps, tp, r, CAP, band=(0, r + 1))


# the variant libraries K2's banded instance comes in (None: the default)
LANE_TUNES = {"default": None, "facc0": SortedTuning(fuse_acc=False),
              "kahan": SortedTuning(kahan=True),
              "bf16": SortedTuning(bf16=True)}


def _lane_rows(cap, device, ext):
    """_banded_inputs' shard frame and rows (some moved 1.5 cells up in z),
    with two live rows' velocities set to inf, so that their neighbours'
    forces are NaN and the NaN trap counts."""
    band = (1, 6)
    tf, ps, vs, tp, r, n_live = _banded_inputs(cap, device, band)
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, cap, band))
    rows[100:400:3, 2] = (rows[100:400:3, 2] + 1.5 / (r - 1)).clamp(max=1.0)
    rows[[7, n_live // 2], 3] = float("inf")
    xs, al = (XSPH, ALPHA) if ext else (0.0, 0.0)
    return tf, rows, tp, r, n_live, band, xs, al


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("cap", [4, CAP, None])
@pytest.mark.parametrize("variant", sorted(LANE_TUNES))
def test_banded_lane_groups_are_the_one_thread_walk_on_card(cuda_device,
                                                            variant, cap,
                                                            ext):
    # the launched banded K2 (without the extensions a group of lanes a live
    # row) gives the bits of the one-thread walk (lanes=1), NaN-trap lane
    # included; it copies the dead rows through, and two launches give the
    # same bits
    tune = LANE_TUNES[variant]
    tf, rows, tp, r, n_live, band, xs, al = _lane_rows(cap, cuda_device, ext)
    name = ("fused_substep_ext_band" if ext else "fused_substep_band") + \
        sk.variant_tag("fused_substep.cu", sk._tuned(tune))
    sk.reset_launch_counts()
    out = sk.fused_substep_cuda(tf, rows, tp, r, cap, xs, al, band=band,
                                tune=tune)
    one = sk.fused_substep_cuda(tf, rows, tp, r, cap, xs, al, band=band,
                                tune=tune, lanes=1)
    assert _same_bits(out, one)
    trapped = out[:n_live, 7] > rows[:n_live, 7]
    assert 0 < int(trapped.sum()) < n_live
    assert torch.equal(out[n_live:], rows[n_live:])
    assert _same_bits(out, sk.fused_substep_cuda(tf, rows, tp, r, cap, xs,
                                                 al, band=band, tune=tune))
    assert sk.launch_counts[name] == 2
    assert sk.launch_counts[f"{name}+lanes1"] == 1


# every shape of the library of all shapes (cuda_build.LANE_SWEEP): lanes
# a row and slots a lane a step
LANE_SHAPES = [(lanes, slots) for lanes in (1, 2, 4, 8)
               for slots in (1, 2, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LANE_SHAPES, ids=lambda s: "%dx%d" % s)
def test_every_lane_group_shape_is_the_one_thread_walk_on_card(cuda_device,
                                                               shape):
    # the library of every shape, which chose the band's: each shape,
    # banded and over the whole grid, gives the one-thread walk's bits
    lanes, slots = shape
    for ext in (False, True):
        tf, rows, tp, r, n_live, band, xs, al = _lane_rows(CAP, cuda_device,
                                                           ext)
        one = sk.fused_substep_cuda(tf, rows, tp, r, CAP, xs, al, band=band,
                                    lanes=1)
        assert _same_bits(sk.fused_substep_cuda(
            tf, rows, tp, r, CAP, xs, al, band=band, lanes=lanes,
            slots=slots), one)
    tf, ps, vs, tp, r = _card_inputs("goldenish", cuda_device, frames=2)
    rows = sk.pack_rows(ps, vs, sk.density_cuda(tf, ps, tp, r, CAP))
    for xs, al in ((0.0, 0.0), (XSPH, ALPHA)):
        assert _same_bits(
            sk.fused_substep_cuda(tf, rows, tp, r, CAP, xs, al, lanes=lanes,
                                  slots=slots),
            sk.fused_substep_cuda(tf, rows, tp, r, CAP, xs, al))


@pytest.mark.cuda
def test_lanes_wrapper_rejects_a_shape_it_has_not_built_on_card(cuda_device):
    tf, rows, tp, r, n_live, band, xs, al = _lane_rows(CAP, cuda_device,
                                                       False)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sk.fused_substep_cuda(tf, rows, tp, r, CAP, band=band, lanes=3)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sk.fused_substep_cuda(tf, rows, tp, r, CAP, band=band, lanes=2,
                              slots=3)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4])
def test_slab_step_on_card_equals_single_device(cuda_device, d):
    # the calm scene: own rows walk the single device's candidates in its
    # order and the halo copies are overwritten before they are read, so
    # the slab step gives the single-device rollout's bits, through D K1
    # and 5·D K2 launches a frame
    from sphfluidsimulation_torch.parallel import (LocalRing, collect,
                                                   distribute,
                                                   make_pallas_slab_step)
    cfg = SimConfig(**_CALM)
    s0 = initial_state(cfg, cuda_device)
    step, spec = make_pallas_slab_step(cfg, LocalRing(d), row_slack=4.0)
    sst = distribute(s0, cfg, spec)
    phys = PhysParams.from_config(cfg, cuda_device)
    sk.reset_launch_counts()
    for _ in range(3):
        sst, m = step(sst, phys)
        assert int(m.exact_cert) == 0
    assert sk.launch_counts == dict(dict.fromkeys(sk.launch_counts, 0),
                                    density_band=3 * d,
                                    fused_substep_band=15 * d)
    out, lost = collect(sst, cfg.n_particles)
    ref, mr = make_rollout(cfg, 3, device=cuda_device)(s0)
    assert lost == 0 and int(m.overflow) == int(mr.overflow[-1])
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


# ------------------------------------------------------ tuning variants --

VARIANT_TUNES = {"facc0": SortedTuning(fuse_acc=False),
                 "kahan": SortedTuning(kahan=True),
                 "bf16": SortedTuning(bf16=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["goldenish", "tiny"])
def test_kahan_density_kernel_matches_plain_on_card(cuda_device, name):
    tf, ps, _, tp, r = _card_inputs(name, cuda_device, frames=2)
    kahan = VARIANT_TUNES["kahan"]
    before = sk.launch_counts.get("density+kahan", 0)
    got = sk.density_pass(tf, ps, tp, r, CAP, tune=kahan)
    assert sk.launch_counts["density+kahan"] == before + 1
    want = sk.density_plain(tf, ps, tp, r, CAP, tune=kahan)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # the compensated sum is at least as close to float64 as the default
    p64 = sk.density_plain(tf, ps.double(), PhysParams(
        *(t.double() for t in tp)), r, CAP)
    e_k = float((got.double() - p64).abs().max())
    e_d = float((sk.density_cuda(tf, ps, tp, r, CAP).double()
                 - p64).abs().max())
    assert e_k <= e_d


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANT_TUNES))
def test_variant_substep_and_forces_match_plain_on_card(cuda_device,
                                                        variant, ext):
    # K2 and K3 in each variant, held to the plain version of the same
    # variant by the accuracy rules, counted under the variant's tag
    tune = VARIANT_TUNES[variant]
    xs, al = (XSPH, ALPHA) if ext else (0.0, 0.0)
    tf, ps, vs, tp, r = _card_inputs("goldenish", cuda_device, frames=2)
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    rows[100:111, 2] = (rows[100:111, 2] + 1.5 / (r - 1)).clamp(max=1.0)
    key = ("fused_substep_ext" if ext else "fused_substep") + "+" + variant
    before = sk.launch_counts.get(key, 0)
    out = sk.fused_substep(tf, rows, tp, r, CAP, xs, al, tune=tune)
    assert sk.launch_counts[key] == before + 1
    acc = sk.substep_accuracy(tf, rows, out, tp, r, CAP, xs, al, tune=tune)
    assert acc.ok, acc
    f, dv = sk.forces_pass(tf, rows, tp, r, CAP, xs, al, tune=tune)
    assert sk.launch_counts["forces+" + variant] >= 1
    acc = sk.forces_accuracy(tf, rows, f, dv, tp, r, CAP, xs, al, tune=tune)
    assert acc.ok, acc
    # the planted control: the variant without viscosity fails its rule
    no_visc = tp._replace(viscosity=torch.zeros_like(tp.viscosity))
    bad = sk.fused_substep_cuda(tf, rows, no_visc, r, CAP, xs, al,
                                tune=tune)
    assert not sk.substep_accuracy(tf, rows, bad, tp, r, CAP, xs, al,
                                   tune=tune).ok


@pytest.mark.cuda
def test_bf16_ext_kernels_take_rho_j_from_the_rows_on_card(cuda_device):
    # with extensions the bf16 K2 and K3 read ρⱼ from the rows, rounded,
    # and compute press_j and 1/ρⱼ from it: pj is not read (garbage gives
    # the same bits), and the result is the plain bf16 version's, not the
    # f32 one's
    bf = VARIANT_TUNES["bf16"]
    tf, ps, vs, tp, r = _card_inputs("goldenish", cuda_device, frames=2,
                                     xsph=XSPH, artificial_viscosity=ALPHA)
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    pj = sk.pj_cols(rows[:, 6], tp)
    junk = torch.full_like(pj, float("nan"))
    out = sk.fused_substep_cuda(tf, rows, tp, r, CAP, XSPH, ALPHA, pj,
                                tune=bf)
    assert _same_bits(out, sk.fused_substep_cuda(tf, rows, tp, r, CAP, XSPH,
                                                 ALPHA, junk, tune=bf))
    assert sk.substep_accuracy(tf, rows, out, tp, r, CAP, XSPH, ALPHA,
                               tune=bf).ok
    assert not sk.substep_accuracy(tf, rows, out, tp, r, CAP, XSPH,
                                   ALPHA).ok
    sums = sk.forces_cuda(tf, rows, tp, r, CAP, True, pj, tune=bf)
    assert _same_bits(sums, sk.forces_cuda(tf, rows, tp, r, CAP, True, junk,
                                           tune=bf))
    f, dv = sk.fold_forces(sums, rows[:, 6], tp, XSPH, ALPHA)
    assert sk.forces_accuracy(tf, rows, f, dv, tp, r, CAP, XSPH, ALPHA,
                              tune=bf).ok


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["goldenish", "tiny"])
def test_bf16_compact_kernel_matches_plain_on_card(cuda_device, name):
    bf = VARIANT_TUNES["bf16"]
    tf, ps, vs, tp, r = _card_inputs(name, cuda_device, frames=2)
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    rows[100:111, 2] += 2.5 / (r - 1)
    for xs, al in ((0.0, 0.0), (XSPH, ALPHA)):
        out, c = compact.compact_substep(tf, rows, tp, r, CAP, xs, al,
                                         tune=bf)
        _, c_p = compact.compact_substep_plain(tf, rows, tp, r, xs, al,
                                               tune=bf)
        assert int(c) == int(c_p)
        acc = sk.substep_accuracy(tf, rows, out, tp, r, None, xs, al,
                                  sums_fn=compact.compact_sums_plain,
                                  tune=bf)
        assert acc.ok, acc
    f, c = compact.forces_compact(tf, rows, tp, r, CAP, tune=bf)
    assert sk.forces_accuracy(tf, rows, f, None, tp, r, None,
                              sums_fn=compact.compact_sums_plain,
                              tune=bf).ok
    for k in ("compact_substep+bf16", "compact_substep_ext+bf16",
              "compact_forces+bf16"):
        assert sk.launch_counts[k] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [4, CAP, None])
def test_banded_compact_kernel_matches_plain_on_card(cuda_device, cap):
    # K5-band density and substep over a band with dead rows, each held to
    # its banded plain version: dead rows get density 0 and are copied
    # through, the drift count equals the plain version's, and the
    # capacity-cut stream gives the uncut stream's bits
    band = (1, 6)
    tf, ps, vs, tp, r, n_live = _banded_inputs(cap, cuda_device, band)
    before = dict(sk.launch_counts)
    rho, c = compact.density_compact(tf, ps, tp, r, cap, band=band)
    assert sk.launch_counts["compact_density_band"] == \
        before["compact_density_band"] + 1
    rho_p, _ = compact.density_compact_plain(tf, ps, tp, r, band)
    torch.testing.assert_close(rho, rho_p, rtol=1e-5, atol=1e-6)
    assert not rho[n_live:].any() and int(c) == 0
    assert _same_bits(compact.density_compact_cuda(tf, ps, tp, r, None,
                                                   band=band)[0], rho)
    rows = sk.pack_rows(ps, vs, rho_p)
    rows[100:400:3, 2] = (rows[100:400:3, 2] + 1.5 / (r - 1)).clamp(max=1.0)
    for xs, al in ((0.0, 0.0), (XSPH, ALPHA)):
        out, c = compact.compact_substep(tf, rows, tp, r, cap, xs, al,
                                         band=band)
        _, c_p = compact.compact_substep_plain(tf, rows, tp, r, xs, al, band)
        assert int(c) == int(c_p)
        assert torch.equal(out[n_live:], rows[n_live:])
        acc = sk.substep_accuracy(tf, rows, out, tp, r, None, xs, al,
                                  sums_fn=compact.compact_sums_plain,
                                  band=band)
        assert acc.ok, acc
        uncut, _ = compact.compact_substep_cuda(tf, rows, tp, r, None, xs,
                                                al, band=band)
        assert _same_bits(uncut, out)
    for k in ("compact_substep_band", "compact_substep_ext_band"):
        assert sk.launch_counts[k] > before[k]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["window", "compact"])
def test_unfused_route_on_card(cuda_device, route):
    # SPH_PALLAS_FUSED=0: one density and five forces launches a frame and
    # no fused substep, tracking the fused route (tests/test_pallas.py:
    # 198-226)
    cfg = SimConfig(**_CALM)
    s0 = initial_state(cfg, cuda_device)
    compact_route = route == "compact"
    sk.reset_launch_counts()
    a, ma = make_rollout(cfg, 3, tune=SortedTuning(compact=compact_route,
                                                   fused=False),
                         device=cuda_device)(s0)
    want = (dict(compact_density=3, compact_forces=15) if compact_route
            else dict(density=3, forces=15))
    assert sk.launch_counts == dict(dict.fromkeys(sk.launch_counts, 0),
                                    **want)
    b, mb = make_rollout(cfg, 3, tune=SortedTuning(compact=compact_route),
                         device=cuda_device)(s0)
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=1e-6)
    torch.testing.assert_close(a.vel, b.vel, rtol=0, atol=1e-6)
    assert int(ma.exact_cert.sum()) == int(mb.exact_cert.sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4])
def test_compact_slab_step_on_card(cuda_device, d):
    # the slab step on the compact route: D K5-band density and 5·D K5-band
    # substep launches a frame, within the slab tolerance of the
    # single-device compact route (tests/test_slab_pallas.py:97-131)
    from sphfluidsimulation_torch.parallel import (LocalRing, collect,
                                                   distribute,
                                                   make_pallas_slab_step)
    cfg = SimConfig(**_CALM)
    s0 = initial_state(cfg, cuda_device)
    step, spec = make_pallas_slab_step(cfg, LocalRing(d), row_slack=4.0,
                                       tune=COMPACT)
    sst = distribute(s0, cfg, spec)
    phys = PhysParams.from_config(cfg, cuda_device)
    sk.reset_launch_counts()
    for _ in range(3):
        sst, m = step(sst, phys)
        assert int(m.exact_cert) == 0
    assert sk.launch_counts == dict(dict.fromkeys(sk.launch_counts, 0),
                                    compact_density_band=3 * d,
                                    compact_substep_band=15 * d)
    out, lost = collect(sst, cfg.n_particles)
    ref, _ = make_rollout(cfg, 3, tune=COMPACT, device=cuda_device)(s0)
    assert lost == 0
    torch.testing.assert_close(out.pos, ref.pos, rtol=0, atol=2e-5)
    torch.testing.assert_close(out.vel, ref.vel, rtol=0, atol=2e-4)


# ------------------------------- the recorded slab frame and Scene(jit) --

# each route of the slab step its graph records: (config extras, tune, the
# launches a frame on d slabs as a function of d)
SLAB_GRAPH_CASES = {
    "window": ({}, None, lambda d: dict(density_band=d,
                                        fused_substep_band=5 * d)),
    "ext": (dict(xsph=XSPH, artificial_viscosity=ALPHA), None,
            lambda d: dict(density_band=d, fused_substep_ext_band=5 * d)),
    "compact": ({}, COMPACT, lambda d: dict(compact_density_band=d,
                                            compact_substep_band=5 * d)),
    "kahan": ({}, SortedTuning(kahan=True),
              lambda d: {"density_band+kahan": d,
                         "fused_substep_band+kahan": 5 * d}),
}


def _bits_of(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def _all_same_bits(a, b):
    a, b = list(a), list(b)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(_bits_of(x), _bits_of(y)) for x, y in zip(a, b))


def _slab_steps(case, d, device, **kw):
    """(cfg, {mode: step}, the slab state of the calm spawn, phys) of the
    slab step of ``case`` (SLAB_GRAPH_CASES) on ``LocalRing(d)``, host loop
    and graph."""
    from sphfluidsimulation_torch.parallel import (LocalRing, distribute,
                                                   make_pallas_slab_step)
    ext, tune, _ = SLAB_GRAPH_CASES[case]
    cfg = SimConfig(**_CALM, **ext)
    steps, spec = {}, None
    for mode, host_loop in (("host", True), ("graph", None)):
        steps[mode], spec = make_pallas_slab_step(
            cfg, LocalRing(d), row_slack=4.0, tune=tune, device=device,
            host_loop=host_loop, **kw)
    sst = distribute(initial_state(cfg, device), cfg, spec)
    return cfg, steps, sst, PhysParams.from_config(cfg, device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SLAB_GRAPH_CASES))
@pytest.mark.parametrize("d", [2, 4])
def test_slab_graph_is_bit_equal_to_the_host_loop_on_card(cuda_device, d,
                                                          case):
    # JAX's jitted shard_map: the whole LocalRing frame (migration,
    # exchanges, banded kernels, metrics) replayed as one graph gives the
    # host loop's state and every metric lane bit for bit, frame by frame,
    # through the same banded launches
    _, steps, s0, phys = _slab_steps(case, d, cuda_device)
    assert steps["host"].host_loop is True
    assert steps["graph"].host_loop is False
    runs = {}
    for mode, step in steps.items():
        step(s0, phys)               # the graph's first call records it
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        st, frames = s0, []
        for _ in range(3):
            st, m = step(st, phys)
            frames.append((*st, *m))
        torch.cuda.synchronize()
        runs[mode] = (frames, dict(sk.launch_counts))
    per_frame = SLAB_GRAPH_CASES[case][2](d)
    for mode, (_, counts) in runs.items():
        assert counts == dict(dict.fromkeys(counts, 0),
                              **{k: 3 * v for k, v in per_frame.items()})
    for a, b in zip(runs["host"][0], runs["graph"][0]):
        assert _all_same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["window", "compact"])
def test_slab_graph_never_waits_for_the_card(cuda_device, case):
    # after the first call (which records the frame) a call copies in,
    # replays and copies out with no synchronising call
    _, steps, s0, phys = _slab_steps(case, 4, cuda_device)
    st, _ = steps["graph"](s0, phys)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            st, m = steps["graph"](st, phys)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.pos.is_cuda and m.exact_cert.is_cuda


@pytest.mark.cuda
def test_failed_slab_capture_raises_and_runs_no_loop_on_card(cuda_device,
                                                             monkeypatch):
    # no fallback: a slab frame that cannot be recorded (its density reads
    # a value back) raises, counts nothing, leaves the caller's stream
    # current and runs no host loop in its place
    _, steps, s0, phys = _slab_steps("window", 2, cuda_device)
    real = sk.density_pass

    def reads_back(*args, **kw):
        rho = real(*args, **kw)
        float(rho.max())
        return rho

    monkeypatch.setattr(sk, "density_pass", reads_back)
    stream = torch.cuda.current_stream(cuda_device)
    sk.reset_launch_counts()
    with pytest.raises(RuntimeError):
        steps["graph"](s0, phys)
    assert sk.launch_counts == dict.fromkeys(sk.launch_counts, 0)
    assert torch.cuda.current_stream(cuda_device) == stream
    assert steps["graph"]._recorded.graph is None
    monkeypatch.setattr(sk, "density_pass", real)
    got, want = steps["graph"](s0, phys), steps["host"](s0, phys)
    assert _all_same_bits((*got[0], *got[1]), (*want[0], *want[1]))


SCENE_JIT_MODES = {
    "faithful": ({}, {}, dict(density=1, fused_substep=5)),
    "corrected": (dict(xsph=XSPH, artificial_viscosity=ALPHA),
                  dict(faithful=False), dict(density=6, forces=5)),
    "compact": ({}, dict(tune=COMPACT),
                dict(compact_density=1, compact_substep=5)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(SCENE_JIT_MODES))
def test_scene_jit_is_bit_equal_to_the_eager_step_on_card(cuda_device, mode):
    # JAX's Scene(jit=True): the frame recorded at the first step and
    # replayed each frame, bit for bit jit=False's state and metrics
    # through the same launches; state and last_metrics are copies
    from sphfluidsimulation_torch import Scene
    ext, kw, per_frame = SCENE_JIT_MODES[mode]
    cfg = SimConfig(**_GOLDENISH, **ext)
    scenes = {jit: Scene(cfg, jit=jit, **kw) for jit in (False, True)}
    assert scenes[True].host_loop is False
    assert scenes[False].host_loop is True
    frames, counts = {}, {}
    for jit, scene in scenes.items():
        scene.step()                # records the graph
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        frames[jit] = [(*scene.step(), *scene.last_metrics)
                       for _ in range(3)]
        torch.cuda.synchronize()
        counts[jit] = dict(sk.launch_counts)
    assert counts[True] == counts[False] == dict(
        dict.fromkeys(counts[True], 0),
        **{k: 3 * v for k, v in per_frame.items()})
    for a, b in zip(frames[False], frames[True]):
        assert _all_same_bits(a, b)
    rec = scenes[True]
    assert rec.state.pos.data_ptr() != rec.state.pos.data_ptr()
    rec.reset()
    assert rec.frame == 0
    assert _all_same_bits(rec.state, initial_state(cfg, cuda_device))


@pytest.mark.cuda
def test_scene_jit_never_waits_for_the_card(cuda_device):
    from sphfluidsimulation_torch import Scene
    scene = Scene(SimConfig(**_GOLDENISH))
    scene.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = scene.step(2)
        m = scene.last_metrics
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.pos.is_cuda and m.exact_cert.is_cuda and scene.frame == 3


@pytest.mark.cuda
def test_failed_scene_capture_raises_on_card(cuda_device, monkeypatch):
    # a Scene frame that cannot be recorded raises at the first step and
    # steps nothing in its place; without the fault it records and matches
    # the eager step
    from sphfluidsimulation_torch import Scene
    from sphfluidsimulation_torch.sim import stepper
    real = stepper._sorted_frame

    def reads_back(*args):
        out = real(*args)
        float(out[3].max_speed)
        return out

    cfg = SimConfig(**_GOLDENISH)
    monkeypatch.setattr(stepper, "_sorted_frame", reads_back)
    scene = Scene(cfg)
    stream = torch.cuda.current_stream(cuda_device)
    sk.reset_launch_counts()
    with pytest.raises(RuntimeError):
        scene.step()
    assert sk.launch_counts == dict.fromkeys(sk.launch_counts, 0)
    assert torch.cuda.current_stream(cuda_device) == stream
    assert scene.frame == 0 and scene.last_metrics is None
    assert _all_same_bits(scene.state, initial_state(cfg, cuda_device))
    monkeypatch.setattr(stepper, "_sorted_frame", real)
    eager = Scene(cfg, jit=False)
    assert _all_same_bits(scene.step(2), eager.step(2))


@pytest.mark.cuda
@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("neighbor", ["slotted", "gather"])
def test_exact_tiers_track_the_brute_oracle_on_card(cuda_device, neighbor,
                                                    faithful):
    # the exact tiers are plain PyTorch: no hand-written kernel launches,
    # and 3 calm frames within 1e-5 of the port's brute oracle, the
    # overflow equal (tests/test_torch_cellops.py holds them to JAX)
    cfg = SimConfig(**_CALM)
    s0 = initial_state(cfg, cuda_device)
    sk.reset_launch_counts()
    a, ma = make_rollout(cfg, 3, neighbor=neighbor, faithful=faithful,
                         device=cuda_device)(s0)
    assert not any(sk.launch_counts.values())
    b, mb = make_rollout(cfg, 3, neighbor="brute", faithful=faithful,
                         device=cuda_device)(s0)
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=1e-5)
    assert torch.equal(ma.overflow, mb.overflow)


@pytest.mark.cuda
def test_dt_rollout_is_bit_equal_to_stepping_on_card(cuda_device):
    # one K1 and five K2 launches a frame, and the result of stepping frame
    # by frame with each frame's substep dt
    from sphfluidsimulation_torch import make_dt_rollout, make_param_step
    cfg = SimConfig(**_GOLDENISH)
    s0 = initial_state(cfg, cuda_device)
    dts = [1 / 240, 1 / 120, 1 / 360, 1 / 180]
    sk.reset_launch_counts()
    final, m = make_dt_rollout(cfg, len(dts), device=cuda_device)(s0, dts)
    assert sk.launch_counts == dict(dict.fromkeys(sk.launch_counts, 0),
                                    density=len(dts),
                                    fused_substep=5 * len(dts))
    step = make_param_step(cfg)
    base = PhysParams.from_config(cfg, cuda_device)
    div = torch.tensor(cfg.substep_divisor, dtype=torch.float32,
                       device=cuda_device)
    st = s0
    for dt in dts:
        st, _ = step(st, base._replace(dt=torch.tensor(
            dt, dtype=torch.float32, device=cuda_device) / div))
    for a, b in zip(final, st):
        assert _same_bits(a, b)


@pytest.mark.cuda
def test_snapshots_of_the_sorted_rollout_on_card(cuda_device):
    # taken inside the sorted frame loop: the same launches and the same
    # final state as the rollout without snapshots
    cfg = SimConfig(**_GOLDENISH)
    s0 = initial_state(cfg, cuda_device)
    sk.reset_launch_counts()
    final, _, snaps = make_rollout(cfg, 4, snapshot_every=2,
                                   device=cuda_device)(s0)
    assert sk.launch_counts == dict(dict.fromkeys(sk.launch_counts, 0),
                                    density=4, fused_substep=20)
    _, _, every = make_rollout(cfg, 4, snapshot_every=1,
                               device=cuda_device)(s0)
    plain, _ = make_rollout(cfg, 4, device=cuda_device)(s0)
    assert snaps.shape == (2, cfg.n_particles, 3)
    assert _same_bits(snaps[0], every[1]) and _same_bits(snaps[1], every[3])
    for a, b in zip(final, plain):
        assert _same_bits(a, b)
    assert _same_bits(snaps[1], final.pos)


@pytest.mark.cuda
def test_mesh_properties_on_card(cuda_device):
    from sphfluidsimulation_torch.render import meshprops
    cfg = SimConfig(**_GOLDENISH)
    st, _ = make_rollout(cfg, 2, device=cuda_device)(
        initial_state(cfg, cuda_device))
    mask = st.nan_count > 0
    mat, col = meshprops.mesh_properties(
        st.pos, st.vel, meshprops.RenderParams.from_config(cfg, cuda_device),
        mask)
    assert mat.device.type == "cuda" and col.device.type == "cuda"
    mat_c, col_c = meshprops.mesh_properties(
        st.pos.cpu(), st.vel.cpu(), meshprops.RenderParams.from_config(cfg),
        mask.cpu())
    torch.testing.assert_close(mat.cpu(), mat_c, rtol=0, atol=1e-6)
    torch.testing.assert_close(col.cpu(), col_c, rtol=0, atol=1e-6)


# ------------------------------------------- batching, sites, domain --
# The modules around the kernels: scene batching launches K1 and K2 once a
# phase over all scenes (the scene axis); the sites tier, the sites slab
# step and the domain step are plain PyTorch on the card and launch no
# kernel.

@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
def test_batched_scenes_launch_the_kernels_and_equal_each_scene_alone(
        cuda_device, ext):
    from sphfluidsimulation_torch.parallel import BatchedScenes
    kw = dict(xsph=XSPH, artificial_viscosity=ALPHA) if ext else {}
    cfg = SimConfig(**_GOLDENISH, **kw)
    overrides = [{"rest_density": 1.0 + 0.25 * i, "seed": i}
                 for i in range(3)]
    bs = BatchedScenes(cfg, overrides, devices=cuda_device)
    sk.reset_launch_counts()
    bs.step(2)
    # one K1, one frame record and five K2 a frame over the three scenes
    k2 = "fused_substep_ext_scenes" if ext else "fused_substep_scenes"
    assert sk.launch_counts == dict(dict.fromkeys(sk.launch_counts, 0),
                                    density_scenes=2, frame_record=2,
                                    **{k2: 10})
    for i, ov in enumerate(overrides):
        c = cfg.replace(**ov)
        solo, _ = make_rollout(c, 2, device=cuda_device)(
            initial_state(c, cuda_device))
        for a, b in zip(bs.states, solo):
            assert _same_bits(a[i], b)


def _config5_batch(device, ext):
    """The frame of config 5's batch over the scene axis (8 scenes of
    524,288 requested particles, rest density 1.0-2.0), or with ``ext`` 2
    scenes of config 3's physics, from the spawn: (frame, sorted
    positions, sorted velocities, stacked params, r, cap, xsph, alpha)."""
    from sphfluidsimulation_torch import cli
    from sphfluidsimulation_torch.ops.frame import build_frame_scenes
    from sphfluidsimulation_torch.params import stack_params
    from sphfluidsimulation_torch.state import stack_states
    if ext:
        base = SimConfig(particle_number=524288, preset=2, xsph=0.3,
                         artificial_viscosity=0.5)
        overrides = cli.sweep_overrides(1.2, 1.8, 2)
    else:
        base = SimConfig(particle_number=524288)
        overrides = cli.sweep_overrides(1.0, 2.0, 8)
    cfgs = [base.replace(**ov) for ov in overrides]
    states = stack_states([initial_state(c, device) for c in cfgs])
    params = stack_params([PhysParams.from_config(c, device) for c in cfgs])
    r, cap = base.bucket_resolution, base.voxel_capacity
    frame, (ps, vs) = build_frame_scenes(states.pos, r, cap,
                                         extras=(states.pos, states.vel))
    return (frame, ps, vs, params, r, cap, base.xsph,
            base.artificial_viscosity)


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
def test_scene_axis_kernels_match_plain_at_config5_on_card(cuda_device,
                                                           ext):
    # K1-scenes and K2-scenes (K2-ext-scenes: 2 scenes of config 3's
    # physics) in one launch each, every scene held to its plain version
    # (the solo rules) and bit-equal to its solo launch, on the rows two
    # substeps into the frame; the viscosity (the artificial viscosity)
    # zeroed must fail scene 0's rule
    from sphfluidsimulation_torch.ops.frame import scene_frame
    frame, ps, vs, params, r, cap, xs, al = _config5_batch(cuda_device, ext)
    name = "fused_substep_ext_scenes" if ext else "fused_substep_scenes"
    before = dict(sk.launch_counts)
    rho = sk.density_scenes(frame, ps, params, r, cap)
    rows = sk.pack_rows_scenes(ps, vs, rho)
    for _ in range(2):
        rows = sk.fused_substep_scenes(frame, rows, params, r, cap, xs, al)
    out = sk.fused_substep_scenes(frame, rows, params, r, cap, xs, al)
    assert sk.launch_counts["density_scenes"] == \
        before["density_scenes"] + 1
    assert sk.launch_counts[name] == before[name] + 3
    for sc in range(ps.shape[0]):
        fs, ph = scene_frame(frame, sc), sk.scene_params(params, sc)
        torch.testing.assert_close(rho[sc], sk.density_plain(
            fs, ps[sc], ph, r, cap), rtol=1e-5, atol=1e-6)
        assert _same_bits(rho[sc], sk.density_cuda(fs, ps[sc], ph, r, cap))
        acc = sk.substep_accuracy(fs, rows[sc], out[sc], ph, r, cap, xs, al)
        assert acc.ok, (sc, acc)
        assert _same_bits(out[sc], sk.fused_substep_cuda(
            fs, rows[sc], ph, r, cap, xs, al))
    if ext:
        bad = sk.fused_substep_scenes_cuda(frame, rows, params, r, cap, xs,
                                           0.0)
    else:
        bad = sk.fused_substep_scenes_cuda(
            frame, rows, params._replace(
                viscosity=torch.zeros_like(params.viscosity)), r, cap)
    fs, ph = scene_frame(frame, 0), sk.scene_params(params, 0)
    assert not sk.substep_accuracy(fs, rows[0], bad[0], ph, r, cap, xs,
                                   al).ok


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
def test_forces_scenes_kernel_matches_plain_at_config5_on_card(cuda_device,
                                                               ext):
    # K3-scenes (K3-ext-scenes: 2 scenes of config 3's physics) in one
    # launch on the rows two substeps into the frame (the spawn's
    # velocities are 0, and the unfused route runs K3 on such rows): every
    # scene's sums bit-equal to its solo launch, the ends of the sweep held
    # to their plain versions (the solo rule); the viscosity zeroed (XSPH 0
    # in the fold with extensions) must fail scene 0's rule
    from sphfluidsimulation_torch.ops.frame import scene_frame
    frame, ps, vs, params, r, cap, xs, al = _config5_batch(cuda_device, ext)
    name = "forces_ext_scenes" if ext else "forces_scenes"
    rho = sk.density_scenes(frame, ps, params, r, cap)
    rows = sk.pack_rows_scenes(ps, vs, rho)
    for _ in range(2):
        rows = sk.fused_substep_scenes(frame, rows, params, r, cap, xs, al)
    before = dict(sk.launch_counts)
    sums = sk.forces_scenes_cuda(frame, rows, params, r, cap, ext)
    assert sk.launch_counts[name] == before[name] + 1
    f, dv = sk.fold_forces(sums, rho, sk.scene_view(params), xs, al)
    n_sc = ps.shape[0]
    for sc in range(n_sc):
        fs, ph = scene_frame(frame, sc), sk.scene_params(params, sc)
        assert _same_bits(sums[sc], sk.forces_cuda(fs, rows[sc], ph, r, cap,
                                                   ext))
        if sc in (0, n_sc - 1):
            acc = sk.forces_accuracy(fs, rows[sc], f[sc],
                                     None if dv is None else dv[sc], ph, r,
                                     cap, xs, al)
            assert acc.ok, (sc, acc)
    fs, ph = scene_frame(frame, 0), sk.scene_params(params, 0)
    if ext:
        f0, dv0 = sk.fold_forces(sums[0], rho[0], ph, 0.0, al)
    else:
        bad = sk.forces_scenes_cuda(frame, rows, params._replace(
            viscosity=torch.zeros_like(params.viscosity)), r, cap)
        f0, dv0 = sk.fold_forces(bad[0], rho[0], ph)
    assert not sk.forces_accuracy(fs, rows[0], f0, dv0, ph, r, cap, xs,
                                  al).ok


# The scene-axis K2 and K3 read the frame record (csrc/window_walk.cuh's
# kRec); the reference walk reads occ, raw and pj
_SCENE_WALK_INPUTS = {}


def _scene_walk_inputs(case, device):
    """(frame, frame-start rows, rows two substeps in, params, r, cap, pj,
    frame record) of config 5 after 11 frames of its batch, or of 2 scenes
    of the golden 262k at the spawn; built once a case."""
    if case not in _SCENE_WALK_INPUTS:
        from sphfluidsimulation_torch import GOLDEN_CONFIG, cli
        from sphfluidsimulation_torch.ops.frame import build_frame_scenes
        from sphfluidsimulation_torch.parallel import BatchedScenes
        from sphfluidsimulation_torch.params import stack_params
        from sphfluidsimulation_torch.state import stack_states
        if case == "config5_f11":
            base = SimConfig(particle_number=524288)
            overrides = cli.sweep_overrides(1.0, 2.0, 8)
            bs = BatchedScenes(base, overrides, devices=device)
            bs.step(11)
            states = bs.states
        else:
            base = GOLDEN_CONFIG
            overrides = cli.sweep_overrides(1.0, 2.0, 2)
            states = stack_states([initial_state(base.replace(**ov), device)
                                   for ov in overrides])
        params = stack_params([PhysParams.from_config(base.replace(**ov),
                                                      device)
                               for ov in overrides])
        r, cap = base.bucket_resolution, base.voxel_capacity
        frame, (ps, vs) = build_frame_scenes(states.pos, r, cap,
                                             extras=(states.pos, states.vel))
        rho = sk.density_scenes(frame, ps, params, r, cap)
        rows = mid = sk.pack_rows_scenes(ps, vs, rho)
        for _ in range(2):
            mid = sk.fused_substep_scenes(frame, mid, params, r, cap)
        _SCENE_WALK_INPUTS[case] = (frame, rows, mid, params, r, cap,
                                    sk.pj_cols_scenes(rho, params),
                                    sk.frame_record_scenes(frame, rho,
                                                           params))
    return _SCENE_WALK_INPUTS[case]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(LANE_TUNES))
@pytest.mark.parametrize("case", ["config5_f11", "262k_x2_f0"])
def test_scene_record_walk_is_the_reference_walk_on_card(cuda_device, case,
                                                         variant):
    # K2-scenes and K3-scenes, without and with the extensions, in each
    # variant library: the record walk gives the reference walk's bits, and
    # each scene's solo launch's
    from sphfluidsimulation_torch.ops.frame import scene_frame
    tune = LANE_TUNES[variant]
    frame, rows, mid, params, r, cap, pj, rec = _scene_walk_inputs(
        case, cuda_device)
    for xs, al in ((0.0, 0.0), (XSPH, ALPHA)):
        ext = sk.uses_extensions(xs, al)

        def k2(**kw):
            return sk.fused_substep_scenes_cuda(frame, mid, params, r, cap,
                                                xs, al, tune=tune, **kw)

        def k3(**kw):
            return sk.forces_scenes_cuda(frame, rows, params, r, cap, ext,
                                         tune=tune, **kw)

        ref2 = k2(reference=True, pj=pj)
        ref3 = k3(reference=True, pj=pj)
        assert _same_bits(k2(rec=rec), ref2), ext
        assert _same_bits(k3(rec=rec), ref3), ext
        # the record and pj built in the wrapper
        assert _same_bits(k2(), ref2) and _same_bits(k3(), ref3)
        assert _same_bits(k2(reference=True), ref2)
        for sc in range(mid.shape[0]):
            fs, ph = scene_frame(frame, sc), sk.scene_params(params, sc)
            assert _same_bits(ref2[sc], sk.fused_substep_cuda(
                fs, mid[sc], ph, r, cap, xs, al, tune=tune)), sc
            assert _same_bits(ref3[sc], sk.forces_cuda(
                fs, rows[sc], ph, r, cap, ext, tune=tune)), sc


@pytest.mark.cuda
def test_scene_walk_reads_its_gate_from_the_record_on_card(cuda_device):
    # planted controls: the walk given a record with one occupied slot's
    # occ cleared, or with one raw id moved next to its row's window, must
    # leave the reference walk's bits
    frame, rows, mid, params, r, cap, pj, rec = _scene_walk_inputs(
        "262k_x2_f0", cuda_device)
    ref = sk.fused_substep_scenes_cuda(frame, mid, params, r, cap,
                                       reference=True, pj=pj)
    assert _same_bits(sk.fused_substep_scenes_cuda(
        frame, mid, params, r, cap, rec=rec), ref)
    # slot j: an occupied neighbour of row i in its own cell
    occ = frame.occ[0]
    i = int(torch.nonzero(occ[:-1] & occ[1:]
                          & (frame.raw[0, :-1] == frame.raw[0, 1:]))[1000])
    j = i + 1
    no_occ = rec.clone()
    no_occ.view(torch.int32)[0, j, 3] = 0
    assert not _same_bits(sk.fused_substep_scenes_cuda(
        frame, mid, params, r, cap, rec=no_occ), ref)
    c = sk.fresh_cell(mid[0, i, 0:3], r)
    x = int(c[0]) + 2 if int(c[0]) + 2 < r else int(c[0]) - 2
    moved = rec.clone()
    moved.view(torch.int32)[0, j, 2] = x + (int(c[1]) + int(c[2]) * r) * r
    assert not _same_bits(sk.fused_substep_scenes_cuda(
        frame, mid, params, r, cap, rec=moved), ref)
    # the reference walk reads no record
    assert _same_bits(sk.fused_substep_scenes_cuda(
        frame, mid, params, r, cap, rec=no_occ, reference=True, pj=pj), ref)


# K1's scene axis reads the density record (csrc/window_walk.cuh's
# kDensityRecord); the reference walk reads occ, raw and pos
DENSITY_TUNES = {"default": None, "kahan": SortedTuning(kahan=True)}


def _density_scene_frames(case, device):
    """(frame, sorted positions, params, r) of _scene_walk_inputs' batch,
    its frame built with the config's capacity, 4 and uncut (None)."""
    from sphfluidsimulation_torch.ops.frame import build_frame_scenes
    frame, rows, _, params, r, cap, _, _ = _scene_walk_inputs(case, device)
    pos = rows[..., 0:3].contiguous()
    out = {cap: (frame, pos)}
    for c in (4, None):
        f, (ps,) = build_frame_scenes(pos, r, c, extras=(pos,))
        out[c] = (f, ps)
    return out, params, r


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(DENSITY_TUNES))
@pytest.mark.parametrize("case", ["config5_f11", "262k_x2_f0"])
def test_density_record_walk_is_the_reference_walk_on_card(cuda_device, case,
                                                           variant):
    # K1-scenes in each library, capacity 4, 32 and uncut: the record walk
    # gives the reference walk's bits (the record given, and built in the
    # wrapper) and each scene's solo K1 launch's; each launch counts once,
    # the reference's under +reference too
    from sphfluidsimulation_torch.ops.frame import scene_frame
    tune = DENSITY_TUNES[variant]
    tag = sk.variant_tag("density.cu", sk._tuned(tune))
    frames, params, r = _density_scene_frames(case, cuda_device)
    for cap, (frame, pos) in frames.items():
        rec = sk.density_record_scenes(frame, pos)
        sk.reset_launch_counts()
        ref = sk.density_scenes_cuda(frame, pos, params, r, cap, tune=tune,
                                     reference=True)
        got = sk.density_scenes_cuda(frame, pos, params, r, cap, tune=tune,
                                     rec=rec)
        assert _same_bits(got, ref), cap
        assert _same_bits(sk.density_scenes_cuda(frame, pos, params, r, cap,
                                                 tune=tune), ref), cap
        assert sk.launch_counts[f"density_scenes{tag}"] == 2
        assert sk.launch_counts[f"density_scenes{tag}+reference"] == 1
        for sc in range(pos.shape[0]):
            fs, ph = scene_frame(frame, sc), sk.scene_params(params, sc)
            assert _same_bits(got[sc], sk.density_cuda(
                fs, pos[sc], ph, r, cap, tune=tune)), (cap, sc)


@pytest.mark.cuda
def test_density_walk_reads_its_gate_from_the_record_on_card(cuda_device):
    # planted controls: a record with one occupied slot's gate word
    # cleared, or one slot's position moved, must leave the reference
    # walk's bits; the reference walk reads no record
    frames, params, r = _density_scene_frames("262k_x2_f0", cuda_device)
    frame, pos = frames[32]
    ref = sk.density_scenes_cuda(frame, pos, params, r, 32, reference=True)
    rec = sk.density_record_scenes(frame, pos)
    occ = frame.occ[0]
    j = int(torch.nonzero(occ[:-1] & occ[1:]
                          & (frame.raw[0, :-1] == frame.raw[0, 1:]))[1000])
    cleared = rec.clone()
    cleared.view(torch.int32)[0, j, 3] = -1
    bad = sk.density_scenes_cuda(frame, pos, params, r, 32, rec=cleared)
    assert not _same_bits(bad, ref)
    assert _same_bits(bad[1], ref[1])          # scene 1 reads its own
    moved = rec.clone()
    moved[0, j, 0] += 0.25 / (r - 1)
    assert not _same_bits(sk.density_scenes_cuda(
        frame, pos, params, r, 32, rec=moved), ref)
    assert _same_bits(sk.density_scenes_cuda(
        frame, pos, params, r, 32, rec=cleared, reference=True), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("faithful", [True, False],
                         ids=["faithful", "corrected"])
def test_scenes_step_passes_the_density_record_to_k1_on_card(
        cuda_device, monkeypatch, faithful):
    # on the card the batched step builds the density record of each
    # K1-scenes launch's own frame and positions and passes it: once a
    # faithful frame, 1 + 5 times a corrected frame; each launch counts once
    from sphfluidsimulation_torch.params import stack_params
    from sphfluidsimulation_torch.sim import stepper
    from sphfluidsimulation_torch.state import stack_states
    built, given = [], []
    real_rec, real_k1 = sk.density_record_scenes, sk.density_scenes

    def record(frame, pos_s):
        rec = real_rec(frame, pos_s)
        built.append((rec, pos_s, frame))
        return rec

    def k1(frame, pos_s, *a, **k):
        given.append(k.get("rec"))
        return real_k1(frame, pos_s, *a, **k)

    monkeypatch.setattr(sk, "density_record_scenes", record)
    monkeypatch.setattr(sk, "density_scenes", k1)
    cfgs = [SimConfig(**_GOLDENISH).replace(rest_density=1.0 + 0.25 * i,
                                            seed=i) for i in range(3)]
    states = stack_states([initial_state(c, cuda_device) for c in cfgs])
    params = stack_params([PhysParams.from_config(c, cuda_device)
                           for c in cfgs])
    step = stepper.make_scenes_step(cfgs[0], faithful, SortedTuning())
    sk.reset_launch_counts()
    frames = 2
    for _ in range(frames):
        states, _ = step(states, params)
    per = 1 if faithful else 1 + cfgs[0].substeps
    assert len(built) == len(given) == frames * per
    assert sk.launch_counts["density_scenes"] == frames * per
    for (rec, pos_s, frame), got in zip(built, given):
        assert got is rec
        assert torch.equal(rec[..., 0:3], pos_s)
        assert torch.equal(rec.view(torch.int32)[..., 3],
                           torch.where(frame.occ, frame.raw, -1))


@pytest.mark.cuda
def test_compact_scenes_kernels_match_plain_on_card(cuda_device):
    # K5-scenes in each mode over 3 scenes with random velocities, on rows
    # of scene 1 moved 2.5 cells up in z after the frame build (some leave
    # their tile's band):
    # every scene's output and drift count bit-equal to its solo launch's,
    # held to its plain version, the drift counts per scene (scene 1's
    # only), and the substep without viscosity must fail the rule
    from sphfluidsimulation_torch.ops.frame import (build_frame_scenes,
                                                    scene_frame)
    from sphfluidsimulation_torch.params import stack_params
    from sphfluidsimulation_torch.state import stack_states
    cfgs = [SimConfig(**_GOLDENISH).replace(rest_density=1.0 + 0.25 * i,
                                            seed=i) for i in range(3)]
    states = stack_states([initial_state(c, cuda_device) for c in cfgs])
    params = stack_params([PhysParams.from_config(c, cuda_device)
                           for c in cfgs])
    r = cfgs[0].bucket_resolution
    vel = 0.2 * torch.randn(states.vel.shape, device=cuda_device,
                            generator=torch.Generator(cuda_device)
                            .manual_seed(0))
    frame, (ps, vs) = build_frame_scenes(states.pos, r, CAP,
                                         extras=(states.pos, vel))
    before = dict(sk.launch_counts)
    rho, c0 = compact.density_compact_scenes(frame, ps, params, r, CAP)
    rows = sk.pack_rows_scenes(ps, vs, rho)
    rows[1, 100:111, 2] += 2.5 / (r - 1)
    outs = {(xs, al): compact.compact_substep_scenes(frame, rows, params, r,
                                                     CAP, xs, al)
            for xs, al in ((0.0, 0.0), (XSPH, ALPHA))}
    f, cf = compact.forces_compact_scenes(frame, rows, params, r, CAP)
    sums, _ = compact.forces_compact_scenes_cuda(frame, rows, params, r, CAP)
    for k in ("compact_density_scenes", "compact_substep_scenes",
              "compact_substep_ext_scenes", "compact_forces_scenes"):
        assert sk.launch_counts[k] > before[k]
    assert c0.tolist() == [0, 0, 0]
    assert cf.tolist()[0] == cf.tolist()[2] == 0 and int(cf[1]) > 0
    for sc in range(3):
        fs, ph = scene_frame(frame, sc), sk.scene_params(params, sc)
        rho1, c1 = compact.density_compact_cuda(fs, ps[sc], ph, r, CAP)
        assert _same_bits(rho[sc], rho1) and int(c1) == 0
        torch.testing.assert_close(rho[sc], compact.density_compact_plain(
            fs, ps[sc], ph, r)[0], rtol=1e-5, atol=1e-6)
        cp = compact.spans_of(fs, rows[sc, :, 0:3], r, True)[1]
        for (xs, al), (out, c) in outs.items():
            o1, c1 = compact.compact_substep_cuda(fs, rows[sc], ph, r, CAP,
                                                  xs, al)
            assert _same_bits(out[sc], o1) and int(c[sc]) == int(c1)
            assert int(c[sc]) == int(cp)
            acc = sk.substep_accuracy(fs, rows[sc], out[sc], ph, r, None,
                                      xs, al,
                                      sums_fn=compact.compact_sums_plain)
            assert acc.ok, (sc, xs, acc)
        s1, c1 = compact.forces_compact_cuda(fs, rows[sc], ph, r, CAP)
        assert _same_bits(sums[sc], s1) and int(cf[sc]) == int(c1)
        assert sk.forces_accuracy(fs, rows[sc], f[sc], None, ph, r, None,
                                  sums_fn=compact.compact_sums_plain).ok
    no_visc = params._replace(viscosity=torch.zeros_like(params.viscosity))
    bad, _ = compact.compact_substep_scenes_cuda(frame, rows, no_visc, r, CAP)
    fs, ph = scene_frame(frame, 1), sk.scene_params(params, 1)
    assert not sk.substep_accuracy(fs, rows[1], bad[1], ph, r, None,
                                   sums_fn=compact.compact_sums_plain).ok


# ------------------------------------------- K5's split of wide tiles --

# a threshold low enough that most tiles of these small frames split, and
# the planted wide tile: its rows spread 1.2 cells up and down in z (on the
# tiny frame tile 40's union then holds 1406 occupied slots, past the
# default threshold)
SPLIT16 = 16
SPLIT_TILE = 5


def _planted(rows, r, tile=SPLIT_TILE):
    out = rows.clone()
    a = tile * compact.CROWS
    out[a:a + 32:2, 2] += 1.2 / (r - 1)
    out[a + 1:a + 32:2, 2] -= 1.2 / (r - 1)
    out[:, 0:3] = out[:, 0:3].clamp(0.0, 1.0)
    return out


def _split_rows(device, name="calm", tile=SPLIT_TILE):
    """A frame on the card and its rows with random velocities and the
    planted wide tile."""
    tf, ps, _, tp, r = _card_inputs(name, device)
    vel = 0.2 * torch.randn(ps.shape, device=device,
                            generator=torch.Generator(device).manual_seed(0))
    rows = sk.pack_rows(ps, vel, sk.density_plain(tf, ps, tp, r, CAP))
    return tf, ps, _planted(rows, r, tile), tp, r


def _held(tf, rows, out, tp, r, xs=0.0, al=0.0, band=None):
    return sk.substep_accuracy(tf, rows, out, tp, r, None, xs, al,
                               sums_fn=compact.compact_sums_plain, band=band)


@pytest.mark.cuda
@pytest.mark.parametrize("name,slots,tile", [
    ("calm", 8, SPLIT_TILE), ("calm", SPLIT16, SPLIT_TILE),
    ("tiny", compact.SPLIT_SLOTS, 40)])
def test_split_kernel_matches_plain_on_wide_tiles(cuda_device, name, slots,
                                                  tile):
    # the substep split at `slots` occupied slots on the planted frame:
    # held to its plain version with and without extensions, the drift
    # count the plain version's, the bits those of a second launch, of the
    # uncut stream and of a launch given occ_cum, one substep launch
    # counted; the whole-tile body held alike
    tf, _, rows, tp, r = _split_rows(cuda_device, name, tile)
    spans, drift = compact.spans_of(tf, rows[:, 0:3], r, True)
    occ_cum = compact.occ_prefix(tf.occ)
    k = compact.n_chunks(compact.tile_cost(spans, tf.start, occ_cum, r),
                         slots)
    assert int(k[tile]) >= 2 and int((k > 1).sum()) >= 1
    for xs, al in ((0.0, 0.0), (XSPH, ALPHA)):
        name_k = "compact_substep_ext" if xs else "compact_substep"
        before = sk.launch_counts[name_k]
        out, c = compact.compact_substep_cuda(tf, rows, tp, r, CAP, xs, al,
                                              split=slots)
        assert sk.launch_counts[name_k] == before + 1
        assert int(c) == int(drift)
        acc = _held(tf, rows, out, tp, r, xs, al)
        assert acc.ok, acc
        for again in (compact.compact_substep_cuda(tf, rows, tp, r, CAP, xs,
                                                   al, split=slots),
                      compact.compact_substep_cuda(tf, rows, tp, r, None, xs,
                                                   al, split=slots),
                      compact.compact_substep_cuda(tf, rows, tp, r, CAP, xs,
                                                   al, occ_cum=occ_cum,
                                                   split=slots)):
            assert _same_bits(again[0], out) and int(again[1]) == int(c)
        whole, cw = compact.compact_substep_cuda(tf, rows, tp, r, CAP, xs, al,
                                                 split=0)
        assert int(cw) == int(drift)
        acc = _held(tf, rows, whole, tp, r, xs, al)
        assert acc.ok, acc


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4])
def test_split_kernel_matches_plain_on_slab_frames(cuda_device, d):
    # K5-band split at 16 slots on each shard's frame of the goldenish
    # scene on d slabs, rows planted: held to the banded plain version,
    # dead rows copied through, the drift count the plain version's, the
    # bits those of a second launch
    from sphfluidsimulation_torch.parallel import (LocalRing, distribute,
                                                   make_pallas_slab_step)
    from sphfluidsimulation_torch.parallel.slab_pallas import shard_frames
    cfg = SimConfig(**_GOLDENISH)
    ring = LocalRing(d)
    _, spec = make_pallas_slab_step(cfg, ring, row_slack=4.0, tune=COMPACT)
    sst = distribute(initial_state(cfg, cuda_device), cfg, spec)
    tp = PhysParams.from_config(cfg, cuda_device)
    r = cfg.bucket_resolution
    split_any = False
    for sf in shard_frames(cfg, spec, ring, sst):
        band, n_live = sf.band, int(sf.frame.start[-1])
        rho, _ = compact.density_compact_cuda(sf.frame, sf.pos_s, tp, r, CAP,
                                              band=band)
        torch.testing.assert_close(rho, compact.density_compact_plain(
            sf.frame, sf.pos_s, tp, r, band)[0], rtol=1e-5, atol=1e-6)
        rows = sk.pack_rows(sf.pos_s, sf.vel_s, rho)
        if n_live > (SPLIT_TILE + 1) * compact.CROWS:
            rows[:n_live] = _planted(rows[:n_live], r)
        spans, drift = compact.spans_of(sf.frame, rows[:, 0:3], r, True, band)
        cost = compact.tile_cost(spans, sf.frame.start,
                                 compact.occ_prefix(sf.frame.occ), r, band)
        split_any |= bool((cost > SPLIT16).any())
        out, c = compact.compact_substep_cuda(sf.frame, rows, tp, r, CAP,
                                              band=band, split=SPLIT16)
        assert int(c) == int(drift)
        assert torch.equal(out[n_live:], rows[n_live:])
        acc = _held(sf.frame, rows, out, tp, r, band=band)
        assert acc.ok, acc
        again, _ = compact.compact_substep_cuda(sf.frame, rows, tp, r, CAP,
                                                band=band, split=SPLIT16)
        assert _same_bits(again, out)
    assert split_any


@pytest.mark.cuda
def test_split_scenes_are_bit_equal_to_solo_on_card(cuda_device):
    # 3 scenes, scene 1's rows planted: the split scene-axis launch gives
    # each scene its solo split launch's bits and drift count, held to the
    # plain version
    from sphfluidsimulation_torch.ops.frame import (build_frame_scenes,
                                                    scene_frame)
    from sphfluidsimulation_torch.params import stack_params
    from sphfluidsimulation_torch.state import stack_states
    cfgs = [SimConfig(**_CALM).replace(rest_density=1.5 + 0.1 * i, seed=i)
            for i in range(3)]
    states = stack_states([initial_state(c, cuda_device) for c in cfgs])
    params = stack_params([PhysParams.from_config(c, cuda_device)
                           for c in cfgs])
    r = cfgs[0].bucket_resolution
    frame, (ps, vs) = build_frame_scenes(states.pos, r, CAP,
                                         extras=(states.pos, states.vel))
    rho, _ = compact.density_compact_scenes_cuda(frame, ps, params, r, CAP)
    rows = sk.pack_rows_scenes(ps, vs, rho)
    rows[1] = _planted(rows[1], r)
    out, cs = compact.compact_substep_scenes_cuda(frame, rows, params, r, CAP,
                                                  XSPH, ALPHA, split=SPLIT16)
    for sc in range(3):
        fs, ph = scene_frame(frame, sc), sk.scene_params(params, sc)
        o1, c1 = compact.compact_substep_cuda(fs, rows[sc], ph, r, CAP, XSPH,
                                              ALPHA, split=SPLIT16)
        assert _same_bits(out[sc], o1) and int(cs[sc]) == int(c1)
        acc = _held(fs, rows[sc], out[sc], ph, r, XSPH, ALPHA)
        assert acc.ok, (sc, acc)
    # a threshold that only scene 1 passes: scenes 0 and 2 walk every tile
    # whole and scene 1 splits, each with its solo bits
    costs = []
    for sc in range(3):
        fs = scene_frame(frame, sc)
        spans, _ = compact.spans_of(fs, rows[sc, :, 0:3], r, True)
        costs.append(int(compact.tile_cost(spans, fs.start, compact.occ_prefix(
            fs.occ), r).max()))
    slots = max(costs[0], costs[2])
    assert costs[1] > slots
    out, cs = compact.compact_substep_scenes_cuda(frame, rows, params, r, CAP,
                                                  split=slots)
    for sc in range(3):
        fs, ph = scene_frame(frame, sc), sk.scene_params(params, sc)
        o1, c1 = compact.compact_substep_cuda(fs, rows[sc], ph, r, CAP,
                                              split=slots)
        assert _same_bits(out[sc], o1) and int(cs[sc]) == int(c1)
        if sc != 1:
            whole, _ = compact.compact_substep_cuda(fs, rows[sc], ph, r, CAP,
                                                    split=0)
            assert _same_bits(out[sc], whole)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [4, CAP, None])
@pytest.mark.parametrize("slots", [2, 8, SPLIT16, None])
def test_split_band_density_matches_plain_on_card(cuda_device, slots, cap):
    # K5-band density split at `slots` occupied union slots (None: the
    # default, compact.DENSITY_SPLIT_SLOTS) on a slab shard's frame built
    # with capacity `cap`: held to the banded plain version, dead rows 0,
    # the bits those of a second launch, of the uncut stream and of a launch
    # given occ_cum, one launch counted a call; at 2, 8 and 16 slots most
    # live tiles split (at 2 into more chunks than the queue holds, so the
    # chunk kernel also walks tiles past its end); the whole-tile body held
    # alike; and planted: the split launch with a smoothing length 5%
    # longer fails the tolerance
    band = (1, 6)
    tf, ps, _, tp, r, n_live = _banded_inputs(cap, cuda_device, band)
    occ_cum = compact.occ_prefix(tf.occ)
    spans = compact.stale_spans(tf, band, r)
    k = compact.n_chunks(compact.tile_cost(spans, tf.start, occ_cum, r, band),
                         slots or compact.DENSITY_SPLIT_SLOTS)
    if slots is not None:
        live = compact._tiled(compact.live_rows(tf), False).any(1)
        assert 2 * int((k[live] > 1).sum()) > int(live.sum())
    if slots == 2:
        assert int(k[k > 1].sum()) > 4 * k.shape[0]
    want, _ = compact.density_compact_plain(tf, ps, tp, r, band)
    before = sk.launch_counts["compact_density_band"]
    rho, c = compact.density_compact_cuda(tf, ps, tp, r, cap, band=band,
                                          split=slots)
    assert sk.launch_counts["compact_density_band"] == before + 1
    torch.testing.assert_close(rho, want, rtol=1e-5, atol=1e-6)
    assert not rho[n_live:].any() and int(c) == 0
    for again in (compact.density_compact_cuda(tf, ps, tp, r, cap, band=band,
                                               split=slots),
                  compact.density_compact_cuda(tf, ps, tp, r, None,
                                               band=band, split=slots),
                  compact.density_compact_cuda(tf, ps, tp, r, cap, band=band,
                                               occ_cum=occ_cum,
                                               split=slots)):
        assert _same_bits(again[0], rho) and int(again[1]) == 0
    assert sk.launch_counts["compact_density_band"] == before + 4
    whole, _ = compact.density_compact_cuda(tf, ps, tp, r, cap, band=band,
                                            split=0)
    torch.testing.assert_close(whole, want, rtol=1e-5, atol=1e-6)
    if int(k.max()) == 1:                   # nothing split: the same walk
        assert _same_bits(whole, rho)
    longer = sk.scal_block(tp._replace(h=1.05 * tp.h))
    bad, _ = compact.density_compact_cuda(tf, ps, tp, r, cap, longer, band,
                                          split=slots)
    assert not torch.allclose(bad, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [0, 3])
@pytest.mark.parametrize("cap", [4, CAP, None])
def test_compact_density_scenes_keep_each_scenes_bits_on_card(cuda_device,
                                                              cap, frames):
    # K5-scenes density over 3 goldenish scenes, at the spawn (aliased raw
    # ids) and 3 frames on, with the frame built at capacity 4 (dropped
    # rows), 32 and uncut: each scene bit-equal to its solo K5 density, to
    # the uncut stream's and to a second launch, and held to the plain
    # version; one launch counted a call; planted: a frame with one of
    # scene 1's occupied slots marked unoccupied changes scene 1's bits and
    # no other scene's
    from sphfluidsimulation_torch.ops.frame import (build_frame_scenes,
                                                    scene_frame)
    from sphfluidsimulation_torch.params import stack_params
    from sphfluidsimulation_torch.state import stack_states
    cfgs = [SimConfig(**_GOLDENISH).replace(rest_density=1.0 + 0.25 * i,
                                            seed=i) for i in range(3)]
    states = []
    for c in cfgs:
        st = initial_state(c, cuda_device)
        if frames:
            st, _ = make_rollout(c, frames, device=cuda_device)(st)
        states.append(st)
    states = stack_states(states)
    params = stack_params([PhysParams.from_config(c, cuda_device)
                           for c in cfgs])
    r = cfgs[0].bucket_resolution
    frame, (ps,) = build_frame_scenes(states.pos, r, cap,
                                      extras=(states.pos,))
    before = sk.launch_counts["compact_density_scenes"]
    rho, c = compact.density_compact_scenes(frame, ps, params, r, cap)
    assert sk.launch_counts["compact_density_scenes"] == before + 1
    assert c.tolist() == [0, 0, 0]
    for again in (compact.density_compact_scenes_cuda(frame, ps, params, r,
                                                      None)[0],
                  compact.density_compact_scenes_cuda(frame, ps, params, r,
                                                      cap)[0]):
        assert _same_bits(again, rho)
    for sc in range(3):
        fs, ph = scene_frame(frame, sc), sk.scene_params(params, sc)
        assert _same_bits(rho[sc],
                          compact.density_compact_cuda(fs, ps[sc], ph, r,
                                                       cap)[0])
        torch.testing.assert_close(rho[sc], compact.density_compact_plain(
            fs, ps[sc], ph, r)[0], rtol=1e-5, atol=1e-6)
    if frames == 0:
        assert bool((frame.raw != frame.cid).any())      # aliased raw ids
    if cap == 4:
        assert not bool(frame.occ.all())
    occ = frame.occ.clone()
    occupied = occ[1].nonzero()[:, 0]
    occ[1, occupied[occupied.shape[0] // 2]] = False
    bad, _ = compact.density_compact_scenes_cuda(frame._replace(occ=occ), ps,
                                                 params, r, cap)
    assert not _same_bits(bad[1], rho[1])
    assert _same_bits(bad[0], rho[0]) and _same_bits(bad[2], rho[2])


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [0, SPLIT16])
def test_tile_clock_records_each_chunk_on_card(cuda_device, slots):
    # the clock instance (-DSPH_TILE_CLOCK=1) gives the default instance's
    # bits and one entry per chunk that ran: each tile's chunks, their
    # cells those of chunk_cells, their spans positive
    tf, _, rows, tp, r = _split_rows(cuda_device, "tiny")
    clock = compact.clock_buffer(rows.shape[0], cuda_device)
    out, c = compact.compact_substep_cuda(tf, rows, tp, r, CAP, split=slots,
                                          clock=clock)
    ref, c_ref = compact.compact_substep_cuda(tf, rows, tp, r, CAP,
                                              split=slots)
    assert _same_bits(out, ref) and int(c) == int(c_ref)
    spans, _ = compact.spans_of(tf, rows[:, 0:3], r, True)
    occ_cum = compact.occ_prefix(tf.occ)
    cost = compact.tile_cost(spans, tf.start, occ_cum, r)
    ran = clock[0, ..., 1] > 0
    k = ran.sum(1)
    if slots == 0:
        assert bool((k == 1).all() and ran[:, 0].all())
    else:
        want = compact.n_chunks(cost, slots).to(k.dtype)
        assert torch.equal(k, want) and int((want > 1).sum()) > 0
        bounds = compact.chunk_cells(spans, tf.start, occ_cum, r, slots)
        split_tiles = (want > 1).nonzero()[:, 0]
        for t in split_tiles.tolist():
            got = [(v & 0xffffffff, v >> 32)
                   for v in clock[0, t, :int(want[t]), 3].tolist()]
            assert got == [(int(bounds[t, q]), int(bounds[t, q + 1]))
                           for q in range(int(want[t]))]
    used = clock[0][ran]
    assert bool((used[:, 1] >= used[:, 0]).all() and (used[:, 2] > 0).all())
    stats = compact.clock_stats([clock])
    assert stats["tiles"] == cost.shape[0]
    assert stats["makespan_us"] >= stats["max_us"] >= stats["p99_us"] > 0


# ------------------------- K5 forces: each lane walks its own slots --

BF16 = SortedTuning(bf16=True)
K5_FORCES_TUNES = {"default": None, "bf16": BF16}


def _forces_scenes(frames, cap, device):
    """3 goldenish scenes (rest density 1.0-1.5) from the spawn (aliased
    raw ids) or ``frames`` frames on, random velocities, the frame built at
    capacity ``cap``: (frame, rows, params, r)."""
    from sphfluidsimulation_torch.ops.frame import build_frame_scenes
    from sphfluidsimulation_torch.params import stack_params
    from sphfluidsimulation_torch.state import stack_states
    cfgs = [SimConfig(**_GOLDENISH).replace(rest_density=1.0 + 0.25 * i,
                                            seed=i) for i in range(3)]
    states = []
    for c in cfgs:
        st = initial_state(c, device)
        if frames:
            st, _ = make_rollout(c, frames, device=device)(st)
        states.append(st)
    states = stack_states(states)
    params = stack_params([PhysParams.from_config(c, device) for c in cfgs])
    r = cfgs[0].bucket_resolution
    vel = 0.2 * torch.randn(states.vel.shape, device=device,
                            generator=torch.Generator(device).manual_seed(1))
    frame, (ps, vs) = build_frame_scenes(states.pos, r, cap,
                                         extras=(states.pos, vel))
    rho = compact.density_compact_scenes(frame, ps, params, r, cap)[0]
    return frame, sk.pack_rows_scenes(ps, vs, rho), params, r


def _forces_hold_the_reference(frame, rows, params, r, cap, tune):
    """K5-scenes forces against solo K5 forces, scene by scene, each in the
    walk it chooses and in both walks (each lane's own slots, and every
    lane through the round's list): every sum and drift count bit-equal;
    the launches counted."""
    from sphfluidsimulation_torch.ops.frame import scene_frame
    tag = sk.variant_tag("compact.cu", (tune or SortedTuning()).k5())
    before = dict(sk.launch_counts)
    sums, c = compact.forces_compact_scenes_cuda(frame, rows, params, r, cap,
                                                 tune=tune)
    for own in (False, True):
        s_all, c_all = compact.forces_compact_scenes_cuda(
            frame, rows, params, r, cap, tune=tune, own=own)
        assert _same_bits(s_all, sums) and torch.equal(c_all, c)
    key = "compact_forces_scenes" + tag
    assert sk.launch_counts[key] == before.get(key, 0) + 3
    for sc in range(rows.shape[0]):
        fs, ph = scene_frame(frame, sc), sk.scene_params(params, sc)
        for own in (None, False, True):
            s1, c1 = compact.forces_compact_cuda(fs, rows[sc], ph, r, cap,
                                                 tune=tune, own=own)
            assert _same_bits(sums[sc], s1) and int(c[sc]) == int(c1)
    solo = "compact_forces" + tag
    assert sk.launch_counts[solo] == before.get(solo, 0) + 3 * rows.shape[0]
    return sums, c


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(K5_FORCES_TUNES))
@pytest.mark.parametrize("frames", [0, 3])
@pytest.mark.parametrize("cap", [4, CAP, None])
def test_compact_forces_own_lists_are_the_reference_walk_on_card(
        cuda_device, cap, frames, variant):
    # K5 forces with each lane walking its own slots of a round, which
    # these scenes (under one row a cell) take, is bit for bit the walk in
    # which every lane steps through the round's whole list, solo and over
    # the scene axis, each scene its solo launch, in both libraries, at
    # capacity 4 (dropped rows), 32 and uncut; and held to its plain version
    from sphfluidsimulation_torch.ops.frame import scene_frame
    tune = K5_FORCES_TUNES[variant]
    frame, rows, params, r = _forces_scenes(frames, cap, cuda_device)
    assert compact.own_lists(rows.shape[1], r)
    rows[1, 100:111, 2] += 2.5 / (r - 1)           # past their tile's band
    sums, c = _forces_hold_the_reference(frame, rows, params, r, cap, tune)
    assert int(c[1]) > 0
    fs, ph = scene_frame(frame, 1), sk.scene_params(params, 1)
    f = sk.fold_forces(sums[1], rows[1, :, 6], ph, fuse_acc=False)[0]
    assert sk.forces_accuracy(fs, rows[1], f, None, ph, r, None,
                              sums_fn=compact.compact_sums_plain,
                              tune=tune).ok


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [CAP, None])
def test_compact_forces_own_lists_at_config5_on_card(cuda_device, cap):
    # config 5 after 11 frames of its batch, the forces on the frame-start
    # rows as the corrected compact sweep runs them: K5-scenes forces, which
    # takes the round's list at about 5 rows a cell, bit-equal to the own
    # lists and each scene to its solo launches in both walks
    frame, rows, _, params, r, _, _, _ = _scene_walk_inputs("config5_f11",
                                                            cuda_device)
    assert not compact.own_lists(rows.shape[1], r)
    _forces_hold_the_reference(frame, rows, params, r, cap, None)
    # the own lists' steps are fewer than the list's pair steps
    from sphfluidsimulation_torch.ops.frame import scene_frame
    _, paired, own = compact.walk_counts(scene_frame(frame, 0),
                                         rows[0, :, 0:3], r, cap)
    assert int(own.sum()) < int(paired.sum())


def _planted_library(source, edits, label, defines=()):
    """``source`` (csrc/) with ``edits`` (old text, which must appear once,
    and its replacement) made, compiled with ``defines`` into
    build/planted/<label> and bound: a planted control's kernels."""
    import subprocess
    import types
    from sphfluidsimulation_torch.ops import cuda_build
    src = (cuda_build.CSRC / source).read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "planted"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{label}.cu", out / f"lib{label}.so"
    cu.write_text(src)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                    *defines, "-I", str(cuda_build.CSRC), "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    fns: dict = {}
    cuda_build._bind(so, cuda_build.KERNELS[source], fns)
    return types.SimpleNamespace(**fns)


@pytest.mark.cuda
def test_forces_lane_mask_without_the_self_skip_fails_on_card(cuda_device,
                                                              monkeypatch):
    # planted: a lane mask that keeps the row's own slot adds the self pair,
    # which the bf16 library makes nonzero (bf16(v_i) is not v_i): the solo
    # launch through the own lists leaves the list walk's bits
    from sphfluidsimulation_torch.ops import cuda_build
    from sphfluidsimulation_torch.ops.frame import scene_frame
    lib = _planted_library(
        "compact.cu", [("cell_near(e.cell, cx, cy, cz) && e.j != i ? 1u",
                        "cell_near(e.cell, cx, cy, cz) ? 1u")],
        "compact_self_pair", ("-DSPH_BF16=1",))
    frame, rows, params, r = _forces_scenes(0, CAP, cuda_device)
    fs, ph, rows = scene_frame(frame, 0), sk.scene_params(params, 0), rows[0]
    ref, c_ref = compact.forces_compact_cuda(fs, rows, ph, r, CAP, tune=BF16,
                                             own=False)
    real = cuda_build.function

    def planted(source, name, tune=None, clock=False, sweep=False):
        if source == "compact.cu" and tune is not None and tune.bf16:
            return getattr(lib, name)
        return real(source, name, tune, clock=clock, sweep=sweep)

    monkeypatch.setattr(cuda_build, "function", planted)
    bad, c_bad = compact.forces_compact_cuda(fs, rows, ph, r, CAP, tune=BF16,
                                             own=True)
    assert int(c_bad) == int(c_ref) and not _same_bits(bad, ref)
    # the planted library's list walk is the unplanted one's
    again, _ = compact.forces_compact_cuda(fs, rows, ph, r, CAP, tune=BF16,
                                           own=False)
    assert _same_bits(again, ref)


# ------------------- the bf16 K2-ext: candidates rounded once a substep --

# config 3 (BASELINE.json: the extension sums)
C3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
               artificial_viscosity=0.5)


def _bf16_ext_rows(case, device, cfg=C3):
    """``cfg``'s frame at the spawn (config 3's and the golden scene's
    alias raw ids) and its rows with random velocities (the spawn's are 0,
    which bf16 keeps), and (``case`` "inf") ±inf velocities planted in some
    rows."""
    st = initial_state(cfg, device)
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    vel = 0.2 * torch.randn(st.vel.shape, device=device,
                            generator=torch.Generator(device).manual_seed(2))
    tf, (ps, vs) = build_frame(st.pos, r, cap, extras=(st.pos, vel))
    tp = PhysParams.from_config(cfg, device)
    rows = sk.pack_rows(ps, vs, sk.density_cuda(tf, ps, tp, r, cap))
    if case == "inf":
        rows[::1001, 3] = float("inf")
        rows[7::997, 4] = -float("inf")
        rows[3::991, 5] = float("inf")
    return tf, rows, tp, r, cap, cfg.xsph, cfg.artificial_viscosity


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_substep", "forces"])
@pytest.mark.parametrize("case", ["spawn", "inf"])
def test_bf16_ext_reads_candidates_rounded_once_on_card(cuda_device, case,
                                                        kernel):
    # the pass's copy bit-equal to its plain version; the bf16 K2-ext
    # (``kernel`` "fused_substep") or K3-ext ("forces"), which makes it,
    # bit-equal to the walk that rounds every slot in its registers, the
    # reference; one pass and one walk counted a call; planted: a copy
    # whose vz is truncated to its high half, not rounded, leaves the
    # reference's bits
    tf, rows, tp, r, cap, xs, al = _bf16_ext_rows(case, cuda_device)
    scal = sk.scal_block(tp, xs, al)
    cand = sk.bf16_candidates_cuda(rows)
    want = sk.bf16_candidates_plain(rows)
    assert _same_bits(cand, want)

    def walk(**kw):
        if kernel == "forces":
            return sk.forces_cuda(tf, rows, tp, r, cap, True, tune=BF16, **kw)
        return sk.fused_substep_cuda(tf, rows, tp, r, cap, xs, al, tune=BF16,
                                     **kw)
    name = ("forces" if kernel == "forces" else "fused_substep_ext") + "+bf16"
    before = dict(sk.launch_counts)
    out = walk()
    assert sk.launch_counts[name] == before.get(name, 0) + 1
    assert sk.launch_counts["bf16_candidates"] == \
        before["bf16_candidates"] + 1
    ref = walk(reference=True)
    assert sk.launch_counts[name + "+reference"] >= 1
    assert _same_bits(out, ref)
    assert _same_bits(walk(scal=scal if kernel != "forces"
                           else sk.scal_block(tp)), ref)
    if case == "inf":
        assert not bool(torch.isfinite(ref).all())
    planted = cand.clone()
    tail = sk.candidate_halves(planted)[1]
    vz = rows[:, 5].view(torch.int32) & -0x10000
    rho = sk.bf16_round(rows[:, 6]).view(torch.int32)
    tail[:, 0] = (vz | ((rho >> 16) & 0xFFFF)).view(torch.float32)
    from sphfluidsimulation_torch.ops import cuda_build
    bad = torch.empty_like(ref)
    source = "forces.cu" if kernel == "forces" else "fused_substep.cu"
    sk._walk_launch(cuda_build.function(source, f"sph_{source[:-3]}_cand",
                                        BF16),
                    kernel, tf, rows, None,
                    sk.scal_block(tp) if kernel == "forces" else scal, bad,
                    r, cap, True, cand=planted)
    assert not _same_bits(bad, ref)


def _record_walk_rows(case, device, cfg=C3):
    """(frame, rows, phys, r, cap, xsph, alpha) of ``cfg`` (config 3, or
    the golden 262k scene without extensions) for the record walks: the
    aliased spawn with random velocities (and, ``case`` "inf", ±inf ones),
    the faithful rollout's frame 10 or (``case`` "corrected") the corrected
    rollout's frame-10 substep frame, the rows K3 reads there."""
    if case not in ("frame10", "corrected"):
        return _bf16_ext_rows(case, device, cfg)
    st, _ = make_rollout(cfg, 10, faithful=case == "frame10",
                         device=device)(initial_state(cfg, device))
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    tf, (ps, vs) = build_frame(st.pos, r, cap, extras=(st.pos, st.vel))
    tp = PhysParams.from_config(cfg, device)
    rows = sk.pack_rows(ps, vs, sk.density_cuda(tf, ps, tp, r, cap))
    return tf, rows, tp, r, cap, cfg.xsph, cfg.artificial_viscosity


def _holds_the_record_walk(case, kernel, tune, device, cfg=C3):
    """The record walk of ``kernel`` ("fused_substep": K2, "forces": K3)
    in ``tune``'s library on ``case``'s rows of ``cfg`` (config 3: with the
    extension sums; without them where ``cfg`` has none): the launched walk
    (its record built in the wrapper, or given, built by the pass)
    bit-equal to the walk that reads occ, raw and pj (``reference``); one
    launch and one pass counted a call; a record whose occ lane is cleared
    on one occupied row leaves the reference's bits."""
    tf, rows, tp, r, cap, xs, al = _record_walk_rows(case, device, cfg)
    ext = sk.uses_extensions(xs, al)
    assert sk.walk_instance(kernel, tune, ext) == f"sph_{kernel}_scenes"

    def walk(**kw):
        if kernel == "forces":
            return sk.forces_cuda(tf, rows, tp, r, cap, ext, tune=tune,
                                  **kw)
        return sk.fused_substep_cuda(tf, rows, tp, r, cap, xs, al,
                                     tune=tune, **kw)
    name = ("forces" if kernel == "forces" else
            "fused_substep_ext" if ext else "fused_substep") + \
        sk.variant_tag(f"{kernel}.cu", tune)
    before = dict(sk.launch_counts)
    out = walk()
    assert sk.launch_counts[name] == before.get(name, 0) + 1
    assert sk.launch_counts["frame_record"] == before["frame_record"] + 1
    ref = walk(reference=True)
    assert _same_bits(out, ref)
    if case == "inf":
        assert not bool(torch.isfinite(ref).all())
    rec = sk.frame_record(tf, rows[:, 6], tp)
    assert _same_bits(rec, sk.frame_record_scenes_plain(
        *sk.one_scene(tf, rows[:, 6], tp)))
    assert _same_bits(walk(rec=rec), ref)
    # the record's occ lane cleared on one occupied row, a member of its
    # neighbours' windows
    occupied = torch.nonzero(tf.occ)
    j = int(occupied[occupied.shape[0] // 2])
    bad = rec.clone()
    bad.view(torch.int32)[0, j, 3] = 0
    assert not _same_bits(walk(rec=bad), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_substep", "forces"])
@pytest.mark.parametrize("case", ["spawn", "inf", "frame10", "corrected"])
def test_kahan_ext_walks_the_frame_record_on_card(cuda_device, case, kernel):
    # the Kahan K2-ext and K3-ext over the whole grid walk the one-scene
    # frame record (built in the wrapper by the pass, or given): bit-equal
    # to the walk that reads occ, raw and pj, the reference, on config 3's
    # aliased spawn, with ±inf velocities, ten frames on and on a corrected
    # substep's frame; planted: a record whose occ lane is cleared on one
    # member leaves the reference's bits
    _holds_the_record_walk(case, kernel, SortedTuning(kahan=True),
                           cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_substep", "forces"])
@pytest.mark.parametrize("case", ["spawn", "inf", "frame10", "corrected"])
def test_facc0_ext_walks_the_frame_record_on_card(cuda_device, case, kernel):
    # the facc0 K2-ext and K3-ext over the whole grid walk the frame record
    # as the Kahan walks do, with the same checks and planted control
    _holds_the_record_walk(case, kernel, SortedTuning(fuse_acc=False),
                           cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("library", ["bf16", "kahan", "facc0"])
@pytest.mark.parametrize("case", ["spawn", "inf", "frame10"])
def test_bf16_walks_the_frame_record_on_card(cuda_device, case, library):
    # the bf16, the Kahan and the facc0 K2 without extensions over the
    # whole grid walk the frame record: on the golden 262k scene's aliased
    # spawn, with ±inf velocities and ten frames on, bit-equal to the walk
    # that reads occ, raw and pj, with the K2-ext walks' checks and planted
    # control
    from sphfluidsimulation_torch import GOLDEN_CONFIG
    tune = {"bf16": BF16, "kahan": SortedTuning(kahan=True),
            "facc0": SortedTuning(fuse_acc=False)}[library]
    _holds_the_record_walk(case, "fused_substep", tune, cuda_device,
                           GOLDEN_CONFIG)


# the frame record pass's edge densities: 0, ε, −1, NaN, ±inf
_EDGE_RHO = (0.0, 1e-6, -1.0, float("nan"), float("inf"), -float("inf"))


def _record_inputs(scenes, n, device, seed=0):
    """(frame with raw and occ, ρ, params) of ``scenes`` scenes of ``n``
    rows: random raw ids and occupancy, random ρ with the edge values in
    every scene, each scene's own k and ρ₀."""
    from sphfluidsimulation_torch.ops.frame import SortedFrame
    g = torch.Generator(device).manual_seed(seed)
    raw = torch.randint(-5, 1 << 20, (scenes, n), generator=g,
                        device=device, dtype=torch.int32)
    occ = torch.rand((scenes, n), generator=g, device=device) < 0.8
    rho = 3.0 * torch.rand((scenes, n), generator=g, device=device) - 0.5
    for sc in range(scenes):
        rho[sc, 5 * sc:5 * sc + len(_EDGE_RHO)] = torch.tensor(
            _EDGE_RHO, device=device)
    params = PhysParams(*(torch.full((scenes,), 0.5, device=device)
                             for _ in PhysParams._fields))
    params = params._replace(
        gas_constant=20.0 + torch.arange(scenes, device=device) * 3.5,
        rest_density=1.0 + torch.arange(scenes, device=device) * 0.125)
    frame = SortedFrame(*(None for _ in SortedFrame._fields))._replace(
        raw=raw, occ=occ)
    return frame, rho, params


@pytest.mark.cuda
@pytest.mark.parametrize("scenes", [1, 8])
def test_frame_record_pass_is_its_plain_version_on_card(cuda_device, scenes):
    # sph_frame_record bit-equal to frame_record_scenes_plain, N not a
    # multiple of the block, with ρ at 0, ε, −1, NaN and ±inf; one launch
    # counted; planted: a pass that leaves lane 3 at 0 differs
    n = 1000 + 37 * scenes
    frame, rho, params = _record_inputs(scenes, n, cuda_device)
    before = sk.launch_counts["frame_record"]
    rec = sk.frame_record_scenes(frame, rho, params)
    assert sk.launch_counts["frame_record"] == before + 1
    want = sk.frame_record_scenes_plain(frame, rho, params)
    assert rec.shape == (scenes, n, 4)
    assert _same_bits(rec, want)
    assert not bool(rec[:, :, 1][~(rho > 1e-6)].any())
    lib = _planted_library("fused_substep.cu", [(
        "__int_as_float(__ldg(occ + q) != 0 ? 1 : 0)", "0.f")],
        "frame_record_occ0")
    bad = torch.empty_like(rec)
    gas_k, rho0 = (x.contiguous() for x in (params.gas_constant,
                                            params.rest_density))
    assert lib.sph_frame_record(
        sk._ptr(rho), sk._ptr(frame.raw), sk._ptr(frame.occ),
        sk._ptr(gas_k), sk._ptr(rho0), sk._ptr(bad), n, scenes,
        torch.cuda.current_stream(cuda_device).cuda_stream) == 0
    torch.cuda.synchronize()
    assert _same_bits(bad[..., 0:3], want[..., 0:3])
    assert not _same_bits(bad, want)


@pytest.mark.cuda
def test_scene_walks_read_the_pass_record_as_the_torch_build_on_card(
        cuda_device):
    # config 5's batch: the scene-axis record the pass builds is the torch
    # build's, bit for bit, and K2-scenes and K3-scenes given either give
    # the same bits, those of the walk that reads occ, raw and pj
    frame, ps, vs, params, r, cap, _, _ = _config5_batch(cuda_device, False)
    rho = sk.density_scenes(frame, ps, params, r, cap)
    rows = sk.pack_rows_scenes(ps, vs, rho)
    rows = sk.fused_substep_scenes(frame, rows, params, r, cap)
    before = sk.launch_counts["frame_record"]
    rec = sk.frame_record_scenes(frame, rows[..., 6], params)
    assert sk.launch_counts["frame_record"] == before + 1
    torch_rec = sk.frame_record_scenes_plain(frame, rows[..., 6], params)
    assert _same_bits(rec, torch_rec)
    k2 = [sk.fused_substep_scenes_cuda(frame, rows, params, r, cap, rec=x)
          for x in (rec, torch_rec)]
    k2.append(sk.fused_substep_scenes_cuda(frame, rows, params, r, cap,
                                           reference=True))
    k3 = [sk.forces_scenes_cuda(frame, rows, params, r, cap, rec=x)
          for x in (rec, torch_rec)]
    k3.append(sk.forces_scenes_cuda(frame, rows, params, r, cap,
                                    reference=True))
    for outs in (k2, k3):
        assert _same_bits(outs[0], outs[1]) and _same_bits(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["kahan", "kahan-unfused",
                                  "kahan-corrected", "facc0",
                                  "facc0-unfused", "facc0-corrected",
                                  "bf16", "kahan-262k", "facc0-262k"])
def test_stepper_builds_the_frame_record_by_its_pass_on_card(
        cuda_device, mode, monkeypatch):
    # the host loop builds the record for a record walk, by the pass, in
    # place of pj: with extensions once a frame for the Kahan and the facc0
    # K2-ext and the unfused Kahan and facc0 K3-ext, once a substep (five
    # a frame) for the corrected Kahan and facc0 K3-ext; without them once
    # a frame for the bf16 K2 and for the Kahan and the facc0 K2 (the
    # golden 262k scene's faithful rollout)
    from sphfluidsimulation_torch import GOLDEN_CONFIG
    variant = mode.split("-")[0]
    if mode.endswith("262k"):
        cfg = GOLDEN_CONFIG
    elif variant == "bf16":
        cfg = SimConfig(**_GOLDENISH)
    else:
        cfg = SimConfig(**_GOLDENISH, xsph=XSPH, artificial_viscosity=ALPHA)
    tune = {"kahan": SortedTuning(kahan=True), "bf16": BF16,
            "facc0": SortedTuning(fuse_acc=False)}[variant]
    tune = tune._replace(fused=not mode.endswith("unfused"))
    faithful = not mode.endswith("corrected")
    made = {"pj": 0, "rec": 0}
    real_pj, real_rec = sk.pj_cols, sk.frame_record

    def pj(*a):
        made["pj"] += 1
        return real_pj(*a)

    def record(*a):
        made["rec"] += 1
        return real_rec(*a)
    monkeypatch.setattr(sk, "pj_cols", pj)
    monkeypatch.setattr(sk, "frame_record", record)
    frames = 2
    sk.reset_launch_counts()
    make_rollout(cfg, frames, faithful=faithful, tune=tune,
                 device=cuda_device, host_loop=True)(
        initial_state(cfg, cuda_device))
    counts = {k: v for k, v in sk.launch_counts.items() if v}
    tag = sk.variant_tag("forces.cu", tune)
    k1 = "density" + sk.variant_tag("density.cu", tune)
    want = {"kahan": {k1: 2, "frame_record": 2,
                      "fused_substep_ext" + tag: 10},
            "kahan-unfused": {k1: 2, "frame_record": 2, "forces" + tag: 10},
            "kahan-corrected": {k1: 12, "frame_record": 10,
                                "forces" + tag: 10},
            "facc0": {k1: 2, "frame_record": 2,
                      "fused_substep_ext" + tag: 10},
            "facc0-unfused": {k1: 2, "frame_record": 2, "forces" + tag: 10},
            "facc0-corrected": {k1: 12, "frame_record": 10,
                                "forces" + tag: 10},
            "bf16": {k1: 2, "frame_record": 2,
                     "fused_substep" + tag: 10},
            "kahan-262k": {k1: 2, "frame_record": 2,
                           "fused_substep" + tag: 10},
            "facc0-262k": {k1: 2, "frame_record": 2,
                           "fused_substep" + tag: 10}}[mode]
    assert counts == want
    assert made["rec"] == want["frame_record"]
    assert made["pj"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["faithful", "corrected", "kahan"])
def test_stepper_rounds_the_bf16_candidates_once_a_substep_on_card(
        cuda_device, mode, monkeypatch):
    # the host loop of the bf16 rollout with extensions runs the pass
    # before each of the five substeps, faithful (K2-ext) or corrected
    # (K3-ext); the Kahan rollout with extensions walks the frame record,
    # which the stepper builds once a frame
    cfg = SimConfig(**_GOLDENISH, xsph=XSPH, artificial_viscosity=ALPHA)
    tune = SortedTuning(kahan=True) if mode == "kahan" else BF16
    sk.reset_launch_counts()
    made, real = [], sk.frame_record

    def record(*a):
        made.append(1)
        return real(*a)
    monkeypatch.setattr(sk, "frame_record", record)
    make_rollout(cfg, 2, faithful=mode != "corrected", tune=tune,
                 device=cuda_device, host_loop=True)(
        initial_state(cfg, cuda_device))
    counts = {k: v for k, v in sk.launch_counts.items() if v}
    want = {"faithful": {"density": 2, "bf16_candidates": 10,
                         "fused_substep_ext+bf16": 10},
            "corrected": {"density": 12, "bf16_candidates": 10,
                          "forces+bf16": 10},
            "kahan": {"density+kahan": 2, "frame_record": 2,
                      "fused_substep_ext+kahan": 10}}[mode]
    assert counts == want
    assert len(made) == (2 if mode == "kahan" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("tune", [SortedTuning(), SortedTuning(kahan=True),
                                  SortedTuning(fuse_acc=False)],
                         ids=["default", "kahan", "facc0"])
def test_only_the_bf16_library_walks_the_candidate_copy_on_card(cuda_device,
                                                                tune):
    # the pass and the two walks of the copy refuse outside the bf16 library
    from sphfluidsimulation_torch.ops import cuda_build
    x = torch.zeros((4, 8), device=cuda_device)
    p, i = sk._ptr(x), (4, 3, 32)
    assert cuda_build.function("fused_substep.cu", "sph_bf16_candidates",
                               tune)(p, p, 4, None) != 0
    for src in ("fused_substep.cu", "forces.cu"):
        fn = cuda_build.function(src, f"sph_{src[:-3]}_cand", tune)
        assert fn(p, p, p, p, p, p, p, *i, None) != 0, src


# the batched steps BatchedScenes records, each on the scene axis: (options,
# extension coefficients, scene-axis launches a frame)
_EXT = dict(xsph=XSPH, artificial_viscosity=ALPHA)
BATCH_CASES = {
    "scene-axis": ({}, {}, dict(density_scenes=1, frame_record=1,
                                fused_substep_scenes=5)),
    "scene-axis-ext": ({}, _EXT, dict(density_scenes=1, frame_record=1,
                                      fused_substep_ext_scenes=5)),
    "corrected": (dict(faithful=False), {}, dict(density_scenes=6,
                                                 frame_record=5,
                                                 forces_scenes=5)),
    "corrected-ext": (dict(faithful=False), _EXT,
                      dict(density_scenes=6, frame_record=5,
                           forces_ext_scenes=5)),
    "compact": (dict(tune=COMPACT), {}, dict(compact_density_scenes=1,
                                             compact_substep_scenes=5)),
    "compact-corrected": (dict(faithful=False, tune=COMPACT), {},
                          dict(compact_density_scenes=6,
                               compact_forces_scenes=5)),
    "unfused": (dict(tune=SortedTuning(fused=False)), {},
                dict(density_scenes=1, frame_record=1, forces_scenes=5)),
    "kahan": (dict(tune=SortedTuning(kahan=True)), {},
              {"density_scenes+kahan": 1, "frame_record": 1,
               "fused_substep_scenes+kahan": 5}),
    "kahan-ext": (dict(tune=SortedTuning(kahan=True)), _EXT,
                  {"density_scenes+kahan": 1, "frame_record": 1,
                   "fused_substep_ext_scenes+kahan": 5}),
    "bf16-ext": (dict(tune=SortedTuning(bf16=True)), _EXT,
                 {"density_scenes": 1, "frame_record": 1,
                  "fused_substep_ext_scenes+bf16": 5}),
}


def _batches(case, device, **kw):
    from sphfluidsimulation_torch.parallel import BatchedScenes
    opts, ext, _ = BATCH_CASES[case]
    cfg = SimConfig(**_GOLDENISH, **ext)
    overrides = [{"rest_density": 1.0 + 0.25 * i, "seed": i}
                 for i in range(3)]
    return {mode: BatchedScenes(cfg, overrides, devices=device,
                                host_loop=mode == "host", **opts, **kw)
            for mode in ("host", "graph")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batched_scenes_graph_is_bit_equal_to_the_host_loop_on_card(
        cuda_device, case):
    # JAX's one program a frame: each frame of the batch one replay of the
    # recorded batched step, bit for bit the host loop's states and
    # metrics, through the same scene-axis launches and no solo one; every
    # scene bit-equal to its solo rollout
    bss = _batches(case, cuda_device)
    assert bss["host"].host_loop is True and bss["graph"].host_loop is False
    counts = {}
    for mode, bs in bss.items():
        bs.step()                 # the graph's first frame records it
        sk.reset_launch_counts()
        bs.step(3)
        torch.cuda.synchronize()
        counts[mode] = dict(sk.launch_counts)
    assert counts["graph"] == counts["host"]
    per_frame = BATCH_CASES[case][2]
    assert {k: v for k, v in counts["host"].items() if v} == {
        k: 3 * v for k, v in per_frame.items()}
    for a, b in zip((*bss["host"].states, *bss["host"].last_metrics),
                    (*bss["graph"].states, *bss["graph"].last_metrics)):
        assert a.shape == b.shape and _same_bits(a, b)
    opts = BATCH_CASES[case][0]
    for i, c in enumerate(bss["graph"].configs):
        solo, _ = make_rollout(c, 4, device=cuda_device, **opts)(
            initial_state(c, cuda_device))
        for a, b in zip(bss["graph"].states, solo):
            assert _same_bits(a[i], b)


@pytest.mark.cuda
def test_batched_states_and_params_set_between_replays_on_card(cuda_device):
    # states and params set between frames of the recorded batch are
    # copied into its carry: the next replays give the frames of the host
    # loop's batched step from them, bit for bit; a wrong shape raises
    from sphfluidsimulation_torch.parallel import make_batched_step
    bss = _batches("scene-axis", cuda_device)
    bs, other = bss["graph"], bss["host"]
    bs.step(2)
    other.step(1)
    states = other.states
    params = other.params._replace(viscosity=other.params.viscosity * 3)
    bs.states, bs.params = states, params
    want, step = states, make_batched_step(SimConfig(**_GOLDENISH))
    for _ in range(2):
        want, m = step(want, params)
        got = bs.step()
        for a, b in zip((*got, *bs.last_metrics), (*want, *m)):
            assert _same_bits(a, b)
    with pytest.raises(ValueError, match="pos"):
        bs.states = states._replace(pos=states.pos[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["host", "graph"])
def test_batched_frame_never_waits_for_the_card(cuda_device, mode):
    # the batched frame build, the scene-axis kernels, the per-scene
    # metrics and unsorts make no synchronising call, in either mode
    bs = _batches("scene-axis-ext", cuda_device)[mode]
    bs.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bs.step(2)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["corrected-ext", "compact",
                                  "compact-corrected", "unfused"])
def test_batched_routes_never_wait_for_the_card(cuda_device, case):
    # the host loop of the other routes' batched steps makes no
    # synchronising call either (the graph's capture would fail on one)
    bs = _batches(case, cuda_device)["host"]
    bs.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bs.step(2)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_failed_batched_capture_raises_on_card(cuda_device, monkeypatch):
    # no fallback: a batched frame that cannot be recorded (it reads a
    # value back) raises, counts nothing, leaves the caller's stream
    # current and steps nothing in its place
    bss = _batches("scene-axis", cuda_device)
    real = sk.density_scenes

    def reads_back(*args, **kw):
        rho = real(*args, **kw)
        float(rho.max())
        return rho

    monkeypatch.setattr(sk, "density_scenes", reads_back)
    stream = torch.cuda.current_stream(cuda_device)
    sk.reset_launch_counts()
    with pytest.raises(RuntimeError):
        bss["graph"].step()
    assert sk.launch_counts == dict.fromkeys(sk.launch_counts, 0)
    assert torch.cuda.current_stream(cuda_device) == stream
    assert bss["graph"].frame == 0
    monkeypatch.setattr(sk, "density_scenes", real)
    for bs in bss.values():
        bs.step(2)
    for a, b in zip(bss["host"].states, bss["graph"].states):
        assert _same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("faithful", [True, False])
def test_sites_tier_tracks_the_brute_oracle_on_card(cuda_device, faithful):
    cfg = SimConfig(**_CALM, xsph=XSPH, artificial_viscosity=ALPHA)
    s0 = initial_state(cfg, cuda_device)
    sk.reset_launch_counts()
    a, ma = make_rollout(cfg, 3, neighbor="sites", faithful=faithful,
                         device=cuda_device)(s0)
    assert not any(sk.launch_counts.values())
    b, mb = make_rollout(cfg, 3, neighbor="brute", faithful=faithful,
                         device=cuda_device)(s0)
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=1e-5)
    assert int(ma.exact_cert.sum()) == 0
    assert torch.equal(ma.overflow, mb.overflow)


@pytest.mark.cuda
def test_sites_banded_passes_bit_identical_on_card(cuda_device):
    # the z-banded grids hold the one-piece grid's sites, folded in the
    # same order: bit-identical on the card too; and the card within the
    # CPU's tolerances of the same passes on the CPU
    from sphfluidsimulation_torch.ops import sites
    cfg = SimConfig(particle_number=4096, bucket_resolution=17, preset=1)
    pos = initial_state(cfg, cuda_device).pos
    vel = 0.05 * torch.sin(37.0 * pos)
    p, r = PhysParams.from_config(cfg, cuda_device), cfg.bucket_resolution
    cid, ic, _ = sites.frame_binding(pos, r, 32)
    out = {}
    for nb in (1, 4):
        rho, cr = sites.density_sites(pos, cid, ic, p, r, 32, 32, z_bands=nb)
        f, _, cf = sites.fluid_forces_sites(pos, vel, rho, cid, ic, p, r,
                                            32, 32, z_bands=nb)
        out[nb] = (rho, f, cr, cf)
    for a, b in zip(out[1], out[4]):
        assert torch.equal(a, b)
    pc = PhysParams.from_config(cfg)
    cid_c, ic_c, _ = sites.frame_binding(pos.cpu(), r, 32)
    assert torch.equal(cid_c, cid.cpu()) and torch.equal(ic_c, ic.cpu())
    rho_c, _ = sites.density_sites(pos.cpu(), cid_c, ic_c, pc, r, 32, 32)
    torch.testing.assert_close(out[1][0].cpu(), rho_c, rtol=2e-5, atol=1e-6)


@pytest.mark.cuda
def test_sites_bound_holds_the_one_piece_pass_on_card(cuda_device):
    # the card takes 1M's passes in one piece, within sites.one_piece_bytes
    from sphfluidsimulation_torch.bench import scaled_config, site_bands
    from sphfluidsimulation_torch.ops import sites
    from sphfluidsimulation_torch.sim.stepper import make_frame_step
    cfg = scaled_config(1 << 20)
    assert site_bands(cfg, cuda_device) == 1
    st = initial_state(cfg, cuda_device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    make_frame_step(cfg, neighbor="sites", device=cuda_device)(st)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert peak <= sites.one_piece_bytes(cfg.bucket_resolution,
                                         cfg.n_particles, 32, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4])
def test_sites_slab_step_matches_single_device_on_card(cuda_device, d):
    from sphfluidsimulation_torch.parallel import (LocalRing, collect,
                                                   distribute,
                                                   make_slab_step)
    cfg = SimConfig(**dict(_CALM, gas_constant=1.0, site_capacity=24))
    gen = torch.Generator().manual_seed(d)
    s0 = initial_state(cfg, cuda_device)._replace(
        pos=(0.05 + 0.9 * torch.rand(cfg.n_particles, 3,
                                     generator=gen)).to(cuda_device),
        vel=(0.02 * torch.randn(cfg.n_particles, 3,
                                generator=gen)).to(cuda_device))
    step, spec = make_slab_step(cfg, LocalRing(d), device=cuda_device)
    sst, m = step(distribute(s0, cfg, spec),
                  PhysParams.from_config(cfg, cuda_device))
    out, lost = collect(sst, cfg.n_particles)
    from sphfluidsimulation_torch.sim.stepper import make_frame_step
    ref, _ = make_frame_step(cfg, neighbor="sites", device=cuda_device)(s0)
    assert lost == 0 and int(m.exact_cert) == 0
    torch.testing.assert_close(out.pos, ref.pos, rtol=0, atol=2e-6)
    torch.testing.assert_close(out.vel, ref.vel, rtol=0, atol=2e-4)


@pytest.mark.cuda
def test_domain_step_equals_the_gather_step_on_card(cuda_device):
    from sphfluidsimulation_torch.parallel import (LocalRing,
                                                   make_sharded_frame_step)
    from sphfluidsimulation_torch.sim.stepper import make_frame_step
    cfg = SimConfig(**_GOLDENISH)
    s0 = initial_state(cfg, cuda_device)
    out, m = make_sharded_frame_step(cfg, LocalRing(4), device=cuda_device)(
        s0, PhysParams.from_config(cfg, cuda_device))
    ref, mr = make_frame_step(cfg, neighbor="gather", device=cuda_device)(s0)
    torch.testing.assert_close(out.pos, ref.pos, rtol=0, atol=2e-6,
                               equal_nan=True)
    assert int(m.overflow) == int(mr.overflow)


@pytest.mark.cuda
def test_sweep_and_shards_cli_on_card(cuda_device, tmp_path, capsys):
    from sphfluidsimulation_torch import cli
    argv = ["--particles", "1024", "--bucket-resolution", "11"]
    sk.reset_launch_counts()
    assert cli.main(["sweep", *argv, "--scenes", "2", "--frames", "2",
                     "--export-dir", str(tmp_path)]) == 0
    # the scene axis: 1 K1 + 1 frame record + 5 K2 a frame over both
    # scenes
    assert sk.launch_counts == dict(dict.fromkeys(sk.launch_counts, 0),
                                    density_scenes=2, frame_record=2,
                                    fused_substep_scenes=10)
    assert len(list(tmp_path.glob("scene_*.png"))) == 2
    assert cli.main(["run", *argv, "--shards", "2", "--row-slack", "4",
                     "--frames", "1"]) == 0
    assert '"lost": 0' in capsys.readouterr().out


@pytest.mark.cuda
def test_entry_runs_a_frame_on_card(cuda_device):
    from sphfluidsimulation_torch.entry import dryrun_multichip, entry
    step, (state, phys) = entry()
    assert state.pos.device.type == "cuda"
    sk.reset_launch_counts()
    state, m = step(state, phys)
    assert sk.launch_counts == dict(dict.fromkeys(sk.launch_counts, 0),
                                    density=1, fused_substep=5)
    assert bool(torch.isfinite(state.pos).all())
    dryrun_multichip(8)


# ------------------------------------------------------------- probes --
# The Hopper micro-benchmarks of the JAX package's Mosaic probes
# (sphfluidsimulation_torch/probes): each kernel against its plain version
# at a small size, each launch counted.

def _probe_launches(name, fn):
    from sphfluidsimulation_torch.probes import common as pcommon
    before = pcommon.launch_counts.get(name, 0)
    out = fn()
    assert pcommon.launch_counts.get(name, 0) == before + 1, name
    return out


@pytest.mark.cuda
def test_probe_live_kernel_matches_plain_on_card(cuda_device):
    from sphfluidsimulation_torch.probes import live
    x = torch.rand(live.SHAPE, device=cuda_device)
    c = torch.tensor([live.clock_constant()], device=cuda_device)
    got = _probe_launches("live", lambda: live.live(x, c))
    assert torch.equal(got, live.live_plain(x, c))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", range(10))
def test_probe_intops_stage_equals_the_truth_on_card(cuda_device, stage):
    from sphfluidsimulation_torch.probes import intops
    st = intops.stages()[stage]
    a, b = intops.inputs_on(st, cuda_device)
    got = _probe_launches(st.kname, lambda: intops.stage_run(st, a, b))
    assert np.array_equal(got.cpu().numpy(), st.truth)
    if st.stage == 3:       # the planted control: a shift of 9
        bad = intops.stage_cuda(3, a, b, shift=9)
        assert not np.array_equal(bad.cpu().numpy(), st.truth)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["A", "B", "C", "D", "E"])
def test_probe_loopstruct_synth_kernel_on_card(cuda_device, variant):
    from sphfluidsimulation_torch.probes import loopstruct as ls
    inp = ls.to_device(ls.synth_inputs(np.random.RandomState(0), 2),
                       cuda_device)
    for data in (inp, ls.gate_open(inp)):
        got = _probe_launches(f"loopstruct_{variant}",
                              lambda: ls.synth(variant, data))
        assert ls.synth_rule(variant, ls.synth_plain(variant, data), got,
                             data)
    if variant == "A":      # the planted control: a line dropped
        opened = ls.gate_open(inp)
        bad = ls.synth_cuda("A", ls.drop_line(opened))
        assert not ls.synth_rule("A", ls.synth_plain("A", opened), bad,
                                 opened)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [4, 32])
def test_probe_loopstruct_frame_kernels_on_card(cuda_device, cap):
    from sphfluidsimulation_torch.probes import loopstruct as ls
    cfg = SimConfig(**_GOLDENISH, voxel_capacity=cap)
    st, _ = make_rollout(cfg, 3, device=cuda_device)(
        initial_state(cfg, cuda_device))
    fin = ls.frame_inputs(cfg, st)
    rg = _probe_launches("loopstruct_ranges", lambda: ls.ranges_cuda(fin))
    want_rg = ls.ranges_plain(fin)
    assert torch.equal(rg[1], want_rg[1]) and torch.equal(rg[0], want_rg[0])
    ref = sk.forces_reference(fin.frame, fin.rows, fin.phys, fin.r, cap)
    k3 = sk.forces_cuda(fin.frame, fin.rows, fin.phys, fin.r, cap, False,
                        fin.pj, fin.scal)
    for v in ("A_f", "D_f", "E_f"):
        got = _probe_launches(f"loopstruct_{v}",
                              lambda: ls.frame_cuda(v, fin, rg))
        acc = ls.frame_hold(fin, got, ref)
        assert acc.ok, (v, acc)
        # the same terms in the same order as K3
        assert torch.equal(got.view(torch.int32), k3.view(torch.int32)), v
    total, members = ls.walk_sum_plain(fin)
    got = _probe_launches("loopstruct_B_f", lambda: ls.frame_cuda("B_f", fin))
    assert ls.walk_sum_rule(got, total, members)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,prec", [
    ("D", 1), ("G", 1), ("G", 3), ("A", 1), ("A", 3), ("M", 1), ("M", 3),
    ("D128", 1), ("A128", 1), ("A128", 3), ("M128", 1), ("M128", 3)])
def test_probe_mxu_instance_on_card(cuda_device, variant, prec):
    from sphfluidsimulation_torch.probes import mxu
    inp = mxu.script_inputs(cuda_device, 2048)[mxu.rows_of(variant)]
    got = _probe_launches(mxu.kernel_name(variant, prec),
                          lambda: mxu.mxu(variant, prec, inp))
    rule = mxu.mxu_rule(variant, prec, inp)
    hold = mxu.mxu_hold(variant, prec, inp, got, rule)
    assert hold.ok, hold
    # the planted controls: wrong kernels, each of which must fail the rule
    for fault in mxu.CONTROLS.get((variant, prec), ()):
        bad = mxu.mxu_cuda(variant, prec, inp, fault)
        assert not mxu.mxu_hold(variant, prec, inp, bad, rule).ok, fault


@pytest.mark.cuda
def test_probe_v7prims_kernel_on_card(cuda_device):
    from sphfluidsimulation_torch.probes import v7prims as v7
    x = torch.from_numpy(v7.x_input()).to(cuda_device)
    off = torch.tensor([v7.OFF], dtype=torch.int32, device=cuda_device)
    for name, tab in v7.tables().items():
        table = torch.from_numpy(tab).to(cuda_device)
        got = _probe_launches("v7prims", lambda: v7.prims(off, x, table))
        assert torch.equal(got, v7.prims_plain(off, x, table))
        if name == "B":
            assert np.array_equal(got.cpu().numpy(), v7.expected_b(x.cpu()
                                                                   .numpy()))
    # an offset the bulk copy cannot take answers NaN
    bad = v7.prims_cuda(off + 2, x, table)
    assert torch.isnan(bad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_probe_scalar_kernel_on_card(cuda_device, variant):
    from sphfluidsimulation_torch.probes import scalar
    slc, spans, x = (torch.from_numpy(a).to(cuda_device)
                     for a in scalar.synth_inputs(2))
    got = _probe_launches(f"scalar_S{variant}",
                          lambda: scalar.scalar(variant, slc, spans, x))
    assert scalar.ulps(scalar.scalar_plain(variant, slc, spans, x),
                       got) <= 1
