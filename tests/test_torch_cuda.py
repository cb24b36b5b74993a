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
small scenes, each scene bit-equal to its solo launch; the batch's graph
against its host loop on every route), the sites tier, its slab step, the
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
    # one K1 and five K2 a frame over the three scenes
    k2 = "fused_substep_ext_scenes" if ext else "fused_substep_scenes"
    assert sk.launch_counts == dict(dict.fromkeys(sk.launch_counts, 0),
                                    density_scenes=2, **{k2: 10})
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


# the batched steps BatchedScenes records, each on the scene axis: (options,
# extension coefficients, scene-axis launches a frame)
_EXT = dict(xsph=XSPH, artificial_viscosity=ALPHA)
BATCH_CASES = {
    "scene-axis": ({}, {}, dict(density_scenes=1, fused_substep_scenes=5)),
    "scene-axis-ext": ({}, _EXT, dict(density_scenes=1,
                                      fused_substep_ext_scenes=5)),
    "corrected": (dict(faithful=False), {}, dict(density_scenes=6,
                                                 forces_scenes=5)),
    "corrected-ext": (dict(faithful=False), _EXT,
                      dict(density_scenes=6, forces_ext_scenes=5)),
    "compact": (dict(tune=COMPACT), {}, dict(compact_density_scenes=1,
                                             compact_substep_scenes=5)),
    "compact-corrected": (dict(faithful=False, tune=COMPACT), {},
                          dict(compact_density_scenes=6,
                               compact_forces_scenes=5)),
    "unfused": (dict(tune=SortedTuning(fused=False)), {},
                dict(density_scenes=1, forces_scenes=5)),
    "kahan": (dict(tune=SortedTuning(kahan=True)), {},
              {"density_scenes+kahan": 1, "fused_substep_scenes+kahan": 5}),
    "bf16-ext": (dict(tune=SortedTuning(bf16=True)), _EXT,
                 {"density_scenes": 1, "fused_substep_ext_scenes+bf16": 5}),
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
    # the scene axis: 1 K1 + 5 K2 a frame over both scenes
    assert sk.launch_counts == dict(dict.fromkeys(sk.launch_counts, 0),
                                    density_scenes=2,
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
