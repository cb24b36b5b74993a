"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; on a CPU-only host they skip. They
import no JAX (the machine with the card has none), so run them without the
JAX test conftest, from the root of a checkout:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

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
@pytest.mark.parametrize("faithful", [True, False])
def test_rollout_never_waits_for_the_card(cuda_device, faithful):
    # the frame loop keeps metrics on the device: no .item(), .cpu() or
    # data-dependent shapes; torch raises on any synchronising call. The
    # corrected mode with both extensions too: its per-substep frame build,
    # K3 and host integration need no sync either
    cfg = SimConfig(**CONFIGS["tiny"])
    if not faithful:
        cfg = cfg.replace(xsph=XSPH, artificial_viscosity=ALPHA)
    state = initial_state(cfg, cuda_device)
    roll = make_rollout(cfg, 3, faithful=faithful, device=cuda_device)
    roll(state)                                # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        final, m = roll(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert final.pos.is_cuda and m.exact_cert.is_cuda


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
    assert out["pallas_tuning"] == {"compact": False}
    sk.reset_launch_counts()
    out = run_bench(4096, frames=2, warmup_frames=1, tune=COMPACT)
    assert out["pallas_tuning"] == {"compact": True} and out["value"] > 0
    assert sk.launch_counts["compact_substep"] == 3 * 5
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
