"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; on a CPU-only host they skip. They
import no JAX (the machine with the card has none), so run them without the
JAX test conftest, from the root of a checkout:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import sph_kernels as sk
from sphfluidsimulation_torch.ops.frame import build_frame
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels are built with "
                    "nvcc and run only on the card")
    return torch.device("cuda")


def _card_inputs(name, device, frames=0):
    cfg = SimConfig(**CONFIGS[name])
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


@pytest.mark.cuda
def test_substep_rule_rejects_kernel_without_viscosity(cuda_device):
    tf, ps, vs, tp, r = _card_inputs("tiny", cuda_device, frames=2)
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    no_visc = tp._replace(viscosity=torch.zeros_like(tp.viscosity))
    bad = sk.fused_substep_cuda(tf, rows, no_visc, r, CAP)
    assert not sk.substep_accuracy(tf, rows, bad, tp, r, CAP).ok


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_layout(cuda_device):
    tf, ps, vs, tp, r = _card_inputs("calm", cuda_device)
    rows = sk.pack_rows(ps, vs, sk.density_cuda(tf, ps, tp, r, CAP))
    with pytest.raises(ValueError):
        sk.fused_substep(tf, rows[:, :7], tp, r, CAP)
    with pytest.raises(ValueError):
        sk.density_pass(tf, ps.double(), tp, r, CAP)


@pytest.mark.cuda
def test_rollout_on_card_tracks_cpu(cuda_device):
    # calm physics: the card's kernels and the CPU plain versions walk the
    # same candidates; rounding stays below the oracle-tracking bound of
    # tests/test_pallas.py::test_calm_rollout_tracks_oracle_with_zero_cert
    cfg = SimConfig(**_CALM)
    sk.reset_launch_counts()
    gpu, m = make_rollout(cfg, 5, device=cuda_device)(
        initial_state(cfg, cuda_device))
    assert sk.launch_counts == {"density": 5, "fused_substep": 25}
    cpu, mc = make_rollout(cfg, 5)(initial_state(cfg))
    torch.testing.assert_close(gpu.pos.cpu(), cpu.pos, rtol=0, atol=5e-4)
    assert torch.equal(m.overflow.cpu(), mc.overflow)
    assert int(m.exact_cert.sum()) == 0


@pytest.mark.cuda
def test_rollout_never_waits_for_the_card(cuda_device):
    # the frame loop keeps metrics on the device: no .item(), .cpu() or
    # data-dependent shapes; torch raises on any synchronising call
    cfg = SimConfig(**CONFIGS["tiny"])
    state = initial_state(cfg, cuda_device)
    roll = make_rollout(cfg, 3, device=cuda_device)
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
    scene = Scene(SimConfig(**_CALM), device=cuda_device)
    st = scene.step(2)
    assert st.pos.is_cuda and scene.frame == 2
    assert bool(torch.isfinite(st.pos).all())
    out = run_bench(4096, frames=2, warmup_frames=1)
    assert out["value"] > 0 and out["exact_cert_total"] == 0
    assert out["device_name"] == torch.cuda.get_device_name(0)
