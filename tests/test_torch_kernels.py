"""The kernel modules of the torch port against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version: it is held
here against JAX ``pallas_sph.density_pass`` / ``fused_substep`` (Pallas in
interpret mode, as the JAX tests run it) and against the brute oracle. The
CUDA kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import ctypes

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.models.presets import init_positions as jinit
from sphfluidsimulation_tpu.ops import brute, pallas_sph
from sphfluidsimulation_tpu.ops.grid import build_bucket
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_tpu.sim.stepper import integrate_substep as jint
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import sph_kernels as sk
from sphfluidsimulation_torch.ops.frame import build_frame
from sphfluidsimulation_torch.params import PhysParams
from sphfluidsimulation_torch.sim.stepper import initial_state, make_rollout

# one intra-op thread: the suite runs in several worker processes on
# shared cores, where each worker's spinning OpenMP threads slowed the
# port's many small CPU ops about fivefold
torch.set_num_threads(1)

# tests/test_pallas.py:18-21
_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
_GOLDENISH = dict(particle_number=1024, bucket_resolution=11)
CONFIGS = {"calm": _CALM, "goldenish": _GOLDENISH}
CAP = 32


def _setup(name):
    kw = CONFIGS[name]
    jc, tc = JConfig(**kw), SimConfig(**kw)
    return (jc, JPhys.from_config(jc), PhysParams.from_config(tc),
            np.array(jinit(jc)), jc.bucket_resolution, jc.n_particles)


def _jax_density(pos, r, n, jp):
    jf, (ps,) = pallas_sph.build_frame(jnp.asarray(pos), r, CAP,
                                       extras=(jnp.asarray(pos),))
    rho, _ = pallas_sph.density_pass(jf, ps, jp, r, n)
    return np.asarray(rho)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_density_matches_jax_density_pass(name):
    _, jp, tp, pos, r, n = _setup(name)
    want = _jax_density(pos, r, n, jp)
    tf, (ps,) = build_frame(torch.from_numpy(pos), r, CAP,
                            extras=(torch.from_numpy(pos),))
    got = sk.density_pass(tf, ps, tp, r, CAP).numpy()
    # same candidate set, sums in another order: rtol 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_fused_substep_matches_jax_fused_substep():
    _, jp, tp, pos, r, n = _setup("calm")
    rng = np.random.default_rng(0)
    vel = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    rho = _jax_density(pos, r, n, jp)            # sorted order
    jf, (ps, vs) = pallas_sph.build_frame(
        jnp.asarray(pos), r, CAP, extras=(jnp.asarray(pos), jnp.asarray(vel)))
    tune = pallas_sph.default_tuning()
    rows = pallas_sph.pack_rows(ps, vs, jnp.asarray(rho), None, n, tune)
    out, cert = pallas_sph.fused_substep(jf, rows, jp, r, n, tune=tune)
    assert int(cert) == 0
    jpos, jvel, jrho, jnan = (np.asarray(a)
                              for a in pallas_sph.unpack_rows(out, n))

    tf, (tps, tvs) = build_frame(torch.from_numpy(pos), r, CAP,
                                 extras=(torch.from_numpy(pos),
                                         torch.from_numpy(vel)))
    trows = sk.pack_rows(tps, tvs, torch.from_numpy(rho))
    tpos, tvel, trho, tnan = sk.unpack_rows(
        sk.fused_substep(tf, trows, tp, r, CAP))
    np.testing.assert_allclose(tpos.numpy(), jpos, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tvel.numpy(), jvel, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(trho.numpy(), jrho)
    np.testing.assert_array_equal(tnan.numpy(), jnan)


def test_inf_velocities_match_brute():
    """±inf velocities on the canonical spawn (out-of-cube aliasing
    included): the pair forces reproduce the brute oracle's NaN/±inf
    pattern element for element, the self pair is skipped, and the whole
    substep traps the same particles as brute forces + JAX
    ``integrate_substep`` (tests/test_pallas.py:514-560)."""
    jc, jp, tp, pos, r, n = _setup("goldenish")
    rng = np.random.default_rng(0)
    vel = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    vel[::37, 0] = np.inf
    vel[5::53, 1] = -np.inf

    bucket, _ = build_bucket(jnp.asarray(pos), r, CAP)
    rho = brute.density_bruteforce(jnp.asarray(pos), bucket.cell_id,
                                   bucket.in_table, jp, r)
    f_b = brute.fluid_forces_bruteforce(jnp.asarray(pos), jnp.asarray(vel),
                                        rho, bucket.cell_id, bucket.in_table,
                                        jp, r)
    jpos, jvel, jnan = (np.asarray(a) for a in
                        jint(jnp.asarray(pos), jnp.asarray(vel), f_b, jp))
    f_b = np.asarray(f_b)

    t = torch.from_numpy
    tf, (ps, vs, rs) = build_frame(t(pos), r, CAP,
                                   extras=(t(pos), t(vel),
                                           t(np.asarray(rho))))
    order = tf.order.long()

    def unsort(a):
        out = torch.empty_like(a)
        out[order] = a
        return out.numpy()

    f_p, dv = sk.forces_pass(tf, sk.pack_rows(ps, vs, rs), tp, r, CAP)
    assert dv is None
    f_p = unsort(f_p)
    np.testing.assert_array_equal(np.isnan(f_p), np.isnan(f_b))
    np.testing.assert_array_equal(np.isposinf(f_p), np.isposinf(f_b))
    np.testing.assert_array_equal(np.isneginf(f_p), np.isneginf(f_b))
    assert np.isinf(f_b).any() or np.isnan(f_b).any()  # scenario is violent
    fin = np.isfinite(f_b)
    scale = np.abs(f_b[fin]).max()
    np.testing.assert_allclose(f_p[fin] / scale, f_b[fin] / scale,
                               rtol=0, atol=1e-5)

    out = sk.fused_substep(tf, sk.pack_rows(ps, vs, rs), tp, r, CAP)
    tpos, tvel, _, tnan = (unsort(a) for a in sk.unpack_rows(out))
    np.testing.assert_array_equal(tnan.astype(bool), jnan)
    assert jnan.any()
    np.testing.assert_array_equal(np.isnan(tvel), np.isnan(jvel))
    ok = np.isfinite(jvel).all(1)
    vscale = np.abs(jvel[ok]).max()
    np.testing.assert_allclose(tvel[ok] / vscale, jvel[ok] / vscale,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tpos[ok], jpos[ok], rtol=0, atol=1e-5)


def test_pack_rows_matches_jax_layout():
    rng = np.random.default_rng(1)
    n = 300
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rho = rng.uniform(0, 3, n).astype(np.float32)
    want = np.asarray(pallas_sph.pack_rows(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rho), None, n,
        pallas_sph.default_tuning())).reshape(-1, sk.N_FIELDS)[:n]
    rows = sk.pack_rows(torch.from_numpy(pos), torch.from_numpy(vel),
                        torch.from_numpy(rho))
    np.testing.assert_array_equal(rows.numpy(), want)
    p, v, d, c = sk.unpack_rows(rows)
    np.testing.assert_array_equal(p.numpy(), pos)
    np.testing.assert_array_equal(v.numpy(), vel)
    np.testing.assert_array_equal(d.numpy(), rho)
    assert c.dtype == torch.int32 and not c.any()


def test_cpu_tensors_route_to_plain_versions():
    cfg = SimConfig(**_CALM)
    st = initial_state(cfg, "cpu")
    tp = PhysParams.from_config(cfg)
    r = cfg.bucket_resolution
    tf, (ps, vs) = build_frame(st.pos, r, CAP, extras=(st.pos, st.vel))
    sk.reset_launch_counts()
    rho = sk.density_pass(tf, ps, tp, r, CAP)
    torch.testing.assert_close(rho, sk.density_plain(tf, ps, tp, r, CAP),
                               rtol=0, atol=0)
    rows = sk.pack_rows(ps, vs, rho)
    torch.testing.assert_close(
        sk.fused_substep(tf, rows, tp, r, CAP),
        sk.fused_substep_plain(tf, rows, tp, r, CAP), rtol=0, atol=0)
    f, dv = sk.forces_pass(tf, rows, tp, r, CAP, 0.3, 0.4)
    sums = sk.forces_plain(tf, rows, tp, r, CAP, ext=True)
    assert torch.equal(f, sk.fold_forces(sums, rho, tp, 0.3, 0.4)[0])
    assert sk.launch_counts == dict.fromkeys(sk.launch_counts, 0)


def test_cuda_build_flags_and_cache_key():
    from sphfluidsimulation_torch.ops import cuda_build
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast-math" not in flags and "fast_math" not in flags
    paths = [cuda_build.library_path(s) for s in cuda_build.KERNELS]
    assert len(set(paths)) == len(paths) == 4     # one library per source
    for s, path in zip(cuda_build.KERNELS, paths):
        assert path.parent == cuda_build.BUILD_DIR
        assert path == cuda_build.library_path(s)  # keyed by content only
    for s in (*cuda_build.HEADERS, *cuda_build.KERNELS):
        assert (cuda_build.CSRC / s).is_file()
    # the K3 and K2 bindings take pj after the rows, the band (zbase,
    # z_span) after the capacity and the extension switch before the
    # stream; K1 takes the band too
    sigs = {n: a for v in cuda_build.KERNELS.values() for n, a in v}
    assert len(sigs["sph_forces"]) == len(sigs["sph_fused_substep"]) == 14
    assert len(sigs["sph_density"]) == 12


def test_lane_group_bindings_and_the_library_of_every_shape():
    # K2's launch with a given shape (lanes a row, slots a lane a step)
    # takes it after the extension switch; the library of every shape (the
    # measurement's, on no path) is a library of its own, tagged, and so is
    # not the default
    from sphfluidsimulation_torch.ops import cuda_build
    sigs = {n: a for v in cuda_build.KERNELS.values() for n, a in v}
    assert sigs["sph_fused_substep_lanes"] == \
        sigs["sph_fused_substep"][:13] + (ctypes.c_int,) * 2 + (
            ctypes.c_void_p,)
    assert sigs["sph_fused_substep_band_walk"] == (ctypes.c_int,) * 2
    sweep = cuda_build.library_path("fused_substep.cu",
                                    (cuda_build.LANE_SWEEP,))
    assert sweep != cuda_build.library_path("fused_substep.cu")
    assert "_lanesweep_" in sweep.name
    assert "SPH_LANE_SWEEP" in (cuda_build.CSRC
                                / "fused_substep.cu").read_text()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_substep_accuracy_rule_accepts_plain_and_rejects_no_viscosity(name):
    # the rule held by chip_smoke.py against the CUDA kernel: it passes the
    # plain float32 version, and fails a substep that drops viscosity
    cfg = SimConfig(**CONFIGS[name])
    st, _ = make_rollout(cfg, 2, device="cpu")(initial_state(cfg, "cpu"))
    tp = PhysParams.from_config(cfg)
    r = cfg.bucket_resolution
    tf, (ps, vs) = build_frame(st.pos, r, CAP, extras=(st.pos, st.vel))
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    good = sk.substep_accuracy(
        tf, rows, sk.fused_substep_plain(tf, rows, tp, r, CAP), tp, r, CAP)
    assert good.ok and good.n_over == 0
    no_visc = tp._replace(viscosity=torch.zeros_like(tp.viscosity))
    bad = sk.substep_accuracy(
        tf, rows, sk.fused_substep_plain(tf, rows, no_visc, r, CAP), tp, r,
        CAP)
    assert not bad.ok and bad.n_over > 0
    assert bad.roundings > 100 * sk.SUBSTEP_ROUNDINGS
