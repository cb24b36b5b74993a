"""K3 (the unfused force pass) and the extension sums of the torch port
against the JAX package.

On the CPU ``forces_pass`` runs K3's plain version and folds its sums: it is
held here against JAX ``pallas_sph.forces_pallas`` (Pallas in interpret
mode, as the JAX tests run it). The CUDA kernel itself is held against the
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.models.presets import init_positions as jinit
from sphfluidsimulation_tpu.ops import pallas_sph
from sphfluidsimulation_tpu.params import PhysParams as JPhys
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
CAP = 32
XSPH, ALPHA = 0.3, 0.4


def _inputs(kw, seed=0):
    """Both packages' frames over the spawn positions, with random
    velocities and the frame-start density in their (equal, see
    tests/test_torch_frame.py) sorted order."""
    jc, tc = JConfig(**kw), SimConfig(**kw)
    jp, tp = JPhys.from_config(jc), PhysParams.from_config(tc)
    r, n = jc.bucket_resolution, jc.n_particles
    pos = np.array(jinit(jc))
    vel = np.random.default_rng(seed).normal(0, 0.2, (n, 3)).astype(
        np.float32)
    jf, (ps, vs) = pallas_sph.build_frame(
        jnp.asarray(pos), r, CAP, extras=(jnp.asarray(pos), jnp.asarray(vel)))
    tf, (tps, tvs) = build_frame(torch.from_numpy(pos), r, CAP,
                                 extras=(torch.from_numpy(pos),
                                         torch.from_numpy(vel)))
    rho = sk.density_plain(tf, tps, tp, r, CAP).numpy()
    return jp, tp, r, n, jf, ps, vs, rho, tf, tps, tvs


def _scaled_close(got, want, atol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


def test_forces_match_jax_forces_pallas_with_zero_density_candidates():
    # ρ = 0 planted on every 17th particle: the ρⱼ guard drops those j from
    # the pressure and viscosity sums only; the XSPH and artificial
    # viscosity sums keep them (pallas_sph.py:1207-1211, 1259-1279).
    # Tolerance: f and dv scaled by their max |·| within 1e-6, the bound of
    # tests/test_pallas.py:80-82 (same candidates, another summation order)
    jp, tp, r, n, jf, ps, vs, rho, tf, tps, tvs = _inputs(_CALM)
    rho[::17] = 0.0
    f, dv, cert = pallas_sph.forces_pallas(jf, ps, vs, jnp.asarray(rho), jp,
                                           r, n, xsph=XSPH, alpha_visc=ALPHA)
    assert int(cert) == 0
    rows = sk.pack_rows(tps, tvs, torch.from_numpy(rho))
    tf_, tdv = sk.forces_pass(tf, rows, tp, r, CAP, XSPH, ALPHA)
    _scaled_close(tf_.numpy(), np.asarray(f), 1e-6)
    _scaled_close(tdv.numpy(), np.asarray(dv), 1e-6)


def test_zero_density_candidates_keep_their_extension_terms():
    # moving the ρ = 0 particles changes their neighbours' XSPH and
    # artificial-viscosity sums, but not their pressure and viscosity sums
    cfg = SimConfig(**_CALM)
    tp = PhysParams.from_config(cfg)
    r = cfg.bucket_resolution
    st = initial_state(cfg, "cpu")
    tf, (ps,) = build_frame(st.pos, r, CAP, extras=(st.pos,))
    rho = sk.density_plain(tf, ps, tp, r, CAP)
    planted = torch.zeros_like(rho, dtype=torch.bool)
    planted[::17] = True
    rho = torch.where(planted, 0.0, rho)
    gen = torch.Generator().manual_seed(0)
    vel = 0.2 * torch.randn(ps.shape, generator=gen)
    moved = torch.where(planted[:, None], vel + 0.5, vel)
    a = sk.forces_plain(tf, sk.pack_rows(ps, vel, rho), tp, r, CAP, ext=True)
    b = sk.forces_plain(tf, sk.pack_rows(ps, moved, rho), tp, r, CAP,
                        ext=True)
    # the default (fuse_acc) layout: pressure and viscosity in lanes 0-2,
    # the extension sums in lanes 3-8 (pallas_sph.py:1740-1748)
    keep = ~planted                  # a planted i's own viscosity sum moves
    torch.testing.assert_close(a[keep, :3], b[keep, :3], rtol=0, atol=0)
    changed = (a[keep, 3:9] != b[keep, 3:9]).any(1)
    assert int(changed.sum()) > 100


@pytest.mark.parametrize("xsph,alpha", [(XSPH, 0.0), (0.0, ALPHA),
                                        (XSPH, ALPHA)])
def test_inf_velocities_with_extensions_match_forces_pallas(xsph, alpha):
    """±inf velocities with the extension sums on. The port's sorted tier
    follows the JAX pallas kernel, which skips the self pair in every force
    sum, extensions included. The JAX brute extension oracles keep the self
    pair (stepper.py:78-82), where an inf velocity gives inf − inf = NaN,
    so this pattern is held against ``forces_pallas``, not brute; on finite
    inputs the two agree (tests/test_torch_extensions.py). With one
    coefficient 0, that term's non-finite sum must not reach the result:
    ``forces_pallas`` returns no dv for xsph = 0 and adds no artificial
    viscosity for alpha_visc = 0 (0·inf would be NaN)."""
    jp, tp, r, n, jf, ps, vs, rho, tf, tps, tvs = _inputs(_GOLDENISH)
    vel = np.array(vs)
    vel[::37, 0] = np.inf
    vel[5::53, 1] = -np.inf
    f, dv, cert = pallas_sph.forces_pallas(jf, ps, jnp.asarray(vel),
                                           jnp.asarray(rho), jp, r, n,
                                           xsph=xsph, alpha_visc=alpha)
    assert int(cert) == 0
    rows = sk.pack_rows(tps, torch.from_numpy(vel), torch.from_numpy(rho))
    tf_, tdv = sk.forces_pass(tf, rows, tp, r, CAP, xsph, alpha)
    assert (tdv is None) == (dv is None) == (xsph == 0.0)
    got = tf_.numpy() if tdv is None else torch.cat([tf_, tdv], 1).numpy()
    want = np.asarray(f) if dv is None else np.concatenate(
        [np.asarray(f), np.asarray(dv)], 1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert not np.isfinite(want).all()                # the scenario bites
    fin = np.isfinite(want)
    _scaled_close(got[fin], want[fin], 1e-5)


@pytest.mark.parametrize("name", ["calm", "goldenish"])
def test_forces_accuracy_rule_accepts_plain_and_rejects_no_xsph(name):
    # the rule chip_smoke.py holds K3 to: it passes the plain float32
    # version and fails the same sums folded with the XSPH coefficient 0.
    # At frame 0 every velocity is 0, so the state is taken after 2 frames
    kw = dict(_CALM if name == "calm" else _GOLDENISH, xsph=XSPH,
              artificial_viscosity=ALPHA)
    cfg = SimConfig(**kw)
    st, _ = make_rollout(cfg, 2, device="cpu")(initial_state(cfg, "cpu"))
    tp = PhysParams.from_config(cfg)
    r = cfg.bucket_resolution
    tf, (ps, vs) = build_frame(st.pos, r, CAP, extras=(st.pos, st.vel))
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    sums = sk.forces_plain(tf, rows, tp, r, CAP, ext=True)
    f, dv = sk.fold_forces(sums, rows[:, 6], tp, XSPH, ALPHA)
    good = sk.forces_accuracy(tf, rows, f, dv, tp, r, CAP, XSPH, ALPHA)
    assert good.ok and good.n_over == 0, good
    f0, dv0 = sk.fold_forces(sums, rows[:, 6], tp, 0.0, ALPHA)
    bad = sk.forces_accuracy(tf, rows, f0, dv0, tp, r, CAP, XSPH, ALPHA)
    assert not bad.ok and bad.roundings > 100 * sk.SUBSTEP_ROUNDINGS, bad


def test_substep_rule_with_extensions_rejects_no_artificial_viscosity():
    # the extended substep rule passes the plain K2-ext and fails K2-ext
    # with alpha_visc zeroed (chip_smoke.py's planted control)
    kw = dict(_CALM, xsph=XSPH, artificial_viscosity=ALPHA)
    cfg = SimConfig(**kw)
    st, _ = make_rollout(cfg, 2, device="cpu")(initial_state(cfg, "cpu"))
    tp = PhysParams.from_config(cfg)
    r = cfg.bucket_resolution
    tf, (ps, vs) = build_frame(st.pos, r, CAP, extras=(st.pos, st.vel))
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    good = sk.substep_accuracy(
        tf, rows, sk.fused_substep_plain(tf, rows, tp, r, CAP, XSPH, ALPHA),
        tp, r, CAP, XSPH, ALPHA)
    assert good.ok, good
    bad = sk.substep_accuracy(
        tf, rows, sk.fused_substep_plain(tf, rows, tp, r, CAP, XSPH, 0.0),
        tp, r, CAP, XSPH, ALPHA)
    assert not bad.ok and bad.roundings > 100 * sk.SUBSTEP_ROUNDINGS, bad


def test_fold_matches_fused_substep_and_traps_still_move_by_xsph():
    # K3's sums + fold + integrate_substep equal the fused plain substep
    # bit for bit, and a NaN-trapped particle still moves by dt·dv
    # (stepper.py:57-59): its velocity is zeroed after the trap, dv is not
    from sphfluidsimulation_torch.sim.stepper import integrate_substep
    cfg = SimConfig(**_CALM)
    tp = PhysParams.from_config(cfg)
    r = cfg.bucket_resolution
    st = initial_state(cfg, "cpu")
    tf, (ps,) = build_frame(st.pos, r, CAP, extras=(st.pos,))
    vel = 0.2 * torch.randn(ps.shape, generator=torch.Generator()
                            .manual_seed(1))
    rows = sk.pack_rows(ps, vel, sk.density_plain(tf, ps, tp, r, CAP))
    f, dv = sk.forces_pass(tf, rows, tp, r, CAP, XSPH, ALPHA)
    pos_n, vel_n, nan = integrate_substep(rows[:, :3], rows[:, 3:6], f, tp,
                                          dv)
    fused = sk.fused_substep_plain(tf, rows, tp, r, CAP, XSPH, ALPHA)
    assert torch.equal(sk.pack_rows(pos_n, vel_n, rows[:, 6],
                                    nan.to(torch.float32)), fused)
    f_nan = f.clone()
    f_nan[::50, 0] = float("nan")
    p2, v2, nan2 = integrate_substep(rows[:, :3], rows[:, 3:6], f_nan, tp, dv)
    assert bool(nan2[::50].all()) and bool((v2[::50] == 0).all())
    want = torch.clamp(rows[::50, :3] + tp.dt * dv[::50], 0.0, 1.0)
    assert torch.equal(p2[::50], want)
    assert bool((dv[::50] != 0).any())
