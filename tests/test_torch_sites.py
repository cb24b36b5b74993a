"""The sites tier (``ops/sites.py``, ``neighbor="sites"``) against the JAX
package's, on the same numpy-seeded inputs: a counterpart of each test of
``tests/test_sites.py``.

- ``frame_binding`` and the site slots (``_site_slots``) are integer-equal
  to JAX's, a coincident pile, NaN rows and signed zeros included.
- Density within rtol 2e-5 / atol 1e-6 of JAX's sites density, forces within
  3e-6 of the largest |f| (the JAX tests' tolerances against brute), and
  each certificate equal to JAX's.
- Within the port, bit for bit: the banded passes against the one-piece
  pass, the cell blocking, the slot trimming.
- The sites step within 1e-5 (positions) of JAX's in both modes and with
  the extensions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.models.presets import init_positions as jinit_pos
from sphfluidsimulation_tpu.ops import sites as jsites
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_tpu.sim.stepper import initial_state as jinit
from sphfluidsimulation_tpu.sim.stepper import make_frame_step as jstep
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import sites
from sphfluidsimulation_torch.params import PhysParams
from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                  make_frame_step,
                                                  make_rollout)

# one intra-op thread, as in the port's other test modules
torch.set_num_threads(1)

# the JAX references, jitted: a call compiles each scan once per shape
# (unjitted, every call traces and compiles the three branches of the
# escalation's lax.switch again)
_jbinding = jax.jit(jsites.frame_binding, static_argnums=(1, 2))
_jdensity = jax.jit(jsites.density_sites, static_argnums=(4, 5, 6),
                    static_argnames=("z_bands",))
_jforces = jax.jit(jsites.fluid_forces_sites, static_argnums=(6, 7, 8),
                   static_argnames=("xsph", "alpha_visc", "z_bands"))
_jinit_pos = jax.jit(jinit_pos, static_argnums=0)

# tests/test_sites.py:40-43, :59-61
RHO_RTOL, RHO_ATOL, F_SCALED = 2e-5, 1e-6, 3e-6
POS_ATOL = 1e-5          # tests/test_sites.py:165-167


def _cloud(n, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (n, 3)).astype(np.float32),
            rng.normal(0, 0.3, (n, 3)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _both(cfg_kw):
    cfg = SimConfig(**cfg_kw)
    jc = JConfig(**cfg_kw)
    return cfg, jc, PhysParams.from_config(cfg), JPhys.from_config(jc)


def _binding(pos, r, cap):
    """The port's and JAX's frame binding of ``pos``, held integer-equal."""
    got = sites.frame_binding(_t(pos), r, cap)
    want = _jbinding(jnp.asarray(pos), r, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got, want


def _hold_density(rho, jrho):
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho),
                               rtol=RHO_RTOL, atol=RHO_ATOL)


def _hold_forces(f, jf, tol=F_SCALED):
    jf = np.asarray(jf)
    scale = max(np.abs(jf).max(), 1e-12)
    np.testing.assert_allclose(f.numpy() / scale, jf / scale, atol=tol)


def _density_pair(pos, r, cap, p, jp, ki, kj, **kw):
    (cid, ic, _), (jcid, jic, _) = _binding(pos, r, cap)
    rho, cert = sites.density_sites(_t(pos), cid, ic, p, r, ki, kj, **kw)
    jrho, jcert = _jdensity(jnp.asarray(pos), jcid, jic, jp, r, ki, kj,
                           **kw)
    return rho, cert, jrho, jcert


# ----------------------------------------------------------- binding/slots --

@pytest.mark.parametrize("cap", [4, 32, None])
def test_frame_binding_integer_equal(cap):
    pos, _ = _cloud(2048, 1, -0.1, 1.1)
    pos[:300] = [0.5, 0.125, 0.5]                  # a pile past capacity
    pos[300:305] = np.nan
    _binding(pos, 9, cap)


def _slot_keys(seed):
    """Site keys with a coincident pile, NaN rows, signed zeros and equal
    positions of different ρ, and cells with out-of-range ids."""
    rng = np.random.default_rng(seed)
    n, r = 1500, 7
    pos = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    pos[:400] = [0.5, 0.0, 0.5]
    pos[:100, 1] = -0.0
    pos[400:410] = np.nan
    pos[410:420, 0] = np.nan
    pos[420:460] = pos[460:500]
    rho = rng.choice(np.float32([0.0, -0.0, 1.5, 2.0, np.nan]), n)
    cid = rng.integers(-3, r ** 3 + 3, n).astype(np.int32)
    cid[:400] = 17
    member = rng.random(n) < 0.8
    return pos, rho, cid, member, r


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_rho", [False, True])
def test_site_slots_integer_equal(masked, with_rho):
    pos, rho, cid, member, r = _slot_keys(3)
    s = r ** 3
    cols = [pos[:, 0], pos[:, 1], pos[:, 2]] + ([rho] if with_rho else [])
    slot, order = sites._site_slots([_t(c) for c in cols], _t(cid), len(cid),
                                    s, 4, _t(member) if masked else None)
    jslot, jorder = jsites._site_slots(
        [jnp.asarray(c) for c in cols], jnp.asarray(cid), len(cid), s, 4,
        jnp.asarray(member) if masked else None)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))


def test_site_builds_integer_equal_on_a_pile():
    # the coincident pile of tests/test_sites.py:109 and a NaN row: slots,
    # occupancy, multiplicity, δ and the certificates equal JAX's
    n, r = 1024, 9
    rng = np.random.default_rng(0)
    pos = np.concatenate([np.repeat([[0.5, 0.125, 0.5]], 900, 0),
                          rng.uniform(0, 1, (n - 900, 3))]).astype(np.float32)
    pos[950] = np.nan
    cfg, jc, p, jp = _both(dict(particle_number=n, bucket_resolution=r,
                                voxel_capacity=None))
    (cid, ic, _), (jcid, jic, _) = _binding(pos, r, None)
    j = sites.build_j_sites(cid, ic, _t(pos), None, None, r, 8, p)
    jj = jsites.build_j_sites(jcid, jic, jnp.asarray(pos), None, None, r, 8,
                              jp)
    np.testing.assert_array_equal(j.a.numpy(), np.asarray(jj.a))
    np.testing.assert_array_equal(j.pos.numpy(), np.asarray(jj.pos))
    assert int(j.cert) == int(jj.cert)
    i = sites.build_i_sites(_t(pos), None, None, r, 8)
    ji = jsites.build_i_sites(jnp.asarray(pos), None, None, r, 8)
    for f in ("slot_of", "occ", "delta", "dmax", "cert"):
        np.testing.assert_array_equal(getattr(i, f).numpy(),
                                      np.asarray(getattr(ji, f)), err_msg=f)


def test_uncapped_binding():
    # voxel_capacity=None: nothing dropped from the bucket, in-range only
    pos, _ = _cloud(2048, 1, 0.48, 0.52)
    (_, in_cap, ovf), _ = _binding(pos, 9, None)
    assert int(ovf) == 0 and bool(in_cap.all())


# --------------------------------------------------------- density, forces --

@pytest.mark.parametrize("n,r,cap", [(512, 9, 32), (1024, 13, 8)])
def test_density_sites_matches_jax(n, r, cap):
    cfg, jc, p, jp = _both(dict(particle_number=n, bucket_resolution=r,
                                voxel_capacity=cap))
    pos, _ = _cloud(cfg.n_particles, n)
    rho, cert, jrho, jcert = _density_pair(pos, r, cap, p, jp, 16, 16)
    assert int(cert) == 0 == int(jcert)
    _hold_density(rho, jrho)


def _forces_pair(pos, vel, rho, r, cap, p, jp, ki, kj, **kw):
    (cid, ic, _), (jcid, jic, _) = _binding(pos, r, cap)
    got = sites.fluid_forces_sites(_t(pos), _t(vel), _t(rho), cid, ic, p, r,
                                   ki, kj, **kw)
    want = _jforces(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rho),
                    jcid, jic, jp, r, ki, kj, **kw)
    return got, want


@pytest.mark.parametrize("n,r,cap", [(512, 9, 32), (1024, 13, 8)])
def test_forces_sites_match_jax(n, r, cap):
    cfg, jc, p, jp = _both(dict(particle_number=n, bucket_resolution=r,
                                voxel_capacity=cap))
    pos, vel = _cloud(cfg.n_particles, n + 7)
    _, _, jrho, _ = _density_pair(pos, r, cap, p, jp, 16, 16)
    (f, dv, c), (jf, jdv, jc_) = _forces_pair(pos, vel, jrho, r, cap, p, jp,
                                              16, 16)
    assert dv is None and jdv is None and int(c) == 0 == int(jc_)
    _hold_forces(f, jf)


@pytest.mark.slow
def test_forces_sites_stale_bucket_fresh_window():
    # the reference walks the FRAME-START bucket from the CURRENT cell
    # (VelPos.compute:57-58): everyone moved 2 cells, the binding stale
    cfg, jc, p, jp = _both(dict(particle_number=1024, bucket_resolution=9))
    pos, vel = _cloud(cfg.n_particles, 11)
    r = 9
    _, _, jrho, _ = _density_pair(pos, r, 32, p, jp, 16, 16)
    pos2 = np.clip(pos + 2.0 / 8.0, 0.0, 1.0)
    (cid, ic, _), (jcid, jic, _) = _binding(pos, r, 32)
    f, _, c = sites.fluid_forces_sites(_t(pos2), _t(vel), _t(jrho), cid, ic,
                                       p, r, 16, 16)
    jf, _, jc_ = _jforces(jnp.asarray(pos2), jnp.asarray(vel), jrho, jcid,
                          jic, jp, r, 16, 16)
    assert int(c) == 0 == int(jc_)
    _hold_forces(f, jf)


@pytest.mark.slow
@pytest.mark.parametrize("preset,r,n", [(1, 11, 1024), (1, 17, 4096)])
def test_spawn_jitter_escalation(preset, r, n):
    # spawns overshoot the cube before the first clamp: the i-grid clamps
    # the cell and widens the window (radius 2 or 3 by max|δ|), as JAX
    kw = dict(particle_number=n, bucket_resolution=r, preset=preset)
    cfg, jc, p, jp = _both(kw)
    pos = np.asarray(_jinit_pos(jc))
    assert pos.min() < 0.0 or pos.max() > 1.0
    i = sites.build_i_sites(_t(pos), None, None, r, 32)
    assert int(i.dmax) > 0                        # the escalation is taken
    rho, cert, jrho, jcert = _density_pair(pos, r, 32, p, jp, 32, 32)
    assert int(cert) == int(jcert)
    _hold_density(rho, jrho)
    vel = np.zeros_like(pos)
    (f, _, c), (jf, _, jc_) = _forces_pair(pos, vel, jrho, r, 32, p, jp,
                                           32, 32)
    assert int(c) == int(jc_)
    _hold_forces(f, jf)


def test_coincident_pile_dedup():
    # 900 particles on one point collapse to ONE site; a site capacity of 8
    # still certifies exact (tests/test_sites.py:109-139)
    n, r = 1024, 9
    rng = np.random.default_rng(0)
    pos = np.concatenate([np.repeat([[0.5, 0.125, 0.5]], 900, 0),
                          rng.uniform(0, 1, (n - 900, 3))]).astype(np.float32)
    vel = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    cfg, jc, p, jp = _both(dict(particle_number=n, bucket_resolution=r,
                                voxel_capacity=None))
    rho, cert, jrho, jcert = _density_pair(pos, r, None, p, jp, 8, 8)
    assert int(cert) == 0 == int(jcert)
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=2e-4,
                               atol=1e-5)
    (f, _, c), (jf, _, jc_) = _forces_pair(pos, vel, jrho, r, None, p, jp,
                                           8, 8)
    assert int(c) == 0 == int(jc_)
    _hold_forces(f, jf, 1e-5)


def test_site_capacity_certificate_fires():
    # more distinct positions per voxel than site slots: a loud certificate
    pos = np.random.default_rng(5).uniform(0.45, 0.55, (256, 3)).astype(
        np.float32)
    cfg, jc, p, jp = _both(dict(particle_number=256, bucket_resolution=5))
    _, cert, _, jcert = _density_pair(pos, 5, 32, p, jp, 2, 2)
    assert int(cert) == int(jcert) > 0


@pytest.mark.slow
def test_independent_i_capacity():
    # site_capacity_i raises only the evaluation grid's capacity
    pos = (0.05 + 0.2 * np.random.default_rng(3).random((512, 3))).astype(
        np.float32)
    cfg, jc, p, jp = _both(dict(particle_number=512, bucket_resolution=9))
    _, small, _, jsmall = _density_pair(pos, 9, 32, p, jp, 8, 32)
    assert int(small) == int(jsmall) > 0
    _, big, _, jbig = _density_pair(pos, 9, 32, p, jp, 512, 32)
    assert int(big) == 0 == int(jbig)


def test_folds_match_jax_scanned_fold(monkeypatch):
    # JAX's large-grid fold (one j-slot at a time, KJ_SCAN_CELLS) and the
    # port's fixed tree: the same candidate set, float-order apart (the
    # tolerances of tests/test_sites.py:245-278)
    kw = dict(particle_number=1024, bucket_resolution=11, preset=0,
              gas_constant=20.0)
    cfg, jc, p, jp = _both(kw)
    pos = np.asarray(_jinit_pos(jc))
    vel = (0.05 * np.sin(37.0 * pos)).astype(np.float32)
    r = 11
    monkeypatch.setattr(jsites, "KJ_SCAN_CELLS", 0)
    rho, cert, jrho, jcert = _density_pair(pos, r, 32, p, jp, 16, 16)
    assert int(cert) == int(jcert)
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=1e-6,
                               atol=1e-6)
    (f, _, c), (jf, _, jc_) = _forces_pair(pos, vel, jrho, r, 32, p, jp,
                                           16, 16)
    assert int(c) == int(jc_)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4,
                               atol=1e-5)


def _port_passes(pos, vel, r, ki, kj, p, **kw):
    cid, ic, _ = sites.frame_binding(_t(pos), r, 32)
    rho, cr = sites.density_sites(_t(pos), cid, ic, p, r, ki, kj)
    f, dv, cf = sites.fluid_forces_sites(_t(pos), _t(vel), rho, cid, ic, p,
                                         r, ki, kj, **kw)
    return rho, cr, f, dv, cf


def _same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x is None and y is None


def test_cell_blocks_and_slot_trimming_keep_every_bit(monkeypatch):
    # the pass's cell blocking and its cut of empty slots change no bit
    kw = dict(particle_number=1024, bucket_resolution=9, xsph=0.05,
              artificial_viscosity=0.2)
    cfg, _, p, _ = _both(kw)
    pos, vel = _cloud(cfg.n_particles, 44)
    args = (pos, vel, 9, 32, 32, p)
    ext = dict(xsph=0.05, alpha_visc=0.2)
    base = _port_passes(*args, **ext)
    monkeypatch.setattr(sites, "_BLOCK_ELEMS", 37 * 32 * 32)
    _same(_port_passes(*args, **ext), base)
    monkeypatch.setattr(sites, "_occupied", lambda flags: flags.shape[-2])
    _same(_port_passes(*args, **ext), base)


def test_artificial_viscosity_nan_of_empty_slots_as_jax():
    # an i-site with infinite velocity: JAX's empty j-slots give its
    # artificial-viscosity sum 0 · inf = NaN; the port's trimmed pass keeps
    # one empty slot and so the same NaN pattern
    kw = dict(particle_number=512, bucket_resolution=9, xsph=0.05,
              artificial_viscosity=0.2)
    cfg, jc, p, jp = _both(kw)
    pos, vel = _cloud(cfg.n_particles, 45)
    vel[:3] = [np.inf, -np.inf, 0.0]
    _, _, jrho, _ = _density_pair(pos, 9, 32, p, jp, 32, 32)
    (f, dv, _), (jf, jdv, _) = _forces_pair(
        pos, vel, jrho, 9, 32, p, jp, 32, 32, xsph=0.05, alpha_visc=0.2)
    np.testing.assert_array_equal(np.isnan(f.numpy()), np.isnan(jf))
    assert np.isnan(f.numpy()).any()
    ok = np.isfinite(np.asarray(jf)).all(-1)
    _hold_forces(f[ok], np.asarray(jf)[ok])


# --------------------------------------------------------- z-banded grids --

@pytest.mark.parametrize("nb", [2, 3, 5])
def test_banded_density_bit_identical(nb):
    cfg, jc, p, jp = _both(dict(particle_number=2048, bucket_resolution=11))
    pos, _ = _cloud(cfg.n_particles, 42)
    r = 11
    (cid, ic, _), _ = _binding(pos, r, 32)
    full, c_full = sites.density_sites(_t(pos), cid, ic, p, r, 16, 16)
    band, c_band = sites.density_sites(_t(pos), cid, ic, p, r, 16, 16,
                                       z_bands=nb)
    assert int(c_full) == 0 == int(c_band)
    assert torch.equal(band, full)
    _, _, jband, _ = _density_pair(pos, r, 32, p, jp, 16, 16, z_bands=nb)
    _hold_density(band, jband)


@pytest.mark.parametrize("nb", [2, 4])
def test_banded_forces_bit_identical(nb):
    cfg, jc, p, jp = _both(dict(particle_number=2048, bucket_resolution=11))
    pos, vel = _cloud(cfg.n_particles, 43)
    r = 11
    (cid, ic, _), _ = _binding(pos, r, 32)
    rho, _ = sites.density_sites(_t(pos), cid, ic, p, r, 16, 16)
    full = sites.fluid_forces_sites(_t(pos), _t(vel), rho, cid, ic, p, r,
                                    16, 16)
    band = sites.fluid_forces_sites(_t(pos), _t(vel), rho, cid, ic, p, r,
                                    16, 16, z_bands=nb)
    assert full[1] is None and band[1] is None
    assert int(full[2]) == 0 == int(band[2])
    assert torch.equal(band[0], full[0])


@pytest.mark.slow
def test_banded_extensions_bit_identical():
    kw = dict(particle_number=1024, bucket_resolution=9, xsph=0.05,
              artificial_viscosity=0.2)
    cfg, jc, p, jp = _both(kw)
    pos, vel = _cloud(cfg.n_particles, 44)
    r = 9
    ext = dict(xsph=0.05, alpha_visc=0.2)
    (cid, ic, _), _ = _binding(pos, r, 32)
    rho, _ = sites.density_sites(_t(pos), cid, ic, p, r, 16, 16)
    f_f, dv_f, c_f = sites.fluid_forces_sites(_t(pos), _t(vel), rho, cid, ic,
                                              p, r, 32, 32, **ext)
    f_b, dv_b, c_b = sites.fluid_forces_sites(_t(pos), _t(vel), rho, cid, ic,
                                              p, r, 32, 32, z_bands=3, **ext)
    assert int(c_f) == 0 == int(c_b)
    assert torch.equal(f_b, f_f) and torch.equal(dv_b, dv_f)
    (jf, jdv, _) = _forces_pair(pos, vel, rho.numpy(), r, 32, p, jp, 32, 32,
                                z_bands=3, **ext)[1]
    _hold_forces(f_b, jf)
    _hold_forces(dv_b, jdv)


def test_banded_cert_counts_once():
    # capacity overflow: each voxel's drops counted by its interior owner
    # band once, so the banded certificate equals the one-piece one (and
    # JAX's)
    pos = np.random.default_rng(7).uniform(0.3, 0.7, (512, 3)).astype(
        np.float32)
    cfg, jc, p, jp = _both(dict(particle_number=512, bucket_resolution=7))
    (cid, ic, _), _ = _binding(pos, 7, 32)
    _, c_f = sites.density_sites(_t(pos), cid, ic, p, 7, 2, 2)
    _, c_b, _, jc_b = _density_pair(pos, 7, 32, p, jp, 2, 2, z_bands=3)
    assert int(c_f) > 0
    assert int(c_b) == int(c_f) == int(jc_b)


def test_banded_spawn_jitter_escalation():
    kw = dict(particle_number=4096, bucket_resolution=13, preset=2)
    cfg, jc, p, jp = _both(kw)
    pos = np.asarray(_jinit_pos(jc))
    r = 13
    (cid, ic, _), _ = _binding(pos, r, 32)
    full, c_f = sites.density_sites(_t(pos), cid, ic, p, r, 32, 32)
    band, c_b, jband, jc_b = _density_pair(pos, r, 32, p, jp, 32, 32,
                                           z_bands=4)
    assert int(c_b) == int(c_f) == int(jc_b)
    assert torch.equal(band, full)
    _hold_density(band, jband)


def test_banded_step_bit_identical_to_full():
    kw = dict(particle_number=1024, bucket_resolution=11, site_capacity=16)
    cfg_f, cfg_b = SimConfig(**kw, site_bands=1), SimConfig(**kw,
                                                            site_bands=3)
    st = initial_state(cfg_f, "cpu")
    s_f, m_f = make_frame_step(cfg_f, neighbor="sites", device="cpu")(st)
    s_b, m_b = make_frame_step(cfg_b, neighbor="sites", device="cpu")(st)
    assert int(m_f.exact_cert) == 0 == int(m_b.exact_cert)
    for a, b in zip(s_b, s_f):
        assert torch.equal(a, b)


def test_bands_for_takes_one_piece_where_the_card_holds_it(monkeypatch):
    # on the CPU JAX's rule; on a card the one-piece pass while its bound
    # fits in half the free memory, JAX's rule past that
    r, n = 75, 1 << 20
    need = sites.one_piece_bytes(r, n, 32, 32)
    assert sites.bands_for(r, n, 32, 32, torch.device("cpu")) == 5
    cuda = torch.device("cuda")
    for free, want in ((2 * need, 1), (2 * need - 2, 5)):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda device, free=free: (free, 80 << 30))
        assert sites.bands_for(r, n, 32, 32, cuda) == want


def test_auto_bands_rule_matches_jax():
    for r in range(3, 130):
        assert sites.auto_bands(r) == jsites.auto_bands(r), r
    assert sites.SITE_BAND_AUTO_CELLS == jsites.SITE_BAND_AUTO_CELLS
    assert sites._BAND_HALO == jsites._BAND_HALO


def test_banded_multi_frame_rollout_runs_and_equals_stepping():
    # JAX refuses multi-frame banded sites rollouts (a TPU worker fault,
    # stepper.py:588-605); the port's rollout is a host loop and runs,
    # bit-equal to stepping frame by frame
    cfg = SimConfig(particle_number=512, bucket_resolution=9,
                    site_capacity=16, site_bands=3)
    st0 = initial_state(cfg, "cpu")
    final, m = make_rollout(cfg, 2, neighbor="sites", device="cpu")(st0)
    step = make_frame_step(cfg, neighbor="sites", device="cpu")
    st = st0
    for _ in range(2):
        st, _ = step(st)
    assert m.exact_cert.shape == (2,)
    for a, b in zip(final, st):
        assert torch.equal(a, b)


# ------------------------------------------------------------- the step ----

def _step_pair(kw, faithful):
    cfg = SimConfig(**kw)
    jc = JConfig(**kw)
    s, m = make_frame_step(cfg, neighbor="sites", faithful=faithful,
                           device="cpu")(initial_state(cfg, "cpu"))
    js_, jm = jax.jit(jstep(jc, neighbor="sites", faithful=faithful))(
        jinit(jc))
    return s, m, js_, jm


@pytest.mark.parametrize("faithful", [
    True, pytest.param(False, marks=pytest.mark.slow)])
def test_sites_step_matches_jax(faithful):
    kw = dict(particle_number=1024, bucket_resolution=11,
              site_capacity=16 if faithful else 32)
    s, m, js_, jm = _step_pair(kw, faithful)
    np.testing.assert_allclose(s.pos.numpy(), np.asarray(js_.pos),
                               rtol=0, atol=POS_ATOL)
    assert int(m.exact_cert) == int(jm.exact_cert) == 0
    assert int(m.overflow) == int(jm.overflow)
    assert float(m.mean_density) == pytest.approx(float(jm.mean_density),
                                                  rel=1e-5)


@pytest.mark.slow
def test_sites_step_extensions_match_jax():
    kw = dict(particle_number=1024, bucket_resolution=11, xsph=0.05,
              artificial_viscosity=0.2, site_capacity=32)
    s, m, js_, jm = _step_pair(kw, True)
    np.testing.assert_allclose(s.pos.numpy(), np.asarray(js_.pos),
                               rtol=0, atol=POS_ATOL)
    assert int(m.exact_cert) == int(jm.exact_cert) == 0


def test_sites_artificial_viscosity_alone_runs_where_jax_raises():
    # JAX keeps the site multiplicity only with XSPH, so its avisc-only
    # force pass reads None and raises (ROADMAP.md queue C); the port keeps
    # it and tracks the slotted tier as the pair with XSPH does
    kw = dict(particle_number=1024, bucket_resolution=11,
              artificial_viscosity=0.2, site_capacity=32)
    jc = JConfig(**kw)
    with pytest.raises(TypeError, match="NoneType"):  # while tracing
        jax.eval_shape(jstep(jc, neighbor="sites"),
                       jax.eval_shape(jax.jit(jinit, static_argnums=0), jc))
    cfg = SimConfig(**kw)
    st = initial_state(cfg, "cpu")
    s, m = make_frame_step(cfg, neighbor="sites", device="cpu")(st)
    ref, _ = make_frame_step(cfg, neighbor="slotted", device="cpu")(st)
    assert int(m.exact_cert) == 0
    torch.testing.assert_close(s.pos, ref.pos, rtol=0, atol=POS_ATOL)
