"""The tuning variants of the torch port (``SortedTuning``: ``fuse_acc``,
``kahan``, ``bf16``, ``fused``) and the banded K5, against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
under a ``PallasTuning`` and through the port's plain version under the
``SortedTuning`` of the same semantic fields (on the CPU every wrapper runs
its plain version; the CUDA instances are held against these plain versions
on the card by tests/test_torch_cuda.py and chip_smoke.py). JAX Pallas runs
in interpret mode, one call a test, with tile groups of two 64-row tiles and
no unroll: layout knobs that the port ignores and that change nothing but
the TPU kernel's summation order, while they keep one interpret-mode call to
a second or two.

Tolerances are those of the port's existing tests of the same functions:
substeps 1e-6 absolute in position and velocity (tests/test_torch_kernels.py,
tests/test_torch_compact.py), force sums 1e-6 of their largest magnitude
(tests/test_torch_forces.py), densities 1e-5 relative (same candidates,
another summation order; the bf16 instances round exactly the values JAX
rounds, so they differ from JAX by summation order alone). JAX's own
contracts between the variants (tests/test_pallas.py,
tests/test_slab_pallas.py) are held on the port with JAX's tolerances.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.models.presets import init_positions as jinit
from sphfluidsimulation_tpu.ops import pallas_compact, pallas_sph
from sphfluidsimulation_tpu.ops.pallas_sph import PallasTuning
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import compact, cuda_build
from sphfluidsimulation_torch.ops import sph_kernels as sk
from sphfluidsimulation_torch.ops.frame import build_frame
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning
from sphfluidsimulation_torch.params import PhysParams
from sphfluidsimulation_torch.parallel import (LocalRing, collect, distribute,
                                               make_pallas_slab_step)
from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                  make_frame_step,
                                                  make_rollout)

# one intra-op thread: the suite runs in several worker processes on
# shared cores, where each worker's spinning OpenMP threads slowed the
# port's many small CPU ops about fivefold
torch.set_num_threads(1)

# tests/test_pallas.py:18-21
_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
_GOLDENISH = dict(particle_number=1024, bucket_resolution=11)
CALM = SimConfig(**_CALM)
CAP = 32
XSPH, ALPHA = 0.3, 0.4
# the JAX kernels' tile geometry in these tests (see the module docstring)
JFAST = dict(tiles_per_group=2, unroll=1)
# the semantic variables and the fields they set
VARS = {"SPH_PALLAS_FUSED": "fused", "SPH_PALLAS_KAHAN": "kahan",
        "SPH_PALLAS_BF16": "bf16", "SPH_PALLAS_FACC": "fuse_acc",
        "SPH_PALLAS_COMPACT": "compact"}
# the variants away from the default, as (port, JAX) tunings
VARIANTS = {"facc0": dict(fuse_acc=False), "kahan": dict(kahan=True),
            "bf16": dict(bf16=True)}


def _tunes(variant: str, **kw) -> tuple[SortedTuning, PallasTuning]:
    fields = dict(VARIANTS[variant], **kw)
    return SortedTuning(**fields), PallasTuning(**fields, **JFAST)


# ------------------------------------------------- reading the environment --

@pytest.mark.parametrize("value", [None, "0", "1"])
@pytest.mark.parametrize("var", sorted(VARS))
def test_from_env_matches_jax(monkeypatch, var, value):
    for v in VARS:
        monkeypatch.delenv(v, raising=False)
    if value is not None:
        monkeypatch.setenv(var, value)
    got, want = SortedTuning.from_env(), PallasTuning.from_env()
    for field in VARS.values():
        assert getattr(got, field) == getattr(want, field), field
    assert sk.default_tuning() == got


# --------------------------------------------------------- bf16 rounding --

def test_bf16_round_matches_jax_round_trip():
    special = np.array(
        [0x00000000, 0x80000000,                      # ±0
         0x00000001, 0x00008000, 0x00018000, 0x00028000,  # subnormals, ties
         0x007FFFFF, 0x807F8000, 0x80010001,
         0x3F808000, 0x3F818000, 0x3F80C000, 0xBF818000,  # ties to even
         0x7F7FFFFF, 0xFF7FFFFF,                      # round to ±inf
         0x7F800000, 0xFF800000,                      # ±inf
         0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF812345,
         0x7FFFFFFF],                                 # NaNs
        np.uint32)
    rng = np.random.default_rng(0)
    bits = np.concatenate([special,
                           rng.integers(0, 2 ** 32, 4096, dtype=np.uint32)])
    x = bits.view(np.float32)
    hi, lo = pallas_sph.unpack_pair_bf16(
        pallas_sph._pack_pair_bf16(jnp.asarray(x), jnp.asarray(x[::-1])))
    got = sk.bf16_round(torch.from_numpy(x.copy())).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(hi).view(np.uint32))
    np.testing.assert_array_equal(got[::-1], np.asarray(lo).view(np.uint32))
    # a float64 evaluation's rows hold float32 values: the same rounding
    fin = np.isfinite(x)
    got64 = sk.bf16_round(torch.from_numpy(x[fin].astype(np.float64)))
    np.testing.assert_array_equal(got64.numpy().astype(np.float32),
                                  got.view(np.float32)[fin])


# ------------------------------------------------------ Kahan fold sign --

def _f32(x):
    return np.float32(x)


def _kahan_f32(terms):
    """JAX's accum recurrence in float32: (s, c)."""
    s = c = _f32(0.0)
    for t in terms:
        y = _f32(t - c)
        tt = _f32(s + y)
        c = _f32(_f32(tt - s) - y)
        s = tt
    return s, c


def _w_f32(p, q, h2, c9):
    d = (p - q).astype(np.float32)
    r2 = _f32(_f32(_f32(d[0] * d[0]) + _f32(d[1] * d[1])) + _f32(d[2] * d[2]))
    diff = _f32(h2 - r2)
    return _f32(_f32(_f32(c9 * diff) * diff) * diff) if diff > 0 else None


def _fold_sign_scene():
    """(pos f32[512, 3], h, row 0's terms in walk order): every particle in
    cell 0 of an R = 3 grid, so the sorted order is the particle order and
    the JAX kernel's lane of particle j is j mod 128. Row 0's neighbours
    within h are particles 128, 256 and 384, all in its own lane, so the
    JAX kernel's lane 0 and the port's walk add the same terms in the same
    order: the self term just below 2^16, then three that carry the sum
    just past it, where rounding down leaves a compensation c with
    s + c ≠ s − c (the last neighbour is moved an ulp at a time until that
    holds)."""
    c_poly6 = _f32(315.0 / (64.0 * np.pi))
    h = _f32(0.0288131)
    h2 = _f32(h * h)
    h9 = _f32(_f32(_f32(_f32(h2 * h2) * h2) * h2) * h)
    c9 = _f32(c_poly6 / h9)
    big = _f32(_f32(_f32(c9 * h2) * h2) * h2)
    assert 65536 - 60 < big < 65536 - 40
    p0 = np.full(3, 0.25, np.float32)
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(3, 3))
    dirs /= np.linalg.norm(dirs, axis=1)[:, None]
    w = float(65536 - big) / 3
    radius = np.sqrt(float(h2) - (w / float(c9)) ** (1 / 3))
    near = (p0 + radius * dirs).astype(np.float32)
    for _ in range(10000):
        terms = [big] + [_w_f32(p0, q, h2, c9) for q in near]
        s, c = _kahan_f32(terms)
        if s == 65536 and _f32(s + c) != _f32(s - c):
            break
        # x an ulp toward p0 raises the last term a little, away lowers it
        x = near[-1, 0]
        near[-1, 0] = np.nextafter(x, p0[0] if s <= 65536 else 2 * x - p0[0])
    else:
        raise AssertionError("no fold-sign scene")
    # the other particles: a lattice of points over 2h from p0, in cell 0
    g = np.arange(0.01, 0.49, 1.1 * float(h), dtype=np.float32)
    far = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    far = far[np.linalg.norm(far - p0, axis=1) > 2.2 * float(h)]
    far = far[rng.permutation(far.shape[0])]
    pos = np.empty((512, 3), np.float32)
    lane0 = np.arange(0, 512, 128)
    pos[lane0] = np.concatenate([p0[None], near])
    pos[np.setdiff1d(np.arange(512), lane0)] = far[:512 - 4]
    return pos, h, terms


def test_kahan_density_matches_jax_and_pins_the_fold_sign():
    # JAX folds the running sum and its compensation as s + c
    # (pallas_sph.py:1392-1394); the textbook correction, with
    # c = (t − s) − y, would be s − c. The port computes what JAX computes:
    # on this scene the two folds differ on row 0, and JAX, the port's
    # plain version and s + c agree bit for bit
    pos, h, terms = _fold_sign_scene()
    n, r = pos.shape[0], 3
    kw = dict(particle_number=n, bucket_resolution=r)
    jp = JPhys.from_config(JConfig(**kw))._replace(h=jnp.float32(h),
                                                   mass=jnp.float32(1.0))
    tp = PhysParams.from_config(SimConfig(**kw))._replace(
        h=torch.tensor(h), mass=torch.tensor(1.0))
    jt = PallasTuning(kahan=True, **JFAST)
    jf, (jps,) = pallas_sph.build_frame(jnp.asarray(pos), r, None,
                                        extras=(jnp.asarray(pos),), tune=jt,
                                        occ_hint=float(n))
    want, _ = pallas_sph.density_pass(jf, jps, jp, r, n, jt,
                                      occ_hint=float(n))
    want = np.asarray(want)
    tf, (tps,) = build_frame(torch.from_numpy(pos), r, None,
                             extras=(torch.from_numpy(pos),))
    assert torch.equal(tf.order, torch.arange(n, dtype=torch.int32))
    got = sk.density_plain(tf, tps, tp, r, None,
                           tune=SortedTuning(kahan=True)).numpy()
    # row 0 adds its terms in one JAX lane, in the order the port walks
    # them: the same bits; the rows whose terms spread over several lanes
    # differ by summation order
    assert got[0].view(np.uint32) == want[0].view(np.uint32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    s, c = _kahan_f32(terms)
    assert want[0] == _f32(s + c) != _f32(s - c)


def test_kahan_sum_is_the_jax_recurrence():
    # the plain versions' compensated sum, column by column, with gated
    # columns left out, is _kahan_f32 over the kept terms
    rng = np.random.default_rng(1)
    terms = (rng.normal(size=(5, 40, 2)) * 10.0 ** rng.integers(
        -6, 6, (5, 40, 2))).astype(np.float32)
    gate = rng.random((5, 40, 2)) < 0.7
    got = sk._kahan_sum(torch.from_numpy(terms), torch.from_numpy(gate))
    for i in range(5):
        for lane in range(2):
            s, c = _kahan_f32(terms[i, gate[i, :, lane], lane])
            assert got[i, lane].item() == _f32(s + c)


# -------------------------------------- variant sums and substeps vs JAX --

@functools.lru_cache(maxsize=None)
def _rows(name, seed=0):
    """(jp, tp, jf, tf, sorted pos, vel, rho, r, n) of a config's spawn
    with random velocities and its density (numpy inputs)."""
    kw = _CALM if name == "calm" else _GOLDENISH
    jc, tc = JConfig(**kw), SimConfig(**kw)
    pos = np.array(jinit(jc))
    r, n = jc.bucket_resolution, jc.n_particles
    vel = np.random.default_rng(seed).normal(0, 0.2, (n, 3)).astype(
        np.float32)
    jf, (jps, jvs) = pallas_sph.build_frame(
        jnp.asarray(pos), r, CAP, extras=(jnp.asarray(pos),
                                          jnp.asarray(vel)),
        tune=PallasTuning(**JFAST))
    tf, (tps, tvs) = build_frame(torch.from_numpy(pos), r, CAP,
                                 extras=(torch.from_numpy(pos),
                                         torch.from_numpy(vel)))
    tp = PhysParams.from_config(tc)
    rho = sk.density_plain(tf, tps, tp, r, CAP).numpy()
    return (JPhys.from_config(jc), tp, jf, tf, tps.numpy(), tvs.numpy(), rho,
            r, n)


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_substep_matches_jax_fused_substep(variant, ext):
    jp, tp, jf, tf, pos, vel, rho, r, n = _rows("calm")
    tune, jt = _tunes(variant)
    xs, al = (XSPH, ALPHA) if ext else (0.0, 0.0)
    jrows = pallas_sph.pack_rows(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(rho), None, n, jt)
    out, cert = pallas_sph.fused_substep(jf, jrows, jp, r, n, xsph=xs,
                                         alpha_visc=al, tune=jt)
    assert int(cert) == 0
    want = np.asarray(out).reshape(-1, sk.N_FIELDS)[:n]
    trows = sk.pack_rows(torch.from_numpy(pos), torch.from_numpy(vel),
                         torch.from_numpy(rho))
    got = sk.fused_substep(tf, trows, tp, r, CAP, xs, al, tune=tune).numpy()
    np.testing.assert_allclose(got[:, 0:6], want[:, 0:6], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 6:8], want[:, 6:8])


def _scaled_close(got, want, atol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


# the instances without extensions are also held by the substep test above
@pytest.mark.parametrize("ext", [pytest.param(False, marks=pytest.mark.slow),
                                 True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_forces_match_jax_forces_pallas(variant, ext):
    jp, tp, jf, tf, pos, vel, rho, r, n = _rows("calm", seed=1)
    tune, jt = _tunes(variant)
    xs, al = (XSPH, ALPHA) if ext else (0.0, 0.0)
    f, dv, cert = pallas_sph.forces_pallas(
        jf, jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rho), jp, r, n,
        xsph=xs, alpha_visc=al, tune=jt)
    assert int(cert) == 0
    rows = sk.pack_rows(torch.from_numpy(pos), torch.from_numpy(vel),
                        torch.from_numpy(rho))
    tf_, tdv = sk.forces_pass(tf, rows, tp, r, CAP, xs, al, tune=tune)
    assert (tdv is None) == (dv is None)
    _scaled_close(tf_.numpy(), np.asarray(f), 1e-6)
    if dv is not None:
        _scaled_close(tdv.numpy(), np.asarray(dv), 1e-6)
    # K3's layout: with fuse_acc the extension sums sit in lanes 3-8
    sums = sk.forces_plain(tf, rows, tp, r, CAP, ext, tune=tune)
    lanes = 3 * (1 + (not tune.fuse_acc) + 2 * ext)
    assert not sums[:, lanes:].any() and bool(sums[:, lanes - 3:].any())


def test_bf16_rounds_the_values_jax_rounds():
    # without extensions (JAX's pj window) only vx and vy of a candidate
    # are rounded; with them, and on K5, vx, vy, vz and ρⱼ, and the
    # pressure and 1/ρⱼ follow the rounded ρⱼ
    _, tp, _, tf, pos, vel, rho, r, n = _rows("calm")
    rows = sk.pack_rows(torch.from_numpy(pos), torch.from_numpy(vel),
                        torch.from_numpy(rho))
    j = torch.arange(n)[:, None]
    bf = SortedTuning(bf16=True)
    v, rj = sk.candidate_values(rows, j, False, bf)
    assert torch.equal(v[..., 0:2], sk.bf16_round(rows[j, 3:5]))
    assert torch.equal(v[..., 2], rows[j, 5]) and torch.equal(rj, rows[j, 6])
    for ext, tune in ((True, bf), (False, bf.k5())):
        v, rj = sk.candidate_values(rows, j, ext, tune)
        assert torch.equal(v, sk.bf16_round(rows[j, 3:6]))
        assert torch.equal(rj, sk.bf16_round(rows[j, 6]))
    assert not torch.equal(sk.bf16_round(rows[:, 6]), rows[:, 6])


# ------------------------------------------------------- K5: bf16, band --

def _drifted(name="calm"):
    """K5's inputs of tests/test_torch_compact.py: the calm spawn, eleven
    rows moved 2.5 cells up in z past their tiles' band, random
    velocities."""
    jp, tp, jf, tf, pos, vel, rho, r, n = _rows(name)
    moved = pos.copy()
    moved[100:111, 2] += 2.5 / (r - 1)
    return jp, tp, jf, tf, moved, vel, rho, r, n


def _jax_self_pair(frame, rows, phys, r, ext):
    """The self pair that JAX's compact kernel keeps (its gate has no
    j != i, pallas_compact.py:394-402) and the port drops, as the reference
    does (VelPos.compute:82): zero with float32 candidates, but a bf16
    candidate's vⱼ = bf16(vᵢ) is not vᵢ, so it adds ∇²W(0)/bf16(ρᵢ)·
    (bf16(vᵢ) − vᵢ) to the viscosity sum and, with extensions,
    2/(ρᵢ + bf16(ρᵢ))·W(0)·(bf16(vᵢ) − vᵢ) to the XSPH sum: f[N, 12] in
    K5's layout, for the rows whose own slot passes the gate."""
    n = rows.shape[0]
    ids = torch.arange(n)
    member = sk.member_gate(frame, ids[:, None],
                            torch.ones((n, 1), dtype=torch.bool),
                            sk.fresh_cell(rows[:, 0:3], r), r)
    h = phys.h
    h2 = h * h
    h6 = h2 * h2 * h2
    rho_r = sk.bf16_round(rows[:, 6:7])
    ok = rho_r > 1e-6
    inv = torch.where(ok, 1.0, 0.0) / torch.where(ok, rho_r, 1.0)
    dv = sk.bf16_round(rows[:, 3:6]) - rows[:, 3:6]
    out = torch.zeros((n, sk.N_SUMS))
    out[:, 3:6] = torch.where(member, (45.0 / np.pi) / h6 * h * inv * dv,
                              0.0)
    if ext:
        w0 = 315.0 / (64.0 * np.pi) / (h6 * h2 * h) * h2 * h2 * h2
        denom = rows[:, 6:7] + rho_r
        out[:, 6:9] = torch.where(member, 2.0 / denom * w0 * dv, 0.0)
    return out


def _sums_with_jax_self_pair(frame, rows, phys, r, capacity=None, ext=False,
                             magnitude=False, band=None, tune=None):
    return compact.compact_sums_plain(frame, rows, phys, r, capacity, ext,
                                      magnitude, band, tune) \
        + _jax_self_pair(frame, rows, phys, r, ext)


_sums_with_jax_self_pair.variant = SortedTuning.k5


# JAX's compact kernel rounds the same four values with and without the
# extensions (tier 1 keeps the instance with them)
@pytest.mark.parametrize("xsph,alpha", [
    pytest.param(0.0, 0.0, marks=pytest.mark.slow), (XSPH, ALPHA)])
def test_bf16_k5_substep_matches_jax_compact_substep(xsph, alpha):
    # the port's K5 in bf16 is JAX's but for the self pair, which the
    # port drops (_jax_self_pair): with it added, the two agree
    jp, tp, jf, tf, pos, vel, rho, r, n = _drifted()
    jt = PallasTuning(compact=True, bf16=True, **JFAST)
    jrows = pallas_sph.pack_rows(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(rho), None, n, jt)
    out, wcert = pallas_compact.compact_substep(
        jf, jrows, jp, r, n, xsph=xsph, alpha_visc=alpha, tune=jt)
    want = np.asarray(out).reshape(-1, sk.N_FIELDS)[:n]
    trows = sk.pack_rows(torch.from_numpy(pos), torch.from_numpy(vel),
                         torch.from_numpy(rho))
    bf = SortedTuning(compact=True, bf16=True)
    got, cert = compact.compact_substep(tf, trows, tp, r, CAP, xsph, alpha,
                                        tune=bf)
    assert torch.equal(got, sk.fused_substep_plain(
        tf, trows, tp, r, None, xsph, alpha, compact.compact_sums_plain,
        tune=bf))
    with_self = sk.fused_substep_plain(tf, trows, tp, r, None, xsph, alpha,
                                       _sums_with_jax_self_pair,
                                       tune=bf).numpy()
    np.testing.assert_allclose(with_self[:, 0:6], want[:, 0:6], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(with_self[:, 6:8], want[:, 6:8])
    assert int(cert) == int(wcert) == 11
    assert not np.array_equal(got.numpy()[:, 3:6], with_self[:, 3:6])


# the same bf16 window as the substep test above, through forces_compact
@pytest.mark.slow
def test_bf16_k5_forces_match_jax_forces_compact():
    jp, tp, jf, tf, pos, vel, rho, r, n = _drifted()
    jt = PallasTuning(compact=True, bf16=True, **JFAST)
    want, _, wcert = pallas_compact.forces_compact(
        jf, jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rho), jp, r, n,
        tune=jt)
    trows = sk.pack_rows(torch.from_numpy(pos), torch.from_numpy(vel),
                         torch.from_numpy(rho))
    bf = SortedTuning(bf16=True)
    got, cert = compact.forces_compact(tf, trows, tp, r, CAP, tune=bf)
    sums, _ = compact.forces_compact_plain(tf, trows, tp, r, bf)
    assert torch.equal(got, sk.fold_forces(sums, trows[:, 6], tp,
                                           fuse_acc=False)[0])
    # with JAX's self pair (see the substep test) the two agree
    f = sk.fold_forces(sums + _jax_self_pair(tf, trows, tp, r, False),
                       trows[:, 6], tp, fuse_acc=False)[0]
    _scaled_close(f.numpy(), np.asarray(want), 1e-6)
    assert int(cert) == int(wcert) == 11


def _band_scene(band_case, dead, seed=5):
    """(pos, gid, valid, band, r) of a banded frame as
    tests/test_torch_slab.py builds it: rows spread over the band's planes
    and a little past them, a pile past the capacity, with or without dead
    rows whose ids ascend with their row index."""
    rng = np.random.default_rng(seed)
    n, r = 900, 9
    zbase, z_span = {"below": (-2, 6), "inside": (3, 4),
                     "above": (6, 5)}[band_case]
    lo = max(zbase, 0) / (r - 1)
    hi = min(zbase + z_span - 1, r - 1) / (r - 1)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(lo, hi + 0.99 / (r - 1), n)
    pos[:150] = rng.uniform(0.0, 0.08, (150, 3))
    pos[:150, 2] += lo
    gid = rng.permutation(n).astype(np.int32)
    valid = np.ones(n, bool)
    if dead:
        valid[rng.choice(n, 250, replace=False)] = False
        gid[~valid] = np.sort(gid[~valid])
    return pos, gid, valid, (zbase, z_span), r


def _band_frames(band_case, dead, cap=CAP):
    pos, gid, valid, band, r = _band_scene(band_case, dead)
    jt = PallasTuning(compact=True, **JFAST)
    jf, (jps,) = pallas_sph.build_frame(
        jnp.asarray(pos), r, cap, extras=(jnp.asarray(pos),),
        gid=jnp.asarray(gid), tune=jt, band=(jnp.int32(band[0]), band[1]),
        valid=jnp.asarray(valid))
    tf, (tps,) = build_frame(
        torch.from_numpy(pos), r, cap, extras=(torch.from_numpy(pos),),
        gid=torch.from_numpy(gid), band=band, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(tps.numpy(), np.asarray(jps))
    return jf, tf, tps, band, r, jt


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("band_case", ["below", "inside", "above"])
def test_banded_spans_and_drift_match_jax(band_case, dead):
    jf, tf, tps, band, r, jt = _band_frames(band_case, dead)
    n = tps.shape[0]
    s_cells = band[1] * r * r
    t = compact.n_tiles(n)
    want = np.asarray(pallas_compact.stale_spans(jf, n, r, jt, s_cells))
    got = compact.stale_spans(tf, band, r)
    np.testing.assert_array_equal(got.numpy(), want[:t])
    # fresh positions: a few rows moved two planes up, past their band
    moved = tps.clone()
    moved[40:60, 2] += 2.0 / (r - 1)
    jband = (jnp.int32(band[0]), band[1])
    wspans, wdrift = pallas_compact.fresh_spans(
        jf, jnp.asarray(want), jnp.asarray(moved.numpy()), n, r, jt, jband,
        s_cells)
    spans, drift = compact.fresh_spans(got, moved, r, band,
                                       compact.live_rows(tf))
    np.testing.assert_array_equal(spans.numpy(), np.asarray(wspans)[:t])
    assert int(drift) == int(wdrift) > 0
    if dead:
        assert (got[-1] == compact.pad_cell(s_cells, r)).all()


@functools.lru_cache(maxsize=None)
def _slab_shard(cfg, frames=0):
    """The banded frame of shard 1 of 4 of ``cfg``'s scene as the slab step
    builds one (the band's rows, then 40 dead rows), in both packages, and
    its sorted rows with random velocities and K1's banded density."""
    st = initial_state(cfg, "cpu")
    if frames:
        st, _ = make_rollout(cfg, frames, device="cpu")(st)
    r, n = cfg.bucket_resolution, cfg.n_particles
    spec_z = -(-r // 4)
    band = (spec_z - 2, spec_z + 4)
    az = (st.pos[:, 2] * (r - 1)).to(torch.int32).clamp(0, r - 1)
    live = (az >= band[0]) & (az < band[0] + band[1])
    n_live = int(live.sum())
    # dead rows' ids ascend with their row index, so both sorts agree
    pos = torch.cat([st.pos[live], st.pos[:40]])
    valid = torch.arange(n_live + 40) < n_live
    gid = torch.cat([torch.arange(n, dtype=torch.int32)[live],
                     torch.arange(40, dtype=torch.int32)])
    vel = torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.2, (pos.shape[0], 3)).astype(np.float32))
    tf, (tps, tvs) = build_frame(pos, r, CAP, extras=(pos, vel), gid=gid,
                                 n_ids=n, band=band, valid=valid)
    jt = PallasTuning(compact=True, **JFAST)
    jf, (jps,) = pallas_sph.build_frame(
        jnp.asarray(pos.numpy()), r, CAP, extras=(jnp.asarray(pos.numpy()),),
        gid=jnp.asarray(gid.numpy()), tune=jt,
        band=(jnp.int32(band[0]), band[1]), valid=jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(tps.numpy(), np.asarray(jps))
    tp = PhysParams.from_config(cfg)
    rho = sk.density_plain(tf, tps, tp, r, CAP, band)
    return jf, tf, tps, tvs, rho, band, jt, tp


def test_banded_k5_density_matches_jax_density_compact():
    jf, tf, tps, _, _, band, jt, tp = _slab_shard(CALM)
    n, r = tps.shape[0], CALM.bucket_resolution
    want, wcert = pallas_compact.density_compact(
        jf, jnp.asarray(tps.numpy()), JPhys.from_config(JConfig(**_CALM)), r,
        n, jt, band=(jnp.int32(band[0]), band[1]))
    got, cert = compact.density_compact(tf, tps, tp, r, CAP, band=band)
    n_live = int(tf.start[-1])
    assert n_live < n
    np.testing.assert_allclose(got[:n_live].numpy(),
                               np.asarray(want)[:n_live], rtol=1e-5, atol=0)
    assert not got[n_live:].any()                     # dead rows: 0
    assert int(cert) == int(wcert) == 0


@pytest.mark.parametrize("ext", [pytest.param(False, marks=pytest.mark.slow),
                                 True])
def test_banded_k5_substep_matches_jax_compact_substep(ext):
    jf, tf, tps, tvs, rho, band, jt, tp = _slab_shard(CALM)
    n, r = tps.shape[0], CALM.bucket_resolution
    xs, al = (XSPH, ALPHA) if ext else (0.0, 0.0)
    moved = tps.clone()
    moved[100:111, 2] += 2.5 / (r - 1)          # past their tiles' band
    jrows = pallas_sph.pack_rows(jnp.asarray(moved.numpy()),
                                 jnp.asarray(tvs.numpy()),
                                 jnp.asarray(rho.numpy()), None, n, jt)
    out, wcert = pallas_compact.compact_substep(
        jf, jrows, JPhys.from_config(JConfig(**_CALM)), r, n, xsph=xs,
        alpha_visc=al, tune=jt, band=(jnp.int32(band[0]), band[1]))
    want = np.asarray(out).reshape(-1, sk.N_FIELDS)[:n]
    rows = sk.pack_rows(moved, tvs, rho)
    got, cert = compact.compact_substep(tf, rows, tp, r, CAP, xs, al,
                                        band=band)
    n_live = int(tf.start[-1])
    got = got.numpy()
    np.testing.assert_allclose(got[:n_live, 0:6], want[:n_live, 0:6],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:n_live, 6:8], want[:n_live, 6:8])
    np.testing.assert_array_equal(got[n_live:], rows[n_live:].numpy())
    assert int(cert) == int(wcert) > 0


# -------------------------------------------- JAX's contracts, on the port --

def _run(cfg, tune, frames, **kw):
    return make_rollout(cfg, frames, tune=tune, device="cpu", **kw)(
        initial_state(cfg, "cpu"))


@pytest.mark.parametrize("fused", [True, False])
def test_fuse_acc_matches_separate_accumulators(fused):
    # tests/test_pallas.py:252-280
    a, ma = _run(CALM, SortedTuning(fused=fused), 3)
    b, mb = _run(CALM, SortedTuning(fused=fused, fuse_acc=False), 3)
    np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), atol=1e-6)
    np.testing.assert_allclose(a.vel.numpy(), b.vel.numpy(), atol=1e-6)
    assert ma.exact_cert.tolist() == mb.exact_cert.tolist() == [0, 0, 0]
    assert torch.equal(ma.overflow, mb.overflow)


def test_fuse_acc_matches_separate_accumulators_extensions():
    # tests/test_pallas.py:283-300
    cfg = CALM.replace(xsph=0.1, artificial_viscosity=0.05)
    a, ma = _run(cfg, SortedTuning(), 1)
    b, mb = _run(cfg, SortedTuning(fuse_acc=False), 1)
    np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), atol=1e-6)
    np.testing.assert_allclose(a.vel.numpy(), b.vel.numpy(), atol=1e-6)
    assert ma.exact_cert.tolist() == mb.exact_cert.tolist()


@pytest.mark.parametrize("ext", [False, True])
def test_unfused_route_matches_fused(ext):
    # tests/test_pallas.py:198-247
    cfg = CALM.replace(xsph=0.1, artificial_viscosity=0.05) if ext else CALM
    frames = 1 if ext else 3
    a, ma = _run(cfg, SortedTuning(fused=True), frames)
    b, mb = _run(cfg, SortedTuning(fused=False), frames)
    np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), atol=1e-6)
    np.testing.assert_allclose(a.vel.numpy(), b.vel.numpy(), atol=1e-6)
    assert torch.equal(a.nan_count, b.nan_count)
    assert ma.exact_cert.tolist() == mb.exact_cert.tolist() == [0] * frames
    assert torch.equal(ma.overflow, mb.overflow)


def test_unfused_route_runs_the_forces_pass(monkeypatch):
    # no fused substep on the unfused route: the forces pass and
    # integrate_substep, five a frame, each on the frame-start density
    calls = []
    real = sk.forces_pass
    monkeypatch.setattr(sk, "forces_pass",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(sk, "fused_substep", None)
    _run(CALM, SortedTuning(fused=False), 2)
    assert len(calls) == 2 * CALM.substeps


@pytest.mark.parametrize("compact_route", [False, True])
def test_bf16_candidates_track_f32(compact_route):
    # tests/test_pallas.py:385-412
    a, ma = _run(CALM, SortedTuning(compact=compact_route), 2)
    b, mb = _run(CALM, SortedTuning(compact=compact_route, bf16=True), 2)
    assert torch.equal(ma.mean_density, mb.mean_density)
    assert ma.exact_cert.tolist() == mb.exact_cert.tolist() == [0, 0]
    assert torch.equal(ma.overflow, mb.overflow)
    np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), atol=5e-4)
    np.testing.assert_allclose(a.vel.numpy(), b.vel.numpy(), atol=5e-2)
    assert not torch.equal(a.pos, b.pos)


def test_kahan_accumulators_track_default():
    # tests/test_pallas.py:562-576
    a, ma = _run(CALM, SortedTuning(), 3)
    b, mb = _run(CALM, SortedTuning(kahan=True), 3)
    assert ma.exact_cert.tolist() == mb.exact_cert.tolist() == [0, 0, 0]
    np.testing.assert_allclose(b.pos.numpy(), a.pos.numpy(), atol=1e-5)


@pytest.mark.parametrize("d", [2, 4])
def test_compact_slab_matches_single_device(d):
    # tests/test_slab_pallas.py:97-131
    k5 = SortedTuning(compact=True)
    step, spec = make_pallas_slab_step(CALM, LocalRing(d), row_slack=4.0,
                                       tune=k5, device="cpu")
    phys = PhysParams.from_config(CALM)
    s0 = initial_state(CALM, "cpu")
    sst = distribute(s0, CALM, spec)
    for _ in range(3):
        sst, m = step(sst, phys)
    ref, mr = _run(CALM, k5, 3)
    out, lost = collect(sst, CALM.n_particles)
    assert int(m.exact_cert) == 0 == int(mr.exact_cert[-1])
    assert int(m.overflow) == int(mr.overflow[-1])
    assert lost == 0
    np.testing.assert_allclose(out.pos.numpy(), ref.pos.numpy(), atol=2e-5)
    np.testing.assert_allclose(out.vel.numpy(), ref.vel.numpy(), atol=2e-4)


# ---------------------------------------------------------------- rollouts --

ROLLOUT_TUNES = {"facc0": SortedTuning(fuse_acc=False),
                 "unfused": SortedTuning(fused=False),
                 "kahan": SortedTuning(kahan=True),
                 "bf16": SortedTuning(bf16=True),
                 "compact bf16": SortedTuning(compact=True, bf16=True),
                 "compact unfused": SortedTuning(compact=True, fused=False)}


@pytest.mark.parametrize("variant", sorted(ROLLOUT_TUNES))
def test_variant_rollout_equals_per_frame_stepping(variant):
    tune = ROLLOUT_TUNES[variant]
    cfg = SimConfig(**_GOLDENISH)
    s0 = initial_state(cfg, "cpu")
    a, ma = make_rollout(cfg, 2, tune=tune, device="cpu")(s0)
    step = make_frame_step(cfg, tune=tune, device="cpu")
    b = s0
    for k in range(2):
        b, mb = step(b)
        for x, y in zip(mb, ma):
            assert torch.equal(x, y[k])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ------------------------------------------------------- builds and names --

def test_variant_libraries_and_launch_tags():
    # each variant is its source compiled with its switches, in a library
    # of its own; a switch a source does not read builds nothing new, and
    # the launch counter names the variant
    base = {s: cuda_build.library_path(s) for s in cuda_build.KERNELS}
    cases = {"facc0": SortedTuning(fuse_acc=False),
             "kahan": SortedTuning(kahan=True),
             "bf16": SortedTuning(bf16=True)}
    for tag, tune in cases.items():
        for src, path in base.items():
            d = cuda_build.defines(src, tune)
            reads = {"facc0": "fuse_acc"}.get(tag, tag) in \
                cuda_build.SOURCE_SWITCHES[src]
            assert bool(d) == reads
            if reads:
                other = cuda_build.library_path(src, d)
                assert other != path and f"_{tag}_" in other.name
                assert sk.variant_tag(src, tune) == f"+{tag}"
            else:
                assert sk.variant_tag(src, tune) == ""
    assert cuda_build.defines("forces.cu", SortedTuning(
        kahan=True, bf16=True, fuse_acc=False)) == (
        "-DSPH_FACC=0", "-DSPH_KAHAN=1", "-DSPH_BF16=1")
    assert SortedTuning(compact=True, kahan=True).k5() == SortedTuning(
        compact=True, fuse_acc=False)


# ----------------------------------------------- the JAX rollouts (slow) --

def _jax_rollout(kw, frames, jt):
    from sphfluidsimulation_tpu.sim.stepper import (initial_state as jinit_st,
                                                    make_rollout as jroll)
    jc = JConfig(**kw)
    st, m = jroll(jc, frames, neighbor="pallas", pallas_tune=jt)(
        jinit_st(jc))
    return st, m


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["unfused", "kahan", "bf16", "facc0"])
def test_window_route_variant_tracks_jax_rollout(variant):
    fields = ({"fused": False} if variant == "unfused"
              else VARIANTS[variant])
    js, jm = _jax_rollout(_CALM, 2, PallasTuning(**fields, **JFAST))
    ts, tm = _run(CALM, SortedTuning(**fields), 2)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), atol=2e-6)
    np.testing.assert_allclose(ts.vel.numpy(), np.asarray(js.vel), atol=2e-4)
    assert tm.exact_cert.tolist() == np.asarray(jm.exact_cert).tolist()


@pytest.mark.slow
@pytest.mark.parametrize("fused", [True, False])
def test_compact_bf16_route_tracks_jax_rollout(fused):
    js, jm = _jax_rollout(_CALM, 2, PallasTuning(compact=True, bf16=True,
                                                 fused=fused, **JFAST))
    ts, tm = _run(CALM, SortedTuning(compact=True, bf16=True, fused=fused),
                  2)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), atol=2e-6)
    np.testing.assert_allclose(ts.vel.numpy(), np.asarray(js.vel), atol=2e-4)
    assert tm.exact_cert.tolist() == np.asarray(jm.exact_cert).tolist()


@pytest.mark.slow
def test_compact_slab_step_matches_jax_slab_step():
    # the JAX slab step on the compact route (its kernels in interpret
    # mode), CALM, two shards, one frame, from the same slab state
    from sphfluidsimulation_tpu.parallel import slab as jslab
    from sphfluidsimulation_tpu.parallel import slab_pallas as jsp
    from sphfluidsimulation_tpu.sim.stepper import initial_state as jinit_st
    jc = JConfig(**_CALM)
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    jt = PallasTuning(compact=True, **JFAST)
    jstep, jspec = jsp.make_pallas_slab_step(jc, mesh, row_slack=4.0,
                                             tune=jt)
    jst = jslab.distribute(jinit_st(jc), jc, jspec, mesh)
    jst, jm = jax.jit(jstep)(jst, JPhys.from_config(jc))
    step, spec = make_pallas_slab_step(CALM, LocalRing(2), row_slack=4.0,
                                       tune=SortedTuning(compact=True),
                                       device="cpu")
    assert tuple(spec) == tuple(jspec)
    sst = distribute(initial_state(CALM, "cpu"), CALM, spec)
    sst, m = step(sst, PhysParams.from_config(CALM))
    out, lost = collect(sst, CALM.n_particles)
    want, wlost = jslab.collect(jst, jc.n_particles)
    assert lost == wlost == 0
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(want.pos),
                               atol=2e-5)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(want.vel),
                               atol=2e-4)
    assert int(m.exact_cert) == 0 == int(jm.exact_cert)
    assert int(m.overflow) == int(jm.overflow)
