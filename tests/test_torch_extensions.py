"""The torch port's XSPH / artificial-viscosity path and its corrected mode
against the JAX package: K2 with extensions (plain version) against JAX
``fused_substep`` on the flat and the in-kernel-worklist (K4) tunings, and
whole frames against the JAX brute and slotted oracles."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.models.presets import init_positions as jinit
from sphfluidsimulation_tpu.ops import pallas_sph
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_tpu.sim.stepper import (initial_state as jstate,
                                                make_frame_step as jstep)
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import sph_kernels as sk
from sphfluidsimulation_torch.ops.frame import build_frame
from sphfluidsimulation_torch.params import PhysParams
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
CAP = 32
XSPH, ALPHA = 0.3, 0.4
_EXT = dict(_CALM, xsph=XSPH, artificial_viscosity=ALPHA)


def _jax_frames(kw, frames, **step_kw):
    step = jax.jit(jstep(JConfig(**kw), **step_kw))
    s = jstate(JConfig(**kw))
    ms = []
    for _ in range(frames):
        s, m = step(s)
        ms.append(m)
    return s, ms


# each JAX fused_substep call in interpret mode costs 20-40 s on the CPU,
# whatever the particle count (256 to 1,024 measured), so the K4 case is
# marked slow; tests/test_pallas.py:473 pins K4 bit-identical to the flat
# kernel of the first case
@pytest.mark.parametrize("tuning", [
    "flat", pytest.param("iki", marks=pytest.mark.slow)])
def test_fused_substep_with_extensions_matches_jax(tuning):
    """K2 with the extension sums against JAX ``fused_substep``. The "iki"
    case is the JAX K4 kernel (``_call_iki``: each tile's worklist derived
    in-kernel from ``start[]``), which the port's K2 already is: every
    thread walks ``start[]`` itself. Tolerance: positions and velocities
    within 1e-6 (tests/test_pallas.py:218-221), ρ and NaN lanes equal."""
    jc = JConfig(**_CALM)
    jp, tp = JPhys.from_config(jc), PhysParams.from_config(SimConfig(**_CALM))
    r, n = jc.bucket_resolution, jc.n_particles
    pos = np.array(jinit(jc))
    vel = np.random.default_rng(2).normal(0, 0.2, (n, 3)).astype(np.float32)
    tf, (tps, tvs) = build_frame(torch.from_numpy(pos), r, CAP,
                                 extras=(torch.from_numpy(pos),
                                         torch.from_numpy(vel)))
    rho = sk.density_plain(tf, tps, tp, r, CAP)
    jf, (ps, vs) = pallas_sph.build_frame(
        jnp.asarray(pos), r, CAP, extras=(jnp.asarray(pos), jnp.asarray(vel)))
    tune = pallas_sph.PallasTuning(fused=True, flat=True,
                                   iki=tuning == "iki")
    rows = pallas_sph.pack_rows(ps, vs, jnp.asarray(rho.numpy()), None, n,
                                tune)
    out, cert = pallas_sph.fused_substep(jf, rows, jp, r, n, xsph=XSPH,
                                         alpha_visc=ALPHA, tune=tune)
    assert int(cert) == 0
    jpos, jvel, jrho, jnan = (np.asarray(a)
                              for a in pallas_sph.unpack_rows(out, n))
    tpos, tvel, trho, tnan = sk.unpack_rows(sk.fused_substep(
        tf, sk.pack_rows(tps, tvs, rho), tp, r, CAP, XSPH, ALPHA))
    np.testing.assert_allclose(tpos.numpy(), jpos, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tvel.numpy(), jvel, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(trho.numpy(), jrho)
    np.testing.assert_array_equal(tnan.numpy(), jnan)
    # the extensions matter at this tolerance
    plain = sk.unpack_rows(sk.fused_substep(tf, sk.pack_rows(tps, tvs, rho),
                                            tp, r, CAP))
    assert np.abs(plain[1].numpy() - jvel).max() > 1e-4


def test_faithful_extensions_track_jax_brute():
    # one frame, atol 1e-5: the bound of tests/test_extensions.py:92
    sb, (mb,) = _jax_frames(_EXT, 1, neighbor="brute")
    cfg = SimConfig(**_EXT)
    st, m = make_frame_step(cfg, device="cpu")(initial_state(cfg, "cpu"))
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(sb.pos), rtol=0,
                               atol=1e-5)
    assert float(m.mean_density) == pytest.approx(float(mb.mean_density),
                                                  rel=1e-5)
    assert int(m.exact_cert) == 0


def test_corrected_mode_matches_jax_slotted():
    # tests/test_pallas.py:141-158: 3 frames, atol 2e-6, mean density 1e-5
    ss, ms = _jax_frames(_CALM, 3, neighbor="slotted", faithful=False)
    cfg = SimConfig(**_CALM)
    final, m = make_rollout(cfg, 3, faithful=False, device="cpu")(
        initial_state(cfg, "cpu"))
    np.testing.assert_allclose(final.pos.numpy(), np.asarray(ss.pos),
                               rtol=0, atol=2e-6)
    assert float(m.mean_density[-1]) == pytest.approx(
        float(ms[-1].mean_density), rel=1e-5)
    assert m.overflow.tolist() == [int(x.overflow) for x in ms]
    assert m.exact_cert.tolist() == [0, 0, 0]


def test_corrected_extensions_track_jax_brute():
    """Corrected mode with both extensions against JAX brute, 3 frames.
    Measured on this CPU: max |Δpos| 1.8e-7 after 3 frames; the bound, 2e-6,
    is the corrected-mode bound of tests/test_pallas.py:155-156."""
    sb, mb = _jax_frames(_EXT, 3, neighbor="brute", faithful=False)
    cfg = SimConfig(**_EXT)
    final, m = make_rollout(cfg, 3, faithful=False, device="cpu")(
        initial_state(cfg, "cpu"))
    np.testing.assert_allclose(final.pos.numpy(), np.asarray(sb.pos),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(final.vel.numpy(), np.asarray(sb.vel),
                               rtol=0, atol=2e-5)
    assert m.overflow.tolist() == [int(x.overflow) for x in mb]
    assert np.asarray(sb.nan_count).sum() == int(final.nan_count.sum()) == 0


@pytest.mark.parametrize("faithful", [True, False])
def test_sorted_tracks_the_port_brute_with_extensions(faithful):
    # the on-card oracle check of chip_smoke.py, here on the CPU: 1k calm
    # with both extensions, 3 frames, within 1e-5 of the port's own brute
    cfg = SimConfig(**_EXT)
    st = initial_state(cfg, "cpu")
    a, ma = make_rollout(cfg, 3, faithful=faithful, device="cpu")(st)
    b, mb = make_rollout(cfg, 3, neighbor="brute", faithful=faithful,
                         device="cpu")(st)
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=1e-5)
    assert torch.equal(ma.overflow, mb.overflow)
    assert float(ma.mean_density[0]) == pytest.approx(
        float(mb.mean_density[0]), rel=1e-5)


def test_corrected_frame_builds_once_more_than_its_substeps(monkeypatch):
    # each corrected frame builds 1 + substeps frames: the extra frame-start
    # build gives the metrics' rho and overflow, as JAX's corrected branch
    import sphfluidsimulation_torch.sim.stepper as stepper
    cfg = SimConfig(**_EXT)
    calls = []
    real = stepper.build_frame
    monkeypatch.setattr(stepper, "build_frame",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    st, m = make_frame_step(cfg, faithful=False, device="cpu")(
        initial_state(cfg, "cpu"))
    assert len(calls) == 1 + cfg.substeps
    assert int(m.exact_cert) == 0 and m.overflow.dtype == torch.int32
    assert bool(((st.pos >= 0) & (st.pos <= 1)).all())


def _slotted_inputs(seed=5):
    """A 1k calm cloud's bucket, frame-start density and packed slots, in
    both packages."""
    from sphfluidsimulation_tpu.ops import cellops as jcell
    from sphfluidsimulation_tpu.ops.grid import build_bucket as jbucket
    from sphfluidsimulation_torch.ops import cellops
    from sphfluidsimulation_torch.ops.grid import build_bucket
    jc = JConfig(**_CALM)
    r, n = jc.bucket_resolution, jc.n_particles
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, 0.6, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    tp = PhysParams.from_config(SimConfig(**_CALM))
    tb, _ = build_bucket(torch.from_numpy(pos), r, CAP)
    rho = cellops.density_grid(torch.from_numpy(pos), tb, CAP, tp, r)
    slots = cellops.pack_slots(tb.table, CAP, n, torch.from_numpy(pos),
                               torch.from_numpy(vel), rho)
    jb, _ = jbucket(jnp.asarray(pos), r, CAP)
    jslots = jcell.pack_slots(jb.table, CAP, n, jnp.asarray(pos),
                              jnp.asarray(vel), jnp.asarray(rho.numpy()))
    return (pos, vel, rho, slots, tp), (jslots, JPhys.from_config(jc)), r


@pytest.mark.parametrize("term", ["xsph", "avisc"])
def test_slotted_extension_sums_match_jax(term):
    """``xsph_slotted`` and ``artificial_viscosity_slotted`` against JAX's
    on the same packed slots: within 1e-6 of the largest term (both sum the
    same terms per window offset in the same offset order)."""
    from sphfluidsimulation_tpu.ops import extensions as jext
    from sphfluidsimulation_torch.ops import extensions as text
    (pos, vel, rho, slots, tp), (jslots, jp), r = _slotted_inputs()
    args = (torch.from_numpy(pos), torch.from_numpy(vel), rho, slots, CAP,
            tp, r)
    jargs = (jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rho.numpy()),
             jslots, CAP, jp, r)
    fn, jfn, coef = {"xsph": (text.xsph_slotted, jext.xsph_slotted, XSPH),
                     "avisc": (text.artificial_viscosity_slotted,
                               jext.artificial_viscosity_slotted, ALPHA)}[
        term]
    got, want = fn(*args, coef).numpy(), np.asarray(jfn(*jargs, coef))
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-6)


@pytest.mark.parametrize("overrides", [
    {"xsph": 0.5},
    {"artificial_viscosity": 0.3},
    {"xsph": 0.3, "artificial_viscosity": 0.2},
])
def test_slotted_extensions_track_the_port_brute(overrides):
    # tests/test_extensions.py:26-41 on the port: the slotted frame step
    # with the extensions against the port's brute oracle, one frame, atol
    # 1e-5, mean density within 1e-5; and against JAX's slotted step
    cfg = SimConfig(**_CALM).replace(**overrides)
    st = initial_state(cfg, "cpu")
    ss, ms = make_frame_step(cfg, neighbor="slotted", device="cpu")(st)
    sb, mb = make_frame_step(cfg, neighbor="brute", device="cpu")(st)
    np.testing.assert_allclose(ss.pos.numpy(), sb.pos.numpy(), atol=1e-5)
    assert float(ms.mean_density) == pytest.approx(float(mb.mean_density),
                                                   rel=1e-5)
    js, _ = _jax_frames(dict(_CALM, **overrides), 1, neighbor="slotted")
    np.testing.assert_allclose(ss.pos.numpy(), np.asarray(js.pos), atol=1e-6)
