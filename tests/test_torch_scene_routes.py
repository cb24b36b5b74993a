"""The scene axis of K3 and K5 and the batched corrected step on the CPU.

JAX's config-5 sweep ``vmap``s the frame step whatever the route: under
``sweep --corrected`` and the unfused route ``forces_pallas`` (K3) runs with
the scene in front of its grid, and under ``SPH_PALLAS_COMPACT=1`` the
compact kernel (K5) does, each scene with its own drift certificate. The
port's counterparts are ``sph_kernels.forces_scenes`` and
``compact.density_compact_scenes``, ``compact_substep_scenes`` and
``forces_compact_scenes``; on the CPU they take the plain versions. These
tests hold, on 2-3 scenes of 512 particles at R = 9:

- each scene-axis plain version bit for bit to the solo plain version of
  each scene (K3 with and without the extension sums; K5 density, substep
  with and without them and forces, the drift counts integer-equal per
  scene), on sorted rows of which one scene's have drifted past their
  tiles' bands;
- ``jax.vmap(forces_pallas)`` and the ``jax.vmap`` of JAX's
  ``density_compact``, ``compact_substep`` and ``forces_compact`` (Pallas
  in interpret mode with tile groups of two 64-row tiles and no unroll, as
  tests/test_torch_batch.py runs the vmapped K1 and K2) on 2 calm scenes
  with different rest densities, within the tolerances of the solo tests
  (tests/test_torch_forces.py: forces scaled by their max |·| within 1e-6;
  tests/test_torch_compact.py: density 1e-5 relative, substep 1e-6
  absolute in position and velocity with ρ and the NaN count equal), the
  drift counts equal per scene;
- one frame of JAX's ``make_batched_step(base, neighbor="pallas",
  faithful=False)`` against the port's corrected batched step on the calm
  preset, within 2e-6 in position, the corrected-mode bound of
  tests/test_pallas.py:155-156 (tests/test_torch_extensions.py holds the
  solo corrected step to it): the same candidates, summed in another
  order, through six densities and five force passes (measured: 7.3e-12
  in position, 1.5e-8 in velocity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.ops import pallas_compact, pallas_sph
from sphfluidsimulation_tpu.ops.pallas_sph import PallasTuning
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_tpu.params import stack_params as jstack_params
from sphfluidsimulation_tpu.parallel.batch import (
    make_batched_step as jmake_batched_step)
from sphfluidsimulation_tpu.sim.stepper import initial_state as jinit
from sphfluidsimulation_tpu.state import ParticleState as JState
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import compact, sph_kernels as sk
from sphfluidsimulation_torch.ops.frame import build_frame_scenes, scene_frame
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning
from sphfluidsimulation_torch.params import PhysParams, stack_params
from sphfluidsimulation_torch.parallel import BatchedScenes
from sphfluidsimulation_torch.sim.stepper import initial_state
from sphfluidsimulation_torch.state import stack_states

# one intra-op thread, as in the port's other test modules
torch.set_num_threads(1)

_GOLDEN = dict(particle_number=512, bucket_resolution=9)
# tests/test_pallas.py:18-21 at the same size
_CALM = dict(particle_number=512, bucket_resolution=9, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
EXT = dict(xsph=0.3, artificial_viscosity=0.4)
CAP = 32
# the JAX kernels' tile geometry (tests/test_torch_batch.py)
JFAST = dict(tiles_per_group=2, unroll=1)
JCOMPACT = PallasTuning(fused=True, compact=True, **JFAST)
# two calm scenes with different rest densities (tests/test_torch_batch.py)
OVERRIDES = [{"rest_density": 1.5}, {"rest_density": 1.9}]
# sorted rows of scene 0 moved 2.5 cells up in z after the frame build:
# each past its tile's band (tests/test_torch_compact.py's drift)
DRIFTED = slice(100, 111)


def _same_bits(a, b):
    """Equal tensors, NaNs and signed zeros bit for bit."""
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


def _scaled_close(got, want, atol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


def _batch(base, overrides, seed=2, **ext):
    """The spawn positions of a batch, its frame over the scene axis, the
    sorted positions and random velocities, the frame-start density and
    the stacked params of both packages."""
    cfgs = [SimConfig(**base, **ext).replace(**ov) for ov in overrides]
    jp = jstack_params([JPhys.from_config(JConfig(**base, **ext)
                                          .replace(**ov))
                        for ov in overrides])
    tp = stack_params([PhysParams.from_config(c) for c in cfgs])
    states = stack_states([initial_state(c, "cpu") for c in cfgs])
    vel = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 0.2, tuple(states.pos.shape)).astype(np.float32))
    r = base["bucket_resolution"]
    frame, (pos_s, vel_s) = build_frame_scenes(states.pos, r, CAP,
                                               extras=(states.pos, vel))
    rho = sk.density_scenes(frame, pos_s, tp, r, CAP)
    return states.pos, frame, pos_s, vel_s, rho, jp, tp, r


def _drifted(pos_s, r):
    """Scene 0's sorted rows ``DRIFTED`` moved up 2.5 cells in z."""
    moved = pos_s.clone()
    moved[0, DRIFTED, 2] += 2.5 / (r - 1)
    return moved


# ------------------------------------------- plain versions, scene by scene --

@pytest.mark.parametrize("ext", [False, True])
def test_forces_scenes_plain_is_each_scene_alone(ext):
    kw = EXT if ext else {}
    _, frame, pos_s, vel_s, rho, _, tp, r = _batch(
        _GOLDEN, [{"rest_density": 1.0 + 0.4 * i, "seed": i}
                  for i in range(3)], **kw)
    rows = sk.pack_rows_scenes(pos_s, vel_s, rho)
    sums = sk.forces_scenes_plain(frame, rows, tp, r, CAP, ext)
    f, dv = sk.forces_scenes(frame, rows, tp, r, CAP, *kw.values())
    assert (dv is None) is not ext
    for s in range(3):
        fs, ph = scene_frame(frame, s), sk.scene_params(tp, s)
        _same_bits(sums[s], sk.forces_plain(fs, rows[s], ph, r, CAP, ext))
        f1, dv1 = sk.forces_pass(fs, rows[s], ph, r, CAP, *kw.values())
        _same_bits(f[s], f1)
        if ext:
            _same_bits(dv[s], dv1)


def test_compact_scenes_plain_are_each_scene_alone():
    _, frame, pos_s, vel_s, _, _, tp, r = _batch(
        _GOLDEN, [{"rest_density": 1.0 + 0.4 * i, "seed": i}
                  for i in range(3)])
    rho5, c0 = compact.density_compact_scenes(frame, pos_s, tp, r, CAP)
    rows = sk.pack_rows_scenes(_drifted(pos_s, r), vel_s, rho5)
    outs = {ext: compact.compact_substep_scenes(frame, rows, tp, r, CAP,
                                                *(EXT.values() if ext
                                                  else ()))
            for ext in (False, True)}
    f, cf = compact.forces_compact_scenes(frame, rows, tp, r, CAP)
    assert c0.tolist() == [0, 0, 0]
    assert cf.dtype == torch.int32 and cf.shape == (3,)
    for s in range(3):
        fs, ph = scene_frame(frame, s), sk.scene_params(tp, s)
        want, wc = compact.density_compact(fs, pos_s[s], ph, r, CAP)
        _same_bits(rho5[s], want)
        assert int(c0[s]) == int(wc)
        for ext, (out, c) in outs.items():
            want, wc = compact.compact_substep(
                fs, rows[s], ph, r, CAP, *(EXT.values() if ext else ()))
            _same_bits(out[s], want)
            assert int(c[s]) == int(wc)
        want, wc = compact.forces_compact(fs, rows[s], ph, r, CAP)
        _same_bits(f[s], want)
        assert int(cf[s]) == int(wc)
    # only scene 0 drifted: each scene counts its own rows
    assert int(cf[0]) > 0 and cf[1:].tolist() == [0, 0]
    for out, c in outs.values():
        _same_bits(c, cf)


# ---------------------------------------------------- against JAX's vmap --

@pytest.mark.parametrize("ext", [False, True])
def test_forces_scenes_matches_jax_vmapped_forces_pallas(ext):
    xs, al = (EXT["xsph"], EXT["artificial_viscosity"]) if ext else (0, 0)
    pos, frame, pos_s, vel_s, rho, jp, tp, r = _batch(
        _CALM, OVERRIDES, **(EXT if ext else {}))
    n = pos.shape[1]
    jt = PallasTuning(**JFAST)

    def forces(p, ps, vs, rho_s, phys):
        jf, _ = pallas_sph.build_frame(p, r, CAP, extras=(p,), tune=jt)
        return pallas_sph.forces_pallas(jf, ps, vs, rho_s, phys, r, n,
                                        xsph=xs, alpha_visc=al, tune=jt)

    f, dv, cert = jax.vmap(forces)(jnp.asarray(pos.numpy()),
                                   jnp.asarray(pos_s.numpy()),
                                   jnp.asarray(vel_s.numpy()),
                                   jnp.asarray(rho.numpy()), jp)
    assert np.asarray(cert).tolist() == [0, 0]
    rows = sk.pack_rows_scenes(pos_s, vel_s, rho)
    got_f, got_dv = sk.forces_scenes(frame, rows, tp, r, CAP, xs, al)
    for s in range(2):
        _scaled_close(got_f[s].numpy(), np.asarray(f)[s], 1e-6)
        if ext:
            _scaled_close(got_dv[s].numpy(), np.asarray(dv)[s], 1e-6)
    assert (got_dv is None) is (dv is None)


def _jax_frame(p, r):
    return pallas_sph.build_frame(p, r, CAP, extras=(p,), tune=JCOMPACT)[0]


def test_density_compact_scenes_matches_jax_vmapped_density_compact():
    pos, frame, pos_s, _, _, jp, tp, r = _batch(_CALM, OVERRIDES)
    n = pos.shape[1]

    def density(p, ps, phys):
        return pallas_compact.density_compact(_jax_frame(p, r), ps, phys, r,
                                              n, JCOMPACT)

    want, wcert = jax.vmap(density)(jnp.asarray(pos.numpy()),
                                    jnp.asarray(pos_s.numpy()), jp)
    got, cert = compact.density_compact_scenes(frame, pos_s, tp, r, CAP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=0)
    assert cert.tolist() == np.asarray(wcert).tolist() == [0, 0]


@pytest.mark.parametrize("ext", [False, True])
def test_compact_substep_scenes_matches_jax_vmapped_compact_substep(ext):
    xs, al = (EXT["xsph"], EXT["artificial_viscosity"]) if ext else (0, 0)
    pos, frame, pos_s, vel_s, rho, jp, tp, r = _batch(
        _CALM, OVERRIDES, **(EXT if ext else {}))
    n = pos.shape[1]
    moved = _drifted(pos_s, r)

    def substep(p, ps, vs, rho_s, phys):
        rows = pallas_sph.pack_rows(ps, vs, rho_s, None, n, JCOMPACT)
        out, cert = pallas_compact.compact_substep(
            _jax_frame(p, r), rows, phys, r, n, xsph=xs, alpha_visc=al,
            tune=JCOMPACT)
        return out.reshape(-1, sk.N_FIELDS)[:n], cert

    want, wcert = jax.vmap(substep)(
        jnp.asarray(pos.numpy()), jnp.asarray(moved.numpy()),
        jnp.asarray(vel_s.numpy()), jnp.asarray(rho.numpy()), jp)
    got, cert = compact.compact_substep_scenes(
        frame, sk.pack_rows_scenes(moved, vel_s, rho), tp, r, CAP, xs, al)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got[..., 0:6], want[..., 0:6], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got[..., 6:8], want[..., 6:8])
    assert cert.tolist() == np.asarray(wcert).tolist()
    assert int(cert[0]) > 0 and int(cert[1]) == 0


def test_forces_compact_scenes_matches_jax_vmapped_forces_compact():
    pos, frame, pos_s, vel_s, rho, jp, tp, r = _batch(_CALM, OVERRIDES)
    n = pos.shape[1]
    moved = _drifted(pos_s, r)

    def forces(p, ps, vs, rho_s, phys):
        return pallas_compact.forces_compact(_jax_frame(p, r), ps, vs, rho_s,
                                             phys, r, n, tune=JCOMPACT)

    want, dv, wcert = jax.vmap(forces)(
        jnp.asarray(pos.numpy()), jnp.asarray(moved.numpy()),
        jnp.asarray(vel_s.numpy()), jnp.asarray(rho.numpy()), jp)
    assert dv is None
    got, cert = compact.forces_compact_scenes(
        frame, sk.pack_rows_scenes(moved, vel_s, rho), tp, r, CAP)
    for s in range(2):
        _scaled_close(got[s].numpy(), np.asarray(want)[s], 1e-6)
    assert cert.tolist() == np.asarray(wcert).tolist()
    assert int(cert[0]) > 0 and int(cert[1]) == 0


# ------------------------------------------------ the corrected batched step --

def test_corrected_batch_matches_jax_vmapped_corrected_step(monkeypatch):
    # JAX's make_batched_step reads its kernels' tuning from the
    # environment: the tile geometry of the tests above
    monkeypatch.setenv("SPH_PALLAS_TPG", str(JFAST["tiles_per_group"]))
    monkeypatch.setenv("SPH_PALLAS_UNROLL", str(JFAST["unroll"]))
    jbase = JConfig(**_CALM)
    jcfgs = [jbase.replace(**ov) for ov in OVERRIDES]
    jstates = JState(*(jnp.stack(xs) for xs in zip(*(jinit(c)
                                                      for c in jcfgs))))
    jp = jstack_params([JPhys.from_config(c) for c in jcfgs])
    want, wm = jmake_batched_step(jbase, neighbor="pallas",
                                  faithful=False)(jstates, jp)
    bs = BatchedScenes(SimConfig(**_CALM), OVERRIDES, faithful=False,
                       tune=SortedTuning(), devices="cpu")
    bs.step()
    np.testing.assert_allclose(bs.states.pos.numpy(), np.asarray(want.pos),
                               rtol=0, atol=2e-6)
    np.testing.assert_array_equal(bs.last_metrics.overflow.numpy(),
                                  np.asarray(wm.overflow))
    np.testing.assert_allclose(bs.last_metrics.mean_density.numpy(),
                               np.asarray(wm.mean_density), rtol=1e-5)
    assert bs.last_metrics.exact_cert.tolist() == \
        np.asarray(wm.exact_cert).tolist() == [0, 0]
