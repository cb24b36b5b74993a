"""The torch port's reference bucket and O(N²) oracles against the JAX
package: ``grid.build_bucket`` integer for integer, the brute density and
forces, and the XSPH / artificial-viscosity oracles, on finite and on ±inf
velocities."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.models.presets import init_positions as jinit
from sphfluidsimulation_tpu.ops import brute as jbrute
from sphfluidsimulation_tpu.ops import extensions as jext
from sphfluidsimulation_tpu.ops import grid as jgrid
from sphfluidsimulation_tpu.ops import sph_math as jmath
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_tpu.sim.stepper import (initial_state as jstate,
                                                make_frame_step as jstep)
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import brute, extensions, grid, sph_math
from sphfluidsimulation_torch.params import PhysParams
from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                  make_frame_step)

# one intra-op thread: the suite runs in several worker processes on
# shared cores, where each worker's spinning OpenMP threads slowed the
# port's many small CPU ops about fivefold
torch.set_num_threads(1)

_GOLDENISH = dict(particle_number=1024, bucket_resolution=11)
CAP = 32
t = torch.from_numpy


@pytest.mark.parametrize("cap", [4, 32, None])
def test_build_bucket_matches_jax(cap):
    rng = np.random.default_rng(5)
    n, r = 700, 9
    # out-of-cube positions alias or fall out of range; a corner cluster
    # overflows small capacities
    pos = rng.uniform(-0.2, 1.25, (n, 3)).astype(np.float32)
    pos[:120] = rng.uniform(0.0, 0.1, (120, 3))
    jb, jcap = jgrid.build_bucket(jnp.asarray(pos), r, cap)
    tb, tcap = grid.build_bucket(t(pos), r, cap)
    assert tcap == jcap
    for f in grid.Bucket._fields:
        got, want = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert int(grid.overflow_count(tb)) == int(jgrid.overflow_count(jb))
    np.testing.assert_array_equal(grid.neighborhood_offsets().numpy(),
                                  np.asarray(jgrid.neighborhood_offsets()))


def _oracle_inputs(vel_fn=None):
    jc = JConfig(**_GOLDENISH)
    jp, tp = JPhys.from_config(jc), PhysParams.from_config(
        SimConfig(**_GOLDENISH))
    r, n = jc.bucket_resolution, jc.n_particles
    pos = np.array(jinit(jc))
    vel = np.random.default_rng(0).normal(0, 0.2, (n, 3)).astype(np.float32)
    if vel_fn is not None:
        vel_fn(vel)
    jb, _ = jgrid.build_bucket(jnp.asarray(pos), r, CAP)
    tb, _ = grid.build_bucket(t(pos), r, CAP)
    return jp, tp, r, pos, vel, jb, tb


def _j_mask(pos, jb, r):
    return jbrute._window_mask(jmath.cell_index(jnp.asarray(pos), r),
                               jb.cell_id, jb.in_table, r)


def _t_mask(pos, tb, r):
    return brute.window_mask(sph_math.cell_index(t(pos), r), tb.cell_id,
                             tb.in_table, r)


def _all_oracles(vel_fn=None):
    jp, tp, r, pos, vel, jb, tb = _oracle_inputs(vel_fn)
    jpos, jvel = jnp.asarray(pos), jnp.asarray(vel)
    jrho = jbrute.density_bruteforce(jpos, jb.cell_id, jb.in_table, jp, r)
    trho = brute.density_bruteforce(t(pos), tb.cell_id, tb.in_table, tp, r)
    # the same density on both sides, so each force oracle is held alone
    rho = np.array(jrho)
    jm, tm = _j_mask(pos, jb, r), _t_mask(pos, tb, r)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = {
        "forces": jbrute.fluid_forces_bruteforce(
            jpos, jvel, jnp.asarray(rho), jb.cell_id, jb.in_table, jp, r),
        "xsph": jext.xsph_bruteforce(jpos, jvel, jnp.asarray(rho), jm, jp,
                                     0.3),
        "avisc": jext.artificial_viscosity_bruteforce(
            jpos, jvel, jnp.asarray(rho), jm, jp, 0.4)}
    got = {
        "forces": brute.fluid_forces_bruteforce(
            t(pos), t(vel), t(rho), tb.cell_id, tb.in_table, tp, r),
        "xsph": extensions.xsph_bruteforce(t(pos), t(vel), t(rho), tm, tp,
                                           0.3),
        "avisc": extensions.artificial_viscosity_bruteforce(
            t(pos), t(vel), t(rho), tm, tp, 0.4)}
    return (trho.numpy(), np.asarray(jrho),
            {k: (got[k].numpy(), np.asarray(want[k])) for k in want})


def test_brute_oracles_match_jax():
    # density rtol 1e-5; forces and extension terms scaled by their max |·|
    # within 1e-6 (tests/test_pallas.py:80-82)
    trho, jrho, pairs = _all_oracles()
    np.testing.assert_allclose(trho, jrho, rtol=1e-5, atol=0)
    for name, (got, want) in pairs.items():
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=1e-6, err_msg=name)


def test_brute_oracles_match_jax_on_inf_velocities():
    # the NaN / ±inf pattern of every oracle equals JAX's element for
    # element (the extension oracles keep the self pair, so inf − inf
    # reaches them, as in JAX); finite entries within 1e-5 scaled
    def plant(vel):
        vel[::37, 0] = np.inf
        vel[5::53, 1] = -np.inf

    _, _, pairs = _all_oracles(plant)
    for name, (got, want) in pairs.items():
        for pred in (np.isnan, np.isposinf, np.isneginf):
            np.testing.assert_array_equal(pred(got), pred(want),
                                          err_msg=name)
        assert not np.isfinite(want).all(), name
        fin = np.isfinite(want)
        if fin.any():
            scale = np.abs(want[fin]).max()
            np.testing.assert_allclose(got[fin] / scale, want[fin] / scale,
                                       rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("faithful", [True, False])
def test_brute_step_with_extensions_matches_jax(faithful):
    # the whole brute frame (bucket, density, forces, both extensions,
    # integration) on the violent golden-ish spawn: atol 1e-5 on positions,
    # overflow and NaN traps equal
    kw = dict(_GOLDENISH, xsph=0.3, artificial_viscosity=0.4)
    sb, mb = jax.jit(jstep(JConfig(**kw), neighbor="brute",
                           faithful=faithful))(jstate(JConfig(**kw)))
    cfg = SimConfig(**kw)
    st, m = make_frame_step(cfg, neighbor="brute", faithful=faithful,
                            device="cpu")(initial_state(cfg, "cpu"))
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(sb.pos), rtol=0,
                               atol=1e-5)
    assert int(m.overflow) == int(mb.overflow)
    np.testing.assert_array_equal(st.nan_count.numpy(),
                                  np.asarray(sb.nan_count))
    assert float(m.mean_density) == pytest.approx(float(mb.mean_density),
                                                  rel=1e-5)
