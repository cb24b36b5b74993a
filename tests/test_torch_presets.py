"""Spawn presets, simplex noise and the elementwise SPH math of the torch
port against the JAX package, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.models.presets import init_positions as jinit
from sphfluidsimulation_tpu.ops import noise as jnoise, sph_math as jmath
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.models.presets import init_positions
from sphfluidsimulation_torch.ops import noise, sph_math


@pytest.mark.parametrize("preset", [0, 1, 2])
def test_presets_bit_equal_to_jax(preset):
    # float32 in the JAX version's operation order: bit equality
    kw = dict(particle_number=4096, bucket_resolution=17, preset=preset)
    want = np.asarray(jinit(JConfig(**kw)))
    got = init_positions(SimConfig(**kw)).numpy()
    np.testing.assert_array_equal(got, want)


def test_presets_seed_offset_bit_equal():
    kw = dict(particle_number=1024, bucket_resolution=11, seed=7)
    np.testing.assert_array_equal(init_positions(SimConfig(**kw)).numpy(),
                                  np.asarray(jinit(JConfig(**kw))))


def test_snoise4_bit_equal_to_jax():
    rng = np.random.default_rng(11)
    v = rng.uniform(-60.0, 400.0, (4096, 4)).astype(np.float32)
    np.testing.assert_array_equal(noise.snoise4(torch.from_numpy(v)).numpy(),
                                  np.asarray(jnoise.snoise4(v)))


def test_sph_math_matches_jax():
    rng = np.random.default_rng(2)
    h = np.float32(1 / 46)
    r = rng.uniform(0, 1.2 * h, 2000).astype(np.float32)
    r[:3] = [0.0, h, 1e-7]
    h2, h6, h9 = h * h, h ** 6, h ** 9

    def t(a):
        return torch.tensor(np.asarray(a))

    for got, want in (
            (sph_math.w_poly6(t(r * r), t(h2), t(h9)),
             jmath.w_poly6(r * r, h2, h9)),
            (sph_math.grad_w_press_over_r(t(r), t(h), t(h6)),
             jmath.grad_w_press_over_r(r, h, h6)),
            (sph_math.grad_w_vis_r(t(r), t(h), t(h6)),
             jmath.grad_w_vis_r(r, h, h6))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    pos = rng.uniform(-0.05, 1.05, (512, 3)).astype(np.float32)
    vel = rng.normal(0, 3, (512, 3)).astype(np.float32)
    vel[7, 2] = np.inf
    args = (h, np.float32(5000.0), np.float32(10.0), np.float32(3e-6))
    got = sph_math.wall_force(t(pos), t(vel), *(t(a) for a in args)).numpy()
    want = np.asarray(jmath.wall_force(pos, vel, *args))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_cell_index_truncates_like_jax():
    # toward zero for negatives, saturating, NaN -> 0 (XLA's convert)
    x = np.array([[-0.5, 0.0, 0.99999], [1.02, np.nan, -3e9],
                  [4e9, -0.0, 0.5]], np.float32)
    np.testing.assert_array_equal(
        sph_math.cell_index(torch.from_numpy(x), 47).numpy(),
        np.asarray(jmath.cell_index(jnp.asarray(x), 47)))
