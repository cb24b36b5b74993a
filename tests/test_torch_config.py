"""SimConfig, PhysParams and state of the torch port against the JAX
package: fields, derived values and the carry-across helpers."""

import numpy as np
import pytest
import torch

from sphfluidsimulation_tpu import config as jconfig
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_tpu.state import make_state as jmake_state
from sphfluidsimulation_torch import config as tconfig
from sphfluidsimulation_torch.params import PhysParams as TPhys
from sphfluidsimulation_torch.state import (make_state, state_from_numpy,
                                            state_to_numpy)

# CALM as in tests/test_pallas.py:18-20
_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
CONFIGS = {
    "golden": (jconfig.GOLDEN_CONFIG, tconfig.GOLDEN_CONFIG),
    "tiny": (jconfig.TINY_CONFIG, tconfig.TINY_CONFIG),
    "calm": (jconfig.SimConfig(**_CALM), tconfig.SimConfig(**_CALM)),
}
DERIVED = ("particle_number_pow2", "texture_resolution", "n_particles",
           "effective_radius", "particle_mass", "substep_dt", "n_cells")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_simconfig_matches_jax(name):
    jc, tc = CONFIGS[name]
    assert tc.as_dict() == jc.as_dict()
    for d in DERIVED:
        assert getattr(tc, d) == getattr(jc, d), d
    assert tc.validate() == tc
    assert tconfig.SimConfig.from_dict(jc.as_dict()) == tc


def test_constants_and_ranges_match_jax():
    for k in ("GRAVITY_Y", "REFERENCE_VOXEL_CAPACITY", "EPSILON"):
        assert getattr(tconfig, k) == getattr(jconfig, k)
    assert tconfig.SimConfig.INSPECTOR_RANGES == \
        jconfig.SimConfig.INSPECTOR_RANGES
    assert [f.name for f in tconfig.dataclasses.fields(tconfig.SimConfig)] \
        == [f.name for f in jconfig.dataclasses.fields(jconfig.SimConfig)]
    for bad in (dict(preset=3), dict(bucket_resolution=1), dict(substeps=0)):
        with pytest.raises(ValueError):
            jconfig.SimConfig(**bad).validate()
        with pytest.raises(ValueError):
            tconfig.SimConfig(**bad).validate()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_physparams_match_jax(name):
    jc, tc = CONFIGS[name]
    jp = JPhys.from_config(jc)
    tp = TPhys.from_config(tc)
    carried = TPhys.from_numpy({k: np.asarray(v)
                                for k, v in jp._asdict().items()})
    assert TPhys._fields == JPhys._fields
    for k in JPhys._fields:
        want = np.asarray(getattr(jp, k))
        for got in (getattr(tp, k), getattr(carried, k)):
            assert got.dtype == torch.float32 and got.ndim == 0
            assert got.numpy().tobytes() == want.tobytes(), k


def test_state_round_trip():
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 1, (257, 3)).astype(np.float32)
    vel = rng.normal(0, 1, (257, 3)).astype(np.float32)
    vel[3, 1] = np.inf
    nan = rng.integers(0, 9, 257).astype(np.int32)
    st = state_from_numpy(pos, vel, nan)
    assert st.n == 257 and st.nan_count.dtype == torch.int32
    for a, b in zip(state_to_numpy(st), (pos, vel, nan)):
        np.testing.assert_array_equal(a, b)
    # make_state zero-initialises velocity and NaN counts, as in JAX
    js = jmake_state(pos)
    ts = make_state(torch.from_numpy(pos))
    for a, b in zip(state_to_numpy(ts), js):
        np.testing.assert_array_equal(a, np.asarray(b))
