"""The torch port's sorted frame equals JAX ``pallas_sph.build_frame``
field for field: order, anchor cid, raw cid, occupancy and start table."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sphfluidsimulation_tpu.ops import grid as jgrid, pallas_sph
from sphfluidsimulation_tpu.models.presets import init_positions as jinit
from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_torch.ops.frame import build_frame

# one intra-op thread: the suite runs in several worker processes on
# shared cores, where each worker's spinning OpenMP threads slowed the
# port's many small CPU ops about fivefold
torch.set_num_threads(1)

FIELDS = ("order", "cid", "raw", "occ", "start")


def _compare(pos, r, cap, gid=None):
    extra = np.arange(pos.shape[0] * 2, dtype=np.float32).reshape(-1, 2)
    jf, (jx,) = pallas_sph.build_frame(
        jnp.asarray(pos), r, cap, extras=(jnp.asarray(extra),),
        gid=None if gid is None else jnp.asarray(gid))
    tf, (tx,) = build_frame(
        torch.from_numpy(pos), r, cap, extras=(torch.from_numpy(extra),),
        gid=None if gid is None else torch.from_numpy(gid))
    for f in FIELDS:
        got, want = getattr(tf, f).numpy(), np.asarray(getattr(jf, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    return tf


@pytest.mark.parametrize("cap", [4, 32, None])
def test_build_frame_matches_jax_out_of_cube_permuted_gid(cap):
    rng = np.random.default_rng(3)
    n, r = 700, 9
    # out-of-cube positions alias (raw != anchor) or fall out of range;
    # a corner cluster overflows small capacities
    pos = rng.uniform(-0.2, 1.25, (n, 3)).astype(np.float32)
    pos[:120] = rng.uniform(0.0, 0.1, (120, 3))
    gid = rng.permutation(n).astype(np.int32)
    tf = _compare(pos, r, cap, gid)
    assert bool((tf.raw != tf.cid).any())          # aliasing exercised
    if cap == 4:
        assert int((~tf.occ).sum()) > 0            # capacity drop exercised


def test_build_frame_matches_jax_on_golden_spawn():
    cfg = JConfig(particle_number=4096, bucket_resolution=17)
    tf = _compare(np.array(jinit(cfg)), 17, 32)
    # the canonical spawn reaches x ~ 1.2: out-of-range raw ids exist
    assert bool((tf.raw != tf.cid).any())


def test_capacity_ranks_match_grid_run_starts():
    # rank = index − start[cid] must equal index − grid.run_starts(cid)
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, 0.3, (900, 3)).astype(np.float32)
    tf, _ = build_frame(torch.from_numpy(pos), 5, 3)
    cid = tf.cid.numpy()
    rank = np.arange(900) - np.asarray(jgrid.run_starts(jnp.asarray(cid)))
    np.testing.assert_array_equal(tf.occ.numpy(), rank < 3)
    assert (rank >= 3).any()


def test_start_table_is_searchsorted():
    rng = np.random.default_rng(6)
    pos = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    tf, _ = build_frame(torch.from_numpy(pos), 7, 32)
    cid = tf.cid.numpy()
    np.testing.assert_array_equal(
        tf.start.numpy(), np.searchsorted(cid, np.arange(7 ** 3 + 1)))
    assert tf.start[-1] == 512
