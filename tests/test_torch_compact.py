"""The compact-lane route (K5, ``ops/compact.py``) against the JAX package's
v7 compact kernels (``pallas_compact.py``, Pallas in interpret mode, as the
JAX tests run it) and against the port's own window route (K1/K2/K3).

A line-for-line Python mirror of the kernel's tile stream (cell-level line
dedup, the slot segments, each round stopped at the first slot past its
cell's capacity) must process, for every tile, exactly each union cell's
capacity-cut prefix, in ascending order, and so every occupied slot of the
``tile_segments`` union.

On the CPU each K5 wrapper runs its plain version; the CUDA kernel is held
against that plain version on the card by tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.models.presets import init_positions as jinit
from sphfluidsimulation_tpu.ops import pallas_compact, pallas_sph
from sphfluidsimulation_tpu.ops.pallas_sph import PallasTuning
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_torch import Scene, cli
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import compact, sph_kernels as sk
from sphfluidsimulation_torch.ops.frame import build_frame
from sphfluidsimulation_torch.ops.sph_kernels import (SortedTuning,
                                                      default_tuning)
from sphfluidsimulation_torch.params import PhysParams
from sphfluidsimulation_torch.sim.stepper import initial_state, make_rollout

# one intra-op thread: the suite runs in several worker processes on
# shared cores, where each worker's spinning OpenMP threads slowed the
# port's many small CPU ops about fivefold
torch.set_num_threads(1)

# tests/test_pallas.py:18-21; the canonical spawn of GOLDENISH holds
# out-of-cube rows
_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
_GOLDENISH = dict(particle_number=1024, bucket_resolution=11)
CONFIGS = {"calm": _CALM, "goldenish": _GOLDENISH}
CAP = 32
JTUNE = PallasTuning(fused=True, compact=True)
# sorted rows moved 2.5 cells up in z after the frame build: eleven rows of
# the calm dam, each past its tile's band
DRIFTED = slice(100, 111)
COMPACT = SortedTuning(compact=True)


def _positions(name, n=None):
    cfg = JConfig(**CONFIGS[name])
    pos = np.array(jinit(cfg))
    return pos if n is None else pos[:n].copy()


def _phys(name):
    return (JPhys.from_config(JConfig(**CONFIGS[name])),
            PhysParams.from_config(SimConfig(**CONFIGS[name])))


def _frames(pos, r):
    """The JAX and the port's frame of the same positions (sorted alike)."""
    jf, (jps,) = pallas_sph.build_frame(jnp.asarray(pos), r, CAP,
                                        extras=(jnp.asarray(pos),),
                                        tune=JTUNE)
    tf, (tps,) = build_frame(torch.from_numpy(pos), r, CAP,
                             extras=(torch.from_numpy(pos),))
    np.testing.assert_array_equal(np.asarray(jps), tps.numpy())
    return jf, tf, tps.numpy()


def _drifted(pos_s, r):
    moved = pos_s.copy()
    moved[DRIFTED, 2] += 2.5 / (r - 1)
    return moved


@pytest.mark.parametrize("case", ["calm", "goldenish", "drift", "ragged"])
def test_spans_and_drift_match_jax(case):
    name = "goldenish" if case in ("goldenish", "ragged") else "calm"
    pos = _positions(name, 1000 if case == "ragged" else None)
    n, r = pos.shape[0], CONFIGS[name]["bucket_resolution"]
    jf, tf, pos_s = _frames(pos, r)
    fresh = _drifted(pos_s, r) if case == "drift" else pos_s

    want = np.asarray(pallas_compact.stale_spans(jf, n, r, JTUNE))
    got = compact.stale_spans(tf)
    t = compact.n_tiles(n)
    assert got.shape == (t, 2) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want[:t])
    assert (want[t:] >= r ** 3).all()          # JAX's pad tiles are dead

    wspans, wdrift = pallas_compact.fresh_spans(
        jf, jnp.asarray(want), jnp.asarray(fresh), n, r, JTUNE)
    spans, drift = compact.fresh_spans(got, torch.from_numpy(fresh), r)
    np.testing.assert_array_equal(spans.numpy(), np.asarray(wspans)[:t])
    assert drift.dtype == torch.int32
    assert int(drift) == int(wdrift)
    assert int(drift) == (11 if case == "drift" else 0)


def test_tile_segments_hold_each_line_slot_once():
    # the nine deduplicated segments are disjoint, increasing, and their
    # union is the union of the nine raw line ranges
    pos = _positions("goldenish")
    r = 11
    _, tf, pos_s = _frames(pos, r)
    spans, _ = compact.fresh_spans(compact.stale_spans(tf),
                                   torch.from_numpy(_drifted(pos_s, r)), r)
    a, b = compact.tile_segments(spans, tf.start, r)
    assert a.shape == b.shape == (compact.n_tiles(pos.shape[0]), 9)
    start = tf.start.numpy()
    for t in range(a.shape[0]):
        lo, hi = spans[t].tolist()
        want = set()
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                off = dz * r * r + dy * r
                qa = min(max(lo + off - 1, 0), r ** 3)
                qb = min(max(hi + off + 2, 0), r ** 3)
                want.update(range(start[qa], start[qb]))
        got = [j for k in range(9) for j in range(a[t, k], b[t, k])]
        assert got == sorted(want)              # once each, in sorted order


# ---------------------------------------------------- the kernel's stream --

def _k5_stream(start, cid, occ, lo, hi, r, cap):
    """compact.cu's stream for one tile with span [lo, hi], line for line:
    (the slots its lanes process, in order; the union's cells). ``cap`` < 0
    streams each cell uncut."""
    s_cells = r ** 3
    segs, union, cb_run = [], [], 0
    for k in range(9):                  # lanes 0-8: the cell-level dedup
        off = (k // 3 - 1) * r * r + (k % 3 - 1) * r
        a = min(max(lo + off - 1, 0), s_cells)
        b = min(max(hi + off + 2, 0), s_cells)
        a, cb_run = max(a, cb_run), max(cb_run, a, b)
        segs.append((start[a], start[cb_run]))
        union += range(a, cb_run)
    out = []
    for base, seg_end in segs:
        while base < seg_end:           # one round: lanes 0-31
            stop, skip_to = 32, base + 32
            for lane in range(32):      # the first lane past its capacity
                j = base + lane
                if (j < seg_end and not occ[j] and cap >= 0
                        and j - start[cid[j]] >= cap):
                    stop, skip_to = lane, start[cid[j] + 1]
                    break
            out += [j for j in range(base, base + stop) if j < seg_end]
            base = skip_to
    return out, union


@functools.lru_cache(maxsize=None)
def _stream_scene(scene, cap):
    """(frame, sorted positions, R): ``calm@3`` and ``goldenish@3`` after
    three faithful frames, ``goldenish@0`` the canonical spawn (raw ids of
    out-of-cube rows alias), the frame built with capacity ``cap``."""
    name, frames = scene.split("@")
    cfg = SimConfig(**CONFIGS[name])
    st = initial_state(cfg, "cpu")
    if int(frames):
        st, _ = make_rollout(cfg, int(frames), device="cpu")(st)
    r = cfg.bucket_resolution
    tf, (ps,) = build_frame(st.pos, r, cap, extras=(st.pos,))
    return tf, ps, r


@pytest.mark.parametrize("spans_of", ["stale", "fresh"])
@pytest.mark.parametrize("cap", [4, CAP, None])
@pytest.mark.parametrize("scene", ["calm@3", "goldenish@3", "goldenish@0"])
def test_kernel_stream_reads_each_tiles_occupied_union_slots(scene, cap,
                                                             spans_of):
    tf, ps, r = _stream_scene(scene, cap)
    spans = compact.stale_spans(tf)
    if spans_of == "fresh":             # rows drifted past their band
        moved = ps.clone()
        moved[DRIFTED, 2] += 2.5 / (r - 1)
        spans, drift = compact.fresh_spans(spans, moved, r)
        assert int(drift) > 0
    a, b = compact.tile_segments(spans, tf.start, r)
    counts = compact.stream_slots(spans, tf.start, r, cap)
    start, cid, occ = tf.start.tolist(), tf.cid.tolist(), tf.occ.tolist()
    kcap = -1 if cap is None else cap
    shorter = 0
    for t, (lo, hi) in enumerate(spans.tolist()):
        seg = [j for k in range(9) for j in range(a[t, k], b[t, k])]
        got, union = _k5_stream(start, cid, occ, lo, hi, r, kcap)
        uncut, _ = _k5_stream(start, cid, occ, lo, hi, r, -1)
        assert uncut == seg                 # the uncut stream is the union
        # each union cell's capacity-cut prefix, in order, and nothing else
        prefixes = [j for c in union
                    for j in range(start[c], start[c + 1]
                                   if kcap < 0 else
                                   min(start[c + 1], start[c] + kcap))]
        assert got == prefixes
        assert [j for j in got if occ[j]] == [j for j in seg if occ[j]]
        assert len(got) == int(counts[t])
        overflows = kcap >= 0 and any(start[c + 1] - start[c] > kcap
                                      for c in union)
        assert (len(got) < len(uncut)) == overflows
        shorter += overflows
    # a cell holding more rows than the capacity shortens its tile's stream
    if cap is not None and bool((tf.start[1:] - tf.start[:-1] > cap).any()):
        assert shorter > 0
    assert cap != 4 or scene == "calm@3" or shorter > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_density_matches_jax_density_compact(name):
    jp, tp = _phys(name)
    pos = _positions(name)
    n, r = pos.shape[0], CONFIGS[name]["bucket_resolution"]
    jf, tf, pos_s = _frames(pos, r)
    want, wcert = pallas_compact.density_compact(jf, jnp.asarray(pos_s), jp,
                                                 r, n, JTUNE)
    got, cert = compact.density_compact(tf, torch.from_numpy(pos_s), tp, r,
                                        CAP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=0)
    assert int(cert) == int(wcert) == 0


def _drifted_rows(name="calm"):
    """(jf, tf, JAX rows, port rows, n, r): the frame-start density with
    eleven rows drifted past their band, random velocities."""
    jp, tp = _phys(name)
    pos = _positions(name)
    n, r = pos.shape[0], CONFIGS[name]["bucket_resolution"]
    jf, tf, pos_s = _frames(pos, r)
    rho = sk.density_plain(tf, torch.from_numpy(pos_s), tp, r, CAP)
    vel = np.random.default_rng(0).normal(0, 0.2, (n, 3)).astype(np.float32)
    moved = _drifted(pos_s, r)
    jrows = pallas_sph.pack_rows(jnp.asarray(moved), jnp.asarray(vel),
                                 jnp.asarray(rho.numpy()), None, n, JTUNE)
    trows = sk.pack_rows(torch.from_numpy(moved), torch.from_numpy(vel), rho)
    return jp, tp, jf, tf, jrows, trows, n, r


@pytest.mark.parametrize("xsph,alpha", [(0.0, 0.0), (0.3, 0.4)])
def test_substep_matches_jax_compact_substep(xsph, alpha):
    jp, tp, jf, tf, jrows, trows, n, r = _drifted_rows()
    out, wcert = pallas_compact.compact_substep(
        jf, jrows, jp, r, n, xsph=xsph, alpha_visc=alpha, tune=JTUNE)
    want = np.asarray(out).reshape(-1, sk.N_FIELDS)[:n]
    got, cert = compact.compact_substep(tf, trows, tp, r, CAP, xsph, alpha)
    got = got.numpy()
    np.testing.assert_allclose(got[:, 0:3], want[:, 0:3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 3:6], want[:, 3:6], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 6:8], want[:, 6:8])
    assert int(cert) == int(wcert) == 11


def test_forces_match_jax_forces_compact():
    jp, tp, jf, tf, jrows, trows, n, r = _drifted_rows()
    rows = np.asarray(jrows).reshape(-1, sk.N_FIELDS)[:n]
    want, dv, wcert = pallas_compact.forces_compact(
        jf, jnp.asarray(rows[:, 0:3]), jnp.asarray(rows[:, 3:6]),
        jnp.asarray(rows[:, 6]), jp, r, n, tune=JTUNE)
    assert dv is None
    got, cert = compact.forces_compact(tf, trows, tp, r, CAP)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy() / np.abs(want).max(),
                               want / np.abs(want).max(), rtol=0, atol=1e-6)
    assert int(cert) == int(wcert) == 11


def test_tile_route_differs_from_window_route_only_on_drifted_rows():
    # K5 evaluates its tile's segments, K2 each row's own 27 cells: the same
    # candidate set for every row inside its band, fewer for a drifted row
    _, tp, _, tf, _, trows, n, r = _drifted_rows()
    k5, cert = compact.compact_substep_plain(tf, trows, tp, r)
    k2 = sk.fused_substep_plain(tf, trows, tp, r, CAP)
    assert int(cert) == 11
    assert bool((k5[DRIFTED] != k2[DRIFTED]).any(1).all())
    held = k5.clone()
    held[DRIFTED] = k2[DRIFTED]
    assert sk.substep_accuracy(tf, trows, held, tp, r, CAP).ok
    # and K5's own rule holds it to its plain version
    assert sk.substep_accuracy(tf, trows, k5, tp, r, None,
                               sums_fn=compact.compact_sums_plain).ok
    # the frame-start density: no drift, the same set as K1
    pos_s = trows[:, 0:3].clone()
    pos_s[DRIFTED, 2] -= 2.5 / (r - 1)
    rho5, _ = compact.density_compact_plain(tf, pos_s, tp, r)
    torch.testing.assert_close(rho5, sk.density_plain(tf, pos_s, tp, r, CAP),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("faithful", [True, False])
def test_compact_rollout_tracks_window_route_on_cpu(faithful):
    cfg = SimConfig(**_CALM)
    st = initial_state(cfg, "cpu")
    k5, m = make_rollout(cfg, 3, faithful=faithful, tune=COMPACT,
                         device="cpu")(st)
    k2, m2 = make_rollout(cfg, 3, faithful=faithful,
                          tune=SortedTuning(compact=False), device="cpu")(st)
    assert m.exact_cert.tolist() == [0, 0, 0]
    assert m.overflow.tolist() == m2.overflow.tolist()
    np.testing.assert_allclose(k5.pos.numpy(), k2.pos.numpy(), rtol=0,
                               atol=2e-6)


@pytest.mark.slow
def test_compact_rollout_matches_jax_compact_step():
    # tolerances of tests/test_pallas.py::test_compact_kernel_matches_v6
    from sphfluidsimulation_tpu.sim.stepper import (initial_state as jstate,
                                                    make_param_step)
    jc, tc = JConfig(**_CALM), SimConfig(**_CALM)
    step = jax.jit(make_param_step(jc, neighbor="pallas", pallas_tune=JTUNE))
    js, jphys = jstate(jc), JPhys.from_config(jc)
    certs = []
    for _ in range(3):
        js, jm = step(js, jphys)
        certs.append(int(jm.exact_cert))
    final, m = make_rollout(tc, 3, tune=COMPACT, device="cpu")(
        initial_state(tc, "cpu"))
    np.testing.assert_allclose(final.pos.numpy(), np.asarray(js.pos),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(final.vel.numpy(), np.asarray(js.vel),
                               rtol=0, atol=2e-4)
    assert m.exact_cert.tolist() == certs == [0, 0, 0]


@pytest.mark.parametrize("value,want", [(None, False), ("0", False),
                                        ("1", True)])
def test_sorted_tuning_reads_the_environment_as_jax_does(monkeypatch, value,
                                                         want):
    if value is None:
        monkeypatch.delenv("SPH_PALLAS_COMPACT", raising=False)
    else:
        monkeypatch.setenv("SPH_PALLAS_COMPACT", value)
    assert default_tuning() == SortedTuning(compact=want)
    assert PallasTuning.from_env().compact == want


def test_cli_and_scene_take_the_compact_route(monkeypatch, tmp_path):
    calls = []
    substep = compact.compact_substep

    def counted(*args, **kw):
        calls.append(1)
        return substep(*args, **kw)

    monkeypatch.setattr(compact, "compact_substep", counted)
    cfg = SimConfig(**_CALM)
    scene = Scene(cfg, tune=COMPACT, device="cpu")
    scene.step(1)
    assert len(calls) == cfg.substeps
    assert int(scene.last_metrics.exact_cert) == 0

    monkeypatch.setenv("SPH_PALLAS_COMPACT", "1")
    argv = ["run", "--device", "cpu", "--particles", "1024",
            "--bucket-resolution", "11", "--preset", "0", "--frames", "1"]
    assert cli.main(argv) == 0
    assert len(calls) == 2 * cfg.substeps


@pytest.mark.parametrize("faithful", [True, False])
def test_stepper_passes_capacity_pj_and_scalars_to_k5(monkeypatch, faithful):
    # each K5 call of a compact frame gets the config's capacity, the
    # frame's scalar block and (force modes) the rows' pj
    import inspect
    seen = []

    def spy(name):
        real = getattr(compact, name)

        def call(*args, **kw):
            seen.append((name, inspect.signature(real).bind(*args, **kw)))
            return real(*args, **kw)
        monkeypatch.setattr(compact, name, call)

    for name in ("density_compact", "compact_substep", "forces_compact"):
        spy(name)
    cfg = SimConfig(**_CALM, voxel_capacity=24)
    make_rollout(cfg, 1, faithful=faithful, tune=COMPACT, device="cpu")(
        initial_state(cfg, "cpu"))
    want = (["density_compact"] + ["compact_substep"] * cfg.substeps
            if faithful else
            ["density_compact"] + ["density_compact", "forces_compact"]
            * cfg.substeps)
    assert [n for n, _ in seen] == want
    for name, b in seen:
        assert b.arguments["capacity"] == 24, name
        assert b.arguments["scal"] is not None, name
        if name != "density_compact":
            rows = b.arguments["rows"]
            assert torch.equal(b.arguments["pj"],
                               sk.pj_cols(rows[:, 6], b.arguments["phys"]))


def test_cpu_tensors_route_to_the_plain_versions():
    _, tp, _, tf, _, trows, n, r = _drifted_rows()
    sk.reset_launch_counts()
    pos_s = trows[:, 0:3]
    cert = compact.fresh_spans(compact.stale_spans(tf), pos_s, r)[1]
    for got, want in (
            (compact.density_compact(tf, pos_s, tp, r, CAP),
             compact.density_compact_plain(tf, pos_s, tp, r)),
            (compact.compact_substep(tf, trows, tp, r, CAP, 0.3, 0.4),
             compact.compact_substep_plain(tf, trows, tp, r, 0.3, 0.4)),
            (compact.forces_compact(tf, trows, tp, r, CAP),
             (sk.fold_forces(compact.forces_compact_plain(tf, trows, tp, r)[0],
                             trows[:, 6], tp, fuse_acc=False)[0], cert))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert sk.launch_counts == dict.fromkeys(sk.launch_counts, 0)
