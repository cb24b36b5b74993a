"""The frame record of K2's and K3's scene-axis walk, and the density
record of K1's, on the CPU.

- The frame record (``sph_kernels.frame_record_scenes``), which the walk
  reads in place of occ, raw and pj, is integer-equal to ``frame.occ`` and
  ``frame.raw`` and bit-equal to ``pj_cols_scenes`` (and so to JAX's
  ``_pj_cols``): on 2-scene frames with the golden spawn's aliased raw
  cells, a capacity drop and rows of zero (and NaN) density, as the
  stepper builds it in faithful and corrected mode.
- ``make_scenes_step`` passes the record to K2's and K3's scene-axis
  wrappers: once a frame in faithful mode (the fused and the unfused
  route), once a substep in corrected mode; the compact route passes pj
  to K5 and builds no record.
- A line-for-line Python mirror of the record walk
  (``csrc/window_walk.cuh::range_walk`` with kRec: one slot a step, the
  gate's occ and raw from the record's bits) sums, for every row, exactly
  that row's members of ``sph_kernels._candidates`` in walk order, j == i
  skipped; a record with one occ cleared drops that slot.
- K1's density record (``sph_kernels.density_record_scenes``) is the
  sorted positions bit for bit and the gate word where(occ, raw, -1),
  integer-equal to JAX's vmapped ``build_frame`` with the golden spawn's
  aliased raw ids and a capacity drop; a dropped slot's word fails every
  row's gate. A line-for-line mirror of the density record walk (the self
  pair kept) sums each row's ``_candidates`` members in walk order, and a
  cleared gate word drops its slot. ``make_scenes_step`` launches
  K1-scenes once a faithful frame, 1 + 5 times a corrected frame, and on
  the CPU (K1's plain version) and the compact route builds no record.
- The scene plain versions still hold against JAX's vmapped
  ``fused_substep`` and ``forces_pallas`` at the tolerances of
  tests/test_torch_batch.py and tests/test_torch_scene_routes.py (the
  plain versions read no record).

The kernels themselves are held to the reference walk and to each scene's
solo launch on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.ops import pallas_sph
from sphfluidsimulation_tpu.ops.pallas_sph import PallasTuning
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_tpu.params import stack_params as jstack_params
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import sph_kernels as sk
from sphfluidsimulation_torch.ops.frame import build_frame_scenes
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning
from sphfluidsimulation_torch.params import PhysParams, stack_params
from sphfluidsimulation_torch.sim import stepper
from sphfluidsimulation_torch.sim.stepper import initial_state
from sphfluidsimulation_torch.state import stack_states

# one intra-op thread, as in the port's other test modules
torch.set_num_threads(1)

# the golden spawn (out-of-cube jitter: aliased raw cells) at a small size
_GOLDEN = dict(particle_number=512, bucket_resolution=9)
# tests/test_pallas.py:18-21 at the same size
_CALM = dict(particle_number=512, bucket_resolution=9, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
EXT = dict(xsph=0.3, artificial_viscosity=0.4)
CAP = 32
# the JAX kernels' tile geometry (tests/test_torch_batch.py)
JFAST = dict(tiles_per_group=2, unroll=1)
OVERRIDES = [{"rest_density": 1.5, "seed": 0},
             {"rest_density": 1.9, "seed": 1}]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _batch(base, cap=CAP, **ext):
    """A 2-scene spawn batch: (cfgs, states, stacked params, frame, pos_s,
    vel_s, ρ, r), the frame built with capacity ``cap``."""
    cfgs = [SimConfig(**base, **ext).replace(**ov) for ov in OVERRIDES]
    states = stack_states([initial_state(c, "cpu") for c in cfgs])
    params = stack_params([PhysParams.from_config(c) for c in cfgs])
    r = base["bucket_resolution"]
    frame, (pos_s, vel_s) = build_frame_scenes(
        states.pos, r, cap, extras=(states.pos, states.vel))
    rho = sk.density_scenes(frame, pos_s, params, r, cap)
    return cfgs, states, params, frame, pos_s, vel_s, rho, r


def _check_record(rec, frame, rho, params):
    assert rec.shape == rho.shape + (4,) and rec.dtype == torch.float32
    assert torch.equal(_bits(rec)[..., 2], frame.raw)
    assert torch.equal(_bits(rec)[..., 3], frame.occ.to(torch.int32))
    assert torch.equal(_bits(rec[..., 0:2]),
                       _bits(sk.pj_cols_scenes(rho, params)))


# ----------------------------------------------------------- the record --

@pytest.mark.parametrize("cap", [4, CAP])
@pytest.mark.parametrize("base", ["golden", "calm"])
def test_frame_record_is_occ_raw_and_pj_bit_for_bit(base, cap):
    _, _, params, frame, _, _, rho, r = _batch(
        _GOLDEN if base == "golden" else _CALM, cap)
    rho = rho.clone()
    # rows of zero, tiny, negative and NaN density: the guarded reciprocal
    rho[0, :4] = torch.tensor([0.0, 1e-7, -1.0, float("nan")])
    rec = sk.frame_record_scenes(frame, rho, params)
    _check_record(rec, frame, rho, params)
    assert bool((rec[0, :4, 1] == 0).all())
    if cap == 4:
        assert not bool(frame.occ.all())          # the capacity drops rows
    if base == "golden":
        # the golden spawn aliases: some raw ids are not their anchor cell
        anchor = torch.repeat_interleave(
            torch.arange(r ** 3, dtype=torch.int32).expand(2, -1),
            (frame.start[:, 1:] - frame.start[:, :-1]).reshape(-1)
            .long()).reshape(frame.raw.shape)
        assert bool((frame.raw != anchor).any())
    # each scene's pj lanes are JAX's _pj_cols of its own physics
    for s, ov in enumerate(OVERRIDES):
        jp = JPhys.from_config(JConfig(**_CALM if base == "calm"
                                       else _GOLDEN).replace(**ov))
        press, inv = pallas_sph._pj_cols(jnp.asarray(rho[s].numpy()), jp)
        np.testing.assert_array_equal(
            rec[s, :, 0].numpy().view(np.uint32),
            np.asarray(press, dtype=np.float32).view(np.uint32))
        np.testing.assert_array_equal(
            rec[s, :, 1].numpy().view(np.uint32),
            np.asarray(inv, dtype=np.float32).view(np.uint32))


# ------------------------------------------- the stepper passes the record --

def _spy(monkeypatch):
    """Records each frame record the stepper builds (checked against the
    frame and ρ it was built from), the record K2's and K3's scene-axis
    wrappers receive and the pj K5's receives."""
    seen = {"records": [], "k2": [], "k3": [], "k5": []}
    real_rec = sk.frame_record_scenes

    def record(frame, rho, params):
        rec = real_rec(frame, rho, params)
        _check_record(rec, frame, rho, params)
        seen["records"].append(rec)
        return rec

    def spy(name, module, attr, key):
        real = getattr(module, attr)

        def call(*a, **k):
            seen[name].append(k.get(key, a[7] if len(a) > 7 else None))
            return real(*a, **k)

        monkeypatch.setattr(module, attr, call)

    monkeypatch.setattr(sk, "frame_record_scenes", record)
    spy("k2", sk, "fused_substep_scenes", "rec")
    spy("k3", sk, "forces_scenes", "rec")
    from sphfluidsimulation_torch.ops import compact
    spy("k5", compact, "compact_substep_scenes", "pj")
    return seen


MODES = {"faithful": (True, SortedTuning(), {}),
         "faithful ext": (True, SortedTuning(), EXT),
         "unfused": (True, SortedTuning(fused=False), {}),
         "corrected": (False, SortedTuning(), {}),
         "corrected ext": (False, SortedTuning(), EXT),
         "compact": (True, SortedTuning(compact=True), {})}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_scenes_step_passes_the_record_in_place_of_pj(monkeypatch, mode):
    faithful, tune, ext = MODES[mode]
    seen = _spy(monkeypatch)
    cfg = SimConfig(**_GOLDEN, **ext)
    cfgs = [cfg.replace(**ov) for ov in OVERRIDES]
    states = stack_states([initial_state(c, "cpu") for c in cfgs])
    params = stack_params([PhysParams.from_config(c) for c in cfgs])
    step = stepper.make_scenes_step(cfg, faithful, tune)
    frames = 2
    for _ in range(frames):
        states, _ = step(states, params)
    subs = frames * cfg.substeps
    if tune.compact:
        # K5 reads pj; no record is built
        assert seen["records"] == [] and len(seen["k5"]) == subs
        assert all(pj is not None for pj in seen["k5"])
        return
    recs = seen["k2"] if faithful and tune.fused else seen["k3"]
    assert len(recs) == subs
    # once a frame in faithful mode, once a substep in corrected mode
    assert len(seen["records"]) == (frames if faithful else subs)
    per = cfg.substeps if faithful else 1
    for i, rec in enumerate(recs):
        assert rec is seen["records"][i // per]


# ------------------------------------------------------ record walk mirror --

def _raw_near(raw, cx, cy, cz, r):
    z = raw // (r * r)
    y = (raw - z * r * r) // r
    x = raw - z * r * r - y * r
    return abs(x - cx) <= 1 and abs(y - cy) <= 1 and abs(z - cz) <= 1


def _record_walk(start, rec, c, i, r, cap):
    """range_walk of csrc/window_walk.cuh with kRec, line for line, for
    row i of fresh cell ``c``: one slot a step, each slot's gate from its
    record ``rec[q]`` = (press_j, inv_j, raw, occ as int bits); the slots
    row i sums, in order (j == i skipped)."""
    cx, cy, cz = c
    x0, x1 = max(cx - 1, 0), min(cx + 1, r - 1)
    out = []
    for z in range(max(cz - 1, 0), min(cz + 1, r - 1) + 1):
        for y in range(max(cy - 1, 0), min(cy + 1, r - 1) + 1):
            line = (z * r + y) * r

            def near(rj):
                return (0 <= rj - line - x0 <= x1 - x0
                        or _raw_near(rj, cx, cy, cz, r))

            end = start[line + x0]
            x = x0
            while x <= x1:
                q = end
                end = start[line + x + 1]
                e = min(end, q + cap) if cap >= 0 else end
                while e == end and x < x1:
                    x += 1
                    end = start[line + x + 1]
                    e = min(end, e + cap) if cap >= 0 else end
                for q in range(q, e):
                    _, _, rj, occ = rec[q]
                    if occ != 0 and q != i and near(rj):
                        out.append(q)
                x += 1
    return out


def _mirror_scene(name, cap):
    """(frame, sorted rows' positions, ρ, params, r) of a 2-scene mirror
    case."""
    if name == "random":
        rng = np.random.default_rng(4)
        pos = torch.from_numpy(rng.random((2, 1500, 3), dtype=np.float32))
        r = 11
        params = stack_params([PhysParams.from_config(SimConfig(**_CALM))
                               for _ in range(2)])
    else:
        cfgs = [SimConfig(**(_GOLDEN if name.startswith("golden")
                             else _CALM)).replace(**ov) for ov in OVERRIDES]
        pos = stack_states([initial_state(c, "cpu") for c in cfgs]).pos
        params = stack_params([PhysParams.from_config(c) for c in cfgs])
        r = cfgs[0].bucket_resolution
    frame, (ps,) = build_frame_scenes(pos, r, cap, extras=(pos,))
    rho = sk.density_scenes(frame, ps, params, r, cap)
    ps = ps.clone()
    if name == "calm moved":
        # rows moved 1.5 cells up in z: they leave their frame-start cell
        ps[:, 100:150, 2] = (ps[:, 100:150, 2] + 1.5 / (r - 1)).clamp(
            max=1.0)
    return frame, ps, rho, params, r


@pytest.mark.parametrize("cap", [4, None])
@pytest.mark.parametrize("name", ["golden", "calm moved", "random"])
def test_record_walk_sums_each_rows_members_in_walk_order(name, cap):
    from sphfluidsimulation_torch.ops.frame import scene_frame
    frame, ps, rho, params, r = _mirror_scene(name, cap)
    rec = sk.frame_record_scenes(frame, rho, params)
    capv = -1 if cap is None else cap
    for sc in range(2):
        fs = scene_frame(frame, sc)
        c = sk.fresh_cell(ps[sc], r)
        j, member = sk._candidates(fs, c, r, sk._window_width(fs, cap))
        start, cells = fs.start.tolist(), c.tolist()
        bits = _bits(rec[sc]).tolist()
        pairs = 0
        for i in range(ps.shape[1]):
            got = _record_walk(start, bits, cells[i], i, r, capv)
            assert got == [int(v) for v in j[i][member[i]] if int(v) != i], \
                (sc, i)
            pairs += len(got)
        assert pairs > 0
        # planted: a record with one occupied slot's occ cleared drops
        # that slot from every row that summed it, and from no other
        i = next(i for i in range(ps.shape[1])
                 if _record_walk(start, bits, cells[i], i, r, capv))
        q = _record_walk(start, bits, cells[i], i, r, capv)[0]
        bits[q][3] = 0
        got = _record_walk(start, bits, cells[i], i, r, capv)
        assert q not in got and len(got) == len(
            [v for v in j[i][member[i]] if int(v) != i]) - 1


# ------------------------------------------------ K1's density record --

def _jax_frames(base, cap):
    """JAX's vmapped build_frame of ``_batch``'s 2-scene spawn: (sorted
    positions, raw, occ) [2, N, ...]."""
    cfgs = [SimConfig(**base).replace(**ov) for ov in OVERRIDES]
    pos = jnp.asarray(stack_states([initial_state(c, "cpu")
                                    for c in cfgs]).pos.numpy())
    r = base["bucket_resolution"]

    def frame(p):
        jf, (ps,) = pallas_sph.build_frame(p, r, cap, extras=(p,),
                                           tune=PallasTuning(**JFAST))
        return ps, jf.raw, jf.occ

    return tuple(np.asarray(x) for x in jax.vmap(frame)(pos))


@pytest.mark.parametrize("cap", [4, CAP, None])
@pytest.mark.parametrize("base", ["golden", "calm"])
def test_density_record_is_pos_and_the_gate_word(base, cap):
    # lanes 0-2 the sorted positions bit for bit, lane 3 the int32 word
    # where(occ, raw, -1): integer-equal to JAX's vmapped build_frame,
    # whose spawn (the golden one's out-of-cube rows) aliases raw ids
    kw = _GOLDEN if base == "golden" else _CALM
    _, _, _, frame, pos_s, _, _, r = _batch(kw, cap)
    rec = sk.density_record_scenes(frame, pos_s)
    assert rec.shape == pos_s.shape[:2] + (4,) and rec.dtype == torch.float32
    assert torch.equal(_bits(rec[..., 0:3]), _bits(pos_s))
    word = _bits(rec)[..., 3]
    assert torch.equal(word, torch.where(frame.occ, frame.raw, -1))
    # occ implies a raw id in [0, R³): the word is below 0 exactly where
    # the slot is unoccupied
    assert bool(((frame.raw >= 0) & (frame.raw < r ** 3))[frame.occ].all())
    assert torch.equal(word < 0, ~frame.occ)
    jps, jraw, jocc = _jax_frames(kw, cap)
    np.testing.assert_array_equal(rec[..., 0:3].numpy().view(np.uint32),
                                  jps.view(np.uint32))
    np.testing.assert_array_equal(word.numpy(), np.where(jocc, jraw, -1))
    if base == "golden":
        # the spawn aliases: some raw ids are not their anchor cell (here
        # out of range, so their word is -1)
        alias = frame.raw != frame.cid
        assert bool(alias.any()) and bool((word[alias] == -1).any())
    if cap == 4:
        assert not bool(frame.occ.all())          # the capacity drops rows


def _gate(word, c, line, r):
    """The density record walk's gate on one slot of line ``line``
    (window_walk.cuh, kDensityRecord) for a row of fresh cell ``c``."""
    cx, cy, cz = c
    x0, x1 = max(cx - 1, 0), min(cx + 1, r - 1)
    return word >= 0 and (0 <= word - line - x0 <= x1 - x0
                          or _raw_near(word, cx, cy, cz, r))


def test_dropped_slots_gate_word_fails_every_row():
    # a slot past the voxel capacity (rank >= 4) whose raw id lies in range
    # holds the word -1, and no row's gate passes it, whereas its raw id
    # would pass the gate of a row of its own cell
    _, _, _, frame, pos_s, _, _, r = _batch(_CALM, 4)
    rec = sk.density_record_scenes(frame, pos_s)
    word = _bits(rec)[..., 3]
    dropped = ~frame.occ & (frame.raw >= 0) & (frame.raw < r ** 3)
    assert int(dropped.sum()) > 0
    for s, j in torch.nonzero(dropped).tolist()[:50]:
        raw = int(frame.raw[s, j])
        z, y = divmod(raw // r, r)
        own = (raw % r, y, z)
        assert int(word[s, j]) == -1
        assert _gate(raw, own, (z * r + y) * r, r)
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                c = (own[0], own[1] + dy, own[2] + dz)
                assert not _gate(int(word[s, j]), c, (z * r + y) * r, r)


def _density_record_walk(start, words, c, i, r, cap):
    """range_walk of csrc/window_walk.cuh with kDensityRecord, line for
    line, for row i of fresh cell ``c``: one slot a step, each slot's gate
    from its record's gate word ``words[q]`` (raw where occ, else -1); the
    slots row i sums, in order (the self pair kept)."""
    cx, cy, cz = c
    x0, x1 = max(cx - 1, 0), min(cx + 1, r - 1)
    out = []
    for z in range(max(cz - 1, 0), min(cz + 1, r - 1) + 1):
        for y in range(max(cy - 1, 0), min(cy + 1, r - 1) + 1):
            line = (z * r + y) * r
            end = start[line + x0]
            x = x0
            while x <= x1:
                q = end
                end = start[line + x + 1]
                e = min(end, q + cap) if cap >= 0 else end
                while e == end and x < x1:
                    x += 1
                    end = start[line + x + 1]
                    e = min(end, e + cap) if cap >= 0 else end
                out += [q for q in range(q, e)
                        if _gate(words[q], c, line, r)]
                x += 1
    return out


@pytest.mark.parametrize("cap", [4, None])
@pytest.mark.parametrize("name", ["golden", "calm moved", "random"])
def test_density_record_walk_sums_each_rows_members_in_walk_order(name,
                                                                   cap):
    from sphfluidsimulation_torch.ops.frame import scene_frame
    frame, ps, _, _, r = _mirror_scene(name, cap)
    rec = sk.density_record_scenes(frame, ps)
    capv = -1 if cap is None else cap
    for sc in range(2):
        fs = scene_frame(frame, sc)
        c = sk.fresh_cell(ps[sc], r)
        j, member = sk._candidates(fs, c, r, sk._window_width(fs, cap))
        start, cells = fs.start.tolist(), c.tolist()
        words = _bits(rec[sc])[:, 3].tolist()
        pairs = own = 0
        for i in range(ps.shape[1]):
            got = _density_record_walk(start, words, cells[i], i, r, capv)
            assert got == [int(v) for v in j[i][member[i]]], (sc, i)
            pairs += len(got)
            own += got.count(i)
        assert 0 < own < pairs
        # planted: a record with one occupied slot's gate word cleared
        # drops that slot from the rows that summed it
        i = next(i for i in range(ps.shape[1])
                 if _density_record_walk(start, words, cells[i], i, r, capv))
        q = _density_record_walk(start, words, cells[i], i, r, capv)[0]
        words[q] = -1
        got = _density_record_walk(start, words, cells[i], i, r, capv)
        assert q not in got and len(got) == int(member[i].sum()) - 1


def _density_spy(monkeypatch):
    """Records each density record the stepper builds and the record each
    K1 scene-axis launch receives, with its positions."""
    seen = {"records": [], "k1": []}
    real_rec, real_k1 = sk.density_record_scenes, sk.density_scenes

    def record(frame, pos_s):
        seen["records"].append(real_rec(frame, pos_s))
        return seen["records"][-1]

    def k1(frame, pos_s, *a, **k):
        seen["k1"].append((k.get("rec"), pos_s))
        return real_k1(frame, pos_s, *a, **k)

    monkeypatch.setattr(sk, "density_record_scenes", record)
    monkeypatch.setattr(sk, "density_scenes", k1)
    return seen


DENSITY_MODES = {"faithful": (True, SortedTuning()),
                 "unfused": (True, SortedTuning(fused=False)),
                 "corrected": (False, SortedTuning()),
                 "compact": (True, SortedTuning(compact=True)),
                 "compact corrected": (False, SortedTuning(compact=True))}


@pytest.mark.parametrize("mode", sorted(DENSITY_MODES))
def test_scenes_step_passes_the_density_record_to_k1(monkeypatch, mode):
    # the batched step launches K1 over the scenes once a faithful frame,
    # 1 + 5 times a corrected frame, each time on its own frame's sorted
    # positions; on the CPU, where K1's plain version reads no record, it
    # builds none and passes none (the card test
    # test_scenes_step_passes_the_density_record_to_k1_on_card holds the
    # records passed there); the compact route launches K5 and builds none
    faithful, tune = DENSITY_MODES[mode]
    seen = _density_spy(monkeypatch)
    cfg = SimConfig(**_GOLDEN)
    cfgs = [cfg.replace(**ov) for ov in OVERRIDES]
    states = stack_states([initial_state(c, "cpu") for c in cfgs])
    params = stack_params([PhysParams.from_config(c) for c in cfgs])
    step = stepper.make_scenes_step(cfg, faithful, tune)
    frames = 2
    for _ in range(frames):
        states, _ = step(states, params)
    assert seen["records"] == []
    if tune.compact:
        assert seen["k1"] == []
        return
    per = 1 if faithful else 1 + cfg.substeps
    assert len(seen["k1"]) == frames * per
    assert all(rec is None and pos_s.shape == states.pos.shape
               for rec, pos_s in seen["k1"])


# ----------------------------------------------------- against JAX's vmap --

@pytest.mark.parametrize("ext", [False, True])
def test_scene_plain_versions_match_jax_vmap(ext):
    # the wrappers' plain versions (a CPU tensor: they read no record)
    # against JAX's vmapped fused_substep (tests/test_torch_batch.py's
    # tolerance: 1e-6 absolute in position and velocity, ρ and the NaN
    # count equal) and forces_pallas (tests/test_torch_scene_routes.py's:
    # 1e-6 of the largest force)
    kw = EXT if ext else {}
    xs, al = (EXT["xsph"], EXT["artificial_viscosity"]) if ext else (0, 0)
    cfgs, states, tp, frame, pos_s, _, rho, r = _batch(_CALM, **kw)
    vel = np.random.default_rng(2).normal(
        0, 0.2, tuple(states.pos.shape)).astype(np.float32)
    frame, (pos_s, vel_s) = build_frame_scenes(
        states.pos, r, CAP, extras=(states.pos, torch.from_numpy(vel)))
    jp = jstack_params([JPhys.from_config(JConfig(**_CALM, **kw)
                                          .replace(**ov))
                        for ov in OVERRIDES])
    n, jt = cfgs[0].n_particles, PallasTuning(**JFAST)
    pos = jnp.asarray(states.pos.numpy())
    rows = sk.pack_rows_scenes(pos_s, vel_s, rho)

    def substep(p, v, rho_s, phys):
        jf, (ps, vs) = pallas_sph.build_frame(p, r, CAP, extras=(p, v),
                                              tune=jt)
        rows = pallas_sph.pack_rows(ps, vs, rho_s, None, n, jt)
        out, cert = pallas_sph.fused_substep(jf, rows, phys, r, n,
                                             xsph=xs, alpha_visc=al,
                                             tune=jt)
        return out.reshape(-1, sk.N_FIELDS)[:n], cert

    want, cert = jax.vmap(substep)(pos, jnp.asarray(vel),
                                   jnp.asarray(rho.numpy()), jp)
    assert np.asarray(cert).tolist() == [0, 0]
    got = sk.fused_substep_scenes(frame, rows, tp, r, CAP, xs, al).numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got[..., 0:6], want[..., 0:6], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got[..., 6:8], want[..., 6:8])

    def forces(p, ps, vs, rho_s, phys):
        jf, _ = pallas_sph.build_frame(p, r, CAP, extras=(p,), tune=jt)
        return pallas_sph.forces_pallas(jf, ps, vs, rho_s, phys, r, n,
                                        xsph=xs, alpha_visc=al, tune=jt)

    f, dv, cert = jax.vmap(forces)(pos, jnp.asarray(pos_s.numpy()),
                                   jnp.asarray(vel_s.numpy()),
                                   jnp.asarray(rho.numpy()), jp)
    assert np.asarray(cert).tolist() == [0, 0]
    got_f, got_dv = sk.forces_scenes(frame, rows, tp, r, CAP, xs, al)
    for s in range(2):
        for g, w in ((got_f, f), (got_dv, dv)) if ext else ((got_f, f),):
            w = np.asarray(w)[s]
            scale = np.abs(w).max()
            np.testing.assert_allclose(g[s].numpy() / scale, w / scale,
                                       rtol=0, atol=1e-6)
    assert (got_dv is None) is (dv is None)
