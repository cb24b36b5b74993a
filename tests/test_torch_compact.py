"""The compact-lane route (K5, ``ops/compact.py``) against the JAX package's
v7 compact kernels (``pallas_compact.py``, Pallas in interpret mode, as the
JAX tests run it) and against the port's own window route (K1/K2/K3).

A line-for-line Python mirror of the kernel's tile stream (cell-level line
dedup, the slot segments, each round stopped at the first slot past its
cell's capacity) must process, for every tile, exactly each union cell's
capacity-cut prefix, in ascending order, and so every occupied slot of the
``tile_segments`` union. The split plan of wide tiles (``tile_cost``,
``n_chunks``, ``chunk_cells``) must cut each tile's stream into
cell-aligned chunks that cover it once, and a plain fold of the chunks'
partial sums, in chunk order, must stay with the plain version and JAX.

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
CROWS = compact.CROWS
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

def _k5_stream(start, cid, occ, lo, hi, r, cap, cells=None, s_cells=None):
    """compact.cu's stream for one tile with span [lo, hi], line for line:
    (the slots its lanes process, in order; the union's cells). ``cap`` < 0
    streams each cell uncut; ``cells`` = (c0, c1) streams one chunk, the
    union's cells in [c0, c1) (``Tile::walk_cells``)."""
    rounds, union = _k5_rounds(start, cid, occ, lo, hi, r, cap, cells,
                               s_cells)
    return [j for rd in rounds for j in rd], union


def _k5_rounds(start, cid, occ, lo, hi, r, cap, cells=None, s_cells=None):
    """:func:`_k5_stream` round by round: (each round's processed slots,
    the union's cells)."""
    s_cells = r ** 3 if s_cells is None else s_cells
    c0, c1 = (0, s_cells) if cells is None else cells
    segs, union, cb_run = [], [], 0
    for k in range(9):                  # lanes 0-8: the cell-level dedup
        off = (k // 3 - 1) * r * r + (k % 3 - 1) * r
        a = min(max(lo + off - 1, 0), s_cells)
        b = min(max(hi + off + 2, 0), s_cells)
        a, cb_run = max(a, cb_run), max(cb_run, a, b)
        segs.append((start[min(max(a, c0), c1)],
                     start[min(max(cb_run, c0), c1)]))
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
            out.append([j for j in range(base, base + stop) if j < seg_end])
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


# ------------------------------------- the forces mode's own lists --

def _ffs_order(mask):
    """The set bits of ``mask`` (numpy uint32) in the order the kernel's
    ``t = __ffs(own) - 1; own &= own - 1`` loop takes them."""
    out = []
    while mask:
        low = mask & (~mask + np.uint32(1))       # the lowest set bit
        out.append(int(low).bit_length() - 1)
        mask = np.uint32(mask & (mask - np.uint32(1)))
    return out


@pytest.mark.parametrize("cap", [4, CAP, None])
@pytest.mark.parametrize("scene", ["goldenish@3", "goldenish@0"])
def test_forces_lanes_walk_their_own_slots_in_the_parents_order(scene, cap):
    # a model of compact.cu's forces walk over each round's compacted list:
    # the parent's (every live lane steps through the list, `continue` where
    # the slot is not near its cell or is its own row) and the launched
    # one's two loops (each lane a mask of its own slots, walked lowest bit
    # first; or the warp through the union of the masks, each lane adding
    # its own) give each row the same candidates in the same order, its
    # members of the tile's union; walk_counts' steps are the model's (the
    # slots kept, those the parent's warp runs the pair for, and the own
    # lists' steps)
    tf, ps, r = _stream_scene(scene, cap)
    n = ps.shape[0]
    spans, _ = compact.spans_of(tf, ps, r, True)
    start, cid, occ = tf.start.tolist(), tf.cid.tolist(), tf.occ.tolist()
    raw = tf.raw.numpy()
    xyz = np.stack([raw % r, raw // r % r, raw // (r * r)], 1)
    cell = sk.fresh_cell(ps, r).numpy()
    kept_n, paired_n, own_n = compact.walk_counts(tf, ps, r, cap)
    kcap = -1 if cap is None else cap
    differ = 0
    for t, (lo, hi) in enumerate(spans.tolist()):
        rows = range(CROWS * t, min(CROWS * (t + 1), n))
        box_lo, box_hi = cell[rows].min(0) - 1, cell[rows].max(0) + 1
        rounds, union = _k5_rounds(start, cid, occ, lo, hi, r, kcap)
        parent = {i: [] for i in rows}
        lanes = {i: [] for i in rows}
        shared = {i: [] for i in rows}
        steps_parent = steps_paired = steps_own = 0
        for rd in rounds:
            kept = [j for j in rd if occ[j]
                    and (xyz[j] >= box_lo).all() and (xyz[j] <= box_hi).all()]
            assert len(kept) <= CROWS
            steps_parent += len(kept)
            counts, masks = [], []
            for i in rows:
                near = [bool((np.abs(xyz[j] - cell[i]) <= 1).all())
                        for j in kept]
                for t_, j in enumerate(kept):         # the parent's loop
                    if not near[t_]:
                        continue
                    if j == i:
                        continue
                    parent[i].append(j)
                mask = np.uint32(0)
                for t_, j in enumerate(kept):
                    if near[t_] and j != i:
                        mask |= np.uint32(1 << t_)
                lanes[i] += [kept[t_] for t_ in _ffs_order(mask)]
                masks.append(mask)
                counts.append(bin(int(mask)).count("1"))
            steps_own += max(counts)
            union_mask = np.bitwise_or.reduce(np.array(masks, np.uint32))
            for i, m in zip(rows, masks):
                shared[i] += [kept[t_] for t_ in _ffs_order(union_mask)
                              if int(m) >> t_ & 1]
            steps_paired += bin(int(union_mask)).count("1")
        assert lanes == parent and shared == parent
        for i in rows:
            members = [j for c in union for j in range(start[c], start[c + 1])
                       if occ[j] and j != i
                       and (np.abs(xyz[j] - cell[i]) <= 1).all()]
            assert parent[i] == members
        assert (int(kept_n[t]), int(paired_n[t]), int(own_n[t])) == \
            (steps_parent, steps_paired, steps_own)
        differ += steps_own < steps_paired
    assert differ > 0
    assert int(own_n.sum()) < int(paired_n.sum()) <= int(kept_n.sum())


@pytest.mark.parametrize("n, r, own", [
    (262144, 47, True),          # golden 262k: 2.5 rows a cell
    (262144, 40, True),          # 4.1
    (1048576, 75, True),         # golden 1M: 2.5
    (524176, 47, False),         # a config-5 scene: 5.0
    (1024, 11, True)])
def test_forces_take_the_own_lists_below_the_rows_per_cell_threshold(n, r,
                                                                     own):
    # the forces wrappers' walk, solo and over the scene axis alike (one
    # rule of n / R³, so that each scene keeps its solo launch's walk):
    # the lanes' own lists (mode 3) below OWN_LISTS_ROWS_PER_CELL rows a
    # cell, else the round's list (mode 1); own= forces either
    assert compact.own_lists(n, r) is own
    assert (n < compact.OWN_LISTS_ROWS_PER_CELL * r ** 3) is own
    assert compact._forces_mode(None, n, r) == (3 if own else 1)
    assert compact._forces_mode(True, n, r) == 3
    assert compact._forces_mode(False, n, r) == 1


# ------------------------------------------------ the wide-tile split --

SPLIT_TILE = 5          # the planted wide tile: rows 160-191 of the calm dam


def _planted(rows):
    """The rows with tile SPLIT_TILE's spread over the planes around it:
    even rows 1.2 cells up in z, odd rows 1.2 cells down, so its fresh span
    widens by about two planes of cells."""
    r = _CALM["bucket_resolution"]
    out = rows.clone()
    a = SPLIT_TILE * compact.CROWS
    out[a:a + 32:2, 2] += 1.2 / (r - 1)
    out[a + 1:a + 32:2, 2] -= 1.2 / (r - 1)
    out[:, 0:3] = out[:, 0:3].clamp(0.0, 1.0)
    return out


@functools.lru_cache(maxsize=None)
def _split_scene(scene):
    """(frame, spans, R, band) of the split tests: ``planted`` the calm dam
    with its planted wide tile (fresh spans), ``band`` a slab shard's frame
    of goldenish@3 (planes 1-6 live, 300 dead rows; stale spans), else
    :func:`_stream_scene`'s frame (stale spans)."""
    if scene == "planted":
        _, _, _, tf, _, trows, _, r = _drifted_rows()
        spans, _ = compact.fresh_spans(compact.stale_spans(tf),
                                       _planted(trows)[:, 0:3], r)
        return tf, spans, r, None
    if scene == "band":
        band = (1, 6)
        cfg = SimConfig(**_GOLDENISH)
        st, _ = make_rollout(cfg, 3, device="cpu")(initial_state(cfg, "cpu"))
        r = cfg.bucket_resolution
        pos = torch.cat([st.pos, st.pos[:300]])
        az = (pos[:, 2] * (r - 1)).to(torch.int32).clamp(0, r - 1)
        valid = (az >= band[0]) & (az < band[0] + band[1])
        valid[cfg.n_particles:] = False
        gid = torch.arange(pos.shape[0], dtype=torch.int32) % cfg.n_particles
        tf, _ = build_frame(pos, r, CAP, extras=(pos,), gid=gid,
                            n_ids=cfg.n_particles, band=band, valid=valid)
        return tf, compact.stale_spans(tf, band, r), r, band
    tf, _, r = _stream_scene(scene, CAP)
    return tf, compact.stale_spans(tf), r, None


@pytest.mark.parametrize("slots", [8, 48])
@pytest.mark.parametrize("scene", ["calm@3", "goldenish@3", "goldenish@0",
                                   "planted", "band"])
def test_split_chunks_cover_each_tiles_stream_once(scene, slots):
    # the plan's chunks of each tile, streamed by the kernel's mirror, are
    # its whole stream once, in ascending slot order, each starting at a
    # cell's first slot; their occupied slots sum to the tile's cost and
    # split it about evenly; a light tile is one chunk
    tf, spans, r, band = _split_scene(scene)
    s_cells = compact.s_cells_of(r, band)
    occ_cum = compact.occ_prefix(tf.occ)
    chunks = compact.CHUNKS
    cost = compact.tile_cost(spans, tf.start, occ_cum, r, band)
    k = compact.n_chunks(cost, slots)
    b = compact.chunk_cells(spans, tf.start, occ_cum, r, slots, band)
    t_n = compact.n_tiles(tf.cid.shape[0])
    assert b.shape == (t_n, chunks + 1) and b.dtype == torch.int32
    assert cost.shape == (t_n,) and k.max() <= chunks
    assert bool((k == 1).eq(cost <= slots).all())
    assert bool((b[:, 0] == 0).all() and (b[:, 1:] >= b[:, :-1]).all())
    m = torch.arange(chunks + 1)
    assert bool((b[m >= k[:, None]] == s_cells).all())
    start, cid, occ = tf.start.tolist(), tf.cid.tolist(), tf.occ.tolist()
    for t, (lo, hi) in enumerate(spans.tolist()):
        whole, _ = _k5_stream(start, cid, occ, lo, hi, r, CAP,
                              s_cells=s_cells)
        parts = [_k5_stream(start, cid, occ, lo, hi, r, CAP,
                            (int(b[t, q]), int(b[t, q + 1])), s_cells)[0]
                 for q in range(int(k[t]))]
        assert [j for part in parts for j in part] == whole
        for part in parts:
            assert not part or part[0] == start[cid[part[0]]]
        counts = [sum(occ[j] for j in part) for part in parts]
        assert sum(counts) == int(cost[t])
        if k[t] > 1:              # about equal, up to one cell's run
            assert max(counts) <= -(-int(cost[t]) // int(k[t])) + CAP
    # the split shows: every scene has split tiles at 8 slots, the planted
    # tile is among them at both thresholds, dead tiles cost nothing
    assert slots != 8 or int((k > 1).sum()) > 0
    if scene == "planted":
        assert int(k[SPLIT_TILE]) >= 3 and int(k.max()) > 1
    if scene == "band":
        assert int(cost[-(300 // compact.CROWS):].max()) == 0


@pytest.mark.parametrize("slots", [120, compact.SPLIT_SLOTS])
def test_n_chunks_grow_with_cost_up_to_the_most(slots):
    # a tile at or below the threshold is one chunk; past it, one chunk a
    # threshold's worth of occupied slots, rounded up, at most CHUNKS
    cost = torch.arange(0, 40 * slots, max(1, slots // 7), dtype=torch.int32)
    k = compact.n_chunks(cost, slots)
    for c, kk in zip(cost.tolist(), k.tolist()):
        want = 1 if c <= slots else min(compact.CHUNKS, -(-c // slots))
        assert kk == want
    assert int(k.max()) == compact.CHUNKS and bool((k[1:] >= k[:-1]).all())
    assert compact.n_chunks(cost, compact.SPLIT_SLOTS).tolist() == \
        compact.n_chunks(cost).tolist()


@pytest.mark.parametrize("scenes", [0, 1, 3])
def test_occ_prefix_counts_each_scenes_occupied_slots(scenes):
    # the occupied slots before each sorted index, scene by scene (0: one
    # frame without a scene axis)
    gen = torch.Generator().manual_seed(scenes)
    occ = torch.rand((max(scenes, 1), 97), generator=gen) > 0.3
    occ = occ[0] if scenes == 0 else occ
    got = compact.occ_prefix(occ)
    assert got.dtype == torch.int32 and got.shape[-1] == 98
    for o, g in zip(occ.reshape(-1, 97), got.reshape(-1, 98)):
        assert g.tolist() == [0] + o.int().cumsum(0).tolist()


def _chunked_sums(slots):
    """compact_sums_plain cut as the kernel cuts it at ``slots``: each row's
    candidates split by the chunks of ``chunk_cells`` (the candidate's
    cell), each chunk's partial sums summed alone, and the partials added
    in chunk order (a SumsFn, as compact_sums_plain)."""
    def sums_fn(frame, rows, phys, r, capacity=None, ext=False,
                magnitude=False, band=None, tune=None):
        tune = (tune or SortedTuning()).k5()
        pos_s = rows[:, 0:3]
        spans, _ = compact.spans_of(frame, pos_s, r, True, band)
        bounds = compact.chunk_cells(spans, frame.start,
                                     compact.occ_prefix(frame.occ), r,
                                     slots, band)
        out = rows.new_zeros((rows.shape[0], sk.N_SUMS))
        for ids, j, member in compact._tile_candidates(frame, spans, pos_s,
                                                       r, band):
            b = bounds[ids // compact.CROWS].long()
            chunk = (frame.cid[j][..., None] >= b[:, None, 1:]).sum(-1)
            total = None
            for q in range(compact.CHUNKS):
                part = sk.force_sums_plain(rows, phys, ids, j,
                                           member & (chunk == q), ext,
                                           magnitude, tune)
                total = part if total is None else total + part
            out[ids, :total.shape[1]] = total
        return out
    sums_fn.variant = SortedTuning.k5
    return sums_fn


@pytest.mark.parametrize("xsph,alpha", [(0.0, 0.0), (0.3, 0.4)])
def test_chunked_fold_matches_plain_and_jax_substep(xsph, alpha):
    # with a threshold of 16 occupied slots most tiles of the drifted calm
    # rows split; folding their chunks' partials in chunk order changes
    # only the rounding: the sums stay within 1e-5 of the plain version's,
    # and the substep within the JAX test's tolerance of JAX's
    # compact_substep, with its drift count
    _, tp, _, tf, _, trows, n, r = _drifted_rows()
    spans, cert = compact.spans_of(tf, trows[:, 0:3], r, True)
    cost = compact.tile_cost(spans, tf.start, compact.occ_prefix(tf.occ), r)
    assert int((compact.n_chunks(cost, 16) > 1).sum()) > cost.shape[0] // 2
    ext = sk.uses_extensions(xsph, alpha)
    got = _chunked_sums(16)(tf, trows, tp, r, ext=ext)
    want = compact.compact_sums_plain(tf, trows, tp, r, ext=ext)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    out = sk.fused_substep_plain(tf, trows, tp, r, None, xsph, alpha,
                                 _chunked_sums(16))
    jax_out, wcert = _jax_substep(xsph, alpha)
    _same_substep(out.numpy(), jax_out)
    assert int(cert) == wcert == 11


def _chunked_density(tf, pos_s, tp, r, slots, band=None):
    """(ρ, chunk bounds): density_compact_plain cut as the kernel cuts it
    at ``slots`` (the split launch of banded density): each row's
    candidates split by the chunks of ``chunk_cells`` (the candidate's
    cell), each chunk's partial sum summed alone, the partials added in
    chunk order."""
    spans = compact.stale_spans(tf, band, r)
    bounds = compact.chunk_cells(spans, tf.start, compact.occ_prefix(tf.occ),
                                 r, slots, band)
    w = pos_s.new_zeros(pos_s.shape[0])
    for ids, j, member in compact._tile_candidates(tf, spans, pos_s, r,
                                                   band):
        b = bounds[ids // compact.CROWS].long()
        chunk = (tf.cid[j][..., None] >= b[:, None, 1:]).sum(-1)
        total = None
        for q in range(compact.CHUNKS):
            part = sk.density_sums_plain(pos_s, tp, ids, j,
                                         member & (chunk == q))
            total = part if total is None else total + part
        w[ids] = total
    return tp.mass * w, bounds


@functools.lru_cache(maxsize=None)
def _jax_band_density():
    """(port frame, sorted positions, port physics, R, band, JAX's
    density_compact(band=) ρ and certificate) on a slab shard's banded frame
    of the calm dam in both packages: shard 1 of 4's planes with two below
    and four above, then 40 dead rows (tests/test_torch_variants.py's
    shard; JAX's tiles in groups of two, no unroll)."""
    name = "calm"
    jp, tp = _phys(name)
    pos = torch.from_numpy(_positions(name))
    r, n = CONFIGS[name]["bucket_resolution"], pos.shape[0]
    spec_z = -(-r // 4)
    band = (spec_z - 2, spec_z + 4)
    az = (pos[:, 2] * (r - 1)).to(torch.int32).clamp(0, r - 1)
    live = (az >= band[0]) & (az < band[0] + band[1])
    n_live = int(live.sum())
    # dead rows' ids ascend with their row index, so both sorts agree
    bpos = torch.cat([pos[live], pos[:40]])
    valid = torch.arange(n_live + 40) < n_live
    gid = torch.cat([torch.arange(n, dtype=torch.int32)[live],
                     torch.arange(40, dtype=torch.int32)])
    tf, (tps,) = build_frame(bpos, r, CAP, extras=(bpos,), gid=gid,
                             n_ids=n, band=band, valid=valid)
    jt = PallasTuning(fused=True, compact=True, tiles_per_group=2, unroll=1)
    jband = (jnp.int32(band[0]), band[1])
    jf, (jps,) = pallas_sph.build_frame(
        jnp.asarray(bpos.numpy()), r, CAP,
        extras=(jnp.asarray(bpos.numpy()),), gid=jnp.asarray(gid.numpy()),
        tune=jt, band=jband, valid=jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(tps.numpy(), np.asarray(jps))
    want, wcert = pallas_compact.density_compact(jf, jps, jp, r,
                                                 tps.shape[0], jt,
                                                 band=jband)
    return tf, tps, tp, r, band, np.asarray(want), int(wcert)


def test_chunked_density_fold_matches_plain_and_jax():
    # density's chunks on the stale spans, folded in chunk order
    tf, pos_s, tp, r, want, wcert = _jax_density("calm")
    got, bounds = _chunked_density(tf, pos_s, tp, r, 16)
    assert int((bounds[:, 2] < r ** 3).sum()) > 0          # split tiles
    torch.testing.assert_close(
        got, compact.density_compact_plain(tf, pos_s, tp, r)[0], rtol=1e-5,
        atol=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    assert wcert == 0


@pytest.mark.parametrize("slots", [8, 16])
def test_chunked_band_density_fold_matches_plain_and_jax(slots):
    # the split launch of banded density on a slab shard's frame: the live
    # tiles cut at `slots` occupied slots, each
    # row's chunk partials folded in chunk order, within 1e-5 of the banded
    # plain version and of JAX's density_compact(band=); dead rows 0, dead
    # tiles one chunk (every live tile but the ragged last splits)
    tf, pos_s, tp, r, band, want, wcert = _jax_band_density()
    n_live = int(tf.start[-1])
    assert 0 < n_live < pos_s.shape[0]
    got, bounds = _chunked_density(tf, pos_s, tp, r, slots, band)
    s_cells = compact.s_cells_of(r, band)
    live = compact._tiled(compact.live_rows(tf), False).any(1)
    assert int((bounds[live, 2] < s_cells).sum()) >= int(live.sum()) - 1
    assert bool((bounds[~live, 1] == s_cells).all())      # one chunk
    plain, _ = compact.density_compact_plain(tf, pos_s, tp, r, band)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[:n_live].numpy(), want[:n_live],
                               rtol=1e-5, atol=0)
    assert not got[n_live:].any() and wcert == 0


@functools.lru_cache(maxsize=None)
def _jax_density(name):
    """(port frame, sorted positions, port physics, R, JAX's density_compact
    ρ and certificate) at the spawn of ``name``."""
    jp, tp = _phys(name)
    pos = _positions(name)
    n, r = pos.shape[0], CONFIGS[name]["bucket_resolution"]
    jf, tf, pos_s = _frames(pos, r)
    want, wcert = pallas_compact.density_compact(jf, jnp.asarray(pos_s), jp,
                                                 r, n, JTUNE)
    return tf, torch.from_numpy(pos_s), tp, r, np.asarray(want), int(wcert)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_density_matches_jax_density_compact(name):
    tf, pos_s, tp, r, want, wcert = _jax_density(name)
    got, cert = compact.density_compact(tf, pos_s, tp, r, CAP)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    assert int(cert) == wcert == 0


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


@functools.lru_cache(maxsize=None)
def _jax_substep(xsph, alpha):
    """JAX's compact_substep of the drifted rows: (rows' f32[n, 8], drift
    count)."""
    jp, _, jf, _, jrows, _, n, r = _drifted_rows()
    out, wcert = pallas_compact.compact_substep(
        jf, jrows, jp, r, n, xsph=xsph, alpha_visc=alpha, tune=JTUNE)
    return np.asarray(out).reshape(-1, sk.N_FIELDS)[:n], int(wcert)


def _same_substep(got, want):
    # the tolerances of the JAX tests' compact kernel check
    np.testing.assert_allclose(got[:, 0:3], want[:, 0:3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 3:6], want[:, 3:6], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 6:8], want[:, 6:8])


@pytest.mark.parametrize("xsph,alpha", [(0.0, 0.0), (0.3, 0.4)])
def test_substep_matches_jax_compact_substep(xsph, alpha):
    _, tp, _, tf, _, trows, n, r = _drifted_rows()
    want, wcert = _jax_substep(xsph, alpha)
    got, cert = compact.compact_substep(tf, trows, tp, r, CAP, xsph, alpha)
    _same_substep(got.numpy(), want)
    assert int(cert) == wcert == 11


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
    # frame's scalar block, (force modes) the rows' pj and (the substep) the
    # frame's prefix count of occupied slots
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
        if name == "compact_substep":      # the split's count, once a frame
            assert torch.equal(b.arguments["occ_cum"], compact.occ_prefix(
                b.arguments["frame"].occ))


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
