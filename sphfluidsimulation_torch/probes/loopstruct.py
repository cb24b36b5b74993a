"""Loop-structure probe of the force walk: how much of a force pass is the
walk, and how much the pair arithmetic?

Counterpart of ``scripts/probe_loopstruct_tpu.py`` (``build_call``'s
pallas_call, :167). Two forms, both in ``csrc/probes/loopstruct.cu``:

- the script's synthetic kernel, variants A-E, on the script's inputs
  (:func:`synth_inputs`, its own numpy copy: 256 groups of 16 tiles of 64
  rows, a window f32[97, 8, 128], 9 lines and 11 chunks a tile, 262,144
  rows × 1,408 candidates = 369,098,752 candidate evaluations): A nested
  line → chunk loops 4 chunks a step, B A's walk with the pair stripped to
  one masked add, C the flat 16-entry list unrolled and gated, D the flat
  list in one dynamic loop 4 a step, E nested 8 a step. A, C, D and E
  compute the same sums. The script's gate passes only candidates whose
  cell lies within 1 of cell (0, 0, 0), and no cell of its window does, so
  those sums are all zero there; the kernels are also held on
  :func:`gate_open`, the same inputs with every candidate's cell 0.
- the port's own walk on a real frame (the 262,144-particle golden state
  at frame 10): A_f is K3's walk without extensions (``window_walk.cuh``
  ``range_walk<2, true, false>``, the full pair), B_f that walk with the
  pair stripped to one masked add, D_f a flat per-row list of slot ranges
  built by a pre-pass and walked in one dynamic loop, E_f the walk 4 slots
  a step. A_f, D_f and E_f keep the walk order and are held to K3's plain
  version by K3's rule (``sph_kernels.forces_accuracy``). B_f / A_f is the
  walk's share of K3's time.

Each variant is reported with its time, its ns per pair step (a candidate
evaluation of the synthetic form; a slot of the walk of the frame form)
and its share of the FP32 bound.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import GOLDEN_CONFIG, SimConfig
from ..ops import cuda_build, sph_kernels as sk
from ..ops.frame import SortedFrame, build_frame
from ..params import PhysParams
from ..sim.stepper import initial_state, make_rollout
from . import common

SOURCE = "probes/loopstruct.cu"
REPLACES = "scripts/probe_loopstruct_tpu.py:167"
LANES = 128
ROWS = 64
TPG = 16
N_WF = 8
W_ROWS = 97          # the script's window rows
GROUPS = 256
N_LINES = 9
MAXC = 16
R = 47
SYNTH = ("A", "B", "C", "D", "E")
FRAME = ("A_f", "B_f", "D_f", "E_f")
FRAMES = 10          # the frame form's state: the golden rollout's frame
MAX_RANGES = 27      # a row's slot ranges: 9 lines, each cut into <= 3
# plain versions: tiles a block (peak memory about 2 GB at 128)
PLAIN_TILES = 128
# the rule of the full pair: scale-rel against the plain version (the
# scripts' measure)
FULL_TOL = 1e-5
_U32 = 2.0 ** -24


class SynthInputs(NamedTuple):
    win: torch.Tensor      # f32[97, 8, 128]
    tiles: torch.Tensor    # i32[T, 18]
    counts: torch.Tensor   # i32[T, 1]
    flat: torch.Tensor     # i32[T, 16]
    fcnt: torch.Tensor     # i32[T, 1]
    rows: torch.Tensor     # f32[T, 64, 8]


def synth_inputs(rng: np.random.RandomState,
                 groups: int = GROUPS) -> tuple[np.ndarray, ...]:
    """The script's ``synth_inputs`` (numpy, the same draws in the same
    order): per tile 7 lines of 1 chunk and 2 of 2, their flat chunk list,
    the window and the rows."""
    t = groups * TPG
    k0 = rng.randint(0, W_ROWS - 3, size=(t, N_LINES)).astype(np.int32)
    ln = np.ones((t, N_LINES), np.int32)
    ln[:, 3] = 2
    ln[:, 5] = 2
    k1 = k0 + ln
    tiles = np.stack([k0, k1], axis=-1).reshape(t, 2 * N_LINES)
    counts = np.full((t, 1), N_LINES, np.int32)
    pos = np.zeros(t, np.int32)
    flat = np.full((t, MAXC), -1, np.int32)
    for i in range(N_LINES):
        for d in range(2):
            sel = ln[:, i] > d
            idx = np.clip(pos, 0, MAXC - 1)
            flat[np.arange(t)[sel], idx[sel]] = k0[sel, i] + d
            pos = pos + sel.astype(np.int32)
    fcnt = pos[:, None].astype(np.int32)
    win = rng.rand(W_ROWS, N_WF, LANES).astype(np.float32)
    win[:, 3, :] = rng.randint(0, R ** 3, size=(W_ROWS, LANES))
    rows = rng.rand(t, ROWS, N_WF).astype(np.float32)
    return win, tiles, counts, flat, fcnt, rows


def to_device(arrays, device) -> SynthInputs:
    return SynthInputs(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in arrays))


def gate_open(inp: SynthInputs) -> SynthInputs:
    """The same inputs with every candidate's cell id 0, inside the
    script's gate: the sums are then those of every candidate."""
    win = inp.win.clone()
    win[:, 3, :] = 0.0
    return inp._replace(win=win)


def drop_line(inp: SynthInputs) -> SynthInputs:
    """The planted control's inputs: each tile walks one line fewer."""
    return inp._replace(counts=inp.counts - 1)


# ------------------------------------------------------------ synthetic --

def _pair_sums(blk: torch.Tensor, gate: torch.Tensor, rows: torch.Tensor,
               full: bool) -> torch.Tensor:
    """The script's ``_pair_full`` (six sums) or ``_pair_min`` (one) of
    ``rows`` f32[b, 64, 8] against the chunks ``blk`` f32[b, C, 8, 128]
    gated by ``gate`` f32[b, C], summed over chunks and lanes: f32[b, 64,
    6]."""
    cand = blk[:, None]                                  # [b, 1, C, 8, 128]
    lane_gate = gate[:, None, :, None]                   # [b, 1, C, 1]
    out = rows.new_zeros(rows.shape[0], rows.shape[1], 6)
    if not full:
        out[..., 0] = (cand[:, :, :, 0] * lane_gate).sum((2, 3))
        return out
    row = rows[:, :, None, None, :]                      # [b, 64, 1, 1, 8]
    rx, ry, rz = row[..., 0], row[..., 1], row[..., 2]
    h = torch.tensor(1.0 / (R - 1), dtype=torch.float32)
    h2 = h * h
    c_grad = torch.tensor(45.0 / math.pi, dtype=torch.float32)
    cg_h6 = c_grad / (h2 * h2 * h2)
    cid = cand[:, :, :, 3]
    cz = torch.floor((cid + 0.5) / (R * R))
    rem = cid - cz * (R * R)
    cy = torch.floor((rem + 0.5) / R)
    cx = rem - cy * R
    member = ((cid >= 0.0) & ((cx - rx * 0.0).abs() <= 1.0)
              & ((cy - ry * 0.0).abs() <= 1.0)
              & ((cz - rz * 0.0).abs() <= 1.0))
    g = member.float() * lane_gate
    dx = rx - cand[:, :, :, 0]
    dy = ry - cand[:, :, :, 1]
    dz = rz - cand[:, :, :, 2]
    r2 = dx * dx + dy * dy + dz * dz
    rho_j = cand[:, :, :, 7]
    rho_ok = rho_j > 1e-6
    inv_rho = torch.where(rho_ok, 1.0, 0.0) / torch.where(rho_ok, rho_j, 1.0)
    abs_r = torch.sqrt(r2)
    rs = torch.rsqrt(torch.clamp(r2, min=1e-30))
    diff = h - abs_r
    valid = (diff > 1e-6) & (abs_r > 1e-6)
    gwp = torch.where(valid, cg_h6 * diff * diff * diff * rs, 0.0)
    gwv = torch.where(abs_r < h, cg_h6 * diff, 0.0)
    press_i = 150.0 * (row[..., 6] - 1.5)
    press_j = 150.0 * (rho_j - 1.5)
    pc = g * (press_i + press_j) * 0.5 * inv_rho * gwp
    vc = g * gwv * inv_rho
    for k, d in enumerate((dx, dy, dz)):
        out[..., k] = (pc * d).sum((2, 3))
    for k in range(3):
        out[..., 3 + k] = (vc * (cand[:, :, :, 4 + k] - row[..., 3 + k])
                           ).sum((2, 3))
    return out


def _chunks(variant: str, inp: SynthInputs, sl: slice):
    """(chunk indices i64[b, K], evaluated f32[b, K]) of tiles ``sl`` as
    ``variant`` walks them: A, B and E the lines' intervals [k0, k1) of the
    first ``counts`` lines, C the list's entries >= 0, D its first ``fcnt``
    entries >= 0. A step's gated chunks add nothing, so these are the whole
    sum."""
    dev = inp.rows.device
    if variant in ("A", "B", "E"):
        k0, k1 = inp.tiles[sl, 0::2], inp.tiles[sl, 1::2]     # [b, 9]
        width = max(int((k1 - k0).max()), 1)
        idx = k0[..., None] + torch.arange(width, device=dev)
        line = torch.arange(N_LINES, device=dev)[None, :, None]
        valid = (idx < k1[..., None]) & (line < inp.counts[sl, :, None])
        return (idx.clamp(0, W_ROWS - 1).reshape(idx.shape[0], -1).long(),
                valid.reshape(idx.shape[0], -1).float())
    flat = inp.flat[sl]
    valid = flat >= 0
    if variant == "D":
        valid &= torch.arange(MAXC, device=dev) < inp.fcnt[sl]
    return flat.clamp(min=0).long(), valid.float()


def synth_plain(variant: str, inp: SynthInputs) -> torch.Tensor:
    """The script kernel's output f32[T, 64, 8] for ``variant`` (A, C, D, E
    the full pair, B the stripped one) over the chunks its walk evaluates,
    in blocks of tiles."""
    t = inp.rows.shape[0]
    out = inp.rows.new_zeros(t, ROWS, 8)
    for t0 in range(0, t, PLAIN_TILES):
        sl = slice(t0, min(t0 + PLAIN_TILES, t))
        idx, gate = _chunks(variant, inp, sl)
        out[sl, :, :6] = _pair_sums(inp.win[idx], gate, inp.rows[sl],
                                    variant != "B")
    return out


def synth_cuda(variant: str, inp: SynthInputs,
               kname: str | None = None) -> torch.Tensor:
    """Variant ``variant``'s kernel instance on the card."""
    dev = inp.rows.device
    t = inp.rows.shape[0]
    for name, x, dtype, shape in (
            ("win", inp.win, torch.float32, (W_ROWS, N_WF, LANES)),
            ("tiles", inp.tiles, torch.int32, (t, 2 * N_LINES)),
            ("counts", inp.counts, torch.int32, (t, 1)),
            ("flat", inp.flat, torch.int32, (t, MAXC)),
            ("fcnt", inp.fcnt, torch.int32, (t, 1)),
            ("rows", inp.rows, torch.float32, (t, ROWS, N_WF))):
        common.check(name, x, dtype, shape, dev)
    out = torch.empty((t, ROWS, 8), dtype=torch.float32, device=dev)
    fn = cuda_build.probe_function(SOURCE, "probe_loopstruct_synth")
    err = fn(SYNTH.index(variant), *(common.ptr(x) for x in inp[:5]),
             common.ptr(inp.rows), common.ptr(out), t, W_ROWS,
             common.stream(dev))
    common.raise_on_error(f"loopstruct {variant}", err)
    common.count(kname or f"loopstruct_{variant}")
    return out


def synth(variant: str, inp: SynthInputs) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if inp.rows.is_cuda:
        return synth_cuda(variant, inp)
    return synth_plain(variant, inp)


def synth_rule(variant: str, want: torch.Tensor, got: torch.Tensor,
               inp: SynthInputs) -> bool:
    """A, C, D, E: scale-rel within 1e-5 of the plain version. B: each
    row's running sum of its n candidate values within 2·n·u·Σ|xⱼ| of the
    plain version's sum, the rounding bound of two float32 sums of n terms
    in any orders (the script's xⱼ are in [0, 1), so Σ|xⱼ| is the sum)."""
    if not bool(torch.isfinite(got).all()):
        return False
    if variant != "B":
        return common.scale_rel(want[..., :6], got[..., :6]) <= FULL_TOL
    k = torch.arange(MAXC, device=inp.flat.device)
    n = ((k < inp.fcnt) & (inp.flat >= 0)).sum(1, keepdim=True) * LANES
    err = (got[..., 0].double() - want[..., 0].double()).abs()
    return bool((inp.win[:, 0] >= 0).all()) and bool(
        (err <= 2.0 * n.double() * _U32 * want[..., 0].double().abs()).all())


def synth_member_pairs(inp: SynthInputs) -> int:
    """Candidates of the tiles' chunk lists that pass the script's gate,
    times the tile's rows: the pairs whose terms the sums need."""
    cid = inp.win[:, 3, :]
    cz = torch.floor((cid + 0.5) / (R * R))
    rem = cid - cz * (R * R)
    cy = torch.floor((rem + 0.5) / R)
    cx = rem - cy * R
    passing = ((cid >= 0) & (cx.abs() <= 1) & (cy.abs() <= 1)
               & (cz.abs() <= 1)).sum(1)                  # per chunk
    k = torch.arange(MAXC, device=cid.device)
    valid = (k < inp.fcnt) & (inp.flat >= 0)
    per_tile = torch.where(valid, passing[inp.flat.clamp(min=0).long()], 0)
    return int(per_tile.sum()) * ROWS


def synth_bound(variant: str, inp: SynthInputs) -> tuple[float, str]:
    """The data's needs: the inputs and the output once, and the member
    pairs' FP32 work (B: one add a candidate of the lists)."""
    nbytes = sum(x.numel() * x.element_size() for x in inp) \
        + inp.rows.numel() * 4
    evals = synth_evaluations(inp)
    ops = evals if variant == "B" else \
        synth_member_pairs(inp) * common.FORCE_PAIR_OPS
    return common.bound(nbytes, ops)


def synth_evaluations(inp: SynthInputs) -> int:
    """The candidate evaluations the chunk lists ask for (rows × 128 × the
    list's chunks): 369,098,752 at the script's size."""
    k = torch.arange(MAXC, device=inp.flat.device)
    chunks = int(((k < inp.fcnt) & (inp.flat >= 0)).sum())
    return chunks * ROWS * LANES


# ---------------------------------------------------------------- frame --

class FrameInputs(NamedTuple):
    frame: SortedFrame
    rows: torch.Tensor     # f32[N, 8], ρ the frame-start density
    pj: torch.Tensor       # f32[N, 2]
    scal: torch.Tensor     # f32[15]
    phys: PhysParams
    r: int
    cap: int | None


def frame_inputs(cfg: SimConfig, state) -> FrameInputs:
    """K3's inputs at ``state``: the sorted frame, the rows with the
    frame-start density, pj and the scalar block."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    phys = PhysParams.from_config(cfg, state.pos.device)
    frame, (pos_s, vel_s) = build_frame(state.pos, r, cap,
                                        extras=(state.pos, state.vel))
    rho = sk.density_pass(frame, pos_s, phys, r, cap)
    rows = sk.pack_rows(pos_s, vel_s, rho)
    return FrameInputs(frame, rows, sk.pj_cols(rows[:, 6], phys),
                       sk.scal_block(phys), phys, r, cap)


def golden_state(device: torch.device, frames: int = FRAMES,
                 cfg: SimConfig = GOLDEN_CONFIG):
    """The faithful rollout's state after ``frames`` frames."""
    state = initial_state(cfg, device)
    state, _ = make_rollout(cfg, frames, device=device)(state)
    return state


def _window(fin: FrameInputs, ids: torch.Tensor):
    """(cells i64[m, 27], in the grid bool[m, 27]) of rows ``ids``'s
    windows, in walk order (z, y, x)."""
    r = fin.r
    c = sk.fresh_cell(fin.rows[ids, 0:3], r)
    nc = c[:, None, :] + torch.tensor(sk._OFFSETS, dtype=torch.int32,
                                      device=c.device)[None]
    inb = ((nc >= 0) & (nc < r)).all(-1)
    cell = nc[..., 0] + nc[..., 1] * r + nc[..., 2] * (r * r)
    return torch.where(inb, cell, 0).long(), inb


def window_slots(fin: FrameInputs, chunk: int = 1 << 16) -> int:
    """The slots the walk visits, every row's window cells each cut at the
    capacity: the frame form's pair steps."""
    n = fin.rows.shape[0]
    total = 0
    for i0 in range(0, n, chunk):
        ids = torch.arange(i0, min(i0 + chunk, n), device=fin.rows.device)
        cell, inb = _window(fin, ids)
        cnt = fin.frame.start[cell + 1] - fin.frame.start[cell]
        if fin.cap is not None:
            cnt = cnt.clamp(max=fin.cap)
        total += int(torch.where(inb, cnt, 0).sum())
    return total


def ranges_plain(fin: FrameInputs) -> tuple[torch.Tensor, torch.Tensor]:
    """D_f's pre-pass in plain PyTorch: (ranges i32[27, N, 4], count
    i32[N]): each row's non-empty slot ranges (q, e, line + x0, x1 − x0) in
    walk order, entry t of row i at [t, i] (zeros past the count), as
    ``window_walk.cuh::range_walk`` forms them: within a (z, y) line, a
    range runs on from cell to cell until a cell is cut at the capacity
    (its end e = its start + capacity) or the window's last cell ends it;
    the next range starts at the cut cell's end."""
    r, cap, start = fin.r, fin.cap, fin.frame.start.long()
    n = fin.rows.shape[0]
    dev = fin.rows.device
    c = sk.fresh_cell(fin.rows[:, 0:3], r).long()
    x0, x1 = (c[:, 0] - 1).clamp(min=0), (c[:, 0] + 1).clamp(max=r - 1)
    ranges = torch.zeros((MAX_RANGES, n, 4), dtype=torch.int32, device=dev)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            z, y = c[:, 2] + dz, c[:, 1] + dy
            line_ok = (z >= 0) & (z < r) & (y >= 0) & (y < r)
            line = (z.clamp(0, r - 1) * r + y.clamp(0, r - 1)) * r
            q = start[line + x0.clamp(max=r - 1)]
            for dx in (-1, 0, 1):
                x = c[:, 0] + dx
                here = line_ok & (x >= x0) & (x <= x1)
                cell = line + x.clamp(0, r - 1)
                end = start[cell + 1]
                e = end if cap is None else torch.minimum(end, start[cell]
                                                          + cap)
                closes = here & ((e != end) | (x == x1))
                keep = closes & (q < e)
                entry = torch.stack([q, e, line + x0, x1 - x0], 1)
                ranges[count[keep].long(), rows[keep]] = \
                    entry[keep].to(torch.int32)
                count = count + keep.to(torch.int32)
                q = torch.where(closes, end, q)
    return ranges, count


def _check_frame_inputs(fin: FrameInputs) -> torch.device:
    n = fin.rows.shape[0]
    dev = fin.rows.device
    common.check("rows", fin.rows, torch.float32, (n, sk.N_FIELDS), dev)
    common.check("pj", fin.pj, torch.float32, (n, 2), dev)
    common.check("scal", fin.scal, torch.float32, (sk.N_SCAL,), dev)
    common.check("frame.start", fin.frame.start, torch.int32,
                 (fin.r ** 3 + 1,), dev)
    common.check("frame.raw", fin.frame.raw, torch.int32, (n,), dev)
    common.check("frame.occ", fin.frame.occ, torch.bool, (n,), dev)
    return dev


def _cap(fin: FrameInputs) -> int:
    return -1 if fin.cap is None else int(fin.cap)


def ranges_cuda(fin: FrameInputs) -> tuple[torch.Tensor, torch.Tensor]:
    """D_f's pre-pass (``ranges_kernel``) on the card."""
    dev = _check_frame_inputs(fin)
    n = fin.rows.shape[0]
    ranges = torch.zeros((MAX_RANGES, n, 4), dtype=torch.int32, device=dev)
    count = torch.empty(n, dtype=torch.int32, device=dev)
    fn = cuda_build.probe_function(SOURCE, "probe_loopstruct_ranges")
    err = fn(common.ptr(fin.rows), common.ptr(fin.frame.start),
             common.ptr(ranges), common.ptr(count), n, fin.r, _cap(fin),
             common.stream(dev))
    common.raise_on_error("loopstruct ranges", err)
    common.count("loopstruct_ranges")
    return ranges, count


def frame_cuda(variant: str, fin: FrameInputs,
               ranges: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> torch.Tensor:
    """Frame variant ``variant`` on the card: K3's raw sums f32[N, 12]
    (A_f, D_f, E_f; D_f walks ``ranges``, the pre-pass's output) or B_f's
    one sum f32[N]."""
    dev = _check_frame_inputs(fin)
    n = fin.rows.shape[0]
    if variant == "D_f":
        common.check("ranges", ranges[0], torch.int32, (MAX_RANGES, n, 4),
                     dev)
        common.check("count", ranges[1], torch.int32, (n,), dev)
        rg, cnt = ranges
    else:
        rg = cnt = fin.rows          # not read
    shape = (n,) if variant == "B_f" else (n, sk.N_SUMS)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    fn = cuda_build.probe_function(SOURCE, "probe_loopstruct_frame")
    err = fn(FRAME.index(variant), common.ptr(fin.rows), common.ptr(fin.pj),
             common.ptr(fin.frame.start), common.ptr(fin.frame.raw),
             common.ptr(fin.frame.occ), common.ptr(fin.scal),
             common.ptr(rg), common.ptr(cnt), common.ptr(out), n, fin.r,
             _cap(fin), common.stream(dev))
    common.raise_on_error(f"loopstruct {variant}", err)
    common.count(f"loopstruct_{variant}")
    return out


def walk_sum_plain(fin: FrameInputs
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """B_f's plain version: (Σⱼ xⱼ over each row's members, j ≠ i, in the
    fixed tree order, the member count) per row."""
    frame, rows, r = fin.frame, fin.rows, fin.r
    n = rows.shape[0]
    width = sk._window_width(frame, fin.cap)
    chunk = max(1, (1 << 21) // (27 * width))
    total = rows.new_zeros(n)
    members = torch.zeros(n, dtype=torch.int64, device=rows.device)
    for i0 in range(0, n, chunk):
        ids = torch.arange(i0, min(i0 + chunk, n), device=rows.device)
        j, member = sk._candidates(frame, sk.fresh_cell(rows[ids, 0:3], r),
                                   r, width)
        member = member & (j != ids[:, None])
        total[ids] = sk._tree_sum(torch.where(member, rows[j, 0], 0.0))
        members[ids] = member.sum(1)
    return total, members


def walk_sum_rule(got: torch.Tensor, want: torch.Tensor,
                  members: torch.Tensor) -> bool:
    """|k − p| ≤ 2·m·u·Σ|xⱼ| per row (m members; xⱼ ≥ 0, so Σ|xⱼ| = p):
    the rounding of two float32 sums of m terms in any orders."""
    err = (got.double() - want.double()).abs()
    return bool((err <= 2.0 * members.double() * _U32
                 * want.double().abs()).all())


def frame_hold(fin: FrameInputs, sums: torch.Tensor,
               ref: sk.Reference) -> sk.Accuracy:
    """K3's rule (``sph_kernels.forces_accuracy``): the raw sums folded and
    held to the plain version particle by particle."""
    f, _ = sk.fold_forces(sums, fin.rows[:, 6], fin.phys)
    return sk.hold(f, ref)


def frame_bound(variant: str, fin: FrameInputs,
                pairs: int) -> tuple[float, str]:
    """K3's bound without extensions (chip_smoke.py's ``bound("forces",
    ...)``: rows, pj and the sums once, start[] and the scalars; 32
    operations a member pair, 6 a row) for A_f, D_f and E_f; B_f reads the
    positions, raw and occ and writes one float, one add a member pair."""
    n, r = fin.rows.shape[0], fin.r
    table = 4 * (r ** 3 + 1) + 4 * sk.N_SCAL
    if variant == "B_f":
        return common.bound(n * (32 + 4 + 1 + 4) + table, pairs)
    return common.bound(n * (32 + 4 + 1 + 48 + 8) + table,
                        pairs * common.FORCE_PAIR_OPS + 6 * n)


# ------------------------------------------------------------------ run --

def run(device=None, groups: int = GROUPS, cfg: SimConfig = GOLDEN_CONFIG,
        state=None, frames: int = FRAMES) -> dict:
    """Both forms: each variant against its plain version, timed, with its
    ns per pair step and its share of the FP32 bound; the frame form at
    ``state`` (None: ``cfg``'s faithful rollout after ``frames``
    frames). Prints its lines and returns the kernels' numbers."""
    dev = common.resolve(device)
    ident = common.identity(dev)
    common.reset_peak_memory(dev)
    inp = to_device(synth_inputs(np.random.RandomState(0), groups), dev)
    opened = gate_open(inp)
    evals = synth_evaluations(inp)
    dense_ms = 1e3 * evals * common.FORCE_PAIR_OPS / common.FP32_OPS_PER_S
    kernels, ok_all, times = {}, True, {}
    for v in SYNTH:
        got = synth(v, inp)
        want = synth_plain(v, inp)
        ok = synth_rule(v, want, got, inp)
        err = common.max_abs(want[..., :6], got[..., :6])
        if v != "B":          # the sums of every candidate
            want_o = synth_plain(v, opened)
            ok &= synth_rule(v, want_o, synth(v, opened), opened)
        ok_all &= ok
        ms = common.time_ms(lambda: synth(v, inp), dev)
        plain_ms = common.time_ms(lambda: synth_plain(v, inp), dev, reps=1)
        b = synth_bound(v, inp)
        times[v] = ms
        per = "" if ms is None else (
            f" ({ms * 1e6 / evals:.4f} ns per pair step, "
            f"{100 * dense_ms / ms:.2f}% of the FP32 bound of its {evals} "
            f"candidate evaluations)")
        print(f"variant {v}: {'OK' if ok else 'MISMATCH'} (scale-rel "
              f"{common.scale_rel(want[..., :6], got[..., :6]):.3e}); "
              f"kernel {common.fmt_ms(ms)}{per}; plain "
              f"{common.fmt_ms(plain_ms)}; bound {b[0]:.5f} ms ({b[1]}) "
              f"[{ident}]", flush=True)
        kernels[f"loopstruct_{v}"] = common.kernel_record(
            "loopstruct.cu", REPLACES, ms, plain_ms, b, err, ok,
            library="none: no PyTorch call computes the gated walk",
            pair_steps=evals)
    if times["A"] is not None:
        print(f"synthetic walk share B / A: {times['B'] / times['A']:.4f} "
              f"[{ident}]", flush=True)

    if state is None:
        state = golden_state(dev, frames, cfg)
    fin = frame_inputs(cfg, state)
    n = fin.rows.shape[0]
    slots = window_slots(fin)
    tot, own = sk.member_pairs(fin.frame, fin.rows[:, 0:3], fin.r, fin.cap)
    ref = sk.forces_reference(fin.frame, fin.rows, fin.phys, fin.r, fin.cap)
    rg = ranges_cuda(fin) if dev.type == "cuda" else None
    rg_plain = ranges_plain(fin)
    if rg is not None:
        ok = bool((rg[1] == rg_plain[1]).all()) and bool(
            (rg[0] == rg_plain[0]).all())
        ms = common.time_ms(lambda: ranges_cuda(fin), dev)
        plain_ms = common.time_ms(lambda: ranges_plain(fin), dev, reps=1)
        b = common.bound(n * (12 + 4) + 4 * (fin.r ** 3 + 1)
                         + int(rg_plain[1].sum()) * 16)
        print(f"D_f pre-pass: {'OK' if ok else 'MISMATCH'} "
              f"({int(rg_plain[1].sum())} ranges, "
              f"{float(rg_plain[1].double().mean()):.2f} a row); kernel "
              f"{common.fmt_ms(ms)}, plain {common.fmt_ms(plain_ms)}, bound "
              f"{b[0]:.5f} ms [{ident}]", flush=True)
        ok_all &= ok
        kernels["loopstruct_ranges"] = common.kernel_record(
            "loopstruct.cu", REPLACES, ms, plain_ms, b,
            0.0 if ok else float("inf"), ok,
            library="none: no PyTorch call forms the ranges")
    print(f"frame: {n} particles, R = {fin.r}, capacity {fin.cap}; {slots} "
          f"slots walked ({slots / n:.2f} a row), {tot - own} member pairs "
          f"(self excluded) [{ident}]", flush=True)
    b_sum, b_members = walk_sum_plain(fin)
    for v in FRAME:
        if dev.type == "cuda":
            got = frame_cuda(v, fin, rg)
            call = (lambda v=v: frame_cuda(v, fin, rg))
        else:
            got = (sk.forces_plain(fin.frame, fin.rows, fin.phys, fin.r,
                                   fin.cap) if v != "B_f" else b_sum)
            call = None
        if v == "B_f":
            ok = walk_sum_rule(got, b_sum, b_members)
            err = common.max_abs(b_sum, got)
            plain = (lambda: walk_sum_plain(fin))
            extra = ""
        else:
            acc = frame_hold(fin, got, ref)
            ok, err = acc.ok, acc.err
            plain = (lambda: sk.forces_plain(fin.frame, fin.rows, fin.phys,
                                             fin.r, fin.cap))
            extra = (f" (K3's rule: {acc.n_over} lanes over, "
                     f"{acc.roundings:.1f} roundings)")
        ok_all &= ok
        ms = None if call is None else common.time_ms(call, dev)
        plain_ms = common.time_ms(plain, dev, reps=1)
        b = frame_bound(v, fin, tot - own)
        times[v] = ms
        per = "" if ms is None else (
            f" ({ms * 1e6 / slots:.4f} ns per pair step, "
            f"{100 * b[0] / ms:.2f}% of the bound)")
        print(f"variant {v}: {'OK' if ok else 'MISMATCH'}{extra}; kernel "
              f"{common.fmt_ms(ms)}{per}; plain {common.fmt_ms(plain_ms)}; "
              f"bound {b[0]:.5f} ms ({b[1]}) [{ident}]", flush=True)
        kernels[f"loopstruct_{v}"] = common.kernel_record(
            "loopstruct.cu", REPLACES, ms, plain_ms, b, err, ok,
            library="none: no PyTorch call computes the window walk",
            pair_steps=slots)
    share = None
    if times["A_f"] is not None:
        share = times["B_f"] / times["A_f"]
        k3 = sk.forces_cuda(fin.frame, fin.rows, fin.phys, fin.r, fin.cap,
                            False, fin.pj, fin.scal)
        same = bool((k3.view(torch.int32) == frame_cuda(
            "A_f", fin).view(torch.int32)).all())
        # the walk share is K3's only while A_f is K3 bit for bit
        ok_all &= same
        print(f"walk share B_f / A_f: {share:.4f}; A_f bit-equal to K3: "
              f"{same} [{ident}]", flush=True)
    common.print_peak_memory("loopstruct", dev, ident)
    return {"ok": ok_all, "kernels": kernels, "walk_share": share,
            "frame_slots": slots, "frame_pairs": tot - own}
