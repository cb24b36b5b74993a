"""Site-grid SPH backend: the exactness and decomposition tier.

Counterpart of ``sphfluidsimulation_tpu/ops/sites.py``, function for
function: ``frame_binding`` (:95), ``JSites``/``ISites`` (:129-158),
``_site_slots`` (:160), ``build_j_sites`` (:197), ``build_i_sites`` (:277),
the window scan (:364-441), ``make_density_pass`` (:444),
``make_force_pass`` (:477), ``combine_forces`` (:580), ``_escalated``
(:627), ``density_sites`` (:636), ``fluid_forces_sites`` (:661),
``auto_bands`` (:710) and ``_banded_pass`` (:722). The JAX module reaches
no ``pl.pallas_call``; this one is plain PyTorch on the device of its
inputs, with no hand-written kernel. ``auto_bands`` is JAX's band rule,
sized for TPU worker memory; on a card ``bands_for`` runs one piece
wherever the card's free memory holds it.

Candidates live in a dense voxel-slot grid ``field[k, c]`` (slot k, flat
cell c = x + y·R + z·R²), so the candidates of cell c at window offset
(ox, oy, oz) are ``field[:, c + ox + oy·R + oz·R²]``: a uniform shift of the
whole array. Slots hold SITES, groups of particles sharing (cell, position
[, ρ][, v]) with a multiplicity and a velocity sum: every pair term is
position-only or linear in the velocities, so per-site sums combine with
the per-particle (ρᵢ, pᵢ, vᵢ) afterwards (the JAX docstring, :25-43). Both
grids are rebuilt every substep: the j-grid keyed by the frame-stale cell
with fresh values (the reference's stale bucket), the i-grid by the fresh
cell (its fresh-centred window). At spawn, positions outside the cube get a
clamped i-cell and a per-site δ ∈ {−1, 0, 1}; while max|δ| > 0 the pass runs
at radius 2 or 3 with an ``|off − δ| ≤ 1`` gate (``_escalated``). Empty
slots and padded margins hold position ``FAR`` = 2, where every kernel
vanishes.

What the port fixes, where JAX leaves a choice to XLA:

- Site keys. ``lax.sort`` sorts several keys lexicographically with floats
  canonicalised (−0.0 equal to 0.0, every NaN equal and last); the port
  maps each float to an int32 key with the same order (``_sort_key``),
  packs the keys two to an int64 and sorts stably, least significant first
  (``_lex_order``). Sites are then grouped by ``!=`` on the sorted values,
  as in JAX, so the slots and site ranks are integer-equal to JAX's.
- Site sums. A site's multiplicity and velocity sum add its members in
  sorted order (``torch.segment_reduce`` over the runs of the sort), which
  is deterministic on both devices; per-site values are written from each
  run's first row, so no index is written twice.
- The pair fold. For each window offset the pair terms of all i- and
  j-slots are one broadcast [Ki, Kj, cells] block, as in JAX's dense pass
  (:457-465); its j-slot sum is a fixed pairwise tree of elementwise adds
  (``_fold_kj``) where JAX leaves the reduction order to XLA (and folds
  one slot at a time above ``KJ_SCAN_CELLS``, :364-389). The cells are cut
  into blocks of at most ``_BLOCK_ELEMS`` pair terms (JAX's concern at
  262k, where a dense [32, 32, S] temporary is 425 MB), and slots empty in
  every cell are cut before the pass (but one). Every op is elementwise, so a site's
  sum does not depend on the grid's extent or the blocking: the banded
  pass is bit-identical to the one-piece pass on each device (JAX pins
  this on the TPU only, :733-736).
- The spawn escalation. At radius w > 1 JAX sweeps all (2w + 1)³ offsets
  with an ``|off − δ| ≤ 1`` gate; the port sweeps the same offsets, in the
  same order, as each site's 27 offsets δ + o (``_window_scan``).
- ``_escalated`` reads max|δ| on the host (one synchronisation a pass) and
  runs the matching radius; JAX's ``lax.switch`` runs the same branch.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..config import EPSILON
from ..params import PhysParams
from . import grid, sph_math

_PI = math.pi
FAR = 2.0  # empty-slot position: ≥ 1 + h from any in-cube point ⇒ kernels ≡ 0


# ---------------------------------------------------------------------------
# frame binding (the reference's once-per-frame bucket insert)
# ---------------------------------------------------------------------------


def frame_binding(pos: torch.Tensor, r: int, cap: int | None):
    """Frame-start bucket membership per particle.

    Returns (stale_cid i32[N], in_cap bool[N], overflow i32[]):
    ``stale_cid`` is the flat voxel id with the reference's aliasing
    arithmetic (Bucket.compute:27-28); ``in_cap`` marks the particles in
    the reference's bucket (rank < cap within their voxel by a stable sort,
    and an in-range id). ``cap=None`` drops nothing but out-of-range ids.
    """
    n = pos.shape[0]
    cid = grid.flat_cell_id(sph_math.cell_index(pos, r), r)
    in_range = (cid >= 0) & (cid < r * r * r)
    if cap is None:
        return cid, in_range, (~in_range).sum().to(torch.int32)
    order = torch.sort(cid, stable=True).indices
    rank_sorted = (torch.arange(n, dtype=torch.int32, device=pos.device)
                   - grid.run_starts(cid[order]))
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    in_cap = in_range & (rank < cap)
    return cid, in_cap, (~in_cap).sum().to(torch.int32)


# ---------------------------------------------------------------------------
# site builds
# ---------------------------------------------------------------------------


class JSites(NamedTuple):
    """Per-substep candidate grid: the stale bucket carrying fresh values,
    deduplicated into sites. All [Kj, S] float32 unless noted."""

    pos: torch.Tensor           # [3, Kj, S] fresh site position; empty FAR
    a: torch.Tensor             # mult/(2ρ) (ρ > ε guard folded); the raw
                                # mult in the rho=None density build
    bp: torch.Tensor | None     # p·mult/(2ρ)
    cv: torch.Tensor | None     # [3, Kj, S] ΣV/ρ
    dv: torch.Tensor | None     # mult/ρ
    rho: torch.Tensor | None    # stale ρ (xsph/avisc only)
    mult: torch.Tensor | None   # site multiplicity (xsph/avisc only)
    vsum: torch.Tensor | None   # [3, Kj, S] ΣV (xsph only)
    vel: torch.Tensor | None    # [3, Kj, S] per-site velocity (avisc only)
    cert: torch.Tensor          # i32[] bucket candidates with no site slot


class ISites(NamedTuple):
    """Per-substep evaluation grid: unique fresh (position, ρ) sites keyed
    by the fresh voxel. All [Ki, S]."""

    pos: torch.Tensor           # [3, Ki, S]; empty FAR
    rho: torch.Tensor | None    # stale ρ per site (None for the density pass)
    vel: torch.Tensor | None    # [3, Ki, S] per-site velocity (avisc only)
    delta: torch.Tensor         # i32[3, Ki, S] true fresh cell − clamped cell
    dmax: torch.Tensor          # i32[] max |delta| (0 after the first clamp)
    slot_of: torch.Tensor       # i32[N] flat site index; Ki·S if dropped
    cert: torch.Tensor          # i32[] particles with no evaluation site
    occ: torch.Tensor           # bool[Ki, S]


def _sort_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key whose order is ``lax.sort``'s order of the float32 ``x``:
    −0.0 equal to 0.0, every NaN equal and after +inf."""
    c = torch.where(x == 0, 0.0, x)
    c = torch.where(torch.isnan(c), float("nan"), c).contiguous()
    b = c.view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _lex_order(keys: list[torch.Tensor]) -> torch.Tensor:
    """The stable lexicographic order (i64[N]) of int32 ``keys``, most
    significant first: two keys packed to an int64 a sort, least
    significant pair first."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    rest = list(keys)
    while rest:
        lo = rest.pop().to(torch.int64) + 2**31
        key = lo if not rest else rest.pop().to(torch.int64) * 2**32 + lo
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


class _Runs(NamedTuple):
    """A site build's sort: ``slot`` i32[N] (sorted order; sentinel k·s),
    ``order`` i64[N], ``first`` bool[N] (the row starts a run of equal
    keys, i.e. a site or a dropped group) and ``lengths`` i64[N] (the run's
    length on its first row, else 0)."""

    slot: torch.Tensor
    order: torch.Tensor
    first: torch.Tensor
    lengths: torch.Tensor


def _site_runs(keys: list[torch.Tensor], cid: torch.Tensor, s: int, k: int,
               in_range: torch.Tensor | None) -> _Runs:
    """The dedup machinery of ``_site_slots`` (JAX :160-195) with the runs
    of the sort kept for the site sums."""
    n = cid.shape[0]
    dev = cid.device
    cmp = ([] if in_range is None else [(~in_range).to(torch.int32)]) + keys
    order = _lex_order([cid] + [v if v.dtype == torch.int32 else _sort_key(v)
                                for v in cmp])
    sorted_cid = cid[order]
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[:1] = True
    for v in [sorted_cid] + [v[order] for v in cmp]:
        first[1:] |= v[1:] != v[:-1]
    g = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    site_rank = g - g[grid.run_starts(sorted_cid).long()]
    ok = site_rank < k
    if in_range is None:
        ok = ok & (sorted_cid >= 0) & (sorted_cid < s)
    else:
        ok = ok & in_range[order]
    slot = torch.where(ok, site_rank.to(torch.int64) * s
                       + sorted_cid.clamp(0, s - 1), k * s).to(torch.int32)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    nxt = torch.where(first, idx, n).flip(0).cummin(0).values.flip(0)
    nxt = torch.cat([nxt[1:], nxt.new_full((1,), n)])
    return _Runs(slot, order, first, torch.where(first, nxt - idx, 0))


def _site_slots(keys: list[torch.Tensor], cid: torch.Tensor, n: int, s: int,
                k: int, in_range: torch.Tensor | None):
    """Shared dedup machinery: stable sort by (cid[, member], *keys), site
    ranks within each voxel, per-particle slot index (k·S + cid layout,
    sentinel k·S). Returns (slot i32[N] in sorted order, order i32[N]),
    integer-equal to JAX's.

    With a member mask, members sort AHEAD of non-members within each voxel
    so their site ranks never count ghost sites."""
    runs = _site_runs(keys, cid, s, k, in_range)
    return runs.slot, runs.order.to(torch.int32)


def _put(runs: _Runs, vals_sorted: torch.Tensor, k: int, s: int,
         fill: float | int = 0.0) -> torch.Tensor:
    """[..., K, S] grid with each site's value (from its run's first row;
    members of a site are equal under ``!=``) and ``fill`` elsewhere;
    ``vals_sorted`` is [N] or [N, C] in sorted order."""
    idx = torch.where(runs.first, runs.slot, k * s).long()
    out = vals_sorted.new_full((k * s + 1,) + vals_sorted.shape[1:], fill)
    out[idx] = vals_sorted
    return out[:k * s].movedim(0, -1).reshape(vals_sorted.shape[1:] + (k, s))


def _add(runs: _Runs, vals_sorted: torch.Tensor, k: int,
         s: int) -> torch.Tensor:
    """[..., K, S] grid of each site's sum of ``vals_sorted`` over its
    members, added in sorted order."""
    sums = torch.segment_reduce(vals_sorted, "sum", lengths=runs.lengths,
                                axis=0)
    return _put(runs, sums, k, s)


def build_j_sites(stale_cid: torch.Tensor, in_cap: torch.Tensor,
                  pos: torch.Tensor, vel: torch.Tensor | None,
                  rho: torch.Tensor | None, r: int, kj: int, p: PhysParams,
                  *, xsph: bool = False, avisc: bool = False,
                  grid_s: int | None = None,
                  member: torch.Tensor | None = None,
                  cert_member: torch.Tensor | None = None) -> JSites:
    """The stale bucket re-expressed with fresh values, as sites (JAX
    :197-274).

    Site key: (stale flat cell, fresh position[, stale ρ][, fresh velocity
    when avisc]); only ``in_cap`` rows take part (rows the reference's
    32-slot cap drops carry zero weight in every field). ``rho=None``
    builds the position-only grid of the density pass. ``grid_s``/
    ``member`` build slab-local and z-banded grids (``stale_cid`` local, the
    grid ``grid_s`` cells, ``member`` the rows allowed to occupy sites);
    ``cert_member`` restricts which capacity-dropped rows the certificate
    counts (each voxel's drops counted by one band only).

    The site multiplicity is kept whenever xsph or avisc is on: the
    artificial viscosity weighs each site by it (JAX keeps it for xsph
    only, so its avisc-only force pass raises; ROADMAP.md queue C).
    """
    s = grid_s if grid_s is not None else r * r * r
    keys = [pos[:, 0], pos[:, 1], pos[:, 2]]
    if rho is not None:
        keys.append(rho)
    if avisc:
        keys += [vel[:, 0], vel[:, 1], vel[:, 2]]
    ms = in_cap if member is None else (member & in_cap)
    runs = _site_runs(keys, stale_cid, s, kj, ms)
    order = runs.order
    w = in_cap[order].to(torch.float32)
    pos_s = _put(runs, pos[order], kj, s, FAR)
    mult = _add(runs, w, kj, s)
    wc = w if cert_member is None else (in_cap & cert_member)[order].to(
        torch.float32)
    cert = torch.where(runs.slot >= kj * s, wc, 0.0).sum().to(torch.int32)
    if rho is None:
        return JSites(pos=pos_s, a=mult, bp=None, cv=None, dv=None,
                      rho=None, mult=None, vsum=None, vel=None, cert=cert)

    vsum = _add(runs, vel[order] * w[:, None], kj, s)
    rho_s = _put(runs, rho[order], kj, s)
    press = p.gas_constant * (rho_s - p.rest_density)
    irho2 = torch.where(rho_s > EPSILON, 0.5 / rho_s.clamp(min=EPSILON), 0.0)
    a = mult * irho2
    return JSites(
        pos=pos_s, a=a, bp=press * a, cv=vsum * (2.0 * irho2),
        dv=mult * (2.0 * irho2),
        rho=rho_s if (xsph or avisc) else None,
        mult=mult if (xsph or avisc) else None,
        vsum=vsum if xsph else None,
        vel=_put(runs, vel[order], kj, s) if avisc else None,
        cert=cert)


def build_i_sites(pos: torch.Tensor, vel: torch.Tensor | None,
                  rho: torch.Tensor | None, r: int, ki: int, *,
                  avisc: bool = False, grid_s: int | None = None,
                  zbase: int = 0,
                  member: torch.Tensor | None = None) -> ISites:
    """Evaluation sites keyed by the fresh voxel, clamped into range; the
    out-of-range remainder δ widens the window (spawn jitter only). JAX
    :277-328.

    ``grid_s``/``zbase``/``member`` build a z-band-local grid (cells
    [zbase·R², zbase·R² + grid_s) of the global id space): only ``member``
    rows compete for sites or count toward the certificate."""
    n = pos.shape[0]
    s = grid_s if grid_s is not None else r * r * r
    cell = sph_math.cell_index(pos, r)
    clamped = cell.clamp(0, r - 1)
    cid = grid.flat_cell_id(clamped, r)
    if grid_s is not None:
        cid = cid - zbase * (r * r)
    keys = [pos[:, 0], pos[:, 1], pos[:, 2]]
    if rho is not None:
        keys.append(rho)
    if avisc:
        keys += [vel[:, 0], vel[:, 1], vel[:, 2]]
    mem = (torch.ones(n, dtype=torch.bool, device=pos.device)
           if member is None else member)
    runs = _site_runs(keys, cid, s, ki, mem)
    order = runs.order
    slot_of = torch.empty_like(runs.slot)
    slot_of[order] = runs.slot

    pos_s = _put(runs, pos[order], ki, s, FAR)
    occ = _put(runs, torch.ones(n, dtype=torch.bool, device=pos.device),
               ki, s, False)
    d = cell - clamped
    delta = _put(runs, d[order], ki, s, 0)
    # certificate: particles with no evaluation site (capacity) or beyond
    # the widest window's δ coverage (spawn overshoot > 2 cells)
    cert = (((runs.slot >= ki * s) & mem[order]).sum()
            + ((d.abs().amax(-1) > 2) & mem).sum()).to(torch.int32)
    return ISites(
        pos=pos_s, rho=None if rho is None else _put(runs, rho[order], ki, s),
        vel=_put(runs, vel[order], ki, s) if avisc else None,
        delta=delta, dmax=delta.abs().amax().to(torch.int32),
        slot_of=slot_of, cert=cert, occ=occ)


# ---------------------------------------------------------------------------
# pair passes (shifted-slice window scans)
# ---------------------------------------------------------------------------

# the largest [Ki, Kj, cells] block of pair terms a pass step evaluates: the
# cells are cut into chunks this size (elementwise ops only, so the chunking
# changes no bit of a result)
_BLOCK_ELEMS = 1 << 23


def _cell_coords(r: int, s: int, zbase: int, device):
    """Global (x, y, z) of the flat ids [0, s); ``zbase`` maps a slab- or
    band-local grid back to global z."""
    c = torch.arange(s, dtype=torch.int32, device=device)
    return c % r, (c // r) % r, c // (r * r) + zbase


def _in_grid(coords, r: int, ox, oy, oz) -> torch.Tensor:
    """The bounds check of Density.compute:46: window cell inside the grid.
    Callers SELECT on it: 0 · inf would leak NaN from windows the
    reference never evaluates."""
    cx, cy, cz = coords
    return ((cx + ox >= 0) & (cx + ox < r) & (cy + oy >= 0) & (cy + oy < r)
            & (cz + oz >= 0) & (cz + oz < r))


def _fold_kj(t: torch.Tensor) -> torch.Tensor:
    """Sum over the j-slot axis (dim −2) in a fixed pairwise order, with
    elementwise adds only; the axis is zero-padded to a power of two. Slots
    whose terms are zero may be cut or added without changing a sum's
    value, so the fold agrees across grids trimmed to different widths."""
    k = t.shape[-2]
    width = _pow2(k)
    if width != k:
        t = F.pad(t, (0, 0, 0, width - k))
    while t.shape[-2] > 1:
        half = t.shape[-2] // 2
        t = t[..., :half, :] + t[..., half:, :]
    return t[..., 0, :]


def _occupied(flags: torch.Tensor) -> int:
    """1 + the last slot (dim −2 of ``flags`` [K, S]) occupied anywhere."""
    used = torch.nonzero(flags.any(-1))
    return int(used[-1]) + 1 if used.numel() else 1


def _pow2(k: int) -> int:
    return 1 << max(k - 1, 0).bit_length()


def _window_scan(jarrs: dict[str, torch.Tensor],
                 iarrs: dict[str, torch.Tensor], r: int, s: int, w: int,
                 zbase: int, delta: torch.Tensor | None, terms: Callable,
                 names: dict[str, int]) -> dict[str, torch.Tensor]:
    """The offset-window sweep of JAX ``_window_scan`` (:392-441).

    ``jarrs`` are j-side arrays [..., Kj, S] (``pos`` padded FAR, the rest
    0), ``iarrs`` i-side arrays [..., Ki, S]. For each window offset, in
    JAX's order (z outer, x inner), ``terms(jf, if_)`` gives the pair terms
    [..., Ki, Kj, C] of a block of C cells; each sum folds its j-slots
    (``_fold_kj``) and adds them gated by a select, ``acc + where(g, ·,
    0)``. ``names`` maps each sum to its number of leading dims (0 or 1,
    the xyz axis).

    Radius 1 reads each offset's j-slots as a uniform shift of the grid.
    At radius w > 1 (spawn frames) JAX sweeps all (2w + 1)³ offsets with
    the gate |off − δ| ≤ 1; the same offsets pass that gate when each site
    takes the 27 offsets δ + o (o ∈ [−1, 1]³, |δ + o| ≤ w), in the same
    order, so the port sweeps those, gathering each site's shifted
    j-slots. Offsets the gate drops add exactly +0.0 in JAX."""
    pad = w * (r * r + r + 1)
    padded = {k: F.pad(v, (pad, pad), value=FAR if k == "pos" else 0.0)
              for k, v in jarrs.items()}
    ki, kj = iarrs["pos"].shape[-2], jarrs["pos"].shape[-2]
    dev = jarrs["pos"].device
    coords = _cell_coords(r, s, zbase, dev)
    acc = {k: torch.zeros((3,) * nd + (ki, s), dtype=torch.float32,
                          device=dev) for k, nd in names.items()}
    chunk = max(1, _BLOCK_ELEMS // (ki * kj))
    for c0 in range(0, s, chunk):
        c1 = min(s, c0 + chunk)
        cc = tuple(x[c0:c1] for x in coords)
        if_ = {k: v[..., c0:c1].unsqueeze(-2) for k, v in iarrs.items()}
        cell = torch.arange(c0, c1, dtype=torch.int64, device=dev)
        for oz in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for ox in (-1, 0, 1):
                    if delta is None:
                        g = _in_grid(cc, r, ox, oy, oz)[None, :]
                        st = pad + oz * (r * r) + oy * r + ox
                        jf = {k: v[..., None, :, st + c0:st + c1]
                              for k, v in padded.items()}
                    else:
                        dl = delta[..., c0:c1]
                        offx, offy, offz = dl[0] + ox, dl[1] + oy, dl[2] + oz
                        g = (_in_grid(cc, r, offx, offy, offz)
                             & (offx.abs() <= w) & (offy.abs() <= w)
                             & (offz.abs() <= w))
                        idx = (pad + cell + offz * (r * r) + offy * r
                               + offx).clamp(0, s + 2 * pad - 1)
                        jf = {k: v[..., :, idx].transpose(-3, -2)
                              for k, v in padded.items()}
                    for k, t in terms(jf, if_).items():
                        a = acc[k][..., c0:c1]
                        a += torch.where(g, _fold_kj(t), 0.0)
    return acc


def _trimmed(i: ISites, j: JSites, jfields: dict, ifields: dict):
    """The fields a pass reads, cut to the i-slots occupied anywhere and to
    the j-slots occupied anywhere plus at least one empty j-slot, rounded up
    to a power of two (the width ``_fold_kj`` folds). The sums of occupied
    i-sites keep their values: every empty j-slot has the same fields (FAR,
    zeros), so its term is the same for all of them, ±0, or NaN where the
    artificial viscosity meets an infinite velocity (0 · inf), and one of
    them gives the sum of all of them."""
    ki = _occupied(i.occ)
    kj = min(_pow2(_occupied(j.pos[0] != FAR) + 1), j.pos.shape[-2])
    return ({k: v[..., :kj, :] for k, v in jfields.items()},
            {k: v[..., :ki, :] for k, v in ifields.items()},
            i.delta[..., :ki, :])


def _untrim(acc: dict, ki: int) -> dict:
    """The sums padded back to all Ki i-slots (the trimmed-off are 0)."""
    return {k: F.pad(v, (0, 0, 0, ki - v.shape[-2])) for k, v in acc.items()}


def make_density_pass(r: int, s: int, w: int, zbase: int = 0):
    """ρ per i-site (Density.compute:32-60; the self term included through
    the site's own multiplicity at offset 0). ``s``/``zbase`` may describe
    a slab- or band-local grid."""

    def run(i: ISites, j: JSites, p: PhysParams) -> torch.Tensor:
        h2, h9 = p.h * p.h, p.h ** 9

        def terms(jf, if_):
            d = if_["pos"] - jf["pos"]
            d2 = d * d
            diff = h2 - (d2[0] + d2[1] + d2[2])
            wk = torch.where(diff > 0, diff * diff * diff, 0.0)
            return {"rho": wk * jf["a"]}

        # j arrays: positions and the multiplicity (JSites.a of the
        # rho=None build)
        jfs, ifs, delta = _trimmed(i, j, {"pos": j.pos, "a": j.a},
                                   {"pos": i.pos})
        acc = _window_scan(jfs, ifs, r, s, w, zbase,
                           delta if w > 1 else None, terms, {"rho": 0})
        c6 = 315.0 / (64.0 * _PI)
        return _untrim(acc, i.occ.shape[0])["rho"] * (p.mass * c6 / h9)

    return run


def make_force_pass(r: int, s: int, w: int, *, xsph: float = 0.0,
                    alpha_visc: float = 0.0, zbase: int = 0):
    """Per-i-site force field sums (VelPos.compute:49-105) + extensions,
    JAX :477-577. Accumulates, per i-site (3-vectors stacked [3, Ki, S]):

        pa = Σ mult_j/(2ρ_j) ∇W_p            (× p_i · c_p · m²/ρ_i later)
        pb = Σ p_j mult_j/(2ρ_j) ∇W_p        (× c_p · m²/ρ_i later)
        vb = Σ (ΣV)_j/ρ_j · ∇²W_v profile    (× c_v · μm²/ρ_i later)
        vc = Σ mult_j/ρ_j · ∇²W_v profile    (× v_i · same scale later)
        av = Σ Π_sj mult_j ∇W_p              (× c_p · m² later, avisc)
        xv = Σ 2m/(ρ_i+ρ_j) W (ΣV)_j         (xsph)
        xm = Σ 2m/(ρ_i+ρ_j) W mult_j         (× v_i, xsph)

    with ∇W_p profile (h−r)³/r and ∇²W_v profile (h−r); constants applied
    in ``combine_forces``. Returns a dict of these sums."""
    use_x, use_a = xsph != 0.0, alpha_visc != 0.0

    def run(i: ISites, j: JSites, p: PhysParams) -> dict:
        h2 = p.h * p.h
        cs = torch.sqrt(p.gas_constant)
        jarrs = {"pos": j.pos, "a": j.a, "bp": j.bp, "cv": j.cv, "dv": j.dv}
        iarrs = {"pos": i.pos}
        if use_a or use_x:
            jarrs.update(rho=j.rho, mult=j.mult)
            iarrs["rho"] = i.rho
        if use_a:
            jarrs["vel"] = j.vel
            iarrs["vel"] = i.vel
        if use_x:
            jarrs["vsum"] = j.vsum

        def terms(jf, if_):
            d = if_["pos"] - jf["pos"]
            d2 = d * d
            r2 = d2[0] + d2[1] + d2[2]
            abs_r = torch.sqrt(r2)
            diff = p.h - abs_r
            valid = (diff > EPSILON) & (abs_r > EPSILON)
            safe = torch.where(valid, abs_r, 1.0)
            gwp = torch.where(valid, (diff * diff * diff) / safe, 0.0)
            gwv = torch.where(abs_r < p.h, diff, 0.0)
            out = {"pa": (gwp * jf["a"]) * d, "pb": (gwp * jf["bp"]) * d,
                   "vb": gwv * jf["cv"], "vc": gwv * jf["dv"]}
            if use_a:
                # Monaghan Π for approaching pairs (extensions.py); sites
                # carry a per-site velocity (the key includes it)
                dvr = (if_["vel"] - jf["vel"]) * d
                vr = dvr[0] + dvr[1] + dvr[2]
                rho_bar = 0.5 * (if_["rho"] + jf["rho"])
                mu = p.h * vr / (r2 + 0.01 * h2)
                pi_av = torch.where((vr < 0) & (rho_bar > EPSILON),
                                    -alpha_visc * cs * mu
                                    / rho_bar.clamp(min=EPSILON), 0.0)
                out["av"] = (pi_av * gwp * jf["mult"]) * d
            if use_x:
                diff2 = h2 - r2
                wk = torch.where(diff2 > 0, diff2 * diff2 * diff2, 0.0)
                den = if_["rho"] + jf["rho"]
                xc = torch.where(den > EPSILON,
                                 2.0 * p.mass / den.clamp(min=EPSILON),
                                 0.0) * wk
                out["xv"] = xc * jf["vsum"]
                out["xm"] = xc * jf["mult"]
            return out

        names = {"pa": 1, "pb": 1, "vb": 1, "vc": 0}
        if use_a:
            names["av"] = 1
        if use_x:
            names.update(xv=1, xm=0)
        jfs, ifs, delta = _trimmed(i, j, jarrs, iarrs)
        acc = _window_scan(jfs, ifs, r, s, w, zbase,
                           delta if w > 1 else None, terms, names)
        return _untrim(acc, i.occ.shape[0])

    return run


def combine_forces(sums: dict, i: ISites, p: PhysParams, *,
                   xsph: float = 0.0, alpha_visc: float = 0.0):
    """Site-level force assembly (VelPos.compute:101-105 scaling), JAX
    :580-611. Returns per site (fstat f32[3,Ki,S], vcoef f32[Ki,S], xstat,
    xcoef): a particle's force is fstat − vᵢ·vcoef and its XSPH velocity
    correction xstat − vᵢ·xcoef."""
    h6, h9 = p.h ** 6, p.h ** 9
    cp = (45.0 / _PI) / h6
    c6 = (315.0 / (64.0 * _PI)) / h9
    rho = i.rho
    press = p.gas_constant * (rho - p.rest_density)
    i_ok = rho > EPSILON
    safe = torch.where(i_ok, rho, 1.0)
    sp = torch.where(i_ok, p.mass * p.mass / safe, 1.0)     # VelPos:101-103
    sv = torch.where(i_ok, p.viscosity * p.mass * p.mass / safe, 1.0)
    f = cp * (press * sums["pa"] + sums["pb"]) * sp + cp * sums["vb"] * sv
    if alpha_visc != 0.0:
        f = f + cp * p.mass * p.mass * sums["av"]   # no ρᵢ scale
    vcoef = cp * sums["vc"] * sv
    xstat = xcoef = None
    if xsph != 0.0:
        xstat = xsph * c6 * sums["xv"]
        xcoef = xsph * c6 * sums["xm"]
    return f, vcoef, xstat, xcoef


# ---------------------------------------------------------------------------
# per-particle entry points
# ---------------------------------------------------------------------------


def _gather_site(i: ISites, arr: torch.Tensor,
                 fill: float = 0.0) -> torch.Tensor:
    """Per-site [..., Ki, S] → per-particle [..., N]; particles with no
    evaluation site (certified) read ``fill``."""
    ki, s = i.occ.shape
    idx = i.slot_of.clamp(0, ki * s - 1).long()
    flat = arr.reshape(arr.shape[:-2] + (ki * s,))
    return torch.where(i.slot_of < ki * s, flat[..., idx], fill)


def _escalated(i: ISites, j: JSites, p: PhysParams, runs):
    """Radius 1 normally; radius 2-3 while spawn δ ≠ 0 (presets can spawn
    past the unit cube before the first clamp; δ up to 2 cells observed,
    beyond that the i-build certificate fires). JAX :627-633 with the
    branch chosen on the host."""
    return runs[min(max(int(i.dmax), 0), len(runs) - 1)](i, j, p)


def _forces_of(i: ISites, sums: dict, vel: torch.Tensor, p: PhysParams,
               xsph: float, alpha_visc: float):
    """(f [N, 3], XSPH dv [N, 3] or None) of a force pass's sums."""
    fstat, vcoef, xstat, xcoef = combine_forces(sums, i, p, xsph=xsph,
                                                alpha_visc=alpha_visc)
    f = _gather_site(i, fstat).T - vel * _gather_site(i, vcoef)[:, None]
    dv = None
    if xsph != 0.0:
        dv = _gather_site(i, xstat).T - vel * _gather_site(i, xcoef)[:, None]
    return f, dv


def density_sites(pos: torch.Tensor, stale_cid: torch.Tensor,
                  in_cap: torch.Tensor, p: PhysParams, r: int, ki: int,
                  kj: int, z_bands: int = 1):
    """Frame-start density per particle (Density.compute:32-60).

    Returns (rho f32[N], cert i32[]). The i-grid is built from the positions
    the bucket was built from (SphFluidSimulation.cs:98-100), so it is both
    fresh- and stale-centred. ``z_bands > 1`` runs the same pass over
    sequential z-band-local grids (:func:`bands_for`), bit-identical."""
    if z_bands > 1:
        return _banded_pass(pos, None, None, stale_cid, in_cap, p, r, ki,
                            kj, z_bands, density=True)
    s = r * r * r
    j = build_j_sites(stale_cid, in_cap, pos, None, None, r, kj, p)
    i = build_i_sites(pos, None, None, r, ki)
    rho_site = _escalated(i, j, p, [make_density_pass(r, s, w)
                                    for w in (1, 2, 3)])
    return _gather_site(i, rho_site, 0.0), i.cert + j.cert


def fluid_forces_sites(pos: torch.Tensor, vel: torch.Tensor,
                       rho: torch.Tensor, stale_cid: torch.Tensor,
                       in_cap: torch.Tensor, p: PhysParams, r: int, ki: int,
                       kj: int, *, xsph: float = 0.0,
                       alpha_visc: float = 0.0, z_bands: int = 1):
    """Pressure + viscosity (+ extensions) per particle for one substep.

    ``pos``/``vel`` are fresh, ``rho``/``stale_cid``/``in_cap`` frame-stale:
    the reference's candidate semantics (VelPos.compute:57-58, 77-94).
    Returns (f_fluid f32[N,3], xsph_dv f32[N,3] | None, cert i32[])."""
    if z_bands > 1:
        return _banded_pass(pos, vel, rho, stale_cid, in_cap, p, r, ki,
                            kj, z_bands, density=False, xsph=xsph,
                            alpha_visc=alpha_visc)
    s = r * r * r
    use_x, use_a = xsph != 0.0, alpha_visc != 0.0
    j = build_j_sites(stale_cid, in_cap, pos, vel, rho, r, kj, p,
                      xsph=use_x, avisc=use_a)
    i = build_i_sites(pos, vel if use_a else None, rho, r, ki, avisc=use_a)
    sums = _escalated(i, j, p, [make_force_pass(r, s, w, xsph=xsph,
                                                alpha_visc=alpha_visc)
                                for w in (1, 2, 3)])
    f, dv = _forces_of(i, sums, vel, p, xsph, alpha_visc)
    return f, dv, i.cert + j.cert


# ---------------------------------------------------------------------------
# z-banded grids (flagship-scale variant)
# ---------------------------------------------------------------------------

# Largest band-local grid (cells) the auto rule allows (JAX :702-706)
SITE_BAND_AUTO_CELLS = 1 << 17
_BAND_HALO = 3  # planes; covers the widest spawn-escalation window (w=3)


def auto_bands(r: int) -> int:
    """Smallest band count whose band-local grid fits the auto budget
    (1 == use the plain full-grid pass)."""
    if r * r * r <= SITE_BAND_AUTO_CELLS:
        return 1
    for nb in range(2, r + 1):
        zspan = -(-r // nb)
        if (zspan + 2 * _BAND_HALO) * r * r <= SITE_BAND_AUTO_CELLS:
            return nb
    return r


def one_piece_bytes(r: int, n: int, ki: int, kj: int) -> int:
    """A bound on the memory of one one-piece pass, the largest (a force
    pass with both extensions): 4 bytes for each j-slot and cell of the
    j-grids' 17 fields and their padded copies (34), and for each i-slot
    and cell of the i-grids' 10 fields and the 17 sums (27); 64 block
    temporaries of ``_BLOCK_ELEMS`` floats; 128 bytes a particle for the
    site builds' sorts."""
    return 4 * r**3 * (34 * kj + 27 * ki) + 256 * _BLOCK_ELEMS + 128 * n


def bands_for(r: int, n: int, ki: int, kj: int,
              device: torch.device) -> int:
    """The band count of ``site_bands = 0``: on a CUDA card the one-piece
    pass whenever :func:`one_piece_bytes` fits in half its free memory;
    else (the CPU, whose memory the tests share, or a full card) JAX's
    rule, :func:`auto_bands`, from the TPU's budget. Either count gives
    the same bits."""
    if (device.type == "cuda" and one_piece_bytes(r, n, ki, kj)
            <= torch.cuda.mem_get_info(device)[0] // 2):
        return 1
    return auto_bands(r)


def _banded_pass(pos, vel, rho, stale_cid, in_cap, p: PhysParams, r: int,
                 ki: int, kj: int, nb: int, *, density: bool,
                 xsph: float = 0.0, alpha_visc: float = 0.0):
    """One density or force pass as ``nb`` sequential z-band-local grids
    (JAX :722-805).

    Band b owns fresh planes [b·zspan, (b+1)·zspan); its grid spans those
    plus ``_BAND_HALO`` planes each side, so every offset of the escalated
    pass (|oz| ≤ 3) reads real candidates. A voxel's site ranks depend only
    on its own rows, so each band's grid holds the full grid's sites for its
    planes, and each i-site folds the identical candidates in the identical
    order: bit-identical to the one-piece pass. Certificates count each
    voxel's drops in its interior owner band only."""
    n = pos.shape[0]
    zspan = -(-r // nb)
    s_loc = (zspan + 2 * _BAND_HALO) * r * r
    s_glob = r * r * r
    use_x, use_a = xsph != 0.0, alpha_visc != 0.0
    fz = sph_math.cell_index(pos[:, 2], r).clamp(0, r - 1)
    in_rng = (stale_cid >= 0) & (stale_cid < s_glob)
    sz = torch.where(in_rng, torch.div(stale_cid, r * r,
                                       rounding_mode="floor"),
                     -_BAND_HALO - 1)
    zero = torch.zeros(n, dtype=torch.float32, device=pos.device)
    cert = torch.zeros((), dtype=torch.int32, device=pos.device)
    rho_out = zero
    f_out = torch.zeros_like(pos)
    vc = zero
    xs = torch.zeros_like(pos) if use_x else None
    xc = zero if use_x else None
    for zb0 in range(0, nb * zspan, zspan):
        lo = zb0 - _BAND_HALO
        j_mem = (in_cap & in_rng & (sz >= lo)
                 & (sz < zb0 + zspan + _BAND_HALO))
        j_int = (sz >= zb0) & (sz < zb0 + zspan)
        i_mem = (fz >= zb0) & (fz < zb0 + zspan)
        cid_loc = stale_cid - lo * (r * r)
        if density:
            j = build_j_sites(cid_loc, in_cap, pos, None, None, r, kj, p,
                              grid_s=s_loc, member=j_mem,
                              cert_member=j_int)
            i = build_i_sites(pos, None, None, r, ki, grid_s=s_loc,
                              zbase=lo, member=i_mem)
            rho_site = _escalated(i, j, p, [
                make_density_pass(r, s_loc, w, zbase=lo) for w in (1, 2, 3)])
            rho_out = torch.where(i_mem, _gather_site(i, rho_site, 0.0),
                                  rho_out)
            cert = cert + i.cert + j.cert
            continue
        j = build_j_sites(cid_loc, in_cap, pos, vel, rho, r, kj, p,
                          xsph=use_x, avisc=use_a, grid_s=s_loc,
                          member=j_mem, cert_member=j_int)
        i = build_i_sites(pos, vel if use_a else None, rho, r, ki,
                          avisc=use_a, grid_s=s_loc, zbase=lo, member=i_mem)
        sums = _escalated(i, j, p, [
            make_force_pass(r, s_loc, w, xsph=xsph, alpha_visc=alpha_visc,
                            zbase=lo) for w in (1, 2, 3)])
        fstat, vcoef, xstat, xcoef = combine_forces(
            sums, i, p, xsph=xsph, alpha_visc=alpha_visc)
        f_out = torch.where(i_mem[:, None], _gather_site(i, fstat).T, f_out)
        vc = torch.where(i_mem, _gather_site(i, vcoef), vc)
        if use_x:
            xs = torch.where(i_mem[:, None], _gather_site(i, xstat).T, xs)
            xc = torch.where(i_mem, _gather_site(i, xcoef), xc)
        cert = cert + i.cert + j.cert
    if density:
        return rho_out, cert
    f = f_out - vel * vc[:, None]
    dv = (xs - vel * xc[:, None]) if use_x else None
    return f, dv, cert
