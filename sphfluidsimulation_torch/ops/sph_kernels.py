"""Density, force and fused-substep passes over the sorted frame: CUDA
kernels and their plain PyTorch versions.

Counterpart of ``sphfluidsimulation_tpu/ops/pallas_sph.py``: ``density_pass``
(:1682, Pallas kernel ``_sph_kernel`` with ``force=False``; K1),
``forces_pallas`` (:1702, ``force=True, fused=False``, with the host-side
scaling and constant fold of :1737-1770; K3, here ``forces_pass``),
``fused_substep`` (:1835, ``_sph_kernel`` with the fused integrate tail
:1404-1489; K2), ``pack_rows`` and ``unpack_rows``. The XSPH and artificial
viscosity coefficients (``xsph``, ``alpha_visc``) turn on the extension sums
inside K2 and K3 (pallas_sph.py:1255-1283).

Every pass evaluates, for each sorted particle i, the pairs (i, j) of the
reference's 27-cell walk (Density.compute:42-54, VelPos.compute:67-82): j is
in the bucket (``frame.occ``) and j's RAW frame-start cell, decoded, lies
within Chebyshev distance 1 of i's fresh cell ``trunc(pos_i·(R−1))``. The
density includes the self pair; the force passes skip j == i
(VelPos.compute:82), extension sums included, as the JAX kernel does. The
ρⱼ > ε guard (VelPos.compute:91) drops j from the pressure and viscosity
sums only; the extension sums keep it, each guarding its own denominator.
Every gate is a select, so ±inf/NaN values of non-candidates never leak in.

Routing: a CPU tensor goes to the plain version; a CUDA tensor launches the
hand-written kernel (``csrc/density.cu``, ``csrc/forces.cu``,
``csrc/fused_substep.cu``) or raises. The kernels walk ``start[]`` cell by
cell, each cell clamped to its first ``capacity`` slots (only those can be
``occ``), so their candidate set is exact: the sorted tier has no truncation
certificate. K2 and K3 (``csrc/window_walk.cuh``) read the j-side
pressure and guarded 1/ρ from :func:`pj_cols`.

Tuning variants (``SortedTuning``, the semantic knobs of the JAX
``PallasTuning``): ``fuse_acc`` (the default; pressure and viscosity in one
accumulator, K2 and K3), ``kahan`` (compensated sums, K1-K3) and ``bf16``
(candidate values rounded to bfloat16, K2 and K3). Every wrapper and plain
version takes ``tune``; each variant's instance is the same source compiled
with its switches (``cuda_build.function``), and its plain version computes
the same variant.

Banded instances (``band=(zbase, z_span)``, the slab step's frame,
``ops/frame.py``): the window's z range is clipped to the band's planes and
``start`` is indexed by local plane; the gate reads global raw ids and does
not change. Every pass treats the rows past ``start[-1]`` (the dead rows of
a slab row buffer, which sort last) as absent: density 0, force sums 0, the
substep copies them through. Without a band there are none. K1 and K2 run
banded; K3 takes the band from the shared walk but the slab step does not
launch it.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Callable, NamedTuple

import torch

from ..config import EPSILON
from ..params import PhysParams
from . import cuda_build, sph_math
from .frame import SortedFrame

N_FIELDS = 8             # rows lanes: x, y, z, vx, vy, vz, rho, nan_count
N_SUMS = 12              # K3 lanes: press 3, visc 3, xsph 3, avisc 3
N_SCAL = 15              # scal_block lanes (sph_common.cuh::Scalars)
_C_POLY6 = 315.0 / (64.0 * math.pi)
_C_GRAD = 45.0 / math.pi
# candidate entries per chunk of the plain versions' dense gather; the
# compensated sums, which walk it column by column, take larger chunks
_CHUNK_PAIRS = 1 << 21
_KAHAN_CHUNK_PAIRS = 1 << 24

# Kernel launches per wrapper; a run resets them and reads them back to show
# which kernels its main path went through.
# "fused_substep" counts K2 without extensions, "fused_substep_ext" with; the
# "*_band" entries count the banded instances of K1, K2 and K5 (the slab
# step, parallel/slab_pallas.py); the "compact_*" entries count the K5
# instances (ops/compact.py). A tuning variant's instance counts under its
# instance's name with the variant's tag (:func:`variant_tag`), e.g.
# "fused_substep_ext+bf16" or "density+kahan"; those keys appear at their
# first launch.
_COUNTERS = ("density", "fused_substep", "fused_substep_ext", "forces",
             "compact_density", "compact_substep", "compact_substep_ext",
             "compact_forces", "density_band", "fused_substep_band",
             "fused_substep_ext_band", "compact_density_band",
             "compact_substep_band", "compact_substep_ext_band")
launch_counts = dict.fromkeys(_COUNTERS, 0)


def reset_launch_counts() -> None:
    """Every count to 0, and the variants' keys dropped."""
    launch_counts.clear()
    launch_counts.update(dict.fromkeys(_COUNTERS, 0))


def _count(name: str) -> None:
    launch_counts[name] = launch_counts.get(name, 0) + 1


class SortedTuning(NamedTuple):
    """Route and variant of the sorted tier; the counterpart of the JAX
    ``PallasTuning`` (pallas_sph.py:73-204), with its field names and
    defaults for the semantic knobs.

    compact:  the compact-lane route, K5 (``ops/compact.py``), for density,
              the fused substep and the forces without extensions; False
              is the per-particle window walk of K1, K2 and K3.
    fused:    one kernel a substep (K2, or K5's fused mode); False runs the
              unfused route, the forces kernel (K3, or K5's forces mode
              without extensions) and ``integrate_substep`` a substep
              (JAX stepper.py:361-376). The slab step always fuses.
    kahan:    compensated pair sums in K1, K2 and K3 (K5 has none, as in
              JAX): the same candidates and pair terms, and each running
              sum carries its compensation, folded in before the result.
    bf16:     candidates' values rounded to bfloat16 where JAX rounds them
              (:func:`bf16_round`): vx and vy on the window route without
              extensions, vx, vy, vz and ρⱼ (and what is computed from ρⱼ)
              with extensions and in K5's force modes. Density does not
              read them.
    fuse_acc: pressure and viscosity share one accumulator triple in K2
              and K3, the viscosity folded in per row (μ where ρᵢ > ε,
              else 1); K3's sums are then (combined 3, xsph 3, avisc 3).
              K5 keeps two accumulators under either value, as in JAX.

    The Mosaic layout variables have no counterpart and are ignored:
    ``SPH_PALLAS_ROWS``, ``_TPG``, ``_UNROLL``, ``_FLAT``, ``_INTCELL``,
    ``_SS``, ``_CROWS``, ``_CK``, ``_W_FUDGE``, ``_LINE_FUDGE``, ``_IKI``
    and ``_PJ`` (the kernels walk ``start[]`` exactly and always read
    precomputed j-side columns; ROADMAP.md queue B, "Not ported, by
    design")."""

    compact: bool = False
    fused: bool = True
    kahan: bool = False
    bf16: bool = False
    fuse_acc: bool = True

    @classmethod
    def from_env(cls) -> "SortedTuning":
        """The semantic ``SPH_PALLAS_*`` variables, read as
        ``PallasTuning.from_env`` reads them (pallas_sph.py:207-241): a
        switch is on when its variable is "1", and an unset variable takes
        the default."""
        d = cls()

        def on(var: str, default: bool) -> bool:
            return os.environ.get(var, "1" if default else "0") == "1"

        return cls(compact=on("SPH_PALLAS_COMPACT", d.compact),
                   fused=on("SPH_PALLAS_FUSED", d.fused),
                   kahan=on("SPH_PALLAS_KAHAN", d.kahan),
                   bf16=on("SPH_PALLAS_BF16", d.bf16),
                   fuse_acc=on("SPH_PALLAS_FACC", d.fuse_acc))

    def k5(self) -> "SortedTuning":
        """The variant K5 computes under this tuning: bf16 only (JAX's
        compact kernel reads neither ``kahan`` nor ``fuse_acc``)."""
        return SortedTuning(compact=True, fused=self.fused, bf16=self.bf16,
                            fuse_acc=False)


def default_tuning() -> SortedTuning:
    """Call-time default: the environment is read when used, not at import."""
    return SortedTuning.from_env()


_DEFAULT = SortedTuning()


def _tuned(tune: SortedTuning | None) -> SortedTuning:
    return _DEFAULT if tune is None else tune


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and back, as JAX's ``astype(bfloat16)``
    does it (``pallas_sph._pack_pair_bf16`` / ``unpack_pair_bf16``): round
    to nearest, ties to even, subnormals kept, ±inf kept, and a NaN becomes
    the quiet NaN of its sign (0x7FC0 or 0xFFC0). Integer arithmetic on the
    float32 bits, as the kernels do it (``sph_common.cuh::bf16_round``);
    a float64 ``x`` must hold float32 values, as the rows of a float64
    evaluation do."""
    u = x.to(torch.float32).view(torch.int32)
    r = (u + 0x7FFF + ((u >> 16) & 1)) & -0x10000
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    r = torch.where(nan, (u & -0x80000000) | 0x7FC00000, r)
    return r.view(torch.float32).to(x.dtype)


# ---------------------------------------------------------------- layout --

def pack_rows(pos_s: torch.Tensor, vel_s: torch.Tensor, rho_s: torch.Tensor,
              aux: torch.Tensor | None = None) -> torch.Tensor:
    """Sorted state → rows f32[N, 8] (x, y, z, vx, vy, vz, rho, aux).

    ``aux`` is the per-particle NaN-trap count the substep accumulates
    (VelPos.compute:143-147); None packs zeros.
    """
    if aux is None:
        aux = torch.zeros_like(rho_s)
    return torch.cat([pos_s, vel_s, rho_s[:, None],
                      aux.to(rho_s.dtype)[:, None]], 1)


def unpack_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    """rows → (pos_s f32[N,3], vel_s f32[N,3], rho_s f32[N], nan i32[N])."""
    return rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 7].to(torch.int32)


def uses_extensions(xsph: float, alpha_visc: float) -> bool:
    """Whether the force passes sum the XSPH / artificial-viscosity terms."""
    return xsph != 0.0 or alpha_visc != 0.0


def scal_block(phys: PhysParams, xsph: float = 0.0,
               alpha_visc: float = 0.0) -> torch.Tensor:
    """The kernels' scalar block f32[N_SCAL] on the parameters' device:
    h, h², c₆ = 315/(64π)/h⁹, c_g = 45/π/h⁶, mass, k, ρ₀, μ, stiffness,
    damping, gravity_y, dt, xsph, alpha_visc, c_s = √k. The plain versions
    use the same constants (in the parameters' dtype, so a float64
    evaluation is a reference). Built without a host-to-device copy, so the
    frame loop never waits for the card."""
    h = phys.h
    h2 = h * h
    h6 = h2 * h2 * h2
    h9 = h6 * h2 * h
    return torch.stack([h, h2, _C_POLY6 / h9, _C_GRAD / h6, phys.mass,
                        phys.gas_constant, phys.rest_density, phys.viscosity,
                        phys.stiffness, phys.damping, phys.gravity_y,
                        phys.dt, torch.full_like(h, xsph),
                        torch.full_like(h, alpha_visc),
                        torch.sqrt(phys.gas_constant)])


def pj_cols(rho: torch.Tensor, phys: PhysParams) -> torch.Tensor:
    """K2's and K3's j-side columns f32[N, 2]: press_j = k·(ρ − ρ₀) and the
    guarded reciprocal [ρ > ε]/ρ, the formulas of ``pallas_sph._pj_cols``
    (:813-821). The stepper computes them beside ``pack_rows``: once a frame
    in faithful mode, where ρ is the frame-start density of all five
    substeps, and once a substep in corrected mode."""
    press = phys.gas_constant * (rho - phys.rest_density)
    ok = rho > EPSILON
    inv = torch.where(ok, 1.0, 0.0) / torch.where(ok, rho, 1.0)
    return torch.stack([press, inv], 1)


# --------------------------------------------------------- plain versions --

# the 27 window offsets (dx, dy, dz) in the kernels' walk order: z outer,
# y middle, x inner
_OFFSETS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]


def fresh_cell(pos: torch.Tensor, r: int) -> torch.Tensor:
    """i's fresh cell trunc(pos·(R−1)), clamped to [−2, R+1]: the clamp moves
    only cells whose whole 27-window lies outside the grid."""
    return sph_math.cell_index(pos, r).clamp(-2, r + 1)


def _window_width(frame: SortedFrame, capacity: int | None) -> int:
    """Candidate slots per cell for the dense gather: the longest anchor
    run, capped at the capacity (slots past it are never occupied)."""
    longest = int((frame.start[1:] - frame.start[:-1]).max())
    width = longest if capacity is None else min(longest, capacity)
    return max(width, 1)


def _n_live(frame: SortedFrame) -> int:
    """The rows before the dead ones: ``start[-1]`` (waits for the card)."""
    return int(frame.start[-1])


def _candidates(frame: SortedFrame, c: torch.Tensor, r: int, width: int,
                band: tuple[int, int] | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense candidate gather for the fresh cells ``c`` i32[m, 3]: sorted
    indices i64[m, 27·width] and the membership mask bool[m, 27·width].
    With ``band`` the window keeps the band's z-planes and reads ``start``
    by local plane."""
    offs = torch.tensor(_OFFSETS, dtype=torch.int32, device=c.device)
    nc = c[:, None, :] + offs[None]                          # [m, 27, 3]
    inb = ((nc >= 0) & (nc < r)).all(-1)
    z = nc[..., 2]
    if band is not None:
        zbase, z_span = band
        inb = inb & (z >= zbase) & (z < zbase + z_span)
        z = z - zbase
    cell = nc[..., 0] + nc[..., 1] * r + z * (r * r)
    cell = torch.where(inb, cell, 0).long()
    s = frame.start[cell].long()
    cnt = torch.where(inb, frame.start[cell + 1].long() - s, 0)
    k = torch.arange(width, device=c.device)
    j = s[..., None] + k                                     # [m, 27, W]
    valid = k < cnt[..., None].clamp(max=width)
    j = torch.where(valid, j, 0).reshape(c.shape[0], -1)
    valid = valid.reshape(c.shape[0], -1)

    return j, member_gate(frame, j, valid, c, r)


def member_gate(frame: SortedFrame, j: torch.Tensor, valid: torch.Tensor,
                c: torch.Tensor, r: int) -> torch.Tensor:
    """The membership gate of candidates ``j`` i64[m, K] (``valid`` marks
    the real slots) for rows whose fresh cells are ``c`` i32[m, 3]: j in the
    bucket and its raw cell within 1 of the row's cell on each axis."""
    raw = frame.raw[j]
    rr = r * r
    cz = torch.div(raw, rr, rounding_mode="floor")
    rem = raw - cz * rr
    cy = torch.div(rem, r, rounding_mode="floor")
    cx = rem - cy * r
    return (valid & frame.occ[j]
            & ((cx - c[:, None, 0]).abs() <= 1)
            & ((cy - c[:, None, 1]).abs() <= 1)
            & ((cz - c[:, None, 2]).abs() <= 1))


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 in a fixed pairwise order.

    Elementwise adds only: the result does not depend on the thread count or
    on memory alignment, as torch's reductions can, so the plain versions
    are bit-reproducible (the sorted rollout must equal per-frame stepping
    bit for bit)."""
    k = x.shape[1]
    width = 1 << max(k - 1, 0).bit_length()
    if width != k:
        pad = x.new_zeros((x.shape[0], width - k) + tuple(x.shape[2:]))
        x = torch.cat([x, pad], 1)
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] + x[:, half:]
    return x[:, 0]


def _kahan_sum(terms: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Compensated (Kahan) sum over dim 1, sequential in column order, of
    ``terms`` f[m, K, L] where ``gate`` bool[m, K, L] holds (a column whose
    gate fails leaves the sum and its compensation as they were), the
    recurrence of the JAX kernel's ``accum`` (pallas_sph.py:1118-1130):

        y = term − c;  t = s + y;  c = (t − s) − y;  s = t.

    The result is s + c, as the JAX kernel folds it (:1392-1394). With
    c = (t − s) − y the textbook correction would be s − c; the port
    computes what JAX computes (tests/test_torch_variants.py pins the
    sign)."""
    s = terms.new_zeros((terms.shape[0],) + tuple(terms.shape[2:]))
    c = torch.zeros_like(s)
    # a column no row keeps changes nothing: only the others are walked
    active = gate.reshape(gate.shape[0], gate.shape[1], -1).any(2).any(0)
    for k in active.nonzero()[:, 0].tolist():
        g = gate[:, k]
        y = terms[:, k] - c
        t = s + y
        c = torch.where(g, (t - s) - y, c)
        s = torch.where(g, t, s)
    return s + c


def _chunk_rows(width: int, kahan: bool) -> int:
    """Rows a chunk of the plain versions' dense gather: the compensated
    sums run column by column, so they take larger chunks."""
    pairs = _KAHAN_CHUNK_PAIRS if kahan else _CHUNK_PAIRS
    return max(1, pairs // (27 * width))


def density_plain(frame: SortedFrame, pos_s: torch.Tensor,
                  phys: PhysParams, r: int, capacity: int | None,
                  band: tuple[int, int] | None = None,
                  tune: SortedTuning | None = None) -> torch.Tensor:
    """ρᵢ = m·Σⱼ W_poly6(|xᵢ−xⱼ|²) over the window pairs, self included
    (Density.compute:32-60); 0 for dead rows. ``tune.kahan`` sums in walk
    order with compensation (K1's kahan instance)."""
    kahan = _tuned(tune).kahan
    n = _n_live(frame)
    width = _window_width(frame, capacity)
    rows = _chunk_rows(width, kahan)
    w_sum = pos_s.new_zeros(pos_s.shape[0])
    for i0 in range(0, n, rows):
        ids = torch.arange(i0, min(i0 + rows, n), device=pos_s.device)
        j, member = _candidates(frame, fresh_cell(pos_s[ids], r), r, width,
                                band)
        w_sum[ids] = density_sums_plain(pos_s, phys, ids, j, member, kahan)
    return phys.mass * w_sum


def member_pairs(frame: SortedFrame, pos_s: torch.Tensor, r: int,
                 capacity: int | None,
                 band: tuple[int, int] | None = None) -> tuple[int, int]:
    """(member pairs, self pairs) of the window route at these positions:
    the pairs (i, j) that the plain versions' gate keeps, the self pair
    included, and how many of them are j == i. The density sums all of
    them, the force passes all but the self pairs. Waits for the card."""
    n = _n_live(frame)
    width = _window_width(frame, capacity)
    rows = max(1, _CHUNK_PAIRS // (27 * width))
    total = own = 0
    for i0 in range(0, n, rows):
        ids = torch.arange(i0, min(i0 + rows, n), device=pos_s.device)
        j, member = _candidates(frame, fresh_cell(pos_s[ids], r), r, width,
                                band)
        total += int(member.sum())
        own += int((member & (j == ids[:, None])).sum())
    return total, own


def density_sums_plain(pos_s: torch.Tensor, phys: PhysParams,
                       ids: torch.Tensor, j: torch.Tensor,
                       member: torch.Tensor,
                       kahan: bool = False) -> torch.Tensor:
    """Σⱼ W_poly6(|xᵢ−xⱼ|²) of rows ``ids`` i64[m] over the candidates ``j``
    i64[m, K] that ``member`` keeps, summed in the fixed tree order, or
    with ``kahan`` in column (walk) order with compensation, each member
    inside the support a step, as K1's kahan instance sums."""
    sc = scal_block(phys)
    h2, c9 = sc[1], sc[2]
    d = pos_s[ids][:, None, :] - pos_s[j]
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    diff = h2 - r2
    use = member & (diff > 0)
    w = torch.where(use, c9 * diff * diff * diff, 0.0)
    return _kahan_sum(w, use) if kahan else _tree_sum(w)


def forces_plain(frame: SortedFrame, rows: torch.Tensor, phys: PhysParams,
                 r: int, capacity: int | None, ext: bool = False,
                 magnitude: bool = False,
                 band: tuple[int, int] | None = None,
                 tune: SortedTuning | None = None) -> torch.Tensor:
    """K3's plain version: the raw force-side pair sums per sorted particle,
    f[N, 12], from the rows state (``rho`` the frame-start density,
    positions and velocities fresh), in the layout of ``tune``'s instance
    (:func:`force_sums_plain`).

    press = Σ (pᵢ + pⱼ)/(2ρⱼ) ∇W rᵢⱼ and visc = Σ ∇²W (vⱼ − vᵢ)/ρⱼ over
    candidates with ρⱼ > ε (VelPos.compute:64-99; the formulas of
    ``ops/brute.py::fluid_forces_bruteforce``). With ``ext``, xsph = Σ
    2/(ρᵢ + ρⱼ) W (vⱼ − vᵢ) and avisc = Σ Π ∇W rᵢⱼ over all candidates
    (pallas_sph.py:1255-1283, ``ops/extensions.py``); without, those lanes
    are 0. :func:`fold_forces` applies the scaling.

    With ``magnitude`` each pair term is replaced by the scale its float32
    rounding works at, and the sums add those: a difference that may cancel
    (pᵢ + pⱼ, h − |r|, h² − |r|², vⱼ − vᵢ, the Π numerator v·r) enters by
    the sizes of its operands. The result bounds the rounding of a float32
    evaluation, up to a count of roundings (``substep_accuracy``). Dead
    rows' sums are 0."""
    tune = _tuned(tune)
    n = _n_live(frame)
    width = _window_width(frame, capacity)
    chunk = _chunk_rows(width, tune.kahan)
    out = rows.new_zeros((rows.shape[0], N_SUMS))
    for i0 in range(0, n, chunk):
        ids = torch.arange(i0, min(i0 + chunk, n), device=rows.device)
        j, member = _candidates(frame, fresh_cell(rows[ids, 0:3], r), r,
                                width, band)
        sums = force_sums_plain(rows, phys, ids, j, member, ext, magnitude,
                                tune)
        out[ids, :sums.shape[1]] = sums
    return out


def candidate_values(rows: torch.Tensor, j: torch.Tensor, ext: bool,
                     tune: SortedTuning
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(vⱼ f[m, K, 3], ρⱼ f[m, K]) as ``tune``'s instance reads them: with
    ``tune.bf16`` vx and vy rounded (:func:`bf16_round`), and also vz and
    ρⱼ where the JAX kernel reads ρⱼ from the candidate and not from
    precomputed j-side columns, that is with extensions or on the compact
    route (pallas_sph.py:855-861, :1191-1203; pallas_compact.py:416-418).
    The pressure, 1/ρⱼ and what the extensions compute from ρⱼ follow
    from the value returned."""
    v_j, rho_j = rows[j, 3:6], rows[j, 6]
    if tune.bf16:
        if ext or tune.compact:
            return bf16_round(v_j), bf16_round(rho_j)
        v_j = torch.cat([bf16_round(v_j[..., 0:2]), v_j[..., 2:3]], -1)
    return v_j, rho_j


def force_sums_plain(rows: torch.Tensor, phys: PhysParams, ids: torch.Tensor,
                     j: torch.Tensor, member: torch.Tensor, ext: bool,
                     magnitude: bool,
                     tune: SortedTuning | None = None) -> torch.Tensor:
    """The force-side pair sums of :func:`forces_plain` for rows ``ids``
    i64[m] over the candidates ``j`` i64[m, K] that ``member`` keeps, j == i
    skipped, in ``tune``'s variant:

    - the candidates' values of :func:`candidate_values` (``bf16``);
    - ``fuse_acc``: pressure and viscosity in one triple, each pair adding
      pc·∇W·r + ∇²W/ρⱼ·μᵢ·(vⱼ − vᵢ) with μᵢ = μ where ρᵢ > ε and 1
      elsewhere (pallas_sph.py:1106-1115, :1234-1245): f[m, 3], or f[m, 9]
      with ``ext`` (combined 3, xsph 3, avisc 3); else f[m, 6] or f[m, 12]
      (press 3, visc 3, xsph 3, avisc 3);
    - summed in the fixed tree order, or with ``kahan`` in column (walk)
      order with compensation (:func:`_kahan_sum`)."""
    tune = _tuned(tune)
    pos_s, vel_s, rho_s = rows[:, 0:3], rows[:, 3:6], rows[:, 6]
    h = phys.h
    h2 = h * h
    h6 = h2 * h2 * h2                              # as in scal_block
    c9 = _C_POLY6 / (h6 * h2 * h)
    cs = torch.sqrt(phys.gas_constant)
    v_j, rho_j = candidate_values(rows, j, ext, tune)
    rho_i = rho_s[ids, None]
    rho_ok = rho_j > EPSILON                       # per-j guard (:91)
    safe_j = torch.where(rho_ok, rho_j, 1.0)
    cand = member & (j != ids[:, None])                       # skip j == i
    m = cand & rho_ok
    d = pos_s[ids, None, :] - pos_s[j]                        # pos_i − pos_j
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    abs_r = torch.sqrt(r2)
    g = sph_math.grad_w_press_over_r(abs_r, h, h6)
    gwv = sph_math.grad_w_vis_r(abs_r, h, h6)
    p_i = sph_math.eos_pressure(rho_i, phys.gas_constant, phys.rest_density)
    p_j = sph_math.eos_pressure(rho_j, phys.gas_constant, phys.rest_density)
    v_i = vel_s[ids, None, :]
    if magnitude:
        hr = h - abs_r
        g = torch.where(g != 0, g + 3 * _C_GRAD / h6 * h * hr * hr / abs_r,
                        0.0)
        gwv = torch.where(abs_r < h, gwv + _C_GRAD / h6 * h, 0.0)
        p_i, p_j, d = p_i.abs(), p_j.abs(), d.abs()
        v_i, v_j = -v_i.abs(), v_j.abs()              # dv = |v_j| + |v_i|
    pc = (p_i + p_j) / (2.0 * safe_j)
    vc = gwv / safe_j
    dv = v_j - v_i                                            # v_j − v_i
    gates = [m[..., None].expand(d.shape)]
    if tune.fuse_acc:
        vmu = torch.where(rho_i > EPSILON, phys.viscosity, 1.0)
        terms = [torch.where(m[..., None], pc[..., None] * (g[..., None] * d)
                             + (vc * vmu)[..., None] * dv, 0.0)]
    else:
        terms = [torch.where(m[..., None], pc[..., None] * (g[..., None] * d),
                             0.0),
                 torch.where(m[..., None], vc[..., None] * dv, 0.0)]
        gates.append(gates[0])
    if ext:
        d2 = h2 - r2
        w6 = torch.where(d2 > 0, c9 * d2 * d2 * d2, 0.0)
        if magnitude:
            w6 = torch.where(d2 > 0, w6 + 3 * c9 * d2 * d2 * (h2 + r2), 0.0)
        denom = rho_i + rho_j
        x_ok = denom > EPSILON
        xc = torch.where(x_ok, 2.0 / torch.where(x_ok, denom, 1.0) * w6, 0.0)
        # no gate on xc: 0·inf = NaN as in the JAX kernel
        terms.append(torch.where(cand[..., None], xc[..., None] * dv, 0.0))
        dvel = -dv                                            # v_i − v_j
        vr = (dvel[..., 0] * d[..., 0] + dvel[..., 1] * d[..., 1]) \
            + dvel[..., 2] * d[..., 2]
        rho_bar = 0.5 * (rho_i + rho_j)
        mu = h * vr / (r2 + 0.01 * h2)
        pi_ok = (vr < 0) & (rho_bar > EPSILON)
        pi = torch.where(pi_ok, -cs * mu / torch.where(pi_ok, rho_bar, 1.0),
                         0.0)
        terms.append(torch.where(cand[..., None], (pi * g)[..., None] * d,
                                 0.0))
        gates += [cand[..., None].expand(d.shape)] * 2
    terms = torch.cat(terms, -1)
    if tune.kahan:
        return _kahan_sum(terms, torch.cat(gates, -1))
    return _tree_sum(terms)


def fold_forces(sums: torch.Tensor, rho_s: torch.Tensor, phys: PhysParams,
                xsph: float = 0.0, alpha_visc: float = 0.0,
                fused_tail: bool = False, fuse_acc: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Raw sums f[N, 12] → (force f[N, 3], XSPH correction dv f[N, 3] or
    None): the m²/ρᵢ scaling guarded by ρᵢ > ε (when it fails the raw sums
    pass through, VelPos.compute:101-105) and the extension constants.
    ``fuse_acc`` says the sums' layout: (combined 3, xsph 3, avisc 3), the
    viscosity already folded in per row (``forces_pallas``,
    pallas_sph.py:1740-1748), or, when False, (press 3, visc 3, xsph 3,
    avisc 3), the layout of K3's ``facc0`` instance and of K5.

    Each extension term is folded only when its own coefficient is nonzero,
    as ``forces_pallas`` does (pallas_sph.py:1760-1768): dv is None for
    xsph = 0, and no artificial-viscosity force is added for alpha_visc = 0,
    so a non-finite sum of a term that is off never reaches the result.
    ``fused_tail`` folds both whenever either coefficient is nonzero, as
    the JAX fused tail does (:1440-1450); K2 and its plain version follow
    it."""
    i_ok = (rho_s > EPSILON)[:, None]
    s_i = torch.where(i_ok, rho_s[:, None], 1.0)
    m_ = phys.mass
    f = torch.where(i_ok, sums[:, 0:3] * (m_ * m_ / s_i), sums[:, 0:3])
    xb = 3
    if not fuse_acc:
        f = f + torch.where(
            i_ok, sums[:, 3:6] * (phys.viscosity * m_ * m_ / s_i),
            sums[:, 3:6])
        xb = 6
    if not uses_extensions(xsph, alpha_visc):
        return f, None
    dv = ((xsph * m_) * sums[:, xb:xb + 3] if fused_tail or xsph != 0.0
          else None)
    if fused_tail or alpha_visc != 0.0:
        f = f + (alpha_visc * m_ * m_) * sums[:, xb + 3:xb + 6]
    return f, dv


# a plain version of the raw pair sums, forces_plain's signature: (frame,
# rows, phys, r, capacity, ext, magnitude, band=, tune=) → f[N, 12]; one
# whose kernel reads only some of the variant switches names the variant it
# computes under a tuning as its attribute ``variant`` (K5's:
# SortedTuning.k5), which also says its sums' layout
SumsFn = Callable[..., torch.Tensor]


def _variant(sums_fn: SumsFn, tune: SortedTuning | None) -> SortedTuning:
    """The variant ``sums_fn`` computes under ``tune``."""
    tune = _tuned(tune)
    return getattr(sums_fn, "variant", lambda t: t)(tune)


def fused_substep_plain(frame: SortedFrame, rows: torch.Tensor,
                        phys: PhysParams, r: int, capacity: int | None,
                        xsph: float = 0.0, alpha_visc: float = 0.0,
                        sums_fn: SumsFn = forces_plain,
                        band: tuple[int, int] | None = None,
                        tune: SortedTuning | None = None) -> torch.Tensor:
    """One substep over the rows state: pair forces, then the integrate
    tail of ``sim.stepper.integrate_substep`` (VelPos.compute:49-157).
    ``sums_fn`` gives the pair sums: the window walk of K2, or the tile
    candidates of K5 (``compact.compact_sums_plain``, which computes
    ``tune.k5()``), each banded with ``band`` and in ``tune``'s variant.
    Dead rows are copied through."""
    from ..sim.stepper import integrate_substep

    tune = _variant(sums_fn, tune)
    sums = sums_fn(frame, rows, phys, r, capacity,
                   uses_extensions(xsph, alpha_visc), band=band, tune=tune)
    rho = rows[:, 6]
    f, dv = fold_forces(sums, rho, phys, xsph, alpha_visc, fused_tail=True,
                        fuse_acc=tune.fuse_acc)
    pos_n, vel_n, nan_mask = integrate_substep(rows[:, 0:3], rows[:, 3:6], f,
                                               phys, dv)
    out = pack_rows(pos_n, vel_n, rho, rows[:, 7] + nan_mask.to(rows.dtype))
    live = torch.arange(rows.shape[0], device=rows.device) < frame.start[-1]
    return torch.where(live[:, None], out, rows)


# ---------------------------------------------------------- accuracy rule --

_U32 = 2.0 ** -24        # unit roundoff of float32
# |k − p64| ≤ SUBSTEP_ERR_FACTOR·|p32 − p64| + SUBSTEP_ROUNDINGS·u·σ
SUBSTEP_ERR_FACTOR = 4.0
SUBSTEP_ROUNDINGS = 256.0


class Accuracy(NamedTuple):
    ok: bool              # every check below holds
    same_nan: bool        # NaN pattern equal to p32's
    same_aux: bool        # ρ and NaN-count lanes equal to p32's (substep)
    n_over: int           # checked lanes over their bound
    roundings: float      # max (|k − p64| − 4·|p32 − p64|) / (u·σ)
    err: float            # max |k − p64| over the checked lanes
    err_plain: float      # max |p32 − p64| over the checked lanes


def _hold(out: torch.Tensor, p32: torch.Tensor, p64: torch.Tensor,
          sigma: torch.Tensor, same_aux: bool = True) -> Accuracy:
    """|out − p64| ≤ 4·|p32 − p64| + 256·u·σ in every lane where p32 and p64
    are not NaN, and the NaN pattern of ``out`` equal to p32's."""
    def err(x: torch.Tensor) -> torch.Tensor:
        x = x.double()
        return torch.where(x == p64, 0.0, (x - p64).abs())   # inf == inf

    nan_p = torch.isnan(p32)
    same_nan = bool((torch.isnan(out) == nan_p).all())
    fin = ~(nan_p | torch.isnan(p64))
    e_k = torch.where(fin, err(out), 0.0)
    e_p = torch.where(fin, err(p32), 0.0)
    over = e_k > SUBSTEP_ERR_FACTOR * e_p + SUBSTEP_ROUNDINGS * _U32 * sigma
    need = (e_k - SUBSTEP_ERR_FACTOR * e_p) / (_U32 * sigma)
    need = torch.where(torch.isnan(need), 0.0, need)     # inf − inf, 0 / 0
    n_over = int(over.sum())
    return Accuracy(
        ok=same_nan and same_aux and n_over == 0, same_nan=same_nan,
        same_aux=same_aux, n_over=n_over, roundings=float(need.max()),
        err=float(e_k.max()), err_plain=float(e_p.max()))


def _reference(frame: SortedFrame, rows: torch.Tensor, phys: PhysParams,
               r: int, capacity: int | None, xsph: float, alpha_visc: float,
               sums_fn: SumsFn, band: tuple[int, int] | None,
               tune: SortedTuning):
    """(rows64, phys64, force scale F, dv scale DV or None): the float64
    inputs and the rounding scales of the folded force and XSPH outputs
    (the magnitudes summed in tree order: their order does not matter)."""
    rows64 = rows.double()
    ph = PhysParams(*(t.double() for t in phys))
    mag = sums_fn(frame, rows64, ph, r, capacity,
                  uses_extensions(xsph, alpha_visc), magnitude=True,
                  band=band, tune=tune._replace(kahan=False))
    f_mag, dv_mag = fold_forces(mag, rows64[:, 6], ph, abs(xsph),
                                abs(alpha_visc), fuse_acc=tune.fuse_acc)
    return rows64, ph, f_mag, dv_mag


class Reference(NamedTuple):
    """What :func:`hold` holds an output to: the plain version in float32
    (p32) and in float64 (p64), and each lane's rounding scale σ; ``aux``
    (the substep's ρ and NaN-count lanes of p32) must be matched exactly."""

    p32: torch.Tensor
    p64: torch.Tensor
    sigma: torch.Tensor
    aux: torch.Tensor | None = None


def substep_reference(frame: SortedFrame, rows: torch.Tensor,
                      phys: PhysParams, r: int, capacity: int | None,
                      xsph: float = 0.0, alpha_visc: float = 0.0,
                      sums_fn: SumsFn = forces_plain,
                      band: tuple[int, int] | None = None,
                      tune: SortedTuning | None = None) -> Reference:
    """The reference of :func:`substep_accuracy` for one substep of
    ``rows``, computed once for any number of outputs."""
    tune = _variant(sums_fn, tune)
    p32 = fused_substep_plain(frame, rows, phys, r, capacity, xsph,
                              alpha_visc, sums_fn, band, tune)
    rows64, ph, f_mag, dv_mag = _reference(frame, rows, phys, r, capacity,
                                           xsph, alpha_visc, sums_fn, band,
                                           tune)
    p64 = fused_substep_plain(frame, rows64, ph, r, capacity, xsph,
                              alpha_visc, sums_fn, band, tune)
    pos, vel = rows64[:, 0:3], rows64[:, 3:6]
    # the wall force's rounding scale: its depth h − x or 1 − x − h
    # cancels, and so may depth·stiffness − Σ damping·v
    near = ((pos < ph.h) | (pos > 1.0 - ph.h)).any(-1, keepdim=True)
    wall = torch.where(near, ph.mass * (
        ph.stiffness * (1.0 + ph.h + pos.abs())
        + ph.damping * vel.abs().sum(-1, keepdim=True)), 0.0)
    zero = torch.zeros_like(ph.gravity_y)
    g = torch.stack([zero, ph.gravity_y, zero]).abs()
    sig_v = vel.abs() + p64[:, 3:6].abs() \
        + ph.dt / ph.mass * (f_mag + wall) + ph.dt * g
    sig_x = pos.abs() + p64[:, 0:3].abs() + ph.dt * sig_v
    if dv_mag is not None:
        sig_x = sig_x + ph.dt * dv_mag
    return Reference(p32[:, :6], p64[:, :6], torch.cat([sig_x, sig_v], 1),
                     p32[:, 6:8])


def hold(out: torch.Tensor, ref: Reference) -> Accuracy:
    """Holds ``out`` (a substep's rows, or folded forces) to ``ref``."""
    if ref.aux is None:
        return _hold(out, ref.p32, ref.p64, ref.sigma)
    same_aux = bool((out[:, 6:8] == ref.aux).all())
    return _hold(out[:, :6], ref.p32, ref.p64, ref.sigma, same_aux)


def substep_accuracy(frame: SortedFrame, rows: torch.Tensor,
                     out: torch.Tensor, phys: PhysParams, r: int,
                     capacity: int | None, xsph: float = 0.0,
                     alpha_visc: float = 0.0,
                     sums_fn: SumsFn = forces_plain,
                     band: tuple[int, int] | None = None,
                     tune: SortedTuning | None = None) -> Accuracy:
    """Holds ``out``, one substep of ``rows`` computed elsewhere (the CUDA
    kernel), to the accuracy of the plain version in the same variant
    ``tune``, particle by particle. ``sums_fn`` names the plain version's
    pair sums (K2's by default, banded with ``band``; K5's is
    ``compact.compact_sums_plain``).

    The golden EOS explodes (FIDELITY.md Part D): force sums cancel terms
    many orders above their result, so no fixed tolerance against the
    float32 plain version p32 means anything. Against p64, the plain version
    evaluated in float64 on the same float32 inputs, each particle and each
    position or velocity lane must satisfy

        |out − p64| ≤ 4·|p32 − p64| + 256·u·σ,

    with u = 2⁻²⁴ and σ the scale that lane's float32 rounding works at:
    σ_v = |v| + |v'| + dt/m·(F + W) + dt·|g| for a velocity, with F the
    folded pair sums' rounding scale (``forces_plain(magnitude=True)``,
    extensions included) and W the wall force's; σ_x = |x| + |x'| +
    dt·(σ_v + D) for a position, with D the XSPH correction's scale (primes:
    p64's result). 256 roundings cover a walk-order sum over hundreds of
    pairs; a dropped or wrong term shows at the scale of the term itself.
    The NaN pattern and the ρ and NaN-count lanes must equal p32's.
    """
    return hold(out, substep_reference(frame, rows, phys, r, capacity, xsph,
                                       alpha_visc, sums_fn, band, tune))


def forces_reference(frame: SortedFrame, rows: torch.Tensor,
                     phys: PhysParams, r: int, capacity: int | None,
                     xsph: float = 0.0, alpha_visc: float = 0.0,
                     sums_fn: SumsFn = forces_plain,
                     tune: SortedTuning | None = None) -> Reference:
    """The reference of :func:`forces_accuracy`: the folded force, and the
    XSPH correction's lanes after it whenever ``xsph`` is nonzero."""
    tune = _variant(sums_fn, tune)
    ext = uses_extensions(xsph, alpha_visc)
    folds = []
    for rw, ph in ((rows, phys), (rows.double(),
                                  PhysParams(*(t.double() for t in phys)))):
        sums = sums_fn(frame, rw, ph, r, capacity, ext, tune=tune)
        folds.append(fold_forces(sums, rw[:, 6], ph, xsph, alpha_visc,
                                 fuse_acc=tune.fuse_acc))
    p32, p64 = folds
    _, _, f_mag, dv_mag = _reference(frame, rows, phys, r, capacity, xsph,
                                     alpha_visc, sums_fn, None, tune)
    if dv_mag is None:
        return Reference(p32[0], p64[0], f_mag)
    return Reference(torch.cat(p32, 1), torch.cat(p64, 1),
                     torch.cat([f_mag, dv_mag], 1))


def forces_out(f: torch.Tensor, dv: torch.Tensor | None,
               xsph: float) -> torch.Tensor:
    """(f, dv) as :func:`hold` reads folded forces: dv's lanes after f's
    when ``xsph`` is nonzero, None standing for zeros."""
    if xsph == 0.0:
        return f
    return torch.cat([f, torch.zeros_like(f) if dv is None else dv], 1)


def forces_accuracy(frame: SortedFrame, rows: torch.Tensor, f: torch.Tensor,
                    dv: torch.Tensor | None, phys: PhysParams, r: int,
                    capacity: int | None, xsph: float = 0.0,
                    alpha_visc: float = 0.0,
                    sums_fn: SumsFn = forces_plain,
                    tune: SortedTuning | None = None) -> Accuracy:
    """Holds (``f``, ``dv``), the folded force and XSPH correction computed
    elsewhere (K3 or K5 + :func:`fold_forces`), to the plain version
    ``sums_fn`` in the variant ``tune`` particle by particle, under the
    rule of :func:`substep_accuracy`: σ is the folded magnitude sum of each
    output lane. ``dv`` None stands for zeros; its lanes are checked whenever
    ``xsph`` is nonzero."""
    return hold(forces_out(f, dv, xsph),
                forces_reference(frame, rows, phys, r, capacity, xsph,
                                 alpha_visc, sums_fn, tune))


# ------------------------------------------------------------ CUDA route --

def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: tuple[int, ...], device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: kernel takes a contiguous, 16-byte aligned {dtype} "
            f"tensor of shape {shape} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _band_args(band: tuple[int, int] | None, r: int) -> tuple[int, int]:
    """(zbase, z_span) of the kernels' walk: the whole grid without a
    band."""
    return (0, r) if band is None else (int(band[0]), int(band[1]))


def _check_frame(frame: SortedFrame, n: int, r: int, device: torch.device,
                 band: tuple[int, int] | None = None) -> None:
    s_cells = _band_args(band, r)[1] * r * r
    _check("frame.start", frame.start, torch.int32, (s_cells + 1,), device)
    _check("frame.raw", frame.raw, torch.int32, (n,), device)
    _check("frame.occ", frame.occ, torch.bool, (n,), device)


def _cap_arg(capacity: int | None) -> int:
    return -1 if capacity is None else int(capacity)


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def variant_tag(source: str, tune: SortedTuning) -> str:
    """The launch-count tag of ``tune``'s instance of kernel ``source``:
    "" for the default instance, else "+facc0", "+kahan", "+bf16" for each
    switch it reads that is away from its default
    (``cuda_build.SOURCE_SWITCHES``)."""
    return "".join(f"+{tag}" for field, _, default, tag in cuda_build.SWITCHES
                   if field in cuda_build.SOURCE_SWITCHES[source]
                   and getattr(tune, field) != default)


def density_cuda(frame: SortedFrame, pos_s: torch.Tensor, phys: PhysParams,
                 r: int, capacity: int | None,
                 scal: torch.Tensor | None = None,
                 band: tuple[int, int] | None = None,
                 tune: SortedTuning | None = None) -> torch.Tensor:
    """K1 (``csrc/density.cu``) on the card, banded with ``band``, in
    ``tune``'s variant (``kahan``; None: the default instance). ``scal``
    is :func:`scal_block` of ``phys`` (built here when None); K1 reads none
    of its coefficient lanes, so K2's block serves too."""
    tune = _tuned(tune)
    n = pos_s.shape[0]
    dev = pos_s.device
    _check("pos_s", pos_s, torch.float32, (n, 3), dev)
    _check_frame(frame, n, r, dev, band)
    if scal is None:
        scal = scal_block(phys)
    _check("phys", scal, torch.float32, (N_SCAL,), dev)
    rho = torch.empty(n, dtype=torch.float32, device=dev)
    fn = cuda_build.function("density.cu", "sph_density", tune)
    err = fn(_ptr(pos_s), _ptr(frame.start), _ptr(frame.raw), _ptr(frame.occ),
             _ptr(scal), _ptr(rho), n, r, _cap_arg(capacity),
             *_band_args(band, r),
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on_error("density", err)
    _count(("density" if band is None else "density_band")
           + variant_tag("density.cu", tune))
    return rho


def _walk_launch(fn, name: str, frame: SortedFrame, rows: torch.Tensor,
                 pj: torch.Tensor, scal: torch.Tensor, out: torch.Tensor,
                 r: int, capacity: int | None, ext: bool,
                 band: tuple[int, int] | None = None) -> None:
    """Checks the inputs of K2 or K3 and launches it into ``out``."""
    n = rows.shape[0]
    dev = rows.device
    _check("rows", rows, torch.float32, (n, N_FIELDS), dev)
    _check_frame(frame, n, r, dev, band)
    _check("phys", scal, torch.float32, (N_SCAL,), dev)
    _check("pj", pj, torch.float32, (n, 2), dev)
    err = fn(_ptr(rows), _ptr(pj), _ptr(frame.start), _ptr(frame.raw),
             _ptr(frame.occ), _ptr(scal), _ptr(out), n, r,
             _cap_arg(capacity), *_band_args(band, r), int(ext),
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on_error(name, err)


def forces_cuda(frame: SortedFrame, rows: torch.Tensor, phys: PhysParams,
                r: int, capacity: int | None, ext: bool = False,
                pj: torch.Tensor | None = None,
                scal: torch.Tensor | None = None,
                tune: SortedTuning | None = None) -> torch.Tensor:
    """K3 (``csrc/forces.cu``) on the card: raw sums f32[N, 12] from the
    rows state, in the layout of ``tune``'s instance (:func:`fold_forces`;
    None: the default instance); ``ext`` selects the instance with the
    extension sums. ``pj`` is :func:`pj_cols` of the rows' ρ and ``scal``
    :func:`scal_block` of ``phys``; each is built here when None (the
    ``bf16`` instance with extensions reads ρⱼ from the rows instead). It
    walks the whole grid: the slab step never launches K3."""
    tune = _tuned(tune)
    if pj is None:
        pj = pj_cols(rows[:, 6], phys)
    if scal is None:
        scal = scal_block(phys)
    out = torch.empty((rows.shape[0], N_SUMS), dtype=torch.float32,
                      device=rows.device)
    _walk_launch(cuda_build.function("forces.cu", "sph_forces", tune),
                 "forces", frame, rows, pj, scal, out, r, capacity, ext)
    _count("forces" + variant_tag("forces.cu", tune))
    return out


def fused_substep_cuda(frame: SortedFrame, rows: torch.Tensor,
                       phys: PhysParams, r: int, capacity: int | None,
                       xsph: float = 0.0, alpha_visc: float = 0.0,
                       pj: torch.Tensor | None = None,
                       scal: torch.Tensor | None = None,
                       band: tuple[int, int] | None = None,
                       tune: SortedTuning | None = None) -> torch.Tensor:
    """K2 (``csrc/fused_substep.cu``) on the card, banded with ``band``, in
    ``tune``'s variant (None: the default instance). Reads the state as it
    was before the substep and writes a new rows tensor. Nonzero
    coefficients select the instance with the extension sums. ``pj`` is
    :func:`pj_cols` of the rows' ρ and ``scal`` :func:`scal_block` of
    ``phys`` and the coefficients; each is built here when None."""
    tune = _tuned(tune)
    if pj is None:
        pj = pj_cols(rows[:, 6], phys)
    if scal is None:
        scal = scal_block(phys, xsph, alpha_visc)
    ext = uses_extensions(xsph, alpha_visc)
    out = torch.empty_like(rows)
    _walk_launch(cuda_build.function("fused_substep.cu", "sph_fused_substep",
                                     tune),
                 "fused_substep", frame, rows, pj, scal, out, r, capacity,
                 ext, band)
    name = "fused_substep_ext" if ext else "fused_substep"
    _count((name if band is None else name + "_band")
           + variant_tag("fused_substep.cu", tune))
    return out


# --------------------------------------------------------------- routing --

def density_pass(frame: SortedFrame, pos_s: torch.Tensor, phys: PhysParams,
                 r: int, capacity: int | None,
                 scal: torch.Tensor | None = None,
                 band: tuple[int, int] | None = None,
                 tune: SortedTuning | None = None) -> torch.Tensor:
    """ρ per sorted particle: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor, over the frame's ``band`` (None: the whole
    grid), in ``tune``'s variant. ``capacity`` is the config's voxel
    capacity (None: uncapped); it bounds the walk, the result does not
    depend on it beyond what ``frame.occ`` already says. ``scal`` (as in
    :func:`density_cuda`) is read by the kernel only."""
    if pos_s.is_cuda:
        return density_cuda(frame, pos_s, phys, r, capacity, scal, band,
                            tune)
    return density_plain(frame, pos_s, phys, r, capacity, band, tune)


def forces_pass(frame: SortedFrame, rows: torch.Tensor, phys: PhysParams,
                r: int, capacity: int | None, xsph: float = 0.0,
                alpha_visc: float = 0.0, pj: torch.Tensor | None = None,
                scal: torch.Tensor | None = None,
                tune: SortedTuning | None = None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(force f[N, 3], XSPH correction dv f[N, 3] or None) per sorted
    particle (``forces_pallas``): the raw sums from the CUDA kernel K3 for a
    CUDA tensor or from the plain version for a CPU one, in ``tune``'s
    variant, then :func:`fold_forces`. Integration is the caller's
    (``sim.stepper.integrate_substep``). ``pj`` and ``scal`` (as in
    :func:`forces_cuda`) are read by the kernel only."""
    tune = _tuned(tune)
    ext = uses_extensions(xsph, alpha_visc)
    if rows.is_cuda:
        sums = forces_cuda(frame, rows, phys, r, capacity, ext, pj, scal,
                           tune)
    else:
        sums = forces_plain(frame, rows, phys, r, capacity, ext, tune=tune)
    return fold_forces(sums, rows[:, 6], phys, xsph, alpha_visc,
                       fuse_acc=tune.fuse_acc)


def fused_substep(frame: SortedFrame, rows: torch.Tensor, phys: PhysParams,
                  r: int, capacity: int | None, xsph: float = 0.0,
                  alpha_visc: float = 0.0, pj: torch.Tensor | None = None,
                  scal: torch.Tensor | None = None,
                  band: tuple[int, int] | None = None,
                  tune: SortedTuning | None = None) -> torch.Tensor:
    """One whole integration substep over the rows state (pair forces, m²/ρ
    scaling, extension sums, wall penalty, gravity, NaN trap, semi-implicit
    Euler, clamp): the CUDA kernel K2 for a CUDA tensor, the plain version
    for a CPU one, over the frame's ``band``, in ``tune``'s variant.
    ``pj`` and ``scal`` (as in :func:`fused_substep_cuda`) are read by the
    kernel only."""
    if rows.is_cuda:
        return fused_substep_cuda(frame, rows, phys, r, capacity, xsph,
                                  alpha_visc, pj, scal, band, tune)
    return fused_substep_plain(frame, rows, phys, r, capacity, xsph,
                               alpha_visc, band=band, tune=tune)
