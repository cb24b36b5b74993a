"""Density and fused-substep passes over the sorted frame: CUDA kernels and
their plain PyTorch versions.

Counterpart of ``sphfluidsimulation_tpu/ops/pallas_sph.py``: ``density_pass``
(:1682, Pallas kernel ``_sph_kernel`` with ``force=False``), ``fused_substep``
(:1835, ``_sph_kernel`` with the fused integrate tail :1404-1489),
``pack_rows`` and ``unpack_rows``.

Both passes evaluate, for each sorted particle i, the pairs (i, j) of the
reference's 27-cell walk (Density.compute:42-54, VelPos.compute:67-82): j is
in the bucket (``frame.occ``) and j's RAW frame-start cell, decoded, lies
within Chebyshev distance 1 of i's fresh cell ``trunc(pos_i·(R−1))``. The
density includes the self pair; the substep skips j == i (VelPos.compute:82).
Every gate is a select, so ±inf/NaN values of non-candidates never leak in.

Routing: a CPU tensor goes to the plain version; a CUDA tensor launches the
hand-written kernel (``csrc/density.cu``, ``csrc/fused_substep.cu``) or
raises. The kernels walk ``start[]`` cell by cell, each cell clamped to its
first ``capacity`` slots (only those can be ``occ``), so their candidate set
is exact: the sorted tier has no truncation certificate.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..config import EPSILON
from ..params import PhysParams
from . import cuda_build, sph_math
from .frame import SortedFrame

N_FIELDS = 8             # rows lanes: x, y, z, vx, vy, vz, rho, nan_count
_C_POLY6 = 315.0 / (64.0 * math.pi)
_C_GRAD = 45.0 / math.pi
# candidate entries per chunk of the plain versions' dense gather
_CHUNK_PAIRS = 1 << 21

# Kernel launches per wrapper; a run resets them and reads them back to show
# which kernels its main path went through.
launch_counts = {"density": 0, "fused_substep": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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


def scal_block(phys: PhysParams) -> torch.Tensor:
    """The kernels' scalar block f32[12] on the parameters' device:
    h, h², c₆ = 315/(64π)/h⁹, c_g = 45/π/h⁶, mass, k, ρ₀, μ, stiffness,
    damping, gravity_y, dt. The plain versions use the same constants (in
    the parameters' dtype, so a float64 evaluation is a reference)."""
    h = phys.h
    h2 = h * h
    h6 = h2 * h2 * h2
    h9 = h6 * h2 * h
    return torch.stack([h, h2, _C_POLY6 / h9, _C_GRAD / h6, phys.mass,
                        phys.gas_constant, phys.rest_density, phys.viscosity,
                        phys.stiffness, phys.damping, phys.gravity_y,
                        phys.dt])


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


def _candidates(frame: SortedFrame, c: torch.Tensor, r: int, width: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense candidate gather for the fresh cells ``c`` i32[m, 3]: sorted
    indices i64[m, 27·width] and the membership mask bool[m, 27·width]."""
    offs = torch.tensor(_OFFSETS, dtype=torch.int32, device=c.device)
    nc = c[:, None, :] + offs[None]                          # [m, 27, 3]
    inb = ((nc >= 0) & (nc < r)).all(-1)
    cell = nc[..., 0] + nc[..., 1] * r + nc[..., 2] * (r * r)
    cell = torch.where(inb, cell, 0).long()
    s = frame.start[cell].long()
    cnt = torch.where(inb, frame.start[cell + 1].long() - s, 0)
    k = torch.arange(width, device=c.device)
    j = s[..., None] + k                                     # [m, 27, W]
    valid = k < cnt[..., None].clamp(max=width)
    j = torch.where(valid, j, 0).reshape(c.shape[0], -1)
    valid = valid.reshape(c.shape[0], -1)

    # membership: j in the bucket, its raw cell within 1 of c on each axis
    raw = frame.raw[j]
    rr = r * r
    cz = torch.div(raw, rr, rounding_mode="floor")
    rem = raw - cz * rr
    cy = torch.div(rem, r, rounding_mode="floor")
    cx = rem - cy * r
    member = (valid & frame.occ[j]
              & ((cx - c[:, None, 0]).abs() <= 1)
              & ((cy - c[:, None, 1]).abs() <= 1)
              & ((cz - c[:, None, 2]).abs() <= 1))
    return j, member


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


def density_plain(frame: SortedFrame, pos_s: torch.Tensor,
                  phys: PhysParams, r: int,
                  capacity: int | None) -> torch.Tensor:
    """ρᵢ = m·Σⱼ W_poly6(|xᵢ−xⱼ|²) over the window pairs, self included
    (Density.compute:32-60)."""
    n = pos_s.shape[0]
    sc = scal_block(phys)
    h2, c9 = sc[1], sc[2]
    width = _window_width(frame, capacity)
    rows = max(1, _CHUNK_PAIRS // (27 * width))
    w_sum = torch.empty(n, dtype=pos_s.dtype, device=pos_s.device)
    for i0 in range(0, n, rows):
        p = pos_s[i0:i0 + rows]
        j, member = _candidates(frame, fresh_cell(p, r), r, width)
        d = p[:, None, :] - pos_s[j]
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        diff = h2 - r2
        w = torch.where(diff > 0, c9 * diff * diff * diff, 0.0)
        w_sum[i0:i0 + rows] = _tree_sum(torch.where(member, w, 0.0))
    return phys.mass * w_sum


def pair_forces_plain(frame: SortedFrame, pos_s: torch.Tensor,
                      vel_s: torch.Tensor, rho_s: torch.Tensor,
                      phys: PhysParams, r: int, capacity: int | None,
                      magnitude: bool = False) -> torch.Tensor:
    """Pressure + viscosity force per sorted particle, f32[N, 3], after the
    guarded m²/ρᵢ scaling (VelPos.compute:64-105; the formulas of
    ``ops/brute.py::fluid_forces_bruteforce``). ``rho_s`` is the frame-start
    density; positions and velocities are fresh.

    With ``magnitude`` each pair term is replaced by the scale its float32
    rounding works at, and the sums add those: a difference that may cancel
    (pᵢ + pⱼ, h − |r|, vⱼ − vᵢ) enters by the sizes of its operands. The
    result bounds the rounding of a float32 evaluation, up to a count of
    roundings (``substep_accuracy``)."""
    n = pos_s.shape[0]
    h = phys.h
    h2 = h * h
    h6 = h2 * h2 * h2                              # as in scal_block
    press = sph_math.eos_pressure(rho_s, phys.gas_constant, phys.rest_density)
    rho_ok = rho_s > EPSILON                       # per-j guard (:91)
    safe = torch.where(rho_ok, rho_s, 1.0)
    width = _window_width(frame, capacity)
    rows = max(1, _CHUNK_PAIRS // (27 * width))
    f_press = torch.empty_like(pos_s)
    f_vis = torch.empty_like(pos_s)
    for i0 in range(0, n, rows):
        p = pos_s[i0:i0 + rows]
        ids = torch.arange(i0, i0 + p.shape[0], device=pos_s.device)
        j, member = _candidates(frame, fresh_cell(p, r), r, width)
        m = member & (j != ids[:, None]) & rho_ok[j]          # skip j == i
        d = p[:, None, :] - pos_s[j]                          # pos_i − pos_j
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        abs_r = torch.sqrt(r2)
        g = sph_math.grad_w_press_over_r(abs_r, h, h6)
        gwv = sph_math.grad_w_vis_r(abs_r, h, h6)
        p_i, p_j = press[i0:i0 + rows, None], press[j]
        v_i, v_j = vel_s[i0:i0 + rows, None, :], vel_s[j]
        if magnitude:
            hr = h - abs_r
            g = torch.where(g != 0, g + 3 * _C_GRAD / h6 * h * hr * hr / abs_r,
                            0.0)
            gwv = torch.where(abs_r < h, gwv + _C_GRAD / h6 * h, 0.0)
            p_i, p_j, d = p_i.abs(), p_j.abs(), d.abs()
            v_i, v_j = -v_i.abs(), v_j.abs()          # dv = |v_j| + |v_i|
        pc = (p_i + p_j) / (2.0 * safe[j])
        t_press = pc[..., None] * (g[..., None] * d)
        vc = gwv / safe[j]
        dv = v_j - v_i                                        # v_j − v_i
        t_vis = vc[..., None] * dv
        f_press[i0:i0 + rows] = _tree_sum(torch.where(m[..., None], t_press,
                                                      0.0))
        f_vis[i0:i0 + rows] = _tree_sum(torch.where(m[..., None], t_vis,
                                                    0.0))
    # final scaling, guarded by ρᵢ > ε (VelPos.compute:101-105): when the
    # guard fails the raw sums pass through unscaled, as in the reference
    i_ok = rho_ok[:, None]
    s_i = safe[:, None]
    m_ = phys.mass
    f_press = torch.where(i_ok, f_press * (m_ * m_ / s_i), f_press)
    f_vis = torch.where(i_ok, f_vis * (phys.viscosity * m_ * m_ / s_i), f_vis)
    return f_press + f_vis


def fused_substep_plain(frame: SortedFrame, rows: torch.Tensor,
                        phys: PhysParams, r: int,
                        capacity: int | None) -> torch.Tensor:
    """One substep over the rows state: pair forces, then the integrate
    tail of ``sim.stepper.integrate_substep`` (VelPos.compute:49-157)."""
    from ..sim.stepper import integrate_substep

    pos, vel, rho = rows[:, 0:3], rows[:, 3:6], rows[:, 6]
    f = pair_forces_plain(frame, pos, vel, rho, phys, r, capacity)
    pos_n, vel_n, nan_mask = integrate_substep(pos, vel, f, phys)
    return pack_rows(pos_n, vel_n, rho, rows[:, 7] + nan_mask.to(rows.dtype))


# ---------------------------------------------------------- accuracy rule --

_U32 = 2.0 ** -24        # unit roundoff of float32
# |k − p64| ≤ SUBSTEP_ERR_FACTOR·|p32 − p64| + SUBSTEP_ROUNDINGS·u·σ
SUBSTEP_ERR_FACTOR = 4.0
SUBSTEP_ROUNDINGS = 256.0


class SubstepAccuracy(NamedTuple):
    ok: bool              # every check below holds
    same_nan: bool        # NaN pattern equal to p32's
    same_aux: bool        # ρ and NaN-count lanes equal to p32's
    n_over: int           # position/velocity lanes over their bound
    roundings: float      # max (|k − p64| − 4·|p32 − p64|) / (u·σ)
    err_pos: float        # max |k − p64| over positions
    err_vel: float        # max |k − p64| over velocities
    err_plain_vel: float  # max |p32 − p64| over velocities


def substep_accuracy(frame: SortedFrame, rows: torch.Tensor,
                     out: torch.Tensor, phys: PhysParams, r: int,
                     capacity: int | None) -> SubstepAccuracy:
    """Holds ``out``, one substep of ``rows`` computed elsewhere (the CUDA
    kernel), to the accuracy of the plain version, particle by particle.

    The golden EOS explodes (FIDELITY.md Part D): force sums cancel terms
    many orders above their result, so no fixed tolerance against the
    float32 plain version p32 means anything. Against p64, the plain version
    evaluated in float64 on the same float32 inputs, each particle and each
    position or velocity lane must satisfy

        |out − p64| ≤ 4·|p32 − p64| + 256·u·σ,

    with u = 2⁻²⁴ and σ the scale that lane's float32 rounding works at:
    σ_v = |v| + |v'| + dt/m·(F + W) + dt·|g| for a velocity, with F the
    pair sums' rounding scale (``pair_forces_plain(magnitude=True)``) and
    W the wall force's; σ_x = |x| + |x'| + dt·σ_v for a position (primes:
    p64's result). 256 roundings cover a walk-order sum over hundreds of
    pairs; a dropped or wrong term shows at the scale of the term itself.
    The NaN pattern and the ρ and NaN-count lanes must equal p32's.
    """
    p32 = fused_substep_plain(frame, rows, phys, r, capacity)
    rows64 = rows.double()
    ph = PhysParams(*(t.double() for t in phys))
    p64 = fused_substep_plain(frame, rows64, ph, r, capacity)
    pos, vel, rho = rows64[:, 0:3], rows64[:, 3:6], rows64[:, 6]
    terms = pair_forces_plain(frame, pos, vel, rho, ph, r, capacity,
                              magnitude=True)
    # the wall force's rounding scale: its depth h − x or 1 − x − h
    # cancels, and so may depth·stiffness − Σ damping·v
    near = ((pos < ph.h) | (pos > 1.0 - ph.h)).any(-1, keepdim=True)
    wall = torch.where(near, ph.mass * (
        ph.stiffness * (1.0 + ph.h + pos.abs())
        + ph.damping * vel.abs().sum(-1, keepdim=True)), 0.0)
    zero = torch.zeros_like(ph.gravity_y)
    g = torch.stack([zero, ph.gravity_y, zero]).abs()
    sig_v = vel.abs() + p64[:, 3:6].abs() \
        + ph.dt / ph.mass * (terms + wall) + ph.dt * g
    sig_x = pos.abs() + p64[:, 0:3].abs() + ph.dt * sig_v
    sigma = torch.cat([sig_x, sig_v], 1)

    def err(x: torch.Tensor) -> torch.Tensor:
        x, ref = x[:, :6].double(), p64[:, :6]
        return torch.where(x == ref, 0.0, (x - ref).abs())   # inf == inf

    nan_p = torch.isnan(p32)
    same_nan = bool((torch.isnan(out) == nan_p).all())
    same_aux = bool((out[:, 6:8] == p32[:, 6:8]).all())
    fin = ~(nan_p[:, :6] | torch.isnan(p64[:, :6]))
    e_k = torch.where(fin, err(out), 0.0)
    e_p = torch.where(fin, err(p32), 0.0)
    over = e_k > SUBSTEP_ERR_FACTOR * e_p + SUBSTEP_ROUNDINGS * _U32 * sigma
    need = (e_k - SUBSTEP_ERR_FACTOR * e_p) / (_U32 * sigma)
    need = torch.where(torch.isnan(need), 0.0, need)     # inf − inf, 0 / 0
    n_over = int(over.sum())
    return SubstepAccuracy(
        ok=same_nan and same_aux and n_over == 0, same_nan=same_nan,
        same_aux=same_aux, n_over=n_over, roundings=float(need.max()),
        err_pos=float(e_k[:, :3].max()), err_vel=float(e_k[:, 3:].max()),
        err_plain_vel=float(e_p[:, 3:].max()))


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


def _check_frame(frame: SortedFrame, n: int, r: int,
                 device: torch.device) -> None:
    _check("frame.start", frame.start, torch.int32, (r * r * r + 1,), device)
    _check("frame.raw", frame.raw, torch.int32, (n,), device)
    _check("frame.occ", frame.occ, torch.bool, (n,), device)


def _cap_arg(capacity: int | None) -> int:
    return -1 if capacity is None else int(capacity)


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def density_cuda(frame: SortedFrame, pos_s: torch.Tensor, phys: PhysParams,
                 r: int, capacity: int | None) -> torch.Tensor:
    """K1 (``csrc/density.cu``) on the card."""
    n = pos_s.shape[0]
    dev = pos_s.device
    _check("pos_s", pos_s, torch.float32, (n, 3), dev)
    _check_frame(frame, n, r, dev)
    scal = scal_block(phys)
    _check("phys", scal, torch.float32, (12,), dev)
    rho = torch.empty(n, dtype=torch.float32, device=dev)
    lib = cuda_build.load()
    err = lib.sph_density(
        _ptr(pos_s), _ptr(frame.start), _ptr(frame.raw), _ptr(frame.occ),
        _ptr(scal), _ptr(rho), n, r, _cap_arg(capacity),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on_error("density", err)
    launch_counts["density"] += 1
    return rho


def fused_substep_cuda(frame: SortedFrame, rows: torch.Tensor,
                       phys: PhysParams, r: int,
                       capacity: int | None) -> torch.Tensor:
    """K2 (``csrc/fused_substep.cu``) on the card. Reads the state as it was
    before the substep and writes a new rows tensor."""
    n = rows.shape[0]
    dev = rows.device
    _check("rows", rows, torch.float32, (n, N_FIELDS), dev)
    _check_frame(frame, n, r, dev)
    scal = scal_block(phys)
    _check("phys", scal, torch.float32, (12,), dev)
    out = torch.empty_like(rows)
    lib = cuda_build.load()
    err = lib.sph_fused_substep(
        _ptr(rows), _ptr(frame.start), _ptr(frame.raw), _ptr(frame.occ),
        _ptr(scal), _ptr(out), n, r, _cap_arg(capacity),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on_error("fused_substep", err)
    launch_counts["fused_substep"] += 1
    return out


# --------------------------------------------------------------- routing --

def density_pass(frame: SortedFrame, pos_s: torch.Tensor, phys: PhysParams,
                 r: int, capacity: int | None) -> torch.Tensor:
    """ρ per sorted particle: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. ``capacity`` is the config's voxel capacity
    (None: uncapped); it bounds the walk, the result does not depend on it
    beyond what ``frame.occ`` already says."""
    if pos_s.is_cuda:
        return density_cuda(frame, pos_s, phys, r, capacity)
    return density_plain(frame, pos_s, phys, r, capacity)


def fused_substep(frame: SortedFrame, rows: torch.Tensor, phys: PhysParams,
                  r: int, capacity: int | None) -> torch.Tensor:
    """One whole integration substep over the rows state (pair forces, m²/ρ
    scaling, wall penalty, gravity, NaN trap, semi-implicit Euler, clamp):
    the CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if rows.is_cuda:
        return fused_substep_cuda(frame, rows, phys, r, capacity)
    return fused_substep_plain(frame, rows, phys, r, capacity)
