"""Tensor-core probe of the force pair: can the six per-pair accumulates, and
the Gram form of r², move onto the matrix unit, at what speed, and at what
cost in accuracy?

Counterpart of ``scripts/probe_mxu_tpu.py`` (``build_call``'s pallas_call,
:217), variants D, G, A, M (64-row tiles) and D128, A128, M128 (128-row
tiles) on the script's inputs (:func:`synth_inputs`, its own numpy copy:
262,144 rows, a window f32[97, 8, 128], 11 chunks a 64-row tile, 22 a
128-row tile, read from a 16-entry list as the script's loop reads it):

- D: the direct pair, six sums on the FP32 units;
- G: D with r² = |xᵢ|² + |xⱼ|² − 2 xᵢ·xⱼ, the Gram term a product;
- A: the direct r², the accumulates as two products against the
  ones-augmented candidates, fᵢ = xᵢ Σpc − Σ pc xⱼ and vᵢ = Σ vc vⱼ − vᵢ Σvc;
- M: G's r² and A's accumulates.

On the card the matrix unit is the tensor cores: ``csrc/probes/mxu.cu``
issues ``mma.sync.aligned.m16n8k8`` with TF32 inputs from inline PTX, in
two instances: one pass on inputs rounded by ``cvt.rna.tf32.f32`` (1×TF32,
the analogue of the TPU's default one-pass f32 dot) and the hi/lo split
with three products (3×TF32, the analogue of ``Precision.HIGHEST``). D has
no product and one instance.

The plain version (:func:`mxu_plain`) computes the same forms in float32;
with ``tf32=True`` it rounds each product's inputs as ``cvt.rna`` does
(:func:`tf32_round`). The 1×TF32 kernels are held to that rounding plain
version, D and the 3×TF32 kernels to the float32 one, under
:func:`mxu_rule`; on the card each 1×TF32 instance with a product (G, A,
M, A128, M128) and A at 3×TF32 also launch planted controls
(:data:`CONTROLS`), wrong kernels the rule must fail. The probe prints
the script's divergence table (D against G, A, M; D128 against A128,
M128: max abs, max rel, scale-rel) for
each instance, and, as the one PyTorch call that computes part of this
work, ``torch.bmm`` of the accumulate product with TF32 on and off (the
port does not use it).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda_build
from . import common

SOURCE = "probes/mxu.cu"
REPLACES = "scripts/probe_mxu_tpu.py:217"
LANES = 128
N_WF = 8
W_ROWS = 97
N_PART = 1 << 18
R = 47
MAXC = 16
VARIANTS = ("D", "G", "A", "M", "D128", "A128", "M128")
MODES = {"D": 0, "G": 1, "A": 2, "M": 3}
PAIRS = (("D", "G"), ("D", "A"), ("D", "M"), ("D128", "A128"),
         ("D128", "M128"))
# plain versions: candidate entries a block (peak memory about 2 GB with
# the float64 scales)
PLAIN_ELEMS = 1 << 23
_U32 = 2.0 ** -24
# the rule (mxu_rule): |k − p64| ≤ 4·|p32 − p64| + 256·u·σ + E + Γ + Φ
ERR_FACTOR = 4.0
ROUNDINGS = 256.0
# Φ's window: FLIP_FACTOR times the first-order rounding error of a float32
# coefficient (_coefficient_errors), whose roundings that do not cancel (√,
# 1/√ within 2 ulp, 1/ρ, the products, a contracted |r|²) COEF_ROUNDINGS
# counts
COEF_ROUNDINGS = 16.0
FLIP_FACTOR = 4.0
# the planted controls: csrc/probes/mxu.cu's fault switch
FAULTS = {"ones column zeroed": 1, "first chunk dropped": 2,
          "velocity accumulate negated": 3}
_WRONG = ("first chunk dropped", "velocity accumulate negated")
# (variant, TF32 passes) → the controls launched beside it on the card
CONTROLS = {("G", 1): _WRONG, ("A", 1): ("ones column zeroed",) + _WRONG,
            ("A", 3): ("ones column zeroed",), ("M", 1): _WRONG,
            ("A128", 1): _WRONG, ("M128", 1): _WRONG}


def rows_of(variant: str) -> int:
    return 128 if variant.endswith("128") else 64


def mode_of(variant: str) -> str:
    return variant[0]


def instances() -> list[tuple[str, int]]:
    """(variant, TF32 passes) of every kernel instance: D and D128 once
    (no product), the others at 1 and 3."""
    return [(v, p) for v in VARIANTS for p in ((1,) if v[0] == "D"
                                               else (1, 3))]


def kernel_name(variant: str, prec: int) -> str:
    return f"mxu_{variant}" if variant[0] == "D" else f"mxu_{variant}_{prec}x"


def n_chunks(rows_n: int) -> int:
    """The script's chunks a tile: 11 a 64-row tile."""
    return max(4, int(round(11 * rows_n / 64.0)))


class MxuInputs(NamedTuple):
    win: torch.Tensor    # f32[97, 8, 128]
    flat: torch.Tensor   # i32[T, 16]
    fcnt: torch.Tensor   # i32[T, 1]
    rows: torch.Tensor   # f32[T, rows_n, 8]


def synth_inputs(rng: np.random.RandomState, rows_n: int,
                 n_part: int = N_PART) -> tuple[np.ndarray, ...]:
    """The script's ``synth_inputs`` (numpy, the same draws in the same
    order): golden-statistics positions and cells, so the membership gate
    passes at a realistic rate and the pair sees support-scale distances."""
    tpg = 1024 // rows_n
    t = (n_part // 1024) * tpg
    nc = n_chunks(rows_n)
    k0 = rng.randint(0, W_ROWS - 1, size=(t, MAXC)).astype(np.int32)
    flat = np.full((t, MAXC), -1, np.int32)
    flat[:, :nc] = k0[:, :nc]
    fcnt = np.full((t, 1), nc, np.int32)
    win = np.zeros((W_ROWS, N_WF, LANES), np.float32)
    pos_j = rng.rand(W_ROWS, LANES, 3).astype(np.float32)
    win[:, 0:3, :] = np.transpose(pos_j, (0, 2, 1))
    cell_j = np.minimum((pos_j * (R - 1)).astype(np.int64), R - 1)
    cid_j = cell_j[..., 0] + cell_j[..., 1] * R + cell_j[..., 2] * R * R
    win[:, 3, :] = cid_j.astype(np.float32)
    win[:, 4:7, :] = rng.randn(W_ROWS, 3, LANES).astype(np.float32) * 0.1
    win[:, 7, :] = (1.0 + rng.rand(W_ROWS, LANES)).astype(np.float32)
    rows = np.zeros((t, rows_n, N_WF), np.float32)
    rows[:, :, 0:3] = rng.rand(t, rows_n, 3).astype(np.float32)
    rows[:, :, 3:6] = rng.randn(t, rows_n, 3).astype(np.float32) * 0.1
    rows[:, :, 6] = (1.0 + rng.rand(t, rows_n)).astype(np.float32)
    return win, flat, fcnt, rows


def script_inputs(device, n_part: int = N_PART) -> dict[int, MxuInputs]:
    """The script's two input sets, by tile height: the 64-row set drawn
    first from RandomState(0), the 128-row set from a fresh RandomState(0)
    (as its main() draws them)."""
    rng = np.random.RandomState(0)
    i64 = synth_inputs(rng, 64, n_part)
    i128 = synth_inputs(np.random.RandomState(0), 128, n_part)
    return {n: MxuInputs(*(torch.from_numpy(a).to(device) for a in arrs))
            for n, arrs in ((64, i64), (128, i128))}


def tf32_spread(c: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """The most by which two float32 values within ``window`` of the
    float64 values ``c`` can round apart to TF32: rounding is monotone, so
    the rounded ends of the interval bound it (0 where no rounding
    midpoint lies within)."""
    a = c.abs()
    return tf32_round((a + window).float()).double() \
        - tf32_round((a - window).clamp(min=0.0).float()).double()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    the nearest value with 10 mantissa bits, ties away from zero, the low
    13 bits zero; NaN kept."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, r)


def _chunk_lists(inp: MxuInputs, sl: slice):
    """The chunks each tile evaluates: entry min(k, 15) of its list for k <
    fcnt, as the script's loop reads it, and whether each is evaluated."""
    width = int(inp.fcnt.max())
    k = torch.arange(width, device=inp.flat.device)
    e = inp.flat[sl][:, k.clamp(max=MAXC - 1)]
    valid = (k < inp.fcnt[sl]) & (e >= 0)
    return e.clamp(min=0).long(), valid


def _gate(blk: torch.Tensor, valid: torch.Tensor,
          rows: torch.Tensor) -> torch.Tensor:
    """The membership gate (float32, as the kernel computes it): the
    candidate's cell within 1 of the row's fresh cell on each axis."""
    cid = blk[:, None, :, 3, :]                         # [b, 1, K, 128]
    cz = torch.floor((cid + 0.5) / (R * R))
    rem = cid - cz * (R * R)
    cy = torch.floor((rem + 0.5) / R)
    cx = rem - cy * R
    f = (rows[..., 0:3] * (R - 1.0)).to(torch.int32).float()
    fx, fy, fz = (f[..., k, None, None] for k in range(3))
    return ((cid >= 0.0) & ((cx - fx).abs() <= 1.0)
            & ((cy - fy).abs() <= 1.0) & ((cz - fz).abs() <= 1.0)
            & valid[:, None, :, None])


def _coefficients(r2, rho_j, press_i, gate, dtype):
    """(pc, vc) of the pairs at squared distance r2."""
    h = torch.tensor(1.0 / (R - 1), dtype=torch.float32).to(dtype)
    h2 = h * h
    cg_h6 = torch.tensor(45.0 / math.pi, dtype=torch.float32).to(dtype) \
        / (h2 * h2 * h2)
    rho_ok = rho_j > 1e-6
    inv_rho = torch.where(rho_ok, 1.0, 0.0).to(dtype) \
        / torch.where(rho_ok, rho_j, 1.0)
    abs_r = torch.sqrt(r2)
    rs = torch.rsqrt(torch.clamp(r2, min=1e-30))
    diff = h - abs_r
    valid = (diff > 1e-6) & (abs_r > 1e-6)
    press_j = 150.0 * (rho_j - 1.5)
    press = press_i + press_j
    gwp = torch.where(valid, cg_h6 * diff * diff * diff * rs, 0.0)
    gwv = torch.where(abs_r < h, cg_h6 * diff, 0.0)
    pc = torch.where(gate, press * 0.5 * inv_rho * gwp, 0.0)
    vc = torch.where(gate, gwv * inv_rho, 0.0)
    return pc, vc


def _coefficient_errors(r2, rho_j, press_i, pc, vc):
    """First-order bounds (float64) on the float32 rounding error of the
    coefficients pc and vc at r2, the kernel's or the plain version's:

        |δpc| ≤ u·|pc|·(16 + 7.5·|r| / |h − |r|| + (|pᵢ| + |pⱼ|) / |pᵢ + pⱼ|)
        |δvc| ≤ u·|vc|·(16 + 2.5·|r| / |h − |r||)

    |r| carries 2.5 roundings (|r|², √, or 1/√), which h − |r| magnifies
    (cubed in pc); pᵢ + pⱼ may cancel; 16 counts the rest."""
    h = torch.tensor(1.0 / (R - 1), dtype=torch.float32).double()
    abs_r = torch.sqrt(r2)
    near = abs_r / (h - abs_r).abs()
    press_j = 150.0 * (rho_j - 1.5)
    cancel = (press_i.abs() + press_j.abs()) / (press_i + press_j).abs()
    e_pc = _U32 * pc.abs() * (COEF_ROUNDINGS + 7.5 * near + cancel)
    e_vc = _U32 * vc.abs() * (COEF_ROUNDINGS + 2.5 * near)
    # a zero coefficient is exact (outside the gate or the support)
    return torch.where(pc == 0, 0.0, e_pc), torch.where(vc == 0, 0.0, e_vc)


def _gram_r2(row, cand, tf32: bool, dtype, delta: float = 0.0):
    """r² = max(|xᵢ|² + |xⱼ|² − 2 xᵢ·xⱼ + delta·(|xᵢ|² + |xⱼ|²), 0) in
    ``dtype`` from the float32 rows f32[b, R, 1, 1, 8] and candidates
    f32[b, 1, K, 8, 128]: the dot product's three terms summed in order
    (in float32 as fused multiply-adds), its inputs TF32-rounded with
    ``tf32``; the norms from the unrounded inputs."""
    xi = row[..., 0:3]                                   # [b, R, 1, 1, 3]
    xj = cand[:, :, :, 0:3, :]                           # [b, 1, K, 3, 128]
    ri, rj = (tf32_round(xi), tf32_round(xj)) if tf32 else (xi, xj)
    if dtype == torch.float32:
        # JAX's order on the CPU (XLA's dot): fma(z, z', fma(y, y', x x')),
        # each fused multiply-add rounded once (its product is exact in
        # float64)
        def fma(a, b, c):
            return (a.double() * b.double() + c.double()).float()

        g2 = fma(ri[..., 2], rj[..., 2, :],
                 fma(ri[..., 1], rj[..., 1, :], ri[..., 0] * rj[..., 0, :]))
    else:
        ri, rj = ri.to(dtype), rj.to(dtype)
        g2 = (ri[..., 0] * rj[..., 0, :] + ri[..., 1] * rj[..., 1, :]) \
            + ri[..., 2] * rj[..., 2, :]
    xi, xj = xi.to(dtype), xj.to(dtype)
    nrm_i = (xi[..., 0] * xi[..., 0] + xi[..., 1] * xi[..., 1]) \
        + xi[..., 2] * xi[..., 2]
    nrm_j = (xj[..., 0, :] * xj[..., 0, :] + xj[..., 1, :] * xj[..., 1, :]) \
        + xj[..., 2, :] * xj[..., 2, :]
    return torch.clamp((nrm_i + nrm_j) - 2.0 * g2
                       + delta * (nrm_i + nrm_j), min=0.0)


class Scales(NamedTuple):
    """f64[T, rows_n, 6] each: the rule's magnitudes (:func:`mxu_plain`)."""
    sig: torch.Tensor   # σ, the magnitude each lane's sums work at
    coef: torch.Tensor  # E, the coefficients' own rounding
    gam: torch.Tensor   # Γ, the Gram form's sensitivity
    phi: torch.Tensor   # Φ, the TF32 rounding flips of the coefficients


def mxu_plain(variant: str, inp: MxuInputs, tf32: bool = False,
              dtype: torch.dtype = torch.float32, scales: bool = False):
    """The script kernel's output [T, rows_n, 8] for ``variant`` in
    ``dtype`` (the six sums in lanes 0-5). ``tf32`` rounds the products'
    inputs (A, M: pc, vc and the candidates; G, M: the Gram coordinates) as
    the 1×TF32 kernel does. With ``scales`` also their :class:`Scales`:

    - σ: the magnitude each lane's sums work at, Σ |pc|·|dx| (the
      accumulate form: Σ |pc|·(|xᵢ| + |xⱼ|), the two products the finish
      subtracts), |pc| raised by the Gram change below;
    - E (D, G and 3×TF32): the coefficients' own float32 rounding,
      Σ ``FLIP_FACTOR``·e(pc)·|dx|, e the first-order bound of
      :func:`_coefficient_errors`;
    - Γ: the Gram form's sensitivity, Σ over pairs of the change of each
      coefficient when r² moves by 8·u·(|xᵢ|² + |xⱼ|²), the rounding of its
      float32 Gram sum, times σ's factor;
    - Φ (in place of E for the ``tf32`` accumulate forms A, M): Σ over the
      pairs whose pc (vc) a kernel may round to another TF32 value than
      the plain version, of the most the two roundings differ by
      (:func:`tf32_spread`), times |xᵢ − xⱼ| (|vⱼ − vᵢ|), the rounded
      candidate's: the kernel's float32 coefficient lies within
      ``FLIP_FACTOR``·e (+ the Gram change) of the exact one. Elsewhere
      both round to the same TF32 value, and the coefficient's own
      rounding leaves no trace."""
    mode, rows_n = mode_of(variant), rows_of(variant)
    gram, mma = mode in "GM", mode in "AM"
    t = inp.rows.shape[0]
    out = inp.rows.new_zeros((t, rows_n, 8), dtype=dtype)
    sc = Scales(*(torch.zeros((t, rows_n, 6), dtype=torch.float64,
                              device=inp.rows.device)
                  for _ in range(4))) if scales else None
    width = int(inp.fcnt.max())
    step = max(1, PLAIN_ELEMS // (rows_n * width * LANES))
    for t0 in range(0, t, step):
        sl = slice(t0, min(t0 + step, t))
        e, valid = _chunk_lists(inp, sl)
        blk32 = inp.win[e]                                # [b, K, 8, 128]
        gate = _gate(blk32, valid, inp.rows[sl])
        cand32 = blk32[:, None]                           # [b, 1, K, 8, 128]
        row32 = inp.rows[sl][:, :, None, None, :]         # [b, R, 1, 1, 8]
        cand, row = cand32.to(dtype), row32.to(dtype)
        d = [row[..., k] - cand[:, :, :, k] for k in range(3)]
        dv = [cand[:, :, :, 4 + k] - row[..., 3 + k] for k in range(3)]
        if gram:
            r2 = _gram_r2(row32, cand32, tf32, dtype)
        else:
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        rho_j = cand[:, :, :, 7]
        press_i = 150.0 * (row[..., 6] - 1.5)
        pc, vc = _coefficients(r2, rho_j, press_i, gate, dtype)
        if mma:
            if tf32:
                pr, vr = (tf32_round(x.float()).to(dtype) for x in (pc, vc))
                xs = [tf32_round(blk32[:, None, :, k]).to(dtype)
                      for k in (0, 1, 2, 4, 5, 6)]
            else:
                pr, vr = pc, vc
                xs = [cand[:, :, :, k] for k in (0, 1, 2, 4, 5, 6)]
            spc, svc = pr.sum((2, 3)), vr.sum((2, 3))
            for k in range(3):
                out[sl, :, k] = row[:, :, 0, 0, k] * spc \
                    - (pr * xs[k]).sum((2, 3))
                out[sl, :, 3 + k] = (vr * xs[3 + k]).sum((2, 3)) \
                    - row[:, :, 0, 0, 3 + k] * svc
        else:
            for k in range(3):
                out[sl, :, k] = (pc * d[k]).sum((2, 3))
                out[sl, :, 3 + k] = (vc * dv[k]).sum((2, 3))
        if not scales:
            continue
        r64 = inp.rows[sl][:, :, None, None, :].double()
        rho64, press64 = blk32[:, None, :, 7].double(), \
            150.0 * (r64[..., 6] - 1.5)
        dpc = torch.zeros_like(pc)
        dvc = torch.zeros_like(vc)
        if gram:
            for sign in (1.0, -1.0):
                p2, v2 = _coefficients(
                    _gram_r2(row32, cand32, tf32, torch.float64,
                             sign * 8.0 * _U32), rho64, press64, gate,
                    torch.float64)
                dpc = torch.maximum(dpc, (p2 - pc).abs())
                dvc = torch.maximum(dvc, (v2 - vc).abs())
        e_pc, e_vc = _coefficient_errors(r2, rho64, press64, pc, vc)
        # the factors a coefficient's change enters each lane by: dx, or,
        # in the accumulate form, its two products xᵢ Σpc and Σ pc xⱼ (with
        # 1×TF32, xⱼ rounded: they no longer cancel to dx)
        if mma:
            f_d = [r64[..., k].abs() + xs[k].abs() for k in range(3)]
            f_dv = [xs[3 + k].abs() + r64[..., 3 + k].abs()
                    for k in range(3)]
        else:
            f_d = [x.abs() for x in d]
            f_dv = [x.abs() for x in dv]
        mag_p, mag_v = pc.abs() + dpc, vc.abs() + dvc
        flip = mma and tf32
        if flip:
            fp = tf32_spread(pc, FLIP_FACTOR * e_pc + dpc)
            fv = tf32_spread(vc, FLIP_FACTOR * e_vc + dvc)
        for k in range(3):
            sc.sig[sl, :, k] = (mag_p * f_d[k]).sum((2, 3))
            sc.sig[sl, :, 3 + k] = (mag_v * f_dv[k]).sum((2, 3))
            sc.gam[sl, :, k] = (dpc * f_d[k]).sum((2, 3))
            sc.gam[sl, :, 3 + k] = (dvc * f_dv[k]).sum((2, 3))
            if flip:
                sc.phi[sl, :, k] = (fp * (r64[..., k] - xs[k]).abs()) \
                    .sum((2, 3))
                sc.phi[sl, :, 3 + k] = (fv * (xs[3 + k] - r64[..., 3 + k])
                                        .abs()).sum((2, 3))
            else:
                sc.coef[sl, :, k] = FLIP_FACTOR * (e_pc * d[k].abs()) \
                    .sum((2, 3))
                sc.coef[sl, :, 3 + k] = FLIP_FACTOR * (e_vc * dv[k].abs()) \
                    .sum((2, 3))
    return (out, sc) if scales else out


class Rule(NamedTuple):
    """An instance's plain version and its bound, [T, rows_n, 6] each."""
    p32: torch.Tensor   # the plain version in float32
    p64: torch.Tensor   # in float64
    tol: torch.Tensor   # the most |k − p64| may be, lane by lane


class Hold(NamedTuple):
    ok: bool
    n_over: int        # lanes over the bound
    err: float         # max |k − p64|
    scale_rel: float   # against p32, the scripts' measure


def mxu_rule(variant: str, prec: int, inp: MxuInputs) -> Rule:
    """The rule ``variant`` at ``prec`` TF32 passes is held to, against the
    plain version of the same rounding (1×TF32: the products' inputs
    rounded; D and 3×TF32: float32), lane by lane:

        |k − p64| ≤ 4·|p32 − p64| + 256·u·σ + E + Γ + Φ,

    p32 and p64 the plain version in float32 and float64 (the same
    rounding of the products' inputs, the same gate), u = 2⁻²⁴, σ, E, Γ
    and Φ as :func:`mxu_plain` gives them. A dropped or wrong term shows at
    the scale of the term."""
    tf32 = prec == 1 and mode_of(variant) != "D"
    p32 = mxu_plain(variant, inp, tf32)[..., :6]
    p64, sc = mxu_plain(variant, inp, tf32, torch.float64, True)
    p64 = p64[..., :6]
    tol = ERR_FACTOR * (p32.double() - p64).abs() \
        + ROUNDINGS * _U32 * sc.sig + sc.coef + sc.gam + sc.phi
    return Rule(p32, p64, tol)


def mxu_hold(variant: str, prec: int, inp: MxuInputs, got: torch.Tensor,
             rule: Rule | None = None) -> Hold:
    """Holds kernel output ``got`` of ``variant`` at ``prec`` to
    :func:`mxu_rule` (``rule``: that rule, already computed)."""
    if rule is None:
        rule = mxu_rule(variant, prec, inp)
    k = got[..., :6].double()
    e_k = (k - rule.p64).abs()
    over = ~(e_k <= rule.tol)
    return Hold(ok=bool(torch.isfinite(k).all()) and not bool(over.any()),
                n_over=int(over.sum()), err=float(e_k.max()),
                scale_rel=common.scale_rel(rule.p32, got[..., :6]))


def mxu_cuda(variant: str, prec: int, inp: MxuInputs,
             fault: str | None = None) -> torch.Tensor:
    """Instance (``variant``, ``prec`` TF32 passes) on the card; ``fault``
    (a key of :data:`FAULTS`) launches a planted control instead, which
    adds no launch to the count."""
    dev = inp.rows.device
    rows_n = rows_of(variant)
    t = inp.rows.shape[0]
    common.check("win", inp.win, torch.float32, (W_ROWS, N_WF, LANES), dev)
    common.check("flat", inp.flat, torch.int32, (t, MAXC), dev)
    common.check("fcnt", inp.fcnt, torch.int32, (t, 1), dev)
    common.check("rows", inp.rows, torch.float32, (t, rows_n, N_WF), dev)
    out = torch.empty((t, rows_n, 8), dtype=torch.float32, device=dev)
    fn = cuda_build.probe_function(SOURCE, "probe_mxu")
    err = fn(MODES[mode_of(variant)], prec, common.ptr(inp.win),
             common.ptr(inp.flat), common.ptr(inp.fcnt),
             common.ptr(inp.rows), common.ptr(out), t, rows_n,
             FAULTS[fault] if fault else 0, common.stream(dev))
    common.raise_on_error(f"mxu {variant} {prec}xTF32", err)
    if not fault:
        common.count(kernel_name(variant, prec))
    return out


def mxu(variant: str, prec: int, inp: MxuInputs) -> torch.Tensor:
    """The instance's kernel for CUDA tensors; for CPU ones its plain
    version (1×TF32: the rounding one)."""
    if inp.rows.is_cuda:
        return mxu_cuda(variant, prec, inp)
    return mxu_plain(variant, inp, prec == 1 and mode_of(variant) != "D")


def member_pairs(variant: str, inp: MxuInputs) -> tuple[int, int]:
    """(pairs whose gate passes, candidate evaluations) of ``variant``'s
    walk: the work the sums need, and the dense work the products do."""
    rows_n = rows_of(variant)
    t = inp.rows.shape[0]
    width = int(inp.fcnt.max())
    step = max(1, PLAIN_ELEMS // (rows_n * width * LANES))
    pairs = evals = 0
    for t0 in range(0, t, step):
        sl = slice(t0, min(t0 + step, t))
        e, valid = _chunk_lists(inp, sl)
        pairs += int(_gate(inp.win[e], valid, inp.rows[sl]).sum())
        evals += int(valid.sum()) * rows_n * LANES
    return pairs, evals


def mxu_bound(variant: str, prec: int, inp: MxuInputs, pairs: int,
              evals: int) -> tuple[float, str]:
    """The inputs and the output once; the member pairs' FP32 work; and for
    the product instances the dense TF32 products they compute (the
    accumulates: 2 products × 4 columns × a multiply-add per candidate
    evaluation; the Gram term: 3 coordinates × a multiply-add), times the
    passes."""
    nbytes = sum(x.numel() * x.element_size() for x in inp) \
        + inp.rows.numel() * 4
    mode = mode_of(variant)
    tf32_ops = 0.0
    if mode in "AM":
        tf32_ops += evals * 2 * 4 * 2
    if mode in "GM":
        tf32_ops += evals * 3 * 2
    return common.bound(nbytes, pairs * common.FORCE_PAIR_OPS,
                        tf32_ops * prec)


def _bmm_ms(inp: MxuInputs, device, tf32: bool) -> float | None:
    """``torch.bmm`` of pc f32[T, rows, K·128] @ [xⱼ yⱼ zⱼ 1] f32[T, K·128,
    4], the accumulate product of a whole pass, with TF32 on or off."""
    if device.type != "cuda":
        return None
    t, rows_n = inp.rows.shape[0], inp.rows.shape[1]
    k = int(inp.fcnt.max()) * LANES
    g = torch.Generator(device=device).manual_seed(0)
    pc = torch.rand((t, rows_n, k), device=device, generator=g)
    xj = torch.rand((t, k, 4), device=device, generator=g)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return common.time_ms(lambda: torch.bmm(pc, xj), device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def divergence(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float,
                                                            float]:
    """The script's table entry of b against a: max abs, max rel where
    |a| > 1e-6, scale-rel."""
    oa, ob = a[..., :6].double(), b[..., :6].double()
    diff = (oa - ob).abs()
    rel = diff / oa.abs().clamp(min=1e-12)
    rel = torch.where(oa.abs() > 1e-6, rel, 0.0)
    return float(diff.max()), float(rel.max()), \
        float(diff.max() / max(float(oa.abs().max()), 1e-300))


def run(device=None, n_part: int = N_PART) -> dict:
    """Every instance against its plain version, timed, with its ns per
    chunk, its bound, the divergence table of each precision, and the
    accumulate product through ``torch.bmm``; on the card the planted
    controls, each of which must fail the rule (``controls``: the lanes
    over it). Prints its lines and returns the kernels' numbers."""
    dev = common.resolve(device)
    ident = common.identity(dev)
    inputs = script_inputs(dev, n_part)
    lib = {tf: {n: _bmm_ms(inputs[n], dev, tf) for n in (64, 128)}
           for tf in (True, False)}
    common.reset_peak_memory(dev)     # the kernels' and plain versions' peak
    for n in (64, 128):
        t = inputs[n].rows.shape[0]
        print(f"library: torch.bmm pc[{t}, {n}, "
              f"{int(inputs[n].fcnt.max()) * LANES}] @ [x y z 1] (the "
              f"accumulate product of a pass): TF32 on "
              f"{common.fmt_ms(lib[True][n])}, off "
              f"{common.fmt_ms(lib[False][n])} [{ident}]", flush=True)
    kernels, outs, controls, ok_all = {}, {}, {}, True
    for variant, prec in instances():
        inp = inputs[rows_of(variant)]
        got = mxu(variant, prec, inp)
        outs[(variant, prec)] = got
        rule = mxu_rule(variant, prec, inp)
        hold = mxu_hold(variant, prec, inp, got, rule)
        ok_all &= hold.ok
        faults = CONTROLS.get((variant, prec), ()) \
            if dev.type == "cuda" else ()
        for fault in faults:
            bad = mxu_hold(variant, prec, inp,
                           mxu_cuda(variant, prec, inp, fault), rule)
            controls[f"{variant} {prec}xTF32, {fault}"] = bad.n_over
            print(f"planted control {variant} {prec}xTF32, {fault}: "
                  f"{'fails as it must' if not bad.ok else 'PASSES'} "
                  f"({bad.n_over} lanes over the rule) [{ident}]",
                  flush=True)
        name = kernel_name(variant, prec)
        ms = common.time_ms(lambda: mxu(variant, prec, inp), dev)
        plain_ms = common.time_ms(
            lambda: mxu_plain(variant, inp, prec == 1 and variant[0] != "D"),
            dev, reps=1)
        pairs, evals = member_pairs(variant, inp)
        b = mxu_bound(variant, prec, inp, pairs, evals)
        tiles = inp.rows.shape[0]
        chunks = tiles * n_chunks(rows_of(variant))
        per = "" if ms is None else \
            f" ({ms * 1e6 / chunks:.1f} ns/chunk, rows={rows_of(variant)})"
        lib_ms = None if variant[0] in "DG" else \
            lib[prec == 1][rows_of(variant)]
        print(f"variant {variant:5s} {prec}xTF32: "
              f"{'OK' if hold.ok else 'MISMATCH'} ({hold.n_over} lanes over "
              f"the rule, scale-rel {hold.scale_rel:.3e}); kernel "
              f"{common.fmt_ms(ms)}{per}; plain {common.fmt_ms(plain_ms)}; "
              f"bound {b[0]:.5f} ms ({b[1]}, {pairs} member pairs) "
              f"[{ident}]", flush=True)
        kernels[name] = common.kernel_record(
            "mxu.cu", REPLACES, ms, plain_ms, b, hold.err, hold.ok,
            library_ms=lib_ms,
            library=("none: no PyTorch call computes the gated pair sums"
                     if lib_ms is None and variant[0] in "DG" else
                     f"torch.bmm of the accumulate product alone, TF32 "
                     f"{'on' if prec == 1 else 'off'}"),
            pair_steps=evals)
    table = {}
    for prec in (1, 3):
        for a, b in PAIRS:
            pa = 1 if a[0] == "D" else prec
            mx, rel, srel = divergence(outs[(a, pa)], outs[(b, prec)])
            table[f"{a} vs {b} {prec}xTF32"] = (mx, rel, srel)
            print(f"{a} vs {b} ({prec}xTF32): max abs diff {mx:.3e}  max "
                  f"rel (|ref|>1e-6) {rel:.3e}  scale-rel {srel:.3e} "
                  f"[{ident}]", flush=True)
    common.print_peak_memory("mxu", dev, ident)
    # a control that passes its rule leaves the rule unproven
    ok_all &= all(n > 0 for n in controls.values())
    return {"ok": ok_all, "kernels": kernels, "divergence": table,
            "controls": controls,
            "library_ms": {f"{n}_tf32_{'on' if tf else 'off'}": lib[tf][n]
                           for tf in (True, False) for n in (64, 128)}}
