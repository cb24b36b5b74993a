"""Integer-op probes: are the int ops of the packed-key membership test right
on the card, bit for bit?

Counterpart of ``scripts/probe_intops_tpu.py`` (its run()'s pallas_call,
:43: stages t1-t4) and ``scripts/probe_intcell_fix_tpu.py`` (:41: stages
a-f). The scripts asked which primitive a compiler got wrong: the f32↔i32
bitcast, arithmetic shifts and masks, the truncating f32→i32 convert of
negatives, shifts on a (64, 1) column (the row-key build), the (64, 1) +
(1, 128) broadcast of the membership digit test, and whether multiplies
fix the row key. Each stage is a kernel instance of its own
(``csrc/probes/intops.cu``) and a plain PyTorch version, both held to the
scripts' own numpy truth exactly; the inputs are the scripts', from
``np.random.RandomState(0)`` in their order (:func:`stages`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda_build
from . import common

SOURCE = "probes/intops.cu"
BIAS = 1 + (1 << 10) + (1 << 20)
R_CELLS = 19


class Stage(NamedTuple):
    kname: str        # the launch counter's name
    label: str        # the script's name of the stage
    stage: int        # intops.cu's stage number
    replaces: str
    a: np.ndarray     # inputs, f32
    b: np.ndarray | None
    truth: np.ndarray  # the script's numpy truth, f32[rows, 128]


def _membership(enc: np.ndarray, rkey: np.ndarray) -> np.ndarray:
    tv = (enc[None, :].astype(np.int64)
          + rkey.reshape(-1, 1).astype(np.int64)).astype(np.int32)
    return ((enc[None, :] >= 0) & ((tv & 1023) <= 2)
            & (((tv >> 10) & 1023) <= 2)
            & (((tv >> 20) & 1023) <= 2)).astype(np.float32)


def _cells(rng: np.random.RandomState) -> tuple[np.ndarray, np.ndarray]:
    """The scripts' candidates: 128 cells of R = 19 and their keys, about a
    fifth of them the dropped-slot sentinel -1."""
    cell = rng.randint(0, R_CELLS, (128, 3)).astype(np.int32)
    enc = cell[:, 0] + (cell[:, 1] << 10) + (cell[:, 2] << 20)
    enc[rng.rand(128) < 0.2] = -1
    return cell, enc.astype(np.int32)


def _t4_draws() -> tuple[np.random.RandomState, list[np.ndarray]]:
    """probe_intops_tpu.py's generator and its draws up to stage t4."""
    rng = np.random.RandomState(0)
    draws = [rng.randint(-(1 << 28), 1 << 28, (8, 128)).astype(np.int32),
             (rng.uniform(-3, 3, (8, 128)) * 10).astype(np.float32),
             rng.randint(-2, 259, (64, 3)).astype(np.float32)]
    return rng, draws


def digit_test_matches_per_axis() -> bool:
    """The script's truth cross-check: stage t4's digit test equals the
    per-axis test (occupied, and within 1 of the row's cell on each
    axis)."""
    rng, _ = _t4_draws()
    cell, enc = _cells(rng)
    rcell = rng.randint(-2, R_CELLS + 2, (64, 3)).astype(np.int32)
    rkey = (BIAS - (rcell[:, 0] + (rcell[:, 1] << 10)
                    + (rcell[:, 2] << 20))).astype(np.int32)
    near = (np.abs(cell[None, :, :] - rcell[:, None, :]) <= 1).all(-1)
    ref = ((enc[None, :] >= 0) & near).astype(np.float32)
    return bool((_membership(enc, rkey) == ref).all())


def stages() -> list[Stage]:
    """The ten stages with the scripts' inputs and truths."""
    out = []
    p1 = "scripts/probe_intops_tpu.py:43"
    rng, (enc_i, xs, rc) = _t4_draws()
    out.append(Stage("intops_t1", "bitcast_shift_mask_8x128", 1, p1,
                     enc_i.view(np.float32), None,
                     ((enc_i >> 10) & 1023).astype(np.float32)))
    out.append(Stage("intops_t2", "trunc_convert_8x128", 2, p1, xs, None,
                     xs.astype(np.int32).astype(np.float32)))
    ic = rc.astype(np.int32)
    t3 = np.broadcast_to(
        (ic[:, 0:1] + (ic[:, 1:2] << 10) + (ic[:, 2:3] << 20))
        .astype(np.float32), (64, 128)).copy()
    out.append(Stage("intops_t3", "rowkey_shifts_64x1", 3, p1, rc, None, t3))
    _, enc = _cells(rng)
    rcell = rng.randint(-2, R_CELLS + 2, (64, 3)).astype(np.int32)
    rkey = (BIAS - (rcell[:, 0] + (rcell[:, 1] << 10)
                    + (rcell[:, 2] << 20))).astype(np.int32)
    out.append(Stage("intops_t4", "membership_bcast_64x128", 4, p1,
                     enc.view(np.float32), rkey.view(np.float32),
                     _membership(enc, rkey)))

    p2 = "scripts/probe_intcell_fix_tpu.py:41"
    rng = np.random.RandomState(0)
    rc = rng.randint(-2, 259, (64, 3)).astype(np.float32)
    ic = rc.astype(np.int32)

    def bcast(col):
        return np.broadcast_to(col.astype(np.float32), (64, 128)).copy()

    tb = bcast(ic[:, 1:2] << 10)
    tkey = (ic[:, 0:1].astype(np.int64) + (ic[:, 1:2].astype(np.int64) << 10)
            + (ic[:, 2:3].astype(np.int64) << 20)).astype(np.int32)
    for kname, label, stage, truth in (
            ("intcell_a", "a_convert_64x1", 5, bcast(ic[:, 0:1])),
            ("intcell_b", "b_shift_64x1", 6, tb),
            ("intcell_c", "c_mul_64x1", 7, tb),
            ("intcell_d", "d_bcast_then_shift", 8, bcast(tkey)),
            ("intcell_e", "e_rowkey_mul_64x1", 9, bcast(tkey))):
        out.append(Stage(kname, label, stage, p2, rc, None, truth))
    _, enc = _cells(rng)
    rcell = rng.randint(-2, R_CELLS + 2, (64, 3)).astype(np.float32)
    ri = rcell.astype(np.int32)
    rkey = (BIAS - (ri[:, 0:1] + (ri[:, 1:2] << 10)
                    + (ri[:, 2:3] << 20))).astype(np.int32)
    out.append(Stage("intcell_f", "f_membership_mulkey", 10, p2,
                     enc.view(np.float32), rcell, _membership(enc, rkey)))
    return out


def _digits_within_2(vj: torch.Tensor, rk: torch.Tensor) -> torch.Tensor:
    t = vj + rk
    return ((vj >= 0) & ((t & 1023) <= 2) & (((t >> 10) & 1023) <= 2)
            & (((t >> 20) & 1023) <= 2)).float()


def stage_plain(stage: int, a: torch.Tensor, b: torch.Tensor | None,
                shift: int = 10) -> torch.Tensor:
    """Stage ``stage`` (1-10, as ``intops.cu`` numbers them) in plain
    PyTorch int32 arithmetic: f32[rows, 128]."""
    def cols(x):
        i = x.to(torch.int32)           # truncates toward zero
        return i[:, 0:1], i[:, 1:2], i[:, 2:3]

    def bcast(col):
        return col.float().expand(-1, 128).contiguous()

    if stage == 1:
        return ((a.view(torch.int32) >> 10) & 1023).float()
    if stage == 2:
        return a.to(torch.int32).float()
    if stage == 4:
        return _digits_within_2(a.view(torch.int32)[None, :],
                                b.view(torch.int32)[:, None])
    if stage == 10:
        ix, iy, iz = cols(b)
        rk = BIAS - (ix + iy * (1 << 10) + iz * (1 << 20))
        return _digits_within_2(a.view(torch.int32)[None, :], rk)
    ix, iy, iz = cols(a)
    if stage == 3:
        return bcast(ix + (iy << shift) + (iz << (2 * shift)))
    if stage == 5:
        return bcast(ix)
    if stage == 6:
        return bcast(iy << 10)
    if stage == 7:
        return bcast(iy * 1024)
    if stage == 8:
        return bcast(ix + (iy << 10) + (iz << 20))
    if stage == 9:
        return bcast(ix + iy * (1 << 10) + iz * (1 << 20))
    raise ValueError(f"no intops stage {stage}")


def rows_of(stage: int) -> int:
    return 8 if stage in (1, 2) else 64


def stage_cuda(stage: int, a: torch.Tensor, b: torch.Tensor | None,
               shift: int = 10, kname: str | None = None) -> torch.Tensor:
    """Stage ``stage``'s kernel instance on the card; ``kname`` is its
    launch counter."""
    dev = a.device
    common.check("a", a, torch.float32, tuple(a.shape), dev)
    if b is not None:
        common.check("b", b, torch.float32, tuple(b.shape), dev)
    out = torch.empty((rows_of(stage), 128), dtype=torch.float32,
                      device=dev)
    fn = cuda_build.probe_function(SOURCE, "probe_intops")
    err = fn(stage, common.ptr(a), common.ptr(a if b is None else b),
             common.ptr(out), rows_of(stage), shift, common.stream(dev))
    common.raise_on_error(f"intops stage {stage}", err)
    common.count(kname or f"intops_stage{stage}")
    return out


def stage_run(st: Stage, a: torch.Tensor, b: torch.Tensor | None,
              shift: int = 10) -> torch.Tensor:
    """The stage's kernel for CUDA tensors, its plain version for CPU
    ones."""
    if a.is_cuda:
        return stage_cuda(st.stage, a, b, shift, st.kname)
    return stage_plain(st.stage, a, b, shift)


def inputs_on(st: Stage, dev: torch.device):
    a = torch.from_numpy(st.a.copy()).to(dev)
    b = None if st.b is None else torch.from_numpy(st.b.copy()).to(dev)
    return a, b


def run(device=None) -> dict:
    """Every stage, kernel and plain version, against the scripts' truth,
    as the scripts print them; each kernel timed."""
    dev = common.resolve(device)
    ident = common.identity(dev)
    kernels, ok_all = {}, True
    for st in stages():
        a, b = inputs_on(st, dev)
        truth = torch.from_numpy(st.truth).to(dev)
        got = stage_run(st, a, b)
        plain = stage_plain(st.stage, a, b)
        bad = int((got != truth).sum())
        ok = bad == 0 and bool((plain == truth).all())
        ok_all &= ok
        ms = common.time_ms(lambda: stage_run(st, a, b), dev)
        plain_ms = common.time_ms(lambda: stage_plain(st.stage, a, b), dev,
                                  reps=1)
        nbytes = (st.a.nbytes + (0 if st.b is None else st.b.nbytes)
                  + st.truth.nbytes)
        bnd = common.bound(nbytes)
        print(f"{st.label}: {'OK' if ok else 'MISMATCH'} ({bad} bad); "
              f"kernel {common.fmt_ms(ms)}, plain "
              f"{common.fmt_ms(plain_ms)}, bound {bnd[0]:.6f} ms [{ident}]",
              flush=True)
        kernels[st.kname] = common.kernel_record(
            "intops.cu", st.replaces, ms, plain_ms, bnd,
            common.max_abs(truth, got), ok, library="none: several int "
            "ops, no one PyTorch call")
    print("digit-test == per-axis truth:", digit_test_matches_per_axis(),
          flush=True)
    return {"ok": ok_all, "kernels": kernels}

