"""Per-tile scalar prologue probe: what does deriving a tile's walk inside
the kernel cost (9 table lookups, a worklist of at most 16 entries, a walk
addressed by it) beside a vector payload that costs almost nothing?

Counterpart of ``scripts/probe_scalar_tpu.py`` (``build``'s pallas_call,
:99), variants S0-S3 over 256 groups of 16 tiles of f32[8, 128], with the
script's inputs (:func:`synth_inputs`): a sorted slice i32[2048], spans
i32[4096, 2] (hi = lo + 3) and the payload. S0 scales the payload; S1 adds
the 9 clamped lookups a tile; S2 the worklist build; S3 the walk that
reads the payload through the worklist. The question bears on K5's
host-side span derivation (``ops/compact.py``). The kernel
(``csrc/probes/scalar.cu``) keeps the slice in shared memory, one warp a
tile; the probe prints ns per tile, each timed launch reading a payload
copy that is not in L2 and writing a fresh output, as the bound counts
them (the payload, 16.8 MB, would otherwise stay in the card's L2).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..ops import cuda_build
from . import common

SOURCE = "probes/scalar.cu"
REPLACES = "scripts/probe_scalar_tpu.py:99"
LANES = 128
TPG = 16
GROUPS = 256
MAXC = 16
S_SLICE = 2048
VARIANTS = (0, 1, 2, 3)


def synth_inputs(groups: int = GROUPS) -> tuple[np.ndarray, ...]:
    """The script's inputs (its main(), RandomState(0)): (slice, spans,
    x)."""
    rng = np.random.RandomState(0)
    slc = np.sort(rng.randint(0, 1 << 14, S_SLICE)).astype(np.int32)
    spans = rng.randint(0, S_SLICE - 100, (groups * TPG, 2)).astype(np.int32)
    spans[:, 1] = spans[:, 0] + 3
    x = rng.rand(groups * TPG, 8, LANES).astype(np.float32)
    return slc, spans, x


def scalar_plain(variant: int, slc: torch.Tensor, spans: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """The script kernel's output f32[T, 8, 128] in plain PyTorch, every
    tile at once: the lookups, the worklist and the walk as index
    arithmetic."""
    acc = x * 1.000001
    if variant == 0:
        return acc
    t = x.shape[0]
    dev = x.device
    lo, hi = spans[:, 0].long(), spans[:, 1].long()
    prev_b = torch.zeros(t, dtype=torch.int64, device=dev)
    k0s, k1s = [], []
    for line in range(9):
        a = slc[(lo + line * 7).clamp(0, S_SLICE - 1)].long()
        b = slc[(hi + line * 7 + 2).clamp(0, S_SLICE - 1)].long()
        a = torch.maximum(a, prev_b)
        b = torch.maximum(b, a)
        prev_b = b
        k0 = torch.div(a, LANES, rounding_mode="trunc")
        k1 = torch.minimum(torch.div(b + LANES - 1, LANES,
                                     rounding_mode="trunc"), k0 + 2)
        k0s.append(k0)
        k1s.append(k1)
    cnt = torch.zeros(t, dtype=torch.int64, device=dev)
    wl = torch.zeros((t, MAXC), dtype=torch.int64, device=dev)
    if variant >= 2:
        rows = torch.arange(t, device=dev)
        for k0, k1 in zip(k0s, k1s):
            n_line = torch.minimum(k1 - k0, torch.full_like(k0, 2))
            for i in range(2):
                use = i < n_line
                wl[rows[use], cnt[use].clamp(max=MAXC - 1)] = k0[use] + i
                cnt = cnt + use.long()
    if variant >= 3:
        group = torch.arange(t, device=dev) // TPG
        for it in range(MAXC):
            use = it < cnt.clamp(max=MAXC)
            e = wl[:, it]
            blk = x[group * TPG + torch.remainder(e, TPG)]
            acc = torch.where(use[:, None, None], acc + blk * 1e-30, acc)
        return acc
    acc = acc + k0s[0].float()[:, None, None] * 1e-30
    if variant >= 2:
        acc = acc + cnt.float()[:, None, None] * 1e-30
    return acc


def scalar_cuda(variant: int, slc: torch.Tensor, spans: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Variant S``variant``'s kernel instance on the card."""
    dev = x.device
    t = x.shape[0]
    common.check("slice", slc, torch.int32, (S_SLICE,), dev)
    common.check("spans", spans, torch.int32, (t, 2), dev)
    common.check("x", x, torch.float32, (t, 8, LANES), dev)
    out = torch.empty_like(x)
    fn = cuda_build.probe_function(SOURCE, "probe_scalar")
    err = fn(variant, common.ptr(slc), common.ptr(spans), common.ptr(x),
             common.ptr(out), t, common.stream(dev))
    common.raise_on_error(f"scalar S{variant}", err)
    common.count(f"scalar_S{variant}")
    return out


def scalar(variant: int, slc, spans, x) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if x.is_cuda:
        return scalar_cuda(variant, slc, spans, x)
    return scalar_plain(variant, slc, spans, x)


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between a and b in float32 units in the last
    place (both finite and of one sign here)."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max())


def run(device=None, groups: int = GROUPS) -> dict:
    """S0-S3, each kernel within 1 ulp of its plain version, timed, in ns
    per tile as the script prints them."""
    dev = common.resolve(device)
    ident = common.identity(dev)
    slc, spans, x = (torch.from_numpy(a).to(dev)
                     for a in synth_inputs(groups))
    t = x.shape[0]
    kernels, ok_all = {}, True
    for v in VARIANTS:
        got = scalar(v, slc, spans, x)
        want = scalar_plain(v, slc, spans, x)
        d = ulps(want, got)
        ok = d <= 1
        ok_all &= ok
        ms = None
        if dev.type == "cuda":
            copies = itertools.cycle(common.past_l2(x, 2 * x.numel() * 4))
            kept = []       # each launch's output stays a fresh buffer
            ms = common.time_ms(
                lambda: kept.append(scalar(v, slc, spans, next(copies))),
                dev)
            del kept
        plain_ms = common.time_ms(lambda: scalar_plain(v, slc, spans, x),
                                  dev, reps=1)
        # the payload read and written, the slice, the spans
        b = common.bound(2 * x.numel() * 4 + S_SLICE * 4 + spans.numel() * 4,
                         x.numel())
        per = "" if ms is None else f" ({ms * 1e6 / t:.1f} ns/tile)"
        print(f"S{v}: {'OK' if ok else 'MISMATCH'} ({d} ulp); kernel "
              f"{common.fmt_ms(ms)}{per}; plain {common.fmt_ms(plain_ms)}; "
              f"bound {b[0]:.5f} ms ({b[1]}) [{ident}]", flush=True)
        kernels[f"scalar_S{v}"] = common.kernel_record(
            "scalar.cu", REPLACES, ms, plain_ms, b,
            common.max_abs(want, got), ok,
            library="none: the lookups and the worklist are not one "
            "PyTorch call")
    return {"ok": ok_all, "kernels": kernels}
