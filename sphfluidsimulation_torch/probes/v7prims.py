"""Primitives probe of the compact-lane kernel's design: a bulk copy of a
dynamic table slice into on-chip memory, a scalar read from it that picks a
dynamic row, and a lane roll by a runtime shift with a funnel merge.

Counterpart of ``scripts/probe_v7_prims.py`` (``main()``'s pallas_call,
:63). The kernel (``csrc/probes/v7prims.cu``) copies table[off : off +
16384] into shared memory with one ``cp.async.bulk`` completing on an
``mbarrier`` (the 1-D form of the Tensor Memory Accelerator), reads row =
slice[7] and sh = slice[11], and writes out f32[16, 128]: the rows x[row :
row + 8] rolled by sh along the lanes, then x[row + 8 : row + 16] rolled
and merged (lanes below sh from it, the rest from the first block). The
inputs are the script's: x f32[64, 128] from RandomState(0), off = 1024,
and its two tables (:func:`tables`). The bulk copy needs off to be a
multiple of 4 (16 bytes); the kernel answers NaN for an off that is not.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_build
from . import common

SOURCE = "probes/v7prims.cu"
REPLACES = "scripts/probe_v7_prims.py:63"
S_SLICE = 1 << 14
TABLE_LEN = 1 << 16
OFF = 1024


def tables() -> dict[str, np.ndarray]:
    """The script's tables: probe A's arange(65536) % 16 and probe B's
    constant 3 with table[1035] = 37 (so row = 3 and sh = 37)."""
    b = np.full(TABLE_LEN, 3, np.int32)
    b[OFF + 11] = 37
    return {"A": (np.arange(TABLE_LEN, dtype=np.int32) % 16), "B": b}


def x_input() -> np.ndarray:
    return np.random.RandomState(0).rand(64, 128).astype(np.float32)


def expected_b(x: np.ndarray) -> np.ndarray:
    """The script's probe-B expectations (np.roll)."""
    top = np.roll(x[3:11], 37, axis=1)
    lane = np.arange(128)[None, :]
    bot = np.where(lane < 37, np.roll(x[11:19], 37, axis=1), top)
    return np.concatenate([top, bot], 0)


def prims_plain(off: torch.Tensor, x: torch.Tensor,
                table: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32[16, 128]."""
    o = int(off[0])
    if o < 0 or o % 4 or o > table.shape[0] - S_SLICE:
        raise ValueError(f"off {o}: the bulk copy needs a multiple of 4 "
                         f"within the table")
    sl = table[o:o + S_SLICE]
    row, sh = int(sl[7]), int(sl[11])
    top = torch.roll(x[row:row + 8], sh, dims=1)
    lane = torch.arange(x.shape[1], device=x.device)[None, :]
    bot = torch.where(lane < sh, torch.roll(x[row + 8:row + 16], sh, dims=1),
                      top)
    return torch.cat([top, bot], 0)


def prims_cuda(off: torch.Tensor, x: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
    """The kernel on the card."""
    dev = x.device
    common.check("off", off, torch.int32, (1,), dev)
    common.check("x", x, torch.float32, (x.shape[0], 128), dev)
    common.check("table", table, torch.int32, (table.shape[0],), dev)
    out = torch.empty((16, 128), dtype=torch.float32, device=dev)
    fn = cuda_build.probe_function(SOURCE, "probe_v7prims")
    err = fn(common.ptr(off), common.ptr(x), common.ptr(table),
             common.ptr(out), x.shape[0], table.shape[0], common.stream(dev))
    common.raise_on_error("v7prims", err)
    common.count("v7prims")
    return out


def prims(off, x, table) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    return prims_cuda(off, x, table) if x.is_cuda else \
        prims_plain(off, x, table)


def run(device=None) -> dict:
    """Probes A and B as the script runs them: A's shape, B equal to the
    np.roll expectations exactly; each kernel output equal to its plain
    version; timed."""
    dev = common.resolve(device)
    ident = common.identity(dev)
    xn = x_input()
    x = torch.from_numpy(xn).to(dev)
    off = torch.tensor([OFF], dtype=torch.int32, device=dev)
    ok_all, err_all = True, 0.0
    outs = {}
    for name, tab in tables().items():
        table = torch.from_numpy(tab).to(dev)
        got = prims(off, x, table)
        want = prims_plain(off, x, table)
        ok = tuple(got.shape) == (16, 128) and bool((got == want).all())
        if name == "B":
            ok &= bool((got.cpu().numpy() == expected_b(xn)).all())
        ok_all &= ok
        err_all = max(err_all, common.max_abs(want, got))
        outs[name] = table
        what = ("shapes/compile" if name == "A" else
                "dynamic roll + funnel + bulk copy + scalar read")
        print(f"probe {name} ({what}): {'OK' if ok else 'MISMATCH'}",
              flush=True)
    table = outs["B"]
    ms = common.time_ms(lambda: prims(off, x, table), dev)
    plain_ms = common.time_ms(lambda: prims_plain(off, x, table), dev,
                              reps=1)
    # the slice, the two rows read, the output written, off
    b = common.bound(S_SLICE * 4 + 16 * 128 * 4 * 2 + 4)
    print(f"v7prims: kernel {common.fmt_ms(ms)}, plain "
          f"{common.fmt_ms(plain_ms)}, bound {b[0]:.6f} ms [{ident}]",
          flush=True)
    return {"ok": ok_all, "kernels": {"v7prims": common.kernel_record(
        "v7prims.cu", REPLACES, ms, plain_ms, b, err_all, ok_all,
        library="none: a bulk copy, scalar reads and two rolls are not one "
        "PyTorch call")}}
