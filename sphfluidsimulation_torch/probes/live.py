"""Device liveness probe: does a freshly built kernel launch and answer?

Counterpart of the TPU liveness probes ``bench.py:95`` (``_PROBE_PALLAS``,
run in a child process by ``_probe``, :101-120) and
``scripts/probe_compact_tpu.py:119`` (``wait_tpu``): o = x + c on
f32[8, 128], with c taken from the clock, so no cached result answers for a
card that does not run. ``probe_device`` builds and launches it in a child
process it can kill, so a hung card costs the caller its budget and no
more; on a host without a card it answers ``(False, reason)``, which is
what a liveness probe is for. Nothing on the simulator's path calls it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..ops import cuda_build
from . import common

SOURCE = "probes/live.cu"
REPLACES = "bench.py:95; scripts/probe_compact_tpu.py:119"
ROOT = Path(__file__).resolve().parents[2]
SHAPE = (8, 128)


def clock_constant() -> float:
    """The cache-busting constant of the TPU probes: seconds mod 100000."""
    return float(int(time.time()) % 100000)


def live_plain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x + c[0]."""
    return x + c[0]


def live_cuda(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The kernel (``csrc/probes/live.cu``) on the card."""
    dev = x.device
    common.check("x", x, torch.float32, tuple(x.shape), dev)
    common.check("c", c, torch.float32, (1,), dev)
    out = torch.empty_like(x)
    fn = cuda_build.probe_function(SOURCE, "probe_live")
    err = fn(common.ptr(x), common.ptr(c), common.ptr(out), x.numel(),
             common.stream(dev))
    common.raise_on_error("live", err)
    common.count("live")
    return out


def live(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    return live_cuda(x, c) if x.is_cuda else live_plain(x, c)


def _child() -> None:
    """The child process of :func:`probe_device`: build, launch, check the
    sum exactly, print "up"."""
    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        os._exit(3)
    c = clock_constant()
    dev = torch.device("cuda")
    out = live_cuda(torch.ones(SHAPE, device=dev),
                    torch.tensor([c], device=dev))
    y = float(out.double().sum())
    if y != (1.0 + c) * SHAPE[0] * SHAPE[1]:
        print(f"wrong sum {y}", flush=True)
        os._exit(4)
    print("up", flush=True)
    os._exit(0)


def probe_device(budget_s: float = 300.0) -> tuple[bool, str]:
    """(ok, why): whether a fresh build and launch of the probe kernel
    answers the right sum within ``budget_s`` seconds, run in a child
    process that is killed when the budget runs out."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "from sphfluidsimulation_torch.probes.live import _child; "
            "_child()")
    try:
        r = subprocess.run([sys.executable, "-c", code],
                           timeout=max(5.0, budget_s), capture_output=True,
                           text=True)
    except subprocess.TimeoutExpired:
        return False, "probe subprocess timed out"
    if r.returncode == 0 and "up" in r.stdout:
        return True, "ok"
    tail = (r.stdout + r.stderr).strip()[-200:]
    return False, f"rc={r.returncode}: {tail}"


def run(device=None) -> dict:
    """The probe: the kernel against its plain version and the exact sum,
    timed; on the card also :func:`probe_device`. Prints its lines and
    returns the kernel's numbers."""
    dev = common.resolve(device)
    ident = common.identity(dev)
    c_val = clock_constant()
    x = torch.ones(SHAPE, device=dev)
    c = torch.tensor([c_val], device=dev)
    out = live(x, c)
    want = live_plain(x, c)
    exact = float(out.double().sum()) == (1.0 + c_val) * x.numel()
    ok = exact and bool((out == want).all())
    ms = common.time_ms(lambda: live(x, c), dev)
    plain_ms = common.time_ms(lambda: live_plain(x, c), dev, reps=1)
    # one PyTorch call computes the same function: torch.add
    lib_ms = common.time_ms(lambda: torch.add(x, c), dev)
    b = common.bound(2 * x.numel() * 4 + 4)
    print(f"live: {'OK' if ok else 'MISMATCH'} (c = {c_val:.0f}, sum "
          f"{float(out.double().sum()):.0f}); kernel {common.fmt_ms(ms)}, "
          f"plain {common.fmt_ms(plain_ms)}, torch.add "
          f"{common.fmt_ms(lib_ms)}, bound {b[0]:.7f} ms [{ident}]",
          flush=True)
    result = {"ok": ok, "kernels": {"live": common.kernel_record(
        "live.cu", REPLACES, ms, plain_ms, b, common.max_abs(want, out), ok,
        library_ms=lib_ms, library="torch.add(x, c)")}}
    if dev.type == "cuda":
        t0 = time.perf_counter()
        up, why = probe_device()
        print(f"probe_device: {up} ({why}), {time.perf_counter() - t0:.1f} s "
              f"in a child process [{ident}]", flush=True)
        result["probe_device"] = [up, why]
        result["ok"] = result["ok"] and up
    return result
