"""What the probes share: the device rule, the card's identity, kernel
timing, bounds, the stream argument of the C calls, and the launch
counts.

No JAX counterpart (each TPU script carried its own timing loop).
"""

from __future__ import annotations

import ctypes
import math

import torch

# the kernels' argument checks and C-call helpers, shared with K1-K5's
# wrappers
from ..ops.sph_kernels import (_check as check, _ptr as ptr,  # noqa: F401
                               _raise_on_error as raise_on_error)
from ..utils.profiling import CudaTimer, gpu_identity

# The bound of a probe kernel: the larger of its bytes over the memory rate,
# its FP32 operations over the FP32 rate outside the tensor cores and its
# dense TF32 tensor-core operations over their rate (NVIDIA H100 SXM,
# dense, NVIDIA's H100 datasheet), counted as chip_smoke.py counts the
# kernels': a multiply-add 2, a square root or a division 1, each input
# byte read once and each output byte written once, and data-dependent work
# as these inputs need it.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# the card spins this many cycles (about 25 ms) before each timed block,
# while the host queues it, so that kernel times are device times
LEAD_CYCLES = 50_000_000
# timed launches of each kernel (the plain versions: one)
REPS = 20
# FP32 operations of one member pair of the force walk: chip_smoke.py's
# OPS_PER_PAIR["forces"] (3 differences, |r|² 5, √ 1, h − |r| 1, ∇W 3, the
# pressure coefficient 2 and its product 1, the pressure sum 6, the
# viscosity coefficient 1, vⱼ − vᵢ 3, the viscosity sum 6)
FORCE_PAIR_OPS = 32

# Kernel launches per probe wrapper (the probe kernel's name); a run resets
# them and reads them back to show which kernels its path went through.
launch_counts: dict[str, int] = {}


def reset_launch_counts() -> None:
    launch_counts.clear()


def count(name: str) -> None:
    launch_counts[name] = launch_counts.get(name, 0) + 1


def resolve(device: torch.device | str | None) -> torch.device:
    """The probes' device: None is the card; a CUDA device without a card
    raises (the probes run on the CPU only when the caller asks)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes run on the card "
                           "unless the caller asks for the CPU with "
                           "--device cpu")
    return dev


def identity(device: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), printed beside every
    number; on the CPU, that no device time was taken."""
    if device.type != "cuda":
        return "cpu: plain versions, device time not measured"
    return gpu_identity().splitlines()[0]


def time_ms(fn, device: torch.device, reps: int = REPS) -> float | None:
    """Device milliseconds of one call of ``fn`` (after one untimed call),
    with CUDA events, the card kept busy while the host queues the calls;
    None on the CPU (no device time there)."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    with CudaTimer(LEAD_CYCLES) as t:
        for _ in range(reps):
            fn()
    return t.ms / reps


def past_l2(x: torch.Tensor, call_bytes: int) -> list[torch.Tensor]:
    """``x`` and enough copies of it that a timed loop cycling through them,
    each call moving ``call_bytes``, moves twice the card's L2 between two
    reads of one copy: its reads come from device memory, as its bound
    counts them."""
    l2 = torch.cuda.get_device_properties(x.device).L2_cache_size
    return [x] + [x.clone() for _ in range(math.ceil(2 * l2 / call_bytes))]


def reset_peak_memory(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def print_peak_memory(name: str, device: torch.device, ident: str) -> None:
    """The peak device memory since :func:`reset_peak_memory` (the plain
    versions' blocks of tiles dominate it)."""
    if device.type == "cuda":
        gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
        print(f"{name}: peak device memory {gib:.3f} GiB [{ident}]",
              flush=True)


def bound(nbytes: float, fp32_ops: float = 0.0,
          tf32_ops: float = 0.0) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do the operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(fp32_ops / FP32_OPS_PER_S, tf32_ops / TF32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.5f} ms"


def scale_rel(ref: torch.Tensor, got: torch.Tensor) -> float:
    """max |got − ref| / max |ref| (0 where both are exactly equal), the
    scripts' "scale-rel"."""
    diff = float((got.double() - ref.double()).abs().max())
    if diff == 0.0:
        return 0.0
    return diff / max(float(ref.double().abs().max()), 1e-300)


def max_abs(ref: torch.Tensor, got: torch.Tensor) -> float:
    return float((got.double() - ref.double()).abs().max())


def stream(device: torch.device) -> ctypes.c_void_p:
    """The C calls' stream argument: PyTorch's current stream."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def kernel_record(source: str, replaces: str, ms, plain_ms, bound_ms_by,
                  err: float, ok: bool, library_ms=None, **extra) -> dict:
    """One probe kernel's numbers, as a run returns them (and chip_smoke.py
    prints them in its kernels line)."""
    b_ms, b_by = bound_ms_by
    return {"source": f"sphfluidsimulation_torch/csrc/probes/{source}",
            "replaces": replaces, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "ok": ok, "library_ms": library_ms, **extra}
