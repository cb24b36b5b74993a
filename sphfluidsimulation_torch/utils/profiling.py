"""Profiling helpers: device synchronisation, CUDA-event timing, identity,
profiler ranges.

Counterpart of ``sphfluidsimulation_tpu/utils/profiling.py::device_sync``.
PyTorch returns before the card finishes, so host-clock timing must end in
``device_sync``; a kernel's own time comes from CUDA events
(:class:`CudaTimer`), a phase's from the profiler ranges that :func:`span`
opens. The JAX module's ``trace`` and ``ThroughputTimer`` have no
counterpart: the port's CLI times frames through ``utils.metrics``.
"""

from __future__ import annotations

import contextlib
import subprocess

import torch
import torch.autograd.profiler as _autograd_profiler


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler runs, and
    a no-op otherwise: an open ``record_function`` costs a dispatcher call
    even with no profiler, which the frame loop should not pay."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def device_sync(device: torch.device | str | None = None) -> None:
    """Wait for all queued work on the card (no-op without CUDA)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


def gpu_identity() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (one line per card). Every measurement is stated beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


class CudaTimer:
    """Times the work queued inside the block with CUDA events.

    ``ms`` is the elapsed device time of the whole block, read after the
    block exits (the exit synchronises on the end event). ``lead_cycles``
    > 0 first keeps the card busy that many clock cycles, before the start
    event, so that the host queues the block while the card waits: the
    time is then the card's alone, with no gap where a kernel is shorter
    than the host's launch work.
    """

    def __init__(self, lead_cycles: int = 0):
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._lead = lead_cycles
        self.ms: float | None = None

    def __enter__(self):
        if self._lead:
            torch.cuda._sleep(self._lead)
        self._start.record()
        return self

    def __exit__(self, *exc):
        self._end.record()
        self._end.synchronize()
        self.ms = self._start.elapsed_time(self._end)
