"""Structured step-metrics logging (JSONL).

Counterpart of ``sphfluidsimulation_tpu/utils/metrics.py::MetricsLogger``,
with the same record keys. The reference's only observability is the
speed-based particle colouring and the NaN alpha marker (SURVEY.md §5). Here
every frame's ``StepMetrics`` can be appended to a JSONL stream, with
wall-clock and throughput bookkeeping. Reading a metric off the card waits
for it: the logger is for the CLI's frame loop, not for timing.
"""

from __future__ import annotations

import json
import os
import time

from ..state import StepMetrics


class MetricsLogger:
    def __init__(self, path: str | None = None, *, n_particles: int = 0,
                 substeps: int = 5):
        self.path = path
        self.n_particles = n_particles
        self.substeps = substeps
        self._t0 = time.time()
        self._last = self._t0
        self.history: list[dict] = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            # truncate on open
            open(path, "w").close()

    def log(self, frame: int, m: StepMetrics, **extra) -> dict:
        now = time.time()
        dt = now - self._last
        self._last = now
        rec = {
            "frame": int(frame),
            "t": round(now - self._t0, 6),
            "frame_wall_s": round(dt, 6),
            "particle_substeps_per_s": (
                self.n_particles * self.substeps / dt if dt > 0 else None),
            "max_speed": float(m.max_speed),
            "mean_density": float(m.mean_density),
            "kinetic_energy": float(m.kinetic_energy),
            "nan_events": int(m.nan_events),
            "overflow": int(m.overflow),
            "exact_cert": int(m.exact_cert),
            **extra,
        }
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec
