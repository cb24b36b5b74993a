"""Throughput benchmark: particle-substeps/sec on the dam-break, on the card.

Counterpart of ``sphfluidsimulation_tpu/bench.py`` (``scaled_config``,
``run_bench``). Workload: the reference's canonical dam-break scene (preset 2
spawn, golden physics constants, SampleScene.unity:362-376) scaled to the
requested particle count, with the bucket resolution scaled like the golden
config (occupancy-preserving: R ∝ N^(1/3), golden 262144 → 47, 1048576 → 75).

Methodology: one warm-up rollout, then one timed rollout of ``frames``
frames; the host clock brackets the timed rollout with device
synchronisations. A measurement needs the card: without CUDA it raises.
"""

from __future__ import annotations

import time

import torch

from .config import SimConfig
from .sim.stepper import initial_state, make_rollout
from .utils.profiling import device_sync, gpu_identity

NORTH_STAR = 1e9  # particle-substeps/sec/chip @ 1M (BASELINE.json)


def scaled_config(n_particles: int) -> SimConfig:
    """Golden physics at a given N; R scales to preserve voxel occupancy."""
    base_r = 47
    r = max(3, round(base_r * (n_particles / 262144.0) ** (1.0 / 3.0)))
    return SimConfig(particle_number=n_particles, bucket_resolution=r)


def run_bench(n_particles: int = 1 << 20, frames: int = 20,
              warmup_frames: int = 5) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("run_bench measures the card; no CUDA device")
    device = torch.device("cuda")
    cfg = scaled_config(n_particles)
    state = initial_state(cfg, device)

    t0 = time.perf_counter()
    state, _ = make_rollout(cfg, warmup_frames, device=device)(state)
    device_sync()
    compile_s = time.perf_counter() - t0

    roll = make_rollout(cfg, frames, device=device)
    device_sync()
    t0 = time.perf_counter()
    final, m = roll(state)
    device_sync()
    elapsed = time.perf_counter() - t0

    rate = cfg.n_particles * cfg.substeps * frames / elapsed
    ident = gpu_identity().splitlines()[0].split(", ")
    return {
        "metric": "particle-substeps/sec/chip (dam-break, faithful mode)",
        "value": round(rate, 1),
        "unit": "particle-substeps/s",
        "vs_baseline": round(rate / NORTH_STAR, 4),
        "n_particles": cfg.n_particles,
        "bucket_resolution": cfg.bucket_resolution,
        "frames_timed": frames,
        "elapsed_s": round(elapsed, 3),
        # the kernel build happens at first use, inside the warm-up
        "compile_plus_warmup_s": round(compile_s, 1),
        "neighbor": "sorted",
        "pallas_tuning": None,
        "scan_unroll": False,
        "site_capacity": None,
        "site_bands": None,
        "host_loop": True,
        "exact_cert_total": int(m.exact_cert.sum()),
        "overflow_max": int(m.overflow.max()),
        "device": str(device),
        "device_name": torch.cuda.get_device_name(0),
        "power_limit": ident[1] if len(ident) > 1 else "not measured",
    }
