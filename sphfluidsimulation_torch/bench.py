"""Throughput benchmark: particle-substeps/sec on the dam-break, on the card.

Counterpart of ``sphfluidsimulation_tpu/bench.py`` (``scaled_config``,
``_site_bands``, ``run_bench``). Workload: the reference's canonical dam-break scene (preset 2
spawn, golden physics constants, SampleScene.unity:362-376) scaled to the
requested particle count, with the bucket resolution scaled like the golden
config (occupancy-preserving: R ∝ N^(1/3), golden 262144 → 47, 1048576 → 75).

Methodology, the JAX bench's (``sphfluidsimulation_tpu/bench.py:96-136``): a
warm-up rollout of ``warmup_frames`` frames; the rollout of ``frames``
frames run once untimed; then the same rollout timed, so the timed window is
frames [warmup + frames, warmup + 2·frames). The host clock brackets it with
device synchronisations. ``host_loop=False`` (the default, JAX's) times the
sorted tier's rollout as a replayed CUDA graph (``sim/graph.py``), whose
capture falls in the warm-up as JAX's compile does; ``host_loop=True`` times
the loop over frames on the host, which the other tiers need.
``steady_frames`` rolls deeper, ``frames`` at a time, and times one late
window (the dam-break's frame cost changes with the frame index). A
measurement needs the card: without CUDA it raises.
"""

from __future__ import annotations

import time

import torch

from .config import SimConfig
from .ops import cuda_build, sites
from .ops.sph_kernels import SortedTuning, default_tuning
from .sim.stepper import initial_state, make_rollout
from .utils.profiling import device_sync, gpu_identity

NORTH_STAR = 1e9  # particle-substeps/sec/chip @ 1M (BASELINE.json)


def scaled_config(n_particles: int,
                  site_capacity: int | None = None) -> SimConfig:
    """Golden physics at a given N; R scales to preserve voxel occupancy."""
    base_r = 47
    r = max(3, round(base_r * (n_particles / 262144.0) ** (1.0 / 3.0)))
    kw = {} if site_capacity is None else {"site_capacity": site_capacity}
    return SimConfig(particle_number=n_particles, bucket_resolution=r, **kw)


def site_bands(cfg: SimConfig, device: torch.device) -> int:
    """The z-band count a sites-tier run on ``device`` resolves to (0 in
    the config: ``sites.bands_for``), JAX bench.py:28-31."""
    return cfg.site_bands or sites.bands_for(
        cfg.bucket_resolution, cfg.n_particles,
        cfg.site_capacity_i or cfg.site_capacity, cfg.site_capacity, device)


def run_bench(n_particles: int = 1 << 20, frames: int = 20,
              warmup_frames: int = 5, neighbor: str = "sorted",
              tune: SortedTuning | None = None,
              steady_frames: int = 0,
              site_capacity: int | None = None,
              host_loop: bool = False) -> dict:
    """``neighbor`` is the tier (``make_rollout``'s); ``tune`` selects the
    sorted tier's route and variant (None reads the ``SPH_PALLAS_*``
    variables); ``steady_frames`` > 0 adds the ``steady_state_*`` keys;
    ``site_capacity`` sets the sites tier's (None: the config's 32);
    ``host_loop`` is ``make_rollout``'s (False, the graph, raises
    ``NotImplementedError`` for the tiers that loop on the host only), and
    the result records it."""
    if not torch.cuda.is_available():
        raise RuntimeError("run_bench measures the card; no CUDA device")
    device = torch.device("cuda")
    tune = default_tuning() if tune is None else tune
    cfg = scaled_config(n_particles, site_capacity)
    state = initial_state(cfg, device)

    t0 = time.perf_counter()
    state, _ = make_rollout(cfg, warmup_frames, neighbor=neighbor,
                            tune=tune, device=device,
                            host_loop=host_loop)(state)
    device_sync()
    compile_s = time.perf_counter() - t0

    roll = make_rollout(cfg, frames, neighbor=neighbor, tune=tune,
                        device=device, host_loop=host_loop)
    state, _ = roll(state)          # the timed length, once untimed
    device_sync()
    t0 = time.perf_counter()
    state, m = roll(state)
    device_sync()
    elapsed = time.perf_counter() - t0

    steady = {}
    if steady_frames:
        frame0 = warmup_frames + 2 * frames     # frames already simulated
        reps = max(1, steady_frames // frames)
        for _ in range(reps - 1):
            state, _ = roll(state)
        device_sync()
        t0 = time.perf_counter()
        state, m = roll(state)
        device_sync()
        s_elapsed = time.perf_counter() - t0
        w0 = frame0 + (reps - 1) * frames
        steady = {
            "steady_state_value": round(
                cfg.n_particles * cfg.substeps * frames / s_elapsed, 1),
            "steady_state_frames_window": [w0, w0 + frames],
            "steady_state_elapsed_s": round(s_elapsed, 3),
        }

    rate = cfg.n_particles * cfg.substeps * frames / elapsed
    ident = gpu_identity().splitlines()[0].split(", ")
    return {
        **steady,
        "metric": "particle-substeps/sec/chip (dam-break, faithful mode)",
        "value": round(rate, 1),
        "unit": "particle-substeps/s",
        "vs_baseline": round(rate / NORTH_STAR, 4),
        "n_particles": cfg.n_particles,
        "bucket_resolution": cfg.bucket_resolution,
        "frames_timed": frames,
        "elapsed_s": round(elapsed, 3),
        # the kernel build, and the graph's capture, happen at first use,
        # inside the warm-up
        "compile_plus_warmup_s": round(compile_s, 1),
        "neighbor": neighbor,
        "pallas_tuning": tune._asdict(),
        "scan_unroll": False,
        "site_capacity": cfg.site_capacity if neighbor == "sites" else None,
        "site_bands": site_bands(cfg, device) if neighbor == "sites" else None,
        "host_loop": host_loop,
        "exact_cert_total": int(m.exact_cert.sum()),
        "overflow_max": int(m.overflow.max()),
        "device": str(device),
        "device_name": torch.cuda.get_device_name(0),
        "power_limit": ident[1] if len(ident) > 1 else "not measured",
        "torch_cuda": torch.version.cuda,
        "nvcc": _nvcc(),
    }


def _nvcc() -> str:
    """The nvcc the kernels were built with, or why there is none."""
    try:
        return cuda_build.nvcc_path()
    except RuntimeError as e:
        return f"not found: {e}"
