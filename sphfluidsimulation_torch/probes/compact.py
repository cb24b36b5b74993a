"""Compact-route probe: does one step of the compact-lane route (K5) agree
with the window route, and what do the two routes run at?

Counterpart of ``scripts/probe_compact_tpu.py``'s stages, with no kernel of
its own (its Pallas kernel is the liveness probe, :mod:`.live`):

- ``check_16k`` (its ``CHECK_SRC``): one faithful step of the window route
  and of the compact route from the canonical spawn at 16,384 particles and
  R = 19, printing the largest position and velocity difference, each
  route's certificate and the compact route's mean density. The golden
  EOS makes the spawn's velocities explode within the step, so rows drift
  past their tile's band and the compact route misses candidates of them,
  which its certificate counts: the routes differ there. :func:`checks`
  states what one run can show of that: the window route certifies 0, the
  rows that differ number no more than the certificate, and at
  ``N_AGREE`` particles, where the compact route certifies 0 too, the two
  routes agree;
- the bench stages (its ``BENCH_SRC``, through ``bench.run_bench``, 20
  frames each): the compact route at 262,144 and 1,048,576 particles, and
  the window route with ``bf16`` at 262,144.

Its ``SPH_PALLAS_CROWS`` sweep (``compact_262k_r16``, ``_r64``) is left out:
``compact_rows`` is a Mosaic layout knob of the TPU kernel (its row tile),
which the port's K5 does not have by design (ROADMAP B). On the CPU the
bench stages run the same rollouts without a rate (no device time there).
"""

from __future__ import annotations

import time

from ..bench import run_bench, scaled_config
from ..config import SimConfig
from ..ops.sph_kernels import SortedTuning
from ..params import PhysParams
from ..sim.stepper import initial_state, make_param_step, make_rollout
from . import common

WINDOW = SortedTuning(fused=True, compact=False)
COMPACT = SortedTuning(fused=True, compact=True)
# (stage, particles, tuning), the script's stages without the sweep
BENCH_STAGES = (("compact_262k", 1 << 18, COMPACT),
                ("compact_1m", 1 << 20, COMPACT),
                ("v6bf16_262k", 1 << 18, SortedTuning(bf16=True)))
FRAMES = 20
# the spawn at which the compact route's certificate is 0 (R = 19)
N_AGREE = 256
# where the routes agree: positions (in the unit box), velocities against
# the largest speed
AGREE_TOL = 1e-5


def check(device, n: int = 1 << 14) -> dict:
    """One step of each route from the spawn (R = 19 up to 16,384
    particles, else 30, as the script sets it)."""
    dev = common.resolve(device)
    cfg = SimConfig(particle_number=n,
                    bucket_resolution=19 if n <= 1 << 14 else 30)
    st = initial_state(cfg, dev)
    phys = PhysParams.from_config(cfg, dev)
    s6, m6 = make_param_step(cfg, tune=WINDOW)(st, phys)
    s7, m7 = make_param_step(cfg, tune=COMPACT)(st, phys)
    vmax = float(s6.vel.abs().max())
    res = {"dpos": float((s7.pos - s6.pos).abs().max()),
           "dvel": float((s7.vel - s6.vel).abs().max()),
           "cert_window": int(m6.exact_cert),
           "cert_compact": int(m7.exact_cert),
           "rho": float(m7.mean_density), "vmax": vmax,
           # rows where the routes part: a position by more than
           # AGREE_TOL, or a velocity by more than AGREE_TOL of the max speed
           "rows_differing": int(
               (((s7.pos - s6.pos).abs() > AGREE_TOL)
                | ((s7.vel - s6.vel).abs() > AGREE_TOL * vmax)).any(1)
               .sum())}
    print(f"check n={n}: RESULT dpos={res['dpos']:.3e} dvel={res['dvel']:.3e} "
          f"cert6={res['cert_window']} cert7={res['cert_compact']} "
          f"rho={res['rho']:.6f}; max speed {vmax:.3e}, "
          f"{res['rows_differing']} rows differ by more than {AGREE_TOL:g} "
          f"(velocities: of the max speed) [{common.identity(dev)}]",
          flush=True)
    return res


def checks(device, n: int = 1 << 14) -> dict:
    """:func:`check` at ``n`` and at ``N_AGREE``, and whether they bear out
    the explanation of the difference (``explained``): the window route
    certifies 0 in both; at ``n`` the rows that differ number no more than
    the compact route's certificate counts; at ``N_AGREE`` it certifies 0
    and the routes agree within ``AGREE_TOL``."""
    big, small = check(device, n), check(device, N_AGREE)
    explained = (big["cert_window"] == 0 and small["cert_window"] == 0
                 and big["rows_differing"] <= big["cert_compact"]
                 and small["cert_compact"] == 0
                 and small["rows_differing"] == 0)
    print(f"check: {'explained' if explained else 'NOT EXPLAINED'} by the "
          f"compact route's certificate (the rows it counts may miss "
          f"candidates) [{common.identity(common.resolve(device))}]",
          flush=True)
    return {"check": big, "agree": small, "explained": explained}


def bench(device, stage: str, n: int, tune: SortedTuning,
          frames: int = FRAMES) -> dict:
    """One bench stage: ``run_bench`` on the card; on the CPU the same
    rollout (``frames`` frames from the spawn), its rate not measured."""
    dev = common.resolve(device)
    ident = common.identity(dev)
    if dev.type == "cuda":
        r = run_bench(n_particles=n, frames=frames, tune=tune)
        print(f"{stage} n={n}: RESULT {r['value']:.6g} {r['unit']} "
              f"compile={r['compile_plus_warmup_s']}s "
              f"cert={r['exact_cert_total']} ovf={r['overflow_max']} "
              f"tune={r['pallas_tuning']} [{ident}]", flush=True)
        return r
    cfg = scaled_config(n)
    t0 = time.perf_counter()
    _, m = make_rollout(cfg, frames, tune=tune, device=dev)(
        initial_state(cfg, dev))
    r = {"value": None, "exact_cert_total": int(m.exact_cert.sum()),
         "overflow_max": int(m.overflow.max()),
         "host_s": time.perf_counter() - t0}
    print(f"{stage} n={n}: rate not measured; cert={r['exact_cert_total']} "
          f"ovf={r['overflow_max']} tune={tune._asdict()} [{ident}]",
          flush=True)
    return r


def run(device=None, n_check: int = 1 << 14, bench_particles=None,
        frames: int = FRAMES) -> dict:
    """:func:`checks` and the bench stages; ``bench_particles`` replaces
    every bench stage's particle count (the CPU tests run them small)."""
    dev = common.resolve(device)
    result = {**checks(dev, n_check), "bench": {}}
    for stage, n, tune in BENCH_STAGES:
        result["bench"][stage] = bench(dev, stage, bench_particles or n,
                                       tune, frames)
    result["ok"] = result["explained"]
    result["kernels"] = {}
    return result
