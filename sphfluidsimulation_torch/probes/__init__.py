"""Hopper micro-benchmarks of the JAX package's Mosaic probes.

Counterpart of the ``scripts/probe_*`` scripts that reach ``pl.pallas_call``
and of the liveness probe in the root ``bench.py``: each probe asks its
script's question of the card, with a hand-written CUDA kernel
(``csrc/probes/``, built at a probe's first use, never by the simulator's
path) and a plain PyTorch version beside it:

- ``live``: does a fresh kernel launch and answer (``live.probe_device``);
- ``intops``: the int ops of the packed-key membership test, bit for bit;
- ``loopstruct``: the walk's and the pair arithmetic's shares of a force
  pass, on the script's synthetic walk and on K3's own walk;
- ``mxu``: the force pair's accumulates and Gram r² on the tensor cores,
  their time and their accuracy;
- ``v7prims``: a bulk copy into shared memory, a scalar read from it and a
  runtime lane roll;
- ``scalar``: the cost of a per-tile scalar prologue;
- ``compact``: the compact route's one-step check and bench stages (no
  kernel of its own).

Run ``python -m sphfluidsimulation_torch.probes NAME [--device cpu]``: on
the card by default (without one it raises), on the CPU the plain versions
with no device time. Each probe prints its lines, every number beside the
card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import importlib

from .common import launch_counts, reset_launch_counts  # noqa: F401

NAMES = ("live", "intops", "loopstruct", "mxu", "v7prims", "scalar",
         "compact")


def run(name: str, device=None, **kwargs) -> dict:
    """Probe ``name``'s run on ``device`` (None: the card)."""
    if name not in NAMES:
        raise ValueError(f"unknown probe {name!r}; one of {NAMES}")
    return importlib.import_module(f".{name}", __name__).run(device,
                                                             **kwargs)
