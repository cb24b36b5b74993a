"""Checkpoint / resume in the JAX package's npz format.

Counterpart of the npz path of ``sphfluidsimulation_tpu/utils/checkpoint.py``:
the same file layout (``pos``, ``vel``, ``nan_count`` and a ``meta`` JSON
blob with ``format_version`` 1, ``frame``, ``config`` and ``extra``), so a
checkpoint written by either package loads in the other. The JAX package's
orbax path (a path without ``.npz``) is JAX-only: orbax saves JAX pytrees,
and the port has no counterpart; such a path raises here.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import SimConfig
from ..state import ParticleState, state_from_numpy, state_to_numpy

_FORMAT_VERSION = 1


def _npz_only(path: str) -> None:
    if not path.endswith(".npz"):
        raise ValueError(
            f"{path}: the torch port reads and writes .npz checkpoints only "
            "(the orbax directory format is the JAX package's)")


def save_checkpoint(path: str, state: ParticleState, cfg: SimConfig, *,
                    frame: int = 0, extra: dict | None = None) -> None:
    """Write state + config (+ metadata) to the ``.npz`` file ``path``."""
    _npz_only(path)
    meta = {"format_version": _FORMAT_VERSION, "frame": int(frame),
            "config": cfg.as_dict(), "extra": extra or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pos, vel, nan_count = state_to_numpy(state)
    np.savez_compressed(
        path, pos=pos, vel=vel, nan_count=nan_count,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))


def load_checkpoint(path: str, device: torch.device | str | None = None
                    ) -> tuple[ParticleState, SimConfig, dict]:
    """Read (state on ``device``, config, meta) from ``path``; validates the
    state's shape against the config."""
    _npz_only(path)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version in {path}")
        cfg = SimConfig.from_dict(meta["config"])
        pos, vel, nan_count = z["pos"], z["vel"], z["nan_count"]
    if pos.shape != (cfg.n_particles, 3):
        raise ValueError(
            f"checkpoint state {pos.shape} does not match config "
            f"({cfg.n_particles} particles)")
    return state_from_numpy(pos, vel, nan_count, device), cfg, meta
