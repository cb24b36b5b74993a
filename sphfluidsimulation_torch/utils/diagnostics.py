"""State validation (SURVEY.md §5: failure detection).

Counterpart of ``sphfluidsimulation_tpu/utils/diagnostics.py::
validate_state``. The reference's only runtime guard is the in-kernel NaN
trap (VelPos.compute:143-147); beyond the always-on per-particle
``nan_count``, ``validate_state`` checks the state's invariants on the host
and raises ``StateError`` with a diagnosis. The JAX module's
``checkify_step`` runs such checks inside ``jit`` without a host round trip;
PyTorch runs eagerly, so the port has no counterpart: a caller that wants
the check calls ``validate_state`` on the step's output, which waits for
the card.
"""

from __future__ import annotations

import numpy as np

from ..state import ParticleState, state_to_numpy


class StateError(RuntimeError):
    pass


def validate_state(state: ParticleState, *, n_particles: int | None = None
                   ) -> dict:
    """Host-side invariant check; returns a small diagnostics dict."""
    pos, vel, nan_count = state_to_numpy(state)
    if n_particles is not None and pos.shape != (n_particles, 3):
        raise StateError(f"position shape {pos.shape} != ({n_particles}, 3)")
    bad_pos = ~np.isfinite(pos)
    bad_vel = ~np.isfinite(vel)
    out_of_cube = (pos < 0.0) | (pos > 1.0)
    diag = {
        "nonfinite_pos": int(bad_pos.any(axis=-1).sum()),
        "nonfinite_vel": int(bad_vel.any(axis=-1).sum()),
        "out_of_cube": int(out_of_cube.any(axis=-1).sum()),
        "nan_trapped": int(nan_count.sum()),
        "max_speed": float(np.sqrt((vel * vel).sum(-1).max())),
    }
    if diag["nonfinite_pos"]:
        raise StateError(f"non-finite positions: {diag}")
    return diag
