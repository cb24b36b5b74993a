"""sphfluidsimulation_torch — the PyTorch + CUDA port of sphfluidsimulation_tpu.

Counterpart of ``sphfluidsimulation_tpu/__init__.py``. The JAX package is the
reference; this package imports ``torch`` and never ``jax``. Its main path is
the faithful dam-break rollout on the sorted-frame tier, whose density and
fused-substep passes are hand-written CUDA kernels (``csrc/``) on an NVIDIA
card and plain PyTorch on the CPU. Public API:

    from sphfluidsimulation_torch import SimConfig, Scene
    scene = Scene(SimConfig(particle_number=65536), device="cuda")
    scene.step(100)
"""

from .config import GOLDEN_CONFIG, TINY_CONFIG, SimConfig  # noqa: F401
from .params import PhysParams, stack_params  # noqa: F401
from .state import (FrameAux, ParticleState, StepMetrics,  # noqa: F401
                    make_state)
from .models.scene import Scene  # noqa: F401
from .sim.stepper import (  # noqa: F401
    initial_state,
    integrate_substep,
    make_dt_rollout,
    make_frame_step,
    make_param_step,
    make_rollout,
)
from . import parallel, render, utils  # noqa: F401

__version__ = "0.1.0"
