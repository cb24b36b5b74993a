"""Runtime utilities: profiling, checkpoint/resume, metrics logging and
state diagnostics. JAX's ``checkify_step``, ``trace`` and
``ThroughputTimer`` are not ported (ROADMAP queue A)."""

from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .diagnostics import StateError, validate_state  # noqa: F401
from .metrics import MetricsLogger  # noqa: F401
from .profiling import device_sync  # noqa: F401
