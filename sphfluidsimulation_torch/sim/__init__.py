"""Frame stepper and rollout engine."""

from .stepper import (make_dt_rollout, make_frame_step, make_rollout,  # noqa: F401
                      integrate_substep)
