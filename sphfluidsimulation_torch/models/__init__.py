"""Spawn presets and the Scene handle."""

from .presets import init_positions, preset1, preset2, preset3  # noqa: F401
from .scene import Scene  # noqa: F401
