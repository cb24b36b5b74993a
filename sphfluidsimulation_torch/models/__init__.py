"""Spawn presets and the Scene handle."""
