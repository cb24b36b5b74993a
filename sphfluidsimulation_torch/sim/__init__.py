"""Frame stepper and rollout engine."""
