"""Runtime utilities: profiling, checkpoint/resume, metrics logging and
state diagnostics."""
