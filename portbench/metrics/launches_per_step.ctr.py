"""Kernels the device ran a step in the traced stretch of a CTR cell (the
graph engine's replays: every kernel of the captured steps)."""

from portbench import trace


def read(record, config, traffic):
    s = record.stretch
    return len(trace.kernels(s.events)) / s.steps
