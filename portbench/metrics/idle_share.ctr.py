"""The device's idle share in the traced stretch of a CTR cell, %:
1 - busy / wall, busy the union of the device's events."""

from portbench import trace


def read(record, config, traffic):
    s = record.stretch
    return 100.0 * (1.0 - trace.busy_s(s.events) / s.wall_s)
