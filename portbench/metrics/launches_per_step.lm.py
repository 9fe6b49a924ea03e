"""Kernels the device ran a step in the traced stretch of an LM cell
(``train/loop.py:make_lm_train_step``'s eager step)."""

from portbench import trace


def read(record, config, traffic):
    s = record.stretch
    return len(trace.kernels(s.events)) / s.steps
