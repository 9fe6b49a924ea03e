"""The LM cell's comparison driven through a whole run at a tiny size on
the CPU: the port (bfloat16, as the file states) against the float32
reference is correct; the control (the reference in float8 in the port's
place) and each planted fault are not."""

from __future__ import annotations

import time

import pytest

from portbench.families import lm
from portbench.tests import tiny


def _run(fault=None):
    return lm.run(tiny.LM_CELL, tiny.lm_config(), tiny.lm_traffic(),
                  seed=2**33 + 5, seconds=0.2, trace=False, device="cpu",
                  root=tiny.ROOT, t_start=time.perf_counter(), fault=fault)


def test_port_agrees_with_reference():
    record = _run()
    assert record.correct, record.checks
    assert record.steps > 0 and record.failed == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_planted_fault_is_not_correct(fault):
    assert not _run(fault).correct


@pytest.mark.parametrize("kind", ["fp8", "half_batch"])
def test_control_is_not_correct(kind):
    out = lm.control(tiny.LM_CELL, tiny.lm_config(), tiny.lm_traffic(),
                     seed=3, device="cpu", root=tiny.ROOT, kind=kind)
    assert not out["correct"], out["checks"]
