"""The comparison that decides ``correct``, driven through a whole CTR run
at a tiny size on the CPU (the port's CPU path against the reference):
true for the port as it is, false for the control (the reference in TF32
in the port's place) and for each fault a training cell can have, planted
in the port's step."""

from __future__ import annotations

import time

import pytest
import torch

from portbench.families import ctr
from portbench.tests import tiny


def _run(placement="fused", fault=None, device="cpu"):
    return ctr.run(tiny.CELL, tiny.config(), tiny.traffic(placement),
                   seed=2**33 + 7, seconds=0.2, trace=False, device=device,
                   root=tiny.ROOT, t_start=time.perf_counter(), fault=fault)


@pytest.mark.parametrize("placement", ["fused", "sparse"])
def test_port_agrees_with_reference(placement):
    record = _run(placement)
    assert record.correct, record.checks
    assert record.steps > 0 and record.failed == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_planted_fault_is_not_correct(fault):
    record = _run("fused", fault)
    assert not record.correct, record.checks


@pytest.mark.parametrize("kind", ["tf32", "half_batch"])
def test_control_is_not_correct(kind):
    out = ctr.control(tiny.CELL, tiny.config(), tiny.traffic(), seed=5,
                      device="cpu", root=tiny.ROOT, kind=kind)
    assert not out["correct"], out["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_port_agrees_with_reference_on_card(card):
    record = _run("fused", device=card)
    assert record.correct, record.checks
    out = ctr.control(tiny.CELL, tiny.config(), tiny.traffic(), seed=5,
                      device=card, root=tiny.ROOT, kind="tf32")
    assert not out["correct"], out["checks"]
