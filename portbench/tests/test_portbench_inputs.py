"""The traffic and the weights are made from ``--seed`` alone, and the
entry point never measures without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from portbench.generators import ctr as gen
from portbench.tests import tiny


def test_traffic_is_deterministic_in_the_seed(monkeypatch):
    # blocks of 200 rows, so the pool of 512 is drawn in three
    monkeypatch.setattr(gen, "BLOCK_ROWS", 200)
    cfg, tr = tiny.config(), tiny.traffic()
    a = gen.make_traffic(tr, cfg, 2**33 + 1, "cpu")
    b = gen.make_traffic(tr, cfg, 2**33 + 1, "cpu")
    c = gen.make_traffic(tr, cfg, 2**33 + 2, "cpu")
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["ids"], c["ids"])
    assert a["ids"].shape == (tr["batch"] * tr["batches"],
                              len(cfg["vocab_sizes"]))
    assert (a["ids"] < np.array(cfg["vocab_sizes"])).all()
    assert 0.1 < a["labels"].mean() < 0.4


def test_weights_are_deterministic_in_the_seed():
    cfg = tiny.config()
    a = gen.make_weights(cfg, 3, "cpu")
    b = gen.make_weights(cfg, 3, "cpu")
    assert torch.equal(a["embed"]["fm"]["field_2"], b["embed"]["fm"]
                       ["field_2"])
    assert torch.equal(a["dense"]["mlp"]["w1"], b["dense"]["mlp"]["w1"])


def test_entry_refuses_without_a_card():
    if torch.cuda.is_available():
        return
    manifest = json.loads((tiny.ROOT.parent / "BENCHMARK.json").read_text())
    cell = manifest["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, str(tiny.ROOT / "run.py"), "--workload", cell,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tiny.ROOT.parent)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr
