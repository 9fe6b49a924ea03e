"""A CTR cell at a size a CPU test holds: the deepfm-criteo file's
numbers and laws on five small fields, a narrow tower and small batches."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = "deepfm-criteo.fused.b131072"
LM_CELL = "rwkv6-7b-8l.train.8x512"


def config() -> dict:
    cfg = json.loads((ROOT / "configs" / "deepfm-criteo.json").read_text())
    cfg["hyperparams"] = dict(cfg["hyperparams"], base_batch=32,
                              epoch_rows=640)
    cfg.update(vocab_sizes=[50, 7, 300, 4, 1000], n_dense=3, emb_dim=4,
               mlp_dims=[16, 16, 16])
    return cfg


def traffic(placement: str = "fused") -> dict:
    t = json.loads((ROOT / "traffic" / "fused.b131072.json").read_text())
    t.update(placement=placement, batch=64, batches=8, scan_steps=4,
             trace_chunks=2)
    return t


def lm_config() -> dict:
    """rwkv6-7b-8l's file at two layers of width 128 (4 heads of 32), a
    vocab of 512, computing in bfloat16 as the file states."""
    cfg = json.loads((ROOT / "configs" / "rwkv6-7b-8l.json").read_text())
    cfg["hyperparams"] = dict(cfg["hyperparams"], base_batch=64)
    cfg.update(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
               vocab_size=512, decay_rank=8)
    return cfg


def lm_traffic() -> dict:
    t = json.loads((ROOT / "traffic" / "8x512.json").read_text())
    t.update(batch=4, seq=32, slices=16, trace_steps=2)
    return t
