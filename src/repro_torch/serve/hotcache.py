"""Hot-id embedding cache: rows on the card for the hot ids, the full
tables in host memory.

A port of ``repro.serve.hotcache``. A production CTR vocabulary does not
fit one card, but the Zipf skew CowClip is built on means a small hot
working set serves almost every lookup (Baidu's hot/cold split,
arXiv:2201.05500). Admission is frequency-clairvoyant: ``id_frequencies``
counts each id's occurrences in the training ids (the sum of CowClip's
per-step counts over an epoch; ``launch/train.py`` saves it beside the
checkpoint), and each field's top-``capacity`` ids by that count get a row
on the card. No online eviction: the hot set refreshes with the snapshot.

A dispatch resolves each (row, field) lookup on the host against the hot
set (``slot_of``: id -> hot slot, -1 on a miss), gathers only the missing
rows from the host tables, and one fixed-shape forward, captured as a CUDA
graph (``engine.TracedFn``), selects each hit's row from the hot tables on
the card and runs the model's combiner. Exactness: hot rows are copies of
the rows the uncached engine reads, through the same
``ctr._forward_from_emb``, so cached and uncached scores agree (held to
1e-5 for the fused and sparse placements in
``tests/test_torch_serve_ctr.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.tree import tree_map
from ..models import ctr
from .engine import TracedFn, _pad_rows


def id_frequencies(ids: np.ndarray,
                   vocab_sizes: Sequence[int]) -> Dict[str, np.ndarray]:
    """Per-field id occurrence counts over a training id matrix [N, F]:
    ``{"field_i": int64 [vocab_i]}``, the admission signal."""
    return {
        f"field_{i}": np.bincount(
            np.asarray(ids[:, i]).ravel(), minlength=v)[:v].astype(np.int64)
        for i, v in enumerate(vocab_sizes)
    }


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


class HotEmbeddingCache:
    """Two-tier embedding storage behind the engine's scoring contract.

    Per field the top-``capacity`` ids by training frequency have their
    rows on ``device`` (the fm table's ``[K, dim]`` rows, and the 1-dim LR
    stream's when the model has one); the full tables stay as host NumPy
    arrays, and the dense tower goes to ``device``. ``score`` has the
    engine's signature, so it drops into a ``MicroBatcher`` unchanged.
    """

    def __init__(self, cfg: ctr.CTRConfig, params: dict,
                 freqs: Dict[str, np.ndarray], *, capacity: int = 4096,
                 batch_size: int = 256,
                 compute_dtype: Optional[str] = None, device="cuda"):
        if compute_dtype is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self.has_lin = "lin" in params["embed"]

        # host tier: the full tables
        self._host_fm = [_host(params["embed"]["fm"][f"field_{i}"])
                         for i in range(cfg.n_fields)]
        self._host_lin = ([_host(params["embed"]["lin"][f"field_{i}"])
                           for i in range(cfg.n_fields)]
                          if self.has_lin else None)

        # device tier: top-capacity rows per field by training frequency
        self._slot_of = []
        hot_fm, hot_lin = [], []
        self.hot_rows = []
        for i, v in enumerate(cfg.vocab_sizes):
            freq = np.asarray(freqs[f"field_{i}"])
            if freq.shape[0] != v:
                raise ValueError(
                    f"field_{i}: freq length {freq.shape[0]} != vocab {v}")
            k = min(int(capacity), v)
            hot_ids = np.argsort(-freq, kind="stable")[:k]
            slot = np.full(v, -1, np.int32)
            slot[hot_ids] = np.arange(k, dtype=np.int32)
            self._slot_of.append(slot)
            self.hot_rows.append(k)
            hot_fm.append(torch.from_numpy(
                self._host_fm[i][hot_ids]).to(self.device))
            if self.has_lin:
                hot_lin.append(torch.from_numpy(
                    self._host_lin[i][hot_ids]).to(self.device))
        self._hot_fm = tuple(hot_fm)
        self._hot_lin = tuple(hot_lin) if self.has_lin else None
        self._dense_params = tree_map(
            lambda x: torch.as_tensor(x).to(self.device), params["dense"])

        self._fwd = TracedFn(self._fwd_body)
        self._lookups = 0
        self._hits = 0

    # ---- the captured forward --------------------------------------------

    def _fwd_body(self, dense_params, hot_fm, hot_lin, slots, hit,
                  miss_fm, miss_lin, feats):
        """Fixed-shape forward: per field the hot row (a gather on the
        card) or the uploaded miss row, then the model's combiner.
        ``slots`` are 0 on a miss; ``hit`` masks that row out."""
        cfg = self.cfg
        cols = [torch.where(hit[:, i, None],
                            torch.index_select(hot_fm[i], 0, slots[:, i]),
                            miss_fm[:, i])
                for i in range(cfg.n_fields)]
        emb = torch.stack(cols, dim=1)
        lin_emb = None
        if hot_lin is not None:
            lcols = [torch.where(hit[:, i, None],
                                 torch.index_select(hot_lin[i], 0,
                                                    slots[:, i]),
                                 miss_lin[:, i])
                     for i in range(cfg.n_fields)]
            lin_emb = torch.stack(lcols, dim=1)
        return ctr._forward_from_emb(dense_params, cfg, emb, lin_emb, feats)

    # ---- host side --------------------------------------------------------

    def _resolve(self, ids: np.ndarray):
        """Split a padded [B, F] id block into hot slots and miss rows."""
        b, n_fields = ids.shape
        slots = np.empty((b, n_fields), np.int32)
        for i in range(n_fields):
            slots[:, i] = self._slot_of[i][ids[:, i]]
        hit = slots >= 0
        miss_fm = np.zeros((b, n_fields, self.cfg.emb_dim), np.float32)
        miss_lin = (np.zeros((b, n_fields, 1), np.float32)
                    if self.has_lin else None)
        for i in range(n_fields):
            mrows = ~hit[:, i]
            if mrows.any():
                cold = ids[mrows, i]
                miss_fm[mrows, i] = self._host_fm[i][cold]
                if self.has_lin:
                    miss_lin[mrows, i] = self._host_lin[i][cold]
        return np.maximum(slots, 0), hit, miss_fm, miss_lin

    def _score_block(self, ids: np.ndarray, dense: np.ndarray,
                     n_real: int) -> np.ndarray:
        slots, hit, miss_fm, miss_lin = self._resolve(ids)
        # stats over real rows only: pad rows alias id 0 and would skew them
        self._lookups += n_real * self.cfg.n_fields
        self._hits += int(hit[:n_real].sum())
        s = self._fwd(self._dense_params, self._hot_fm, self._hot_lin,
                      slots, hit, miss_fm, miss_lin, dense)
        return s.cpu().numpy()[:n_real]

    def score(self, ids, dense) -> np.ndarray:
        """Engine-contract scoring: [n, F] ids + [n, Dd] feats -> [n] f32."""
        ids = np.atleast_2d(np.asarray(ids, np.int32))
        dense = np.atleast_2d(np.asarray(dense, np.float32))
        n = ids.shape[0]
        bs = self.batch_size
        out = np.empty(n, np.float32)
        for start in range(0, max(n, 1), bs):
            end = min(start + bs, n)
            out[start:end] = self._score_block(
                _pad_rows(ids[start:end], bs),
                _pad_rows(dense[start:end], bs), end - start)
        return out

    @property
    def n_traces(self) -> int:
        return self._fwd.n_traces

    def hit_rate(self) -> float:
        """Fraction of (row, field) lookups served by the hot set."""
        return self._hits / max(self._lookups, 1)

    def stats(self) -> dict:
        return {"lookups": self._lookups, "hits": self._hits,
                "hit_rate": self.hit_rate(), "hot_rows": list(self.hot_rows),
                "n_traces": self.n_traces,
                "device_rows": int(sum(self.hot_rows)),
                "host_rows": int(sum(t.shape[0] for t in self._host_fm))}
