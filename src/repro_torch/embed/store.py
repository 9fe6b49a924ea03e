"""EmbeddingStore: one facade over the embedding placements.

A port of ``repro.embed.store``. Two placements are built: ``dense``
tables updated by the fused CowClip + coupled-L2 + Adam kernel
(``kernel="fused"``, the ``fused`` train path) and ``sparse``, the
unique-id placement whose update runs on a batch's unique rows through the
two sparse kernels, with lazy decay settled by ``flush``. Every other
placement is named here so the CLI and the routing stay those of the
reference, and raises ``NotImplementedError`` naming its ROADMAP item when
a bundle is asked for::

    bundle = store_for(cfg, path="sparse").make_bundle(cfg, hp, ...)
    params = bundle.prepare(params)
    state  = bundle.init(params)
    params, state, aux = bundle.step(params, state, batch)
    params, state = bundle.flush(params, state)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import builders
from ..core.builders import TRAIN_PATHS, TrainStepBundle
from ..core.tree import tree_leaves

PLACEMENTS = ("dense", "sparse", "sharded", "sharded_sparse", "hotcold")

# core.builders.TRAIN_PATHS path name -> (placement, dense kernel)
_PATH_TO_STORE = {
    "substrate": ("dense", "substrate"),
    "fused": ("dense", "fused"),
    "sparse": ("sparse", "auto"),
    "sharded": ("sharded", "auto"),
    "sharded_sparse": ("sharded_sparse", "auto"),
    "hotcold": ("hotcold", "auto"),
}

# where each placement that is not ported yet stands in ROADMAP.md
NOT_PORTED = {
    "substrate": "ROADMAP queue 1 item 4 (the substrate placement)",
    "hotcold": "ROADMAP queue 1 item 5 (streaming and hot/cold tiers)",
    "sharded": "ROADMAP queue 1 item 7 (multi-GPU placements)",
    "sharded_sparse": "ROADMAP queue 1 item 7 (multi-GPU placements)",
}


def not_ported(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"placement {path!r} is not ported to repro_torch yet: "
        f"{NOT_PORTED[path]}; use the 'fused' or 'sparse' placement")


@dataclasses.dataclass(frozen=True)
class EmbeddingStore:
    """A chosen placement plus its placement-specific knobs."""

    placement: str = "dense"
    kernel: str = "substrate"     # dense only: "substrate" | "fused"

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {self.placement!r}; "
                             f"expected one of {PLACEMENTS}")

    @property
    def path(self) -> str:
        """The ``TRAIN_PATHS`` name of this store."""
        return self.kernel if self.placement == "dense" else self.placement

    def describe(self) -> str:
        if self.placement == "dense":
            return f"dense({self.kernel})"
        return self.placement

    def make_bundle(
        self,
        cfg,
        hp,
        *,
        clip_kind: str = "adaptive_column",
        r: float = 1.0,
        zeta: float = 1e-5,
        warmup_steps: int = 0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        nonfinite_guard: bool = False,
    ) -> TrainStepBundle:
        """Build this placement's bundle (``fused`` and ``sparse`` only).

        The fused kernel always applies CowClip, as the reference's fused
        path does; ``sparse`` takes ``clip_kind`` "adaptive_column"
        (CowClip) or "none" (the ablation clips are substrate-only).
        ``nonfinite_guard`` skips any update whose batch loss is NaN/Inf,
        counted in ``aux["skipped_steps"]``.
        """
        if self.path not in ("fused", "sparse"):
            raise not_ported(self.path)
        from ..train import loop as loop_lib  # deferred: train imports core

        dense_tx = builders.dense_tower_tx(
            hp, warmup_steps=warmup_steps, b1=b1, b2=b2, eps=eps)
        if self.path == "fused":
            step, init = loop_lib.make_fused_train_step(
                cfg, hp, r=r, zeta=zeta, dense_tx=dense_tx,
                nonfinite_guard=nonfinite_guard)
            return TrainStepBundle(step, init, builders.identity_flush)

        if clip_kind not in ("adaptive_column", "none"):
            raise ValueError(
                f"{self.placement} placement supports clip_kind "
                f"'adaptive_column' or 'none', got {clip_kind!r} "
                f"(ablation clips are substrate-only)")
        step, init, flush = loop_lib.make_sparse_train_step(
            cfg, hp, r=r, zeta=zeta, dense_tx=dense_tx,
            clip=clip_kind == "adaptive_column", b1=b1, b2=b2, eps=eps,
            nonfinite_guard=nonfinite_guard)
        return TrainStepBundle(step, init, flush)


def serving_snapshot(bundle: TrainStepBundle, params, state):
    """Canonical dense params for serving, from any placement's live
    state: ``flush`` (settles the sparse placement's pending decay; the
    identity elsewhere), then ``export`` (undoes ``prepare``'s layout)."""
    params, _ = bundle.flush(params, state)
    return bundle.export(params)


def max_pending_depth(state) -> int:
    """Deepest pending lazy-decay debt in an optimizer state, in steps:
    ``max(step - last_step)`` over every embedding row. 0 right after a
    ``flush`` and for placements whose state has no ``last_step``."""
    if not isinstance(state, dict) or "last_step" not in state:
        return 0
    step = int(state["step"])
    return max([0] + [int(step - ls.to(torch.int64).min())
                      for ls in tree_leaves(state["last_step"])])


def resolve_path(cfg, path: Optional[str] = None) -> str:
    """Resolution order: explicit path > cfg.placement > cfg.sparse knob
    ("sparse" when set, else "substrate")."""
    if path is None:
        path = getattr(cfg, "placement", None)
    if path is None:
        path = "sparse" if getattr(cfg, "sparse", False) else "substrate"
    if path not in TRAIN_PATHS:
        raise ValueError(
            f"unknown path {path!r}; expected one of {TRAIN_PATHS}")
    return path


def store_for(cfg, *, path: Optional[str] = None) -> EmbeddingStore:
    """The store for a config: routes the train-path names and the
    config's ``placement`` onto one of the placements."""
    placement, kernel = _PATH_TO_STORE[resolve_path(cfg, path)]
    return EmbeddingStore(placement=placement, kernel=kernel)
