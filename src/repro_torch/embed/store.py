"""EmbeddingStore: one facade over the embedding placements.

A port of ``repro.embed.store``. The port's first slice builds one
placement: ``dense`` tables updated by the fused CowClip + coupled-L2 +
Adam kernel (``kernel="fused"``, the ``fused`` train path). Every other
placement is named here so the CLI and the routing stay those of the
reference, and raises ``NotImplementedError`` naming its ROADMAP item when
a bundle is asked for::

    bundle = store_for(cfg, path="fused").make_bundle(cfg, hp, ...)
    params = bundle.prepare(params)
    state  = bundle.init(params)
    params, state, aux = bundle.step(params, state, batch)
    params, state = bundle.flush(params, state)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import builders
from ..core.builders import TRAIN_PATHS, TrainStepBundle

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
    "sparse": "ROADMAP queue 1 item 1 (slice 2: the sparse placement)",
    "hotcold": "ROADMAP queue 1 item 5 (streaming and hot/cold tiers)",
    "sharded": "ROADMAP queue 1 item 7 (multi-GPU placements)",
    "sharded_sparse": "ROADMAP queue 1 item 7 (multi-GPU placements)",
}


def not_ported(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"placement {path!r} is not ported to repro_torch yet: "
        f"{NOT_PORTED[path]}; use the 'fused' placement")


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
        r: float = 1.0,
        zeta: float = 1e-5,
        warmup_steps: int = 0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        nonfinite_guard: bool = False,
    ) -> TrainStepBundle:
        """Build this placement's bundle (``dense`` + ``fused`` only).

        The fused kernel always applies CowClip, as the reference's fused
        path does (the ablation clips are substrate-only).
        ``nonfinite_guard`` skips any update whose batch loss is NaN/Inf,
        counted in ``aux["skipped_steps"]``.
        """
        if self.path != "fused":
            raise not_ported(self.path)
        from ..train import loop as loop_lib  # deferred: train imports core

        dense_tx = builders.dense_tower_tx(
            hp, warmup_steps=warmup_steps, b1=b1, b2=b2, eps=eps)
        step, init = loop_lib.make_fused_train_step(
            cfg, hp, r=r, zeta=zeta, dense_tx=dense_tx,
            nonfinite_guard=nonfinite_guard)
        return TrainStepBundle(step, init, builders.identity_flush)


def resolve_path(cfg, path: Optional[str] = None) -> str:
    """Resolution order: explicit path > cfg.placement > "substrate"."""
    if path is None:
        path = getattr(cfg, "placement", None) or "substrate"
    if path not in TRAIN_PATHS:
        raise ValueError(
            f"unknown path {path!r}; expected one of {TRAIN_PATHS}")
    return path


def store_for(cfg, *, path: Optional[str] = None) -> EmbeddingStore:
    """The store for a config: routes the train-path names and the
    config's ``placement`` onto one of the placements."""
    placement, kernel = _PATH_TO_STORE[resolve_path(cfg, path)]
    return EmbeddingStore(placement=placement, kernel=kernel)
