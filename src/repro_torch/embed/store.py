"""EmbeddingStore: one facade over the embedding placements.

A port of ``repro.embed.store``. Its placements: ``dense`` tables
updated through the composable optimizer chain (``kernel="substrate"``,
the exactness oracle: ``core.builders.build_optimizer`` with any Table-7
clip) or by the fused CowClip + coupled-L2 + Adam kernel
(``kernel="fused"``); ``sparse``, the unique-id placement whose update
runs on a batch's unique rows through the two sparse kernels, with lazy
decay settled by ``flush``; ``sharded`` and ``sharded_sparse``, the
tables' rows split over the ``"model"`` axis of a ``torch.distributed``
grid of ranks and the batch over its ``"data"`` axis
(``embed.sharded``, ``embed.sharded_sparse``; a rank's update dense on
its rows through the fused kernel, or on the batch ids it owns through
the sparse pair; both take the non-finite guard, snapshots and
streaming as the single-device placements do); and ``hotcold``, a
fixed-capacity hot tier a field beside the full tables, for streaming
training (``embed.hotcold``), with
the cold tier on the card (``cold_store="none"``) or in an out-of-core
host store planned one step ahead (``"mem"``/``"mmap"``,
``embed.migrate``)::

    bundle = store_for(cfg, path="sparse").make_bundle(cfg, hp, ...)
    params = bundle.prepare(params)
    state  = bundle.init(params)
    params, state, aux = bundle.step(params, state, batch)
    params, state = bundle.flush(params, state)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

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

MESH_PLACEMENTS = ("sharded", "sharded_sparse")


@dataclasses.dataclass(frozen=True)
class EmbeddingStore:
    """A chosen placement plus its placement-specific knobs."""

    placement: str = "dense"
    kernel: str = "substrate"     # dense only: "substrate" | "fused"
    hot_capacity: int = 4096      # hotcold only: hot rows per field
    cold_store: str = "none"      # hotcold only: "none" (cold tier on the
                                  # device, in the step) | "mem" | "mmap"
                                  # (out-of-core ColdStore + async
                                  # migration planner)
    cold_dir: Optional[str] = None  # hotcold/mmap only: table directory
    admission: str = "cumulative"   # hotcold only: "cumulative" | "decayed"
    half_life: int = 0              # hotcold/decayed only: steps per halving
    mesh: Any = None                # sharded only, required there: a
                                    # launch.mesh.CtrMesh
    partition: str = "div"          # sharded only: "div" | "mod"

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {self.placement!r}; "
                             f"expected one of {PLACEMENTS}")
        if self.cold_store not in ("none", "mem", "mmap"):
            raise ValueError(f"unknown cold_store {self.cold_store!r}; "
                             "expected 'none', 'mem', or 'mmap'")
        if self.cold_store != "none" and self.placement != "hotcold":
            raise ValueError("cold_store applies to the hotcold placement "
                             f"only (placement={self.placement!r})")
        if self.cold_store == "mmap" and not self.cold_dir:
            raise ValueError("cold_store='mmap' needs cold_dir "
                             "(the on-disk table directory)")
        if self.placement in MESH_PLACEMENTS and self.mesh is None:
            raise ValueError(
                f"the {self.placement} placement needs mesh= (a grid of "
                "repro_torch.launch.mesh.make_ctr_mesh, inside its "
                "process_group)")

    @property
    def path(self) -> str:
        """The ``TRAIN_PATHS`` name of this store."""
        return self.kernel if self.placement == "dense" else self.placement

    def describe(self) -> str:
        if self.placement in MESH_PLACEMENTS:
            detail = ("per-shard unique-id update, "
                      if self.placement == "sharded_sparse" else "")
            return (f"{self.placement}(rows over model={self.mesh.model}, "
                    f"batch over data={self.mesh.data}, {detail}"
                    f"{self.partition} partition)")
        if self.placement == "dense":
            return f"dense({self.kernel})"
        if self.placement == "hotcold":
            adm = (f"{self.admission}(half_life={self.half_life})"
                   if self.admission == "decayed" else self.admission)
            if self.cold_store != "none":
                return (f"hotcold({self.hot_capacity} hot rows/field, "
                        f"{adm} admission, async {self.cold_store} cold "
                        f"store)")
            return (f"hotcold({self.hot_capacity} hot rows/field, "
                    f"{adm} freq-ranked admission, cold host tier)")
        return self.placement

    def make_bundle(
        self,
        cfg,
        hp,
        *,
        clip_kind: str = "adaptive_column",
        r: float = 1.0,
        zeta: float = 1e-5,
        clip_t: float = 1.0,
        warmup_steps: int = 0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        nonfinite_guard: bool = False,
    ) -> TrainStepBundle:
        """Build this placement's bundle.

        The substrate takes any ``clip_kind`` of
        ``core.cowclip.CLIP_KINDS`` (``clip_t`` the constant clips'
        threshold); the fused kernel always applies CowClip, as the
        reference's fused path does; ``sparse`` and ``hotcold`` take
        "adaptive_column" (CowClip) or "none" (the ablation clips are
        substrate-only). ``nonfinite_guard`` skips any update whose batch
        loss is NaN/Inf, counted in ``aux["skipped_steps"]``, value-exact
        on clean data (on the sharded placements every rank takes the
        same flag, ``train.loop.make_sharded_train_step``); the async
        hotcold placement (a cold store) refuses it, as the reference
        does: its step fills host-side eviction handles and cannot be
        skipped.
        """
        from ..train import loop as loop_lib  # deferred: train imports core

        if self.path == "substrate":
            tx = builders.build_optimizer(
                hp, clip_kind=clip_kind, r=r, zeta=zeta, clip_t=clip_t,
                warmup_steps=warmup_steps, b1=b1, b2=b2, eps=eps)
            step = loop_lib.make_train_step(cfg, tx,
                                            nonfinite_guard=nonfinite_guard)
            return TrainStepBundle(step, tx.init, builders.identity_flush)

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
        clip = clip_kind == "adaptive_column"
        if self.placement == "sparse":
            step, init, flush = loop_lib.make_sparse_train_step(
                cfg, hp, r=r, zeta=zeta, dense_tx=dense_tx, clip=clip,
                b1=b1, b2=b2, eps=eps, nonfinite_guard=nonfinite_guard)
            return TrainStepBundle(step, init, flush)
        if self.placement in MESH_PLACEMENTS:
            make = (loop_lib.make_sharded_sparse_train_step
                    if self.placement == "sharded_sparse"
                    else loop_lib.make_sharded_train_step)
            return make(cfg, hp, self.mesh, scheme=self.partition, r=r,
                        zeta=zeta, dense_tx=dense_tx, clip=clip, b1=b1,
                        b2=b2, eps=eps, nonfinite_guard=nonfinite_guard)

        kw = dict(r=r, zeta=zeta, dense_tx=dense_tx, clip=clip, b1=b1,
                  b2=b2, eps=eps, admission=self.admission,
                  half_life=self.half_life)
        if self.cold_store != "none":
            from .migrate import make_async_hotcold_bundle

            if nonfinite_guard:
                raise ValueError(
                    "nonfinite_guard is not supported for the async hotcold "
                    "placement (cold_store='mem'/'mmap'): its step fills "
                    "host-side eviction handles and cannot be skipped")
            return make_async_hotcold_bundle(
                cfg, hp, backend=self.cold_store, directory=self.cold_dir,
                capacity=self.hot_capacity, **kw)
        from .hotcold import make_hotcold_train_step

        step, init, flush = make_hotcold_train_step(
            cfg, hp, capacity=self.hot_capacity,
            nonfinite_guard=nonfinite_guard, **kw)
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


def store_for(cfg, *, path: Optional[str] = None, mesh: Any = None,
              partition: str = "div", hot_capacity: int = 4096,
              cold_store: str = "none", cold_dir: Optional[str] = None,
              admission: str = "cumulative",
              half_life: int = 0) -> EmbeddingStore:
    """The store for a config: routes the train-path names and the
    config's ``placement`` onto one of the placements; the sharded and
    hotcold knobs are carried along (and validated) whatever the
    placement."""
    placement, kernel = _PATH_TO_STORE[resolve_path(cfg, path)]
    return EmbeddingStore(placement=placement, kernel=kernel, mesh=mesh,
                          partition=partition, hot_capacity=hot_capacity,
                          cold_store=cold_store, cold_dir=cold_dir,
                          admission=admission, half_life=half_life)
