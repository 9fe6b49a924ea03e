"""Batch-size scaling rules from the paper (Section 3, Tables 8-9).

Every rule maps base hyperparameters at reference batch size ``b`` to the
hyperparameters for batch size ``s * b``. Embedding and dense towers are kept
as separate groups because the paper's central finding is that they must scale
*differently*:

  no_scale     : lr, l2 unchanged (both groups)
  sqrt         : lr *= sqrt(s), l2 *= sqrt(s)         (Krizhevsky 14 / Hoffer 17)
  sqrt_star    : lr *= sqrt(s), l2 unchanged          (Guo et al. 18 variant)
  linear       : lr *= s, l2 unchanged                (Goyal et al. 17)
  n2_lambda    : emb lr fixed, emb l2 *= s^2; dense lr *= sqrt(s)   (Rule 4)
  cowclip      : emb lr fixed, emb l2 *= s;  dense lr *= sqrt(s)    (Rule 3)

The paper's empirical-scaling column (Table 8) equals ``n2_lambda``.

The port's own copy of ``repro.core.scaling`` (pure Python / NumPy), kept
verbatim so that ``repro_torch`` imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Hyperparams:
    """Per-group hyperparameters produced by a scaling rule."""

    emb_lr: float
    emb_l2: float
    dense_lr: float
    dense_l2: float
    batch_size: int

    def replace(self, **kw) -> "Hyperparams":
        return dataclasses.replace(self, **kw)


RULES = ("no_scale", "sqrt", "sqrt_star", "linear", "n2_lambda", "cowclip")


def scale_hyperparams(
    rule: str,
    *,
    base_lr: float,
    base_l2: float,
    base_batch: int,
    batch_size: int,
    base_dense_lr: float | None = None,
) -> Hyperparams:
    """Apply a named scaling rule to go from ``base_batch`` to ``batch_size``.

    ``base_dense_lr`` defaults to ``base_lr`` (the paper uses a larger dense
    LR for CowClip on Criteo, Table 9).
    """
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}; expected one of {RULES}")
    if batch_size % base_batch:
        raise ValueError("batch_size must be a multiple of base_batch")
    s = batch_size / base_batch
    dense_lr = base_dense_lr if base_dense_lr is not None else base_lr

    # Paper appendix: "no L2-regularization is imposed on dense weights" —
    # the L2 column in Tables 8-9 is the embedding lambda.
    if rule == "no_scale":
        return Hyperparams(base_lr, base_l2, dense_lr, 0.0, batch_size)
    if rule == "sqrt":
        f = math.sqrt(s)
        return Hyperparams(base_lr * f, base_l2 * f, dense_lr * f, 0.0, batch_size)
    if rule == "sqrt_star":
        f = math.sqrt(s)
        return Hyperparams(base_lr * f, base_l2, dense_lr * f, 0.0, batch_size)
    if rule == "linear":
        return Hyperparams(base_lr * s, base_l2, dense_lr * s, 0.0, batch_size)
    if rule == "n2_lambda":
        # Rule 4: eta_e fixed, lambda_e *= s^2, dense sqrt-scaled.
        return Hyperparams(
            base_lr, base_l2 * s * s, dense_lr * math.sqrt(s), 0.0, batch_size
        )
    # rule == "cowclip": Rule 3 — eta_e fixed, lambda_e *= s, dense sqrt-scaled.
    return Hyperparams(
        base_lr, base_l2 * s, dense_lr * math.sqrt(s), 0.0, batch_size
    )
