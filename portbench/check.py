"""The comparison that decides ``correct`` for a training cell.

The port's first steps and the reference's, from the same weights on the
same batches, are compared by three numbers, each the worst case of its
kind:

* ``loss_gap``: over the steps, ``|loss - loss_ref| / |loss_ref|``;
* ``grad_norm_gap``: over the leaves, the gap between the norm of the
  first step's gradient as the optimizer takes it and the reference's,
  over the larger of the reference's norm of that leaf and of the median
  leaf;
* ``change_norm_gap``: the same for the norm of each leaf's change over
  the steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone);
* ``grad_norm_gap_median`` and ``change_norm_gap_median``: the median
  leaf's gap of each, steady from seed to seed where a few leaves are
  ill-conditioned (``PERF.md`` says where a cell compares them).

A gap of norms, not the norm of a difference: Adam's first steps move a
weight by about the learning rate whatever the size of its gradient, so
the sign of a gradient that is nought to rounding decides a direction,
while the norms hold. Each cell compares the numbers its limits file
(``limits/<cell>.json``) names, with limits set from measured readings
(``PERF.md``); every number is printed.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

NAMES = ("loss_gap", "grad_norm_gap", "change_norm_gap",
         "grad_norm_gap_median", "change_norm_gap_median")
ROUND_OFF = 1e-3   # a leaf whose gradient is under this share of the
                   # median leaf's moves by round-off alone


def _median(values):
    vals = sorted(values)
    n = len(vals)
    return 0.5 * (vals[(n - 1) // 2] + vals[n // 2])


def _gaps(got: dict, want: dict, names, floor: float) -> dict:
    """Each leaf's gap of norms over the larger of its reference norm and
    ``floor``; a leaf the port does not report reads NaN."""
    out = {}
    for name in names:
        a, b = got.get(name, math.nan), want[name]
        out[name] = (abs(a - b) / max(b, floor) if max(b, floor) > 0
                     else abs(a - b))
    return out


def _worst(gaps: dict):
    worst, where = 0.0, None
    for name, gap in gaps.items():
        if not gap <= worst:          # a NaN is the worst
            worst, where = gap, name
            if math.isnan(gap):
                break
    return worst, where


def _median_gap(gaps: dict) -> float:
    vals = list(gaps.values())
    return math.nan if any(math.isnan(v) for v in vals) else _median(vals)


def training_gaps(got: dict, want: dict) -> dict:
    """The three gaps of ``got`` (the port's readings) against ``want``
    (the reference's), each ``{"value", "leaf"}``."""
    losses = [abs(a - b) / abs(b) if b else abs(a - b)
              for a, b in zip(got["losses"], want["losses"])]
    if len(got["losses"]) != len(want["losses"]):
        losses.append(math.nan)
    loss_gap = max(losses, key=lambda x: math.inf if math.isnan(x) else x)
    grads = want["grad"]
    med = _median(grads.values())
    grad = _gaps(got["grad"], grads, grads, med)
    kept = [k for k, v in grads.items() if v >= ROUND_OFF * med]
    change = want["change"]
    change = _gaps(got["change"], change, kept,
                   _median([change[k] for k in kept]))
    (grad_gap, grad_leaf), (change_gap, change_leaf) = (_worst(grad),
                                                        _worst(change))
    return {"loss_gap": {"value": loss_gap, "leaf": None},
            "grad_norm_gap": {"value": grad_gap, "leaf": grad_leaf},
            "change_norm_gap": {"value": change_gap, "leaf": change_leaf},
            "grad_norm_gap_median": {"value": _median_gap(grad),
                                     "leaf": None},
            "change_norm_gap_median": {"value": _median_gap(change),
                                       "leaf": None},
            "left_out": sorted(set(grads) - set(kept))}


def load_limits(root: Path, cell: str) -> dict:
    """The cell's limits, ``{name: limit}``; an absent file gives none,
    and a run without limits is not correct."""
    path = root / "limits" / f"{cell}.json"
    if not path.exists():
        return {}
    return {k: float(v) for k, v in json.loads(path.read_text())[
        "limits"].items()}


def judge(gaps: dict, limits: dict):
    """``(correct, checks)``: each number the cell's limits name, beside
    its limit; correct when there are limits and every such number is at
    most its limit."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = gaps[name]["value"]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, checks
