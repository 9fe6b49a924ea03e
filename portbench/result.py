"""The result line of a run, from its ``RunRecord``."""

from __future__ import annotations

import json
import sys

import torch

from . import trace as trace_lib
from .manifest import metric_reader


def device_info(record, traced: bool) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": int(record.peak_bytes)}
    stretch = record.stretch
    if traced and stretch is not None and stretch.done:
        out["busy_s"] = trace_lib.busy_s(stretch.events)
        out["window_s"] = stretch.wall_s
    return out


def line(manifest, cell: dict, config: dict, traffic: dict, record,
         traced: bool) -> dict:
    name = cell["name"]
    metrics = {}
    if not traced:
        for m in manifest.metrics(name, "end_to_end"):
            metrics[m["name"]] = {"value": record.e2e[m["name"]],
                                  "unit": m["unit"]}
    elif record.stretch is not None and record.stretch.done:
        for m in manifest.metrics(name, "per_layer"):
            value = metric_reader(m["name"])(record, config, traffic)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(record.correct), "attempted": record.steps,
           "failed": record.failed, "metrics": metrics,
           "device": device_info(record, traced)}
    if traced and record.stretch is not None and record.stretch.done:
        events = record.stretch.events
        out["breakdown"] = {
            "device_ops": trace_lib.device_ops(events),
            "idle_gaps": trace_lib.idle_gaps(events, record.stretch.spans)}
    out["checks"] = record.checks
    return out


def emit(out: dict, record) -> None:
    """The run's notes and gaps, then each compared number beside its
    limit as the last lines on standard error; then the result as the last
    line on standard output."""
    print(f"notes: {json.dumps(record.notes)}", file=sys.stderr)
    print(f"gaps: {json.dumps(record.gaps)}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
