"""Deterministic fault injection for crash/IO robustness testing.

The port's own copy of ``repro.testing.faults`` (standard library and
NumPy only), under the same environment variable, so one plan arms a
trainer of either package.

Everything here is seeded and replayable: a ``FaultPlan`` describes the
faults one run should suffer — kill the process at training step *k*
(optionally in the middle of a snapshot write, after the temp files exist
but before the rename that makes the snapshot valid), raise transient
``OSError``s from the ColdStore's I/O entry points, raise inside the
``ChunkStream`` worker, corrupt event rows — and two identically-planned
runs suffer identical faults. Plans cross process boundaries through one
environment variable (``REPRO_FAULT_PLAN``, JSON), which is how the test
suite arms a subprocess trainer launched via ``repro_torch.launch.train``:

    plan = FaultPlan(kill_at_step=11)
    env = {**os.environ, **plan.to_env()}
    subprocess.run([... "-m", "repro_torch.launch.train", ...], env=env)

The trainer's snapshot hook checks ``should_kill(step)`` at each step
boundary and SIGKILLs itself — no cooperation from signal handlers, the
hardest crash shape short of pulling power.

``install_coldstore_faults`` arms a live ``ColdStore`` with a seeded
transient-``OSError`` hook; the store's own bounded-retry/backoff policy
(``ColdStore._io``) must absorb them, counted in ``faults_retried``.
``corrupt_tsv_line`` mangles raw TSV rows the way real log corruption
does (truncated fields, non-integer ids, out-of-range hash values) so the
``follow_tsv_events`` quarantine path is exercised with known-bad rows.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
from typing import Dict, Optional

import numpy as np

__all__ = ["FAULT_PLAN_ENV", "FaultPlan", "install_coldstore_faults",
           "kill_now", "transient_oserror_hook"]

FAULT_PLAN_ENV = "REPRO_FAULT_PLAN"


def kill_now():
    """SIGKILL the current process — no cleanup, no atexit, no flushing;
    the crash shape every durability claim must survive."""
    os.kill(os.getpid(), signal.SIGKILL)


@dataclasses.dataclass
class FaultPlan:
    """One run's deterministic fault schedule.

    kill_at_step: SIGKILL the trainer when this training step completes
        (the snapshot hook checks after its own bookkeeping, so a kill at
        a snapshot boundary lands *after* that snapshot is taken unless
        ``kill_in_snapshot`` is set).
    kill_in_snapshot: land the kill *inside* the snapshot write at
        ``kill_at_step`` — after the payload temp files are written but
        before the atomic rename publishes the snapshot, leaving a torn
        ``*.tmp`` directory a resume must ignore.
    io_errors: per-op transient-OSError budget for an armed ColdStore,
        e.g. ``{"gather": 2, "scatter": 1}`` — the first N calls of that
        op raise once each before succeeding on retry.
    io_error_every: instead of a fixed budget, fail each op call with
        probability 1/``io_error_every`` from the plan's seeded RNG
        (0 disables).
    stream_raise_at_chunk: raise ``RuntimeError`` inside the ChunkStream
        worker when the transform sees this chunk index (arm via
        ``stream_transform_hook``).
    corrupt_row_rate: probability an event row fed through
        ``corrupt_tsv_line`` is mangled (seeded).
    seed: RNG seed for the probabilistic knobs.
    """

    kill_at_step: Optional[int] = None
    kill_in_snapshot: bool = False
    io_errors: Optional[Dict[str, int]] = None
    io_error_every: int = 0
    stream_raise_at_chunk: Optional[int] = None
    corrupt_row_rate: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._io_budget = dict(self.io_errors or {})

    # -- process-boundary plumbing ------------------------------------------

    def to_env(self) -> Dict[str, str]:
        """The environment fragment that arms a subprocess with this plan."""
        return {FAULT_PLAN_ENV: json.dumps({
            k: v for k, v in dataclasses.asdict(self).items()
            if not k.startswith("_")})}

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """The plan armed in this process's environment, if any."""
        raw = os.environ.get(FAULT_PLAN_ENV)
        if not raw:
            return None
        return cls(**json.loads(raw))

    # -- fault predicates ----------------------------------------------------

    def should_kill(self, step: int) -> bool:
        return self.kill_at_step is not None and step >= self.kill_at_step

    def maybe_kill(self, step: int, *, in_snapshot: bool = False):
        """SIGKILL if the plan says so. ``in_snapshot=True`` is the
        mid-snapshot-write call site; a plan with ``kill_in_snapshot``
        fires only there, otherwise only at the step boundary."""
        if not self.should_kill(step):
            return
        if in_snapshot == self.kill_in_snapshot:
            kill_now()

    def io_fault(self, op: str) -> bool:
        """Consume one fault for ``op`` if the plan has any left."""
        if self._io_budget.get(op, 0) > 0:
            self._io_budget[op] -= 1
            return True
        if self.io_error_every > 0:
            return bool(self._rng.random() < 1.0 / self.io_error_every)
        return False

    def corrupt_row(self) -> bool:
        return (self.corrupt_row_rate > 0
                and bool(self._rng.random() < self.corrupt_row_rate))

    # -- injectors -----------------------------------------------------------

    def coldstore_hook(self):
        """A ``ColdStore.fault_hook`` raising this plan's transient
        OSErrors (deterministic given the plan)."""

        def hook(op: str):
            if self.io_fault(op):
                raise OSError(f"injected transient {op} fault")

        return hook

    def stream_transform_hook(self, inner=None):
        """A ChunkStream ``transform`` that raises on the worker thread at
        ``stream_raise_at_chunk`` and otherwise delegates to ``inner``
        (identity by default) — exercises the worker-failure re-raise
        contract."""
        seen = [0]

        def transform(chunk):
            if (self.stream_raise_at_chunk is not None
                    and seen[0] == self.stream_raise_at_chunk):
                raise RuntimeError(
                    f"injected stream-worker fault at chunk {seen[0]}")
            seen[0] += 1
            return chunk if inner is None else inner(chunk)

        return transform

    def corrupt_tsv_line(self, line: str, n_fields: int) -> str:
        """Mangle one TSV row the way real log corruption does; returns
        the line unchanged when the seeded coin says so."""
        if not self.corrupt_row():
            return line
        cells = line.split("\t")
        mode = int(self._rng.integers(3))
        if mode == 0:                       # wrong field count (truncation)
            cells = cells[: max(1, len(cells) // 2)]
        elif mode == 1:                     # non-numeric id cell
            cells[-1] = "garbage"
        else:                               # out-of-range hash value
            cells[-n_fields] = str(1 << 40)
        return "\t".join(cells)


def transient_oserror_hook(fails_per_op: Dict[str, int]):
    """The simplest deterministic hook: op -> remaining failures; each
    armed op raises once per call until its budget is spent."""
    budget = dict(fails_per_op)

    def hook(op: str):
        if budget.get(op, 0) > 0:
            budget[op] -= 1
            raise OSError(f"injected transient {op} fault")

    return hook


def install_coldstore_faults(store, plan: FaultPlan):
    """Arm a live ColdStore with ``plan``'s transient I/O faults; returns
    the store (its retry/backoff policy plus ``faults_retried`` counter
    absorb and account for them)."""
    store.fault_hook = plan.coldstore_hook()
    return store
