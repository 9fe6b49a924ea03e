"""What a family's window driver hands back to the harness."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class RunRecord:
    """One run of a cell: the end-to-end readings (``e2e``, by metric
    name), the window's counts, the traced stretch (``stretch``, a
    ``trace.Stretch``, or None untraced) with what its steps asked of the
    layers (``work``), and the comparison that decides ``correct``."""

    family: str
    setup_s: float
    window_s: float
    steps: int
    failed: int
    peak_bytes: int
    e2e: dict
    input_wait_s: float = 0.0
    stretch: Any = None
    work: dict = dataclasses.field(default_factory=dict)
    correct: bool = False
    checks: dict = dataclasses.field(default_factory=dict)
    gaps: Optional[dict] = None
    # what the run printed on standard error beside its result: the parts
    # of its set-up, its window's counts
    notes: dict = dataclasses.field(default_factory=dict)
