"""Deterministic fault injection for robustness tests
(``repro_torch.testing.faults``)."""

from .faults import (  # noqa: F401
    FAULT_PLAN_ENV,
    FaultPlan,
    install_coldstore_faults,
    kill_now,
    transient_oserror_hook,
)
