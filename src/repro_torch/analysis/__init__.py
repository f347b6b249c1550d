"""Runtime checks of the port's serving stack (PyTorch counterpart of
``repro.analysis``): the invariant auditor that the paged engine runs at
its boundary ticks under ``ServingConfig.debug_invariants``."""
from .invariants import InvariantViolation, audit_boundary, audit_controller

__all__ = ["InvariantViolation", "audit_boundary", "audit_controller"]
