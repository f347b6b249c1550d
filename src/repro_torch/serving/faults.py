"""The fault types the host paging code raises and checks (a copy of the
part of ``repro.serving.faults`` that ``PagedController`` uses).  Chaos
injection itself is not ported yet: the engine never wires a stash
endpoint, so ``PagedController.stash_endpoint`` stays ``None``."""
from __future__ import annotations

# what a best-effort guarded call returns when its injected attempts fail
FAILED = object()


class InjectedFault(RuntimeError):
    """A scheduled fault, surfaced past an endpoint's retry budget."""

    def __init__(self, site: str, msg: str):
        super().__init__(f"[{site}] {msg}")
        self.site = site


class StashAllocError(InjectedFault):
    """Host-stash allocation failure (the ``stash`` site)."""
