"""Host<->device transfer accounting and the synchronous fetch ring
(PyTorch counterpart of ``repro.serving.dma``).

* ``TransferStats`` — counts every host<->device transfer the engine
  issues, split into *blocking* and *async*; ``host_blocked_fraction`` is
  the share of engine steps that stalled on a blocking transfer.
* ``FetchRing`` — the per-step device->host fetch (sampled tokens,
  telemetry, recovery requests).  This slice ports depth 0 only, the
  synchronous pipeline: the engine pops right after it pushes, and the pop
  is a blocking copy to numpy.  The async depth-1 ring on CUDA streams is a
  later slice.
* ``HostStaging`` — reused host buffers for the boundary-tick pool
  transfers, reallocated only when a shape changes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _nbytes(x) -> int:
    try:
        return int(x.nbytes)
    except Exception:                      # scalars / python ints
        return 0


@dataclasses.dataclass
class TransferStats:
    """Counts every host<->device transfer an engine issues.

    *Blocking* transfers stall the host: a direct ``device_get`` /
    ``device_put`` whose data was not already in flight (boundary-tick pool
    pulls, un-prefetched thaw uploads, depth-0 ring pops).  *Async*
    transfers were issued ahead of use (ring fetches, speculative thaw
    staging) — the host may still wait on them at consume time, but the
    wait is overlap-compensated and recorded separately as ``waited_s``.
    """
    blocking_d2h: int = 0
    blocking_h2d: int = 0
    async_d2h: int = 0
    async_h2d: int = 0
    d2h_bytes: int = 0
    h2d_bytes: int = 0
    blocked_s: float = 0.0      # host time inside blocking transfers
    waited_s: float = 0.0       # host time waiting on async-issued data
    steps: int = 0              # engine steps observed (begin/end bracket)
    blocked_steps: int = 0      # steps with >= 1 blocking transfer
    _step_open: bool = dataclasses.field(default=False, repr=False)
    _step_blocked: bool = dataclasses.field(default=False, repr=False)

    # ---- per-step bracketing ---------------------------------------- #
    def begin_step(self) -> None:
        self._step_open = True
        self._step_blocked = False

    def end_step(self) -> None:
        if not self._step_open:
            return
        self.steps += 1
        if self._step_blocked:
            self.blocked_steps += 1
        self._step_open = False

    def cancel_step(self) -> None:
        """Close the bracket without counting it (no jitted step ran —
        e.g. a drain-only or prefill-only engine call)."""
        self._step_open = False

    # ---- transfer notes --------------------------------------------- #
    def note_blocking(self, nbytes: int, d2h: bool, seconds: float = 0.0
                      ) -> None:
        if d2h:
            self.blocking_d2h += 1
            self.d2h_bytes += nbytes
        else:
            self.blocking_h2d += 1
            self.h2d_bytes += nbytes
        self.blocked_s += seconds
        if self._step_open:
            self._step_blocked = True

    def note_async(self, nbytes: int, d2h: bool, seconds: float = 0.0
                   ) -> None:
        if d2h:
            self.async_d2h += 1
            self.d2h_bytes += nbytes
        else:
            self.async_h2d += 1
            self.h2d_bytes += nbytes
        self.waited_s += seconds

    # ---- derived metrics -------------------------------------------- #
    @property
    def host_blocked_fraction(self) -> float:
        """Share of engine steps that stalled on a blocking transfer."""
        return self.blocked_steps / self.steps if self.steps else 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {
            "blocking_d2h": self.blocking_d2h,
            "blocking_h2d": self.blocking_h2d,
            "async_d2h": self.async_d2h,
            "async_h2d": self.async_h2d,
            "d2h_bytes": self.d2h_bytes,
            "h2d_bytes": self.h2d_bytes,
            "blocked_s": round(self.blocked_s, 4),
            "waited_s": round(self.waited_s, 4),
            "steps": self.steps,
            "blocked_steps": self.blocked_steps,
            "host_blocked_fraction": round(self.host_blocked_fraction, 4),
        }


class FetchRing:
    """Depth-0 device->host fetch ring: ``push(meta, arrays)`` enqueues a
    step's tensors, ``pop()`` materializes the oldest entry to numpy (a
    blocking copy).  Entries drain FIFO, so host bookkeeping is applied in
    push order."""

    def __init__(self, stats: TransferStats, depth: int = 0):
        if depth != 0:
            raise NotImplementedError(
                "only the synchronous (depth-0) ring is ported")
        self.stats = stats
        self.depth = depth
        self._entries: List[Tuple[Dict[str, Any], Dict[str, Any]]] = []

    def push(self, meta: Dict[str, Any], arrays: Dict[str, Any]) -> None:
        self._entries.append((meta, arrays))

    def pop(self) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """Materialize and return the oldest (meta, host arrays) entry."""
        if not self._entries:
            return None
        meta, arrays = self._entries.pop(0)
        t0 = time.perf_counter()
        host = {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in arrays.items()}
        dt = time.perf_counter() - t0
        nbytes = sum(_nbytes(v) for v in host.values())
        self.stats.note_blocking(nbytes, d2h=True, seconds=dt)
        return meta, host

    def drain(self):
        """Pop every pending entry (oldest first)."""
        while self._entries:
            yield self.pop()


class HostStaging:
    """Reused host staging buffers (the pinned-memory stand-in).

    ``buf(name, shape, dtype)`` returns a numpy buffer that persists across
    calls; it is reallocated only when the requested shape/dtype changes,
    so the steady-state boundary tick reuses the same allocation for its
    pull/push staging.  ``put(name, src)`` copies ``src`` into the named
    buffer and returns it.
    """

    def __init__(self):
        self._bufs: Dict[str, Any] = {}

    def buf(self, name: str, shape, dtype):
        b = self._bufs.get(name)
        if b is None or b.shape != tuple(shape) or b.dtype != np.dtype(dtype):
            b = np.empty(shape, dtype)
            self._bufs[name] = b
        return b

    def put(self, name: str, src):
        b = self.buf(name, src.shape, src.dtype)
        np.copyto(b, src)
        return b

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._bufs.values())
