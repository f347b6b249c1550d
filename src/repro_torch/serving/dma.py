"""Host<->device transfer accounting, the fetch ring and host staging
(PyTorch counterpart of ``repro.serving.dma``).

* ``TransferStats`` — counts every host<->device transfer the engine
  issues, split into *blocking* and *async*; ``host_blocked_fraction`` is
  the share of engine steps that stalled on a blocking transfer.
* ``FetchRing`` — the per-step device->host fetch (sampled tokens,
  telemetry, recovery requests).  Depth 1 is the async pipeline: ``push``
  starts the copies and the engine pops the entry one call later, so the
  copy overlaps the host work in between.  On a card the copies run on a
  side stream into pinned host buffers, one event an entry; on the CPU the
  same bookkeeping runs with plain copies.  Depth 0 is the synchronous
  baseline: the engine pops right after it pushes, and the pop is a
  blocking copy.
* ``HostStaging`` — reused host buffers for the boundary-tick pool
  transfers and the speculative thaw uploads, reallocated only when a
  shape changes; pinned on a card, with an event guarding each buffer
  that an async copy still reads.
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


def _host_dtype(dt: torch.dtype) -> torch.dtype:
    """numpy has no bfloat16: its bytes travel as int16 (``device.
    host_view``)."""
    return torch.int16 if dt == torch.bfloat16 else dt


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
    """Fetch ring of depth 0 or 1: ``push(meta, arrays)`` enqueues a step's
    tensors, ``pop()`` returns the oldest entry as numpy arrays.  Entries
    drain FIFO, so host bookkeeping is applied in push order whatever the
    depth — which is what makes async-vs-sync token parity exact.

    Depth 1 on a card: ``push`` clones each tensor on the compute stream
    (the decode step updates its state in place, so an entry must never
    alias a tensor the next step rewrites), makes the side copy stream wait
    for the compute stream, and copies the clones there into pinned host
    buffers with ``non_blocking`` copies, recording one event for the
    entry; ``pop`` waits on that event (timed as ``waited_s``) and returns
    the buffers to the pool.  Depth 1 on the CPU copies at push time.
    Either way the pop is an *async* transfer.  Depth 0 pops with a
    blocking copy.

    ``endpoint`` (a ``faults.Endpoint``, the ``ring`` injection point)
    guards each pop's materialisation: the wait for the entry's copy, the
    copy out and the return of its pinned buffers run inside the function
    the endpoint calls, so they run once however many injected attempts
    fail.  The engine drops ``depth`` to 0 while that endpoint's breaker
    is open; the FIFO drain keeps the fallback token-identical, and a pop
    is tallied as blocking or async by the depth at the pop."""

    def __init__(self, stats: TransferStats, depth: int = 0, device=None,
                 endpoint: Optional[Any] = None):
        if depth not in (0, 1):
            raise ValueError("the pipeline is single- or double-buffered")
        self.stats = stats
        self.depth = depth
        self.endpoint = endpoint
        self.device = torch.device("cpu" if device is None else device)
        self._stream: Optional[torch.cuda.Stream] = None
        self._free: Dict[Tuple, List[torch.Tensor]] = {}   # pinned buffers
        self._entries: List[Tuple[Dict[str, Any], Dict[str, Any], Any]] = []

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def _async_card(self) -> bool:
        return self.depth == 1 and self.device.type == "cuda"

    def _pinned(self, shape, dtype) -> torch.Tensor:
        free = self._free.get((tuple(shape), dtype))
        if free:
            return free.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def push(self, meta: Dict[str, Any], arrays: Dict[str, Any]) -> None:
        if self.depth == 0:
            self._entries.append((meta, arrays, None))
            return
        if not self._async_card:
            host = {k: v.detach().cpu().numpy().copy()
                    if isinstance(v, torch.Tensor) else np.asarray(v)
                    for k, v in arrays.items()}
            self._entries.append((meta, host, None))
            return
        compute = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        srcs = {k: v.detach().clone() for k, v in arrays.items()
                if isinstance(v, torch.Tensor)}
        bufs = {k: np.asarray(v) for k, v in arrays.items()
                if not isinstance(v, torch.Tensor)}
        self._stream.wait_stream(compute)
        with torch.cuda.stream(self._stream):
            for k, src in srcs.items():
                hd = _host_dtype(src.dtype)
                buf = self._pinned(src.shape, hd)
                buf.copy_(src.view(hd) if hd != src.dtype else src,
                          non_blocking=True)
                src.record_stream(self._stream)
                bufs[k] = buf
            done = torch.cuda.Event()
            done.record(self._stream)
        self._entries.append((meta, bufs, done))

    def pop(self) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """Return the oldest (meta, host arrays) entry."""
        if not self._entries:
            return None
        meta, arrays, done = self._entries.pop(0)
        t0 = time.perf_counter()

        def _materialize():
            if done is None:        # a depth-0 entry, or copied at push
                return {k: v.detach().cpu().numpy()
                        if isinstance(v, torch.Tensor) else np.asarray(v)
                        for k, v in arrays.items()}
            done.synchronize()
            host = {k: b.numpy().copy() if isinstance(b, torch.Tensor)
                    else b for k, b in arrays.items()}
            for b in arrays.values():         # its copy has landed
                if isinstance(b, torch.Tensor):
                    self._free.setdefault((tuple(b.shape), b.dtype),
                                          []).append(b)
            return host

        host = self.endpoint.call(_materialize) \
            if self.endpoint is not None else _materialize()
        dt = time.perf_counter() - t0
        nbytes = sum(_nbytes(v) for v in host.values())
        if self.depth == 0:
            self.stats.note_blocking(nbytes, d2h=True, seconds=dt)
        else:
            self.stats.note_async(nbytes, d2h=True, seconds=dt)
        return meta, host

    def drain(self):
        """Pop every pending entry (oldest first)."""
        while self._entries:
            yield self.pop()


class HostStaging:
    """Reused host staging buffers.

    ``buf(name, shape, dtype)`` returns a numpy buffer that persists across
    calls; it is reallocated only when the requested shape/dtype changes,
    so the steady-state boundary tick reuses the same allocation for its
    pulls.  ``pull(name, t)`` copies a tensor into the named buffer (bf16
    as its int16 bytes) and returns it.  With ``pinned=True`` (a card) the
    buffers are page-locked, ``tensor(name)`` is the buffer as a torch
    tensor for an async host-to-device copy, and ``fence(name, event)``
    marks the buffer as read by a copy in flight: the next ``buf`` of that
    name waits for the event, so a buffer is never rewritten under a copy.
    """

    def __init__(self, pinned: bool = False):
        self.pinned = pinned
        self._bufs: Dict[str, Any] = {}
        self._tensors: Dict[str, torch.Tensor] = {}
        self._fences: Dict[str, Any] = {}

    def buf(self, name: str, shape, dtype):
        fence = self._fences.pop(name, None)
        if fence is not None:
            fence.synchronize()
        b = self._bufs.get(name)
        if b is None or b.shape != tuple(shape) or b.dtype != np.dtype(dtype):
            if self.pinned:
                t = torch.from_numpy(np.empty(0, dtype))
                t = torch.empty(tuple(shape), dtype=t.dtype, pin_memory=True)
                self._tensors[name] = t
                b = t.numpy()
            else:
                b = np.empty(shape, dtype)
            self._bufs[name] = b
        return b

    def __getitem__(self, name: str) -> np.ndarray:
        return self._bufs[name]

    def tensor(self, name: str) -> torch.Tensor:
        """The named buffer as a tensor (pinned staging only)."""
        return self._tensors[name]

    def fence(self, name: str, event) -> None:
        self._fences[name] = event

    def pull(self, name: str, t: torch.Tensor) -> np.ndarray:
        """Blocking copy of ``t`` into the named buffer (straight into the
        pinned buffer on a card)."""
        hd = _host_dtype(t.dtype)
        src = t.detach().view(hd) if hd != t.dtype else t.detach()
        b = self.buf(name, src.shape, torch.empty(0, dtype=hd).numpy().dtype)
        if self.pinned:
            self._tensors[name].copy_(src)
        else:
            np.copyto(b, src.cpu().numpy())
        return b

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._bufs.values())
