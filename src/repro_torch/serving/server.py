"""Multi-tenant streaming server front end over the SLO scheduler (the
port's copy of ``repro.serving.server``; stdlib, numpy and the port).

Two layers:

``AsyncServingEngine``
    An asyncio facade over one ``Scheduler`` (and through it one engine).
    The scheduler and the engines are synchronous and single-threaded, so
    the facade runs a **strict alternation** serve loop: apply every
    pending operation (submits, cancels, pause/release decisions) on the
    event-loop thread, pump freshly committed tokens into the per-request
    streams, then run exactly one ``Scheduler.step`` in the default
    executor.  Handlers never touch the scheduler directly: they append
    an op and await a future, so no locks exist; the scheduler is touched
    either by ``_apply_ops`` / ``_pump_all`` (loop thread, between steps)
    or by ``step`` (executor thread), never both.

    All device work stays inside ``Scheduler.step``.  The pump reads host
    state only (``Lane.generated``, ``LaneSnapshot.generated``,
    ``Scheduler.done``'s numpy results), so the loop thread issues no
    device copy and no synchronize.  Consecutive steps may run on
    different executor threads; that is safe because the engines launch
    on PyTorch's current stream, which is the device's default stream on
    every thread, and their side streams and events are objects they own.

    *Streaming*: each request gets a ``RequestStream``, a **bounded**
    ``asyncio.Queue`` of events (``token`` / ``rewind`` / terminal).
    Rewalk rewinds and quarantine rewinds shrink a lane's committed prefix
    mid-decode, so the protocol has a ``rewind`` event telling the
    consumer to truncate: the streamed output is the *committed*
    sequence, identical to the batch path's final result.

    *Backpressure*: a slow consumer fills its queue; the serve loop then
    parks the request through ``Scheduler.pause`` (suspend the lane, hold
    the snapshot *outside* the queue), so the lane serves someone else,
    and releases it the moment the consumer drains to half capacity.

    *Cancellation*: client disconnects go to ``Scheduler.cancel``
    (suspend and drop): the lane frees, exported stash bytes return, no
    scheduler entry is stranded.

``ServingServer``
    A stdlib HTTP/1.1 server (``asyncio.start_server`` and hand-parsed
    requests).  ``POST /v1/generate`` streams Server-Sent Events; the
    tenant comes from the ``X-Tenant`` header (or the JSON body), and a
    client that disconnects mid-stream (reader EOF or a broken write)
    cancels its request.  ``GET /v1/health`` and ``GET /v1/stats`` expose
    the engine, ladder and tenancy state.

Prompts are token-id lists: the repo serves models, not tokenizers.
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, List, Optional, Union

import numpy as np

import torch

from repro_torch.serving.engine import LaneSnapshot, Request, RequestStatus
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler

DEFAULT_STREAM_CAPACITY = 64


class RequestStream:
    """Async iterator over one request's event stream.

    Events are dicts: ``{"event": "token", "index": i, "token": t}``,
    ``{"event": "rewind", "to": n}`` (truncate to the first ``n``
    tokens), and one terminal ``{"event": "done", "status": ...,
    "tokens": [...]}``.  The queue is bounded — not consuming it
    eventually pauses the request (see module docstring), it never
    grows without limit."""

    def __init__(self, uid: int, capacity: int = DEFAULT_STREAM_CAPACITY,
                 wake: Optional[asyncio.Event] = None):
        self.uid = uid
        self.queue: asyncio.Queue = asyncio.Queue(capacity)
        self.capacity = capacity
        self._wake = wake
        self._terminal = False

    def __aiter__(self) -> "RequestStream":
        return self

    async def __anext__(self) -> Dict[str, Any]:
        if self._terminal:
            raise StopAsyncIteration
        ev = await self.queue.get()
        if self._wake is not None:
            # tell the serve loop a slot freed — it may be sleeping idle
            # with this stream's remaining events still un-pumped
            self._wake.set()
        if ev["event"] == "done":
            self._terminal = True
        return ev

    async def collect(self) -> Dict[str, Any]:
        """Drain to the terminal event, replaying token/rewind events into
        a committed-token list; returns the terminal event with the
        replayed ``streamed`` sequence attached (must equal ``tokens`` —
        the streaming-parity invariant)."""
        toks: List[int] = []
        async for ev in self:
            if ev["event"] == "token":
                assert ev["index"] == len(toks), (ev, len(toks))
                toks.append(ev["token"])
            elif ev["event"] == "rewind":
                del toks[ev["to"]:]
            else:
                ev = dict(ev)
                ev["streamed"] = toks
                return ev
        raise RuntimeError("stream ended without a terminal event")


class _StreamState:
    __slots__ = ("stream", "sent", "paused", "want_pause")

    def __init__(self, stream: RequestStream):
        self.stream = stream
        self.sent = 0                 # tokens already delivered
        self.paused: Optional[Union[Request, LaneSnapshot]] = None
        self.want_pause = False


class AsyncServingEngine:
    """Asyncio facade over a ``Scheduler``.  Construct with a ready
    scheduler (tenancy attached there), ``await start()``, then
    ``submit``/``cancel``/``stats`` from any coroutine.  ``await
    close()`` drains nothing — it stops the loop; cancel requests first
    if you need clean terminal events."""

    def __init__(self, sched: Scheduler,
                 stream_capacity: int = DEFAULT_STREAM_CAPACITY):
        self.sched = sched
        self.stream_capacity = stream_capacity
        self.unhandled_exceptions = 0
        self.n_paused = 0
        self.n_resumed = 0
        self._streams: Dict[int, _StreamState] = {}
        self._ops: List[tuple] = []
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._running = False

    # ---------------- public coroutine API ---------------- #
    async def start(self) -> None:
        assert self._task is None, "already started"
        self._wake = asyncio.Event()
        self._running = True
        self._task = asyncio.get_running_loop().create_task(
            self._serve_loop())

    async def close(self) -> None:
        self._running = False
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None

    def _op(self, kind: str, payload) -> "asyncio.Future":
        fut = asyncio.get_running_loop().create_future()
        self._ops.append((kind, payload, fut))
        self._wake.set()
        return fut

    async def submit(self, prompt, n_tokens: int,
                     sampling: SamplingParams = SamplingParams.greedy(),
                     priority: int = 0,
                     deadline_ms: Optional[float] = None,
                     slo_tokens_per_s: Optional[float] = None,
                     tenant: Optional[str] = None) -> RequestStream:
        """Enqueue a request; resolves once the scheduler accepted it,
        returning the event stream (``stream.uid`` is the request id)."""
        kw = dict(prompt=np.asarray(prompt, np.int32), n_tokens=n_tokens,
                  sampling=sampling, priority=priority,
                  deadline_ms=deadline_ms,
                  slo_tokens_per_s=slo_tokens_per_s, tenant=tenant)
        return await self._op("submit", kw)

    async def cancel(self, uid: int) -> bool:
        """Client went away: cancel ``uid`` (False = already finished)."""
        return await self._op("cancel", uid)

    async def stats(self) -> Dict[str, Any]:
        return await self._op("stats", None)

    # ---------------- serve loop (event-loop thread) ---------------- #
    async def _serve_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            try:
                self._apply_ops()
                self._pump_all()
            except Exception:
                self.unhandled_exceptions += 1
            if not self._running and not self._ops:
                return
            if self.sched.queue or self.sched.busy:
                try:
                    await loop.run_in_executor(None, self.sched.step)
                except Exception:
                    self.unhandled_exceptions += 1
                # yield so handlers queued behind the step get a slice
                await asyncio.sleep(0)
            else:
                # fully idle (streams may still be draining client-side):
                # sleep until an op arrives
                await self._wake.wait()
                self._wake.clear()

    def _apply_ops(self) -> None:
        ops, self._ops = self._ops, []
        for kind, payload, fut in ops:
            try:
                if kind == "submit":
                    uid = self.sched.submit(**payload)
                    stream = RequestStream(uid, self.stream_capacity,
                                           wake=self._wake)
                    self._streams[uid] = _StreamState(stream)
                    fut.set_result(stream)
                elif kind == "cancel":
                    fut.set_result(self._cancel(payload))
                elif kind == "stats":
                    fut.set_result(self._stats())
                else:                      # pragma: no cover
                    raise AssertionError(kind)
            except Exception as e:
                self.unhandled_exceptions += 1
                if not fut.done():
                    fut.set_exception(e)
        self._apply_backpressure()

    def _cancel(self, uid: int) -> bool:
        st = self._streams.get(uid)
        if st is not None and st.paused is not None:
            # the request is parked in OUR hand, not the scheduler's
            # queue: give it back first so cancel finds it
            self.sched.release(st.paused)
            st.paused = None
        ok = self.sched.cancel(uid)
        # terminal event (cancelled or already-done) flows via _pump_all
        return ok

    def _stats(self) -> Dict[str, Any]:
        s = self.sched
        out: Dict[str, Any] = {
            "active_lanes": s.engine.n_active_lanes,
            "queued": len(s.queue),
            "done": len(s.done),
            "streams": len(self._streams),
            "n_preemptions": s.n_preemptions,
            "n_preempt_skipped_cost": s.n_preempt_skipped_cost,
            "n_cancelled": s.n_cancelled,
            "n_paused": self.n_paused,
            "n_resumed": self.n_resumed,
            "unhandled_exceptions": self.unhandled_exceptions,
            "preempt_cost_s": s.preempt_cost_s(),
            "step_s": s._step_s,
        }
        if s.tenancy is not None:
            out["tenants"] = s.tenancy.snapshot()
        return out

    # ---------------- pumping + backpressure ---------------- #
    def _committed(self, uid: int, st: _StreamState) -> List[int]:
        """The uid's committed token list right now, wherever it lives:
        our paused hand, a running lane, or a queued entry (a suspended
        victim's snapshot; plain queued requests have no tokens yet)."""
        if st.paused is not None:
            item = st.paused
            return list(item.generated) \
                if isinstance(item, LaneSnapshot) else []
        for l in self.sched.engine.lanes:
            if l.request is not None and l.request.uid == uid:
                return list(l.generated)
        for e in self.sched.queue:
            item = e[-1]
            req = item.req if isinstance(item, LaneSnapshot) else item
            if req.uid == uid:
                return list(item.generated) \
                    if isinstance(item, LaneSnapshot) else []
        return []                          # e.g. paged over-prefill

    def _emit(self, st: _StreamState, toks: List[int]) -> bool:
        """Push the un-sent suffix of ``toks`` (after any rewind) into the
        stream without blocking; returns False when the queue filled."""
        q = st.stream.queue
        if len(toks) < st.sent:
            try:
                q.put_nowait({"event": "rewind", "to": len(toks)})
            except asyncio.QueueFull:
                return False
            st.sent = len(toks)
        while st.sent < len(toks):
            try:
                q.put_nowait({"event": "token", "index": st.sent,
                              "token": int(toks[st.sent])})
            except asyncio.QueueFull:
                return False
            st.sent += 1
        return True

    def _pump_all(self) -> None:
        for uid, st in list(self._streams.items()):
            req = self.sched.done.get(uid)
            if req is not None:
                final = [] if req.result is None \
                    else [int(t) for t in req.result]
                if self._emit(st, final) and not st.stream.queue.full():
                    st.stream.queue.put_nowait({
                        "event": "done", "status": str(req.status),
                        "tokens": final})
                    del self._streams[uid]
                continue
            if not self._emit(st, self._committed(uid, st)) \
                    and st.paused is None:
                st.want_pause = True       # consumer is behind: park it

    def _apply_backpressure(self) -> None:
        for uid, st in self._streams.items():
            if st.want_pause and st.paused is None:
                st.want_pause = False
                item = self.sched.pause(uid)
                if item is not None:
                    st.paused = item
                    self.n_paused += 1
            elif st.paused is not None and \
                    st.stream.queue.qsize() <= st.stream.capacity // 2:
                # consumer drained: hand the snapshot back to the queue
                self.sched.release(st.paused)
                st.paused = None
                self.n_resumed += 1
                self._wake.set()


# ===================== HTTP front end ===================== #

_JSON = {"Content-Type": "application/json"}
_SSE = {"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}


def _sse(event: str, data: Dict[str, Any]) -> bytes:
    return (f"event: {event}\ndata: {json.dumps(data)}\n\n").encode()


class ServingServer:
    """stdlib HTTP/1.1 + SSE front end over an ``AsyncServingEngine``.

    Endpoints::

        POST /v1/generate   {"prompt": [ints], "n_tokens": n, ...}
                            -> text/event-stream of token/rewind/done
        GET  /v1/health     -> engine health + robustness snapshot
        GET  /v1/stats      -> scheduler/tenancy/server counters

    Tenant identity: ``X-Tenant`` header, else ``"tenant"`` in the JSON
    body, else untenanted.  Sampling: ``{"greedy": true}`` (default) or
    ``temperature``/``top_k``/``top_p``.  A client that disconnects
    mid-stream cancels its request (freeze-native suspend + drop)."""

    def __init__(self, engine: AsyncServingEngine,
                 host: str = "127.0.0.1", port: int = 8777):
        self.engine = engine
        self.host, self.port = host, port
        self._srv: Optional[asyncio.base_events.Server] = None

    async def start(self) -> None:
        await self.engine.start()
        self._srv = await asyncio.start_server(self._handle, self.host,
                                               self.port)
        # port=0 support: report the bound port back
        self.port = self._srv.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._srv is not None:
            self._srv.close()
            await self._srv.wait_closed()
            self._srv = None
        await self.engine.close()

    # ---------------- request plumbing ---------------- #
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            try:
                method, path, _ = line.decode("latin-1").split(None, 2)
            except ValueError:
                await self._respond(writer, 400, {"error": "bad request"})
                return
            headers: Dict[str, str] = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length", 0) or 0)
            if n:
                body = await reader.readexactly(n)
            await self._route(method, path, headers, body, reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception:
            self.engine.unhandled_exceptions += 1
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _respond(self, writer, code: int, obj: Dict[str, Any],
                       ) -> None:
        body = json.dumps(obj).encode()
        writer.write(
            f"HTTP/1.1 {code} {'OK' if code == 200 else 'ERR'}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
            .encode() + body)
        await writer.drain()

    async def _route(self, method, path, headers, body, reader, writer):
        if method == "GET" and path == "/v1/health":
            eng = self.engine.sched.engine
            await self._respond(writer, 200, _jsonable(eng.health()))
            return
        if method == "GET" and path == "/v1/stats":
            await self._respond(writer, 200,
                                _jsonable(await self.engine.stats()))
            return
        if method == "POST" and path == "/v1/generate":
            await self._generate(headers, body, reader, writer)
            return
        await self._respond(writer, 404, {"error": f"no route {path}"})

    async def _generate(self, headers, body, reader, writer) -> None:
        try:
            spec = json.loads(body.decode() or "{}")
            prompt = np.asarray(spec["prompt"], np.int32)
            n_tokens = int(spec["n_tokens"])
        except (KeyError, ValueError, TypeError) as e:
            await self._respond(writer, 400, {"error": f"bad spec: {e}"})
            return
        if spec.get("greedy", True):
            sampling = SamplingParams.greedy()
        else:
            sampling = SamplingParams(
                temperature=float(spec.get("temperature", 0.7)),
                top_k=int(spec.get("top_k", 40)),
                top_p=float(spec.get("top_p", 0.9)))
        tenant = headers.get("x-tenant") or spec.get("tenant")
        stream = await self.engine.submit(
            prompt, n_tokens, sampling=sampling,
            priority=int(spec.get("priority", 0)),
            deadline_ms=spec.get("deadline_ms"),
            slo_tokens_per_s=spec.get("slo_tokens_per_s"),
            tenant=tenant)
        writer.write(b"HTTP/1.1 200 OK\r\n" + b"".join(
            f"{k}: {v}\r\n".encode() for k, v in _SSE.items())
            + b"Connection: close\r\n\r\n")
        # disconnect watcher: with the body consumed, any further read
        # returns EOF exactly when the client goes away
        eof = asyncio.get_running_loop().create_task(reader.read())
        try:
            async for ev in stream:
                writer.write(_sse(ev.pop("event"), ev))
                await writer.drain()
                if eof.done():
                    raise ConnectionResetError("client disconnected")
        except (ConnectionError, asyncio.IncompleteReadError):
            await self.engine.cancel(stream.uid)
        finally:
            eof.cancel()


def _jsonable(obj):
    """Best-effort JSON coercion for health/stats payloads (numpy and
    torch scalars and arrays, enums, nested dicts)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, RequestStatus):
        return obj.value
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return obj.tolist()
    return obj
