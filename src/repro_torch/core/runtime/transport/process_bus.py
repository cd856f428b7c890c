"""Cross-process ``TuningBus``: a parent-side hub serving pipe endpoints.

:class:`MultiprocessBus` keeps the fleet's one message store (a plain
:class:`~repro_torch.core.runtime.bus.InProcessBus`, so staleness/drop
accounting is byte-for-byte the in-process semantics via the shared
``BusAccounting`` mixin) in the coordinator process. Worker processes
hold :class:`PipeEndpoint` handles — picklable, spawn-safe — that speak
a tiny request/response RPC over a duplex ``multiprocessing.Pipe``; a
broker thread in the parent multiplexes all endpoints with
``multiprocessing.connection.wait``.

Payload purity is enforced at the boundary: endpoints run every
published payload through :func:`~repro_torch.core.runtime.transport.wire.
to_wire` *in the worker* (so a live-object leak raises where the bug
is), the broker decodes before storing, and deliveries re-encode for
the return trip. The parent's own publishes round-trip through the same
encoder — symmetric purity, and what the conformance suite relies on to
compare transports counter-for-counter.

``wait`` is served asynchronously: the broker parks the request with a
deadline and replies when the next publish arrives (from any process)
or the deadline passes — the endpoint blocks on its pipe meanwhile, so
a cross-process ``bus.wait`` behaves like the in-process condition
variable.

Heartbeats: endpoints can ``beat(peer, interval)``; the hub records
them in a :class:`~repro_torch.runtime.fault_tolerance.HeartbeatTracker`
(``hub.heartbeats``) so a runtime can tell a straggler from a corpse.
"""
from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection as mpc
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.runtime.bus import BusMessage, InProcessBus, TuningBus
from repro_torch.core.runtime.telemetry.clock import perf_s
from repro_torch.core.runtime.telemetry.recorder import active as _telemetry
from repro_torch.core.runtime.transport.wire import from_wire, to_wire
from repro_torch.runtime.fault_tolerance import HeartbeatTracker

__all__ = ["MultiprocessBus", "PipeEndpoint", "EndpointError"]


class EndpointError(RuntimeError):
    """The hub failed to serve a request (the hub-side error, re-raised
    at the calling endpoint)."""


def _pack(msgs: List[BusMessage]) -> List[tuple]:
    return [(m.topic, m.shard, m.interval, to_wire(m.payload))
            for m in msgs]


def _unpack(rows: List[tuple]) -> List[BusMessage]:
    return [BusMessage(t, s, i, from_wire(p)) for t, s, i, p in rows]


class PipeEndpoint(TuningBus):
    """Worker-side bus handle over one duplex pipe (see module docstring).

    Picklable: only the connection and peer name travel to the spawned
    worker; the request lock is rebuilt lazily on first use.
    """

    def __init__(self, conn: mpc.Connection, peer: object):
        self._conn = conn
        self.peer = peer
        self._lock: Optional[threading.Lock] = None

    # spawn ships the endpoint inside Process args; drop the lock
    def __getstate__(self):
        return {"conn": self._conn, "peer": self.peer}

    def __setstate__(self, state):
        self._conn = state["conn"]
        self.peer = state["peer"]
        self._lock = None

    def _call(self, *req) -> Any:
        if self._lock is None:
            self._lock = threading.Lock()
        rec = _telemetry()
        t0 = perf_s() if rec.enabled else 0.0
        with self._lock:
            self._conn.send(req)
            tag, data = self._conn.recv()
        if rec.enabled and req[0] != "wait":
            # wait() parks on the hub by design; timing it would just
            # measure the requested timeout, not transport latency
            rec.hist("bus.rpc_ms", round((perf_s() - t0) * 1e3, 1))
        if tag == "err":
            raise EndpointError(f"bus hub rejected {req[0]!r}: {data}")
        return data

    # ------------------------------------------------------- TuningBus
    def publish(self, topic: str, shard: object, interval: int,
                payload: Any, retain: bool = False) -> None:
        # encode worker-side: a live-object leak raises here, in the
        # process that built the payload
        self._call("pub", topic, shard, int(interval), to_wire(payload),
                   bool(retain))

    def consume(self, topic: str, now: Optional[int] = None,
                max_staleness: Optional[int] = None) -> List[BusMessage]:
        return _unpack(self._call("con", topic, now, max_staleness))

    def latest(self, topic: str, now: Optional[int] = None,
               max_staleness: Optional[int] = None,
               exclude_shard: object = None) -> List[BusMessage]:
        return _unpack(self._call("lat", topic, now, max_staleness,
                                  exclude_shard))

    def wait(self, timeout: float) -> None:
        self._call("wait", float(timeout))

    # ------------------------------------------------------ extensions
    def stats(self) -> Dict[str, int]:
        return self._call("stats")

    def beat(self, interval: Optional[int] = None) -> None:
        self._call("hb", self.peer, interval)

    def close(self) -> None:
        try:
            self._call("bye")
        except (OSError, EOFError, BrokenPipeError):
            pass
        self._conn.close()


class MultiprocessBus(TuningBus):
    """The parent-side hub (see module docstring). Use as the
    coordinator's bus directly; hand workers :meth:`endpoint` handles.
    Context-managed: ``with MultiprocessBus() as hub: ...`` starts and
    stops the broker thread."""

    def __init__(self, ctx: Optional[mp.context.BaseContext] = None,
                 heartbeat_timeout_s: float = 30.0):
        self.ctx = ctx or mp.get_context("spawn")
        self._store = InProcessBus()
        self.heartbeats = HeartbeatTracker(heartbeat_timeout_s)
        self._conns: Dict[mpc.Connection, object] = {}
        self._reg_lock = threading.Lock()
        # parked wait requests: (conn, deadline)
        self._waiters: List[Tuple[mpc.Connection, float]] = []
        self._wlock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------- lifecycle
    def start(self) -> "MultiprocessBus":
        if self._thread is None:
            self._thread = threading.Thread(target=self._serve,
                                            name="bus-hub", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._reg_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            c.close()

    def __enter__(self) -> "MultiprocessBus":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def endpoint(self, peer: object) -> PipeEndpoint:
        """A new worker handle. Call before spawning; pass the endpoint
        in the worker's args (it pickles; the parent end stays here)."""
        parent, child = self.ctx.Pipe(duplex=True)
        with self._reg_lock:
            self._conns[parent] = peer
        return PipeEndpoint(child, peer)

    # ------------------------------------------------- parent-side bus
    def publish(self, topic: str, shard: object, interval: int,
                payload: Any, retain: bool = False) -> None:
        # same purity round-trip the endpoints get: the coordinator must
        # not be the one path that can leak a live object onto the bus
        self._store.publish(topic, shard, interval,
                            from_wire(to_wire(payload)), retain)
        self._flush_waiters(wake=True)

    def consume(self, topic: str, now: Optional[int] = None,
                max_staleness: Optional[int] = None) -> List[BusMessage]:
        return self._store.consume(topic, now, max_staleness)

    def latest(self, topic: str, now: Optional[int] = None,
               max_staleness: Optional[int] = None,
               exclude_shard: object = None) -> List[BusMessage]:
        return self._store.latest(topic, now, max_staleness, exclude_shard)

    def wait(self, timeout: float) -> None:
        self._store.wait(timeout)

    def stats(self) -> Dict[str, int]:
        return self._store.stats()

    # ----------------------------------------------------- broker loop
    def _serve(self) -> None:
        while not self._stop.is_set():
            with self._reg_lock:
                conns = list(self._conns)
            if not conns:
                time.sleep(0.005)
                self._flush_waiters()
                continue
            try:
                ready = mpc.wait(conns, timeout=0.02)
            except OSError:
                ready = []          # a conn died between list and wait
            for conn in ready:
                try:
                    req = conn.recv()
                except (EOFError, OSError):
                    self._drop(conn)
                    continue
                self._handle(conn, req)
            self._flush_waiters()

    def _drop(self, conn: mpc.Connection) -> None:
        with self._reg_lock:
            self._conns.pop(conn, None)
        with self._wlock:
            self._waiters = [(c, d) for c, d in self._waiters if c is not conn]
        conn.close()

    def _handle(self, conn: mpc.Connection, req: tuple) -> None:
        op = req[0]
        try:
            if op == "pub":
                _, topic, shard, interval, payload, retain = req
                self._store.publish(topic, shard, interval,
                                    from_wire(payload), retain)
                conn.send(("ok", None))
                self._flush_waiters(wake=True)
            elif op == "con":
                _, topic, now, max_staleness = req
                conn.send(("ok", _pack(self._store.consume(
                    topic, now, max_staleness))))
            elif op == "lat":
                _, topic, now, max_staleness, exclude = req
                conn.send(("ok", _pack(self._store.latest(
                    topic, now, max_staleness, exclude))))
            elif op == "wait":
                with self._wlock:
                    self._waiters.append((conn, time.monotonic() + req[1]))
            elif op == "stats":
                conn.send(("ok", self._store.stats()))
            elif op == "hb":
                _, peer, interval = req
                self.heartbeats.beat(peer, interval)
                conn.send(("ok", None))
            elif op == "bye":
                conn.send(("ok", None))
                self._drop(conn)
            else:
                conn.send(("err", f"unknown op {op!r}"))
        except (BrokenPipeError, OSError):
            self._drop(conn)
        except Exception as e:               # serve errors, don't die
            try:
                conn.send(("err", f"{type(e).__name__}: {e}"))
            except (BrokenPipeError, OSError):
                self._drop(conn)

    def _flush_waiters(self, wake: bool = False) -> None:
        """Answer parked ``wait`` requests: all of them on a publish
        (``wake=True``), expired ones on a broker tick."""
        now = time.monotonic()
        with self._wlock:
            if wake:
                due, self._waiters = self._waiters, []
            else:
                due = [(c, d) for c, d in self._waiters if d <= now]
                self._waiters = [(c, d) for c, d in self._waiters if d > now]
        for conn, _ in due:
            try:
                conn.send(("ok", None))
            except (BrokenPipeError, OSError):
                self._drop(conn)
