"""Cross-host ``TuningBus``: length-prefixed frames over TCP.

:class:`SocketBusHost` is the hub — it owns the fleet's one message
store (an :class:`~repro_torch.core.runtime.bus.InProcessBus`, same
``BusAccounting`` semantics as every other transport) and serves it on
a listening socket: an accept thread plus one daemon thread per
connection, each speaking the frame protocol below. The coordinator
uses the host object directly as its bus; shard workers — same machine
or another host — connect :class:`SocketBus` clients to
``host.address`` with ``authkey=host.authkey``.

Authentication: every connection starts with a shared-secret
challenge/response handshake (the :mod:`multiprocessing.connection`
scheme) carried in **raw fixed-size byte strings** — the host sends a
random 32-byte challenge, the client answers with
``HMAC-SHA256(authkey, challenge)``, and the host proves itself back
with ``HMAC-SHA256(authkey, challenge + b"#HOST")``. Nothing a peer
sends is deserialized before its digest verifies, so an unauthenticated
peer can never reach the pickle codec; a client talking to an impostor
host raises :class:`BusAuthError` instead of retrying. The host
auto-generates ``authkey`` when none is given. The handshake
authenticates peers only — frames are neither encrypted nor
per-message MACed, so the port should still live on a trusted network.

Frame protocol (post-handshake): every message is a 4-byte big-endian
length prefix followed by a pickled request/response tuple. Payloads
inside requests are **wire-encoded**
(:mod:`~repro_torch.core.runtime.transport.wire`) before they are framed, so
pickle only ever sees tagged plain-value trees — no live objects, and
the frame bytes are transport-portable (the wire tree is msgpack-able;
pickle is the framing codec the container ships with). Client requests
are ``("req", peer, epoch, seq, op_tuple)`` where the op tuples mirror
the pipe RPC: ``pub``/``con``/``lat``/``wait``/``stats``/``hb``/
``bye``; ``wait`` blocks the connection's server thread on the store's
condition variable — a natural cross-host ``bus.wait``.

Clients reconnect: any send/recv failure closes the socket and retries
with bounded exponential backoff (``backoff_s`` doubling up to
``backoff_cap_s``, at most ``max_retries`` attempts) before raising
:class:`BusDisconnected`. Retries are **exactly-once** on the store:
each logical call carries a per-client ``(epoch, seq)`` tag and the
host caches its last response per peer (serve → cache → send, under a
per-peer lock), so a retry whose original was already served — a
destructive ``con`` drain, a counter-bumping ``pub`` — is answered
from the cache instead of re-executed, and a response frame lost in
flight is replayed rather than surfacing as lost messages. Each client
can run a background heartbeat thread; the host tracks beats per peer
in a :class:`~repro_torch.runtime.fault_tolerance.HeartbeatTracker`
(``host.heartbeats``) so a runtime can mark silent peers dead.
"""
from __future__ import annotations

import hmac
import pickle
import secrets
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.runtime.bus import BusMessage, InProcessBus, TuningBus
from repro_torch.core.runtime.telemetry.clock import perf_s
from repro_torch.core.runtime.telemetry.recorder import active as _telemetry
from repro_torch.core.runtime.transport.wire import from_wire, to_wire
from repro_torch.runtime.fault_tolerance import HeartbeatTracker

__all__ = ["SocketBusHost", "SocketBus", "BusDisconnected", "BusAuthError"]

_LEN = struct.Struct(">I")
_MAX_FRAME = 256 * 1024 * 1024      # sanity bound, not a protocol limit
_MAX_WAIT_S = 60.0                  # server-side clamp on parked waits
_CHALLENGE_LEN = 32                 # raw bytes, fixed size — never pickled
_DIGEST_LEN = 32                    # HMAC-SHA256
_HOST_SUFFIX = b"#HOST"             # domain-separates the host's proof
_HANDSHAKE_TIMEOUT_S = 10.0         # a silent scanner can't park a thread


class BusDisconnected(ConnectionError):
    """Reconnect attempts exhausted (bounded backoff ran out)."""


class BusAuthError(ConnectionError):
    """The peer failed the shared-secret handshake (wrong ``authkey``,
    or the host could not prove knowledge of ours). Never retried — a
    key mismatch does not fix itself."""


def _as_key(authkey) -> bytes:
    if isinstance(authkey, str):
        authkey = authkey.encode("utf-8")
    if not isinstance(authkey, (bytes, bytearray)) or not authkey:
        raise ValueError("authkey must be a non-empty bytes/str secret")
    return bytes(authkey)


def _send_frame(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed the connection")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > _MAX_FRAME:
        raise ConnectionError(f"frame length {n} exceeds sanity bound")
    return pickle.loads(_recv_exact(sock, n))


def _pack(msgs: List[BusMessage]) -> List[tuple]:
    return [(m.topic, m.shard, m.interval, to_wire(m.payload))
            for m in msgs]


def _unpack(rows: List[tuple]) -> List[BusMessage]:
    return [BusMessage(t, s, i, from_wire(p)) for t, s, i, p in rows]


class SocketBusHost(TuningBus):
    """The listening hub (see module docstring). ``port=0`` binds an
    ephemeral loopback port; read the bound address from
    ``host.address`` and the shared secret from ``host.authkey``
    (auto-generated unless passed in). Context-managed."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 heartbeat_timeout_s: float = 30.0,
                 authkey: Optional[bytes] = None):
        self.authkey = (_as_key(authkey) if authkey is not None
                        else secrets.token_bytes(32))
        self._store = InProcessBus()
        self.heartbeats = HeartbeatTracker(heartbeat_timeout_s)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.address: Tuple[str, int] = self._srv.getsockname()
        self._stop = threading.Event()
        self._conns: List[socket.socket] = []
        self._conn_lock = threading.Lock()
        # exactly-once retry support: last (epoch, seq, response) per
        # peer, and a per-peer serve lock so a retry arriving on a fresh
        # connection can't race the original connection's serve
        self._replies: Dict[object, Tuple[object, int, tuple]] = {}
        self._reply_lock = threading.Lock()
        self._peer_locks: Dict[object, threading.Lock] = {}
        self._accepter = threading.Thread(target=self._accept_loop,
                                          name="socketbus-accept",
                                          daemon=True)
        self._accepter.start()

    # ------------------------------------------------------- lifecycle
    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._conn_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()

    def __enter__(self) -> "SocketBusHost":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------- server loops
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return                       # closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conn_lock:
                self._conns.append(conn)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             name="socketbus-conn", daemon=True).start()

    def _handshake(self, conn: socket.socket) -> bool:
        """Challenge/response before anything is deserialized: raw
        fixed-size byte strings only — a peer without the key never
        reaches the pickle codec."""
        conn.settimeout(_HANDSHAKE_TIMEOUT_S)
        challenge = secrets.token_bytes(_CHALLENGE_LEN)
        conn.sendall(challenge)
        digest = _recv_exact(conn, _DIGEST_LEN)
        want = hmac.new(self.authkey, challenge, "sha256").digest()
        if not hmac.compare_digest(digest, want):
            return False
        conn.sendall(hmac.new(self.authkey, challenge + _HOST_SUFFIX,
                              "sha256").digest())
        conn.settimeout(None)
        return True

    def _conn_loop(self, conn: socket.socket) -> None:
        try:
            if not self._handshake(conn):
                return
            while not self._stop.is_set():
                req = _recv_frame(conn)
                if not self._answer(conn, req):
                    break
        except (ConnectionError, OSError, EOFError, pickle.PickleError):
            pass
        finally:
            with self._conn_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            conn.close()

    def _answer(self, conn: socket.socket, req: tuple) -> bool:
        """Serve one framed request; returns False on ``bye``. Tagged
        requests get exactly-once semantics: serve → cache → send under
        the peer's lock, so a retry (same epoch+seq, possibly on a new
        connection after the response frame was lost) replays the cached
        response instead of re-executing a destructive op."""
        if req[0] != "req":                  # untagged probe — no replay
            return self._serve_and_send(conn, req)
        _, peer, epoch, seq, body = req
        with self._reply_lock:
            lock = self._peer_locks.setdefault(peer, threading.Lock())
        with lock:
            with self._reply_lock:
                cached = self._replies.get(peer)
            if cached is not None and cached[:2] == (epoch, seq):
                _send_frame(conn, cached[2])
                return body[0] != "bye"
            try:
                resp = ("ok", self._serve(body))
            except Exception as e:           # serve errors, don't die
                resp = ("err", f"{type(e).__name__}: {e}")
            with self._reply_lock:
                self._replies[peer] = (epoch, seq, resp)
            _send_frame(conn, resp)
        return body[0] != "bye"

    def _serve_and_send(self, conn: socket.socket, body: tuple) -> bool:
        try:
            resp = ("ok", self._serve(body))
        except Exception as e:
            resp = ("err", f"{type(e).__name__}: {e}")
        _send_frame(conn, resp)
        return body[0] != "bye"

    def _serve(self, req: tuple) -> Any:
        op = req[0]
        if op == "pub":
            _, topic, shard, interval, payload, retain = req
            self._store.publish(topic, shard, interval,
                                from_wire(payload), retain)
            return None
        if op == "con":
            _, topic, now, max_staleness = req
            return _pack(self._store.consume(topic, now, max_staleness))
        if op == "lat":
            _, topic, now, max_staleness, exclude = req
            return _pack(self._store.latest(topic, now, max_staleness,
                                            exclude))
        if op == "wait":
            # blocks this connection's thread only — the cross-host twin
            # of the in-process condition wait
            self._store.wait(min(float(req[1]), _MAX_WAIT_S))
            return None
        if op == "stats":
            return self._store.stats()
        if op == "hb":
            _, peer, interval = req
            self.heartbeats.beat(peer, interval)
            return None
        if op == "bye":
            return None
        raise ValueError(f"unknown op {op!r}")

    # ------------------------------------------------- parent-side bus
    def publish(self, topic: str, shard: object, interval: int,
                payload: Any, retain: bool = False) -> None:
        # symmetric purity: the coordinator's payloads cross the same
        # wire encoder the remote peers' do
        self._store.publish(topic, shard, interval,
                            from_wire(to_wire(payload)), retain)

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


class SocketBus(TuningBus):
    """Client endpoint: the four-method bus over a framed TCP connection
    (see module docstring). Needs the host's ``authkey`` — read it from
    ``SocketBusHost.authkey`` or share a secret out of band. Picklable —
    the address, peer name, authkey, and retry policy travel; the socket
    is (re)built lazily, which is also what makes a spawned worker's
    copy immediately usable (an unpickled copy gets a fresh retry epoch,
    so its call tags never collide with its ancestor's)."""

    def __init__(self, address: Tuple[str, int], peer: object = "?",
                 authkey: Optional[bytes] = None,
                 connect_timeout_s: float = 10.0, io_timeout_s: float = 120.0,
                 max_retries: int = 8, backoff_s: float = 0.05,
                 backoff_cap_s: float = 1.0):
        if authkey is None:
            raise ValueError(
                "SocketBus needs the host's shared secret: pass "
                "authkey=host.authkey (or the out-of-band key)")
        self.address = (address[0], int(address[1]))
        self.peer = peer
        self.authkey = _as_key(authkey)
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.reconnects = 0                 # observability: tests gate this
        self._epoch = secrets.token_hex(8)  # unique per client instance
        self._seq = 0
        self._sock: Optional[socket.socket] = None
        self._lock: Optional[threading.Lock] = None
        self._hb_stop: Optional[threading.Event] = None

    def __getstate__(self):
        return {k: getattr(self, k) for k in
                ("address", "peer", "authkey", "connect_timeout_s",
                 "io_timeout_s", "max_retries", "backoff_s",
                 "backoff_cap_s")}

    def __setstate__(self, state):
        self.__init__(state["address"], state["peer"], state["authkey"],
                      state["connect_timeout_s"], state["io_timeout_s"],
                      state["max_retries"], state["backoff_s"],
                      state["backoff_cap_s"])

    # ----------------------------------------------------- connection
    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.address,
                                        timeout=self.connect_timeout_s)
        sock.settimeout(self.io_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            challenge = _recv_exact(sock, _CHALLENGE_LEN)
            sock.sendall(hmac.new(self.authkey, challenge,
                                  "sha256").digest())
            proof = _recv_exact(sock, _DIGEST_LEN)
            want = hmac.new(self.authkey, challenge + _HOST_SUFFIX,
                            "sha256").digest()
            if not hmac.compare_digest(proof, want):
                raise BusAuthError(
                    f"peer {self.peer!r}: host at {self.address} failed "
                    f"to prove knowledge of the authkey — not our hub")
        except BaseException:
            sock.close()
            raise
        return sock

    def _call(self, *req) -> Any:
        if self._lock is None:
            self._lock = threading.Lock()
        rec = _telemetry()
        t0 = perf_s() if rec.enabled else 0.0
        with self._lock:
            # one tag per logical call, reused verbatim across retries:
            # the host replays its cached response if the original was
            # already served (exactly-once for destructive ops)
            seq, self._seq = self._seq, self._seq + 1
            frame = ("req", self.peer, self._epoch, seq, req)
            attempt = 0
            while True:
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                        if attempt:
                            self.reconnects += 1
                            if rec.enabled:
                                rec.count("bus.reconnects")
                    _send_frame(self._sock, frame)
                    tag, data = _recv_frame(self._sock)
                    break
                except BusAuthError:
                    self._sock = None        # key mismatch: never retried
                    raise
                except (ConnectionError, OSError, EOFError,
                        pickle.PickleError):
                    if self._sock is not None:
                        self._sock.close()
                        self._sock = None
                    attempt += 1
                    if attempt > self.max_retries:
                        raise BusDisconnected(
                            f"peer {self.peer!r}: bus host {self.address} "
                            f"unreachable after {self.max_retries} "
                            f"reconnect attempts") from None
                    # bounded exponential backoff
                    time.sleep(min(self.backoff_s * (2 ** (attempt - 1)),
                                   self.backoff_cap_s))
        if rec.enabled and req[0] != "wait":
            # wait() parks on the host by design; timing it would just
            # measure the requested timeout, not transport latency
            rec.hist("bus.rpc_ms", round((perf_s() - t0) * 1e3, 1))
        if tag == "err":
            raise RuntimeError(f"bus host rejected {req[0]!r}: {data}")
        return data

    # ------------------------------------------------------- TuningBus
    def publish(self, topic: str, shard: object, interval: int,
                payload: Any, retain: bool = False) -> None:
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

    def start_heartbeat(self, every_s: float = 0.5,
                        interval_fn: Optional[Callable[[], int]] = None
                        ) -> None:
        """Beat the host from a daemon thread until :meth:`close` (the
        cross-host liveness signal; ``interval_fn`` reports the peer's
        current probe interval alongside)."""
        if self._hb_stop is not None:
            return
        self._hb_stop = threading.Event()

        def loop(stop: threading.Event) -> None:
            while not stop.is_set():
                try:
                    self.beat(interval_fn() if interval_fn else None)
                except (BusDisconnected, BusAuthError, RuntimeError):
                    return
                stop.wait(every_s)

        threading.Thread(target=loop, args=(self._hb_stop,),
                         name=f"socketbus-hb-{self.peer}",
                         daemon=True).start()

    def close(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_stop = None
        try:
            self._call("bye")
        except (BusDisconnected, BusAuthError, RuntimeError):
            pass
        if self._sock is not None:
            self._sock.close()
            self._sock = None
