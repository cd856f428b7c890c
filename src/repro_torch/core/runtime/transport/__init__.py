"""Cross-process and cross-host ``TuningBus`` transports.

The in-process runtime (``repro_torch.core.runtime``) already speaks an
object-free, id-keyed bus protocol; this package carries it across real
process and host boundaries:

* :mod:`~repro_torch.core.runtime.transport.wire` — the payload round-trip
  contract (``to_wire``/``from_wire``): tagged plain-value trees, numpy
  buffers, registered payload dataclasses — and a loud
  :class:`WireError` for anything alive;
* :mod:`~repro_torch.core.runtime.transport.process_bus` —
  :class:`MultiprocessBus`, a parent-side hub serving picklable
  :class:`PipeEndpoint` handles over multiprocessing pipes;
* :mod:`~repro_torch.core.runtime.transport.socket_bus` —
  :class:`SocketBusHost` / :class:`SocketBus`, the same RPC over
  length-prefixed pickle frames on TCP behind a shared-secret HMAC
  handshake (``authkey``), with heartbeats, exactly-once retries, and
  bounded reconnect backoff — the two-terminal / cross-host transport;
* :mod:`~repro_torch.core.runtime.transport.fleet` —
  :class:`ProcessRuntime`, the spawn/join worker lifecycle around the
  sharded runtime: sync mode decision-identical to one process, async
  mode straggler-tolerant, snapshot/restore (:class:`KillShard`) and
  mid-run repartitioning (:class:`Repartition`).
"""
from repro_torch.core.runtime.transport.fleet import (
    KillShard, ProcessRuntime, Repartition,
)
from repro_torch.core.runtime.transport.process_bus import (
    EndpointError, MultiprocessBus, PipeEndpoint,
)
from repro_torch.core.runtime.transport.socket_bus import (
    BusAuthError, BusDisconnected, SocketBus, SocketBusHost,
)
from repro_torch.core.runtime.transport.wire import (
    WireError, assert_wire_safe, from_wire, to_wire,
)

__all__ = [
    "BusAuthError",
    "BusDisconnected",
    "EndpointError",
    "KillShard",
    "MultiprocessBus",
    "PipeEndpoint",
    "ProcessRuntime",
    "Repartition",
    "SocketBus",
    "SocketBusHost",
    "WireError",
    "assert_wire_safe",
    "from_wire",
    "to_wire",
]
