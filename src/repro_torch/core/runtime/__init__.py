"""Sharded fleet execution: shards + the observation/decision bus.

``runtime`` is the execution layer above the single-process
:class:`~repro_torch.storage.sim.Simulation`: :class:`ShardedRuntime`
partitions a deployment's clients into node-group shards, each
advancing its own plan -> resolve -> commit loop, while tuning policies
gather observations and scatter decisions over a :class:`TuningBus`
instead of touching ``sim.clients`` directly. Sync mode is
decision-identical to the single-process step on the host backends;
async mode trades identity for bounded-staleness cadence isolation — a
straggler shard never blocks the fleet's probe cadence. Over a
``"soa-torch"`` simulation the shards step on the fleet's device
(:class:`~repro_torch.storage.device.ShardedDeviceFleet`).

All exports resolve lazily (PEP 562): ``storage/sim.py`` and the
policies import the runtime's neighbours, and an eager
``from .sharded import`` here would close an import cycle back through
``repro_torch.storage.sim``. Lazy resolution keeps this package's
import side-effect free.

The ``transport`` subpackage carries the same bus protocol across
process and host boundaries: :class:`~repro_torch.core.runtime.transport.
MultiprocessBus` (pipes), :class:`~repro_torch.core.runtime.transport.
SocketBus` (loopback/remote TCP), and :class:`~repro_torch.core.runtime.
transport.ProcessRuntime` — the spawn/join worker lifecycle with
snapshot/restore and elastic repartitioning. The ``telemetry``
subpackage is the observability layer: spans/counters into per-process
ring buffers, Perfetto export, and the crash flight recorder. Both
resolve lazily too (``repro_torch.telemetry`` imports the recorder
directly).
"""
import importlib

_EXPORTS = {
    "BusAccounting": "repro_torch.core.runtime.bus",
    "BusMessage": "repro_torch.core.runtime.bus",
    "COORDINATOR": "repro_torch.core.runtime.bus",
    "InProcessBus": "repro_torch.core.runtime.bus",
    "TuningBus": "repro_torch.core.runtime.bus",
    "Shard": "repro_torch.core.runtime.sharded",
    "ShardedRuntime": "repro_torch.core.runtime.sharded",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    if name in ("transport", "telemetry"):
        return importlib.import_module(f"repro_torch.core.runtime.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS)
                  | {"transport", "telemetry"})
