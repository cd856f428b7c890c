"""The telemetry names the core and the runtime import: :func:`perf_s`,
:func:`active` and :class:`NullRecorder`, re-exported from
:mod:`repro_torch.core.runtime.telemetry`.

With no recorder installed, :func:`active` returns the shared disabled
recorder, whose every operation is a constant-time no-op; a process
that installs one (``telemetry.enable()``, ``ProcessRuntime(telemetry=
True)``) records the spans and counters of the instrumented modules.
"""
from repro_torch.core.runtime.telemetry.clock import perf_s
from repro_torch.core.runtime.telemetry.recorder import NullRecorder, active

__all__ = ["NullRecorder", "active", "perf_s"]
