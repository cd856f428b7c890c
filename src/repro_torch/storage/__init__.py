"""Lustre-like parallel-file-system model: the substrate CARAT tunes.

The port's copy of ``repro.storage``: the scalar oracle (``IOClient``),
the host struct-of-arrays core (``SoACore``), the torch device fleet
(``DeviceFleet``, the default ``Simulation`` backend) and trace-driven
workload replay with its bundled corpus (``storage/traces/``).
"""
from repro_torch.storage.params import PFSParams, PAGE_SIZE
from repro_torch.storage.workloads import (WorkloadSpec, WORKLOADS,
                                           get_workload, idle_workload)
from repro_torch.storage.client import IOClient, ClientConfig
from repro_torch.storage.pfs import ClusterFeedback, PFSCluster
from repro_torch.storage.sim import SchedulePolicy, Simulation, SimResult
from repro_torch.storage.soa import (DemandBatch, PlanBatch, SoAClientView,
                                     SoACore)
from repro_torch.storage.replay import (Trace, TraceRecord, WorkloadSchedule,
                                        SchedulePhase, parse_trace,
                                        render_trace, load_trace,
                                        bundled_traces, load_bundled_trace,
                                        compile_trace, segment_phases,
                                        schedule_from_names,
                                        simulation_from_schedules,
                                        simulation_from_trace,
                                        synthesize_trace)

__all__ = [
    "PFSParams", "PAGE_SIZE", "WorkloadSpec", "WORKLOADS", "get_workload",
    "idle_workload", "IOClient", "ClientConfig", "PFSCluster",
    "ClusterFeedback", "Simulation", "SimResult", "SchedulePolicy",
    "SoACore", "SoAClientView", "PlanBatch", "DemandBatch",
    "Trace", "TraceRecord", "WorkloadSchedule", "SchedulePhase",
    "parse_trace", "render_trace", "load_trace", "bundled_traces",
    "load_bundled_trace", "compile_trace", "segment_phases",
    "schedule_from_names", "simulation_from_schedules",
    "simulation_from_trace", "synthesize_trace",
]
