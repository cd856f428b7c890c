"""Lustre-like parallel-file-system model: the substrate CARAT tunes.

The port's copy of ``repro.storage``: the scalar oracle (``IOClient``),
the host struct-of-arrays core (``SoACore``) and the torch device fleet
(``DeviceFleet``, the default ``Simulation`` backend). The reference's
trace replay layer is not ported yet.
"""
from repro_torch.storage.params import PFSParams, PAGE_SIZE
from repro_torch.storage.workloads import (WorkloadSpec, WORKLOADS,
                                           get_workload, idle_workload)
from repro_torch.storage.client import IOClient, ClientConfig
from repro_torch.storage.pfs import ClusterFeedback, PFSCluster
from repro_torch.storage.sim import SchedulePolicy, Simulation, SimResult
from repro_torch.storage.soa import (DemandBatch, PlanBatch, SoAClientView,
                                     SoACore)

__all__ = [
    "PFSParams", "PAGE_SIZE", "WorkloadSpec", "WORKLOADS", "get_workload",
    "idle_workload", "IOClient", "ClientConfig", "PFSCluster",
    "ClusterFeedback", "Simulation", "SimResult", "SchedulePolicy",
    "SoACore", "SoAClientView", "PlanBatch", "DemandBatch",
]
