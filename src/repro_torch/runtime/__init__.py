from repro_torch.runtime.fault_tolerance import (ClusterMonitor, ElasticPlan,
                                                 StragglerDetector)

__all__ = ["ClusterMonitor", "ElasticPlan", "StragglerDetector"]
