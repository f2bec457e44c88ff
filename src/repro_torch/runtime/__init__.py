from repro_torch.runtime.ft import FaultToleranceManager, NodeState, StragglerDetector
from repro_torch.runtime.elastic import ElasticPlan, plan_remesh

__all__ = ["FaultToleranceManager", "NodeState", "StragglerDetector",
           "ElasticPlan", "plan_remesh"]
