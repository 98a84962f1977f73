"""Failure detection, elastic remesh planning and straggler mitigation
(port of ``repro.runtime``)."""
from repro_torch.runtime.failures import FailureDetector, NodeStatus
from repro_torch.runtime.elastic import MeshPlan, plan_mesh
from repro_torch.runtime.straggler import StragglerMitigator

__all__ = ["FailureDetector", "NodeStatus", "MeshPlan", "plan_mesh",
           "StragglerMitigator"]
