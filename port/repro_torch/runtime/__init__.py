from repro_torch.runtime.elastic import replan_dense, replan_sparse
from repro_torch.runtime.fault_tolerance import RestartableLoop, StepWatchdog

__all__ = ["RestartableLoop", "StepWatchdog", "replan_sparse", "replan_dense"]
