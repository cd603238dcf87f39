from repro_torch.runtime.fault_tolerance import RestartableLoop, StepWatchdog

__all__ = ["RestartableLoop", "StepWatchdog"]
