"""Fault tolerance and fault injection for the serving runtime — the port's
own copies of ``repro.runtime`` (pure Python)."""

from repro_torch.runtime.chaos import (ChaosError, Fault, FaultInjector,
                                       SimClock)
from repro_torch.runtime.fault_tolerance import (ElasticPolicy,
                                                 HeartbeatMonitor,
                                                 RestartPolicy,
                                                 StragglerMitigator)

__all__ = ["ChaosError", "ElasticPolicy", "Fault", "FaultInjector",
           "HeartbeatMonitor", "RestartPolicy", "SimClock",
           "StragglerMitigator"]
