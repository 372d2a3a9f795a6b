from repro_torch.runtime.fault import (FaultConfig, FaultInjector,
                                       SimulatedFailure, Watchdog,
                                       run_with_restarts)

__all__ = ["FaultConfig", "FaultInjector", "SimulatedFailure", "Watchdog",
           "run_with_restarts"]
