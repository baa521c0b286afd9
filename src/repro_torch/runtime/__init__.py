from repro_torch.runtime.fault_tolerance import (RESTART_EXIT_CODE,
                                                 PreemptionGuard,
                                                 run_with_restarts)
from repro_torch.runtime.straggler import StragglerWatchdog

__all__ = ["RESTART_EXIT_CODE", "PreemptionGuard", "run_with_restarts",
           "StragglerWatchdog"]
