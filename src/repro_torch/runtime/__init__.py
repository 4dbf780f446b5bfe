"""Training runtime: the checkpoint/restart supervisor
(``fault_tolerance``) and the straggler monitor (``straggler``).
``elastic`` (re-meshing) is not ported yet."""
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    FaultPlan,
    TrainSupervisor,
)
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
