"""Training runtime: the checkpoint/restart supervisor
(``fault_tolerance``), the straggler monitor (``straggler``) and the
re-mesh plan (``elastic``; its ``reshard_state`` waits for the port's
sharding rules)."""
from repro_torch.runtime.elastic import (  # noqa: F401
    RescalePlan,
    make_rescaled_mesh,
    rescale_plan,
)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    FaultPlan,
    TrainSupervisor,
)
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
