"""Training runtime: the checkpoint/restart supervisor
(``fault_tolerance``), the straggler monitor (``straggler``) and the
re-mesh plan and state move (``elastic``: ``rescale_plan``,
``make_rescaled_mesh``, ``reshard_state``)."""
from repro_torch.runtime.elastic import (  # noqa: F401
    RescalePlan,
    make_rescaled_mesh,
    rescale_plan,
    reshard_state,
)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    FaultPlan,
    TrainSupervisor,
)
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
