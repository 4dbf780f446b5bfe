"""Training runtime: the checkpoint/restart supervisor
(``fault_tolerance``), the straggler monitor (``straggler``), the
re-mesh plan and state move (``elastic``: ``rescale_plan``,
``make_rescaled_mesh``, ``reshard_state``), and the span layer
(``spans``: named host intervals on the profiler's clock).

``spans`` is imported by the core, model and launch modules, which the
other three import in turn, so their names are loaded at first use."""
from importlib import import_module

from repro_torch.runtime import spans  # noqa: F401

_LAZY = {"RescalePlan": "elastic", "make_rescaled_mesh": "elastic",
         "rescale_plan": "elastic", "reshard_state": "elastic",
         "FaultPlan": "fault_tolerance", "TrainSupervisor": "fault_tolerance",
         "StragglerMonitor": "straggler"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(f"{__name__}.{_LAZY[name]}"), name)
