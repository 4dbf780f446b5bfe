"""The optimizer: AdamW (``adamw``), the reference's ``optim`` package."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    apply,
    global_norm,
    init,
    schedule,
    state_from_numpy,
)
