"""Synthetic training data (``pipeline``)."""
from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLM,
    make_batch_iterator,
)
