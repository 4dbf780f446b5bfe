"""Plain PyTorch references of the benchmark's models and optimizer.

Straightforward float32 code (TF32 off), written from the published
descriptions; it imports nothing of the program.  Weights are the nested
dicts the benchmark makes (``harness/weights.py``), every stacked layer
leaf led by the layer axis; a layer's leaves are cast to float32 as they
are used.  ``precision="fp8"`` is the control: every projection's operands
rounded to float8 e4m3 (a scale per output channel for the weight, per
token for the activation), the step below the configurations' bfloat16.
"""
import torch


def no_tf32() -> None:
    """Float32 products in float32: TF32 would be a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
