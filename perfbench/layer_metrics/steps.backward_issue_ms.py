"""Host milliseconds a training step spends in ``torch.autograd.grad``:
the program's ``steps.backward`` spans over its ``train.step`` spans, in
the traced window (the recompute of each checkpointed block included)."""
from perfbench.harness.program_spans import per


def read(out, ctx):
    return per("steps.backward", "train.step")
