"""Host milliseconds a training step spends issuing its forward pass:
the program's ``steps.forward`` spans (the loss) over its ``train.step``
spans, in the traced window."""
from perfbench.harness.program_spans import per


def read(out, ctx):
    return per("steps.forward", "train.step")
