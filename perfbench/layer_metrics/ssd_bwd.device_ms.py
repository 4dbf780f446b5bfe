"""Device milliseconds a training step spends in the SSD scan's backward
kernel: every launch whose name holds ``ssd_bwd`` in the traced window,
whatever its label (the autograd engine's thread launches it, and carries
no ``train.step`` label), over the program's ``train.step`` spans of the
window (the trace's own ``train.step`` count holds the benchmark's label
and the program's span, two a step)."""
from perfbench.harness.program_spans import window

KERNEL = "ssd_bwd"


def read(out, ctx):
    red = out.readings.get("trace")
    if red is None:
        return None
    recs = window()
    steps = sum(1 for r in recs if r.name == "train.step") if recs else 0
    time = sum(v for k, v in red.kernels.items() if KERNEL in k)
    if not steps or not time:
        return None
    return 1e3 * time / steps
