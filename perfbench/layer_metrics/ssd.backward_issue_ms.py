"""Host milliseconds a training step spends in ``SSDScanFn.backward``
(the plain scan recomputed and differentiated, every Mamba layer): the
program's ``ssd.backward`` spans on every thread (the autograd engine's
on the card) over its ``train.step`` spans, in the traced window."""
from perfbench.harness.program_spans import per


def read(out, ctx):
    return per("ssd.backward", "train.step")
