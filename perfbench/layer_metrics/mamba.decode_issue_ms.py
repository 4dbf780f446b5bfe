"""Host milliseconds a decode step spends issuing its Mamba layers: the
program's ``mamba.decode`` spans (each Mamba mixer's one-token form)
inside ``serve.decode`` over the decode spans, in the traced window
(None where the program opens no such span)."""
from perfbench.harness.program_spans import per


def read(out, ctx):
    return per("mamba.decode", "serve.decode", under="serve.decode") or None
