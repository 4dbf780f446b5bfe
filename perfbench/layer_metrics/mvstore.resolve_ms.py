"""Host milliseconds a decode step spends resolving its parameters from
the store (``mv_snapshot``): the program's ``mvstore.resolve`` spans
inside ``serve.decode`` over the decode spans, in the traced window."""
from perfbench.harness.program_spans import per


def read(out, ctx):
    return per("mvstore.resolve", "serve.decode", under="serve.decode")
