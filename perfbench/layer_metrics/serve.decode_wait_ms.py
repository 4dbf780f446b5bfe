"""Host milliseconds a decode step waits for the card: the program's
``serve.readback`` spans inside ``serve.decode`` over the decode spans, in
the traced window."""
from perfbench.harness.program_spans import per


def read(out, ctx):
    return per("serve.readback", "serve.decode", under="serve.decode")
