"""Host milliseconds a decode step spends issuing its work: the
program's ``serve.decode`` spans less their ``serve.readback`` children
(the copy home that waits for the card), over the decode spans, in the
traced window."""
from perfbench.harness.program_spans import per


def read(out, ctx):
    whole = per("serve.decode", "serve.decode")
    wait = per("serve.readback", "serve.decode", under="serve.decode")
    return None if whole is None else whole - wait
