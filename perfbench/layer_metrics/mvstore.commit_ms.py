"""Host milliseconds a training step spends committing its version
(the fused commit: the step's scalars, one ``fused_adamw`` launch and two
ring stamps a leaf): the program's ``mvstore.commit`` spans over its
``train.step`` spans, in the traced window."""
from perfbench.harness.program_spans import per


def read(out, ctx):
    return per("mvstore.commit", "train.step")
