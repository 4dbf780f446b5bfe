"""Host milliseconds the trainer takes to issue a step (the program's
``Trainer.step_times``: the step enqueued, not run), mean over the
window's steps."""


def read(out, ctx):
    s = out.readings.get("host_issue_s")
    return None if s is None else s * 1e3
