"""Share of the traced window in which no operation ran on the card
(the trainer alone)."""


def read(out, ctx):
    red = out.readings.get("trace")
    if red is None or not red.window_s:
        return None
    return 1.0 - red.busy_s / red.window_s
