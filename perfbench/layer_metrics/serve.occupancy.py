"""Share of slot-steps with a request decoding, over the window's
scheduler passes (the program's ``ServeMetrics`` counters)."""


def read(out, ctx):
    return out.readings.get("occupancy")
