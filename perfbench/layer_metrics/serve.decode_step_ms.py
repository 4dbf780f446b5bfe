"""Host milliseconds of one ``ModelSlotExecutor.decode`` call (it ends in
its one copy home), all the window's calls over their count."""


def read(out, ctx):
    r = out.readings
    if not r.get("decode_calls"):
        return None
    return 1e3 * r["decode_s"] / r["decode_calls"]
