"""Model flops of the window's served tokens (frozen 2 N a prefilled or
decoded token) over the window, as a share of the card's bf16 peak."""
from perfbench.frozen.peaks import PEAK_FLOPS


def read(out, ctx):
    r = out.readings
    if not r.get("serve_flops"):
        return None
    return 100.0 * r["serve_flops"] / r["window_s"] / PEAK_FLOPS["bfloat16"]
