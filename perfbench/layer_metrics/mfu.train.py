"""Model flops of the window's finished training steps (frozen 6 N a
token) over the time they took, as a share of the card's bf16 peak."""
from perfbench.frozen.peaks import PEAK_FLOPS


def read(out, ctx):
    r = out.readings
    if not r.get("train_steps"):
        return None
    return 100.0 * r["train_flops"] / r["train_seconds"] \
        / PEAK_FLOPS["bfloat16"]
