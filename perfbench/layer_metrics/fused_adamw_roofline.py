"""The optimizer's fused step: the frozen bytes of every leaf's update
and ring write (one launch a leaf) over the launches' device time in the
traced window, in per cent."""
from perfbench.frozen import arith
from perfbench.frozen.peaks import HBM_BW

KERNEL = "fused_adamw_kernel"


def read(out, ctx):
    red = out.readings.get("trace")
    if red is None:
        return None
    time = sum(v for k, v in red.kernels.items() if KERNEL in k)
    n = sum(v for (lb, k), v in red.launches.items() if KERNEL in k)
    leaves = arith.param_leaves(ctx.config)
    if not time or not n:
        return None
    steps = n / len(leaves)
    return 100.0 * steps * arith.fused_adamw_bytes(leaves, True) \
        / HBM_BW / time
