"""The training step's SSD scans: the frozen bound of every call the
trainer launched in the traced window (four kernels a call) over their
device time, in per cent."""
from perfbench.frozen import arith
from perfbench.frozen.peaks import bound_seconds

KERNEL = "ssd_scan_kernel"
CALL = "ssd_scan_kernel_out"           # one a call


def read(out, ctx):
    red = out.readings.get("trace")
    if red is None:
        return None
    c, t = ctx.config, ctx.traffic["train"]
    time = sum(v for (lb, k), v in red.by_label.items()
               if lb == "train.step" and KERNEL in k)
    calls = sum(n for (lb, k), n in red.launches.items()
                if lb == "train.step" and CALL in k)
    if not calls or not time:
        return None
    di = c["expand"] * c["d_model"]
    flops, nbytes = arith.ssd_scan_work(
        t["rows"], t["seq"], di // c["headdim"], c["headdim"],
        c["d_state"], c["chunk_size"], arith.ITEMSIZE[c["dtype"]])
    return 100.0 * calls * bound_seconds(flops, nbytes, c["dtype"]) / time
