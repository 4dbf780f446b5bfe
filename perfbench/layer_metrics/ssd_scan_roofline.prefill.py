"""The prefills' SSD scans: the frozen bound of a scan of each window
prefill's prompt (batch 1, the configuration's Mamba widths) over the
device time of the ``ssd_scan`` launches the prefills made, in per cent
(four kernels a call, one of them ``ssd_scan_kernel_out``)."""
from perfbench.frozen import arith
from perfbench.frozen.peaks import bound_seconds

KERNEL = "ssd_scan_kernel"
CALL = "ssd_scan_kernel_out"           # one a call
LABEL = "serve.prefill"


def read(out, ctx):
    red = out.readings.get("trace")
    lengths = out.readings.get("prefill_lengths")
    if red is None or not lengths:
        return None
    c = ctx.config
    time = sum(v for (lb, k), v in red.by_label.items()
               if lb == LABEL and KERNEL in k)
    calls = sum(n for (lb, k), n in red.launches.items()
                if lb == LABEL and CALL in k)
    if not calls or not time:
        return None
    di = c["mamba_expand"] * c["hidden_size"]
    mean = sum(bound_seconds(*arith.ssd_scan_work(
        1, S, di // c["mamba_d_head"], c["mamba_d_head"], c["mamba_d_state"],
        c["mamba_chunk_size"], arith.ITEMSIZE[c["dtype"]]), c["dtype"])
        for S in lengths) / len(lengths)
    # the launches the trace holds, each at the window's mean prompt
    return 100.0 * calls * mean / time
