"""Prefill attention: the frozen bound of every prefill's layers in the
window (batch 1, causal, the prompt's length) over the device time of
the ``flash_attention`` launches the prefills made, in per cent."""
from perfbench.frozen import arith
from perfbench.frozen.peaks import bound_seconds

KERNEL = "flash_attention_kernel"


def read(out, ctx):
    red = out.readings.get("trace")
    lengths = out.readings.get("prefill_lengths")
    if red is None or not lengths:
        return None
    c = ctx.config
    time = sum(v for (lb, k), v in red.by_label.items()
               if lb == "serve.prefill" and KERNEL in k)
    n = sum(v for (lb, k), v in red.launches.items()
            if lb == "serve.prefill" and KERNEL in k)
    if not time or not n:
        return None
    L = c["num_hidden_layers"]
    bound = sum(bound_seconds(*arith.flash_attention_work(
        1, S, S, c["num_attention_heads"], c["num_key_value_heads"],
        c["head_dim"], True, arith.ITEMSIZE[c["dtype"]]), c["dtype"])
        for S in lengths) * L
    # launches the trace holds against those the window's prefills made
    return 100.0 * bound * (n / (L * len(lengths))) / time
