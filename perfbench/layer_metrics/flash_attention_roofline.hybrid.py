"""Prefill attention of a hybrid stack: the frozen bound of each window
prefill's attention layers (those ``layer_types`` names; batch 1,
causal, the prompt's length, heads of hidden_size / num_attention_heads)
over the device time of the ``flash_attention`` launches the prefills
made, in per cent."""
from perfbench.frozen import arith
from perfbench.frozen.peaks import bound_seconds

KERNEL = "flash_attention_kernel"
LABEL = "serve.prefill"


def read(out, ctx):
    red = out.readings.get("trace")
    lengths = out.readings.get("prefill_lengths")
    if red is None or not lengths:
        return None
    c = ctx.config
    time = sum(v for (lb, k), v in red.by_label.items()
               if lb == LABEL and KERNEL in k)
    n = sum(v for (lb, k), v in red.launches.items()
            if lb == LABEL and KERNEL in k)
    if not time or not n:
        return None
    L = c["layer_types"].count("attention")
    H = c["num_attention_heads"]
    bound = sum(bound_seconds(*arith.flash_attention_work(
        1, S, S, H, c["num_key_value_heads"], c["hidden_size"] // H, True,
        arith.ITEMSIZE[c["dtype"]]), c["dtype"]) for S in lengths) * L
    # launches the trace holds against those the window's prefills made
    return 100.0 * bound * (n / (L * len(lengths))) / time
