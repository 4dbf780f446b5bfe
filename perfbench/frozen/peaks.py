"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

#: FLOP/s by operand dtype: bf16 on the tensor cores, f32 off them
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: bytes/s of HBM3
HBM_BW = 3.35e12


def bound_seconds(flops: float, nbytes: float, dtype: str = "bfloat16"
                  ) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BW)
