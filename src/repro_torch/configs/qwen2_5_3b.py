"""qwen2.5-3b [dense] — GQA with QKV bias.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
[hf:Qwen/Qwen2.5-0.5B family scaling; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
    supports_long_context=False,
    long_context_note="pure full attention decoder",
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
