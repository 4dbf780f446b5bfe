"""llama4-scout-17b-a16e [moe] — MoE 16e top-1 + shared expert, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Llama-4 routes top-1 over 16 experts plus one always-on shared expert;
every layer is MoE.  (Its interleaved NoPE/chunked attention is not modeled;
we treat it as full attention -> long_500k skipped.)
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    moe=MoEConfig(
        num_experts=16,
        experts_per_token=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        every_n_layers=1,
    ),
    supports_long_context=False,
    long_context_note="treated as full attention (chunked-attn not modeled)",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
