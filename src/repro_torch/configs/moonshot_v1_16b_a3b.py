"""moonshot-v1-16b-a3b [moe] — kimi/moonlight-style fine-grained MoE, 64e top-6.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840.
[hf:moonshotai/Moonlight-16B-A3B; hf]

Fine-grained experts (d_ff_expert=1408), 64 experts top-6, every layer MoE.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    head_dim=128,
    moe=MoEConfig(
        num_experts=64,
        experts_per_token=6,
        d_ff_expert=1408,
        every_n_layers=1,
    ),
    supports_long_context=False,
    long_context_note="pure full attention decoder",
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
