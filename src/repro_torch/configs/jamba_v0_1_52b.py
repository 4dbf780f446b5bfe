"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  [arXiv:2403.19887; hf]

Real Jamba uses attn_layer_period=8 / offset=4 and MoE every 2nd layer with
16 experts top-2; its mamba mixer is Mamba-1 with d_state=16 — the model
uses the SSD (Mamba-2 style) mixer with d_state=16 instead, as the JAX
package does (the chunked SSD form of the same SSM, which the ``ssd_scan``
kernel computes).
Hybrid + SSM decode path -> supports long_500k.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    moe=MoEConfig(
        num_experts=16,
        experts_per_token=2,
        d_ff_expert=14336,
        every_n_layers=2,
    ),
    mamba=MambaConfig(d_state=16, expand=2, head_dim=64, d_conv=4, chunk=256),
    attn_layer_period=8,
    attn_layer_offset=4,
    supports_long_context=True,
    long_context_note=(
        "hybrid 1:7 attn:mamba; the 4 attention layers decode in O(seq) per "
        "token against a 500k KV cache that fits when sharded"
    ),
    source="arXiv:2403.19887; hf",
)
