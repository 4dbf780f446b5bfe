"""granite-4.0-h-small [hybrid] — Mamba-2 + NoPE GQA, 72e top-10 MoE + shared.

40L d_model=4096 32H (GQA kv=8, head 128) vocab=100352, tied.
[hf:ibm-granite/granite-4.0-h-small config.json; model_type
granitemoehybrid]  A configuration of the port only: the JAX package has
no counterpart, so it stays out of ``REGISTRY`` and ``ARCH_IDS``.

The published layers (``GraniteMoeHybrid`` in Hugging Face transformers):
36 Mamba-2 mixers (128 heads of 64, d_state 128, one group, chunk 256,
conv 4 with bias) and 4 attention mixers at layers 5, 15, 25 and 35 (32
query heads, 8 KV heads, no position embedding, softmax scale
``attention_multiplier`` 1/128); every layer a MoE of 72 SwiGLU experts
of width 768, top 10 (the softmax over the top-10 router logits, no
capacity, no dropped token), beside one shared SwiGLU of width 1536.  The
embedding is multiplied by 12, each branch's output by 0.22 before its
residual add (the MoE's and the shared expert's summed first), and the
logits divided by 16.  RMSNorm eps 1e-5.

The cut.  The deployment this stands for is two cards that share each
layer's experts (two-way expert parallel, 36 experts a card; attention,
Mamba, the shared expert and the vocabulary replicated).  This
configuration is one card's share at full depth: it holds experts 0-35
of every layer (``experts_held``), routes over all 72 and computes its
own experts' part for the tokens routed to them; what experts 36-71
would add is left out.  Every width is the published one.
"""
from repro_torch.configs.base import (PortMambaConfig, PortModelConfig,
                                      PortMoEConfig)

CONFIG = PortModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,
    vocab_size=100352,
    head_dim=128,
    rms_eps=1e-5,
    tie_embeddings=True,
    moe=PortMoEConfig(
        num_experts=72,
        experts_per_token=10,
        d_ff_expert=768,
        every_n_layers=1,
        experts_held=36,
        first_expert=0,
        shared_d_ff=1536,
    ),
    mamba=PortMambaConfig(d_state=128, expand=2, head_dim=64, d_conv=4,
                          chunk=256, conv_bias=True),
    attn_layer_period=10,
    attn_layer_offset=5,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=0.0078125,
    position_embedding="nope",
    supports_long_context=True,
    long_context_note=(
        "hybrid 1:9 attention:mamba; the 4 NoPE attention layers decode in "
        "O(seq) a token, the Mamba layers in O(1)"),
    source="hf:ibm-granite/granite-4.0-h-small",
)
