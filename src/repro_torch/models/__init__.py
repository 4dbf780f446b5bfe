"""Models of the port: the decoder-only stack (``transformer``) over
attention (``attention``, whose prefill runs the ``flash_attention``
kernel on the card), the Mamba-2 mixer (``mamba``, whose prefill runs
the ``ssd_scan`` kernel on the card) and MoE FFNs (``moe``); the
encoder-decoder (``encdec``: a bidirectional encoder, a causal decoder
with cross-attention); SwiGLU FFN and RMSNorm/RoPE; all behind
``model_zoo``."""
