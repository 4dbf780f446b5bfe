"""Models of the port: the decoder-only family (``transformer``) over
attention (``attention``, whose prefill runs the ``flash_attention``
kernel on the card), SwiGLU FFN and RMSNorm/RoPE, behind ``model_zoo``.
The Mamba, MoE and encoder-decoder families are not ported yet."""
