"""Models of the port: the decoder-only stack (``transformer``) over
attention (``attention``, whose prefill runs the ``flash_attention``
kernel on the card) and the Mamba-2 mixer (``mamba``, whose prefill runs
the ``ssd_scan`` kernel on the card), SwiGLU FFN and RMSNorm/RoPE,
behind ``model_zoo``.  The MoE and encoder-decoder families are not
ported yet."""
