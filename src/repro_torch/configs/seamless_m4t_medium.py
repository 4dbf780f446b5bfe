"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.  [arXiv:2308.11596; hf]

The audio frontend is a stub: a batch carries precomputed frame
embeddings (``batch["frame_embeds"]``, 4096 frames) for the encoder.  12
encoder + 12 decoder layers; a decode step runs the decoder (self-KV
cache of the text, cross-attention over the 4096-frame encoder output).
Vocab 256206 is not 16-divisible; padded to a multiple of 256 (256256).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    is_encdec=True,
    n_encoder_layers=12,
    frontend="audio",
    frontend_len=4096,
    supports_long_context=False,
    long_context_note="enc-dec full attention",
    source="arXiv:2308.11596; hf",
)
