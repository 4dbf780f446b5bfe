"""mamba2-780m [ssm] — attention-free, SSD (state-space duality).

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128.  [arXiv:2405.21060; unverified]

d_inner = expand*d_model = 3072, SSD head_dim 64 -> 48 SSD heads.
Vocab 50280 is not 16-divisible; padded to a multiple of 256 (50432)
(logits over pad ids are masked to -inf in the loss).
Attention-free: O(1) decode state, chunked-scan prefill.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    mamba=MambaConfig(d_state=128, expand=2, head_dim=64, d_conv=4, chunk=256),
    tie_embeddings=True,
    supports_long_context=True,
    long_context_note="pure SSM: O(1) state decode, chunked-scan prefill",
    source="arXiv:2405.21060; unverified",
)
