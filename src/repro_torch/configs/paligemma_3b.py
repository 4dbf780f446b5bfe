"""paligemma-3b [vlm] — SigLIP vision frontend (stub) + gemma decoder.

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.  [arXiv:2407.07726; hf]

The modality frontend is a stub: a batch carries precomputed patch
embeddings (224px/14 -> 256 patches, ``batch["patch_embeds"]``) that are
prepended to the token embeddings.  gemma uses head_dim=256 (8 heads x 256 =
2048) and MQA (kv=1).  Vocab 257216 is 16-divisible; padded to %256 anyway.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    frontend="vision",
    frontend_len=256,
    supports_long_context=False,
    long_context_note="pure full attention decoder",
    source="arXiv:2407.07726; hf",
)
