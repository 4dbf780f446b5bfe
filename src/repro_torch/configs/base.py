"""Configuration dataclasses of the port.

This package's own copy of the reference's ``configs/base.py``: the same
fields, defaults and derived properties.  Every architecture is a
``ModelConfig``; input-shape cells are ``ShapeConfig``s; parallel and
runtime knobs live in ``ParallelConfig`` and the store's in
``MVStoreConfig``.  Configs are frozen dataclasses, so they hash and
print reproducibly.  The port runs one device, so of ``ParallelConfig``
only the attention and decode knobs are read (``attn_impl``,
``attn_block_q``/``attn_block_k``, ``decode_attn_chunk``,
``gather_mode``); the sharding fields are kept so a configuration reads
the same in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# ---------------------------------------------------------------------------
# Shape cells: seq_len x global_batch, and which step they drive.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Parallelism / performance knobs.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelConfig:
    """Execution knobs of a step (the reference's sharding fields kept)."""

    fsdp: bool = True
    microbatches: int = 1
    remat: str = "block"              # 'none' | 'block'
    attn_impl: str = "blockwise"      # 'blockwise' | 'pallas' | 'naive'
    attn_block_q: int = 1024          # blockwise-attention tile sizes
    attn_block_k: int = 1024
    decode_attn_chunk: int = 0        # 0 = unchunked decode attention
    pipeline_stages: int = 1
    moe_capacity_factor: float = 1.25
    gather_mode: str = "take"         # embedding lookup: 'take' | 'onehot'
    scan_layers: bool = True
    probe_unroll: bool = False


@dataclass(frozen=True)
class MVStoreConfig:
    """The paper's technique (dynamic multiversioning) at the parameter-store
    level.  ``ring_slots`` is R, the bounded version-list length.  ``mode``
    selects the local mode of a commit ('Q' = unversioned fast path, 'U' =
    copy-on-write versioned commit).  See core/mvstore.py.
    """

    enabled: bool = True
    ring_slots: int = 2
    mode: str = "Q"                   # local mode of the commit
    fused_commit: bool = False        # the trainer's fused optimizer path

    def replace(self, **kw) -> "MVStoreConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Model architecture.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    num_shared_experts: int = 0
    every_n_layers: int = 1           # MoE replaces FFN every n layers
    router_aux_weight: float = 0.01

    # -- settings of ``PortMoEConfig``, neutral here ----------------------
    @property
    def experts_held(self) -> int:
        """Experts whose weights this device holds (all of them)."""
        return self.num_experts

    @property
    def first_expert(self) -> int:
        """Router index of the first held expert."""
        return 0

    @property
    def dropless(self) -> bool:
        """Route every token to its top k with no capacity bound."""
        return False

    @property
    def shared_d_ff(self) -> int:
        """Width of the shared SwiGLU beside the routed experts."""
        return self.d_ff_expert * self.num_shared_experts


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    d_conv: int = 4
    chunk: int = 256

    # -- settings of ``PortMambaConfig``, neutral here --------------------
    @property
    def conv_bias(self) -> bool:
        """A bias on the x, B and C convolutions."""
        return False

    @property
    def n_groups(self) -> int:
        """Groups of B and C (the mixer has one)."""
        return 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: MoEConfig = field(default_factory=MoEConfig)
    mamba: MambaConfig = field(default_factory=MambaConfig)
    attn_layer_period: int = 0        # hybrid: 1 attention layer per period
    attn_layer_offset: int = 0
    is_encdec: bool = False
    n_encoder_layers: int = 0
    frontend: str = "none"            # none | vision | audio
    frontend_len: int = 0
    supports_long_context: bool = False
    long_context_note: str = ""
    dtype: str = "bfloat16"
    source: str = ""

    # -- derived ---------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def padded_vocab(self, multiple: int = 256) -> int:
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        if m.num_experts == 0:
            return False
        return (i % m.every_n_layers) == (m.every_n_layers - 1)

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid archs: which mixer a layer uses (attention vs mamba)."""
        if self.family == "ssm":
            return False
        if self.attn_layer_period <= 0:
            return True
        return (i % self.attn_layer_period) == self.attn_layer_offset

    @property
    def layer_types(self) -> List[str]:
        """``"attention"`` or ``"mamba"``: each layer's mixer."""
        return ["attention" if self.is_attn_layer(i) else "mamba"
                for i in range(self.n_layers)]

    # -- settings of ``PortModelConfig``, neutral here --------------------
    @property
    def embedding_multiplier(self) -> float:
        """Factor on the embedded tokens."""
        return 1.0

    @property
    def residual_multiplier(self) -> float:
        """Factor on each mixer's and FFN's output before the residual
        add."""
        return 1.0

    @property
    def logits_scaling(self) -> float:
        """Divisor of the output logits."""
        return 1.0

    @property
    def attention_multiplier(self) -> Optional[float]:
        """Softmax scale of attention (None: 1/sqrt(head dim))."""
        return None

    @property
    def position_embedding(self) -> str:
        """``"rope"`` or ``"nope"`` (no position embedding)."""
        return "rope"

    def supports_shape(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """Whether a shape cell is runnable; returns (ok, skip-reason)."""
        if shape.name == "long_500k" and not self.supports_long_context:
            return False, ("long_500k skipped: pure full-attention arch (no "
                           "sub-quadratic path)")
        return True, ""


# ---------------------------------------------------------------------------
# Port-only settings.  The JAX package's configurations have none of these
# fields, so they live on subclasses: ``dataclasses.asdict`` of every
# configuration of ``REGISTRY`` stays the reference's, field for field,
# and the base classes answer each setting with its neutral value (the
# properties above), so a layer reads ``cfg.<setting>`` of either.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PortMoEConfig(MoEConfig):
    """A dropless expert layer: it routes every token to its top k with
    no capacity bound, and holds ``experts_held`` of the router's
    ``num_experts`` experts (None: all of them), from ``first_expert`` on
    (its device's share under expert parallelism); a shared SwiGLU of
    width ``shared_d_ff`` (0: none) beside them."""
    experts_held: Optional[int] = None
    first_expert: int = 0
    shared_d_ff: int = 0

    def __post_init__(self):
        if self.experts_held is None:
            object.__setattr__(self, "experts_held", self.num_experts)
        if not (0 < self.experts_held and 0 <= self.first_expert
                and self.first_expert + self.experts_held
                <= self.num_experts):
            raise ValueError(
                f"experts {self.first_expert}.."
                f"{self.first_expert + self.experts_held - 1} held of "
                f"{self.num_experts}")

    @property
    def dropless(self) -> bool:
        """Always: this layer has no capacity path."""
        return True


@dataclass(frozen=True)
class PortMambaConfig(MambaConfig):
    """A Mamba-2 mixer with a bias on its convolutions."""
    conv_bias: bool = True


@dataclass(frozen=True)
class PortModelConfig(ModelConfig):
    """A decoder with scaled embeddings, residual branches and logits, a
    set softmax scale, and a choice of position embedding."""
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: Optional[float] = None
    position_embedding: str = "rope"


@dataclass(frozen=True)
class RunConfig:
    """One fully-specified run: arch x shape x parallelism x MVStore mode."""

    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    mvstore: MVStoreConfig = field(default_factory=MVStoreConfig)
    seed: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
