"""Parameter counts, model flops and the kernels' operations and bytes,
from a configuration file's published keys alone.

Counting rules (the benchmark's, whatever the program counts):
  - model flops: 6 N a trained token, 2 N a prefilled or generated token,
    N the parameters a token uses (the embedding table only where it is
    tied to the output head: a lookup is no product);
  - a kernel's operations: what its inputs need, so a causal product
    counts the lower triangle of its square, not the whole square;
  - a kernel's bytes: each input read once and each output written once.
"""
from __future__ import annotations

from typing import List, Tuple

#: bytes of each dtype name
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def padded_vocab(cfg: dict) -> int:
    return int(cfg["vocab_padded"])


def param_leaves(cfg: dict) -> List[Tuple[str, int, str]]:
    """``(name, elements, dtype)`` of every parameter leaf, the layers of
    one kind stacked into one leaf, as the program stores them (the norms,
    the SSM's per-head vectors and its conv filters are float32)."""
    fam = cfg["family"]
    dt = cfg["dtype"]
    V = padded_vocab(cfg)
    if fam == "mamba2":
        d, L = cfg["d_model"], cfg["n_layer"]
        di = cfg["expand"] * d
        N, K = cfg["d_state"], cfg["d_conv"]
        H = di // cfg["headdim"]
        per = [("norm_mixer", d, "float32"), ("w_z", d * di, dt),
               ("w_x", d * di, dt), ("w_B", d * N, dt), ("w_C", d * N, dt),
               ("w_dt", d * H, dt), ("conv_x", K * di, "float32"),
               ("conv_B", K * N, "float32"), ("conv_C", K * N, "float32"),
               ("A_log", H, "float32"), ("D", H, "float32"),
               ("dt_bias", H, "float32"), ("norm", di, "float32"),
               ("w_out", di * d, dt)]
        out = [("embed", V * d, dt), ("final_norm", d, "float32")]
    elif fam == "dense":
        d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
        h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        dh, ff = cfg["head_dim"], cfg["intermediate_size"]
        per = [("norm_mixer", d, "float32"), ("w_q", d * h * dh, dt),
               ("w_k", d * kv * dh, dt), ("w_v", d * kv * dh, dt),
               ("w_o", h * dh * d, dt), ("norm_ffn", d, "float32"),
               ("w_gate", d * ff, dt), ("w_up", d * ff, dt),
               ("w_down", ff * d, dt)]
        out = [("embed", V * d, dt), ("final_norm", d, "float32")]
        if not cfg["tie_word_embeddings"]:
            out.append(("lm_head", d * V, dt))
    else:
        raise KeyError(f"no parameter table for family {fam!r}")
    return out + [(n, L * e, t) for n, e, t in per]


def active_params(cfg: dict) -> int:
    """Parameters a token uses: all but an untied embedding table."""
    tied = cfg.get("tie_embeddings", cfg.get("tie_word_embeddings"))
    return sum(e for n, e, _ in param_leaves(cfg)
               if n != "embed" or tied)


def train_flops(cfg: dict, tokens: int) -> float:
    return 6.0 * active_params(cfg) * tokens


def serve_flops(cfg: dict, tokens: int) -> float:
    return 2.0 * active_params(cfg) * tokens


# ---------------------------------------------------------------------------
# kernels: (flops, bytes) of one call
# ---------------------------------------------------------------------------


def ssd_scan_work(B: int, S: int, H: int, P: int, N: int, chunk: int,
                  itemsize: int = 2) -> Tuple[float, float]:
    """One chunked SSD scan over x [B, S, H, P], dt [B, S, H] f32, A [H]
    f32, B and C [B, S, N].  Operations per token: C.B^T over the causal
    part of its chunk, the chunk state and the carried state's output
    (2 N H P), and the chunk's own rows' output over the causal part.
    Bytes: x read and y written, dt and A, B and C, the initial and the
    final state (f32)."""
    Q = min(chunk, S)
    tri = (Q + 1) / 2.0
    flops = 2.0 * B * S * (tri * N + 2 * N * H * P + H * tri * P)
    nbytes = (2 * B * S * H * P * itemsize + 4 * (B * S * H + H)
              + 4 * 2 * B * H * N * P + 2 * B * S * N * itemsize)
    return flops, float(nbytes)


def flash_attention_work(B: int, Sq: int, Sk: int, H: int, KV: int, D: int,
                         causal: bool, itemsize: int = 2
                         ) -> Tuple[float, float]:
    """Attention of q [B, Sq, H, D] over k, v [B, Sk, KV, D]: both products
    over the pairs the mask keeps (a causal call with Sq == Sk keeps
    Sq (Sq + 1) / 2 of them); q, k, v read and the output written once."""
    if causal:                  # query i sees keys 0 .. (Sk - Sq) + i
        pairs = Sq * (Sk - Sq) + Sq * (Sq + 1) / 2.0
    else:
        pairs = Sq * Sk
    flops = 4.0 * B * H * D * pairs
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KV * D) * itemsize
    return flops, float(nbytes)


def fused_adamw_bytes(leaves: List[Tuple[str, int, str]],
                      ring: bool) -> float:
    """One optimizer step over every leaf: p, g (the parameter's dtype), m
    and v (f32) read; p', m', v' and, with a ring, the ring row written."""
    total = 0
    for _, n, dt in leaves:
        e = ITEMSIZE[dt]
        per = 2 * e + e + 16 + (e if ring else 0)
        total += n * per
    return float(total)


def snapshot_select_bytes(leaves: List[Tuple[str, int, str]],
                          ring_slots: int) -> float:
    """One resolve of every leaf: the chosen row read and written, the
    timestamps and the clock read."""
    return float(sum(2 * n * ITEMSIZE[dt] + 4 * ring_slots + 4
                     for _, n, dt in leaves))


__all__ = ["ITEMSIZE", "active_params", "flash_attention_work",
           "fused_adamw_bytes", "param_leaves", "serve_flops",
           "snapshot_select_bytes", "ssd_scan_work", "train_flops"]
