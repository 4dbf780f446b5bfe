"""Deterministic synthetic data pipeline.

This package's own copy of the JAX package's ``data/pipeline.py``
(numpy only): the same Philox streams, so both packages draw the same
batches bit for bit.

Each (step, shard) pair maps to an independent counter-based stream, so:
  * every data-parallel host materializes ONLY its shard (no host holds the
    global batch);
  * restarts are exactly reproducible (checkpoint stores just the step);
  * elastic rescaling re-partitions deterministically (shard i of N draws
    the same tokens regardless of which host computes it).

The token process is a noisy affine walk over the vocab — enough structure
that a small LM's loss falls measurably within tens of steps (the e2e
test's assertion), with an exact analytic entropy floor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: int = 3          # next = a*tok + c + U[0, noise)  (mod V)
    a: int = 5
    c: int = 17

    def shard_batch(self, step: int, shard: int, n_shards: int
                    ) -> Dict[str, np.ndarray]:
        """The rows of the global batch owned by ``shard``."""
        assert self.global_batch % n_shards == 0
        rows = self.global_batch // n_shards
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[step, shard, 0, 0]))
        start = rng.integers(0, self.vocab_size, size=(rows, 1))
        steps = rng.integers(0, self.noise,
                             size=(rows, self.seq_len))
        toks = np.empty((rows, self.seq_len + 1), np.int64)
        toks[:, 0] = start[:, 0]
        for t in range(self.seq_len):
            toks[:, t + 1] = (self.a * toks[:, t] + self.c
                              + steps[:, t]) % self.vocab_size
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return self.shard_batch(step, 0, 1)

    def entropy_floor(self) -> float:
        return float(np.log(self.noise))


def make_batch_iterator(cfg: ModelConfig, shape: ShapeConfig, *,
                        seed: int = 0, shard: int = 0, n_shards: int = 1,
                        start_step: int = 0,
                        frontend_dim: Optional[int] = None
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Batches for a model config: tokens/labels (+ stub frontend
    embeddings for vlm/audio archs)."""
    text_len = shape.seq_len - (cfg.frontend_len
                                if cfg.frontend == "vision" else 0)
    src = SyntheticLM(cfg.vocab_size, text_len, shape.global_batch,
                      seed=seed)
    d = frontend_dim or cfg.d_model
    step = start_step
    while True:
        batch = src.shard_batch(step, shard, n_shards)
        if cfg.frontend == "vision":
            rng = np.random.Generator(np.random.Philox(
                key=seed + 1, counter=[step, shard, 0, 0]))
            batch["patch_embeds"] = rng.standard_normal(
                (batch["tokens"].shape[0], cfg.frontend_len, d),
                dtype=np.float32)
        if cfg.frontend == "audio":
            rng = np.random.Generator(np.random.Philox(
                key=seed + 1, counter=[step, shard, 0, 0]))
            batch["frame_embeds"] = rng.standard_normal(
                (batch["tokens"].shape[0], cfg.frontend_len, d),
                dtype=np.float32)
        yield batch
        step += 1
