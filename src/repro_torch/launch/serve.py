"""Serving driver: continuous-batching generation from MVStore snapshots.

The server is the paper's *versioned reader*: every prefill and decode
step resolves the model parameters at a read clock through
``mv_snapshot``, so serving can share the store with a writer that
commits new parameter versions without ever reading a torn update.
Requests enter a ``RequestQueue``; the ``ContinuousBatchingScheduler``
keeps a fixed slot pool full (a freed slot is re-prefilled at once, the
batch never drains to empty); ``ModelSlotExecutor`` maps slots onto the
prefill/decode step functions.  On the card each prefill's attention
runs the ``flash_attention`` kernel and each Mamba layer's prefill the
``ssd_scan`` kernel; in Mode U every versioned block of every step goes
through ``snapshot_select``.

One parameter resolution per batched decode step, at the OLDEST active
pinned clock: every step reads one consistent snapshot, and a request
admitted after a commit may be served a slightly older consistent
version (bounded by the ring depth).  In Mode Q (unversioned blocks) a
commit during a request makes the snapshot read return ``ok=False``; the
affected requests restart at a fresh clock (counted, and surfaced as
aborts in ``Server.stats()``).

Where the port differs from the reference: torch has no buffer donation,
so the reference's "donated buffer deleted under the reader" abort has
no trigger here (the ``ok=False`` path remains); the decode cache is
updated in place; and a prefilled row is written into a preallocated
cache instead of being zero-padded to ``max_len`` (decode masks by
``cache_len``, so the result is the same).

    python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --requests 8 --prompt-len 512 --gen 32
    python -m repro_torch.launch.serve --arch mamba2-780m \
        --prompt-len 512 --gen 32
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \
        --prompt-len 512 --gen 32
    python -m repro_torch.launch.serve --smoke --device cpu
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --smoke \
        --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs import (ALL_ARCH_IDS, MVStoreConfig, ParallelConfig,
                                 get_config, smoke_config)
from repro_torch.core import mvstore
from repro_torch.core.engine import resolve_device
from repro_torch.core.stats_schema import normalize_stats
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.sharding import tree_map
from repro_torch.models import model_zoo as zoo
from repro_torch.runtime import spans
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import Outcome, Request, RequestQueue
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, \
    StepResult


class _ReaderMetrics(ServeMetrics):
    """ServeMetrics that also announces to a controller ReaderHandle, so
    serving aborts feed the K1/K2/K3 go-versioned heuristics."""

    def __init__(self, reader, **kw):
        super().__init__(**kw)
        self._reader = reader

    def on_snapshot_abort(self, n: int = 1) -> None:
        super().on_snapshot_abort(n)
        self._reader.on_abort(n)

    def on_prefill_retry(self, n: int = 1) -> None:
        super().on_prefill_retry(n)
        self._reader.on_abort(n)

    def on_complete(self, req, now=None, store_clock=None) -> None:
        super().on_complete(req, now=now, store_clock=store_clock)
        self._reader.on_commit(req.max_new, req.pinned_clock)


class ModelSlotExecutor:
    """SlotExecutor over the prefill/decode step functions.

    Owns the batched decode cache (``[group, n_slots, ...]`` leaves:
    attention's k/v up to ``max_len`` positions, a Mamba layer's states;
    allocated at the first prefill in the prefill's dtypes), the
    per-slot cache lengths and last tokens.  A B=1 prefill's cache is
    written into its slot's row — the continuous-batching primitive: one
    slot changes occupant, the other slots' decode stream never pauses.
    Decode steps every slot's cache, a freed slot's too (as the
    reference does); the slot's next insertion overwrites it.
    """

    def __init__(self, cfg, pcfg, mvcfg, state_fn, *, n_slots: int,
                 max_len: int, device, reader=None):
        self.cfg = cfg
        self.mvcfg = mvcfg
        self.state_fn = state_fn
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = device
        self.reader = reader
        self._prefill1 = steps_mod.make_prefill_step(cfg, pcfg, mvcfg)
        self._decode = steps_mod.make_decode_step(cfg, pcfg, mvcfg)
        self.cache = None
        self.cache_len = torch.zeros((n_slots,), dtype=torch.int32,
                                     device=device)
        self.tokens = torch.zeros((n_slots,), dtype=torch.int32,
                                  device=device)
        #: each slot's request id, for the decode span's ``rids``
        self.rids = [-1] * n_slots

    def current_clock(self) -> int:
        return int(self.state_fn().clock)

    def _insert(self, one, slot: int) -> None:
        """Write a B=1 prefilled cache into batch row ``slot``, as the
        reference's ``_insert_fn``: a leaf the prefill left short of the
        full one's (the k/v sequence axis at the prompt's length) fills
        its prefix, and positions past it keep the row's earlier
        contents, which decode never attends (it masks by
        ``cache_len``); a leaf of full size (a Mamba layer's SSM and conv
        states) is overwritten whole.  The cache is allocated at the
        first insertion, each leaf in the prefill's dtype for it."""
        if self.cache is None:
            blank = zoo.init_cache(self.cfg, self.n_slots, self.max_len,
                                   torch.float32, device="meta")
            self.cache = tree_map(
                lambda z, o: torch.zeros(z.shape, dtype=o.dtype,
                                         device=self.device), blank, one)

        def put(full, src):
            src = src[:, 0]
            target = full.shape[:1] + full.shape[2:]
            if any(s > t for s, t in zip(src.shape, target)):
                raise ValueError(
                    f"a prefilled cache leaf {tuple(src.shape)} does not "
                    f"fit {tuple(target)} (max_len={self.max_len})")
            full[:, slot][tuple(slice(0, s) for s in src.shape)].copy_(src)

        tree_map(put, self.cache, one)

    # -- SlotExecutor ----------------------------------------------------
    def prefill(self, slot: int, req: Request, clock: int) -> StepResult:
        with spans.span("serve.prefill", rid=req.rid):
            state = self.state_fn()
            if self.reader is not None:
                self.reader.begin(int(clock))
            tokens = torch.as_tensor(np.asarray(req.payload, np.int32),
                                     device=self.device)[None]
            logits, cache1, len1, ok = self._prefill1(
                state, {"tokens": tokens}, clock)
            with spans.span("serve.readback"):
                okb = bool(ok)
            if not okb:
                return StepResult(False, clock)
            self._insert(cache1, slot)
            self.cache_len[slot] = len1[0]
            self.rids[slot] = req.rid
            tok = torch.argmax(logits[0]).to(torch.int32)
            self.tokens[slot] = tok
            with spans.span("serve.readback"):
                token = int(tok)
            return StepResult(True, int(clock), token=token)

    def decode(self, slots: Sequence[int], clocks: Sequence[int]
               ) -> List[StepResult]:
        # one parameter resolution per batched step, at the oldest
        # active pin (see module docstring for the staleness contract)
        with spans.span("serve.decode",
                        rids=[self.rids[i] for i in slots]):
            rc = min(clocks)
            state = self.state_fn()
            logits, self.cache, self.cache_len, ok = self._decode(
                state, self.cache, self.cache_len, self.tokens, rc)
            self.tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            row = torch.cat([ok.reshape(1).to(torch.int32), self.tokens])
            with spans.span("serve.readback"):
                host = row.cpu().numpy()
            okb = bool(host[0])
            return [StepResult(okb, rc, token=int(host[1 + i]))
                    for i in slots]


class Server:
    """Continuous-batching server over ``batch`` decode slots, on
    ``device`` (the card unless the caller names another; no card raises).

    ``serve_batch`` submits B prompts and returns [B, max_new] tokens;
    requests beyond the slot count queue up and fill freed slots.
    ``submit``/``pump`` are the asynchronous surface: a writer may replace
    ``server.mv_state`` (e.g. with ``mv_commit``) between pumps.
    ``stats()`` reports the normalized TM stats schema, with snapshot-read
    retries counted as aborts.  ``params`` (a tree of tensors) or a ready
    ``mv_state`` skip the random initialisation from ``seed``.
    """

    def __init__(self, cfg, *, batch: int, prompt_len: int, max_len: int,
                 mvcfg=None, controller=None, seed: int = 0, params=None,
                 mv_state=None, device=None):
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.device = resolve_device(device)
        self.pcfg = ParallelConfig(
            remat="none", attn_block_q=min(512, prompt_len),
            attn_block_k=min(512, prompt_len))
        self.mvcfg = mvcfg or MVStoreConfig(mode="Q")
        self.controller = controller
        self.reader = controller.reader() if controller else None
        if mv_state is None:
            if params is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
                params = zoo.init_params(cfg, gen)
            params = tree_map(lambda t: t.to(self.device), params)
            versioned = "all" if self.mvcfg.mode in ("U",) else "none"
            mv_state = mvstore.mv_init(params, self.mvcfg,
                                       versioned=versioned)
        self.mv_state = mv_state
        self.metrics = (_ReaderMetrics(self.reader, seed=seed)
                        if self.reader is not None
                        else ServeMetrics(seed=seed))
        self.queue = RequestQueue(max_depth=max(64, 4 * batch),
                                  n_servers=batch)
        self.executor = ModelSlotExecutor(
            cfg, self.pcfg, self.mvcfg, lambda: self.mv_state,
            n_slots=batch, max_len=max_len, device=self.device,
            reader=self.reader)
        # retry-forever like the original per-batch loop; every retry is
        # still counted and surfaced through stats()
        self.scheduler = ContinuousBatchingScheduler(
            self.queue, self.executor, self.metrics,
            max_request_aborts=1 << 30)
        self._rid = 0

    @property
    def aborts(self) -> int:
        """Snapshot-read retries (prefill + in-flight decode aborts)."""
        return self.metrics.snapshot_aborts + self.metrics.prefill_retries

    # -- async surface ---------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int) -> Request:
        self._rid += 1
        req = Request(rid=self._rid, payload=np.asarray(prompt),
                      max_new=max_new)
        adm = self.queue.offer(req)
        if adm.value != "admitted":
            raise RuntimeError(f"request {req.rid} not admitted: {adm}")
        return req

    def pump(self) -> bool:
        """One scheduler iteration; returns False when idle."""
        return self.scheduler.step()

    # -- sync surface ----------------------------------------------------
    def serve_batch(self, prompts: np.ndarray, max_new: int
                    ) -> np.ndarray:
        """prompts: [B, S] int32 -> generated [B, max_new] int32."""
        reqs = [self.submit(p, max_new) for p in prompts]
        while any(r.outcome is Outcome.PENDING for r in reqs):
            if not self.pump():
                time.sleep(1e-5)
        return np.stack(
            [np.asarray(r.tokens[:max_new], np.int32) for r in reqs])

    def stats(self) -> Dict[str, object]:
        """Serving counters in the normalized TM stats schema."""
        return normalize_stats(
            {"commits": self.metrics.completed,
             "aborts": self.aborts,
             "ro_commits": self.metrics.completed},
            backend="mvserve", mode=self.mvcfg.mode)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve seeded requests from an MVStore snapshot.")
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ALL_ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (CPU tests)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.frontend != "none" or cfg.is_encdec:
        print(f"note: {args.arch} needs frontend embeds; serving the "
              "text path only")
    server = Server(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    max_len=args.prompt_len + args.gen, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(
        0, cfg.vocab_size, size=(args.requests, args.prompt_len),
        dtype=np.int32)
    t0 = time.time()
    out = server.serve_batch(prompts, args.gen)
    dt = time.time() - t0
    m = server.metrics
    print(f"done on {server.device}: {args.requests} requests x {args.gen} "
          f"tokens in {dt:.1f}s ({args.requests * args.gen / dt:.1f} tok/s)"
          f" occupancy={m.occupancy:.2f} "
          f"p50={m.latency.percentile(50) * 1e3:.0f}ms "
          f"p99={m.latency.percentile(99) * 1e3:.0f}ms "
          f"(out shape {out.shape})")
    print(f"stats: {server.stats()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
