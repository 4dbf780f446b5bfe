"""The closed loop over the program's ``Server``, and what the window's
figures are taken from.

The loop keeps ``slots + queued`` requests outstanding: as one completes
the next is submitted, so the offered load is fixed by the mix and
nothing searches for a rate.  After every ``pump`` each outstanding
request's new tokens are stamped with the host clock; a request whose
tokens are thrown away (a snapshot abort restarts it) loses their stamps
too.  The benchmark times the executor's ``prefill`` and ``decode`` from
its own code (a span around each call into the layer, with a profiler
label of the same name)."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from perfbench.harness.traffic import Requests


@dataclasses.dataclass
class Rec:
    index: int
    prompt: np.ndarray
    req: object
    times: List[float] = dataclasses.field(default_factory=list)
    aborts: int = 0


class Spans:
    """Host time and calls of each wrapped call, counted only while
    ``on``."""

    def __init__(self):
        self.on = False
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    def wrap(self, name: str, fn: Callable) -> Callable:
        def call(*a, **k):
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                dt = time.perf_counter() - t0
            if self.on:
                self.seconds[name] = self.seconds.get(name, 0.0) + dt
                self.calls[name] = self.calls.get(name, 0) + 1
            return out
        return call


class ClosedLoop:
    def __init__(self, server, requests: Requests, queued: int,
                 spans: Spans):
        self.server = server
        self.requests = requests
        self.cap = server.batch + queued
        self.spans = spans
        self.next = 0
        self.open: List[Rec] = []
        self.done: List[Rec] = []
        self.failed: List[Rec] = []
        #: tokens prefilled and decoded while ``spans.on``, and the
        #: prompt length of each prefill then
        self.prefilled = 0
        self.decoded = 0
        self.prefill_lengths: List[int] = []
        ex = server.executor
        prefill = spans.wrap("serve.prefill", ex.prefill)
        decode = spans.wrap("serve.decode", ex.decode)

        def counted_prefill(slot, req, clock):
            if spans.on:
                self.prefilled += len(req.payload)
                self.prefill_lengths.append(len(req.payload))
            return prefill(slot, req, clock)

        def counted_decode(slots, clocks):
            if spans.on:
                self.decoded += len(slots)
            return decode(slots, clocks)

        ex.prefill = counted_prefill
        ex.decode = counted_decode

    def fill(self) -> None:
        while len(self.open) < self.cap:
            p = self.requests.prompt(self.next)
            req = self.server.submit(p, self.requests.gen_tokens)
            self.open.append(Rec(self.next, p, req))
            self.next += 1

    def pump(self, fill: bool = True) -> bool:
        if fill:
            self.fill()
        with torch.profiler.record_function("serve.pump"):
            worked = self.server.pump()
        now = time.perf_counter()
        still = []
        for r in self.open:
            req = r.req
            if req.aborts != r.aborts:
                r.aborts = req.aborts
                r.times.clear()
            n = len(req.tokens)
            del r.times[n:]
            r.times.extend([now] * (n - len(r.times)))
            state = req.outcome.value
            if state == "completed":
                self.done.append(r)
            elif state != "pending":
                self.failed.append(r)
            else:
                still.append(r)
        self.open = still
        return worked

    def run_until(self, stop: Callable[[], bool]) -> None:
        while not stop():
            if not self.pump():
                time.sleep(1e-4)

    def drain(self, need: int) -> List[Rec]:
        """After the window: submit nothing more and pump until ``need``
        of the requests outstanding at its close have finished (untimed;
        the check may judge them).  Returns those finished."""
        tracked = list(self.open)
        finished: List[Rec] = []
        while need > 0 and self.open:
            self.pump(fill=False)
            finished = [r for r in tracked if r in self.done]
            if len(finished) >= need:
                break
        return finished

    # -- the window's figures ---------------------------------------------
    def tokens_in(self, t0: float, t1: float) -> int:
        return sum(sum(1 for t in r.times if t0 <= t < t1)
                   for r in self.done + self.open)

    def gaps_in(self, t0: float, t1: float) -> List[float]:
        """Every gap between two consecutive tokens of a request, both
        inside the window, of every request."""
        out = []
        for r in self.done + self.open:
            ts = [t for t in r.times if t0 <= t < t1]
            out.extend(b - a for a, b in zip(ts, ts[1:]))
        return out

    def finished_in(self, t0: float, t1: float) -> List[Rec]:
        return [r for r in self.done if r.times and t0 <= r.times[-1] < t1]

    def failed_in(self, t0: float, t1: float) -> List[Rec]:
        return [r for r in self.failed
                if r.req.t_done >= 0 and t0 <= r.req.t_done < t1]


def start_server(ctx, pcfg, w, dev, mv_state=None):
    """The program's ``Server`` as the mix sets it up: its mode, slots and
    longest prompt plus the tokens out; over the weights ``w`` or a
    store ``mv_state`` the caller already has."""
    from repro_torch.configs import MVStoreConfig
    from repro_torch.launch.serve import Server
    mix = ctx.traffic
    longest = mix["prompt_len"]["max"]
    mv = MVStoreConfig(mode=mix["mode"],
                       ring_slots=ctx.config["mvstore"]["ring_slots"])
    return Server(pcfg, batch=mix["slots"], prompt_len=longest,
                  max_len=longest + mix["gen_tokens"], mvcfg=mv,
                  params=w, mv_state=mv_state, device=dev)


def warm(loop: ClosedLoop, tokens: int) -> None:
    """Run the loop until every slot holds a request that has produced
    ``tokens`` tokens (or finished)."""
    slots = loop.server.batch
    loop.run_until(lambda: len(loop.done) + sum(
        len(r.times) >= tokens for r in loop.open) >= slots)


def window_figures(loop: ClosedLoop, t0: float, t1: float) -> dict:
    """The serving end-to-end figures of the window [t0, t1)."""
    gaps = loop.gaps_in(t0, t1)
    return {"gen_tokens_per_s": loop.tokens_in(t0, t1) / (t1 - t0),
            "token_gap_p95_ms": p95(gaps) * 1e3,
            "gap_samples": len(gaps)}


def p95(xs: List[float]) -> float:
    """The 95th percentile, interpolated between order statistics."""
    return float(np.percentile(np.asarray(xs, dtype=np.float64), 95)) \
        if xs else float("nan")


def sample(recs: List[Rec], seed: int, n: int) -> List[Rec]:
    """``n`` of ``recs`` drawn from the seed, the longest prompt among
    them."""
    if not recs:
        return []
    longest = max(recs, key=lambda r: (len(r.prompt), r.index))
    rest = [r for r in recs if r is not longest]
    rng = np.random.Generator(np.random.Philox(key=int(seed),
                                               counter=[4, 0, 0, 0]))
    pick = rng.permutation(len(rest))[:max(n - 1, 0)]
    return [longest] + [rest[i] for i in sorted(pick)]


def widest_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """How far the served tokens' logits lie below the reference's best
    at their positions, the widest over all positions (0 where every
    served token is the reference's own argmax)."""
    best = ref_logits.max(dim=-1).values
    got = torch.gather(ref_logits, -1, served.long()[:, None])[:, 0]
    return float((best - got).max())


class GapStats:
    """Where the served tokens' gaps lie: the first token's (the
    prefill's) against the later ones', and how many are off the
    reference's argmax at all."""

    def __init__(self):
        self.first = 0.0
        self.rest = 0.0
        self.off = 0
        self.n = 0
        self.margin = []

    def add(self, ref_logits: torch.Tensor, served: torch.Tensor) -> None:
        best = ref_logits.max(dim=-1).values
        got = torch.gather(ref_logits, -1, served.long()[:, None])[:, 0]
        g = (best - got).float().cpu()
        top2 = ref_logits.topk(2, dim=-1).values
        self.margin.append(float((top2[:, 0] - top2[:, 1]).median()))
        self.first = max(self.first, float(g[0]))
        if len(g) > 1:
            self.rest = max(self.rest, float(g[1:].max()))
        self.off += int((g > 0).sum())
        self.n += len(g)

    def summary(self) -> dict:
        return {"first": self.first, "rest": self.rest, "off": self.off,
                "tokens": self.n,
                "median_top2_margin": float(np.median(self.margin))
                if self.margin else None}


def first_gap(ref_logits: torch.Tensor, other_logits: torch.Tensor) -> float:
    """The widest gap of the token another computation puts first."""
    return widest_gap(ref_logits, other_logits.argmax(dim=-1))


