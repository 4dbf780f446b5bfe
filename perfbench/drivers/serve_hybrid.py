"""A server without a writer over a hybrid model: ``drivers/serve.py``'s
closed loop and window, with the reference module the configuration
names (``reference``), the model flops of ``frozen/hybrid_arith`` and
the program's expert-row counter.

Set-up: the kernels, the weights made from the seed on the card, the
server, and the loop brought to its steady state (``stagger``) and run
until every slot has decoded a few tokens (so the window starts with the
batch full and the hybrid cache allocated).  Every request of a mix asks
for the same number of tokens, so a first wave admitted at once would
decode in step to its end, all its slots' next prefills in one pump; the
first wave is staggered instead, and the window sees prefills between
decode steps as a server that has run for a while does.  Its tokens
come unevenly: a group's pump (four prefills) takes ~2 s for 68 tokens,
the ~7 decode steps after it 64 tokens each 0.2 s, and a window's end
cuts that cycle at a point the program's speed sets, which moves a
count over the whole window by up to ~3 %.  So ``gen_tokens_per_s`` is
the rate over whole cycles (``steady_rate``): the tokens from the end of
the window's first pump that admitted a request to the end of its last
one, over that time.
After the window: the peak memory and the counter are read; where fewer
requests finished in the window than the check takes, the loop runs on
(untimed, nothing new submitted) until that many of those outstanding
have finished; the server is freed, a sample of the finished requests
drawn from the seed (the longest prompt among them), the weights made
again, and each sampled request's prompt and served tokens run through
the reference in one pass.  Two numbers are compared: the widest gap by
which a served token's logit lies below the reference's best
(``served_logit_gap``), and the median of those gaps over the served
tokens that are not the reference's best (``served_off_gap_median``, 0
where none is).  With random weights many positions hold near ties that
rounding breaks either way, and how many depends on the sample; the
gap of a broken tie does not: it is as wide as the logits' error, so it
tells a computation in a lower precision than the configuration's from
the program, which the widest gap (its tail is a flipped routing choice
now and then) and the share of broken ties (it follows the sample's
ties) do not.  Calibrating, the control's first choices are judged in
the served tokens' place, and ``altered_gap`` is the widest gap with
each served token replaced by the next id (a token other than the
model's)."""
from __future__ import annotations

import importlib
import time

import torch

from perfbench.frozen import hybrid_arith
from perfbench.harness import model, weights
from perfbench.harness.common import Check, Outcome
from perfbench.harness.serving import (ClosedLoop, GapStats, Rec, Spans,
                                       sample, start_server, warm,
                                       window_figures)
from perfbench.harness.trace import Tracer
from perfbench.harness.traffic import Requests

LABELS = ("serve.pump", "serve.prefill", "serve.decode")
COUNTER = "moe.expert_rows"


def expert_rows():
    """The program's count of rows each held expert computed in the
    traced window, or None (no counter in the program, or none kept)."""
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    counters = getattr(spans, "counters", None)
    rows = counters().get(COUNTER) if counters else None
    return None if rows is None else [int(n) for n in rows.cpu()]


def stagger(loop: ClosedLoop, warm_tokens: int) -> None:
    """Submit the first wave so that its slots finish as those of a
    server in its steady state do: in groups of one pass of the prompt
    grid, the groups spread evenly over a request's tokens.  The k-th of
    G groups asks for ``warm_tokens + ceil((k + 1) (gen - warm_tokens) /
    G)`` tokens, so after the warm-up its slots stand that many tokens
    from their end, as slots admitted k-th of G evenly spaced times
    before would.  Each later request asks for the mix's ``gen_tokens``,
    so the pattern holds: a finished group's slots are refilled in one
    pump, between decode steps, by the next pass of the grid (where the
    slots are a whole number of passes), and so every pump does the same
    work for every seed, the pass's sizes in another order, as the
    generator makes a run's."""
    reqs, batch = loop.requests, loop.server.batch
    size = len(reqs.grid)
    groups = -(-batch // size)
    left = reqs.gen_tokens - warm_tokens
    for i in range(batch):
        n = warm_tokens + -(-(i // size + 1) * left // groups)
        p = reqs.prompt(loop.next)
        loop.open.append(Rec(loop.next, p, loop.server.submit(p, n)))
        loop.next += 1


def steady_rate(loop: ClosedLoop, t0: float, t1: float):
    """Tokens a second over whole admission cycles of the window [t0,
    t1): those stamped after the end of its first pump that admitted a
    request, up to and with its last such pump, over the time between
    their ends (None with fewer than two such pumps).  A request's first
    token carries the stamp of the pump that admitted it."""
    recs = loop.done + loop.open
    ends = sorted({r.times[0] for r in recs
                   if r.times and t0 <= r.times[0] < t1})
    if len(ends) < 2:
        return None
    a, b = ends[0], ends[-1]
    n = sum(a < t <= b for r in recs for t in r.times)
    return n / (b - a)


class Gaps:
    """Each position's gap: how far the chosen token's logit lies below
    the reference's best."""

    def __init__(self):
        self.gaps = []

    def add(self, ref: torch.Tensor, chosen: torch.Tensor) -> None:
        best = ref.max(dim=-1).values
        got = torch.gather(ref, -1, chosen.long()[:, None])[:, 0]
        self.gaps.append((best - got).float().cpu())

    def checks(self, limits: dict):
        g = torch.cat(self.gaps)
        off = g[g > 0]
        return [Check("served_logit_gap", float(g.max()),
                      limits["served_logit_gap"]),
                Check("served_off_gap_median",
                      float(off.median()) if off.numel() else 0.0,
                      limits["served_off_gap_median"])]


def reference_gaps(ctx, recs, dev, control: bool):
    """How the served tokens (and, with ``control``, the control's first
    choices) lie against the configuration's reference over the sampled
    requests: (the served tokens' Gaps and GapStats, the control's Gaps
    or None, altered_gap or None)."""
    from perfbench.reference import no_tf32
    ref_mod = importlib.import_module(
        "perfbench.reference." + ctx.config["reference"])
    no_tf32()
    cfg = ctx.config
    w = weights.make(model.leaves(model.program_config(ctx)), ctx.seed,
                     dev, cfg["init"]["embed_std"])
    served, stats = Gaps(), GapStats()
    ctrl = Gaps() if control else None
    altered = Gaps() if control else None
    for r in recs:
        toks = list(r.req.tokens)
        seq = torch.as_tensor(list(r.prompt) + toks[:-1], device=dev)
        first = len(r.prompt) - 1
        ref = ref_mod.logits(w, seq, cfg, first)
        chosen = torch.as_tensor(toks, device=dev)
        served.add(ref, chosen)
        stats.add(ref, chosen)
        if control:
            low = ref_mod.logits(w, seq, cfg, first, precision="fp8")
            ctrl.add(ref, low.argmax(dim=-1))
            altered.add(ref, (chosen + 1) % cfg["vocab_size"])
    return served, stats, ctrl, (
        float(torch.cat(altered.gaps).max()) if control else None)


def run(ctx) -> Outcome:
    mix, cfg = ctx.traffic, ctx.config
    dev = torch.device(ctx.device)
    marks = [("start", time.time() - ctx.t_process)]
    # first, so a program without this configuration fails at once
    pcfg = model.program_config(ctx)
    model.build_kernels(dev)
    marks.append(("kernels", time.time() - ctx.t_process))
    w = weights.make(model.leaves(pcfg), ctx.seed, dev,
                     cfg["init"]["embed_std"])
    server = start_server(ctx, pcfg, w, dev)
    marks.append(("server", time.time() - ctx.t_process))
    del w
    spans = Spans()
    loop = ClosedLoop(server, Requests(mix, ctx.seed, cfg["vocab_size"]),
                      mix["queued"], spans)
    stagger(loop, mix["warm_tokens"])
    warm(loop, mix["warm_tokens"])
    marks.append(("warm-up", time.time() - ctx.t_process))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    m = server.metrics
    occ0 = (m.active_slot_steps, m.total_slot_steps)
    with Tracer(ctx.trace) as tracer:
        setup_s = time.time() - ctx.t_process
        t0 = time.perf_counter()
        t1 = t0 + ctx.seconds
        spans.on = True
        with tracer.window():
            loop.run_until(lambda: time.perf_counter() >= t1)
        spans.on = False
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    red = tracer.reduce(LABELS) if ctx.trace else None
    fig = window_figures(loop, t0, t1)
    rate = steady_rate(loop, t0, t1)
    done = loop.finished_in(t0, t1)
    failed = loop.failed_in(t0, t1)
    occ = (m.active_slot_steps - occ0[0], m.total_slot_steps - occ0[1])
    readings = {
        "window_s": ctx.seconds,
        "occupancy": occ[0] / occ[1] if occ[1] else None,
        "decode_s": spans.seconds.get("serve.decode", 0.0),
        "decode_calls": spans.calls.get("serve.decode", 0),
        "serve_flops": hybrid_arith.serve_flops(cfg, loop.prefilled
                                                + loop.decoded),
        "prefill_lengths": list(loop.prefill_lengths),
        "expert_rows": expert_rows() if ctx.trace else None,
        "aborts": server.aborts,
        "gap_samples": fig["gap_samples"],
        # the harness's count: every token of the window over the window
        "gen_tokens_whole_window_per_s": fig["gen_tokens_per_s"],
        "trace": red,
    }
    peak = model.memory_peak(dev)
    info = model.device_info(dev)
    marks.append(("window closed", time.time() - ctx.t_process))
    drained = loop.drain(mix["check"]["requests"] - len(done))
    marks.append(("drained", time.time() - ctx.t_process))
    recs = sample(done + drained, ctx.seed, mix["check"]["requests"])
    del loop, server, m
    model.free()
    served, stats, ctrl, readings["altered_gap"] = reference_gaps(
        ctx, recs, dev, ctx.calibrate)
    readings["gap_stats"] = stats.summary()
    marks.append(("served check", time.time() - ctx.t_process))
    lim = ctx.workload["limits"]
    control = ctrl.checks(lim) if ctrl else None
    readings["control_gap"] = control[0].value if control else 0.0
    readings["control_off_gap_median"] = control[1].value if control \
        else None
    checks = served.checks(lim) + [
        Check("failed_requests", float(len(failed)), 0.0),
        Check("requests_checked_short",
              float(max(mix["check"]["requests"] - len(recs), 0)), 0.0)]
    e2e = {"gen_tokens_per_s": fig["gen_tokens_per_s"] if rate is None
           else rate,
           "token_gap_p95_ms": fig["token_gap_p95_ms"],
           "setup_s": setup_s}
    return Outcome(e2e=e2e, readings=readings, checks=checks,
                   attempted=len(done) + len(drained) + len(failed),
                   failed=len(failed),
                   memory_peak=peak, device=info, control=control,
                   trace=red.as_line() if red else None,
                   notes=["set-up (s since the process began): " + ", ".join(
                       f"{n} {t:.2f}" for n, t in marks)])
