"""A server without a writer: the closed loop over ``Server`` in the
mix's mode, its figures over the window, and the served tokens held
against the reference's full forward pass.

Set-up: the kernels, the weights made from the seed on the card, the
server, and the loop run until every slot has decoded a few tokens (so
the window starts with the batch full and the cache allocated).  After
the window: the peak memory is read; where fewer requests finished in the
window than the check takes, the loop runs on (untimed, nothing new
submitted) until that many of those outstanding have finished; the
server is freed, a sample of the finished requests drawn from the seed
(the longest prompt among them), the weights made again, and each sampled request's prompt
and served tokens run through the reference in one pass; the widest gap
by which a served token's logit lies below the reference's best is the
number compared."""
from __future__ import annotations

import time

import torch

from perfbench.frozen import arith
from perfbench.harness import model, weights
from perfbench.harness.common import Check, Outcome
from perfbench.harness.serving import (ClosedLoop, GapStats, Spans,
                                       first_gap, sample, start_server,
                                       warm, widest_gap, window_figures)
from perfbench.harness.trace import Tracer
from perfbench.harness.traffic import Requests

LABELS = ("serve.pump", "serve.prefill", "serve.decode")


def reference_gaps(ctx, recs, dev, control: bool):
    """The widest gap of the served tokens (and of the control's first
    tokens) over the sampled requests, through the dense reference."""
    from perfbench.reference import dense, no_tf32
    no_tf32()
    cfg = ctx.config
    w = weights.make(model.leaves(model.program_config(ctx)), ctx.seed,
                     dev, cfg["init"]["embed_std"])
    stats = GapStats()
    gap = ctrl = 0.0
    for r in recs:
        toks = list(r.req.tokens)
        seq = torch.as_tensor(list(r.prompt) + toks[:-1], device=dev)
        first = len(r.prompt) - 1
        ref = dense.logits(w, seq, cfg, first)
        served = torch.as_tensor(toks, device=dev)
        gap = max(gap, widest_gap(ref, served))
        stats.add(ref, served)
        if control:
            low = dense.logits(w, seq, cfg, first, precision="fp8")
            ctrl = max(ctrl, first_gap(ref, low))
    return gap, ctrl, stats.summary()


def run(ctx) -> Outcome:
    mix, cfg = ctx.traffic, ctx.config
    dev = torch.device(ctx.device)
    marks = [("start", time.time() - ctx.t_process)]
    model.build_kernels(dev)
    marks.append(("kernels", time.time() - ctx.t_process))
    pcfg = model.program_config(ctx)
    w = weights.make(model.leaves(pcfg), ctx.seed, dev,
                     cfg["init"]["embed_std"])
    server = start_server(ctx, pcfg, w, dev)
    marks.append(("server", time.time() - ctx.t_process))
    del w
    spans = Spans()
    loop = ClosedLoop(server, Requests(mix, ctx.seed, cfg["vocab_size"]),
                      mix["queued"], spans)
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
    done = loop.finished_in(t0, t1)
    failed = loop.failed_in(t0, t1)
    occ = (m.active_slot_steps - occ0[0], m.total_slot_steps - occ0[1])
    readings = {
        "window_s": ctx.seconds,
        "occupancy": occ[0] / occ[1] if occ[1] else None,
        "decode_s": spans.seconds.get("serve.decode", 0.0),
        "decode_calls": spans.calls.get("serve.decode", 0),
        "serve_flops": arith.serve_flops(cfg, loop.prefilled
                                         + loop.decoded),
        "prefill_lengths": list(loop.prefill_lengths),
        "aborts": server.aborts,
        "gap_samples": fig["gap_samples"],
        "trace": red,
    }
    peak = model.memory_peak(dev)
    info = model.device_info(dev)
    marks.append(("window closed", time.time() - ctx.t_process))
    drained = loop.drain(mix["check"]["requests"] - len(done))
    recs = sample(done + drained, ctx.seed, mix["check"]["requests"])
    del loop, server, m
    model.free()
    gap, ctrl, readings["gap_stats"] = reference_gaps(ctx, recs, dev,
                                                      ctx.calibrate)
    readings["control_gap"] = ctrl
    marks.append(("served check", time.time() - ctx.t_process))
    lim = ctx.workload["limits"]["served_logit_gap"]
    control = [Check("served_logit_gap", ctrl, lim)] if ctx.calibrate \
        else None
    checks = [Check("served_logit_gap", gap, lim),
              Check("failed_requests", float(len(failed)), 0.0),
              Check("requests_checked_short",
                    float(max(mix["check"]["requests"] - len(recs), 0)),
                    0.0)]
    e2e = {"gen_tokens_per_s": fig["gen_tokens_per_s"],
           "token_gap_p95_ms": fig["token_gap_p95_ms"],
           "setup_s": setup_s}
    return Outcome(e2e=e2e, readings=readings, checks=checks,
                   attempted=len(done) + len(drained) + len(failed),
                   failed=len(failed),
                   memory_peak=peak, device=info, control=control,
                   trace=red.as_line() if red else None,
                   notes=["set-up (s since the process began): " + ", ".join(
                       f"{n} {t:.2f}" for n, t in marks)])
