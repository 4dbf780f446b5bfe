"""Training into the versioned store: every optimizer step committed as a
new version of the parameters.

The trainer (``Trainer``, the store in Mode U: every block versioned in
a ring of ``ring_slots``, the fused commit) steps without pause on
batches made from the seed, one thread, each step ending when its loss
is read on the host.

Set-up drives the same trainer through its first ``checked_steps``
steps (the window's own call, on batches that all differ) and keeps the
readings the reference follows: each step's loss, each leaf's first
gradient as the optimizer took it (from its second moment), and each
leaf's change from the seed's weights in every version the ring holds
for those steps.  After the window, with the program's state freed: the
ring's clocks at the end; then the reference's own first steps from the
seed's weights, compared with those readings.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from perfbench.frozen import arith
from perfbench.harness import model, weights
from perfbench.harness.common import Check, Outcome
from perfbench.harness.trace import Tracer
from perfbench.harness.traffic import Batches

LABELS = ("train.step",)


def flat(tree, prefix=()) -> Dict[tuple, torch.Tensor]:
    """``{path: leaf}`` of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def nest(leaves: Dict[tuple, torch.Tensor]) -> dict:
    out: dict = {}
    for path, t in leaves.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def worst(xs) -> float:
    """The largest of ``xs``, NaN if any is (``max`` may pass one by)."""
    xs = list(xs)
    return float("nan") if any(x != x for x in xs) else max(xs)


def worst_leaf(prog: Dict[tuple, float], ref: Dict[tuple, float],
               keep=None) -> float:
    """The largest gap between the program's and the reference's norm of
    a leaf, over the larger of that leaf's reference norm and the median
    leaf's."""
    paths = [p for p in ref if keep is None or p in keep]
    med = statistics.median(ref[p] for p in paths)
    return worst(abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30)
                 for p in paths)


def moment_norms(nu, b2: float) -> Dict[tuple, float]:
    """Each leaf's first (clipped) gradient norm from the second moment
    after one step: nu = (1 - b2) g^2."""
    return {p: float(torch.sqrt(v.double().sum() / (1 - b2)))
            for p, v in flat(nu).items()}


def make_trainer(ctx, pcfg, w, dev):
    """The program's trainer over the benchmark's weights: built as the
    program builds it, its own initial state replaced by one made from
    ``w`` with the program's ``mv_init`` and ``adamw.init``, its
    controller brought to Mode U and held there."""
    from repro_torch.configs import MVStoreConfig, ShapeConfig
    from repro_torch.core import mvcontroller, mvstore
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import Trainer
    from repro_torch.optim import adamw
    t = ctx.traffic["train"]
    mvcfg = MVStoreConfig(mode="U", fused_commit=True,
                          ring_slots=ctx.config["mvstore"]["ring_slots"])
    ctl = mvcontroller.MVController(mvcfg=mvcfg, start_bg=False)
    shape = ShapeConfig("train", t["seq"], t["rows"], "train")
    trainer = Trainer(pcfg, shape, mvcfg=mvcfg, controller=ctl,
                      seed=ctx.seed, device=dev)
    want = ctx.config["optimizer"]
    have = trainer.opt_cfg._asdict()
    bad = {k: (v, have.get(k)) for k, v in want.items() if have.get(k) != v}
    if bad:
        raise ValueError(f"the trainer's optimizer differs from the "
                         f"configuration file: {bad}")
    trainer.state = None
    model.free()
    trainer.state = steps_mod.TrainState(
        mv=mvstore.mv_init(w, mvcfg, versioned="all"),
        opt=adamw.init(w, trainer.opt_cfg))
    ctl.try_cas_q_to_qtou(ctl.reader())
    return trainer, ctl


def ring_versions(mv) -> Dict[int, Dict[tuple, torch.Tensor]]:
    """``{clock: {path: the leaf the ring holds for it}}`` (views), for
    every clock that each leaf's ring holds."""
    paths = list(mv.ring)
    ts = {p: mv.ring_ts[p].tolist() for p in paths}
    out = {}
    for c in set(ts[paths[0]]):
        if c < 0 or any(c not in ts[p] for p in paths):
            continue
        out[c] = {weights.parse_path(p): mv.ring[p][ts[p].index(c)]
                  for p in paths}
    return out


def changes(versions, w0, clocks) -> List[Dict[tuple, float]]:
    """Each leaf's change from ``w0`` in the version of each of ``clocks``
    (NaN for a version the ring does not hold)."""
    first = flat(w0)
    out = []
    for c in clocks:
        v = versions.get(c)
        out.append({p: float(torch.linalg.vector_norm(
            v[p].float() - t.float())) if v is not None else float("nan")
            for p, t in first.items()})
    return out


def first_steps(ctx, trainer, ctl, batches, w0) -> dict:
    """The checked steps, through ``train_step``; returns the program's
    readings of them: the losses, the first gradient's norms, the change
    in the ring's version of each step, and (a fault the check has to
    see) the change in the version before it."""
    b2 = trainer.opt_cfg.b2
    n = ctx.traffic["checked_steps"]
    losses, g1 = [], None
    for s in range(n):
        state, met = trainer.train_step(trainer.state, batches.at(s))
        trainer.state = state
        losses.append(float(met["loss"]))
        if s == 0:
            g1 = moment_norms(state.opt.nu, b2)
            ctl.step_once()              # QtoU -> U: the trainer ticked
    versions = ring_versions(trainer.state.mv)
    return {"losses": losses, "grad1": g1,
            "change": changes(versions, w0, range(1, n + 1)),
            "stale_change": changes(versions, w0, range(0, n))}


def ring_checks(mv, R: int) -> List[Check]:
    """Every leaf's ring holds the newest min(R, clock + 1) clocks (the
    rest of its slots empty), and the slot of the newest clock is the live
    parameters bit for bit."""
    from repro_torch.core.mvstore import NO_TS
    K = int(mv.clock)
    want = [c for c in range(K - R + 1, K + 1) if c >= 0]
    want += [NO_TS] * (R - len(want))
    off, diff = 0, 0.0
    live = flat(mv.live)
    for p, ts in mv.ring_ts.items():
        got = ts.tolist()
        off += sum(a != b for a, b in zip(sorted(got), sorted(want)))
        if K in got:
            row = mv.ring[p][got.index(K)]
            leaf = live[weights.parse_path(p)]
            diff = max(diff, float((row.float() - leaf.float()).abs().max()))
        else:
            off += 1
    return [Check("ring_clocks_off", float(off), 0.0),
            Check("ring_newest_vs_live", diff, 0.0)]


def reference_steps(ctx, dev, batches, rows=None, prec="f32") -> dict:
    """The reference's own first steps from the seed's weights: losses,
    first gradient norms, each step's change (``rows`` keeps the first
    rows of each batch: the half-batch fault)."""
    from perfbench.reference import mamba2, no_tf32
    from perfbench.reference.adamw import AdamW
    no_tf32()
    cfg = ctx.config
    w = weights.make(model.leaves(model.program_config(ctx)), ctx.seed,
                     dev, cfg["init"]["embed_std"])
    stored = flat(w)
    p0 = {p: t.clone() for p, t in stored.items()}
    opt = AdamW(stored, cfg["optimizer"])
    losses, g1, change = [], None, []
    for s in range(ctx.traffic["checked_steps"]):
        b = batches.at(s)
        tok = torch.as_tensor(b["tokens"][:rows], device=dev)
        lab = torch.as_tensor(b["labels"][:rows], device=dev)
        p32 = {p: t.to(torch.float32, copy=True).requires_grad_()
               for p, t in stored.items()}
        loss = mamba2.loss(nest(p32), tok, lab, cfg, prec)
        grads = torch.autograd.grad(loss, list(p32.values()))
        losses.append(float(loss.detach()))
        del p32, loss
        opt.step(stored, dict(zip(stored, grads)))
        del grads
        if s == 0:
            g1 = {p: float(torch.sqrt(v.double().sum()
                                      / (1 - cfg["optimizer"]["b2"])))
                  for p, v in opt.v.items()}
        change.append({p: float(torch.linalg.vector_norm(
            stored[p].float() - p0[p].float())) for p in stored})
    return {"losses": losses, "grad1": g1, "change": change}


def compare_steps(prog: dict, ref: dict, change="change") -> Dict[str, float]:
    """The program's readings (or a fault's, ``change="stale_change"``)
    against the reference's: the losses' widest gap, and by the worst
    leaf the first gradient and the change in every checked version
    (leaves whose reference gradient is under a thousandth of the median
    leaf's move by rounding alone and are left out of the change)."""
    med = statistics.median(ref["grad1"].values())
    moved = {p for p, g in ref["grad1"].items() if g >= 1e-3 * med}
    return {"loss_gap": max(abs(a - b) for a, b in zip(prog["losses"],
                                                       ref["losses"])),
            "grad1_gap": worst_leaf(prog["grad1"], ref["grad1"]),
            "change_gap": worst(worst_leaf(p, r, moved) for p, r in
                                zip(prog[change], ref["change"]))}


def run(ctx) -> Outcome:
    mix, cfg = ctx.traffic, ctx.config
    dev = torch.device(ctx.device)
    marks = [("start", time.time() - ctx.t_process)]
    model.build_kernels(dev)
    marks.append(("kernels", time.time() - ctx.t_process))
    pcfg = model.program_config(ctx)
    w0 = weights.make(model.leaves(pcfg), ctx.seed, dev,
                      cfg["init"]["embed_std"])
    trainer, ctl = make_trainer(ctx, pcfg, w0, dev)
    marks.append(("trainer", time.time() - ctx.t_process))
    batches = Batches(mix, ctx.seed, cfg["vocab_size"])
    prog = first_steps(ctx, trainer, ctl, batches, w0)
    marks.append(("checked steps", time.time() - ctx.t_process))
    del w0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    issue0 = len(trainer.step_times)
    ends: List[float] = []
    step = mix["checked_steps"]
    st = met = None
    with Tracer(ctx.trace) as tracer:
        setup_s = time.time() - ctx.t_process
        t0 = time.perf_counter()
        t1 = t0 + ctx.seconds
        with tracer.window():
            while time.perf_counter() < t1:
                with torch.profiler.record_function("train.step"):
                    st, met = trainer.train_step(trainer.state,
                                                 batches.at(step))
                    trainer.state = st
                    float(met["loss"])
                ends.append(time.perf_counter())
                step += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    red = tracer.reduce(LABELS) if ctx.trace else None
    done = [e for e in ends if e < t1]
    n_tok = len(done) * batches.tokens_per_step
    t_train = (done[-1] - t0) if done else float("nan")
    issue = trainer.step_times[issue0:]
    readings = {
        "window_s": ctx.seconds,
        "train_steps": len(done),
        "train_seconds": t_train,
        "train_flops": arith.train_flops(cfg, n_tok),
        "host_issue_s": sum(issue) / len(issue) if issue else None,
        "trace": red,
    }
    peak = model.memory_peak(dev)
    info = model.device_info(dev)
    marks.append(("window closed", time.time() - ctx.t_process))
    checks = ring_checks(trainer.state.mv, cfg["mvstore"]["ring_slots"])
    readings["last_clock"] = int(trainer.state.mv.clock)
    del trainer, ctl, st, met
    model.free()
    ref = reference_steps(ctx, dev, batches)
    cmp = compare_steps(prog, ref)
    lim = ctx.workload["limits"]
    # the losses are read, not compared: neither the control nor a fault
    # reads three times what sound runs do (PERF.md)
    readings["loss_gap"] = cmp.pop("loss_gap")
    checks += [Check(k, v, lim[k]) for k, v in cmp.items()]
    control = None
    if ctx.calibrate:
        low = compare_steps(reference_steps(ctx, dev, batches, prec="fp8"),
                            ref)
        control = [Check(k, low[k], lim[k]) for k in cmp]
        readings["control"] = low
        readings["half_batch"] = compare_steps(reference_steps(
            ctx, dev, batches, rows=mix["train"]["rows"] // 2), ref)
        readings["stale_version"] = compare_steps(prog, ref, "stale_change")
    marks.append(("training check", time.time() - ctx.t_process))
    e2e = {"train_tokens_per_s": n_tok / t_train if done else float("nan"),
           "setup_s": setup_s}
    return Outcome(e2e=e2e, readings=readings, checks=checks,
                   attempted=len(ends), failed=0,
                   memory_peak=peak, device=info, control=control,
                   trace=red.as_line() if red else None,
                   notes=["set-up (s since the process began): " + ", ".join(
                       f"{n} {t:.2f}" for n, t in marks)])
