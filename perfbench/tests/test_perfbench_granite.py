"""granite-4.0-h-small's cell at reduced widths on the CPU: the plain
reference (``reference/granite_hybrid.py``) against the program's prefill
and its decode through ``ModelSlotExecutor``'s hybrid cache, the expert
shares against the uncut reference layer, the settings the check has to
see, the frozen arithmetic, the new readers, and ``correct`` under the
cell's faults and its control."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from perfbench.frozen import arith, hybrid_arith
from perfbench.frozen.peaks import bound_seconds
from perfbench.harness import common, model, weights
from perfbench.harness.trace import Reduced
from perfbench.reference import granite_hybrid as G
from perfbench.tests import smoke

ARCH = "granite-4.0-h-small"
CELL = "granite-4.0-h-small.serve_H"
SEED = 2**31 + 509
#: float32 program against the float32 reference: the same sums in
#: another order (grouped products, a chunked scan), some 1e-7 of logits
#: whose spread is ~1e-2 at this size
F32 = dict(atol=2e-6, rtol=1e-4)


def _program(dtype="float32", **changes):
    from repro_torch.configs import smoke_config
    pcfg = dataclasses.replace(smoke_config(ARCH), dtype=dtype, **changes)
    cfg = smoke.config_file(ARCH, pcfg)
    return pcfg, cfg


def _weights(pcfg, cfg, seed=SEED):
    return weights.make(model.leaves(pcfg), seed, "cpu",
                        cfg["init"]["embed_std"])


def _served(pcfg, w, prompts, steps):
    """Prefill each prompt into a slot of one ``ModelSlotExecutor`` and
    decode ``steps`` tokens for all slots together; returns each slot's
    logits [1 + steps, V] and its tokens."""
    from repro_torch.configs import MVStoreConfig
    from repro_torch.launch.serve import Server
    from repro_torch.serve.queue import Request
    srv = Server(pcfg, batch=len(prompts), prompt_len=max(map(len, prompts)),
                 max_len=max(map(len, prompts)) + steps + 1,
                 mvcfg=MVStoreConfig(mode="Q"), params=w, device="cpu")
    ex = srv.executor
    seen = []
    for name in ("_prefill1", "_decode"):
        real = getattr(ex, name)

        def spy(*a, real=real):
            out = real(*a)
            seen.append(out[0].clone())
            return out
        setattr(ex, name, spy)
    toks = [[] for _ in prompts]
    for i, p in enumerate(prompts):
        r = ex.prefill(i, Request(rid=i, payload=np.asarray(p), max_new=1),
                       0)
        toks[i].append(r.token)
    rows = [[seen[i][0]] for i in range(len(prompts))]
    for _ in range(steps):
        res = ex.decode(list(range(len(prompts))), [0] * len(prompts))
        for i, r in enumerate(res):
            toks[i].append(r.token)
            rows[i].append(seen[-1][i])
    return [torch.stack(r) for r in rows], toks


def _reference(w, cfg, prompt, toks, **kw):
    seq = torch.as_tensor(list(prompt) + toks[:-1])
    return G.logits(w, seq, cfg, len(prompt) - 1, **kw)


def test_prefill_and_decode_through_the_hybrid_cache_match_reference():
    """Two slots (prompts of 64 and 32 tokens) prefilled into the batched
    cache, then 9 decode steps of both together: every position's logits
    against the reference's one full forward pass."""
    pcfg, cfg = _program()
    w = _weights(pcfg, cfg)
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, 512, (n,), generator=g).tolist()
               for n in (64, 32)]
    rows, toks = _served(pcfg, w, prompts, 9)
    for prompt, got, t in zip(prompts, rows, toks):
        assert got.shape[0] == 10
        torch.testing.assert_close(got, _reference(w, cfg, prompt, t), **F32)


@pytest.mark.parametrize("change", ["no_conv_bias", "rope"])
def test_the_check_sees_conv_bias_and_nope(change):
    """The program with the convolution bias left out, or with RoPE in
    place of NoPE, lies ten times outside the comparison's tolerance (at
    this size attention's scores are small, so RoPE moves the logits
    least)."""
    pcfg, cfg = _program()
    w = _weights(pcfg, cfg)
    if change == "no_conv_bias":
        for sub in w["layers"].values():
            if "mamba" in sub:
                for n in ("x", "B", "C"):
                    sub["mamba"][f"conv_{n}_bias"] = torch.zeros_like(
                        sub["mamba"][f"conv_{n}_bias"])
        ref_w = _weights(pcfg, cfg)
        bad = pcfg
    else:
        ref_w = w
        bad = dataclasses.replace(pcfg, position_embedding="rope")
    prompt = torch.randint(0, 512, (64,),
                           generator=torch.Generator().manual_seed(8)).tolist()
    (got,), (t,) = _served(bad, w, [prompt], 3)
    ref = _reference(ref_w, cfg, prompt, t)
    tol = F32["atol"] + F32["rtol"] * ref.abs().max()
    assert (got - ref).abs().max() > 10 * tol


def test_expert_shares_add_up_to_the_uncut_reference_layer():
    """Reference layers holding experts 0-3 and 4-7 of 8, the shared
    expert counted once, add up to the reference layer that holds all 8;
    the program's share equals the reference's share."""
    from repro_torch.models import moe as MOE
    pcfg, cfg = _program()
    w = _weights(pcfg, cfg)
    p = G.layer(w["layers"], 0)["sub0"]["moe"]
    h = torch.randn(40, 64, generator=torch.Generator().manual_seed(9))
    whole = dict(p)
    for k in ("w_gate", "w_up", "w_down"):      # a second card's experts
        whole[k] = torch.cat([p[k], torch.flip(p[k], dims=[1])])
    E = cfg["num_local_experts_published"]
    uncut, shared = G.moe(whole, h, dict(cfg, num_local_experts=E), "f32")
    a, _ = G.moe(p, h, cfg, "f32")
    other = {**p, **{k: whole[k][E // 2:] for k in ("w_gate", "w_up",
                                                     "w_down")}}
    b, _ = G.moe(other, h, dict(cfg, first_local_expert=E // 2), "f32")
    torch.testing.assert_close(a + b, uncut, atol=1e-6, rtol=1e-5)
    prog, _ = MOE.moe_apply(p, h[None], pcfg.moe)
    torch.testing.assert_close(prog[0], a + shared, **F32)


def test_frozen_parameter_table_matches_program():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.sharding import leaves_with_path
    from repro_torch.models import model_zoo
    for file_cfg, pcfg in (
            (common.load_json("configs", ARCH), get_config(ARCH)),
            (smoke.config_file(ARCH, smoke_config(ARCH)),
             smoke_config(ARCH))):
        meta = {".".join(weights.parse_path(p)): m
                for p, m in leaves_with_path(model_zoo.model_meta(pcfg))}
        frozen = {n: (e, dt) for n, e, dt in
                  hybrid_arith.param_leaves(file_cfg)}
        assert frozen == {n: (math.prod(m.shape), m.dtype)
                          for n, m in meta.items()}
        assert hybrid_arith.active_params(file_cfg) == pytest.approx(
            model_zoo.param_counts(pcfg)["active"])
    full = common.load_json("configs", ARCH)
    # 2 N a token: N the mixers, the tied head, the shared expert, the
    # router and 5 of the 36 held experts, ~6.9 B
    assert hybrid_arith.serve_flops(full, 1) == pytest.approx(
        2 * 6_915_684_864)


def _reduced(by_label, launches):
    return Reduced(window_s=10.0, busy_s=5.0, kernels={}, by_label=by_label,
                   launches=launches, label_counts={}, lost=0,
                   device_ops=[], idle_gaps=[])


def test_prefill_scan_share_is_100_at_the_bound_and_none_without_a_trace():
    cfg = common.load_json("configs", ARCH)
    ctx = common.Context(cell=CELL, seed=0, seconds=1, trace=True,
                         workload={}, config=cfg, traffic={}, t_process=0)
    lengths = [2048, 8192, 4096]
    layers = cfg["layer_types"].count("mamba")
    bound = layers * sum(bound_seconds(*arith.ssd_scan_work(
        1, S, 128, 64, 128, 256, 2)) for S in lengths)
    calls = layers * len(lengths)
    red = _reduced({("serve.prefill", "ssd_scan_kernel_out_mma"): bound / 2,
                    ("serve.prefill", "ssd_scan_kernel_cb_mma"): bound / 2,
                    ("serve.decode", "ssd_scan_kernel_out_mma"): bound},
                   {("serve.prefill", "ssd_scan_kernel_out_mma"): calls})
    out = common.Outcome(e2e={}, readings={"trace": red,
                                           "prefill_lengths": lengths},
                         checks=[], attempted=1, failed=0, memory_peak=0,
                         device={})
    rd = common.load_module("layer_metrics", "ssd_scan_roofline.prefill")
    assert rd.read(out, ctx) == pytest.approx(100.0)
    out.readings["trace"] = None
    assert rd.read(out, ctx) is None


def test_hybrid_attention_share_is_100_at_the_bound_and_none_without():
    """Four attention layers of forty, heads of 4096 / 32: the bound of
    each prefill's attention over the launches' time."""
    cfg = common.load_json("configs", ARCH)
    ctx = common.Context(cell=CELL, seed=0, seconds=1, trace=True,
                         workload={}, config=cfg, traffic={}, t_process=0)
    lengths = [2048, 8192, 6144]
    bound = 4 * sum(bound_seconds(*arith.flash_attention_work(
        1, S, S, 32, 8, 128, True, 2)) for S in lengths)
    red = _reduced({("serve.prefill", "flash_attention_kernel_mma"): bound,
                    ("serve.decode", "flash_attention_kernel_mma"): bound},
                   {("serve.prefill", "flash_attention_kernel_mma"):
                    4 * len(lengths)})
    out = common.Outcome(e2e={}, readings={"trace": red,
                                           "prefill_lengths": lengths},
                         checks=[], attempted=1, failed=0, memory_peak=0,
                         device={})
    rd = common.load_module("layer_metrics",
                            "flash_attention_roofline.hybrid")
    assert rd.read(out, ctx) == pytest.approx(100.0)
    out.readings["trace"] = None
    assert rd.read(out, ctx) is None


def test_load_imbalance_reads_the_counter():
    rd = common.load_module("layer_metrics", "moe.load_imbalance")
    out = common.Outcome(e2e={}, readings={"expert_rows": [3, 1, 0, 4]},
                         checks=[], attempted=1, failed=0, memory_peak=0,
                         device={})
    assert rd.read(out, None) == pytest.approx(2.0)
    for rows in (None, [0, 0]):
        out.readings["expert_rows"] = rows
        assert rd.read(out, None) is None


#: limits at this size, where logits spread by ~5e-3: the served gap of
#: sound bf16 runs reads 2e-4 - 4.4e-3 over 256 tokens (a flipped routing
#: choice now and then moves a position's logits ten times as far as
#: rounding does, in decode and sequence form alike), with each token the
#: next id 0.026 - 0.035; the median gap of the tokens off the
#: reference's best 1.1e-4 - 5.2e-4 sound, the float8 control's 8.2e-4 -
#: 1.15e-3 (seven seeds each)
SMALL = {"served_logit_gap": 0.0015, "served_off_gap_median": 0.0005}


def _run(mix=smoke.SERVE_MIX, limits=SMALL, **kw):
    ctx = smoke.context(CELL, mix=mix, seed=2**31 + 303, seconds=1.5,
                        limits=limits, **kw)
    return common.load_module("drivers", ctx.traffic["driver"]).run(ctx)


def test_sound_run_is_correct_and_the_control_is_not():
    """The float8 control breaks near ties by wider gaps than the
    program: the median gap of its choices off the reference's best is
    over the limit.  32 tokens of 8 requests, so the median is read over
    256; the widest gap's limit is the spans tests' (its sound tail grows
    with the tokens read)."""
    mix = dict(smoke.SERVE_MIX, gen_tokens=32, queued=6,
               check={"requests": 8})
    out = _run(mix=mix, limits=dict(SMALL, served_logit_gap=0.02),
               calibrate=True)
    assert out.correct, out.checks
    assert out.control_correct is False, out.control
    assert not {c.name: c for c in out.control}[
        "served_off_gap_median"].ok
    assert out.readings["altered_gap"] > 0.02
    assert out.readings["serve_flops"] > 0


def test_an_altered_token_is_not_correct(monkeypatch):
    from repro_torch.launch import serve
    real = serve.ModelSlotExecutor.decode

    def decode(self, slots, clocks):
        res = real(self, slots, clocks)
        self.tokens = (self.tokens + 1) % self.cfg.vocab_size
        return [type(r)(r.ok, r.clock, token=int(self.tokens[i]))
                for i, r in zip(slots, res)]

    monkeypatch.setattr(serve.ModelSlotExecutor, "decode", decode)
    out = _run()
    assert not out.correct
    checks = {c.name: c for c in out.checks}
    # at the cell's width the median is the one that catches it (the
    # widest gap's limit stands above the sound tail)
    assert not checks["served_logit_gap"].ok
    assert not checks["served_off_gap_median"].ok


class _Queue:
    """A stand-in for the program's server: it records what is asked."""

    def __init__(self, batch):
        self.batch = batch
        self.asked = []

    def submit(self, prompt, max_new):
        self.asked.append((len(prompt), max_new))
        return object()


@pytest.mark.parametrize("slots,gen,warm", [(64, 128, 3), (8, 32, 3),
                                            (6, 16, 2)])
def test_first_wave_is_staggered_in_passes_of_the_grid(slots, gen, warm):
    """The first wave finishes in groups of one pass of the prompt grid,
    each group at its own depth, spread over a request's tokens; every
    later request asks for the mix's count."""
    from perfbench.drivers.serve_hybrid import stagger
    from perfbench.harness.serving import ClosedLoop
    from perfbench.harness.traffic import Requests
    mix = {"prompt_len": {"min": 2048, "max": 8192, "step": 2048},
           "gen_tokens": gen}
    server = _Queue(slots)
    loop = ClosedLoop.__new__(ClosedLoop)
    loop.server, loop.requests, loop.next, loop.open = (
        server, Requests(mix, SEED, 100352), 0, [])
    stagger(loop, warm)
    asks = [n for _, n in server.asked]
    groups = [asks[i:i + 4] for i in range(0, slots, 4)]
    assert loop.next == slots and len(loop.open) == slots
    assert all(len(set(g)) == 1 for g in groups)
    firsts = [g[0] for g in groups]
    assert firsts == sorted(set(firsts)) and firsts[-1] == gen
    assert firsts[0] > warm
    # even spacing: the groups' depths differ by at most one token from
    # the even split of the tokens left after the warm-up
    steps = np.diff([warm] + firsts)
    assert steps.max() - steps.min() <= 1
    if slots % 4 == 0:
        # each group one pass of the grid
        for i in range(0, slots, 4):
            assert sorted(n for n, _ in server.asked[i:i + 4]) == [
                2048, 4096, 6144, 8192]


def test_the_rate_is_read_over_whole_admission_cycles():
    """Pumps end at 1, 2, ..., 9; requests admitted at the ends of pumps
    2 and 6 (their first tokens): the rate is the tokens stamped in (2,
    6] over 4 s; with one admission in the window, None."""
    from perfbench.drivers.serve_hybrid import steady_rate
    from perfbench.harness.serving import Rec
    loop = type("Loop", (), {})()
    old = Rec(0, np.zeros(1), None, times=[0.5] + [float(t)
                                                   for t in range(1, 10)])
    a = Rec(1, np.zeros(1), None, times=[2.0, 3.0, 4.0])
    b = Rec(2, np.zeros(1), None, times=[6.0, 7.0])
    loop.done, loop.open = [a], [old, b]
    # old: 3, 4, 5, 6; a: 3, 4; b: 6
    assert steady_rate(loop, 1.0, 9.5) == pytest.approx(7 / 4)
    assert steady_rate(loop, 3.0, 9.5) is None
