"""The frozen arithmetic against the program's own counts on today's tree,
and every share at most 100 % for a device time at its bound."""
from __future__ import annotations

import math

import pytest
import torch

from perfbench.frozen import arith
from perfbench.frozen.peaks import HBM_BW, bound_seconds
from perfbench.harness import common
from perfbench.harness.trace import Reduced
from perfbench.tests import smoke

CELLS = ("mamba2-780m.train_U", "deepseek-7b.serve_Q")


def _configs():
    """(file config, program config) at full size and reduced."""
    from repro_torch.configs import get_config, smoke_config
    out = []
    for cell in CELLS:
        wl = common.load_json("workloads", cell)
        file_cfg = common.load_json("configs", wl["config"])
        arch = file_cfg["program_arch"]
        out.append((file_cfg, get_config(arch)))
        out.append((smoke.config_file(wl["config"], smoke_config(arch)),
                    smoke_config(arch)))
    return out


@pytest.mark.parametrize("i", range(4))
def test_parameter_table_matches_program(i):
    from repro_torch.launch.sharding import leaves_with_path
    from repro_torch.models import model_zoo
    file_cfg, pcfg = _configs()[i]
    meta = {p: m for p, m in leaves_with_path(model_zoo.model_meta(pcfg))}
    frozen = {n: (e, dt) for n, e, dt in arith.param_leaves(file_cfg)}
    assert len(frozen) == len(meta)
    for path, m in meta.items():
        name = path.rsplit("['", 1)[1][:-2]
        assert frozen[name] == (math.prod(m.shape), m.dtype), path
    counts = model_zoo.param_counts(pcfg)
    assert arith.active_params(file_cfg) == counts["active"]


def test_ssd_scan_counts_match_program():
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch import roofline
    g = torch.Generator().manual_seed(0)
    B, S, H, P, N, Q = 2, 64, 4, 8, 16, 32
    xh = torch.randn(B, S, H, P, generator=g).to(torch.bfloat16)
    dt = torch.rand(B, S, H, generator=g)
    A = -torch.rand(H, generator=g)
    Bm = torch.randn(B, S, N, generator=g).to(torch.bfloat16)
    Cm = torch.randn(B, S, N, generator=g).to(torch.bfloat16)
    with roofline.count(device="cpu") as rec:
        SS.ssd_scan(xh, dt, A, Bm, Cm, chunk=Q)
    calls, flops, nbytes = rec.kernels["ssd_scan"]
    f, b = arith.ssd_scan_work(B, S, H, P, N, Q, 2)
    assert calls == 1 and b == nbytes
    # the program counts the whole square of a chunk, the frozen count
    # the causal part the inputs need
    tri, sq = (Q + 1) / 2, Q
    assert f == pytest.approx(flops - 2 * B * S * (sq - tri) * (N + H * P))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_counts_match_program(causal):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import roofline
    B, S, H, D = 1, 128, 2, 16
    q, k, v = (torch.randn(B, S, H, D).to(torch.bfloat16) for _ in range(3))
    with roofline.count(device="cpu") as rec:
        FA.flash_attention(q, k, v, causal=causal)
    calls, flops, nbytes = rec.kernels["flash_attention"]
    f, b = arith.flash_attention_work(B, S, S, H, H, D, causal, 2)
    assert calls == 1 and b == nbytes
    if causal:     # the kernel visits whole tiles; the inputs need fewer
        assert f == 2 * B * H * D * S * (S + 1) and f < flops
    else:
        assert f == flops


def test_fused_adamw_and_resolve_bytes_match_program():
    from repro_torch.kernels import fused_adamw as FW
    from repro_torch.kernels import snapshot_select as SSel
    leaves = [("w", 96, "bfloat16"), ("n", 8, "float32")]
    want_fw = want_ss = 0
    for _, n, dt in leaves:
        t = getattr(torch, dt)
        p = torch.zeros(n, dtype=t)
        ring = torch.zeros((4, n), dtype=t)
        ts = torch.zeros(4, dtype=torch.int32)
        want_fw += FW.work(p, p, p.float(), p.float(), ring, 0, None)[1]
        want_ss += SSel.work(ring, ts, 0)[1]
    assert arith.fused_adamw_bytes(leaves, True) == want_fw
    assert arith.snapshot_select_bytes(leaves, 4) == want_ss


def _reduced(by_label, launches, kernels=None):
    kernels = kernels or {}
    return Reduced(window_s=10.0, busy_s=5.0, kernels=kernels,
                   by_label=by_label, launches=launches, label_counts={},
                   lost=0, device_ops=[], idle_gaps=[])


def test_shares_reach_100_at_the_bound():
    cfg = common.load_json("configs", "mamba2-780m")
    mix = common.load_json("traffic", "train_U")
    ctx = common.Context(cell="x", seed=0, seconds=1, trace=True,
                         workload={}, config=cfg, traffic=mix, t_process=0)
    t = mix["train"]
    di = cfg["expand"] * cfg["d_model"]
    b = bound_seconds(*arith.ssd_scan_work(
        t["rows"], t["seq"], di // cfg["headdim"], cfg["headdim"],
        cfg["d_state"], cfg["chunk_size"], 2))
    calls = 96
    red = _reduced({("train.step", "ssd_scan_kernel_out_mma"): calls * b / 2,
                    ("train.step", "ssd_scan_kernel_cb_mma"): calls * b / 2},
                   {("train.step", "ssd_scan_kernel_out_mma"): calls})
    out = common.Outcome(e2e={}, readings={"trace": red}, checks=[],
                         attempted=1, failed=0, memory_peak=0, device={})
    ssd = common.load_module("layer_metrics", "ssd_scan_roofline")
    assert ssd.read(out, ctx) == pytest.approx(100.0)
    leaves = arith.param_leaves(cfg)
    tb = 3 * arith.fused_adamw_bytes(leaves, True) / HBM_BW
    red = _reduced({}, {("train.step", "fused_adamw_kernel"): 3 * len(leaves)},
                   {"fused_adamw_kernel": tb})
    out.readings["trace"] = red
    fw = common.load_module("layer_metrics", "fused_adamw_roofline")
    assert fw.read(out, ctx) == pytest.approx(100.0)

    dcfg = common.load_json("configs", "deepseek-7b")
    dctx = common.Context(cell="x", seed=0, seconds=1, trace=True,
                          workload={}, config=dcfg, traffic={}, t_process=0)
    L = dcfg["num_hidden_layers"]
    lengths = [512, 2048]
    tb = L * sum(bound_seconds(*arith.flash_attention_work(
        1, S, S, 32, 32, 128, True, 2)) for S in lengths)
    red = _reduced({("serve.prefill", "flash_attention_kernel_mma"): tb},
                   {("serve.prefill", "flash_attention_kernel_mma"):
                    L * len(lengths)})
    out.readings.update(trace=red, prefill_lengths=lengths)
    fa = common.load_module("layer_metrics", "flash_attention_roofline")
    assert fa.read(out, dctx) == pytest.approx(100.0)


def test_readers_return_none_without_a_trace():
    spec = common.benchmark_spec()
    out = common.Outcome(e2e={}, readings={"trace": None}, checks=[],
                         attempted=1, failed=0, memory_peak=0, device={})
    ctx = common.Context(cell="x", seed=0, seconds=1, trace=True,
                         workload={}, config={}, traffic={}, t_process=0)
    for m in spec["per_layer"]:
        if m["source"] == "device_trace":
            mod = common.load_module("layer_metrics", m["name"])
            assert mod.read(out, ctx) is None, m["name"]
