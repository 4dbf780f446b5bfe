"""granite-4.0-h-small, the port's own configuration: its settings sit on
port-only subclasses and leave every other configuration as it was; its
MoE layer holds a share of the experts, routes over all of them and
drops no token; its spans and expert-row counter record where the work
is; the server takes it (no JAX here: the JAX package has no such
model)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import (ALL_ARCH_IDS, ARCH_IDS, PORT_ONLY, REGISTRY,
                                 MVStoreConfig, ParallelConfig, get_config,
                                 smoke_config)
from repro_torch.launch.sharding import materialize
from repro_torch.models import moe as MOE
from repro_torch.models import model_zoo as ZOO
from repro_torch.runtime import spans

ARCH = "granite-4.0-h-small"


def _cfg():
    return dataclasses.replace(smoke_config(ARCH), dtype="float32")


def test_port_only_config_has_the_published_widths():
    c = get_config(ARCH)
    assert ARCH in PORT_ONLY and ARCH in ALL_ARCH_IDS
    assert ARCH not in REGISTRY and ARCH not in ARCH_IDS
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
            c.resolved_head_dim, c.vocab_size) == (40, 4096, 32, 8, 128,
                                                   100352)
    assert [i for i, t in enumerate(c.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    m = c.moe
    assert (m.num_experts, m.experts_held, m.first_expert,
            m.experts_per_token, m.d_ff_expert, m.shared_d_ff,
            m.dropless) == (72, 36, 0, 10, 768, 1536, True)
    s = c.mamba
    assert (s.d_state, s.head_dim, s.expand, s.d_conv, s.chunk, s.conv_bias,
            s.n_groups) == (128, 64, 2, 4, 256, True, 1)
    assert (c.embedding_multiplier, c.residual_multiplier, c.logits_scaling,
            c.attention_multiplier, c.position_embedding, c.tie_embeddings,
            c.rms_eps) == (12.0, 0.22, 16.0, 0.0078125, "nope", True, 1e-5)
    assert ZOO.param_counts(c)["total"] == 18_617_793_024


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registry_configs_read_the_neutral_settings(arch):
    """The JAX package's configurations keep their fields (no port-only
    key in ``asdict``) and read every new setting as off."""
    c = get_config(arch)
    for obj, keys in ((c, ("embedding_multiplier", "residual_multiplier",
                           "logits_scaling", "attention_multiplier",
                           "position_embedding")),
                      (c.moe, ("experts_held", "first_expert", "dropless",
                               "shared_d_ff")),
                      (c.mamba, ("conv_bias", "n_groups"))):
        assert not set(keys) & set(dataclasses.asdict(obj))
    assert (c.embedding_multiplier, c.residual_multiplier, c.logits_scaling,
            c.attention_multiplier, c.position_embedding) == (
        1.0, 1.0, 1.0, None, "rope")
    assert c.moe.experts_held == c.moe.num_experts
    assert not c.moe.dropless and not c.mamba.conv_bias
    assert c.moe.shared_d_ff == c.moe.d_ff_expert * c.moe.num_shared_experts


@pytest.mark.parametrize("held,first,ok", [
    (None, 0, True), (4, 4, True), (0, 0, False), (5, 4, False),
    (4, -1, False)])
def test_port_moe_config_holds_a_share_of_the_experts(held, first, ok):
    """A port-only MoE is dropless by its type, holds every expert unless
    told otherwise, and refuses a share with no expert or past the
    router's last."""
    from repro_torch.configs.base import PortMoEConfig
    kw = dict(num_experts=8, experts_per_token=2, d_ff_expert=64,
              experts_held=held, first_expert=first)
    if not ok:
        with pytest.raises(ValueError):
            PortMoEConfig(**kw)
        return
    m = PortMoEConfig(**kw)
    assert m.dropless and m.experts_held == (held or 8)
    assert "dropless" not in dataclasses.asdict(m)


def test_smoke_reduction_keeps_the_share():
    c = smoke_config(ARCH)
    assert (c.moe.num_experts, c.moe.experts_held, c.moe.experts_per_token,
            c.moe.shared_d_ff) == (8, 4, 2, 128)
    assert c.n_layers == 8 and c.layer_types.count("attention") == 2
    leaves = dict(_leaves(c))
    assert leaves["['layers']['sub0']['moe']['w_router']"] == (2, 64, 8)
    assert leaves["['layers']['sub0']['moe']['w_gate']"] == (2, 4, 64, 64)
    assert leaves["['layers']['sub0']['mamba']['conv_x_bias']"] == (2, 128)


def _leaves(c):
    from repro_torch.launch.sharding import leaves_with_path
    return [(p, tuple(m.shape)) for p, m in
            leaves_with_path(ZOO.model_meta(c))]


def _moe_params(moe_cfg, d, seed=0):
    return materialize(MOE.moe_meta(d, moe_cfg, "float32"),
                       torch.Generator().manual_seed(seed))


def _share(params, lo, hi):
    """The weights a card holding experts lo..hi-1 has (the router and the
    shared expert whole)."""
    out = dict(params)
    for k in ("w_gate", "w_up", "w_down"):
        out[k] = params[k][lo:hi]
    return out


def test_expert_shares_add_up_to_the_whole_layer():
    """Two cards' shares of a layer, the shared expert counted once, add
    up to the layer that holds every expert."""
    m = _cfg().moe
    whole = dataclasses.replace(m, experts_held=m.num_experts)
    p = _moe_params(whole, 64)
    x = torch.randn(2, 12, 64, generator=torch.Generator().manual_seed(1))
    y, _ = MOE.moe_apply(p, x, whole)
    half = m.num_experts // 2
    a, _ = MOE.moe_apply(_share(p, 0, half), x,
                         dataclasses.replace(m, experts_held=half))
    b, _ = MOE.moe_apply(_share(p, half, m.num_experts), x,
                         dataclasses.replace(m, experts_held=half,
                                             first_expert=half))
    shared = MOE.ffn_apply(p["shared"], x)
    # float32 sums of the same terms in another order
    torch.testing.assert_close(a + b - shared, y, atol=1e-6, rtol=1e-5)
    assert not torch.allclose(a, y, atol=1e-3)


def test_no_token_is_dropped_under_a_skewed_router():
    """Every token routed to the same two experts: each gets both, whatever
    the count (a capacity bound of N k / E would keep few)."""
    m = dataclasses.replace(_cfg().moe, experts_held=8)
    p = _moe_params(m, 64, seed=3)
    router = torch.full((64, 8), -1.0)
    router[:, 2] = 2.0
    router[:, 5] = 1.0
    p["w_router"] = router
    x = torch.rand(1, 40, 64, generator=torch.Generator().manual_seed(4))
    y, _ = MOE.moe_apply(p, x, m)
    logits = x[0] @ router
    gates = torch.softmax(torch.topk(logits, 2, -1).values, -1)

    def expert(e):
        g = x[0] @ p["w_gate"][e]
        return (torch.nn.functional.silu(g) * (x[0] @ p["w_up"][e])) \
            @ p["w_down"][e]

    want = gates[:, :1] * expert(2) + gates[:, 1:] * expert(5) \
        + MOE.ffn_apply(p["shared"], x)[0]
    torch.testing.assert_close(y[0], want, atol=1e-5, rtol=1e-4)
    order, offs, _ = MOE.route_dropless(x[0], router, m)
    assert MOE.expert_rows(offs).tolist() == [0, 0, 40, 0, 0, 40, 0, 0]
    assert offs.tolist() == [0, 0, 40, 40, 40, 80, 80, 80]


def test_held_elsewhere_rows_never_reach_the_sum(monkeypatch):
    """Rows past the held experts' are left unset by the grouped product;
    filled with NaN they change nothing."""
    m = _cfg().moe
    p = _moe_params(m, 64, seed=5)
    x = torch.randn(1, 16, 64, generator=torch.Generator().manual_seed(6))
    y, _ = MOE.moe_apply(p, x, m)
    real = MOE._grouped

    def poisoned(a, w, offs):
        out = real(a, w, offs)
        out[int(offs[-1]):] = float("nan")
        return out

    monkeypatch.setattr(MOE, "_grouped", poisoned)
    z, _ = MOE.moe_apply(p, x, m)
    assert torch.equal(y, z)


def _server(batch=2):
    from repro_torch.launch.serve import Server
    return Server(_cfg(), batch=batch, prompt_len=32, max_len=48,
                  mvcfg=MVStoreConfig(mode="Q"), device="cpu")


def _prompts(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (n, 32)).astype(
        np.int32)


def test_decode_spans_and_the_expert_row_counter():
    """Inside ``recording()`` a decode step opens one ``mamba.decode`` a
    Mamba layer and one ``moe.route`` and ``moe.experts`` a layer, all
    under ``serve.decode``; the counter holds every held row, and nothing
    is kept outside a recording."""
    srv = _server()
    cfg = srv.cfg
    with spans.recording():
        srv.serve_batch(_prompts(2, 1), 4)
    recs = spans.records()
    dec = [r for r in recs if r.name == "serve.decode"]
    assert dec
    n_mamba = cfg.layer_types.count("mamba")
    for d in dec:
        kids = [r.name for r in recs if r.parent is d]
        assert kids.count("mamba.decode") == n_mamba
        assert kids.count("moe.route") == cfg.n_layers
        assert kids.count("moe.experts") == cfg.n_layers
    rows = spans.counters()["moe.expert_rows"]
    assert rows.shape == (cfg.moe.experts_held,)
    tokens = sum(len(r.attrs["rids"]) for r in dec) \
        + 32 * sum(1 for r in recs if r.name == "serve.prefill")
    # each token's k choices fall on this card's experts or the other's
    assert 0 < int(rows.sum()) <= tokens * cfg.n_layers \
        * cfg.moe.experts_per_token


def test_off_the_counter_keeps_nothing():
    with spans.recording():
        pass
    m = _cfg().moe
    MOE.moe_apply(_moe_params(m, 64), torch.randn(1, 4, 64), m)
    assert spans.counters() == {}


def test_server_takes_it_and_its_cache_holds_both_states():
    srv = _server(batch=3)
    out = srv.serve_batch(_prompts(4, 2), 6)
    assert out.shape == (4, 6)
    cache = srv.executor.cache
    kinds = {k: set(v) for k, v in cache.items()}
    assert kinds["sub2"] == {"k", "v"}
    assert kinds["sub0"] == {"ssm", "conv_x", "conv_B", "conv_C"}
    assert cache["sub0"]["ssm"].dtype == torch.float32
    assert cache["sub2"]["k"].shape == (2, 3, 48, 16)


def test_serve_cli_accepts_it(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "2", "--batch", "2",
                       "--prompt-len", "32", "--gen", "3"]) == 0
    assert "done on cpu" in capsys.readouterr().out


def test_nope_and_scale_reach_attention(monkeypatch):
    """A NoPE config rotates nothing in prefill or decode, and hands its
    softmax scale to both attentions."""
    from repro_torch.models import attention as A
    from repro_torch.models import blocks
    seen = []

    def no_rope(*a, **k):
        raise AssertionError("RoPE under a NoPE config")

    def spy(kind, real):
        def call(*a, **k):
            seen.append((kind, k["scale"]))
            return real(*a, **k)
        return call

    monkeypatch.setattr(blocks, "apply_rope", no_rope)
    monkeypatch.setattr(A, "attention", spy("prefill", A.attention))
    monkeypatch.setattr(A, "decode_attention",
                        spy("decode", A.decode_attention))
    cfg = _cfg()
    p = ZOO.init_params(cfg, torch.Generator().manual_seed(0))
    par = ParallelConfig(remat="none")
    tok = torch.randint(0, 512, (1, 32))
    with torch.no_grad():
        _, cache, clen = ZOO.prefill_fn(p, {"tokens": tok}, cfg, par)
        ZOO.decode_fn(p, cache, clen - 1, tok[:, -1].to(torch.int32), cfg,
                      par)
    assert set(seen) == {("prefill", 0.0078125), ("decode", 0.0078125)}
