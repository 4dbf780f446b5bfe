"""The port's Mamba-2 family against the JAX package's, on the CPU.

Weights come from the reference's ``zoo.init_params`` for the reduced
mamba2-780m config (width 64, d_state 16, heads of 8, chunk 32, 2
layers), with the zero-initialised ``A_log`` and ``dt_bias`` and the
unit ``D`` replaced by seeded values so that every head decays, steps
and skips differently; they are carried across by ``params_from_numpy``.
Every other input is made with numpy from a seed.  float32 throughout,
tolerance 2e-4 (``tests/test_kernels.py``'s model tolerance), greedy
tokens identical; one trainer step (the scans through ``SSDScanFn``)
within 1e-4 of the reference trainer's.  The prefill scan is the port's
plain ``ssd_scan`` on the CPU and the reference's XLA lowering, which its
blocks run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MVStoreConfig as JMVStoreConfig
from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import smoke_config as j_smoke_config
from repro.core import mvstore as J_MV
from repro.launch.serve import Server as JServer
from repro.models import blocks as J_BLK
from repro.models import mamba as J_M
from repro.models import model_zoo as J_ZOO
from repro_torch.configs import (MVStoreConfig, ParallelConfig, ShapeConfig,
                                 get_config, smoke_config)
from repro_torch.core import mvstore as T_MV
from repro_torch.launch import serve as T_SERVE_MOD
from repro_torch.launch import sharding as SH
from repro_torch.launch.serve import Server
from repro_torch.models import blocks as BLK
from repro_torch.models import mamba as T_M
from repro_torch.models import model_zoo as ZOO

ARCH = "mamba2-780m"
TOL = 2e-4


def _cfgs(dtype="float32"):
    jc = dataclasses.replace(j_smoke_config(ARCH), dtype=dtype)
    tc = dataclasses.replace(smoke_config(ARCH), dtype=dtype)
    return jc, tc


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _params(jc, seed=0, spread=0.5):
    """Reference params with per-head A_log, dt_bias and D drawn from
    N(0, ``spread``), as (jax tree, torch tree)."""
    jp = J_ZOO.init_params(jc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    flat, tdef = jax.tree_util.tree_flatten_with_path(jp)
    leaves = []
    for path, leaf in flat:
        key = jax.tree_util.keystr(path)
        if any(k in key for k in ("'A_log'", "'dt_bias'", "'D'")):
            leaf = jnp.asarray(rng.normal(0, spread, leaf.shape),
                               leaf.dtype)
        leaves.append(leaf)
    jp = jax.tree_util.tree_unflatten(tdef, leaves)
    return jp, ZOO.params_from_numpy(jax.tree.map(np.asarray, jp))


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["sub0"]["mamba"]),
            SH.tree_map(lambda t: t[0], tp["layers"]["sub0"]["mamba"]))


def _x(shape, seed):
    a = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _state(tc, batch, seed):
    """A seeded non-zero Mamba state as (jax MambaState, torch
    MambaState)."""
    rng = np.random.default_rng(seed)
    zero = T_M.mamba_init_state(batch, tc.d_model, tc.mamba, "float32")
    arrs = [rng.normal(0, 0.5, tuple(t.shape)).astype(np.float32)
            for t in zero]
    return (J_M.MambaState(*map(jnp.asarray, arrs)),
            T_M.MambaState(*map(torch.from_numpy, arrs)))


def test_meta_and_param_counts_match_the_reference():
    jc, tc = _cfgs()
    jm = jax.tree_util.tree_flatten_with_path(J_ZOO.model_meta(jc))[0]
    tm = list(SH.leaves_with_path(ZOO.model_meta(tc)))
    assert [p for p, _ in tm] == [jax.tree_util.keystr(p) for p, _ in jm]
    for (_, t), (_, j) in zip(tm, jm):
        assert (t.shape, t.dtype, t.init, t.scale) == \
            (tuple(j.shape), j.dtype, j.init, j.scale)
    full = ZOO.param_counts(get_config(ARCH))
    assert full == {"total": 780_222_720, "active": 780_222_720,
                    "embed": 77_463_552}
    assert len(list(SH.leaves_with_path(ZOO.model_meta(get_config(ARCH))))) \
        == 16


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.5, (4, 24)).astype(np.float32)
    S = 1 if with_state else 9
    jx, tx = _x((2, S, 24), seed=2)
    if with_state:
        js, ts = _x((2, 3, 24), seed=3)
        jy, jn = J_M._causal_conv(jx, jnp.asarray(w), js)
        ty, tn = T_M._causal_conv(tx, torch.from_numpy(w), ts)
        _close(tn, jn)
    else:
        jy = J_M._causal_conv(jx, jnp.asarray(w))
        ty = T_M._causal_conv(tx, torch.from_numpy(w))
    _close(ty, jy)


def test_ssd_decode_step_matches():
    rng = np.random.default_rng(4)
    B, H, N, P = 2, 4, 8, 6
    arrs = [rng.normal(0, 1, s).astype(np.float32)
            for s in ((B, H, N, P), (B, H, P), (B, H), (H,), (B, N), (B, N))]
    arrs[2] = np.log1p(np.exp(arrs[2]))
    arrs[3] = -np.exp(arrs[3] * 0.3)
    jy, js = J_M.ssd_decode_step(*map(jnp.asarray, arrs))
    ty, ts = T_M.ssd_decode_step(*map(torch.from_numpy, arrs))
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("mode", ["sequence", "prefill_with_state",
                                  "decode", "one_token_prefill"])
def test_mamba_apply_matches(mode):
    """Sequence mode (no state), a 64-token prefill from a seeded state
    (two chunks of 32), a decode step from a seeded state, and a
    one-token call with a state, which both packages take as a decode
    step (``state is not None and S == 1``)."""
    jc, tc = _cfgs()
    jl, tl = _layer0(*_params(jc, seed=5))
    S = {"sequence": 64, "prefill_with_state": 64}.get(mode, 1)
    jx, tx = _x((2, S, tc.d_model), seed=6)
    if mode == "sequence":
        _close(T_M.mamba_apply(tl, tx, tc.mamba, rms_eps=tc.rms_eps),
               J_M.mamba_apply(jl, jx, jc.mamba, rms_eps=jc.rms_eps))
        return
    js, ts = _state(tc, 2, seed=7)
    if mode == "one_token_prefill":
        js, ts = (J_M.mamba_init_state(2, jc.d_model, jc.mamba,
                                       jnp.float32),
                  T_M.mamba_init_state(2, tc.d_model, tc.mamba, "float32"))
    jy, jn = J_M.mamba_apply(jl, jx, jc.mamba, rms_eps=jc.rms_eps, state=js)
    ty, tn = T_M.mamba_apply(tl, tx, tc.mamba, rms_eps=tc.rms_eps, state=ts)
    _close(ty, jy)
    for got, want in zip(tn, jn):
        _close(got, want)


@pytest.mark.parametrize("S", [2, 3, 5, 20])
def test_short_prefill_with_state_matches(S):
    """Prompts shorter than ``d_conv - 1`` (S = 2) or near it, and one
    shorter than a chunk, prefilled from a seeded state: ``_tail_conv``
    keeps the last ``min(S, d_conv - 1)`` rows as the reference does, and
    the output and all four state leaves agree."""
    jc, tc = _cfgs()
    jl, tl = _layer0(*_params(jc, seed=5))
    jx, tx = _x((2, S, tc.d_model), seed=8)
    js, ts = _state(tc, 2, seed=9)
    jy, jn = J_M.mamba_apply(jl, jx, jc.mamba, rms_eps=jc.rms_eps, state=js)
    ty, tn = T_M.mamba_apply(tl, tx, tc.mamba, rms_eps=tc.rms_eps, state=ts)
    _close(ty, jy)
    for got, want in zip(tn, jn):
        _close(got, want)


@pytest.mark.parametrize("ffn", ["none", "dense"])
def test_sublayer_matches_with_and_without_cache(ffn):
    """The ("mamba", ffn) sub-layer: sequence mode, the prefill that
    builds its state cache, and a decode step that updates that cache in
    place in the port."""
    jc, tc = _cfgs()
    if ffn == "dense":
        jc = dataclasses.replace(jc, d_ff=128)
        tc = dataclasses.replace(tc, d_ff=128)
    kind = ("mamba", ffn)
    jm = jax.tree_util.tree_flatten_with_path(J_BLK.sublayer_meta(jc, kind))
    assert [(jax.tree_util.keystr(p), tuple(m.shape)) for p, m in jm[0]] \
        == [(p, m.shape) for p, m in
            SH.leaves_with_path(BLK.sublayer_meta(tc, kind))]
    rng = np.random.default_rng(8)
    gen = torch.Generator().manual_seed(8)
    tp = SH.materialize(BLK.sublayer_meta(tc, kind), gen)
    tp["mamba"]["A_log"] = torch.from_numpy(
        rng.normal(0, 0.5, tp["mamba"]["A_log"].shape).astype(np.float32))
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    jpc, tpc = JParallelConfig(remat="none"), ParallelConfig(remat="none")
    jx, tx = _x((2, 32, tc.d_model), seed=9)
    pos = np.arange(32)[None]
    jy, _, _ = J_BLK.sublayer_apply(jp, jx, kind, jc, jpc,
                                    positions=jnp.asarray(pos))
    ty, tcache, _ = BLK.sublayer_apply(tp, tx, kind, tc, tpc,
                                       positions=torch.from_numpy(pos))
    assert tcache is None
    _close(ty, jy)
    jy, jcache, _ = J_BLK.sublayer_apply(jp, jx, kind, jc, jpc,
                                         positions=jnp.asarray(pos),
                                         want_cache=True)
    ty, tcache, _ = BLK.sublayer_apply(tp, tx, kind, tc, tpc,
                                       positions=torch.from_numpy(pos),
                                       want_cache=True)
    _close(ty, jy)
    assert sorted(tcache) == sorted(jcache) == ["conv_B", "conv_C",
                                                "conv_x", "ssm"]
    for n in jcache:
        _close(tcache[n], jcache[n])
    jx1, tx1 = _x((2, 1, tc.d_model), seed=10)
    held = {n: t.clone() for n, t in tcache.items()}
    cache_in = {n: t.clone() for n, t in tcache.items()}
    jy, jcache, _ = J_BLK.sublayer_apply(jp, jx1, kind, jc, jpc,
                                         positions=None, cache=jcache)
    ty, tnew, _ = BLK.sublayer_apply(tp, tx1, kind, tc, tpc,
                                     positions=None, cache=cache_in)
    _close(ty, jy)
    assert tnew is cache_in                      # updated in place
    for n in jcache:
        _close(cache_in[n], jcache[n])
        assert not torch.equal(cache_in[n], held[n])


def test_init_cache_matches_the_reference():
    jc, tc = _cfgs("bfloat16")
    jcache = J_ZOO.init_cache(jc, 3, 40, jnp.bfloat16)
    tcache = ZOO.init_cache(tc, 3, 40, "bfloat16")
    assert sorted(tcache) == sorted(jcache)
    for sub in jcache:
        for n, j in jcache[sub].items():
            t = tcache[sub][n]
            assert tuple(t.shape) == j.shape
            assert str(t.dtype).split(".")[-1] == str(j.dtype)
            assert not t.any()


def _prefill_decode(jc, tc, jp, tp, toks, steps):
    """Prefill ``toks`` and ``steps`` greedy decode steps in both packages
    (each fed the reference's token); returns the logits pairs and the
    final caches."""
    jpc, tpc = JParallelConfig(remat="none"), ParallelConfig(remat="none")
    jl, jcache, jlen = J_ZOO.prefill_fn(jp, {"tokens": jnp.asarray(toks)},
                                        jc, jpc)
    tl, tcache, tlen = ZOO.prefill_fn(tp, {"tokens": torch.from_numpy(toks)},
                                      tc, tpc)
    out = [(tl, jl)]
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tl, dim=-1).numpy(), tok)
        jl, jcache, jlen = J_ZOO.decode_fn(jp, jcache, jlen,
                                           jnp.asarray(tok), jc, jpc)
        tl, tcache, tlen = ZOO.decode_fn(tp, tcache, tlen,
                                         torch.from_numpy(tok), tc, tpc)
        out.append((tl, jl))
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    return out, tcache, jcache


def test_prefill_and_four_decode_steps_match():
    """mamba2-smoke: a 2 x 64 prefill (two chunks a layer) and four
    decode steps: logits within 2e-4 at every step, the same greedy
    tokens, and the same state caches at the end."""
    jc, tc = _cfgs()
    jp, tp = _params(jc, seed=11)
    toks = np.random.default_rng(12).integers(
        0, tc.vocab_size, (2, 64)).astype(np.int32)
    out, tcache, jcache = _prefill_decode(jc, tc, jp, tp, toks, steps=4)
    for tl, jl in out:
        _close(tl, jl)
    for sub in jcache:
        for n in jcache[sub]:
            _close(tcache[sub][n], jcache[sub][n])


def test_prefill_matches_at_bf16():
    """bfloat16 weights and activations: the prefill logits within 2e-2
    (bf16 rounds at other places in the two frameworks)."""
    jc, tc = _cfgs("bfloat16")
    jp, tp = _params(jc, seed=13)
    toks = np.random.default_rng(14).integers(
        0, tc.vocab_size, (2, 32)).astype(np.int32)
    out, _, _ = _prefill_decode(jc, tc, jp, tp, toks, steps=0)
    assert out[0][0].dtype == torch.bfloat16
    _close(*out[0], tol=2e-2)


def _loss_and_grads(spread):
    """The loss and every parameter's gradient, (port, reference): the
    port's through the plain scan, the reference's by ``jax.grad``."""
    jc, tc = _cfgs()
    jp, tp = _params(jc, seed=15, spread=spread)
    rng = np.random.default_rng(16)
    toks = rng.integers(0, tc.vocab_size, (2, 32)).astype(np.int32)
    labels = rng.integers(0, tc.vocab_size, (2, 32)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(J_ZOO.loss_fn)(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        jc, JParallelConfig(remat="block"))
    paths = [p for p, _ in SH.leaves_with_path(tp)]
    leaves = [t.clone().requires_grad_() for _, t in
              SH.leaves_with_path(tp)]
    view = T_MV._unflatten(tp, dict(zip(paths, leaves)))
    tloss = ZOO.loss_fn(view, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels)},
                        tc, ParallelConfig(remat="block"))
    tgrads = torch.autograd.grad(tloss, leaves)
    jflat = [g for _, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    return (tloss, tgrads), (jloss, jflat)


def test_loss_and_grads_match_reference():
    """The CPU route stays differentiable: the loss and every gradient
    against the reference's, at decays (A near -1) under which the
    reference's whole-square ``exp`` does not overflow."""
    (tloss, tgrads), (jloss, jgrads) = _loss_and_grads(spread=0.1)
    _close(tloss, jloss)
    for got, want in zip(tgrads, jgrads):
        _close(got, want)


def test_steep_decay_gradient_stays_finite():
    """Steeper decays (A down to -4.5): above the diagonal cum_i - cum_j
    passes 88, where the reference's ``exp`` over the whole Q x Q square
    overflows; the ``where`` after it keeps the forward finite, but its
    gradient is inf * 0 = NaN in every parameter that reaches a Mamba
    layer.  The port masks the exponent first: the same loss, and a
    finite gradient."""
    (tloss, tgrads), (jloss, jgrads) = _loss_and_grads(spread=0.5)
    _close(tloss, jloss)
    assert all(bool(torch.isfinite(g).all()) for g in tgrads)
    assert any(np.isnan(np.asarray(g)).any() for g in jgrads)


BATCH, PROMPT, GEN = 2, 32, 5


def _servers(mode, seed=0):
    jc, tc = _cfgs()
    jp, tp = _params(jc, seed=seed)
    kw = dict(batch=BATCH, prompt_len=PROMPT, max_len=PROMPT + GEN)
    js = JServer(jc, mvcfg=JMVStoreConfig(mode=mode), params=jp, **kw)
    ts = Server(tc, mvcfg=MVStoreConfig(mode=mode), params=tp,
                device="cpu", **kw)
    prompts = np.random.default_rng(seed + 1).integers(
        0, tc.vocab_size, (2 * BATCH, PROMPT)).astype(np.int32)
    return js, ts, jp, tp, prompts


def test_serve_batch_matches_the_reference():
    """Four seeded requests through two slots (freed slots refill, their
    state overwritten whole): the port's tokens are the reference's."""
    js, ts, _, _, prompts = _servers("Q")
    want = js.serve_batch(prompts, GEN)
    got = ts.serve_batch(prompts, GEN)
    assert got.shape == (2 * BATCH, GEN) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert ts.aborts == js.aborts == 0
    leaves = ts.executor.cache["sub0"]
    assert leaves["ssm"].shape == (2, BATCH, 16, 16, 8)
    assert leaves["ssm"].dtype == torch.float32
    assert leaves["conv_x"].shape == (2, BATCH, 3, 128)


def test_mode_u_commit_during_decode_matches_the_reference():
    """A writer commits a version with ``final_norm`` negated while both
    slots decode: Mode U serves the pinned version from the ring, with no
    abort and the tokens of a run without the commit, in both
    packages."""
    js, ts, jp, tp, prompts = _servers("U", seed=2)
    prompts = prompts[:BATCH]
    base = ts.serve_batch(prompts, GEN)
    np.testing.assert_array_equal(base, js.serve_batch(prompts, GEN))
    js, ts, _, _, _ = _servers("U", seed=2)
    toks = {}
    for name, server, mv, new, mvcfg in (
            ("jax", js, J_MV, dict(jp, final_norm=-jp["final_norm"]),
             JMVStoreConfig(mode="U")),
            ("port", ts, T_MV, dict(tp, final_norm=-tp["final_norm"]),
             MVStoreConfig(mode="U"))):
        reqs = [server.submit(p, GEN) for p in prompts]
        server.pump()
        assert all(len(r.tokens) == 2 for r in reqs)
        server.mv_state = mv.mv_commit(server.mv_state, new,
                                       local_mode="U", cfg=mvcfg)
        while any(r.outcome is r.outcome.PENDING for r in reqs):
            server.pump()
        assert server.aborts == 0
        toks[name] = np.array([r.tokens for r in reqs], np.int32)
    np.testing.assert_array_equal(toks["port"], toks["jax"])
    np.testing.assert_array_equal(toks["port"], base)


def test_cli_serves_mamba_on_the_cpu_when_asked(capsys):
    assert T_SERVE_MOD.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--requests", "2", "--batch", "2",
                             "--prompt-len", "8", "--gen", "3"]) == 0
    assert "done on cpu: 2 requests x 3 tokens" in capsys.readouterr().out


def _state_np(state):
    """A train state's live blocks and moments as numpy, by path (either
    package)."""
    out = {}
    for key, tree in (("live", state.mv.live), ("mu", state.opt.mu),
                      ("nu", state.opt.nu)):
        if isinstance(state.mv.clock, int):
            out.update({key + p: _np(t) for p, t in T_MV._flatten(tree)})
        else:
            out.update({key + jax.tree_util.keystr(p): _np(x) for p, x in
                        jax.tree_util.tree_flatten_with_path(tree)[0]})
    return out


@pytest.mark.parametrize("mode", ["Q", "U_fused"])
def test_trainer_step_matches_the_reference(mode):
    """One ``Trainer(device="cpu")`` step of the Mamba smoke config (its
    scans through ``SSDScanFn``) against the reference trainer's step
    from the same weights and batch, float32: loss, live blocks and
    moments within 1e-4."""
    from repro.configs import ShapeConfig as JShapeConfig
    from repro.launch.train import Trainer as JTrainer
    from repro_torch.launch.train import Trainer

    kw = dict(mode="U", fused_commit=True) if mode == "U_fused" \
        else dict(mode="Q")
    jc, tc = _cfgs()
    jt = JTrainer(jc, JShapeConfig("t", 32, 2, "train"),
                  mvcfg=JMVStoreConfig(**kw), seed=1)
    init = jax.tree.map(np.asarray, jt.state.mv.live)
    jstate, jm = jt.train_step(jt.state, jt.batch_at(0))
    jt.controller.stop()
    tt = Trainer(tc, ShapeConfig("t", 32, 2, "train"),
                 mvcfg=MVStoreConfig(**kw), params=init, device="cpu")
    tstate, tm = tt.train_step(tt.state, tt.batch_at(0))
    tt.controller.stop()
    assert tstate.mv.clock == int(jstate.mv.clock) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4, atol=1e-4)
    got, want = _state_np(tstate), _state_np(jstate)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.cuda
def test_training_mamba_on_the_card():
    """On the card ``lm_loss`` differentiates through ``SSDScanFn`` (the
    ``ssd_scan`` kernel forward; backward ``ssd_scan_bwd``, whose float32
    inputs take the plain scan's gradient on its counted f32 branch, the
    kernel being bf16): the gradient equals the CPU's within 1e-4
    (float32, TF32 off), and a ``Trainer`` step trains, launching the
    kernel for each layer's forward and recompute."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA ssd_scan kernel)")
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    _, tc = _cfgs()
    tp = ZOO.init_params(tc, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab_size, (2, 32)).astype(np.int32))
        for k in ("tokens", "labels")}
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.to(dev).requires_grad_()
                  for _, t in SH.leaves_with_path(tp)]
        paths = [p for p, _ in SH.leaves_with_path(tp)]
        view = T_MV._unflatten(tp, dict(zip(paths, leaves)))
        loss = ZOO.loss_fn(view, {k: v.to(dev) for k, v in batch.items()},
                           tc, ParallelConfig(remat="block"))
        grads[dev] = torch.autograd.grad(loss, leaves)
    for g, w in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
    tr = Trainer(tc, ShapeConfig("s", 32, 2, "train"),
                 mvcfg=MVStoreConfig(mode="U", fused_commit=True),
                 device="cuda")
    SS.launches.reset()
    state, metrics = tr.train_step(tr.state, tr.batch_at(0))
    tr.controller.stop()
    assert bool(torch.isfinite(metrics["loss"]))
    assert state.mv.clock == 1
    assert SS.launches.value == 2 * tc.n_layers
