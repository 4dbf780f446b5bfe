"""The decoder-only families the port added beside qwen2.5-3b and
mamba2-780m (dense deepseek-7b, minitron-4b and mistral-large-123b; MoE
moonshot-v1-16b-a3b and llama4-scout-17b-a16e; hybrid jamba-v0.1-52b; VLM
paligemma-3b) against the JAX package's, on the CPU, each at the
reference's smoke config.

Weights come from the reference's ``zoo.init_params`` (for jamba with
its Mamba layers' ``A_log``, ``dt_bias`` and ``D`` drawn from a seed, so
every head decays differently) and are carried across by
``params_from_numpy``; token ids and patch embeddings are numpy from a
seed.  float32 throughout, tolerance 2e-4 (``tests/test_kernels.py``'s),
greedy tokens identical; the reference's prefill attention is its
Pallas kernel in interpret mode, as its own tests run it (its blockwise
attention where a gradient is taken: the kernel has none).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import SMOKE_SHAPE as J_SMOKE_SHAPE
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models import model_zoo as J_ZOO
from repro_torch.configs import (SMOKE_SHAPE, ParallelConfig, get_config,
                                 smoke_config)
from repro_torch.core import mvstore as MVS
from repro_torch.launch import sharding as SH
from repro_torch.models import model_zoo as ZOO
from repro_torch.models import transformer as TR

NEW = ("deepseek-7b", "minitron-4b", "mistral-large-123b",
       "moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "jamba-v0.1-52b",
       "paligemma-3b")
TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: faster here,
    and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cfgs(arch):
    return (dataclasses.replace(j_smoke_config(arch), dtype="float32"),
            dataclasses.replace(smoke_config(arch), dtype="float32"))


def _params(jc, seed):
    """Reference params (Mamba layers' A_log, dt_bias and D from
    N(0, 0.1)) as (jax tree, numpy tree)."""
    jp = J_ZOO.init_params(jc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    flat, tdef = jax.tree_util.tree_flatten_with_path(jp)
    leaves = []
    for path, leaf in flat:
        key = jax.tree_util.keystr(path)
        if any(k in key for k in ("'A_log'", "'dt_bias'", "'D'")):
            leaf = jnp.asarray(rng.normal(0, 0.1, leaf.shape), leaf.dtype)
        leaves.append(leaf)
    jp = jax.tree_util.tree_unflatten(tdef, leaves)
    return jp, jax.tree.map(np.asarray, jp)


def _batch(cfg, seed, labels=False):
    """Seeded numpy inputs: tokens [2, 16] (and labels); for a vision
    config ``frontend_len`` patch embeddings ahead of 32 - frontend_len
    tokens (the reference's Pallas attention tiles the 32 positions by
    16)."""
    rng = np.random.default_rng(seed)
    shape = (2, 32 - cfg.frontend_len) if cfg.frontend == "vision" \
        else (2, 16)
    b = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab_size,
                                   shape).astype(np.int32)
    if cfg.frontend == "vision":
        b["patch_embeds"] = rng.normal(
            0, 1, (2, cfg.frontend_len, cfg.d_model)
        ).astype(np.float32)
    return b


def _pcfgs(remat="none", impl="pallas"):
    """(reference, port) configs; the reference's Pallas kernel has no
    gradient, so the loss tests take its blockwise attention."""
    kw = dict(remat=remat, attn_impl=impl, attn_block_q=16,
              attn_block_k=16)
    return JParallelConfig(**kw), ParallelConfig(**kw)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", NEW)
def test_meta_and_param_counts_match(arch, smoke):
    """The smoke tree and the full tree (no allocation): the same paths,
    shapes, logical axes, init rules and dtypes; the same counts."""
    jc = j_smoke_config(arch) if smoke else j_get_config(arch)
    tc = smoke_config(arch) if smoke else get_config(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        J_ZOO.model_meta(jc), is_leaf=lambda x: hasattr(x, "axes"))
    tm = list(SH.leaves_with_path(ZOO.model_meta(tc)))
    assert [p for p, _ in tm] == [jax.tree_util.keystr(p) for p, _ in flat]
    for (_, jl), (_, tl) in zip(flat, tm):
        assert (jl.shape, jl.axes, jl.init, jl.dtype) == \
            (tl.shape, tl.axes, tl.init, tl.dtype)
    assert ZOO.param_counts(tc) == J_ZOO.param_counts(jc)
    assert TR.layer_kinds(tc) == J_ZOO.transformer.layer_kinds(jc)


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_three_decode_steps_match(arch):
    """A 2 x 16 prefill (paligemma's 2 x 24 behind its 8 patch
    embeddings) and three decode steps, each fed the reference's greedy
    token: logits within 2e-4 at every step, the same greedy tokens, the
    same cache lengths and, at the end, the same caches."""
    jc, tc = _cfgs(arch)
    jp, npp = _params(jc, seed=21)
    tp = ZOO.params_from_numpy(npp)
    jpc, tpc = _pcfgs()
    b = _batch(tc, seed=22)
    jl, jcache, jlen = jax.jit(J_ZOO.prefill_fn, static_argnums=(2, 3))(
        jp, jax.tree.map(jnp.asarray, b), jc, jpc)
    tl, _, tlen = ZOO.prefill_fn(
        tp, {k: torch.from_numpy(v) for k, v in b.items()}, tc, tpc)
    _close(tl, jl)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))

    def grow(name, a):               # k/v [g, B, S, kv*dh] get 4 slots
        return jnp.pad(a, [(0, 0), (0, 0), (0, 4), (0, 0)]) \
            if name in ("k", "v") else a

    jcache = {s: {n: grow(n, a) for n, a in c.items()}
              for s, c in jcache.items()}
    tcache = ZOO.params_from_numpy(jax.tree.map(np.asarray, jcache))
    jdecode = jax.jit(J_ZOO.decode_fn, static_argnums=(4, 5))
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tl, dim=-1).numpy(), tok)
        jl, jcache, jlen = jdecode(jp, jcache, jlen, jnp.asarray(tok), jc,
                                   jpc)
        tl, tcache, tlen = ZOO.decode_fn(tp, tcache, tlen,
                                         torch.from_numpy(tok), tc, tpc)
        _close(tl, jl)
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(torch.argmax(tl, dim=-1).numpy(),
                                  np.asarray(jnp.argmax(jl, axis=-1)))
    for sub in jcache:
        for n in jcache[sub]:
            _close(tcache[sub][n], jcache[sub][n])


def _torch_grads(tc, npp, tb, remat):
    flat = MVS._flatten(ZOO.params_from_numpy(npp))
    leaves = [t.requires_grad_() for _, t in flat]
    tp = MVS._unflatten(ZOO.params_from_numpy(npp),
                        {p: t for (p, _), t in zip(flat, leaves)})
    loss = ZOO.loss_fn(tp, tb, tc, _pcfgs(remat, "blockwise")[1])
    return [p for p, _ in flat], loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", NEW)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` (the MoE layers' aux loss included; for paligemma
    the patch positions dropped before the head) and every parameter's
    gradient, remat on, against ``jax.value_and_grad(zoo.loss_fn)``."""
    jc, tc = _cfgs(arch)
    jp, npp = _params(jc, seed=23)
    b = _batch(tc, seed=24, labels=True)
    jl, jg = jax.jit(jax.value_and_grad(J_ZOO.loss_fn),
                     static_argnums=(2, 3))(
        jp, jax.tree.map(jnp.asarray, b), jc,
        _pcfgs("block", "blockwise")[0])
    paths, tl, tg = _torch_grads(
        tc, npp, {k: torch.from_numpy(v) for k, v in b.items()}, "block")
    _close(tl, jl)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert paths == [jax.tree_util.keystr(p) for p, _ in jflat]
    for got, (_, want) in zip(tg, jflat):
        _close(got, want)


@pytest.mark.parametrize("arch", NEW)
def test_group_remat_gives_the_block_gradients(arch):
    """``remat="group:2"`` (each pair of groups checkpointed around the
    per-group checkpoints) gives ``"block"``'s loss and gradients bit for
    bit; a group count that does not split into runs of k raises."""
    _, tc = _cfgs(arch)
    _, npp = _params(_cfgs(arch)[0], seed=25)
    tb = {k: torch.from_numpy(v)
          for k, v in _batch(tc, seed=26, labels=True).items()}
    _, base_loss, base = _torch_grads(tc, npp, tb, "block")
    _, loss, grads = _torch_grads(tc, npp, tb, "group:2")
    assert torch.equal(loss, base_loss)
    for a, b in zip(grads, base):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="runs of 3"):
        _torch_grads(tc, npp, tb, "group:3")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_vision_batch_shapes_match(kind):
    """``batch_shapes`` of paligemma's full config: the reference's names,
    shapes and axes (the text ``frontend_len`` shorter than the cell);
    ``concrete_batch`` draws them at those shapes and dtypes."""
    shape = dataclasses.replace(SMOKE_SHAPE, kind=kind)
    jshape = dataclasses.replace(J_SMOKE_SHAPE, kind=kind)
    for arch in ("paligemma-3b", "moonshot-v1-16b-a3b"):
        cfg = smoke_config(arch)
        got = ZOO.batch_shapes(cfg, shape)
        want = J_ZOO.batch_shapes(j_smoke_config(arch), jshape)
        assert list(got) == list(want)
        for name, (shp, dt, ax) in got.items():
            wshp, wdt, wax = want[name]
            assert (shp, ax) == (wshp, wax)
            assert str(dt).split(".")[-1] == np.dtype(wdt).name
        batch = ZOO.concrete_batch(cfg, shape,
                                   torch.Generator().manual_seed(0))
        for name, t in batch.items():
            assert tuple(t.shape) == got[name][0]
            assert t.dtype == got[name][1]
        if kind == "decode":
            assert batch["cache_len"].tolist() == [shape.seq_len - 1] * 2
        else:
            assert int(batch["tokens"].max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b",
                                  "paligemma-3b"])
def test_trainer_takes_the_moe_hybrid_and_vlm_families(arch):
    """Nothing in ``Trainer`` or the steps refuses these families: two
    Mode-U fused steps (a vision batch carrying its patch embeddings, the
    MoE aux loss inside the loss), finite losses, the clock at 2, and the
    step-1 version read back whole from the ring."""
    from repro_torch.configs import MVStoreConfig, ShapeConfig
    from repro_torch.launch.train import Trainer

    cfg = smoke_config(arch)
    tr = Trainer(cfg, ShapeConfig("t", 32, 2, "train"),
                 mvcfg=MVStoreConfig(mode="U", fused_commit=True),
                 device="cpu")
    try:
        batch = tr.batch_at(0)
        assert ("patch_embeds" in batch) == (cfg.frontend == "vision")
        state = tr.state
        losses = []
        for step in range(2):
            prev = {p: t.clone() for p, t in MVS._flatten(state.mv.live)}
            state, metrics = tr.train_step(state, tr.batch_at(step))
            losses.append(float(metrics["loss"]))
        assert np.isfinite(losses).all() and state.mv.clock == 2
        view, ok = MVS.mv_snapshot(state.mv, 1)
        assert bool(ok)
        for p, t in MVS._flatten(view):
            assert torch.equal(t, prev[p]), p
    finally:
        tr.controller.stop()
