"""The port's training gradients against the JAX package's, on the CPU.

The attention gradient (``FlashAttentionFn``: the kernel wrapper's plain
version forward, the plain-torch backward), the loss and its gradients
through the reduced qwen2.5-3b config (2 layers, width 64), and the
recompute and group views that must not change them.  Weights come
from the reference's ``init_params`` and are carried across by
``params_from_numpy``; every other input is made with numpy from a
seed.  float32 is held within 2e-4, bfloat16 within 2e-2: the
tolerances of ``tests/test_kernels.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import smoke_config as j_smoke_config
from repro.models import attention as J_ATT
from repro.models import model_zoo as J_ZOO
from repro_torch.configs import ParallelConfig, smoke_config
from repro_torch.core import mvstore as MVS
from repro_torch.data import pipeline as DATA
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as ATT
from repro_torch.models import model_zoo as ZOO
from repro_torch.models import transformer as TR

ARCH = "qwen2.5-3b"
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: faster here,
    and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype):
    jc = dataclasses.replace(j_smoke_config(ARCH), dtype=dtype)
    tc = dataclasses.replace(smoke_config(ARCH), dtype=dtype)
    return jc, tc


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(a, dtype):
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _params(jc, seed=0):
    """Reference params with seeded biases, as (jax tree, numpy tree)."""
    jp = J_ZOO.init_params(jc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    flat, tdef = jax.tree_util.tree_flatten_with_path(jp)
    leaves = []
    for path, leaf in flat:
        if "b_" in jax.tree_util.keystr(path):
            leaf = jnp.asarray(rng.normal(0, 0.5, leaf.shape),
                               jnp.float32).astype(leaf.dtype)
        leaves.append(leaf)
    jp = jax.tree_util.tree_unflatten(tdef, leaves)
    return jp, jax.tree.map(np.asarray, jp)


def _batch(cfg, seed=0):
    b = DATA.SyntheticLM(cfg.vocab_size, 32, 2, seed=seed).global_batch_at(0)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# attention gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,KV,D", [(2, 64, 4, 2, 16), (1, 32, 4, 1, 8)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_grads_match_reference(B, S, H, KV, D, causal, dtype):
    """dq, dk, dv of the port's ``attention`` (``FlashAttentionFn``: the
    kernel wrapper's plain version forward, the plain-torch backward)
    against ``jax.grad`` of the reference's ``blockwise_attention``."""
    rng = np.random.default_rng(11)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(0, 1, shp), dtype)
        for shp in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    w = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)

    def jloss(q, k, v):
        o = J_ATT.blockwise_attention(q, k, v, causal=causal, block_q=16,
                                      block_k=16)
        return jnp.sum(o.astype(jnp.float32) * w)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o = ATT.attention(*leaves, causal=causal, block_q=16, block_k=16)
    assert o.grad_fn is not None
    tgrads = torch.autograd.grad((o.float() * torch.from_numpy(w)).sum(),
                                 leaves)
    for got, want in zip(tgrads, jgrads):
        assert got.dtype == getattr(torch, dtype)
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, TOL[dtype])


def test_attention_forward_without_grad_skips_the_function():
    """No input requires grad: the kernel wrapper is called as it is (no
    graph); with one that does, the output carries the Function."""
    q = torch.randn(1, 16, 2, 8)
    assert ATT.attention(q, q, q, causal=True).grad_fn is None
    qg = q.clone().requires_grad_()
    o = ATT.attention(qg, q, q, causal=True)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        assert ATT.attention(qg, q, q, causal=True).grad_fn is None


@pytest.mark.cuda
def test_bare_cuda_wrapper_refuses_grad():
    """On the card the kernel has no backward: the bare wrapper raises for
    an input that requires grad, and the Function's output has a graph
    whose gradient matches the naive attention's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA flash_attention kernel)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 64, 4, 32, generator=gen, device="cuda")
               for _ in range(3))
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        FA.flash_attention(qg, k, v, causal=True)
    o = ATT.attention(qg, k, v, causal=True)
    (dq,) = torch.autograd.grad(o.sum(), [qg])
    qn = q.clone().requires_grad_()
    (dqn,) = torch.autograd.grad(
        ATT.naive_attention(qn, k, v, causal=True).sum(), [qn])
    torch.testing.assert_close(dq, dqn, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_grads_match_reference(dtype):
    """``loss_fn`` and its gradients (remat on, the reference's default)
    against ``jax.value_and_grad(zoo.loss_fn)`` from the same weights."""
    jc, tc = _cfgs(dtype)
    jp, npp = _params(jc, seed=2)
    nb, tb = _batch(tc, seed=3)
    jpc = JParallelConfig(attn_block_q=16, attn_block_k=16)
    tpc = ParallelConfig(attn_block_q=16, attn_block_k=16)
    jl, jg = jax.jit(jax.value_and_grad(J_ZOO.loss_fn),
                     static_argnums=(2, 3))(
        jp, jax.tree.map(jnp.asarray, nb), jc, jpc)
    flat = MVS._flatten(ZOO.params_from_numpy(npp))
    leaves = [t.requires_grad_() for _, t in flat]
    tp = MVS._unflatten(ZOO.params_from_numpy(npp),
                        {p: t for (p, _), t in zip(flat, leaves)})
    tl = ZOO.loss_fn(tp, tb, tc, tpc)
    tg = torch.autograd.grad(tl, leaves)
    _close(tl, jl, TOL[dtype])
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [p for p, _ in flat] == [jax.tree_util.keystr(p)
                                    for p, _ in jflat]
    for got, leaf, (_, want) in zip(tg, leaves, jflat):
        assert got.dtype == leaf.dtype
        _close(got, want, TOL[dtype])


def test_softmax_xent_masks_the_padded_vocab():
    from repro.models import common as J_COM
    from repro_torch.models import common as COM

    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (2, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    for z in (0.0, 1e-4):
        got = COM.softmax_xent(torch.from_numpy(logits),
                               torch.from_numpy(labels), 33, z_loss=z)
        want = J_COM.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                  33, z_loss=z)
        _close(got, want, 1e-6)


def _grads(tc, npp, tb, remat):
    flat = MVS._flatten(ZOO.params_from_numpy(npp))
    leaves = [t.requires_grad_() for _, t in flat]
    tp = MVS._unflatten(ZOO.params_from_numpy(npp),
                        {p: t for (p, _), t in zip(flat, leaves)})
    tpc = ParallelConfig(remat=remat, attn_block_q=16, attn_block_k=16)
    loss = ZOO.loss_fn(tp, tb, tc, tpc)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("dtype", DTYPES)
def test_remat_and_unbind_give_the_same_gradients(dtype, monkeypatch):
    """Per-group recompute changes no gradient, and the one-``unbind``
    group views give the gradients of per-group ``t[g]`` selects."""
    jc, tc = _cfgs(dtype)
    _, npp = _params(jc, seed=5)
    _, tb = _batch(tc, seed=6)
    base = _grads(tc, npp, tb, "block")
    for variant in ("none", "select"):
        if variant == "select":
            monkeypatch.setattr(TR, "_groups", lambda tree, n: [
                TR._group(tree, g) for g in range(n)])
        loss, grads = _grads(tc, npp, tb,
                             "block" if variant == "select" else "none")
        assert torch.equal(loss, base[0])
        for a, b in zip(grads, base[1]):
            assert torch.equal(a, b), variant


def test_group_remat_variant_is_not_ported():
    """The variant is ported now: ``remat="group:2"`` (the two groups
    checkpointed as one run around their per-group checkpoints) gives
    ``"block"``'s loss and gradients bit for bit, and the reference's
    loss and gradients within 2e-4."""
    jc, tc = _cfgs("float32")
    jp, npp = _params(jc, seed=8)
    nb, tb = _batch(tc, seed=9)
    base = _grads(tc, npp, tb, "block")
    loss, grads = _grads(tc, npp, tb, "group:2")
    assert torch.equal(loss, base[0])
    for a, b in zip(grads, base[1]):
        assert torch.equal(a, b)
    jpc = JParallelConfig(remat="group:2", attn_block_q=16,
                          attn_block_k=16)
    jl, jg = jax.jit(jax.value_and_grad(J_ZOO.loss_fn),
                     static_argnums=(2, 3))(
        jp, jax.tree.map(jnp.asarray, nb), jc, jpc)
    _close(loss, jl, TOL["float32"])
    for got, (_, want) in zip(grads,
                              jax.tree_util.tree_flatten_with_path(jg)[0]):
        _close(got, want, TOL["float32"])
