"""The encoder-decoder family (seamless-m4t-medium; ``models/encdec.py``,
the cross-attention of ``models/blocks.py``) against the JAX package's,
on the CPU, at the reference's smoke config.

Weights come from the reference's ``zoo.init_params`` and are carried
across by ``params_from_numpy``; tokens and frame embeddings are numpy
from a seed (128 frames, 16 tokens; attention blocks of 64 rows, the
plain kernel's kv tile).  The reference's attention is its blockwise
lowering (its default, and the only one with a gradient).  float32
within 2e-4 (1e-4 for gradients and trainer steps); a bf16 sub-layer
within 2e-2 (rtol = atol); a bf16 model against the float32 run of its
weights, within twice the reference's error (``_held``).  Frame dtypes follow JAX's promotion:
bf16 frames keep a bf16 model bf16; float32 frames (the data pipeline's)
run a bf16 model's encoder, its output and the cross-attention's k and v
in float32, the decoder in bf16; bf16 frames against float32 weights
change the encoder's carry dtype, which both packages refuse.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MVStoreConfig as JMVStoreConfig
from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.core import mvstore as J_MV
from repro.data import pipeline as J_PIPE
from repro.launch import steps as J_STEPS
from repro.models import attention as J_ATT
from repro.models import blocks as J_BLK
from repro.models import encdec as J_ED
from repro.models import model_zoo as J_ZOO
from repro_torch.configs import (NOT_PORTED, MVStoreConfig, ParallelConfig,
                                 ShapeConfig, get_config, smoke_config)
from repro_torch.core import mvstore as T_MV
from repro_torch.data import pipeline as T_PIPE
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as T_STEPS
from repro_torch.models import attention as T_ATT
from repro_torch.models import blocks as BLK
from repro_torch.models import encdec as ED
from repro_torch.models import model_zoo as ZOO

ARCH = "seamless-m4t-medium"
FRAMES, TOKENS = 128, 16
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
#: (weights, frames) dtypes: a bf16 model over bf16 frames (serving's
#: ``concrete_batch``) and over float32 frames (training's pipeline),
#: and a float32 model over float32 frames
DTYPES = [("bfloat16", "bfloat16"), ("bfloat16", "float32"),
          ("float32", "float32")]


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


def _dt(x):
    """A tensor's or array's dtype by name ('float32', 'bfloat16')."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[-1]
    return jnp.dtype(x.dtype).name


def _close(got, want, tol):
    assert tuple(got.shape) == tuple(want.shape)
    assert _dt(got) == _dt(want)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(j_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(smoke_config(ARCH), dtype=dtype))


def _params(jc, seed):
    """The reference's params as (jax tree, the port's tensor tree)."""
    jp = J_ZOO.init_params(jc, jax.random.PRNGKey(seed))
    return jp, ZOO.params_from_numpy(jax.tree.map(np.asarray, jp))


def _arr(a, dtype):
    """A float32 numpy array as (jax array, tensor) of ``dtype`` (a bf16
    pair rounds the same values)."""
    j = jnp.asarray(a).astype(jnp.dtype(dtype))
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t


def _batch(cfg, seed, frames_dtype, labels=False):
    """Seeded inputs as (jax dict, torch dict): tokens [2, 16] (and
    labels), frame embeddings [2, 128, d] N(0, 1) in ``frames_dtype``."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size,
                                (2, TOKENS)).astype(np.int32)}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab_size,
                                   (2, TOKENS)).astype(np.int32)
    j = {k: jnp.asarray(v) for k, v in b.items()}
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    j["frame_embeds"], t["frame_embeds"] = _arr(
        rng.standard_normal((2, FRAMES, cfg.d_model), dtype=np.float32),
        frames_dtype)
    return j, t


def _pcfgs(remat="none"):
    kw = dict(remat=remat, attn_impl="blockwise", attn_block_q=64,
              attn_block_k=64)
    return JParallelConfig(**kw), ParallelConfig(**kw)


# ---------------------------------------------------------------------------
# config, meta, counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False])
def test_meta_and_param_counts_match(smoke):
    """The smoke tree and the full tree (no allocation): the same paths,
    shapes, logical axes, init rules and dtypes (no QKV bias on a
    cross-attention); the same counts, for the full config 977,860,608
    total, 715,454,464 active, 262,406,144 embedding."""
    jc = j_smoke_config(ARCH) if smoke else j_get_config(ARCH)
    tc = smoke_config(ARCH) if smoke else get_config(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        J_ZOO.model_meta(jc), is_leaf=lambda x: hasattr(x, "axes"))
    tm = list(SH.leaves_with_path(ZOO.model_meta(tc)))
    assert [p for p, _ in tm] == [jax.tree_util.keystr(p) for p, _ in flat]
    for (_, jl), (_, tl) in zip(flat, tm):
        assert (jl.shape, jl.axes, jl.init, jl.dtype) == \
            (tl.shape, tl.axes, tl.init, tl.dtype)
    assert ZOO.param_counts(tc) == J_ZOO.param_counts(jc)
    if not smoke:
        assert ZOO.param_counts(tc) == {"total": 977_860_608,
                                        "active": 715_454_464,
                                        "embed": 262_406_144}
        assert NOT_PORTED == ()


@pytest.mark.parametrize("cross", [False, True])
def test_attn_meta_matches_with_a_qkv_bias(cross):
    """A config with a QKV bias: self-attention has it, cross-attention
    does not, in both packages."""
    jc = dataclasses.replace(j_smoke_config(ARCH), qkv_bias=True)
    tc = dataclasses.replace(smoke_config(ARCH), qkv_bias=True)
    want = J_BLK.attn_meta(jc, cross=cross)
    got = BLK.attn_meta(tc, cross=cross)
    assert sorted(got) == sorted(want)
    assert ("b_q" in got) is not cross
    for k in want:
        assert (got[k].shape, got[k].axes, got[k].init) == \
            (want[k].shape, want[k].axes, want[k].init)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_audio_batch_shapes_match(kind):
    """``batch_shapes`` of the full config: the reference's names, shapes,
    axes and dtypes (4096 bf16 frame embeddings beside the tokens);
    ``concrete_batch`` draws them at those shapes and dtypes."""
    cfg = get_config(ARCH)
    got = ZOO.batch_shapes(cfg, ShapeConfig("s", 32, 2, kind))
    want = J_ZOO.batch_shapes(j_get_config(ARCH),
                              JShapeConfig("s", 32, 2, kind))
    assert list(got) == list(want)
    for name, (shp, dt, ax) in got.items():
        wshp, wdt, wax = want[name]
        assert (shp, ax) == (wshp, wax)
        assert str(dt).split(".")[-1] == np.dtype(wdt).name
    small = smoke_config(ARCH)
    batch = ZOO.concrete_batch(small, ShapeConfig("s", 32, 2, kind),
                               torch.Generator().manual_seed(0))
    for name, (shp, dt, _) in ZOO.batch_shapes(
            small, ShapeConfig("s", 32, 2, kind)).items():
        assert tuple(batch[name].shape) == shp and batch[name].dtype == dt


def test_pipeline_draws_the_references_frames():
    """The data pipeline's audio batches (tokens, labels, float32 frame
    embeddings) equal the reference's bit for bit."""
    cfg = smoke_config(ARCH)
    shape = (ShapeConfig("s", 32, 2, "train"),
             JShapeConfig("s", 32, 2, "train"))
    got = T_PIPE.make_batch_iterator(cfg, shape[0], start_step=3)
    want = J_PIPE.make_batch_iterator(j_smoke_config(ARCH), shape[1],
                                      start_step=3)
    for _ in range(2):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w) == ["frame_embeds", "labels",
                                          "tokens"]
        assert g["frame_embeds"].dtype == np.float32
        assert g["frame_embeds"].shape == (2, cfg.frontend_len,
                                           cfg.d_model)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
# cross-attention sub-layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attn_apply_matches(dtype):
    """``attn_apply(kv_source=, use_rope=False, want_cache=True)``: 16
    queries over 128 source positions, output and the (unrotated) k/v
    cache; and with RoPE on, k rotated at ``arange(Sk)``."""
    jc, tc = _cfgs(dtype)
    jp, tp = _params(jc, seed=1)
    jpc, tpc = _pcfgs()
    lp = jax.tree.map(lambda a: a[0], jp["decoder"]["cross_attn"])
    tlp = {k: v[0] for k, v in tp["decoder"]["cross_attn"].items()}
    rng = np.random.default_rng(2)
    jx, tx = _arr(rng.standard_normal((2, TOKENS, 64), np.float32), dtype)
    js, ts = _arr(rng.standard_normal((2, FRAMES, 64), np.float32), dtype)
    pos = np.arange(TOKENS)[None]
    for rope in (False, True):
        jy, (jk, jv) = J_BLK.attn_apply(
            lp, jx, jc, jpc, positions=jnp.asarray(pos), causal=False,
            kv_source=js, use_rope=rope, want_cache=True)
        ty, (tk, tv) = BLK.attn_apply(
            tlp, tx, tc, tpc, positions=torch.from_numpy(pos),
            causal=False, kv_source=ts, use_rope=rope, want_cache=True)
        for got, want in ((ty, jy), (tk, jk), (tv, jv)):
            _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attn_decode_matches(dtype):
    """``attn_decode(cross=True, cross_len=)`` over a 128-position cross
    cache with ragged valid lengths: the output matches, q gets no RoPE
    and the cache is left as it was (nothing written)."""
    jc, tc = _cfgs(dtype)
    jp, tp = _params(jc, seed=3)
    jpc, tpc = _pcfgs()
    lp = jax.tree.map(lambda a: a[0], jp["decoder"]["cross_attn"])
    tlp = {k: v[0] for k, v in tp["decoder"]["cross_attn"].items()}
    rng = np.random.default_rng(4)
    jx, tx = _arr(rng.standard_normal((2, 1, 64), np.float32), dtype)
    jk, tk = _arr(rng.standard_normal((2, FRAMES, 64), np.float32), dtype)
    jv, tv = _arr(rng.standard_normal((2, FRAMES, 64), np.float32), dtype)
    clen = np.array([5, 7], np.int32)
    xlen = np.array([FRAMES, 40], np.int32)
    before = (tk.clone(), tv.clone())
    jy, _, _ = J_BLK.attn_decode(lp, jx, jc, jpc, cache_k=jk, cache_v=jv,
                                 cache_len=jnp.asarray(clen), cross=True,
                                 cross_len=jnp.asarray(xlen))
    ty, ck, cv = BLK.attn_decode(tlp, tx, tc, tpc, cache_k=tk, cache_v=tv,
                                 cache_len=torch.from_numpy(clen),
                                 cross=True,
                                 cross_len=torch.from_numpy(xlen))
    _close(ty, jy, TOL[dtype])
    assert ck is tk and cv is tv
    assert torch.equal(tk, before[0]) and torch.equal(tv, before[1])


def test_mixed_dtype_attention_and_its_gradient_match():
    """bf16 queries against float32 keys and values (a bf16 decoder's
    cross-attention over a float32 encoder): the output is bf16, as the
    reference's, and the gradients (bf16 q's, float32 k's and v's)
    match ``jax.grad`` of the reference's blockwise attention."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, TOKENS, 4, 16), np.float32)
    k = rng.standard_normal((2, FRAMES, 4, 16), np.float32)
    v = rng.standard_normal((2, FRAMES, 4, 16), np.float32)
    do = rng.standard_normal((2, TOKENS, 4, 16), np.float32)
    jq, tq = _arr(q, "bfloat16")
    kw = dict(causal=False, block_q=16, block_k=16)

    def jloss(q, k, v):
        o = J_ATT.blockwise_attention(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * do), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(jq, jnp.asarray(k),
                                                   jnp.asarray(v))
    leaves = [tq.requires_grad_(), torch.from_numpy(k).requires_grad_(),
              torch.from_numpy(v).requires_grad_()]
    to = T_ATT.attention(*leaves, impl="blockwise", **kw)
    tg = torch.autograd.grad((to.float() * torch.from_numpy(do)).sum(),
                             leaves)
    _close(to, jo, TOL["bfloat16"])
    _close(tg[0], jg[0], TOL["bfloat16"])
    for got, want in zip(tg[1:], jg[1:]):
        _close(got, want, GRAD_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _f32_twin(jc, jp, jb):
    """The reference's float32 run of the same model and inputs: the
    bf16 weights and frames upcast (exactly)."""
    up = lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a
    return (dataclasses.replace(jc, dtype="float32"), jax.tree.map(up, jp),
            jax.tree.map(up, jb))


def _held(got, want, f32):
    """The port's ``got`` against the reference's ``want``: the same
    shape and dtype; float32 within 2e-4; bf16 each held against the
    float32 twin's ``f32``: the port's mean and max error at most twice
    the reference's.  (An element-wise 2e-2 does not survive two bf16
    layers: XLA fuses elementwise chains and skips bf16 roundings that
    the port's eager ops keep, so single elements near a cancellation
    differ by more; a fault moves the error by far more than 2x.)"""
    assert tuple(got.shape) == tuple(want.shape)
    assert _dt(got) == _dt(want)
    if _dt(want) == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["float32"],
                                   atol=TOL["float32"])
        return
    e_got = np.abs(_np(got) - _np(f32))
    e_want = np.abs(_np(want) - _np(f32))
    assert e_got.mean() <= 2 * e_want.mean(), (e_got.mean(), e_want.mean())
    assert e_got.max() <= 2 * e_want.max(), (e_got.max(), e_want.max())


@pytest.mark.parametrize("weights,frames", DTYPES)
def test_encode_matches(weights, frames):
    """``encode`` (bidirectional, RoPE over ``arange(F)``) over 128
    frames: the reference's output dtype (float32 frames keep a bf16
    model's encoder in float32, and it then matches within 2e-4), and
    its values (``_held``)."""
    jc, tc = _cfgs(weights)
    jp, tp = _params(jc, seed=6)
    jpc, tpc = _pcfgs()
    jb, tb = _batch(tc, 7, frames)
    enc = jax.jit(J_ED.encode, static_argnums=(2, 3))
    want = enc(jp, jb["frame_embeds"], jc, jpc)
    jc32, jp32, jb32 = _f32_twin(jc, jp, jb)
    got = ED.encode(tp, tb["frame_embeds"], tc, tpc)
    assert _dt(want) == frames
    _held(got, want, enc(jp32, jb32["frame_embeds"], jc32, jpc))


def test_narrow_frames_against_wide_weights_raise_in_both():
    """bf16 frames against float32 weights: the first layer's output is
    promoted to float32, which the reference's scan carry refuses
    (``TypeError``); the port refuses it too."""
    jc, tc = _cfgs("float32")
    jp, tp = _params(jc, seed=8)
    jpc, tpc = _pcfgs()
    jb, tb = _batch(tc, 9, "bfloat16")
    with pytest.raises(TypeError):
        J_ED.encode(jp, jb["frame_embeds"], jc, jpc)
    with pytest.raises(TypeError, match="carry"):
        ED.encode(tp, tb["frame_embeds"], tc, tpc)


def _grow(name, a):
    """A prefill cache leaf with 4 more self-attention positions."""
    if name in ("k", "v"):
        return jnp.pad(a, [(0, 0), (0, 0), (0, 4), (0, 0)])
    return a


def _j_run(jc, jp, jb, jpc, feed=None):
    """The reference's prefill and three decode steps, fed ``feed`` (or
    its own greedy tokens): (logits by step, prefill cache, final cache,
    cache lengths by step, the tokens fed)."""
    jl, jcache, jlen = jax.jit(J_ZOO.prefill_fn, static_argnums=(2, 3))(
        jp, jb, jc, jpc)
    pre = jcache
    jcache = {n: _grow(n, a) for n, a in jcache.items()}
    jdecode = jax.jit(J_ZOO.decode_fn, static_argnums=(4, 5))
    logits, lens, toks = [jl], [jlen], []
    for i in range(3):
        tok = feed[i] if feed is not None else \
            np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jcache, jlen = jdecode(jp, jcache, jlen, jnp.asarray(tok), jc,
                                   jpc)
        logits.append(jl)
        lens.append(jlen)
        toks.append(tok)
    return logits, pre, jcache, lens, toks


@pytest.mark.parametrize("weights,frames", DTYPES)
def test_prefill_and_three_decode_steps_match(weights, frames):
    """``prefill_fn`` (128 frames, 2 x 16 tokens) and three decode steps,
    each fed the reference's greedy token: logits at every step, the
    cache lengths (the text alone) and, after prefill and at the end,
    the ``k``, ``v``, ``cross_k`` and ``cross_v`` caches, each in the
    reference's dtype (float32 cross caches under float32 frames, bf16
    self caches and logits) and held to it by ``_held``.  float32: the
    same greedy tokens."""
    jc, tc = _cfgs(weights)
    jp, tp = _params(jc, seed=10)
    jpc, tpc = _pcfgs()
    jb, tb = _batch(tc, 11, frames)
    jls, jpre, jcache, jlens, toks = _j_run(jc, jp, jb, jpc)
    f32 = (jls, jpre, jcache)
    if weights != "float32":
        f32 = _j_run(*_f32_twin(jc, jp, jb), jpc, feed=toks)[:3]
    assert _dt(jpre["cross_k"]) == frames and _dt(jpre["k"]) == weights
    tl, tcache, tlen = ZOO.prefill_fn(tp, tb, tc, tpc)
    assert sorted(tcache) == sorted(jpre) == ["cross_k", "cross_v", "k",
                                              "v"]
    for n in jpre:
        _held(tcache[n], jpre[n], f32[1][n])
    tcache = {n: torch.cat([t, t.new_zeros(t.shape[:2] + (4,)
                                           + t.shape[3:])], dim=2)
              if n in ("k", "v") else t for n, t in tcache.items()}
    for i in range(4):
        _held(tl, jls[i], f32[0][i])
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlens[i]))
        assert tlen.tolist() == [TOKENS + i] * 2
        if i == 3:
            break
        if weights == "float32":
            np.testing.assert_array_equal(
                torch.argmax(tl, dim=-1).numpy(), toks[i])
        tl, tcache, tlen = ZOO.decode_fn(tp, tcache, tlen,
                                         torch.from_numpy(toks[i]), tc, tpc)
    for n in jcache:
        _held(tcache[n], jcache[n], f32[2][n])


def test_init_cache_matches():
    """``init_cache``: k/v at ``max_len``, the cross caches at the
    config's ``frontend_len``, every leaf leading with the layer axis."""
    jc, tc = _cfgs("bfloat16")
    want = J_ZOO.init_cache(jc, 2, 24, jnp.bfloat16)
    got = ZOO.init_cache(tc, 2, 24, "bfloat16")
    assert sorted(got) == sorted(want)
    for n in want:
        assert tuple(got[n].shape) == want[n].shape == \
            (2, 2, 24 if n in ("k", "v") else tc.frontend_len, 64)
        assert got[n].dtype == torch.bfloat16 and not got[n].any()


def _torch_grads(tc, tp, tb, remat):
    flat = T_MV._flatten(tp)
    leaves = [t.detach().clone().requires_grad_() for _, t in flat]
    view = T_MV._unflatten(tp, {p: t for (p, _), t in zip(flat, leaves)})
    loss = ZOO.loss_fn(view, tb, tc, _pcfgs(remat)[1])
    return [p for p, _ in flat], loss, torch.autograd.grad(loss, leaves)


def test_loss_and_grads_match_reference():
    """``loss_fn`` and every parameter's gradient, float32, remat
    ``"block"`` in both, against ``jax.value_and_grad(zoo.loss_fn)``."""
    jc, tc = _cfgs("float32")
    jp, tp = _params(jc, seed=12)
    jb, tb = _batch(tc, 13, "float32", labels=True)
    jl, jg = jax.jit(jax.value_and_grad(J_ZOO.loss_fn),
                     static_argnums=(2, 3))(jp, jb, jc, _pcfgs("block")[0])
    paths, tl, tg = _torch_grads(tc, tp, tb, "block")
    _close(tl, jl, GRAD_TOL)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert paths == [jax.tree_util.keystr(p) for p, _ in jflat]
    for got, (_, want) in zip(tg, jflat):
        _close(got, want, GRAD_TOL)


@pytest.mark.parametrize("remat", ["block", "group:2"])
def test_remat_gives_the_unrematerialized_gradients(remat):
    """``remat="block"`` (each encoder and decoder layer recomputed in the
    backward) gives ``"none"``'s loss and gradients bit for bit;
    ``"group:2"`` checkpoints nothing in this family, in the reference
    as here, and gives them too."""
    _, tc = _cfgs("float32")
    _, tp = _params(_cfgs("float32")[0], seed=14)
    _, tb = _batch(tc, 15, "float32", labels=True)
    _, base_loss, base = _torch_grads(tc, tp, tb, "none")
    _, loss, grads = _torch_grads(tc, tp, tb, remat)
    assert torch.equal(loss, base_loss)
    for a, b in zip(grads, base):
        assert torch.equal(a, b)


def test_bf16_loss_over_float32_frames_matches():
    """The trainer's dtypes: a bf16 model over the pipeline's float32
    frames (the encoder in float32, the cross-attention bf16 over
    float32 k/v): the loss within 2e-2 and its gradient finite in the
    leaves' own dtypes."""
    jc, tc = _cfgs("bfloat16")
    jp, tp = _params(jc, seed=16)
    jb, tb = _batch(tc, 17, "float32", labels=True)
    jl = jax.jit(J_ZOO.loss_fn, static_argnums=(2, 3))(
        jp, jb, jc, _pcfgs("block")[0])
    _, tl, tg = _torch_grads(tc, tp, tb, "block")
    _close(tl, jl, TOL["bfloat16"])
    for (_, leaf), g in zip(T_MV._flatten(tp), tg):
        assert g.dtype == leaf.dtype and bool(torch.isfinite(g).all())


# ---------------------------------------------------------------------------
# trainer, steps, server
# ---------------------------------------------------------------------------


def _state_np(state):
    """Live blocks and moments of a train state (either package)."""
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
    """One ``Trainer(device="cpu")`` step (the pipeline's float32 frame
    embeddings beside the tokens) against the reference trainer's step
    from the same weights and batch, float32: loss, live blocks and
    moments within 1e-4."""
    from repro.launch.train import Trainer as JTrainer
    from repro_torch.launch.train import Trainer

    kw = dict(mode="U", fused_commit=True) if mode == "U_fused" \
        else dict(mode="Q")
    jc, tc = _cfgs("float32")
    jt = JTrainer(jc, JShapeConfig("t", 32, 2, "train"),
                  mvcfg=JMVStoreConfig(**kw), seed=1)
    init = jax.tree.map(np.asarray, jt.state.mv.live)
    batch = jt.batch_at(0)
    assert batch["frame_embeds"].dtype == np.float32
    jstate, jm = jt.train_step(jt.state, batch)
    jt.controller.stop()
    tt = Trainer(tc, ShapeConfig("t", 32, 2, "train"),
                 mvcfg=MVStoreConfig(**kw), params=init, device="cpu")
    tstate, tm = tt.train_step(tt.state, tt.batch_at(0))
    tt.controller.stop()
    assert tstate.mv.clock == int(jstate.mv.clock) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    got, want = _state_np(tstate), _state_np(jstate)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


def test_steps_from_a_mode_u_snapshot_match():
    """``make_prefill_step`` and three ``make_decode_step`` calls reading a
    Mode-U store (every block versioned, 2 ring slots) at clock 0 after
    a commit of a negated ``lm_head`` at clock 1: every step ``ok``, the
    logits those of the live-parameter calls on the clock-0 weights
    (bit for bit) and the reference's steps' (within 2e-4)."""
    jc, tc = _cfgs("float32")
    jp, tp = _params(jc, seed=18)
    jpc, tpc = _pcfgs()
    jb, tb = _batch(tc, 19, "float32")
    jmv, tmv = JMVStoreConfig(mode="U", ring_slots=2), \
        MVStoreConfig(mode="U", ring_slots=2)
    jst = J_MV.mv_init(jp, jmv, versioned="all")
    tst = T_MV.mv_init(tp, tmv, versioned="all")
    jst = J_MV.mv_commit(jst, {**jp, "lm_head": -jp["lm_head"]},
                         local_mode="U", cfg=jmv)
    tst = T_MV.mv_commit(tst, {**tp, "lm_head": -tp["lm_head"]},
                         local_mode="U", cfg=tmv)
    jpre = J_STEPS.make_prefill_step(jc, jpc, jmv)
    jdec = J_STEPS.make_decode_step(jc, jpc, jmv)
    tpre = T_STEPS.make_prefill_step(tc, tpc, tmv)
    tdec = T_STEPS.make_decode_step(tc, tpc, tmv)
    jl, jcache, jlen, jok = jpre(jst, jb, 0)
    tl, tcache, tlen, tok_ = tpre(tst, tb, 0)
    ll, lcache, llen = ZOO.prefill_fn(tp, tb, tc, tpc)
    jcache = {n: _grow(n, a) for n, a in jcache.items()}
    tcache = ZOO.params_from_numpy(jax.tree.map(np.asarray, jcache))
    lcache = ZOO.params_from_numpy(jax.tree.map(np.asarray, jcache))
    for step in range(4):
        assert bool(jok) and bool(tok_)
        assert torch.equal(tl, ll)
        _close(tl, jl, TOL["float32"])
        if step == 3:
            break
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jcache, jlen, jok = jdec(jst, jcache, jlen, jnp.asarray(tok), 0)
        tl, tcache, tlen, tok_ = tdec(tst, tcache, tlen,
                                      torch.from_numpy(tok), 0)
        ll, lcache, llen = ZOO.decode_fn(tp, lcache, llen,
                                         torch.from_numpy(tok), tc, tpc)
    assert torch.equal(tlen, llen)


def test_both_servers_fail_at_the_first_prefill():
    """The reference's ``Server`` hands a prefill only its tokens, so an
    encoder-decoder config fails at its first request with
    ``KeyError('frame_embeds')``; the port's keeps that failure (it gains
    no frame-embeddings feature the reference lacks)."""
    from repro.launch.serve import Server as JServer
    from repro_torch.launch.serve import Server

    jc, tc = _cfgs("float32")
    jp, tp = _params(jc, seed=20)
    prompt = np.arange(TOKENS, dtype=np.int32)[None]
    kw = dict(batch=1, prompt_len=TOKENS, max_len=TOKENS + 2)
    for server in (JServer(jc, params=jp, **kw),
                   Server(tc, params=tp, device="cpu", **kw)):
        with pytest.raises(KeyError, match="frame_embeds"):
            server.serve_batch(prompt, 2)
