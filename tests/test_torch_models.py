"""The port's model stack against the JAX package's, on the CPU.

Weights come from the reference's ``zoo.init_params`` (with the zero
biases replaced by seeded values, so the QKV-bias path does work), are
carried across by ``params_from_numpy`` and go through both packages;
every other input is made with numpy from a seed.  The reduced qwen2.5-3b
config runs at float32 (tolerance 2e-4, greedy tokens identical) and at
bfloat16 (2e-2): the tolerances of ``tests/test_kernels.py``.  The
reference's Pallas attention runs in interpret mode, as its own tests
run it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models import attention as J_ATT
from repro.models import blocks as J_BLK
from repro.models import common as J_COM
from repro.models import ffn as J_FFN
from repro.models import model_zoo as J_ZOO
from repro_torch.configs import ParallelConfig, get_config, smoke_config
from repro_torch.launch import sharding as SH
from repro_torch.models import attention as ATT
from repro_torch.models import blocks as BLK
from repro_torch.models import common as COM
from repro_torch.models import ffn as FFN
from repro_torch.models import model_zoo as ZOO
from repro_torch.models import transformer as TR

ARCH = "qwen2.5-3b"
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")


def _cfgs(dtype):
    jc = dataclasses.replace(j_smoke_config(ARCH), dtype=dtype)
    tc = dataclasses.replace(smoke_config(ARCH), dtype=dtype)
    return jc, tc


def _np(x):
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(a, dtype):
    """A float32 numpy array as a (jax, torch) pair of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _close(got, want, dtype):
    tol = TOL[dtype]
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.normal(0, 2, (2, 5, 64)), dtype)
    w = rng.normal(1, 0.1, 64).astype(np.float32)
    _close(COM.rmsnorm(tx, torch.from_numpy(w), 1e-6),
           J_COM.rmsnorm(jx, jnp.asarray(w), 1e-6), dtype)
    assert COM.rmsnorm(tx, torch.from_numpy(w)).dtype == tx.dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope_matches(dtype):
    rng = np.random.default_rng(2)
    jx, tx = _both(rng.normal(0, 1, (2, 7, 3, 16)), dtype)
    pos = rng.integers(0, 600, (2, 7)).astype(np.int32)
    got = COM.apply_rope(tx, torch.from_numpy(pos), 1e6)
    want = J_COM.apply_rope(jx, jnp.asarray(pos), 1e6)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ffn_apply_matches(dtype):
    jc, _ = _cfgs(dtype)
    jp, npp = _params(jc)
    layer0 = jax.tree.map(lambda a: a[0], npp["layers"]["sub0"]["ffn"])
    rng = np.random.default_rng(3)
    jx, tx = _both(rng.normal(0, 1, (2, 6, 64)), dtype)
    _close(FFN.ffn_apply(ZOO.params_from_numpy(layer0), tx),
           J_FFN.ffn_apply(jax.tree.map(jnp.asarray, layer0), jx), dtype)


@pytest.mark.parametrize("impl", ["blockwise", "pallas", "naive"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_apply_matches(impl, dtype):
    """The attention sub-layer, prefill with its cache, through each impl
    of the reference (Pallas in interpret mode) against the port's."""
    jc, tc = _cfgs(dtype)
    _, npp = _params(jc, seed=4)
    p0 = jax.tree.map(lambda a: a[0], npp["layers"]["sub0"]["attn"])
    S = 32
    jpc = JParallelConfig(attn_impl=impl, attn_block_q=16, attn_block_k=16)
    tpc = ParallelConfig(attn_impl=impl, attn_block_q=16, attn_block_k=16)
    rng = np.random.default_rng(5)
    jx, tx = _both(rng.normal(0, 1, (2, S, 64)), dtype)
    pos = np.arange(S)[None]
    jy, (jk, jv) = J_BLK.attn_apply(
        jax.tree.map(jnp.asarray, p0), jx, jc, jpc,
        positions=jnp.asarray(pos), want_cache=True)
    ty, (tk, tv) = BLK.attn_apply(
        ZOO.params_from_numpy(p0), tx, tc, tpc,
        positions=torch.from_numpy(pos), want_cache=True)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, dtype)


def test_blockwise_keeps_the_tiling_assertion():
    q = torch.zeros(1, 48, 2, 8)
    with pytest.raises(AssertionError):
        ATT.attention(q, q, q, causal=True, block_q=32, block_k=32)
    with pytest.raises(AssertionError):
        ATT.attention(q, q[:, :32], q[:, :32], causal=True)


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_matches(chunk, dtype):
    rng = np.random.default_rng(6)
    B, S, H, KV, D = 3, 32, 4, 2, 16
    jq, tq = _both(rng.normal(0, 1, (B, H, D)), dtype)
    jk, tk = _both(rng.normal(0, 1, (B, S, KV, D)), dtype)
    jv, tv = _both(rng.normal(0, 1, (B, S, KV, D)), dtype)
    cl = np.array([1, 17, 32], np.int32)
    got = ATT.decode_attention(tq, tk, tv, torch.from_numpy(cl), chunk=chunk)
    want = J_ATT.decode_attention(jq, jk, jv, jnp.asarray(cl), chunk=chunk)
    _close(got, want, dtype)


def _prefill_both(impl, dtype, seed):
    jc, tc = _cfgs(dtype)
    jp, npp = _params(jc, seed=seed)
    tp = ZOO.params_from_numpy(npp)
    jpc = JParallelConfig(remat="none", attn_impl=impl, attn_block_q=16,
                          attn_block_k=16)
    tpc = ParallelConfig(remat="none", attn_impl=impl, attn_block_q=16,
                         attn_block_k=16)
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, tc.vocab_size, (2, 16)).astype(np.int32)
    jout = J_ZOO.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jc, jpc)
    tout = ZOO.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, tc, tpc)
    return (jc, jp, jpc, jout), (tc, tp, tpc, tout)


@pytest.mark.parametrize("impl", ["blockwise", "pallas"])
def test_prefill_and_three_decode_steps_match(impl):
    """lm_prefill + three lm_decode_steps at float32, each fed the
    reference's own greedy token: logits and caches within 2e-4, and the
    port's greedy tokens are the reference's."""
    dtype = "float32"
    (jc, jp, jpc, (jl, jcache, jlen)), (tc, tp, tpc, (tl, _, tlen)) = \
        _prefill_both(impl, dtype, seed=7)
    _close(tl, jl, dtype)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    # grow both caches to 24 positions, as the server's cache is longer
    pad = [(0, 0), (0, 0), (0, 8), (0, 0)]
    jcache = jax.tree.map(lambda a: jnp.pad(a, pad), jcache)
    tcache = ZOO.params_from_numpy(jax.tree.map(np.asarray, jcache))
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(tl, dim=-1).numpy(), tok)
        jl, jcache, jlen = J_ZOO.decode_fn(jp, jcache, jlen,
                                           jnp.asarray(tok), jc, jpc)
        tl, tcache, tlen = ZOO.decode_fn(tp, tcache, tlen,
                                         torch.from_numpy(tok), tc, tpc)
        _close(tl, jl, dtype)
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    for sub in jcache:
        for n in ("k", "v"):
            _close(tcache[sub][n], jcache[sub][n], dtype)


@pytest.mark.parametrize("impl", ["blockwise", "pallas"])
def test_prefill_matches_at_bf16(impl):
    """The bfloat16 case: prefill logits and caches within 2e-2.  (bf16
    rounds at other places in the two frameworks, so the decode steps
    are held to the reference at float32, above.)"""
    dtype = "bfloat16"
    (_, _, _, (jl, jcache, jlen)), (_, _, _, (tl, tcache, tlen)) = \
        _prefill_both(impl, dtype, seed=7)
    assert tl.dtype == torch.bfloat16
    _close(tl, jl, dtype)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    for sub in jcache:
        for n in ("k", "v"):
            _close(tcache[sub][n], jcache[sub][n], dtype)


def test_decode_drops_a_write_past_the_cache():
    """A row whose cache is full is not written (the reference's scatter
    drops an out-of-range update); the other rows are."""
    _, tc = _cfgs("float32")
    gen = torch.Generator().manual_seed(0)
    tp = ZOO.init_params(tc, gen)
    cache = ZOO.init_cache(tc, 2, 4, "float32")
    before = cache["sub0"]["k"].clone()
    clen = torch.tensor([4, 1], dtype=torch.int32)
    logits, cache, clen2 = ZOO.decode_fn(
        tp, cache, clen, torch.tensor([3, 5], dtype=torch.int32), tc,
        ParallelConfig())
    assert torch.equal(cache["sub0"]["k"][:, 0], before[:, 0])
    assert not torch.equal(cache["sub0"]["k"][:, 1, 1], before[:, 1, 1])
    assert clen2.tolist() == [5, 2] and torch.isfinite(logits).all()


def test_params_from_numpy_round_trip():
    """bf16 bits survive, every other dtype round-trips, and the paths are
    the ones ``keystr`` spells."""
    jc = j_smoke_config(ARCH)
    jp = J_ZOO.init_params(jc, jax.random.PRNGKey(3))
    npp = jax.tree.map(np.asarray, jp)
    tp = ZOO.params_from_numpy(npp)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    jpaths = [jax.tree_util.keystr(p) for p, _ in flat]
    tpaths = [p for p, _ in SH.leaves_with_path(tp)]
    assert tpaths == jpaths
    from repro_torch.core import mvstore
    assert mvstore.block_paths(tp) == jpaths
    for (path, jleaf), (_, tleaf) in zip(flat, SH.leaves_with_path(tp)):
        a = np.asarray(jleaf)
        assert tuple(tleaf.shape) == a.shape
        if a.dtype.name == "bfloat16":
            assert tleaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                tleaf.view(torch.int16).numpy().view(np.uint16),
                a.view(np.uint16))
        else:
            np.testing.assert_array_equal(tleaf.numpy(), a)


@pytest.mark.parametrize("smoke", [True, False])
def test_meta_and_param_counts_match(smoke):
    """The full qwen2.5-3b tree (no allocation) and the smoke tree: the
    same paths, shapes, dtypes and init rules; the same counts."""
    jc = j_smoke_config(ARCH) if smoke else j_get_config(ARCH)
    tc = smoke_config(ARCH) if smoke else get_config(ARCH)
    jm = J_ZOO.model_meta(jc)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jm, is_leaf=lambda x: hasattr(x, "axes"))
    tm = list(SH.leaves_with_path(ZOO.model_meta(tc)))
    assert [p for p, _ in tm] == [jax.tree_util.keystr(p) for p, _ in flat]
    for (_, jl), (_, tl) in zip(flat, tm):
        assert (jl.shape, jl.axes, jl.init, jl.dtype) == \
            (tl.shape, tl.axes, tl.init, tl.dtype)
    assert ZOO.param_counts(tc) == J_ZOO.param_counts(jc)
    if not smoke:
        assert TR.n_groups(tc) == 36
        assert dict(SH.leaves_with_path(ZOO.model_meta(tc)))[
            "['lm_head']"].shape == (2048, 152064)


def test_materialize_follows_the_init_rules():
    _, tc = _cfgs("float32")
    a = ZOO.init_params(tc, torch.Generator().manual_seed(11))
    b = ZOO.init_params(tc, torch.Generator().manual_seed(11))
    for (p, x), (_, y) in zip(SH.leaves_with_path(a),
                              SH.leaves_with_path(b)):
        assert torch.equal(x, y), p
    lay = a["layers"]["sub0"]
    assert torch.equal(lay["norm_mixer"], torch.ones(2, 64))
    assert torch.equal(lay["attn"]["b_q"], torch.zeros(2, 64))
    w = lay["ffn"]["w_down"]                       # fan_in 128
    assert abs(float(w.std()) - 128 ** -0.5) < 0.01
    e = a["embed"]                                 # fan_in = padded vocab
    assert abs(float(e.std()) - 512 ** -0.5) < 0.005
    bf = ZOO.init_params(smoke_config(ARCH),
                         torch.Generator().manual_seed(0))
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["final_norm"].dtype == torch.float32


def test_unported_archs_and_kinds_say_so():
    """Nothing is left unported: ``NOT_PORTED`` is empty, the
    encoder-decoder seamless-m4t-medium is registered (the reference's
    config field for field) and builds the encoder-decoder tree, and an
    unknown arch raises ``KeyError``; every sub-layer kind a
    decoder-only config builds, the MoE ones included, has its
    parameters."""
    from repro_torch.configs import ARCH_IDS, NOT_PORTED, REGISTRY
    assert NOT_PORTED == ()
    assert ARCH_IDS == J_ARCH_IDS
    cfg = get_config("seamless-m4t-medium")
    assert REGISTRY["seamless-m4t-medium"] is cfg and cfg.is_encdec
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        j_get_config("seamless-m4t-medium"))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    cfg = smoke_config("jamba-v0.1-52b")
    for kind in (("attn", "moe"), ("mamba", "moe")):
        m = BLK.sublayer_meta(cfg, kind)
        assert set(m["moe"]) == {"w_router", "w_gate", "w_up", "w_down"}
        assert "norm_ffn" in m
    meta = ZOO.model_meta(dataclasses.replace(cfg, is_encdec=True))
    assert sorted(meta) == ["decoder", "embed", "enc_norm", "encoder",
                            "final_norm", "lm_head"]


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_smoke_config_is_the_references(arch):
    """``smoke_config`` reduces every architecture of the JAX package's
    registry field for field as the reference does (depth by family, the
    MoE reduction, the hybrid interleave); the port's full configs equal
    the reference's too."""
    from repro_torch.configs import NOT_PORTED
    if arch in NOT_PORTED:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            smoke_config(arch)
        return
    for mine, ref in ((smoke_config(arch), j_smoke_config(arch)),
                      (get_config(arch), j_get_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_materialize_bounds_its_float32_draw(monkeypatch):
    """A leaf larger than ``DRAW_CAP_BYTES`` as float32 is drawn in
    slices no larger than the cap, into its final dtype, and its values
    keep the init rule's std (scale / sqrt(fan_in))."""
    from repro_torch.launch.sharding import ParamMeta
    monkeypatch.setattr(SH, "DRAW_CAP_BYTES", 4096)
    draws = []
    randn = torch.randn

    def recording(*shape, **kw):
        t = randn(*shape, **kw)
        draws.append(t.numel() * t.element_size())
        return t

    monkeypatch.setattr(SH.torch, "randn", recording)
    meta = {"w": ParamMeta((6, 40, 256), (None, None, None), scale=2.0,
                           dtype="bfloat16"),
            "b": ParamMeta((100,), (None,), dtype="float32")}
    out = SH.materialize(meta, torch.Generator().manual_seed(3))
    assert max(draws) <= 4096
    assert sum(draws) == 4 * (6 * 40 * 256 + 100)
    w = out["w"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (6, 40, 256)
    assert abs(float(w.float().std()) - 2.0 / 40 ** 0.5) < 0.01
    assert abs(float(out["b"].std()) - 100 ** -0.5) < 0.03
