"""The port's optimizer and ``fused_adamw`` plain version against the JAX
package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Tolerances are those of ``tests/test_kernels.py``: parameters and ring
1e-5 at float32 and 2e-2 at bfloat16, moments 1e-5.  The reference's
Pallas ``fused_adamw`` runs in interpret mode, as its own tests run it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as J_OPS
from repro.kernels import ref as J_REF
from repro.optim import adamw as J_ADAMW
from repro_torch.kernels import fused_adamw as FA
from repro_torch.launch import sharding as SH
from repro_torch.optim import adamw as ADAMW

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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


def _both(a, dtype):
    """A float32 numpy array as a (jax, torch) pair of ``dtype``, equal
    bit for bit."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _tree(rng, dtype):
    """A small parameter-shaped tree: 2-d leaves (decayed) and a 1-d one
    (not), as (jax tree, torch tree)."""
    shapes = {"w": (8, 12), "layers": {"a": (3, 4, 5)}, "norm": (12,)}
    j, t = {}, {}
    for k, s in shapes.items():
        if isinstance(s, dict):
            pairs = {kk: _both(rng.standard_normal(ss), dtype)
                     for kk, ss in s.items()}
            j[k] = {kk: p[0] for kk, p in pairs.items()}
            t[k] = {kk: p[1] for kk, p in pairs.items()}
        else:
            j[k], t[k] = _both(rng.standard_normal(s), dtype)
    return j, t


@pytest.mark.parametrize("warmup,total", [(100, 10000), (10, 1000),
                                          (0, 1)])
def test_schedule_matches_reference(warmup, total):
    cfg_j = J_ADAMW.AdamWConfig(warmup_steps=warmup, total_steps=total)
    cfg_t = ADAMW.AdamWConfig(warmup_steps=warmup, total_steps=total)
    steps = np.array([0, 1, 3, 9, 10, 11, 99, 100, 101, 500, 999, 5000,
                      10000, 20000], np.float32)
    want = J_ADAMW.schedule(jnp.asarray(steps), cfg_j)
    got = ADAMW.schedule(torch.from_numpy(steps), cfg_t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [ADAMW.NORM_CHUNK, 7])
def test_global_norm_matches_reference(dtype, chunk, monkeypatch):
    monkeypatch.setattr(ADAMW, "NORM_CHUNK", chunk)
    j, t = _tree(np.random.default_rng(1), dtype)
    got = ADAMW.global_norm(t)
    assert got.dtype == torch.float32
    _close(got, J_ADAMW.global_norm(j), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count", [0, 4])
def test_apply_matches_reference(dtype, count):
    rng = np.random.default_rng(2)
    jp, tp = _tree(rng, dtype)
    jg, tg = _tree(rng, "float32")
    jm, tm = _tree(rng, "float32")
    jv, tv = _tree(rng, "float32")
    jv = jax.tree.map(jnp.abs, jv)
    tv = SH.tree_map(torch.abs, tv)
    cfg = dict(lr=3e-3, warmup_steps=3, total_steps=50)
    jstate = J_ADAMW.AdamWState(jm, jv, jnp.int32(count))
    tstate = ADAMW.AdamWState(tm, tv, torch.tensor(count, dtype=torch.int32))
    jnew, jopt = J_ADAMW.apply(jg, jstate, jp, J_ADAMW.AdamWConfig(**cfg))
    tnew, topt = ADAMW.apply(tg, tstate, tp, ADAMW.AdamWConfig(**cfg))
    assert int(topt.count) == int(jopt.count) == count + 1
    for got, want in zip(SH.tree_leaves(tnew), jax.tree.leaves(jnew)):
        assert got.dtype == getattr(torch, dtype)
        _close(got, want, TOL[dtype])
    for tree_t, tree_j in ((topt.mu, jopt.mu), (topt.nu, jopt.nu)):
        for got, want in zip(SH.tree_leaves(tree_t),
                             jax.tree.leaves(tree_j)):
            _close(got, want, 1e-5)
    # functional: the inputs are untouched
    for got, want in zip(SH.tree_leaves(tm), jax.tree.leaves(jm)):
        np.testing.assert_array_equal(_np(got), _np(want))


def _adamw_inputs(shape, dtype, with_ring, seed=5, g_dtype="float32"):
    rng = np.random.default_rng(seed)
    jp, tp = _both(rng.standard_normal(shape), dtype)
    jg, tg = _both(rng.standard_normal(shape), g_dtype)
    jm, tm = _both(rng.standard_normal(shape) * 0.1, "float32")
    jv, tv = _both(np.abs(rng.standard_normal(shape)) * 0.01, "float32")
    jr = tr = None
    if with_ring:
        jr, tr = _both(np.zeros((3,) + tuple(shape)), dtype)
    return (jp, jg, jm, jv, jr), (tp, tg, tm, tv, tr)


KW = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)


def _scalars(lr, scale, count):
    cnt = jnp.float32(count)
    b1c, b2c = 1 - 0.9 ** cnt, 1 - 0.95 ** cnt
    vals = np.array([lr, scale, float(b1c), float(b2c)], np.float32)
    return b1c, b2c, torch.from_numpy(vals)


@pytest.mark.parametrize("shape", [(64,), (24, 16), (3, 5, 8)])
@pytest.mark.parametrize("with_ring", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_adamw_plain_matches_reference(shape, with_ring, dtype):
    """The sweep of ``tests/test_kernels.py::test_fused_adamw_sweep``:
    ``fused_adamw`` on CPU tensors (its plain version) against
    ``ref.fused_adamw_ref`` and against ``ops.fused_adamw`` (the Pallas
    kernel in interpret mode)."""
    (jp, jg, jm, jv, jr), (tp, tg, tm, tv, tr) = _adamw_inputs(
        shape, dtype, with_ring)
    b1c, b2c, scalars = _scalars(3e-3, 0.7, 3)
    before = FA.launches.value
    p2 = FA.fused_adamw(tp, tg, tm, tv, tr, 2, scalars, **KW)
    assert FA.launches.value == before       # the CPU launches nothing
    kw = dict(lr=jnp.float32(3e-3), scale=jnp.float32(0.7), **KW)
    pr, mr, vr, rr = J_REF.fused_adamw_ref(
        jp.reshape(-1), jg.reshape(-1), jm.reshape(-1), jv.reshape(-1),
        jr.reshape(3, -1) if with_ring else None, 2, b1c=b1c, b2c=b2c, **kw)
    pk, mk, vk, rk = J_OPS.fused_adamw(jp, jg, jm, jv, jr, 2,
                                       count=jnp.int32(3), **kw)
    tol = TOL[dtype]
    assert p2.dtype == tp.dtype and p2.shape == tp.shape
    for want_p, want_m, want_v in ((pr, mr, vr), (pk, mk, vk)):
        _close(p2.reshape(-1), want_p.reshape(-1), tol)
        _close(tm.reshape(-1), want_m.reshape(-1), 1e-5)
        _close(tv.reshape(-1), want_v.reshape(-1), 1e-5)
    if with_ring:
        _close(tr.reshape(3, -1), rr, tol)
        _close(tr, rk, tol)
        np.testing.assert_array_equal(_np(tr[2]), _np(p2))
        assert float(tr[:2].abs().sum()) == 0.0      # other slots untouched


@pytest.mark.parametrize("case", ["ragged", "empty", "bf16_grad"])
def test_fused_adamw_plain_edge_cases(case):
    """A ragged n (no tile divides it), n = 0, and a bfloat16 gradient
    (read as is; the reference widens it to f32 first, exactly)."""
    n = {"ragged": 2053, "empty": 0, "bf16_grad": 300}[case]
    g_dtype = "bfloat16" if case == "bf16_grad" else "float32"
    (jp, jg, jm, jv, jr), (tp, tg, tm, tv, tr) = _adamw_inputs(
        (n,), "bfloat16", True, seed=7, g_dtype=g_dtype)
    b1c, b2c, scalars = _scalars(1e-3, 0.5, 7)
    p2 = FA.fused_adamw(tp, tg, tm, tv, tr, 1, scalars, **KW)
    pr, mr, vr, rr = J_REF.fused_adamw_ref(
        jp, jg.astype(jnp.float32), jm, jv, jr, 1, lr=jnp.float32(1e-3),
        scale=jnp.float32(0.5), b1c=b1c, b2c=b2c, **KW)
    assert p2.shape == (n,) and p2.dtype == torch.bfloat16
    _close(p2, pr, TOL["bfloat16"])
    _close(tm, mr, 1e-5)
    _close(tv, vr, 1e-5)
    _close(tr, rr, TOL["bfloat16"])


@pytest.mark.parametrize("slot", [3, -1, 10])
def test_fused_adamw_slot_out_of_range_raises(slot):
    _, (tp, tg, tm, tv, tr) = _adamw_inputs((16,), "float32", True)
    m0 = tm.clone()
    with pytest.raises(IndexError):
        FA.fused_adamw(tp, tg, tm, tv, tr, slot,
                       _scalars(1e-3, 1.0, 1)[2], **KW)
    assert torch.equal(tm, m0)                    # nothing was written


def test_fused_adamw_rejects_mismatched_inputs():
    _, (tp, tg, tm, tv, tr) = _adamw_inputs((16,), "float32", True)
    sc = _scalars(1e-3, 1.0, 1)[2]
    with pytest.raises(ValueError):
        FA.fused_adamw(tp, tg[:8], tm, tv, tr, 0, sc, **KW)
    with pytest.raises(ValueError):
        FA.fused_adamw(tp, tg, tm.double(), tv, tr, 0, sc, **KW)
    with pytest.raises(ValueError):
        FA.fused_adamw(tp, tg, tm, tv, tr.bfloat16(), 0, sc, **KW)
    with pytest.raises(ValueError):
        FA.fused_adamw(tp, tg, tm, tv, tr, 0, sc[:3], **KW)


def test_state_from_numpy_round_trip():
    """The reference's AdamWState (after a step, so every leaf is
    non-trivial) carried across keeps every leaf bit for bit."""
    rng = np.random.default_rng(3)
    jp, _ = _tree(rng, "bfloat16")
    jg, _ = _tree(rng, "float32")
    cfg = J_ADAMW.AdamWConfig()
    _, jopt = J_ADAMW.apply(jg, J_ADAMW.init(jp, cfg), jp, cfg)
    topt = ADAMW.state_from_numpy(jax.tree.map(np.asarray, jopt))
    assert isinstance(topt, ADAMW.AdamWState)
    assert topt.count.dtype == torch.int32 and int(topt.count) == 1
    for tree_t, tree_j in ((topt.mu, jopt.mu), (topt.nu, jopt.nu)):
        assert set(tree_t) == set(tree_j)
        for got, want in zip(SH.tree_leaves(tree_t),
                             jax.tree.leaves(tree_j)):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = SH.tree_map(lambda t: t.numpy(), topt.mu)
    for got, want in zip(SH.tree_leaves(back), jax.tree.leaves(jopt.mu)):
        np.testing.assert_array_equal(got, np.asarray(want))
