"""The port's mixture-of-experts layer against the JAX package's, on the
CPU.

The expert weights come from the reference's ``moe_meta`` through its
``materialize`` and are carried across by ``params_from_numpy``; the
activations are numpy from a seed.  ``route``'s slot tables must agree
bit for bit (routing is discrete: one different choice moves a token to
another expert), its weights and aux loss within 1e-6; ``moe_apply``
within 2e-4 at float32 and 2e-2 at bfloat16 (``tests/test_kernels.py``'s
tolerances), over (G, N, E, K) grids with and without dropped slots,
per-sequence and whole-batch groups, and with and without a shared
expert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.launch.sharding import materialize as j_materialize
from repro.models import moe as J_MOE
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as MOE
from repro_torch.models.model_zoo import params_from_numpy

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
#: (G, N, E, K) route grids
GRIDS = [(1, 16, 4, 1), (2, 32, 8, 2), (3, 24, 8, 3), (2, 64, 4, 2),
         (2, 48, 16, 6)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(E, K, F=32, shared=0):
    kw = dict(num_experts=E, experts_per_token=K, d_ff_expert=F,
              num_shared_experts=shared)
    return JMoEConfig(**kw), MoEConfig(**kw)


def _route_both(G, N, E, K, cf, seed, d=32, tie=False):
    jc, tc = _cfgs(E, K)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (G, N, d)).astype(np.float32)
    w = rng.normal(0, d ** -0.5, (d, E)).astype(np.float32)
    if tie:
        w[:, 1::2] = w[:, 0::2]      # experts 2i and 2i+1 tie everywhere
    want = jax.jit(J_MOE.route, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(w), jc, cf)
    got = MOE.route(torch.from_numpy(x), torch.from_numpy(w), tc, cf)
    return got, want


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("G,N,E,K", GRIDS)
def test_route_matches_bit_for_bit(G, N, E, K, cf):
    """slot_token and slot_of equal, dtypes and shapes included; the
    renormalised weights and the aux loss within 1e-6."""
    (ts, to, tw, ta), (js, jo, jw, ja) = _route_both(G, N, E, K, cf,
                                                     seed=G * 100 + N)
    for got, want in ((ts, js), (to, jo)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)


def test_route_grid_drops_and_keeps():
    """The grid exercises both regimes: at capacity factor 0.5 a group
    of 64 tokens over 4 experts drops slots (slot_of holds the sentinel
    E*C), at 1.25 a group of 16 over 4 keeps them all."""
    def dropped(G, N, E, K, cf):
        (_, slot_of, _, _), (_, j_slot_of, _, _) = _route_both(
            G, N, E, K, cf, seed=G * 100 + N)
        C = MOE._capacity(N, _cfgs(E, K)[1], cf)
        assert C == J_MOE._capacity(N, _cfgs(E, K)[0], cf)
        return int((slot_of == E * C).sum()), int(
            (np.asarray(j_slot_of) == E * C).sum())

    got, want = dropped(2, 64, 4, 2, 0.5)
    assert got == want > 0
    assert dropped(1, 16, 4, 1, 1.25) == (0, 0)


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_route_breaks_ties_toward_the_lower_expert(cf):
    """Experts 2i and 2i+1 share a router column, so every token's
    probabilities tie in pairs: both packages pick the lower index
    first, as ``lax.top_k`` does."""
    (ts, to, tw, _), (js, jo, jw, _) = _route_both(2, 32, 8, 3, cf, seed=5,
                                                   tie=True)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)


def test_capacity_rounds_as_the_reference():
    for N in (1, 7, 16, 100, 512):
        for E, K in ((4, 1), (8, 2), (64, 6), (16, 2)):
            for cf in (0.5, 1.0, 1.25, 2.0):
                jc, tc = _cfgs(E, K)
                assert MOE._capacity(N, tc, cf) == \
                    J_MOE._capacity(N, jc, cf)


def _apply_both(B, S, E, K, shared, groups, cf, dtype, seed):
    jc, tc = _cfgs(E, K, F=48, shared=shared)
    d = 32
    jp = j_materialize(J_MOE.moe_meta(d, jc, dtype),
                       jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(seed).normal(0, 1, (B, S, d))
    jx = jnp.asarray(x, jnp.float32).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jy, jaux = jax.jit(J_MOE.moe_apply, static_argnums=(2,),
                       static_argnames=("capacity_factor", "groups"))(
        jp, jx, jc, capacity_factor=cf, groups=groups)
    ty, taux = MOE.moe_apply(tp, tx, tc, capacity_factor=cf, groups=groups)
    return (ty, taux), (jy, jaux)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("groups", [None, 1])
@pytest.mark.parametrize("B,S,E,K,cf", [(2, 16, 8, 2, 1.25),
                                        (2, 40, 4, 2, 0.5),
                                        (3, 8, 16, 6, 1.25)])
def test_moe_apply_matches(B, S, E, K, cf, groups, shared, dtype):
    """The layer's output in the activations' dtype and its aux loss
    against the reference's."""
    (ty, taux), (jy, jaux) = _apply_both(B, S, E, K, shared, groups, cf,
                                         dtype, seed=B * 10 + S)
    assert ty.dtype == getattr(torch, dtype)
    assert tuple(ty.shape) == tuple(jy.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6,
                               atol=1e-6)


def test_moe_apply_gradients_match():
    """float32: the gradients of a seeded <w, y> + aux for x and every
    weight (router included) against ``jax.grad``."""
    jc, tc = _cfgs(8, 2, F=48, shared=1)
    d, B, S = 32, 2, 24
    jp = j_materialize(J_MOE.moe_meta(d, jc, "float32"),
                       jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    w = rng.normal(0, 1, (B, S, d)).astype(np.float32)

    def jloss(p, x):
        y, aux = J_MOE.moe_apply(p, x, jc, capacity_factor=0.5)
        return jnp.sum(y * w) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    names = [tuple(k.key for k in path) for path, _ in flat]
    leaves = [torch.from_numpy(np.array(a)).requires_grad_()
              for _, a in flat]
    tp = {}
    for name, t in zip(names, leaves):
        node = tp
        for k in name[:-1]:
            node = node.setdefault(k, {})
        node[name[-1]] = t
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = MOE.moe_apply(tp, tx, tc, capacity_factor=0.5)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux,
                                leaves + [tx])
    want = [g for _, g in jax.tree_util.tree_flatten_with_path(jgp)[0]]
    for got, ref in zip(grads, want + [jgx]):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-4, atol=2e-4)
