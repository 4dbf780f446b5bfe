"""The port's ``ssd_scan`` (its plain version, which the wrapper takes for
CPU tensors) against the JAX package's SSD scans, on the CPU.

Inputs are made with numpy from a seed and go through both packages:
``y`` against the reference's ``ops.ssd_scan`` (the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it) over the
reference's sweep, 2e-3 at float32 and 5e-2 at bfloat16 (its own
tolerances); the final state and a scan from a non-zero ``init_state``
against ``repro.models.mamba.ssd_chunk_scan`` (the XLA route the model
runs) and ``ref.ssd_scan_ref`` (the step-by-step recurrence), 2e-3.
The gradients through ``models.mamba.SSDScanFn`` (the scan's
``torch.autograd.Function``: the wrapper forward, the plain scan's
gradient recomputed backward) against ``jax.grad`` of the XLA route, at
decays under which the reference's whole-square ``exp`` stays finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as J_OPS
from repro.kernels import ref as J_REF
from repro.models import mamba as J_MAMBA
from repro_torch.kernels import ssd_scan as SS
from repro_torch.models import mamba as T_MAMBA

SWEEP = [(1, 64, 2, 8, 4, 16), (2, 128, 4, 16, 8, 32),
         (1, 256, 2, 32, 16, 64)]
TOL = {"float32": 2e-3, "bfloat16": 5e-2}


def _inputs(B, S, H, P, N, seed=0, dt_scale=1.0):
    """Seeded float32 numpy inputs: xh, dt (post-softplus), A (negative),
    B_, C_ — the reference sweep's distributions."""
    rng = np.random.default_rng(seed)
    xh = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))) * dt_scale
    A = -np.exp(rng.standard_normal(H) * 0.3)
    b = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    return xh, dt.astype(np.float32), A.astype(np.float32), b, c


def _jax(arrs, dtype):
    xh, dt, A, b, c = arrs
    cast = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731
    return cast(xh), jnp.asarray(dt), jnp.asarray(A), cast(b), cast(c)


def _torch(arrs, dtype):
    """The same values as ``_jax`` (bf16 rounded by JAX, carried bit for
    bit through float32)."""
    j = _jax(arrs, dtype)
    td = getattr(torch, dtype)
    return tuple(torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        td if i in (0, 3, 4) else torch.float32) for i, a in enumerate(j))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_pallas(B, S, H, P, N, chunk, dtype):
    arrs = _inputs(B, S, H, P, N, seed=S + H)
    want, _ = J_OPS.ssd_scan(*_jax(arrs, dtype), chunk=chunk)
    got, state = SS.ssd_scan(*_torch(arrs, dtype), chunk=chunk,
                             want_state=False)
    assert got.dtype == getattr(torch, dtype) and state is None
    _close(got, want, TOL[dtype])
    oracle, _ = J_REF.ssd_scan_ref(*_jax(arrs, dtype))
    _close(got, oracle, TOL[dtype])


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_final_state_matches_reference(B, S, H, P, N, chunk):
    arrs = _inputs(B, S, H, P, N, seed=1)
    got_y, got_s = SS.ssd_scan_plain(*_torch(arrs, "float32"), chunk=chunk)
    assert got_s.shape == (B, H, N, P) and got_s.dtype == torch.float32
    want_y, want_s = J_MAMBA.ssd_chunk_scan(*_jax(arrs, "float32"),
                                            chunk=chunk)
    _close(got_y, want_y, 2e-3)
    _close(got_s, want_s, 2e-3)
    _, oracle_s = J_REF.ssd_scan_ref(*_jax(arrs, "float32"))
    _close(got_s, oracle_s, 2e-3)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_init_state_matches_reference(B, S, H, P, N, chunk):
    """A scan that starts from a seeded state: y and the final state
    against the reference's chunked scan, and against the two halves of
    one longer scan (the second starting from the first's state)."""
    arrs = _inputs(B, S, H, P, N, seed=2)
    init = np.random.default_rng(3).standard_normal(
        (B, H, N, P)).astype(np.float32)
    t_in = _torch(arrs, "float32")
    got_y, got_s = SS.ssd_scan(*t_in, chunk=chunk,
                               init_state=torch.from_numpy(init))
    want_y, want_s = J_MAMBA.ssd_chunk_scan(*_jax(arrs, "float32"),
                                            chunk=chunk,
                                            init_state=jnp.asarray(init))
    _close(got_y, want_y, 2e-3)
    _close(got_s, want_s, 2e-3)
    half = S // 2
    first = [t[:, :half] if t.dim() > 1 else t for t in t_in]
    second = [t[:, half:] if t.dim() > 1 else t for t in t_in]
    y0, s0 = SS.ssd_scan_plain(*first, chunk=chunk)
    y1, s1 = SS.ssd_scan_plain(*second, chunk=chunk, init_state=s0)
    full_y, full_s = SS.ssd_scan_plain(*t_in, chunk=chunk)
    _close(torch.cat([y0, y1], dim=1), full_y, 2e-3)
    _close(s1, full_s, 2e-3)


def test_chunk_that_does_not_divide_raises_in_both_packages():
    arrs = _inputs(1, 48, 2, 8, 4)
    with pytest.raises(AssertionError):
        J_OPS.ssd_scan(*_jax(arrs, "float32"), chunk=32)
    with pytest.raises(AssertionError):
        J_MAMBA.ssd_chunk_scan(*_jax(arrs, "float32"), chunk=32)
    with pytest.raises(ValueError, match="does not divide"):
        SS.ssd_scan(*_torch(arrs, "float32"), chunk=32)
    with pytest.raises(ValueError, match="does not divide"):
        T_MAMBA.ssd_chunk_scan(*_torch(arrs, "float32"), chunk=32)
    # S below the chunk: one chunk of S rows, in both
    got, _ = SS.ssd_scan(*_torch(arrs, "float32"), chunk=256)
    want, _ = J_MAMBA.ssd_chunk_scan(*_jax(arrs, "float32"), chunk=256)
    _close(got, want, 2e-3)


def test_steep_decay_stays_finite_forward_and_backward():
    """dt * A of -40 a row: the reference's whole-square exp(cum_i -
    cum_j) overflows above the diagonal.  The plain version masks the
    exponent first, so its output equals the recurrence's and its
    gradient has no NaN."""
    arrs = _inputs(1, 64, 2, 8, 4, seed=4, dt_scale=40.0)
    xh, dt, A, b, c = (t.clone().requires_grad_()
                       for t in _torch(arrs, "float32"))
    y, state = SS.ssd_scan_plain(xh, dt, A, b, c, chunk=64)
    oracle_y, oracle_s = J_REF.ssd_scan_ref(*_jax(arrs, "float32"))
    _close(y, oracle_y, 2e-3)
    _close(state, oracle_s, 2e-3)
    grads = torch.autograd.grad((y.sum() + state.sum()), [xh, dt, A, b, c])
    assert all(bool(torch.isfinite(g).all()) for g in grads)


#: gradient cases: (B, S, H, P, N, chunk); the last is the short tile
#: (Q = 200, three full 64-row tiles and a short one)
GRAD_SHAPES = SWEEP + [(1, 400, 2, 8, 4, 200)]


def _grad_inputs(shape, init, seed=3):
    """Seeded float32 inputs at a mild decay (dt scaled by 0.3: cum_i -
    cum_j stays well below exp's overflow over a whole chunk), an
    init_state when ``init``, and seeded cotangents for y and the final
    state."""
    B, S, H, P, N, _ = shape
    arrs = list(_inputs(B, S, H, P, N, seed=seed, dt_scale=0.3))
    rng = np.random.default_rng(seed + 100)
    arrs.append(rng.standard_normal((B, H, N, P)).astype(np.float32)
                if init else None)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ds = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return arrs, dy, ds


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", GRAD_SHAPES)
def test_ssd_fn_grads_match_jax_grad(B, S, H, P, N, chunk, init):
    """<dy, y> + <ds, final state> differentiated with respect to every
    input: the port through ``ssd_chunk_scan`` -> ``SSDScanFn``, the
    reference by ``jax.grad`` of its XLA ``ssd_chunk_scan``; 2e-3."""
    shape = (B, S, H, P, N, chunk)
    arrs, dy, ds = _grad_inputs(shape, init)
    n = 6 if init else 5

    def jloss(*xs):
        y, st = J_MAMBA.ssd_chunk_scan(*xs[:5], chunk=chunk,
                                       init_state=xs[5] if init else None)
        return jnp.sum(y * dy) + jnp.sum(st * ds)

    want = jax.grad(jloss, argnums=tuple(range(n)))(
        *[jnp.asarray(a) for a in arrs[:n]])
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs[:n]]
    y, st = T_MAMBA.ssd_chunk_scan(*ts[:5], chunk=chunk,
                                   init_state=ts[5] if init else None)
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward"
    loss = (y * torch.from_numpy(dy)).sum() + (st * torch.from_numpy(ds)
                                               ).sum()
    got = torch.autograd.grad(loss, ts)
    for g, w, t in zip(got, want, ts):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, 2e-3)


@pytest.mark.parametrize("want_state", [False, True])
def test_ssd_fn_bf16_grads_keep_dtypes_and_equal_plain_autograd(want_state):
    """bf16 xh, B_, C_ (dt, A f32): each gradient in its input's dtype,
    and equal to autograd straight through ``ssd_scan_plain`` (the
    Function's backward is that graph, recomputed)."""
    arrs, dy, _ = _grad_inputs((2, 128, 4, 16, 8, 32), False)
    base = _torch(arrs[:5], "bfloat16")
    runs = []
    for route in ("fn", "plain"):
        ts = [t.clone().requires_grad_() for t in base]
        if route == "fn":
            y, st = T_MAMBA.ssd_chunk_scan(*ts, chunk=32,
                                           want_state=want_state)
        else:
            y, st = SS.ssd_scan_plain(*ts, chunk=32)
        assert (st is not None) == (route == "plain" or want_state)
        loss = (y.float() * torch.from_numpy(dy)).sum()
        if want_state:
            loss = loss + st.square().sum()
        runs.append(torch.autograd.grad(loss, ts))
    for g, t, p in zip(runs[0], base, runs[1]):
        assert g.dtype == t.dtype
        torch.testing.assert_close(g, p, rtol=0, atol=0)


def test_ssd_fn_steep_decay_gradient_stays_finite():
    """The steep decay of ``test_steep_decay_stays_finite_forward_and_
    backward`` through the Function: every gradient finite (the
    recompute masks the exponent before ``exp``)."""
    arrs = _inputs(1, 64, 2, 8, 4, seed=4, dt_scale=40.0)
    ts = [t.clone().requires_grad_() for t in _torch(arrs, "float32")]
    y, state = T_MAMBA.ssd_chunk_scan(*ts, chunk=64)
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward"
    grads = torch.autograd.grad(y.sum() + state.sum(), ts)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_plain_route_counts_no_launch_and_checks_its_arguments():
    arrs = _torch(_inputs(1, 32, 2, 8, 4), "float32")
    SS.launches.reset()
    y, state = SS.ssd_scan(*arrs, chunk=16)
    assert SS.launches.value == 0
    assert y.shape == (1, 32, 2, 8) and state.shape == (1, 2, 4, 8)
    xh, dt, A, b, c = arrs
    with pytest.raises(ValueError, match="dt has shape"):
        SS.ssd_scan(xh, dt[:, :16], A, b, c, chunk=16)
    with pytest.raises(ValueError, match="init_state has shape"):
        SS.ssd_scan(xh, dt, A, b, c, chunk=16,
                    init_state=torch.zeros(1, 2, 8, 4))
    with pytest.raises(ValueError, match="xh"):
        SS.ssd_scan(xh[0], dt, A, b, c, chunk=16)


@pytest.mark.cuda
def test_bare_cuda_wrapper_refuses_grad():
    """On the card the scan kernel has no backward: the bare wrapper
    raises for an input that requires grad while grad mode is on, and
    runs under ``no_grad``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA ssd_scan kernel)")
    xh, dt, A, b, c = (t.cuda() for t in _torch(_inputs(1, 64, 2, 8, 4),
                                                "float32"))
    xg = xh.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        SS.ssd_scan(xg, dt, A, b, c, chunk=32)
    with torch.no_grad():
        y, _ = SS.ssd_scan(xg, dt, A, b, c, chunk=32)
    want, _ = SS.ssd_scan_plain(xh, dt, A, b, c, chunk=32)
    torch.testing.assert_close(y, want, rtol=2e-3, atol=2e-3)


# The plain stages of the CUDA scan's decomposition (``kernels/ssd_scan``:
# cb, state, fold, out), each against the reference.  The sweep plus a
# ragged chunk (Q = 200, three full 64-row tiles and a short one) at the
# smallest d_state of the sweep (N = 4).
STAGE_SHAPES = SWEEP + [(1, 400, 2, 8, 4, 200)]


def _chunk_np(a, Q):
    """[B, S, ...] -> [B, nc, Q, ...] (numpy)."""
    return a.reshape(a.shape[0], a.shape[1] // Q, Q, *a.shape[2:])


@pytest.mark.parametrize("B,S,H,P,N,chunk", STAGE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_cb_and_cum_match_reference_chunk_einsums(B, S, H, P, N, chunk,
                                                        dtype):
    """Stage 1's C.B^T and stage 2's cum against the reference chunk
    body's einsum and cumsum (``repro/models/mamba.py``), chunk by
    chunk, on the same bf16-rounded inputs."""
    arrs = _inputs(B, S, H, P, N, seed=5)
    jx, jdt, jA, jb, jc = _jax(arrs, dtype)
    _, tdt, tA, tb, tc = _torch(arrs, dtype)
    Q = min(chunk, S)
    cb = SS.chunk_cb_plain(tb, tc, Q)
    cum = SS.chunk_cum_plain(tdt, tA, Q)
    assert cb.shape == (B, S // Q, Q, Q) and cum.shape == (B, S // Q, H, Q)
    for c in range(S // Q):
        rows = slice(c * Q, (c + 1) * Q)
        want_cb = jnp.einsum("bin,bjn->bij", jc[:, rows].astype(jnp.float32),
                             jb[:, rows].astype(jnp.float32))
        want_cum = jnp.cumsum(jdt[:, rows] * jA[None, None, :], axis=1)
        _close(cb[:, c], want_cb, 2e-3)
        _close(cum[:, c].transpose(1, 2), want_cum, 2e-3)


@pytest.mark.parametrize("B,S,H,P,N,chunk", STAGE_SHAPES)
def test_stage_states_match_reference(B, S, H, P, N, chunk):
    """Stage 2's chunk-local states against the reference's chunked scan
    of the chunk alone, and stage 3's state entering each chunk and
    final state against the reference's scan of the prefix before it
    (``ssd_chunk_scan``), from a seeded ``init_state``; from zeros, the
    final state against the recurrence (``ssd_scan_ref``)."""
    arrs = _inputs(B, S, H, P, N, seed=6)
    init = np.random.default_rng(7).standard_normal(
        (B, H, N, P)).astype(np.float32)
    j_in = _jax(arrs, "float32")
    t_in = _torch(arrs, "float32")
    xh, dt, A, b, c = t_in
    Q = min(chunk, S)
    cum = SS.chunk_cum_plain(dt, A, Q)
    local = SS.chunk_state_plain(xh, dt, b, cum, Q)
    state_in, final = SS.fold_plain(local, cum, torch.from_numpy(init))
    assert local.shape == state_in.shape == (B, S // Q, H, N, P)
    for k in range(S // Q):
        rows = slice(k * Q, (k + 1) * Q)
        one = [a[:, rows] if a.ndim > 1 else a for a in j_in]
        _, want_local = J_MAMBA.ssd_chunk_scan(*one, chunk=Q)
        _close(local[:, k], want_local, 2e-3)
        if k == 0:
            _close(state_in[:, 0], init, 2e-3)
        else:
            prefix = [a[:, :k * Q] if a.ndim > 1 else a for a in j_in]
            _, want_in = J_MAMBA.ssd_chunk_scan(
                *prefix, chunk=Q, init_state=jnp.asarray(init))
            _close(state_in[:, k], want_in, 2e-3)
    _, want_final = J_MAMBA.ssd_chunk_scan(*j_in, chunk=Q,
                                           init_state=jnp.asarray(init))
    _close(final, want_final, 2e-3)
    _, zero_final = SS.fold_plain(local, cum)
    _, oracle = J_REF.ssd_scan_ref(*j_in)
    _close(zero_final, oracle, 2e-3)


@pytest.mark.parametrize("B,S,H,P,N,chunk", STAGE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_output_composition_matches_pallas(B, S, H, P, N, chunk,
                                                 dtype):
    """Stage 4's y over the plain stages before it, and
    ``ssd_scan_plain`` (their composition), against the Pallas kernel in
    interpret mode (``ops.ssd_scan``)."""
    arrs = _inputs(B, S, H, P, N, seed=8)
    xh, dt, A, b, c = _torch(arrs, dtype)
    Q = min(chunk, S)
    cum = SS.chunk_cum_plain(dt, A, Q)
    state_in, _ = SS.fold_plain(SS.chunk_state_plain(xh, dt, b, cum, Q),
                                cum)
    y = SS.output_plain(xh, dt, c, SS.chunk_cb_plain(b, c, Q), cum,
                        state_in, Q)
    assert y.dtype == getattr(torch, dtype) and y.shape == xh.shape
    want, _ = J_OPS.ssd_scan(*_jax(arrs, dtype), chunk=chunk)
    _close(y, want, TOL[dtype])
    composed, _ = SS.ssd_scan_plain(xh, dt, A, b, c, chunk=chunk)
    assert torch.equal(composed, y)


def test_scratch_views_are_one_aligned_allocation():
    """The kernel's scratch is one f32 allocation cut into C.B^T (rows
    padded to 64), cum and the chunk states, each view 16-byte aligned."""
    xh = torch.zeros(2, 400, 3, 8)
    cb, cum, states = SS.scratch(xh, 5, 200)
    assert cb.shape == (2, 2, 256, 256) and cum.shape == (2, 2, 3, 200)
    assert states.shape == (2, 2, 3, 5, 8)
    base = cb.untyped_storage().data_ptr()
    assert cum.untyped_storage().data_ptr() == base \
        == states.untyped_storage().data_ptr()
    assert all(t.data_ptr() % 16 == 0 and t.is_contiguous()
               for t in (cb, cum, states))
