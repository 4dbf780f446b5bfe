"""The SSD scan's backward kernel (``kernels/ssd_scan.ssd_scan_bwd``,
``csrc/ssd_scan_bwd.cu``) on the card: each gradient against the plain
backward (autograd through the plain scan, on the card), two calls equal
bit for bit, and one call a Mamba layer through a training step.  Every
test needs an NVIDIA card and skips without one.  The file imports nothing
of JAX, so the card's machine runs it:

    python -m pytest -q -m cuda tests/test_torch_ssd_card.py
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as SS

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")
#: (B, S, H, P, N, chunk, init_state and dfinal): mamba2-780m's training
#: shape (the benchmark's train_U), jamba-v0.1-52b's Mamba heads (128 of
#: 64, d_state 16: the kernel's N <= 64 instantiation), and a 200-row
#: chunk (three full 64-row tiles and a short one) from a carried state
CASES = {"mamba2_780m_train": (4, 2048, 48, 64, 128, 256, False),
         "jamba_heads": (1, 2048, 128, 64, 16, 256, False),
         "short_tile_state": (1, 400, 48, 64, 128, 200, True)}
#: each gradient's tolerance, as a share of the plain gradient's largest
#: |element|.  bf16 dx, dB, dC: both sides round an f32 sum to bf16 once,
#: so they may lie 2^-8 of an element apart, and the kernel's f32 operands
#: split into bf16 hi + lo add ~2^-16 a term.  f32 ddt, dA, dinit: those
#: split products and another order of summation (the card read 2.6e-5 at
#: most at these shapes).
TOL = {"dx": 2 ** -7, "ddt": 1e-3, "dA": 1e-3, "dB": 2 ** -7, "dC": 2 ** -7,
       "dinit": 1e-3}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA ssd_scan_bwd kernel)")
    return torch.device("cuda")


def _args(dev, B, S, H, P, N, state, seed=0):
    """Seeded bf16 arguments: xh, dt, A, B_, C_, init_state, dy, dfinal
    (the state and its gradient None unless ``state``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    return ((rn(B, S, H, P) * 0.5).bfloat16(), F.softplus(rn(B, S, H)),
            -torch.exp(rn(H) * 0.3), (rn(B, S, N) * 0.5).bfloat16(),
            (rn(B, S, N) * 0.5).bfloat16(),
            rn(B, H, N, P) if state else None, rn(B, S, H, P).bfloat16(),
            rn(B, H, N, P) if state else None)


def _saved(args, chunk):
    """The forward's scratch, as ``SSDScanFn`` keeps it."""
    with torch.no_grad():
        return SS.ssd_scan(*args[:5], chunk=chunk, init_state=args[5],
                           want_state=False, keep_scratch=True)[2]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_kernel_matches_the_plain_backward(card, case):
    B, S, H, P, N, chunk, state = CASES[case]
    args = _args(card, B, S, H, P, N, state)
    SS.bwd_launches.reset()
    got = SS.ssd_scan_bwd(*args, chunk=chunk, saved=_saved(args, chunk))
    assert SS.bwd_launches.value == 1
    want = SS.ssd_scan_bwd_plain(*args, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert (g is None) == (w is None), name
        if w is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= TOL[name] * float(w.float().abs().max()), (name, err)


@pytest.mark.cuda
def test_bwd_kernel_gives_the_same_bits_twice(card):
    """Every sum across blocks is a partial added in a fixed order, so
    two calls give the same gradients bit for bit; without the forward's
    scratch the call raises."""
    args = _args(card, 2, 512, 48, 64, 128, True, seed=1)
    saved = _saved(args, 256)
    first = SS.ssd_scan_bwd(*args, chunk=256, saved=saved)
    second = SS.ssd_scan_bwd(*args, chunk=256, saved=saved)
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="scratch"):
        SS.ssd_scan_bwd(*args, chunk=256)


@pytest.mark.cuda
def test_bwd_launches_once_a_layer_in_a_training_step(card):
    """A ``Trainer`` step of the bf16 smoke Mamba model: one backward
    launch a Mamba layer, and no call on the f32 branch."""
    from repro_torch.configs import MVStoreConfig, ShapeConfig, smoke_config
    from repro_torch.launch.train import Trainer

    tc = dataclasses.replace(smoke_config("mamba2-780m"), dtype="bfloat16")
    tr = Trainer(tc, ShapeConfig("s", 64, 2, "train"),
                 mvcfg=MVStoreConfig(mode="U", fused_commit=True),
                 device="cuda")
    SS.bwd_launches.reset()
    SS.bwd_f32_plain.reset()
    _, metrics = tr.train_step(tr.state, tr.batch_at(0))
    tr.controller.stop()
    assert bool(torch.isfinite(metrics["loss"]))
    assert SS.bwd_launches.value == tc.n_layers
    assert SS.bwd_f32_plain.value == 0
