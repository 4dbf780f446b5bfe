"""The port's four kernels, through their CPU (plain PyTorch) route,
against the JAX package's Pallas kernels and numpy twins.

Pallas runs as ``tests/test_kernels.py`` runs it: ``interpret=True``,
int32-range inputs, ragged and tile-multiple N (ragged batches padded the
way ``kernels/ops.py`` pads them).  The beyond-int32 cases go against the
numpy twins and ``ops`` wrappers.  Everything is integer: every
comparison is exact.  The CUDA kernels themselves run only on a card
(``chip_smoke.py`` holds each against the same plain versions there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import validation as JV
from repro.core.vlt import np_version_select
from repro.kernels import gather_read as J_GR
from repro.kernels import ops
from repro.kernels import scatter_write as J_SW
from repro.kernels import validate as J_VK
from repro.kernels import version_select as J_VS
from repro_torch import kernels as K
from repro_torch.kernels import gather_read as GR
from repro_torch.kernels import scatter_write as SW
from repro_torch.kernels import validate as VK
from repro_torch.kernels import version_select as VS

I32 = (1 << 31) - 1
BIG = (1 << 40) + 123


def _t(a):
    return torch.from_numpy(np.array(a, np.int64))


def _tile(n, cap):
    return min(cap, 1 << (n - 1).bit_length()) if n > 1 else 1


@pytest.mark.parametrize("n", [1, 7, 256, 512, 777])
def test_gather_matches_pallas(n):
    rng = np.random.default_rng(n)
    heap = rng.integers(-I32, I32, 2048).astype(np.int32)
    addrs = rng.integers(0, 2048, n)
    tile = _tile(n, 512)
    padded = np.pad(addrs, (0, (-n) % tile))       # address 0, as ops pads
    want = np.asarray(J_GR.gather_read_flat(
        jnp.asarray(heap), jnp.asarray(padded, jnp.int32), tile=tile,
        interpret=True))[:n]
    got = GR.gather_read(_t(heap), addrs)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,n", [(64, 16), (512, 512), (1000, 128),
                                 (1000, 7)])
def test_scatter_matches_pallas(h, n):
    rng = np.random.default_rng(h + n)
    heap = rng.integers(-I32, I32, h).astype(np.int32)
    addrs = rng.choice(h, size=n, replace=False)
    vals = rng.integers(-I32, I32, n).astype(np.int32)
    tile = _tile(n, 512)
    pad = (-n) % tile
    want = np.asarray(J_SW.scatter_write_flat(
        jnp.asarray(heap), jnp.asarray(np.pad(addrs, (0, pad),
                                              constant_values=h), jnp.int32),
        jnp.asarray(np.pad(vals, (0, pad))), tile=tile, interpret=True))
    row = _t(heap)
    SW.scatter_write(row, addrs, vals)               # in place
    np.testing.assert_array_equal(row.numpy(), want)


def _lock_fields(rng, n):
    ver = rng.integers(0, 30, n)
    own = rng.integers(-2, 4, n).astype(np.int32)
    meta = rng.integers(0, 4, n).astype(np.int32)
    seen = np.where(rng.random(n) < 0.5, ver, rng.integers(0, 30, n))
    return ver, own, meta, seen


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("n,r_clock,tid", [(1, 0, 0), (7, 15, 1),
                                           (512, 29, -1), (1000, 15, 1)])
def test_validate_mask_matches_pallas(mode, n, r_clock, tid):
    """Per-entry mask parity with the Pallas kernel (inputs rebased and
    padded exactly as ``ops.validate_readset`` prepares them), and the
    AND against ``np_validate``."""
    rng = np.random.default_rng(31 * mode + n)
    ver, own, meta, seen = _lock_fields(rng, n)
    tile = _tile(n, 512)
    pad = (-n) % tile
    p = J_VK.PAD

    def prep(x, fill, rebase=False):
        x = np.asarray(x, np.int64) - (r_clock if rebase else 0)
        return jnp.pad(jnp.asarray(x, jnp.int32), (0, pad),
                       constant_values=fill)
    want = np.asarray(J_VK.validate_readset_flat(
        prep(ver, p["ver"], True), prep(own, p["own"]),
        prep(meta, p["meta"]), prep(seen, p["seen"], True), 0, tid,
        mode, tile=tile, interpret=True))[:n]
    mask, all_ok = VK.validate_mask(_t(ver), torch.from_numpy(own),
                                    torch.from_numpy(meta), seen,
                                    r_clock, tid, mode)
    assert mask.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), want)
    assert bool(all_ok) == JV.np_validate(ver, own, meta, seen, r_clock,
                                          tid, mode)


def test_validate_beyond_int32_clock():
    """Versions past int32 (the packed word gives them 46 bits): the
    port compares int64 as stored and must agree with the int64 numpy
    twin and with ``ops``'s rebased route (tests/test_kernels.py:224)."""
    big = (1 << 31) + 12345
    ver = np.asarray([big, big + 1, big - 1, big - 3], np.int64)
    own = np.full(4, -1, np.int32)
    meta = np.zeros(4, np.int32)
    seen = ver.copy()
    for mode, r_clock in [(0, big), (0, big + 2), (1, big), (2, big + 2),
                          (0, 1 << 45), (1, (1 << 45) - 7)]:
        want = JV.np_validate(ver, own, meta, seen, r_clock, 0, mode)
        got = VK.validate_readset(_t(ver), torch.from_numpy(own),
                                  torch.from_numpy(meta), seen, r_clock, 0,
                                  mode)
        assert got == want == ops.validate_readset(ver, own, meta, seen,
                                                   r_clock, 0, mode)
    assert not VK.validate_readset(_t([big]), torch.from_numpy(own[:1]),
                                   torch.from_numpy(meta[:1]), [big], big,
                                   0, 0)


@pytest.mark.parametrize("n", [1, 7, 130, 512])
def test_version_select_matches_pallas(n):
    rng = np.random.default_rng(3 + n)
    empty = 1 << 62
    ts = rng.integers(0, 1000, size=(n, 4)).astype(np.int64)
    ts[rng.random((n, 4)) < 0.3] = empty
    data = rng.integers(-5000, 5000, size=(n, 4)).astype(np.int64)
    tile = _tile(n, 256)
    pad = (-n) % tile
    for clock in (1, 500, 999):
        rel = np.clip(ts - clock, -I32, I32)
        got_v, got_ok = J_VS.version_select_flat(
            jnp.pad(jnp.asarray(rel, jnp.int32), ((0, pad), (0, 0)),
                    constant_values=J_VS.PAD_TS),
            jnp.pad(jnp.asarray(data, jnp.int32), ((0, pad), (0, 0))),
            0, tile=tile, interpret=True)
        want_ok = np.asarray(got_ok)[:n] != 0
        want_v = np.asarray(got_v)[:n]
        vals, ok = VS.version_select(_t(ts), _t(data), clock)
        assert ok.dtype == torch.int32 and vals.dtype == torch.int64
        np.testing.assert_array_equal(ok.numpy() != 0, want_ok)
        np.testing.assert_array_equal(vals.numpy()[want_ok],
                                      want_v[want_ok])
        # and every lane (no-match rows included) equals the numpy twin
        tw_v, tw_ok = np_version_select(ts, data, clock)
        np.testing.assert_array_equal(vals.numpy(), tw_v)
        np.testing.assert_array_equal(ok.numpy() != 0, tw_ok)


def test_version_select_beyond_int32():
    """int64 payloads and clocks come back exact (the reference routes
    such batches to numpy; the port is int64 throughout)."""
    ts = np.array([[5, 3], [9, 1], [1 << 62, 1 << 62]], np.int64)
    data = np.array([[BIG, 7], [-BIG, 8], [BIG, BIG]], np.int64)
    vals, ok = VS.version_select(_t(ts), _t(data), 6)
    r_vals, r_ok = ops.version_select(ts, data, 6)
    assert ok.tolist() == [1, 1, 0] and r_ok.tolist() == [True, True, False]
    assert vals.tolist()[:2] == r_vals.tolist()[:2] == [BIG, 8]
    clock = (1 << 44) + 10
    ts2 = ts + (1 << 44)
    v2, ok2 = VS.version_select(_t(ts2), _t(data), clock)
    w2, wok2 = np_version_select(ts2, data, clock)
    np.testing.assert_array_equal(v2.numpy(), w2)
    np.testing.assert_array_equal(ok2.numpy() != 0, wok2)


def test_scatter_beyond_int32_matches_twins():
    heap = np.arange(16, dtype=np.int64)
    heap[0] = BIG
    addrs, vals = np.array([3, 5]), np.array([BIG, -BIG], np.int64)
    row = _t(heap)
    SW.scatter_write(row, addrs, vals)
    want = J_SW.np_write_back(heap, addrs, vals)
    np.testing.assert_array_equal(row.numpy(), want)
    np.testing.assert_array_equal(row.numpy(),
                                  ops.write_back(heap, addrs, vals))
    # gathers read the int64 words back exact
    assert GR.gather_read(row, [0, 3, 5]).tolist() == [BIG, BIG, -BIG]


@pytest.mark.parametrize("bad", [[-1], [0, -3], [16], [2, 17]])
def test_out_of_range_addresses_raise_at_both_ends(bad):
    """Negative addresses would wrap and past-the-end ones would read or
    write outside the row: both raise, and a scatter writes nothing."""
    row = torch.arange(16, dtype=torch.int64)
    with pytest.raises(IndexError):
        GR.gather_read(row, bad)
    with pytest.raises(IndexError):
        SW.scatter_write(row, bad, [9] * len(bad))
    assert row.tolist() == list(range(16))
    # the reference raises on the same batches
    with pytest.raises(IndexError):
        J_SW.np_write_back(np.arange(16), np.array(bad), np.ones(len(bad)))


def test_plain_route_counts_no_launch_and_refuses_other_devices():
    K.reset_launch_counts()
    row = torch.arange(8, dtype=torch.int64)
    GR.gather_read(row, [1, 2])
    SW.scatter_write(row, [1], [5])
    VK.validate_readset(row[:2], torch.zeros(2, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int32), [0, 1], 9, 0, 0)
    VS.version_select(row.reshape(2, 4), row.reshape(2, 4), 3)
    assert K.launch_counts() == {name: 0 for name in K.COUNTERS}
    meta_row = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError):
        GR.gather_read(meta_row, [1])
    with pytest.raises(TypeError):
        GR.gather_read(row, torch.zeros(1, dtype=torch.int64,
                                        device="meta"))
