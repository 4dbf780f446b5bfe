"""The port's kernels, through their CPU (plain PyTorch) route,
against the JAX package's Pallas kernels and numpy twins.

Pallas runs as ``tests/test_kernels.py`` runs it: ``interpret=True``,
int32-range inputs, ragged and tile-multiple N (ragged batches padded the
way ``kernels/ops.py`` pads them).  The beyond-int32 cases go against the
numpy twins and ``ops`` wrappers.  Every integer comparison is exact;
``flash_attention`` is held within ``tests/test_kernels.py``'s tolerances
(2e-4 at float32, 2e-2 at bfloat16).  The CUDA kernels themselves run only on a card
(``chip_smoke.py`` holds each against the same plain versions there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import validation as JV
from repro.core.vlt import np_version_select
from repro.core.engine import arrayheap as JA
from repro.kernels import commit_fused as J_CF
from repro.kernels import gather_read as J_GR
from repro.kernels import ops
from repro.kernels import ref as J_REF
from repro.kernels import scatter_write as J_SW
from repro.kernels import snapshot_select as J_SS
from repro.kernels import validate as J_VK
from repro.kernels import version_select as J_VS
from repro_torch import kernels as K
from repro_torch.core.engine import arrayheap as TA
from repro_torch.core.engine import validation as TV
from repro_torch.kernels import _lib
from repro_torch.kernels import commit_fused as CF
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import gather_read as GR
from repro_torch.kernels import scatter_write as SW
from repro_torch.kernels import snapshot_select as SS
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


@pytest.mark.parametrize("n", [1, 7, 512])
def test_gather_home_matches_pallas(n):
    """``gather_read_home``: the gather with its words brought home, a
    host int64 array equal to the Pallas kernel's gather."""
    rng = np.random.default_rng(200 + n)
    heap = rng.integers(-I32, I32, 2048).astype(np.int32)
    addrs = rng.integers(0, 2048, n)
    tile = _tile(n, 512)
    padded = np.pad(addrs, (0, (-n) % tile))
    want = np.asarray(J_GR.gather_read_flat(
        jnp.asarray(heap), jnp.asarray(padded, jnp.int32), tile=tile,
        interpret=True))[:n]
    got = GR.gather_read_home(_t(heap), list(addrs))
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_read_word_reads_one_element(dtype):
    """``_lib.read_word`` is ``int(row[idx])`` of a row or a view of one,
    and refuses an index outside the row at both ends."""
    row = torch.arange(-5, 11, dtype=dtype) * 3
    view = row[4:]
    assert [_lib.read_word(row, i) for i in range(16)] == row.tolist()
    assert [_lib.read_word(view, i) for i in range(12)] == view.tolist()
    for bad in (-1, 16):
        with pytest.raises(IndexError):
            _lib.read_word(row, bad)


@pytest.mark.parametrize("bad", [[-1], [0, -3], [16], [2, 17]])
def test_out_of_range_addresses_raise_at_both_ends(bad):
    """Negative addresses would wrap and past-the-end ones would read or
    write outside the row: both raise, and a scatter writes nothing."""
    row = torch.arange(16, dtype=torch.int64)
    with pytest.raises(IndexError):
        GR.gather_read(row, bad)
    with pytest.raises(IndexError):
        GR.gather_read_home(row, bad)
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
    GR.gather_read(row.to(torch.int32), [1, 2])
    GR.gather_read_home(row, [1, 2])
    SW.scatter_write(row, [1], [5])
    VK.validate_readset(row[:2], torch.zeros(2, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int32), [0, 1], 9, 0, 0)
    VS.version_select(row.reshape(2, 4), row.reshape(2, 4), 3)
    CF.commit_fused(row, [1], [2], [0], [], [], [], [], [], [0], [0], 4, 1)
    SS.snapshot_select(row.reshape(2, 4), torch.tensor([1, 2],
                                                       dtype=torch.int32), 3)
    qkv = torch.ones(1, 4, 2, 8)
    FA.flash_attention(qkv, qkv, qkv, causal=True)
    assert K.launch_counts() == {name: 0 for name in K.COUNTERS}
    meta_row = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError):
        GR.gather_read(meta_row, [1])
    with pytest.raises(TypeError):
        GR.gather_read(row, torch.zeros(1, dtype=torch.int64,
                                        device="meta"))


# ---------------------------------------------------------------------------
# gather_read over int32 rows (the MVStore block)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 512])
def test_gather_int32_row_matches_pallas(n):
    rng = np.random.default_rng(100 + n)
    heap = rng.integers(-I32, I32, 2048).astype(np.int32)
    addrs = rng.integers(0, 2048, n)
    tile = _tile(n, 512)
    padded = np.pad(addrs, (0, (-n) % tile))
    want = np.asarray(J_GR.gather_read_flat(
        jnp.asarray(heap), jnp.asarray(padded, jnp.int32), tile=tile,
        interpret=True))[:n]
    got = GR.gather_read(torch.from_numpy(heap), addrs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(IndexError):
        GR.gather_read(torch.from_numpy(heap), [2048])


# ---------------------------------------------------------------------------
# commit_fused
# ---------------------------------------------------------------------------


def test_commit_fused_constants_pinned_to_engine():
    assert (CF.MODE_LT, CF.MODE_LE, CF.MODE_EQ) == \
        (TV.V_LT, TV.V_LE, TV.V_EQ) == (J_CF.MODE_LT, J_CF.MODE_LE,
                                        J_CF.MODE_EQ)
    assert CF.VER_SHIFT == TA._VER_SHIFT == JA._VER_SHIFT
    assert CF.TID_BIAS == TA._TID_BIAS and CF.TID_MASK == TA._TID_MASK
    assert CF.UNLOCKED_WORD == TA._UNLOCKED_WORD == JA._UNLOCKED_WORD


def _words(ver, own, meta):
    """Packed lock words from (version, owner tid, meta bit0 locked /
    bit1 flag) — ArrayLockTable's layout."""
    own = np.asarray(own, np.int64)
    meta = np.asarray(meta, np.int64)
    return ((np.asarray(ver, np.int64) << CF.VER_SHIFT)
            | (((own + CF.TID_BIAS) & CF.TID_MASK) << 2)
            | ((meta & 1) << 1) | ((meta >> 1) & 1))


def _cf_batch(rng, n_txn, h, vmax=50):
    w_parts = [rng.choice(h, size=rng.integers(0, 9), replace=False)
               .astype(np.int64) for _ in range(n_txn)]
    w_flat, w_seg, _ = CF.pack_segments(w_parts)
    w_val = rng.integers(-1000, 1000, size=w_flat.size).astype(np.int64)
    n_l = int(rng.integers(0, 4 * n_txn))
    n_r = int(rng.integers(0, 4 * n_txn))
    mk = lambda k: (rng.integers(0, vmax, size=k).astype(np.int64),  # noqa
                    rng.integers(-1, 5, size=k).astype(np.int32),
                    rng.integers(0, 4, size=k).astype(np.int32))
    lf, rf = mk(n_l), mk(n_r)
    return dict(w_flat=w_flat, w_val=w_val, w_seg=w_seg,
                l_f=lf, l_seg=rng.integers(0, n_txn, n_l).astype(np.int64),
                r_f=rf, r_seg=rng.integers(0, n_txn, n_r).astype(np.int64),
                r_seen=rng.integers(0, vmax, size=n_r).astype(np.int64),
                tids=np.arange(n_txn, dtype=np.int64),
                rcs=rng.integers(0, vmax, size=n_txn).astype(np.int64))


def _port_commit(heap, b, cv, n_txn, mode, out_of_place=False):
    return CF.commit_fused(
        heap, b["w_flat"], b["w_val"], b["w_seg"], _words(*b["l_f"]),
        b["l_seg"], _words(*b["r_f"]), b["r_seen"], b["r_seg"], b["tids"],
        b["rcs"], cv, n_txn, mode=mode, out_of_place=out_of_place)


@pytest.mark.parametrize("mode", [CF.MODE_LT, CF.MODE_LE, CF.MODE_EQ])
def test_commit_fused_matches_pallas_and_numpy(mode):
    """Random groups with passing and failing members, empty read or
    lock batches, ragged write batches: the port's plain route equals
    the Pallas kernel in interpret mode (heap, verdict, release
    versions) and the reference's numpy version, bit for bit, in place
    and out of place."""
    rng = np.random.default_rng(31 + mode)
    h, n_txn, cv = 64, 4, 77
    for _ in range(4):
        heap = rng.integers(-100, 100, size=h).astype(np.int32)
        b = _cf_batch(rng, n_txn, h)
        (lv, lo, lm), (rv, ro, rm) = b["l_f"], b["r_f"]
        want_heap, want_ok, want_lver = J_CF.np_commit_fused(
            heap, b["w_flat"], b["w_val"], b["w_seg"], lv, lo, lm,
            b["l_seg"], rv, ro, rm, b["r_seen"], b["r_seg"], b["tids"],
            b["rcs"], cv, n_txn, mode)
        tile = 8
        pad = (-b["w_flat"].size) % tile or tile
        i32 = lambda x: np.asarray(x, np.int32)             # noqa: E731

        def side(x, seg, fill):
            # the Pallas kernel needs >= 1 entry per side: a pad entry
            # owned by a dummy always-passing transaction slot
            return (x, seg) if seg.size else (np.array([fill], x.dtype),
                                              np.array([n_txn], np.int64))
        (lv_p, ls_p), (lo_p, _), (lm_p, _) = (
            side(lv, b["l_seg"], 0), side(lo, b["l_seg"], 0),
            side(lm, b["l_seg"], 0))
        (rv_p, rs_p), (ro_p, _), (rm_p, _), (rn_p, _) = (
            side(rv, b["r_seg"], 0), side(ro, b["r_seg"], 0),
            side(rm, b["r_seg"], 0), side(b["r_seen"], b["r_seg"], 0))
        got_heap, got_ok, got_lver = J_CF.commit_fused_flat(
            heap, i32(np.concatenate([b["w_flat"], np.full(pad, h)])),
            i32(np.concatenate([b["w_val"], np.zeros(pad)])),
            i32(np.concatenate([b["w_seg"], np.zeros(pad)])),
            i32(lv_p), lo_p, lm_p, i32(ls_p), i32(rv_p), ro_p, rm_p,
            i32(rn_p), i32(rs_p), i32(np.append(b["tids"], 0)),
            i32(np.append(b["rcs"], 1 << 20)), np.array([cv], np.int32),
            mode=mode, tile=tile, interpret=True)
        np.testing.assert_array_equal(np.asarray(got_heap), want_heap)
        np.testing.assert_array_equal(np.asarray(got_ok)[:n_txn] != 0,
                                      want_ok)
        for oop in (False, True):
            t_heap = torch.from_numpy(heap.copy())
            new, ok, l_out = _port_commit(t_heap, b, cv, n_txn, mode, oop)
            assert (new is t_heap) != oop
            np.testing.assert_array_equal(new.numpy(), want_heap)
            if oop:
                np.testing.assert_array_equal(t_heap.numpy(), heap)
            np.testing.assert_array_equal(ok.numpy() != 0, want_ok)
            want_words = np.where(
                want_ok[b["l_seg"]], CF.release_word(cv), _words(*b["l_f"]))
            np.testing.assert_array_equal(l_out.numpy(), want_words)
            if b["l_seg"].size:
                np.testing.assert_array_equal(
                    np.asarray(got_lver)[:b["l_seg"].size],
                    want_lver.astype(np.int32))


def test_commit_fused_failed_member_and_int64_payloads():
    """Payloads, versions and the commit version beyond int32 stay
    exact; a member whose write lock another tid holds fails and leaves
    its row untouched; its lock entry keeps its own word."""
    big = (1 << 33) + 5
    heap = np.array([1, 2, 3, big, 4, 5, 6, 7], np.int64)
    w_addr = np.array([0, 2, 7], np.int64)
    w_val = np.array([big + 1, -7, 999], np.int64)
    w_seg = np.array([0, 0, 1], np.int64)
    l_words = _words([big, big, 5], [-1, -1, 9], [0, 0, 1])
    l_seg = np.array([0, 0, 1], np.int64)
    z = np.zeros((0,), np.int64)
    cv = big + 9
    new, ok, l_out = CF.commit_fused(
        torch.from_numpy(heap.copy()), w_addr, w_val, w_seg, l_words, l_seg,
        z, z, z, [0, 1], [big, big], cv, 2, mode=CF.MODE_LE)
    assert ok.tolist() == [1, 0]
    assert new.tolist() == [big + 1, 2, -7, big, 4, 5, 6, 7]
    assert l_out.tolist() == [CF.release_word(cv)] * 2 + [int(l_words[2])]
    # the reference's numpy route gives the same heap and verdict
    jl = TA.ArrayLockTable.host_fields(l_words)
    j_heap, j_ok, j_lver = J_CF.np_commit_fused(
        heap, w_addr, w_val, w_seg, *jl, l_seg, z, z.astype(np.int32),
        z.astype(np.int32), z, z, np.array([0, 1]), np.array([big, big]),
        cv, 2, J_CF.MODE_LE)
    assert j_heap.tolist() == new.tolist() and j_ok.tolist() == [True, False]
    assert (np.asarray(l_out) >> CF.VER_SHIFT).tolist() == j_lver.tolist()


def test_commit_fused_rejects_bad_batches():
    heap = torch.zeros(8, dtype=torch.int64)
    z = np.zeros((0,), np.int64)
    for bad in ([-1], [8]):
        with pytest.raises(IndexError):
            CF.commit_fused(heap, bad, [1], [0], z, z, z, z, z, [0], [0],
                            1, 1)
    with pytest.raises(ValueError):
        CF.commit_fused(heap, [1], [1], [1], z, z, z, z, z, [0], [0], 1, 1)
    assert heap.tolist() == [0] * 8


# ---------------------------------------------------------------------------
# snapshot_select
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["ties", "no_valid", "no_ts", "mixed"])
def test_snapshot_select_matches_pallas_and_ref(case):
    """Newest slot with NO_TS < ts <= clock, first maximum on ties, slot
    0 with ok False when none qualifies — against the Pallas kernel in
    interpret mode and ``ref.snapshot_select_ref``."""
    rng = np.random.default_rng(len(case))
    R, n = 8, 256
    ring = rng.integers(-I32, I32, (R, n)).astype(np.int32)
    ts = {"ties": [3, 7, 7, 2, 7, -1, 5, 1],
          "no_valid": [9, 10, 11, 12, 13, 14, 15, 16],
          "no_ts": [-1] * 8,
          "mixed": [4, -1, 6, 3, -1, 8, 2, 6]}[case]
    ts = np.array(ts, np.int32)
    for clock in (0, 4, 6, 7, 20):
        want, want_ok = J_SS.snapshot_select_flat(
            jnp.asarray(ring), jnp.asarray(ts), clock, tile=128,
            interpret=True)
        ref, ref_ok = J_REF.snapshot_select_ref(jnp.asarray(ring),
                                                jnp.asarray(ts), clock)
        got, ok = SS.snapshot_select(torch.from_numpy(ring),
                                     torch.from_numpy(ts), clock)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert bool(ok) == bool(want_ok) == bool(ref_ok)


def test_snapshot_select_copies_and_keeps_block_shape():
    ring = torch.arange(24, dtype=torch.int32).reshape(3, 2, 4)
    ts = torch.tensor([1, 2, -1], dtype=torch.int32)
    got, ok = SS.snapshot_select(ring, ts, 5)
    assert got.shape == (2, 4) and bool(ok)
    assert got.flatten().tolist() == list(range(8, 16))
    ring[1] = 0                                  # a later ring refresh
    assert got.flatten().tolist() == list(range(8, 16))
    with pytest.raises(ValueError):
        SS.snapshot_select(ring, ts.to(torch.int64), 5)


def test_snapshot_select_hands_out_distinct_ok_tensors():
    """Each call's ``ok`` is a 0-d bool of its own, also across the bulk
    blocks it is cut from: a later call never writes an earlier one's."""
    dev = torch.device("cpu")
    oks = [_lib.fresh_ok(dev) for _ in range(_lib.OK_BLOCK + 3)]
    assert all(o.dim() == 0 and o.dtype == torch.bool for o in oks)
    for o in oks:
        o.fill_(False)
    oks[5].fill_(True)
    assert [bool(o) for o in oks].count(True) == 1
    assert len({o.data_ptr() for o in oks}) == len(oks)


def test_snapshot_select_ok_tensors_stay_distinct_across_threads():
    """The STM's reader threads take ``ok`` tensors at once: under a
    short switch interval and more threads than cores, no element is
    handed out twice."""
    import sys
    import threading

    dev = torch.device("cpu")
    got = [[] for _ in range(16)]

    def take(out):
        for _ in range(300):
            o = _lib.fresh_ok(dev)
            out.append((o.data_ptr(), o))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=take, args=(g,)) for g in got]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    taken = [x for g in got for x in g]
    assert len(taken) == 16 * 300
    # every tensor is alive in ``taken``, so equal addresses would mean
    # one element handed out twice
    assert len({ptr for ptr, _ in taken}) == len(taken)


class _FakeLib:
    """Stands in for the kernel library: records each entry point call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("stream,refused", [(0, False), (0x7F00, True)])
def test_launch_keeps_the_one_stream_rule(monkeypatch, stream, refused):
    """``_lib.launch`` enqueues on the default stream and refuses any
    other, comparing raw stream handles (no card: the handles and the
    library are stand-ins)."""
    from repro_torch.kernels import _lib

    fake = _FakeLib()
    monkeypatch.setattr(_lib, "_lib", fake)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: stream, raising=False)
    monkeypatch.setitem(_lib._DEFAULT_STREAMS, 0, 0)
    dev = torch.device("cuda", 0)
    if refused:
        with pytest.raises(RuntimeError, match="one-stream rule"):
            _lib.launch("snapshot_select_rows", dev, 1, 2, 3)
        assert fake.calls == []
    else:
        _lib.launch("snapshot_select_rows", dev, 1, 2, 3)
        assert fake.calls == [("snapshot_select_rows", (1, 2, 3, 0))]


# ---------------------------------------------------------------------------
# flash_attention (float: held within the reference's tolerances)
# ---------------------------------------------------------------------------

FA_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _fa_inputs(seed, B, Sq, Sk, H, KV, D, dtype):
    """q, k, v from numpy as (jax, torch) pairs of ``dtype``."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)):
        j = jnp.asarray(rng.normal(0, 1, shape), jnp.float32).astype(dtype)
        t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            getattr(torch, dtype))
        out.append((j, t))
    return out


def _fa_close(got, want, dtype):
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        rtol=FA_TOL[dtype], atol=FA_TOL[dtype])


@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 128, 2, 2, 32),      # MHA
    (2, 256, 4, 2, 64),      # GQA 2:1
    (1, 512, 8, 1, 64),      # MQA
    (2, 128, 4, 4, 128),     # the largest head dim
    (1, 128, 8, 1, 256),     # MQA at paligemma-3b's head dim
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(B, S, H, KV, D, causal, dtype):
    """The shape grid of ``tests/test_kernels.py``: the port's plain route
    against ``ops.flash_attention`` (Pallas, interpret mode, K and V
    repeated per group); the port indexes the kv head instead."""
    (jq, tq), (jk, tk), (jv, tv) = _fa_inputs(S + H, B, S, S, H, KV, D,
                                              dtype)
    want = ops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                               block_k=64)
    _fa_close(FA.flash_attention(tq, tk, tv, causal=causal), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_gqa_eight_to_one(dtype):
    """qwen2.5-3b's grouping, 16 query heads over 2 kv heads (G = 8)."""
    (jq, tq), (jk, tk), (jv, tv) = _fa_inputs(8, 1, 128, 128, 16, 2, 32,
                                              dtype)
    want = ops.flash_attention(jq, jk, jv, causal=True, block_q=64,
                               block_k=64)
    _fa_close(FA.flash_attention(tq, tk, tv, causal=True), want, dtype)


@pytest.mark.parametrize("causal,Sq,Sk", [(True, 100, 100),
                                          (False, 100, 77)])
def test_flash_attention_ragged_tiles_match_the_oracle(causal, Sq, Sk):
    """Lengths that the kernel's 64-row tiles do not divide, and Sq != Sk
    without the mask, against ``ref.flash_attention_ref`` (the full
    matrix); the plain version walks a ragged last kv block."""
    (jq, tq), (jk, tk), (jv, tv) = _fa_inputs(9, 2, Sq, Sk, 4, 2, 40,
                                              "float32")
    def heads(a, g):                     # [B, S, h, D] -> [B*h*g, S, D]
        a = jnp.repeat(a.transpose(0, 2, 1, 3), g, 1)
        return a.reshape(-1, a.shape[2], 40)

    want = J_REF.flash_attention_ref(heads(jq, 1), heads(jk, 2),
                                     heads(jv, 2), causal=causal)
    want = want.reshape(2, 4, Sq, 40).transpose(0, 2, 1, 3)
    _fa_close(FA.flash_attention(tq, tk, tv, causal=causal), want,
              "float32")


def test_flash_attention_refuses_mismatched_heads():
    q = torch.zeros(1, 8, 6, 16)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q[:, :, :4], q[:, :, :4], causal=True)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q[..., :8], q[..., :8], causal=False)
