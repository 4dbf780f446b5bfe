"""The versioned read's mirror resolve (``mirror_select``) and the scatter
from host columns, through their CPU (plain PyTorch) routes, against the
JAX package.

* Seeded mirror states (numpy, from a seed) are loaded into both
  packages' ``PackedVLT``; the port's ``select`` and
  ``mirror_select_plain`` must give the reference's
  ``repro.core.vlt.PackedVLT.select`` values on every lane, its ``ok``
  (code != 0) and its ``way_hits``, exactly (all integer).
* A versioned ``read_bulk`` in 300-word chunks (past the 256 elements
  that ride in the launch's parameters on the card) matches the
  reference's values and stats in Mode Q and Mode U.
* ``scatter_write`` from host columns (list, numpy, CPU tensor, object
  payloads) at 1023, 1024 and 1025 pairs, ``scatter_fill``, and the
  packing the card's C call reads (``pack_pairs``) against the
  reference's ``np_write_back`` and a numpy scatter; bad addresses raise
  before anything is written.

The CUDA kernels run only on a card: ``chip_smoke.py`` holds each
against the same plain versions there, on both argument routes.
"""
import numpy as np
import pytest
import torch

import repro.api as J
from repro.configs.paper_stm import MultiverseParams as JParams
from repro.core import vlt as JV
from repro.core.engine import arrayheap as J_AH
from repro.core.locks import LockState
from repro.kernels import scatter_write as J_SW
from repro_torch import api as T
from repro_torch import kernels as K
from repro_torch.configs.paper_stm import MultiverseParams as TParams
from repro_torch.core import vlt as TV
from repro_torch.core.engine import arrayheap as TA
from repro_torch.core.locks import LockState as TLockState
from repro_torch.kernels import scatter_write as SW
from repro_torch.kernels import version_select as VS

EMPTY = JV.EMPTY_TS
BIG = (1 << 40) + 123


def _mirror_state(rng, size, ways=2, depth=4, base=BIG):
    """Seeded mirror arrays: seq mostly even (a tenth odd: torn rows),
    ways tracking addresses 0..999 or a sentinel, timestamps around
    ``base`` with empty slots, int64 data over the whole range."""
    seq = rng.integers(0, 1000, size) * 2 + (rng.random(size) < 0.1)
    addr = rng.integers(0, 1000, (size, ways))
    addr[rng.random((size, ways)) < 0.15] = JV.PackedVLT.NO_ADDR
    addr[rng.random((size, ways)) < 0.05] = JV.PackedVLT.UNPACKABLE
    ts = base + rng.integers(-12, 12, (size, ways, depth))
    ts = -np.sort(-ts, axis=2)                     # newest first
    ts[rng.random((size, ways, depth)) < 0.2] = EMPTY
    data = rng.integers(-(1 << 62), 1 << 62, (size, ways, depth))
    return seq, addr, ts, data


def _twins(state, ways=2, depth=4):
    seq, addr, ts, data = state
    ref = JV.PackedVLT(seq.size, depth=depth, ways=ways)
    ref._seq[:], ref._addr[:], ref._ts[:], ref._data[:] = seq, addr, ts, data
    port = TV.PackedVLT(seq.size, depth=depth, ways=ways, device="cpu")
    port.load(seq, addr, ts, data)
    return ref, port


def _queries(rng, addr, n):
    """``n`` (lock index, address) pairs: a third asks for way 0's
    address, a third way 1's, the rest a random address (mostly
    unmatched)."""
    size, ways = addr.shape
    idxs = rng.integers(0, size, n)
    pick = rng.integers(0, 3, n)
    addrs = rng.integers(0, 1000, n)
    for w in range(ways):
        sel = pick == w
        addrs[sel] = np.maximum(addr[idxs[sel], w], 0)
    return idxs.astype(np.int64), addrs.astype(np.int64)


def _check_against_reference(ref, port, idxs, addrs, r_clock):
    r_vals, r_ok = ref.select(idxs, addrs, r_clock)
    out = port.select(idxs, addrs, r_clock).numpy()
    codes = out[1]
    port.count_way_hits(codes[codes != 0])
    np.testing.assert_array_equal(codes != 0, r_ok)
    np.testing.assert_array_equal(out[0], r_vals)
    assert port.way_hits == ref.way_hits
    # the plain version, called bare, is the same block
    plain = VS.mirror_select_plain(
        port._seq, port._addr, port._tsdata, torch.from_numpy(idxs),
        torch.from_numpy(addrs), r_clock).numpy()
    np.testing.assert_array_equal(plain, out)
    return codes


@pytest.mark.parametrize("n", [1, 256, 257, 1024])
@pytest.mark.parametrize("base", [1000, BIG])
def test_select_matches_reference(n, base):
    rng = np.random.default_rng(n + base % 97)
    state = _mirror_state(rng, 512, base=base)
    ref, port = _twins(state)
    idxs, addrs = _queries(rng, state[1], n)
    seen = set()
    for r_clock in (base - 13, base, base + 5, base + 13):
        codes = _check_against_reference(ref, port, idxs, addrs, r_clock)
        seen.update(np.unique(codes).tolist())
    if n >= 256:
        assert {0, 1, 2} <= seen          # misses, first and second way


def test_select_cases_one_by_one():
    """One element per case: stable first-way and second-way hits, an
    odd seq, an unmatched address, a sentinel way, no version below the
    clock, empty slots, int64 data and a clock beyond int32."""
    clock = (1 << 44) + 50
    seq = np.array([2, 4, 7, 6, 8, 10, 12, 0], np.int64)
    addr = np.array([[5, 9], [11, 3], [5, 6], [1, 2], [-1, 4], [8, -2],
                     [13, 14], [-1, -1]], np.int64)
    ts = np.full((8, 2, 4), EMPTY, np.int64)
    data = np.arange(64, dtype=np.int64).reshape(8, 2, 4) * BIG
    ts[0, 0] = [clock + 3, clock - 1, clock - 9, EMPTY]   # slot 1
    ts[1, 1] = [clock - 2, clock - 3, EMPTY, EMPTY]       # way 1 slot 0
    ts[2, 0] = [clock - 1, EMPTY, EMPTY, EMPTY]           # torn row
    ts[3, 0] = [clock - 1, EMPTY, EMPTY, EMPTY]           # unmatched
    ts[4, 1] = [clock - 5, EMPTY, EMPTY, EMPTY]           # after a NO_ADDR
    ts[5, 0] = [clock, clock + 1, EMPTY, EMPTY]           # none below
    ts[6, 0] = [EMPTY] * 4                                # empty way
    ref, port = _twins((seq, addr, ts, data))
    idxs = np.arange(8, dtype=np.int64)
    addrs = np.array([5, 3, 5, 7, 4, 8, 13, 0], np.int64)
    codes = _check_against_reference(ref, port, idxs, addrs, clock)
    assert codes.tolist() == [1, 2, 0, 0, 2, 0, 0, 0]
    vals = port.select(idxs, addrs, clock).numpy()[0]
    assert vals[0] == data[0, 0, 1] and vals[1] == data[1, 1, 0]
    assert vals[4] == data[4, 1, 0]
    # a miss still carries the plain version's value: way 0, slot 0
    assert vals[3] == data[3, 0, 0] and vals[6] == data[6, 0, 0]
    # the sentinel ways never match, even for the sentinel's own value
    neg = port.select(np.array([7, 5]), np.array([-1, -2]), clock)
    assert neg[1].tolist() == [0, 0]


def test_select_writes_into_the_callers_block_and_checks_bounds():
    rng = np.random.default_rng(3)
    state = _mirror_state(rng, 64)
    _, port = _twins(state)
    idxs, addrs = _queries(rng, state[1], 40)
    block = torch.full((6, 40), -7, dtype=torch.int64)
    got = port.select(idxs, addrs, BIG, out=block[4:])
    assert got.data_ptr() == block[4].data_ptr()
    np.testing.assert_array_equal(block[4:].numpy(),
                                  port.select(idxs, addrs, BIG).numpy())
    assert (block[:4] == -7).all()
    K.reset_launch_counts()
    for bad in ([-1], [64], [3, 70]):
        with pytest.raises(IndexError):
            port.select(np.array(bad), np.zeros(len(bad), np.int64), BIG)
    with pytest.raises(ValueError):
        port.select(idxs, addrs[:5], BIG)
    with pytest.raises(ValueError):
        port.select(idxs, addrs, BIG, out=block[3:])
    assert K.launch_counts()["mirror_select"] == 0


def _make(pkg, forced_mode, array_heap):
    if pkg is J:
        return J.make_tm("multiverse", 2, array_heap=array_heap,
                         start_bg=False, forced_mode=forced_mode,
                         params=JParams(k1=2, k2=6, k3=6,
                                        lock_table_bits=8))
    return T.make_tm("multiverse", 2, array_heap=array_heap, start_bg=False,
                     forced_mode=forced_mode, device="cpu",
                     params=TParams(k1=2, k2=6, k3=6, lock_table_bits=8))


@pytest.mark.parametrize("array_heap", [True, False])
@pytest.mark.parametrize("forced_mode", ["Q", "U"])
@pytest.mark.parametrize("seed", [0, 1])
def test_versioned_read_bulk_long_chunks_match_reference(forced_mode,
                                                         seed, array_heap):
    """Versioned readers scan 900 words in 300-word chunks while another
    tid commits writes between the chunks: the values every chunk reads,
    the commit outcomes and the mirror's stats equal the reference's, on
    a device heap (one bracketed gather and the mirror in one block) and
    on a host heap (the lock gathers around the host gather)."""
    region, chunk = 900, 300
    out = []
    for pkg in (J, T):
        tm = _make(pkg, forced_mode, array_heap)
        base = tm.alloc(region, 100)
        rng = np.random.default_rng(seed)
        trace = []
        for _ in range(8):
            tm.clock.increment()
            tm.begin_operation(0)
            tx = tm.begin(0)
            tx._ctx.versioned = True
            try:
                for off in range(0, region, chunk):
                    for _ in range(int(rng.integers(1, 6))):
                        a = base + int(rng.integers(region))
                        v = int(rng.integers(1000))
                        pkg.run(tm, lambda t: t.write(a, v), tid=1)
                        trace.append(("write", a - base, v))
                    vals = tx.read_bulk(range(base + off,
                                              base + off + chunk))
                    trace.append(("chunk", [int(v) for v in vals]))
                tm.commit(tx)
                trace.append(("commit",))
            except pkg.AbortTx:
                tm.abort(tx)
                trace.append(("abort",))
        stats = tm.raw.stats()
        out.append((trace, {k: stats[k] for k in (
            "version_gather_hits", "mirror_way2_hits", "commits",
            "aborts")}))
        tm.stop()
    (jt, js), (tt, ts) = out
    assert tt == jt
    assert ts == js
    if forced_mode == "U":
        assert ts["version_gather_hits"] > 0


# ---------------------------------------------------------------------------
# the scatter from host columns
# ---------------------------------------------------------------------------


class _Payload:
    """A non-integer payload that coerces through ``int``."""

    def __init__(self, v):
        self.v = v

    def __int__(self):
        return self.v


def _columns(kind, vals):
    if kind == "list":
        return vals.tolist()
    if kind == "numpy":
        return vals
    if kind == "tensor":
        return torch.from_numpy(vals.copy())
    return [_Payload(int(v)) for v in vals]


@pytest.mark.parametrize("n", [1023, 1024, 1025])
@pytest.mark.parametrize("kind", ["list", "numpy", "tensor", "object"])
def test_scatter_host_columns_match_reference(n, kind):
    rng = np.random.default_rng(n)
    heap = rng.integers(-(1 << 62), 1 << 62, 4096)
    addrs = rng.choice(4096, n, replace=False).astype(np.int64)
    vals = rng.integers(-(1 << 62), 1 << 62, n)
    row = torch.from_numpy(heap.copy())
    SW.scatter_write(row, addrs, _columns(kind, vals))
    want = J_SW.np_write_back(heap, addrs, vals)
    np.testing.assert_array_equal(row.numpy(), want)
    host = heap.copy()
    host[addrs] = vals
    np.testing.assert_array_equal(row.numpy(), host)


@pytest.mark.parametrize("n", [1, 1024, 1025, 2049])
@pytest.mark.parametrize("kind", ["list", "numpy", "tensor", "object"])
def test_pack_pairs_is_what_the_c_call_reads(n, kind):
    """The buffer the card's C call reads (the parameter buffer up to
    1024 pairs, a staging block above): index ``2i``, value ``2i + 1``;
    words past the pairs untouched."""
    rng = np.random.default_rng(7 + n)
    addrs = rng.integers(0, 1 << 40, n)
    vals = rng.integers(-(1 << 62), 1 << 62, n)
    buf = np.full(2 * n + 3, -5, np.int64)
    SW.pack_pairs(buf, addrs, _columns(kind, vals))
    np.testing.assert_array_equal(buf[0:2 * n:2], addrs)
    np.testing.assert_array_equal(buf[1:2 * n:2], vals)
    assert (buf[2 * n:] == -5).all()
    np.testing.assert_array_equal(buf[:2 * n].reshape(n, 2),
                                  np.stack((addrs, vals), axis=1))
    with pytest.raises(ValueError):
        SW.pack_pairs(buf, addrs, _columns(kind, vals)[:n - 1] if n > 1
                      else [])


def test_as_values_coerces_like_the_scalar_path():
    out = np.empty(4, np.int64)
    SW.as_values([1.9, -2.5, True, 7], 4, out)
    assert out.tolist() == [1, -2, 1, 7]
    SW.as_values(torch.tensor([3.7, -1.2, 0.0, 9.0]), 4, out)
    assert out.tolist() == [3, -1, 0, 9]
    SW.as_values(np.array([BIG, -BIG, 0, 1], dtype=object), 4, out)
    assert out.tolist() == [BIG, -BIG, 0, 1]
    with pytest.raises(ValueError):
        SW.as_values(5, 4, out)


@pytest.mark.parametrize("n", [1, 2048, 2049])
def test_scatter_fill_matches_reference(n):
    """The fill form (one value at every index; repeated indices allowed)
    against ``np_write_back`` with a full value column, and a repeated
    index with an equal value in the pair form."""
    rng = np.random.default_rng(n)
    heap = rng.integers(-(1 << 62), 1 << 62, 4096)
    addrs = rng.integers(0, 4096, n)
    word = (BIG << 18) | 2
    row = torch.from_numpy(heap.copy())
    SW.scatter_fill(row, addrs, word)
    want = J_SW.np_write_back(heap, addrs, np.full(n, word, np.int64))
    np.testing.assert_array_equal(row.numpy(), want)
    # a repeated index with an equal value, in the pair form
    u = rng.choice(4096, min(n, 4000), replace=False)
    vals = np.arange(u.size, dtype=np.int64)
    row = torch.from_numpy(heap.copy())
    SW.scatter_write(row, np.concatenate((u, u[:1])),
                     np.concatenate((vals, vals[:1])))
    host = heap.copy()
    host[u] = vals
    np.testing.assert_array_equal(row.numpy(), host)


@pytest.mark.parametrize("bad", [[-1], [0, -3], [4096], [2, 5000],
                                 list(range(1023)) + [-2]])
def test_bad_addresses_raise_before_anything_is_written(bad):
    K.reset_launch_counts()
    row = torch.arange(4096, dtype=torch.int64)
    with pytest.raises(IndexError):
        SW.scatter_write(row, bad, list(range(len(bad))))
    with pytest.raises(IndexError):
        SW.scatter_fill(row, bad, 9)
    with pytest.raises(ValueError):
        SW.scatter_write(row, [1, 2], [5])
    assert row.tolist() == list(range(4096))
    assert K.launch_counts()["scatter_write"] == 0


@pytest.mark.parametrize("version", [None, 7, BIG >> 4])
def test_unlock_bulk_matches_reference(version):
    """The commit release (fill form at a version) and the keep-version
    release over twin lock tables, duplicates included."""
    rng = np.random.default_rng(11)
    ref, port = J_AH.ArrayLockTable(10), TA.ArrayLockTable(10, device="cpu")
    for idx in rng.integers(0, 1 << 10, 300):
        st = LockState(True, int(rng.integers(0, 1 << 30)), 3, False)
        ref.store(int(idx), st)
        port.store(int(idx), TLockState(*st))
    idxs = rng.integers(0, 1 << 10, 1500)
    ref.unlock_bulk(idxs, version)
    port.unlock_bulk(idxs, version)
    np.testing.assert_array_equal(port.row.numpy(), ref._words)
