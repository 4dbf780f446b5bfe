"""The port's lock table, heap and state carry-across against the JAX
package's, on seeded batches, bit for bit (all integer: exact)."""
import numpy as np
import pytest
import torch

from repro.core.engine import arrayheap as J_AH
from repro.core.engine import validation as JV
from repro.core.locks import LockState, addr_index
from repro_torch.api import dump_numpy_state, load_numpy_state, make_tm
from repro_torch.core.engine import arrayheap as AH
from repro_torch.core.engine import validation as TV
from repro_torch.core.locks import LockState as TLockState
from repro_torch.kernels import validate as VK

CPU = "cpu"


def _states(rng, n):
    out = []
    for _ in range(n):
        out.append(LockState(bool(rng.integers(2)),
                             int(rng.integers(0, 1 << 46)),
                             int(rng.integers(-2, 6)),
                             bool(rng.integers(2))))
    return out


def test_pack_unpack_bit_identical():
    rng = np.random.default_rng(0)
    states = _states(rng, 300)
    for tid in (-2, -1, 0, 65533):
        for version in (0, 1, (1 << 46) - 1):
            for locked in (False, True):
                for flag in (False, True):
                    states.append(LockState(locked, version, tid, flag))
    for st in states:
        w = J_AH.pack_lock(st)
        assert AH.pack_lock(TLockState(*st)) == w
        assert tuple(AH.unpack_lock(w)) == tuple(J_AH.unpack_lock(w)) \
            == tuple(st)


@pytest.mark.parametrize("bits", [8, 12, 16])
def test_index_bulk_matches_addr_index(bits):
    rng = np.random.default_rng(bits)
    addrs = np.concatenate([
        rng.integers(0, 1 << 20, 500), rng.integers(0, (1 << 63) - 1, 500),
        np.array([0, 1, (1 << 63) - 1])]).astype(np.int64)
    lt = AH.ArrayLockTable(bits, device=CPU)
    got = lt.index_bulk(addrs)
    assert got.dtype == np.int64
    assert got.tolist() == [addr_index(int(a), bits) for a in addrs]


def _twin_tables(seed, bits=9):
    rng = np.random.default_rng(seed)
    ref = J_AH.ArrayLockTable(bits)
    port = AH.ArrayLockTable(bits, device=CPU)
    for idx, st in zip(rng.integers(0, 1 << bits, 200),
                       _states(rng, 200)):
        st = st._replace(version=st.version % 40, tid=st.tid % 4)
        ref.store(int(idx), st)
        port.store(int(idx), TLockState(*st))
    return rng, ref, port


def _words(t):
    return t._words.cpu().numpy() if isinstance(t._words, torch.Tensor) \
        else t._words


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lock_table_bulk_ops_match_reference(seed):
    rng, ref, port = _twin_tables(seed)
    size = ref.size
    np.testing.assert_array_equal(_words(port), _words(ref))
    for step in range(60):
        idxs = rng.integers(0, size, int(rng.integers(1, 300)))
        tid = int(rng.integers(0, 4))
        op = step % 4
        if op == 0:
            rv, ro, rm = ref.gather(idxs)
            pv, po, pm = port.gather(idxs)
            assert pv.dtype == torch.int64 and po.dtype == torch.int32
            np.testing.assert_array_equal(pv.numpy(), rv)
            np.testing.assert_array_equal(po.numpy(), ro)
            np.testing.assert_array_equal(pm.numpy(), rm)
        elif op == 1:
            mv = None if rng.random() < 0.5 else int(rng.integers(0, 45))
            r = ref.try_lock_bulk(idxs, tid, max_version=mv)
            p = port.try_lock_bulk(idxs, tid, max_version=mv)
            assert (r is None) == (p is None)
            if r is not None:
                np.testing.assert_array_equal(p, r)
        elif op == 2:
            ver = None if rng.random() < 0.5 else int(rng.integers(0, 50))
            ref.unlock_bulk(idxs, ver)
            port.unlock_bulk(idxs, ver)
        else:
            w = ref.words_at(idxs)
            np.testing.assert_array_equal(port.words_at(idxs).numpy(), w)
            tids = rng.integers(-2, 4, idxs.size)
            np.testing.assert_array_equal(port.claim_words(w, tids),
                                          ref.claim_words(w, tids))
            np.testing.assert_array_equal(port.held_by(tid),
                                          ref.held_by(tid))
        np.testing.assert_array_equal(_words(port), _words(ref))
    # the scalar surface reads the same words
    for i in rng.integers(0, size, 50):
        assert tuple(port.read(int(i))) == tuple(ref.read(int(i)))


def test_array_heap_matches_reference():
    rng = np.random.default_rng(5)
    ref, port = J_AH.ArrayHeap(4), AH.ArrayHeap(4, device=CPU)
    for step in range(40):
        if step % 5 == 0:
            n, init = int(rng.integers(1, 90)), int(rng.integers(-9, 9))
            assert port.alloc(n, init) == ref.alloc(n, init)
        live = len(ref)
        assert len(port) == live
        addrs = rng.integers(0, live, int(rng.integers(1, 2 * live)))
        np.testing.assert_array_equal(port.gather(addrs).numpy(),
                                      ref.gather(addrs))
        uniq = np.unique(addrs)
        vals = rng.integers(-(1 << 62), 1 << 62, uniq.size)
        ref.scatter(uniq, vals)
        port.scatter(uniq, torch.from_numpy(vals) if step % 2 else
                     vals.tolist())
        a = int(rng.integers(0, live))
        ref[a] = step
        port[a] = step
        assert port[a] == ref[a]
    np.testing.assert_array_equal(port.live().numpy(),
                                  ref._buf[:len(ref)])
    for bad in ([-1], [len(ref)]):
        with pytest.raises(IndexError):
            port.gather(bad)
        with pytest.raises(IndexError):
            port.scatter(bad, [1])
    with pytest.raises(IndexError):
        port[len(ref)]
    with pytest.raises(IndexError):
        port[-1] = 0


def _random_state(rng, bits=8, ways=2, depth=4, heap=700):
    size = 1 << bits
    return {
        "heap": rng.integers(-(1 << 62), 1 << 62, heap),
        "lock_words": rng.integers(0, 1 << 62, size),
        "clock": int(rng.integers(0, 1 << 40)),
        "mirror_seq": rng.integers(0, 100, size) * 2,
        "mirror_addr": rng.integers(-2, 1000, (size, ways)),
        "mirror_ts": rng.integers(0, 1 << 62, (size, ways, depth)),
        "mirror_data": rng.integers(-(1 << 62), 1 << 62,
                                    (size, ways, depth)),
    }


def test_load_then_dump_round_trips():
    from repro_torch.configs.paper_stm import MultiverseParams

    rng = np.random.default_rng(9)
    state = _random_state(rng)
    tm = make_tm("multiverse", 2, array_heap=True, start_bg=False,
                 device=CPU, params=MultiverseParams(lock_table_bits=8))
    tm.alloc(10, 1)
    load_numpy_state(tm, state)
    out = dump_numpy_state(tm)
    assert set(out) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(v))
    # the loaded heap is live: reads and the allocation frontier follow it
    assert len(tm.raw.heap) == state["heap"].size
    assert tm.peek(3) == int(state["heap"][3])
    assert tm.alloc(2, 7) == state["heap"].size
    with pytest.raises(ValueError):
        load_numpy_state(tm, {**state, "lock_words": np.zeros(5)})
    tm.stop()


def _twin_lock_words(seed, bits=12, n=1500):
    """Twin lock tables holding own and foreign locks, flags and versions
    up to 2^44 (far beyond int32; an int64 word holds 45 bits)."""
    rng = np.random.default_rng(seed)
    ref = J_AH.ArrayLockTable(bits)
    port = AH.ArrayLockTable(bits, device=CPU)
    for idx, st in zip(rng.integers(0, 1 << bits, n), _states(rng, n)):
        st = st._replace(version=st.version >> 2)
        ref.store(int(idx), st)
        port.store(int(idx), TLockState(*st))
    return rng, ref, port


def _read_set(rng, ref, n, valid):
    """``n`` (lock index, seen version) pairs; ``valid``: only free words,
    each seen at its version (a set every mode accepts at a clock past
    its versions); else any word, a tenth seen at another version."""
    idxs = rng.integers(0, ref.size, 4 * n)
    rv, _, rm = ref.gather(idxs)
    if valid:
        idxs, rv = idxs[rm == 0][:n], rv[rm == 0][:n]
        return idxs, rv.copy()
    idxs, rv = idxs[:n], rv[:n]
    return idxs, np.where(rng.random(n) < 0.9, rv,
                          rv + rng.integers(-1, 2, n))


def _clocks(rv):
    top = int(rv.max()) + 1 if rv.size else 1
    return [(top, 1), (int(np.median(rv)) if rv.size else 0, 0),
            ((1 << 31) + 5, -1), (1 << 45, 3)]


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("seed,n", [(0, 1), (1, 300), (2, 1024),
                                    (3, 2000)])
def test_validate_words_matches_reference(mode, seed, n):
    """``validate_words``' plain route (the CPU lock table's) against the
    reference on the same lock-table state: its mask entry by entry and
    its verdict against ``np_validate`` over the reference table's
    gathered fields, with own locks, flags and clocks beyond int32; an
    all-valid set gives True."""
    rng, ref, port = _twin_lock_words(seed)
    for valid in (False, True):
        idxs, seen = _read_set(rng, ref, n, valid)
        rv, ro, rm = ref.gather(idxs)
        entries = np.stack((idxs, seen), axis=1)
        for r_clock, tid in _clocks(rv):
            ok, mask = VK.validate_words(port.row, entries, r_clock, tid,
                                         mode, want_mask=True)
            want = [JV.np_validate(rv[i:i + 1], ro[i:i + 1], rm[i:i + 1],
                                   seen[i:i + 1], r_clock, tid, mode)
                    for i in range(idxs.size)]
            assert mask.dtype == torch.int32 and ok.dim() == 0
            assert mask.tolist() == [int(w) for w in want]
            assert bool(ok) == JV.np_validate(rv, ro, rm, seen, r_clock,
                                              tid, mode)
            if valid and r_clock > int(rv.max()):
                assert bool(ok)
            ok2, none = VK.validate_words(port.row, entries, r_clock, tid,
                                          mode)
            assert none is None and bool(ok2) == bool(ok)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("seed", [4, 5])
def test_revalidate_bulk_route_matches_scalar_and_reference(mode, seed):
    """The engine's ``revalidate`` over a read set at or above
    ``BULK_MIN`` (the ``validate_words`` route) gives the verdict of the
    word-at-a-time loop and of the reference engine on the twin table."""
    rng, ref, port = _twin_lock_words(seed)
    for n in (TV.BULK_MIN, 700):
        for valid in (False, True):
            idxs, seen = _read_set(rng, ref, n, valid)
            read_set = list(zip(idxs.tolist(), seen.tolist()))
            rv = ref.gather(idxs)[0]
            for r_clock, tid in _clocks(rv):
                bulk = TV.revalidate_bulk(port, read_set, r_clock, tid, mode)
                assert bulk is not None
                assert bulk == TV.revalidate(port, read_set, r_clock, tid,
                                             mode) \
                    == TV.revalidate_scalar(port, read_set, r_clock, tid,
                                            mode) \
                    == JV.revalidate(ref, read_set, r_clock, tid, mode)


def test_validate_words_checks_its_arguments():
    """Out-of-range lock indices raise before anything runs; an empty
    read set is valid."""
    port = AH.ArrayLockTable(8, device=CPU)
    with pytest.raises(IndexError):
        VK.validate_words(port.row, [[256, 0]], 1, 0, 0)
    with pytest.raises(IndexError):
        VK.validate_words(port.row, [[-1, 0]], 1, 0, 0)
    ok, mask = VK.validate_words(port.row, np.zeros((0, 2), np.int64), 1,
                                 0, 2, want_mask=True)
    assert bool(ok) and mask.shape == (0,)
    VK.launches.reset()
    VK.validate_words(port.row, [[3, 0]], 1, 0, 1)
    assert VK.launches.value == 0        # the plain route launches nothing
