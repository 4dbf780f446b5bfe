"""The port's roofline (``repro_torch.launch.roofline``), its
``model_flops``, its report and its ``core.stm.run`` shim against the
JAX package's, on the CPU.

``model_flops`` must equal the reference's for every arch and shape;
``roofline_terms`` and ``collective_bytes`` must give the reference's
numbers at the same peaks and for the same collectives (issued here on
a fake process group of 8 ranks, subgroups of 4 and 2, where the
reference parses HLO text); the eager byte model and
``attention_score_bytes`` must give hand counts; and each kernel
wrapper, on its CPU route under ``count()``, must add the flops
``FlopCounterMode`` counts over its plain version and the bytes of its
kernel's bound, and return what it returns uncounted.
"""
import dataclasses
import json
import textwrap
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import roofline as J_RL
from repro.models import model_zoo as J_ZOO
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.kernels import commit_fused as CF
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_adamw as FW
from repro_torch.kernels import gather_read as GR
from repro_torch.kernels import scatter_write as SW
from repro_torch.kernels import snapshot_select as SN
from repro_torch.kernels import ssd_scan as SS
from repro_torch.kernels import validate as VK
from repro_torch.kernels import version_select as VS
from repro_torch.launch import roofline as RL
from repro_torch.launch import roofline_report as RR
from repro_torch.models import attention as AT
from repro_torch.models import model_zoo as ZOO

from benchmarks import roofline_report as J_RR


# ---------------------------------------------------------------------------
# model_flops and roofline_terms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equals_reference(arch, shape):
    assert sorted(SHAPES) == sorted(J_SHAPES)
    got = ZOO.model_flops(get_config(arch), SHAPES[shape])
    want = J_ZOO.model_flops(j_get_config(arch), J_SHAPES[shape])
    assert isinstance(got, float) and got == float(want)


def test_model_flops_moonshot_at_six_layers():
    """The depth the card trains moonshot-v1-16b-a3b at."""
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=6)
    jcfg = dataclasses.replace(j_get_config("moonshot-v1-16b-a3b"),
                               n_layers=6)
    for shape in SHAPES:
        assert ZOO.model_flops(cfg, SHAPES[shape]) == float(
            J_ZOO.model_flops(jcfg, J_SHAPES[shape]))
    assert ZOO.param_counts(cfg)["total"] == 4_094_453_760


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's roofline module at the port's peaks."""
    monkeypatch.setattr(J_RL, "PEAK_FLOPS", RL.PEAK_FLOPS["bfloat16"])
    monkeypatch.setattr(J_RL, "HBM_BW", RL.HBM_BW)
    monkeypatch.setattr(J_RL, "ICI_BW", RL.NVLINK_BW)
    return J_RL


@pytest.mark.parametrize("arch,shape,cost,wire,chips", [
    # the reference test's counts (tests/test_sharding_dryrun.py)
    ("qwen2.5-3b", "train_4k", {"flops": 1e14, "bytes accessed": 1e11},
     1e9, 256),
    ("moonshot-v1-16b-a3b", "decode_32k",
     {"flops": 3e11, "bytes accessed": 5e10}, 0.0, 1),
    ("paligemma-3b", "prefill_32k",
     {"flops": 2e12, "bytes accessed": 1e9}, 9e11, 4),
])
def test_roofline_terms_equal_reference(h100_reference, arch, shape, cost,
                                        wire, chips):
    got = RL.roofline_terms(get_config(arch), SHAPES[shape], cost=cost,
                            collectives={"total_wire_bytes": wire},
                            n_chips=chips)
    want = h100_reference.roofline_terms(
        j_get_config(arch), J_SHAPES[shape], cost=cost,
        collectives={"total_wire_bytes": wire}, n_chips=chips)
    assert got == pytest.approx(want, rel=1e-12)
    assert got["dominant"] == want["dominant"]


def test_roofline_terms_float32_peak():
    cost = {"flops": 67e12, "bytes accessed": 0.0}
    t = RL.roofline_terms(get_config("qwen2.5-3b"), SHAPES["train_4k"],
                          cost=cost, collectives={}, n_chips=1,
                          dtype="float32")
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["dominant"] == "compute"


# ---------------------------------------------------------------------------
# collective_bytes on a fake process group
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_world():
    """A fake process group of 8 ranks (this process is rank 0) with
    subgroups {0..3} and {0, 1}; destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield dist.new_group([0, 1, 2, 3]), dist.new_group([0, 1])
    finally:
        dist.destroy_process_group()


def test_collective_bytes_equal_reference_parser(fake_world):
    """The reference test's collectives (an all-reduce of f32[128, 256]
    over 4 ranks, an all-gather to bf16[64, 64] over 2, a permute of
    f32[32]), issued through c10d: a point-to-point ``send`` is the
    permute (its receiver's ``recv_`` is not counted again)."""
    g4, g2 = fake_world
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with RL.count(device="cpu") as rec:
            dist.all_reduce(torch.zeros(128, 256), group=g4)
            dist.all_gather_into_tensor(
                torch.empty(64, 64, dtype=torch.bfloat16),
                torch.zeros(32, 64, dtype=torch.bfloat16), group=g2)
            dist.send(torch.zeros(32), dst=1, group=g4)
    got = RL.collective_bytes(rec, default_group=4)
    hlo = textwrap.dedent("""
      ENTRY %main {
        %ar = f32[128,256]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}
        %ag = bf16[64,64]{1,0} all-gather(%y), replica_groups=[8,2]<=[16]
        %cp = f32[32]{0} collective-permute(%z)
        %dot = f32[8,8]{1,0} dot(%a, %b)
      }
    """)
    want = J_RL.collective_bytes(hlo, default_group=4)
    assert got["ops"] == want["ops"]
    assert got["total_result_bytes"] == want["total_result_bytes"]
    assert got["total_wire_bytes"] == pytest.approx(want["total_wire_bytes"])
    assert [(t["kind"], t["group"], t["wire_bytes"]) for t in got["top"]] \
        == [(t["kind"], t["group"], t["wire_bytes"]) for t in want["top"]]
    assert len(got["top"]) == 3


def test_collective_bytes_scatter_and_all_to_all(fake_world):
    """reduce-scatter (result 1/n of the operand) and all-to-all over the
    whole group, and the c10d ops the fake group records for them."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with RL.count(device="cpu") as rec:
            dist.reduce_scatter_tensor(torch.empty(16), torch.zeros(128))
            dist.all_to_all_single(torch.empty(32), torch.zeros(32))
    assert [c["op"] for c in rec.collectives] == [
        "_reduce_scatter_base_", "alltoall_base_"]
    got = RL.collective_bytes(rec)
    hlo = ("%rs = f32[16]{0} reduce-scatter(%x), "
           "replica_groups={{0,1,2,3,4,5,6,7}}\n"
           "%aa = f32[32]{0} all-to-all(%y), "
           "replica_groups={{0,1,2,3,4,5,6,7}}\n")
    want = J_RL.collective_bytes(hlo)
    assert got["ops"] == want["ops"]
    assert got["total_wire_bytes"] == pytest.approx(want["total_wire_bytes"])


# ---------------------------------------------------------------------------
# the eager byte model and the attention score bytes
# ---------------------------------------------------------------------------


def test_eager_byte_model_hand_count():
    """Every operand read and every result written; a view moves
    nothing; a copy to another device is not counted."""
    a, b = torch.randn(128, 128), torch.randn(128, 128)
    c = torch.randn(1024)
    t, v = 128 * 128 * 4, 1024 * 4
    with RL.count(device="cpu") as rec:
        d = a @ b                 # mm: reads a, b, writes d
        e = torch.exp(c)          # reads c, writes e
        f = d + d                 # reads d twice, writes f
        f.view(-1)                # a view: nothing
        f.add_(1.0)               # reads f, writes f
        e.to("meta")              # another device
    assert RL.hbm_bytes_model(rec) == {"hbm_bytes": float(8 * t + 2 * v)}
    assert rec.flops == 2 * 128 ** 3
    assert rec.by_op["aten.mm"] == [1, 2 * 128 ** 3, 3 * t]
    assert rec.cost() == {"flops": float(2 * 128 ** 3),
                          "bytes accessed": float(8 * t + 2 * v)}


def test_counted_flops_equal_flop_counter_mode_on_a_graph():
    """A small autograd graph: ``count()`` and ``FlopCounterMode`` give
    the same flops, backward included."""
    torch.manual_seed(0)
    w = torch.randn(32, 64, requires_grad=True)
    x = torch.randn(16, 8, 64)

    def step():
        y = torch.nn.functional.linear(x, w)
        z = torch.einsum("bsd,bte->bst", y, y).softmax(-1)
        z.sum().backward()

    with FlopCounterMode(display=False) as fc:
        step()
    with RL.count(device="cpu") as rec:
        step()
    assert rec.flops == fc.get_total_flops() > 0


def test_attention_score_bytes_plain_forward_and_backward():
    """The plain forward's scores (``naive_attention``, one kv head a
    query head) and the plain backward's recomputed scores and dP
    (``FlashAttentionFn``: the kernel wrapper forward keeps its scores
    on chip): twice the bytes of each [B, H, S, S] f32 product."""
    B, S, H, D = 2, 48, 4, 16
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, S, H, D, generator=g) for _ in range(3))
    score = B * H * S * S * 4
    with RL.count(device="cpu") as rec:
        AT.naive_attention(q, k, v, causal=True)
    assert RL.attention_score_bytes(rec, S, S) == 2 * score
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    with RL.count(device="cpu") as rec:
        o = AT.blockwise_attention(qg, kg, vg, causal=True, block_q=S,
                                   block_k=S)
        o.sum().backward()
    assert rec.kernels["flash_attention"][0] == 1
    assert RL.attention_score_bytes(rec, S, S) == 2 * 2 * score
    assert RL.attention_score_bytes(rec, S, S + 1) == 0.0


# ---------------------------------------------------------------------------
# the kernel hooks
# ---------------------------------------------------------------------------


def _flash(B, Sq, Sk, H, KV, D, causal):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(B, Sq, H, D, generator=g)
    k, v = (torch.randn(B, Sk, KV, D, generator=g) for _ in range(2))
    return (lambda: FA.flash_attention(q, k, v, causal=causal),
            lambda: FA.flash_attention_plain(q, k, v, causal=causal),
            FA.work(q, k, v, causal=causal))


def _ssd(init):
    g = torch.Generator().manual_seed(2)
    B, S, H, P, N, Q = 2, 128, 3, 8, 16, 32
    xh = torch.randn(B, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g))
    Bm, Cm = (torch.randn(B, S, N, generator=g) for _ in range(2))
    st = torch.randn(B, H, N, P, generator=g) if init else None
    args = (xh, dt, A, Bm, Cm)
    return (lambda: SS.ssd_scan(*args, chunk=Q, init_state=st),
            lambda: SS.ssd_scan_plain(*args, chunk=Q, init_state=st),
            SS.work(*args, chunk=Q, init_state=st))


def _adamw(ring):
    g = torch.Generator().manual_seed(3)
    p = torch.randn(24, 16, generator=g).to(torch.bfloat16)
    gr = torch.randn(24, 16, generator=g)
    m, v = torch.zeros(24, 16), torch.zeros(24, 16)
    r = torch.zeros(2, 24, 16, dtype=torch.bfloat16) if ring else None
    sc = torch.tensor([1e-3, 1.0, 0.1, 0.05])
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)

    def state():
        return (p, gr, m.clone(), v.clone(),
                None if r is None else r.clone(), 1, sc)
    a, b = state(), state()
    return (lambda: FW.fused_adamw(*a, **kw),
            lambda: FW.fused_adamw_plain(*b, **kw), FW.work(*a, **kw))


def _snapshot():
    ring = torch.arange(3 * 40, dtype=torch.int32).reshape(3, 40)
    ts = torch.tensor([4, 7, -1], dtype=torch.int32)
    return (lambda: SN.snapshot_select(ring, ts, 6),
            lambda: SN.snapshot_select_plain(ring, ts, 6),
            (0, 2 * 160 + 12 + 4))


def _row(n=64):
    return torch.arange(n, dtype=torch.int64) * 3


def _stm_cases():
    """name -> (call, its kernel's bytes); every input made here, so a
    counted call counts the wrapper alone."""
    rows = [_row() for _ in range(6)]
    addrs = np.array([5, 1, 60, 7], np.int64)
    idx = torch.from_numpy(addrs)
    vals = torch.tensor([10, 11, 12, 13])
    words = _row()
    ver = torch.arange(8, dtype=torch.int64)
    own = torch.zeros(8, dtype=torch.int32)
    meta = torch.zeros(8, dtype=torch.int32)
    ts = torch.tensor([[1, 5], [2, 9], [8, 3]], dtype=torch.int64)
    data = torch.arange(6, dtype=torch.int64).reshape(3, 2)
    seq = torch.zeros(16, dtype=torch.int64)
    way = torch.arange(32, dtype=torch.int64).reshape(16, 2)
    tsd = torch.ones((2, 16, 2, 4), dtype=torch.int64)
    z = np.zeros((0,), np.int64)
    heap = _row(16)
    entries = np.stack([addrs, np.zeros(4, np.int64)], 1)
    return {
        "gather_read": (lambda: GR.gather_read(rows[0], addrs), 4 * 24),
        "gather_read_dev": (lambda: GR.gather_read_dev(rows[0], idx),
                            4 * 24),
        "gather_bracketed": (
            lambda: GR.gather_bracketed(words, rows[1], addrs, addrs),
            4 * 56),
        "scatter_write": (lambda: SW.scatter_write(rows[2], addrs, vals),
                          4 * 24),
        "scatter_write_dev": (
            lambda: SW.scatter_write_dev(rows[3], idx, vals), 4 * 24),
        "scatter_fill": (lambda: SW.scatter_fill(rows[4], addrs, 9), 4 * 16),
        "validate_mask": (
            lambda: VK.validate_mask(ver, own, meta, ver, 9, 0, 0),
            8 * 28 + 4),
        "validate_words": (
            lambda: VK.validate_words(rows[5], entries, 9, 0, 0), 4 * 24 + 1),
        "version_select": (lambda: VS.version_select(ts, data, 6),
                           48 + 48 + 36),
        "mirror_select": (
            lambda: VS.mirror_select(seq, way, tsd, [1, 2], [2, 5], 3),
            2 * 116),
        "commit_fused": (
            lambda: CF.commit_fused(heap, addrs[:2], [100, 101], [0, 0],
                                    z, z, z, z, z, [0], [0], 5, 1),
            2 * 32 + 17),
    }


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name,make", [
    ("flash_square_causal", lambda: _flash(2, 100, 100, 4, 2, 40, True)),
    ("flash_noncausal_gqa", lambda: _flash(2, 100, 77, 4, 1, 40, False)),
    ("flash_causal_short_queries", lambda: _flash(1, 70, 200, 8, 1, 16,
                                                  True)),
    ("ssd_zero_state", lambda: _ssd(False)),
    ("ssd_random_state", lambda: _ssd(True)),
    ("adamw_ring", lambda: _adamw(True)),
    ("adamw_no_ring", lambda: _adamw(False)),
    ("snapshot_select", _snapshot),
])
def test_model_kernel_hooks_count_the_plain_version(name, make):
    wrapper, plain, (flops, nbytes) = make()
    with FlopCounterMode(display=False) as fc:
        want = plain()
    with RL.count(device="cpu") as rec:
        got = wrapper()
    assert rec.flops == fc.get_total_flops() == flops
    assert rec.bytes == nbytes
    (kernel, (calls, kf, kb)), = rec.kernels.items()
    assert (calls, kf, kb) == (1, flops, nbytes)
    assert dict(rec.by_op) == {f"kernel:{kernel}": [1, flops, nbytes]}
    assert _same(got, want)


@pytest.mark.parametrize("name", list(_stm_cases()))
def test_stm_kernel_hooks_count_their_bound_bytes(name):
    """No products in any integer kernel's plain version; the bytes are
    the kernel's bound's, and the call returns what it returns
    uncounted."""
    call, nbytes = _stm_cases()[name]
    with FlopCounterMode(display=False) as fc:
        want = call()
    with RL.count(device="cpu") as rec:
        got = call()
    assert rec.flops == fc.get_total_flops() == 0
    assert rec.bytes == nbytes and len(rec.kernels) == 1
    assert all(k.startswith("kernel:") for k in rec.by_op)
    assert _same(got, want)


def test_nested_counted_wrappers_count_once():
    """``gather_read`` calls ``gather_read_dev``: one kernel's work."""
    row = _row()
    with RL.count(device="cpu") as rec:
        GR.gather_read(row, [1, 2, 3])
    assert dict(rec.by_op) == {"kernel:gather_read": [1, 0, 3 * 24]}


def test_no_count_no_work_and_counters_close():
    from repro_torch.kernels import _lib

    select = _snapshot()[0]
    with RL.count(device="cpu") as rec:
        with RL.count(device="cpu") as inner:
            select()
            assert len(_lib.COUNTERS) == 2
    assert not _lib.COUNTERS
    assert inner.kernels == {"snapshot_select": [1, 0, 336]}
    assert rec.kernels == {}
    select()                             # no counter open: nothing added
    assert inner.bytes == 336


# ---------------------------------------------------------------------------
# the report and the shim
# ---------------------------------------------------------------------------


def test_report_renders_the_reference_text(tmp_path):
    rows = [
        {"arch": "qwen2.5-3b", "shape": "train_chip", "mesh": "1xH100",
         "mv_mode": "U", "status": "ok",
         "memory": {"peak_bytes_per_device": 68.04e9},
         "roofline": {"t_compute_s": 0.05, "t_memory_s": 0.2,
                      "t_collective_s": 0.0, "dominant": "memory",
                      "useful_flops_ratio": 0.61,
                      "roofline_fraction": 0.21}},
        {"arch": "mamba2-780m", "shape": "decode", "mesh": "1xH100",
         "status": "skipped", "reason": "no card"},
        {"arch": "qwen2.5-3b", "shape": "train_chip", "mesh": "1xH100",
         "mv_mode": "Q", "status": "failed"},
    ]
    fit = tmp_path / "roofline.jsonl"
    fit.write_text("".join(json.dumps(r) + "\n" for r in rows))
    got, want = RR.render(str(fit)), J_RR.render(str(fit))
    assert got == want and len(got) == 3
    assert RR.to_markdown(got) == J_RR.to_markdown(want)
    md = tmp_path / "t.md"
    RR.render(str(fit), md_out=str(md))
    assert md.read_text() == J_RR.to_markdown(want)


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_stm_run_deprecation_warning_points_at_caller(package):
    import importlib

    make_tm = importlib.import_module(f"{package}.api").make_tm
    stm = importlib.import_module(f"{package}.core.stm")
    tm = make_tm("tl2", n_threads=1, **(
        {"device": "cpu"} if package == "repro_torch" else {}))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert stm.run(tm, lambda tx: 41 + 1, tid=0) == 42
    dep = [w for w in caught
           if issubclass(w.category, DeprecationWarning)]
    assert dep, "shim did not warn"
    assert dep[0].filename == __file__      # stacklevel=2: the caller
    tm.stop()
