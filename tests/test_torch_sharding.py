"""The port's sharding layer (``repro_torch.launch.sharding``, the dry
run's planning in ``launch/dryrun.py``, ``model_zoo.cache_axes``/
``input_specs`` and ``launch/steps``' state and cache specs) against the
JAX package's, in this process and with no process group.

For every arch x shape x production mesh (16x16 ``("data", "model")``
and 2x16x16 ``("pod", "data", "model")``, each given as a duck carrying
``axis_names`` and ``devices``, all the reference's rules read), the
rule table, the cell's rules and parallelism defaults, whether the cell
is skipped and why, every parameter's partition spec, the cache's
logical axes, the inputs' shapes, dtypes and specs, and the cache's and
the train state's, must be the reference's.  The reference's
``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported, so its two
planning functions are read from its source and run here without
importing it.

Each kernel wrapper on the model path must take its fake route on fake
CUDA tensors (a ``FakeTensorMode``'s, as the dry run traces): outputs
of the plain version's shapes and dtypes, the plain version's counted
work, and no launch.
"""
import ast
import dataclasses
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.launch.sharding as J_SH
import repro.launch.steps as J_STEPS
from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import get_config as j_get_config
from repro.configs import get_shape as j_get_shape
from repro.models import model_zoo as J_ZOO
from repro.optim import adamw as j_adamw
from repro_torch import kernels as K
from repro_torch.configs import ARCH_IDS, SHAPES, MVStoreConfig, get_config
from repro_torch.configs import get_shape
from repro_torch.kernels import _lib
from repro_torch.kernels import commit_fused as CF
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_adamw as FW
from repro_torch.kernels import snapshot_select as SN
from repro_torch.kernels import ssd_scan as SS
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.sharding import leaves_with_path
from repro_torch.models import model_zoo as ZOO
from repro_torch.optim import adamw

REF_DRYRUN = Path(J_SH.__file__).with_name("dryrun.py")

MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
}


def _reference_planning():
    """``default_parallel`` and ``cell_rules`` of the reference's dry run,
    compiled from its source in a namespace of their imports."""
    tree = ast.parse(REF_DRYRUN.read_text())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("default_parallel", "cell_rules")]
    ns = {"ParallelConfig": JParallelConfig,
          "default_rules": J_SH.default_rules}
    exec(compile(ast.Module(body=fns, type_ignores=[]), str(REF_DRYRUN),
                 "exec"), ns)
    return ns["default_parallel"], ns["cell_rules"]


J_DEFAULT_PARALLEL, J_CELL_RULES = _reference_planning()


def _duck(mesh):
    shape, axes = MESHES[mesh]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, object))


def _jax_mesh(mesh):
    """A one-device JAX mesh with the production mesh's axis names (a
    ``NamedSharding`` reads only the names)."""
    axes = MESHES[mesh][1]
    return JMesh(np.asarray(jax.devices()[:1]).reshape((1,) * len(axes)),
                 axes)


def _spec(s):
    return tuple(s)


def _jax_leaves(tree, leaf):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)
    return {jax.tree_util.keystr(p): x for p, x in flat}


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_plan_equals_reference(arch, shape, mesh):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    shp, jshp = get_shape(shape), j_get_shape(shape)
    duck = _duck(mesh)
    # the rule table, and whether the cell is skipped (and why)
    assert SH.default_rules(duck).table == J_SH.default_rules(duck).table
    jok, jreason = jcfg.supports_shape(jshp)
    # the reference's reason ends with a pointer to a design document
    # this repository does not hold; the port's stops before it
    assert cfg.supports_shape(shp) == (jok, jreason.split("; see ")[0])
    # the cell's parallelism and rules
    pcfg = DR.default_parallel(cfg, shp, duck)
    jpcfg = J_DEFAULT_PARALLEL(jcfg, jshp, duck)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jpcfg)
    rules = DR.cell_rules(duck, shp, pcfg)
    jrules = J_CELL_RULES(duck, jshp, jpcfg)
    assert rules.table == jrules.table
    # every parameter's partition spec
    got = dict(leaves_with_path(SH.param_specs(ZOO.model_meta(cfg), rules)))
    want = _jax_leaves(J_SH.param_specs(J_ZOO.model_meta(jcfg), jrules),
                       lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert sorted(got) == sorted(want)
    assert {p: s for p, s in got.items()} == \
        {p: _spec(s) for p, s in want.items()}
    # the cache's logical axes and the inputs
    assert ZOO.cache_axes(cfg) == J_ZOO.cache_axes(jcfg)
    jm = _jax_mesh(mesh)
    ins = ZOO.input_specs(cfg, shp, rules, duck)
    jins = J_ZOO.input_specs(jcfg, jshp, jrules, jm)
    assert sorted(ins) == sorted(jins)
    for name, t in ins.items():
        j = jins[name]
        assert t.shape == tuple(j.shape), name
        assert _dtype_name(t.dtype) == str(j.dtype), name
        assert t.spec == _spec(j.sharding.spec), name
    bs, jbs = ZOO.batch_shapes(cfg, shp), J_ZOO.batch_shapes(jcfg, jshp)
    assert {k: (s, _dtype_name(d), a) for k, (s, d, a) in bs.items()} == \
        {k: (s, str(jnp.dtype(d)), a) for k, (s, d, a) in jbs.items()}
    # the decode cache's shapes, dtypes and specs
    if shp.kind == "decode":
        cs = dict(leaves_with_path(STEPS.cache_specs(cfg, shp, rules)))
        jcs = _jax_leaves(J_STEPS.cache_specs(jcfg, jshp, jrules, jm), None)
        assert sorted(cs) == sorted(jcs)
        for p, t in cs.items():
            assert (t.shape, _dtype_name(t.dtype), t.spec) == \
                (tuple(jcs[p].shape), str(jcs[p].dtype),
                 _spec(jcs[p].sharding.spec)), p


@pytest.mark.parametrize("mv_mode", ["Q", "U"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_specs_equal_reference(arch, mv_mode):
    """Parameters, moments, rings and their timestamps: shapes, dtypes
    and specs (on the pod mesh's train_4k rules), as the reference's
    ``train_state_specs``."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    duck, jm = _duck("pod"), _jax_mesh("pod")
    rules = DR.cell_rules(duck, get_shape("train_4k"),
                          DR.default_parallel(cfg, get_shape("train_4k"),
                                              duck))
    jrules = J_CELL_RULES(duck, j_get_shape("train_4k"), J_DEFAULT_PARALLEL(
        jcfg, j_get_shape("train_4k"), duck))
    mv = MVStoreConfig(enabled=True, mode=mv_mode)
    from repro.configs import MVStoreConfig as JMV
    st = STEPS.train_state_specs(cfg, mv, rules, duck, adamw.AdamWConfig())
    jst = J_STEPS.train_state_specs(jcfg, JMV(enabled=True, mode=mv_mode),
                                    jrules, jm, j_adamw.AdamWConfig())

    def flat(tree):
        return dict(leaves_with_path(tree))

    def jflat(tree):
        return _jax_leaves(tree, None)

    for got, want in ((flat(st.mv.live), jflat(jst.mv.live)),
                      (flat(st.opt.mu), jflat(jst.opt.mu)),
                      (st.mv.ring, jst.mv.ring),
                      (st.mv.ring_ts, jst.mv.ring_ts)):
        assert sorted(got) == sorted(want)
        for p, t in got.items():
            w = want[p]
            assert (t.shape, _dtype_name(t.dtype), t.spec) == \
                (tuple(w.shape), str(w.dtype), _spec(w.sharding.spec)), p
    assert sorted(st.mv.block_clocks) == sorted(jst.mv.block_clocks)


# ---------------------------------------------------------------------------
# placements and the no-rules path
# ---------------------------------------------------------------------------


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    pod = _duck("multipod")
    rules = SH.default_rules(pod)
    # batch over pod and data (pod first), the vocab over model
    assert SH.placements(rules.spec(("batch", None, "vocab")), pod) == \
        (Shard(0), Shard(0), Shard(2))
    assert SH.placements(rules.spec(("fsdp", "tp")), pod) == \
        (Replicate(), Shard(0), Shard(1))
    # a mesh dim of size 1 replicates whatever the spec says
    one = types.SimpleNamespace(axis_names=("data", "model"),
                                devices=np.empty((1, 1), object))
    assert SH.placements(SH.default_rules(one).spec(("batch", "tp")),
                         one) == (Replicate(), Replicate())


def test_no_rules_leaves_tensors_alone():
    x = torch.arange(6.0).reshape(2, 3)
    assert SH.current_rules() is None and SH.current_mesh() is None
    assert SH.shard_act(x, ("batch", None)) is x
    with SH.use_rules(SH.default_rules(_duck("pod")), None):
        assert SH.shard_act(x, ("batch", None)) is x      # not a DTensor
        assert SH.local_call(lambda t: t + 1, (x,), (("batch", None),),
                             ("batch", None), (2, 3)).equal(x + 1)
    assert SH.current_rules() is None


# ---------------------------------------------------------------------------
# the kernels' fake route
# ---------------------------------------------------------------------------


def _cases():
    g = torch.Generator().manual_seed(0)

    def r(*s, dt=torch.float32):
        return torch.randn(*s, generator=g).to(dt)

    B, S, H, KV, D = 2, 64, 4, 2, 16
    q, k, v = r(B, S, H, D, dt=torch.bfloat16), \
        r(B, S, KV, D, dt=torch.bfloat16), r(B, S, KV, D, dt=torch.bfloat16)
    Hs, P, N = 4, 8, 16
    xh, dt_ = r(B, S, Hs, P, dt=torch.bfloat16), torch.rand(B, S, Hs,
                                                            generator=g)
    A, Bm, Cm = -torch.rand(Hs, generator=g), r(B, S, N, dt=torch.bfloat16), \
        r(B, S, N, dt=torch.bfloat16)
    p, gr = r(64, 32, dt=torch.bfloat16), r(64, 32, dt=torch.bfloat16)
    m, vv = r(64, 32).abs(), r(64, 32).abs()
    ring = torch.zeros(2, 64, 32, dtype=torch.bfloat16)
    scal = torch.tensor([1e-3, 1.0, 0.1, 0.05])
    ts = torch.tensor([3, 5], dtype=torch.int32)
    heap = torch.arange(256, dtype=torch.int32)
    hring = torch.zeros(2, 256, dtype=torch.int32)
    hts = torch.tensor([0, -1], dtype=torch.int32)
    addrs, vals = np.array([3, 17, 200]), np.array([7, 8, 9])
    z, one = np.zeros(0, np.int64), np.zeros(1, np.int64)
    return {
        "flash_attention": (FA, lambda q, k, v: FA.flash_attention(
            q, k, v, causal=True), (q, k, v)),
        "ssd_scan": (SS, lambda xh, dt, A, Bm, Cm: SS.ssd_scan(
            xh, dt, A, Bm, Cm, chunk=32), (xh, dt_, A, Bm, Cm)),
        "fused_adamw": (FW, lambda p, g, m, v, ring, s: FW.fused_adamw(
            p, g, m, v, ring, 1, s, b1=0.9, b2=0.95, eps=1e-8, wd=0.1),
            (p, gr, m, vv, ring, scal)),
        "snapshot_select": (SN, lambda ring, ts: SN.snapshot_select(
            ring, ts, 4), (ring, ts)),
        "commit_fused": (CF, lambda heap, ring, ts: CF.commit_fused(
            heap, addrs, vals, np.zeros(3, np.int64), z, z, z, z, z, one,
            one, 1, 1, out_of_place=True, ring=ring, ring_ts=ts,
            ring_slot=1), (heap, hring, hts)),
    }


def _flat(out):
    return [t for t in (out if isinstance(out, tuple) else (out,))
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("name", sorted(_cases()))
def test_fake_route_matches_plain(name):
    mod, call, args = _cases()[name]
    with RL.count(device="cpu") as plain_rec:
        want = call(*(a.clone() for a in args))
    K.reset_launch_counts()
    with FakeTensorMode():
        fake = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                    device="cuda") for a in args]
        assert all(_lib.device_kind(a) == "fake" for a in fake)
        with RL.count(device="cuda") as fake_rec:
            got = call(*fake)
    assert K.launch_counts()[name] == 0
    got, want = _flat(got), _flat(want)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "cuda" for t in got)
    assert fake_rec.kernels[name] == plain_rec.kernels[name]


def test_fake_cpu_tensor_takes_the_plain_route():
    fm = FakeTensorMode()
    with fm:
        q = torch.empty(1, 8, 2, 16)
        assert _lib.device_kind(q) == "cpu"
        o = FA.flash_attention(q, q[:, :, :1], q[:, :, :1], causal=True)
    assert o.shape == q.shape
