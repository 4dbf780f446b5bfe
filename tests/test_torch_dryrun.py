"""The port's fake-rank dry run (``repro_torch.launch.dryrun``) and
``runtime/elastic.reshard_state``, in two processes of their own, each
read by several tests: a process group lives as long as its process,
and xdist runs other files in the same worker.

On a (4, 2) ``("data", "model")`` CPU mesh of a fake process group, at
``smoke_config`` size (the reference's ``test_small_mesh_dryrun_
subprocess`` cell):
  - train (Mode Q and U) and decode (Mode U) trace to a record, and
    Mode U's flops are at least Mode Q's;
  - for the dense smoke model, rank 0's counted flops times 8 equal the
    unsharded step's, exactly (train, prefill and decode): every product
    is split eight ways and none is computed twice;
  - ``run_probes`` rebuilds the whole trace's totals from 1- and
    2-period traces (a 4-layer model, 2 microbatches), exactly;
  - ``reshard_state`` hands rank 0 the piece of every leaf its partition
    spec gives it, values kept.
On one CPU rank, ``reshard_state`` keeps every value, and each leaf is
laid out by the spec the reference's ``reshard_state`` gives it.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

PRELUDE = """
import dataclasses, json
import numpy as np
import torch
from repro_torch.configs import MVStoreConfig, ParallelConfig, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models import model_zoo as ZOO
from repro_torch.optim import adamw

CFG = smoke_config("qwen2.5-3b")


def pcfg_of(kind, m=2):
    return ParallelConfig(microbatches=m if kind == "train" else 1,
                          remat="block" if kind == "train" else "none",
                          attn_block_q=32, attn_block_k=32)


def mesh_4x2():
    M.fake_world(8)
    return M.make_rank_mesh((4, 2), ("data", "model"), "cpu")


def trace(cfg, shape, mesh, pcfg, mv):
    rules = DR.cell_rules(mesh, shape, pcfg)
    rec, mem, _ = DR.compile_once(cfg, shape, mesh, pcfg, mv,
                                  adamw.AdamWConfig(), rules)
    return rec, mem


def unsharded_flops(cfg, shape, pcfg, mv):
    # the same step on plain fake CPU tensors, no rules
    from torch._subclasses.fake_tensor import FakeTensorMode
    rules = SH.Rules()
    opt = adamw.AdamWConfig()

    def real(tree):
        if isinstance(tree, SH.TensorSpec):
            return torch.empty(tree.shape, dtype=tree.dtype)
        if isinstance(tree, dict):
            return {k: real(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(real(v) for v in tree))
        return tree

    with FakeTensorMode(), RL.count(device="cpu") as rec:
        st = real(ST.train_state_specs(cfg, mv, rules, None, opt))
        inp = real(ZOO.input_specs(cfg, shape, rules))
        if shape.kind == "train":
            ST.make_train_step(cfg, pcfg, mv, opt)(st, inp)
        elif shape.kind == "prefill":
            ST.make_prefill_step(cfg, pcfg, mv)(st.mv, inp, 0)
        else:
            cache = real(ST.cache_specs(cfg, shape, rules))
            ST.make_decode_step(cfg, pcfg, mv)(
                st.mv, cache, inp["cache_len"], inp["token"], 0)
    return rec.flops
"""

#: each process's code: one on the 4 x 2 mesh, one on a single rank
PROGRAMS = {
    "mesh_4x2": """
from repro_torch.runtime.elastic import reshard_state
mesh = mesh_4x2()
out = {"cells": {}, "flops_x8": {}, "probes": {}}
# the reference's small-mesh cells, and rank 0's flops x 8 against the
# unsharded step's
for kind, mv in (("train", "Q"), ("train", "U"), ("prefill", "U"),
                 ("decode", "U")):
    shape = ShapeConfig("t", 64, 8, kind)
    mvc = MVStoreConfig(enabled=True, mode=mv, fused_commit=mv == "U")
    rec, mem = trace(CFG, shape, mesh, pcfg_of(kind), mvc)
    out["cells"][f"{kind}_{mv}"] = {
        "flops": rec.flops, "bytes": rec.bytes,
        "peak": mem["peak_bytes_per_device"],
        "collectives": len(rec.collectives)}
    out["flops_x8"][f"{kind}_{mv}"] = [
        rec.flops * 8, unsharded_flops(CFG, shape, pcfg_of(kind), mvc)]
# the probes' algebra against the whole trace (4 layers, 2 microbatches)
cfg = dataclasses.replace(CFG, n_layers=4)
for kind in ("train", "decode"):
    shape = ShapeConfig("t", 64, 8, kind)
    over = {"microbatches": 2, "attn_block_q": 32, "attn_block_k": 32}
    if kind == "train":
        over["remat"] = "block"
    pcfg = DR.default_parallel(cfg, shape, mesh, over)
    rec, _ = trace(cfg, shape, mesh, pcfg, MVStoreConfig(enabled=True,
                                                         mode="Q"))
    whole = DR._metrics(rec)
    total, ledger = DR.run_probes(None, None, mv_mode="Q", overrides=over,
                                  cfg=cfg, shape=shape, mesh=mesh)
    out["probes"][kind] = {"n": len(ledger), **{
        k: [total[k], whole[k]] for k in DR._NUM_KEYS}}
# rank 0's piece of every leaf, values kept, storage its own
rules = SH.default_rules(mesh)
g = torch.Generator().manual_seed(0)
params = ZOO.init_params(CFG, g, "cpu")
specs = SH.param_specs(ZOO.model_meta(CFG), rules)
moved = reshard_state(params, mesh, rules, spec_tree=specs)
bad = []
for (path, x), (_, d), (_, s) in zip(SH.leaves_with_path(params),
                                     SH.leaves_with_path(moved),
                                     SH.leaves_with_path(specs)):
    idx = [slice(None)] * x.dim()
    for dim in range(x.dim()):
        lo, n = SH.local_range(d, dim)
        idx[dim] = slice(lo, lo + n)
    if tuple(d.placements) != SH.placements(s, mesh) or \\
            not torch.equal(d.to_local(), x[tuple(idx)]):
        bad.append(path)
    if d.to_local().untyped_storage().data_ptr() == \\
            x.untyped_storage().data_ptr():
        bad.append(path + " shares storage")
out["reshard"] = {"leaves": len(SH.tree_leaves(params)), "bad": bad}
print(json.dumps(out))
""",
    # one CPU rank against the reference's reshard_state
    "one_rank": """
import jax
from jax.sharding import Mesh as JMesh
from repro.launch import sharding as J_SH
from repro.models import model_zoo as J_ZOO
from repro.configs import smoke_config as j_smoke
from repro.runtime.elastic import reshard_state as j_reshard
from repro_torch.runtime.elastic import reshard_state
M.fake_world(1)
mesh = M.make_rank_mesh((1, 1), ("data", "model"), "cpu")
jmesh = JMesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
jcfg = j_smoke("qwen2.5-3b")
jparams = J_ZOO.init_params(jcfg, jax.random.PRNGKey(0))
jspecs = J_SH.param_specs(J_ZOO.model_meta(jcfg), J_SH.default_rules(jmesh))
jmoved = j_reshard(jparams, jmesh, spec_tree=jspecs)
params = ZOO.params_from_numpy(jax.tree.map(np.asarray, jparams))
specs = SH.param_specs(ZOO.model_meta(CFG), SH.default_rules(mesh))
moved = reshard_state(params, mesh, spec_tree=specs)
flat, _ = jax.tree_util.tree_flatten_with_path(jmoved)
jleaves = {jax.tree_util.keystr(p): x for p, x in flat}
bad = []
for path, d in SH.leaves_with_path(moved):
    j = jleaves[path]
    want = SH.placements(tuple(j.sharding.spec) + (None,) * (
        j.ndim - len(j.sharding.spec)), mesh)
    same = np.array_equal(d.full_tensor().float().numpy(),
                          np.asarray(j, np.float32))
    if tuple(d.placements) != want or not same:
        bad.append(path)
# a plain state with no spec tree lands replicated, values kept
st = {"a": torch.arange(6.0).reshape(2, 3), "clock": 3}
rep = reshard_state(st, mesh)
ok = rep["clock"] == 3 and torch.equal(rep["a"].full_tensor(), st["a"])
print(json.dumps({"reshard": {"leaves": len(jleaves), "bad": bad},
                  "plain_ok": ok}))
""",
}


def _run(program):
    code = PRELUDE + textwrap.dedent(PROGRAMS[program])
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def mesh_4x2():
    return _run("mesh_4x2")


@pytest.fixture(scope="module")
def one_rank():
    return _run("one_rank")


def test_small_mesh_cells(mesh_4x2):
    out = mesh_4x2["cells"]
    assert out["train_Q"]["flops"] > 0 and out["decode_U"]["flops"] > 0
    assert out["train_U"]["flops"] >= out["train_Q"]["flops"]
    # the ring makes Mode U's live set the larger
    assert out["train_U"]["peak"] > out["train_Q"]["peak"] > 0
    assert all(v["collectives"] > 0 for v in out.values())


@pytest.mark.parametrize("cell", ["train_Q", "train_U", "prefill_U",
                                  "decode_U"])
def test_rank0_flops_times_8_equal_unsharded(mesh_4x2, cell):
    sharded, plain = mesh_4x2["flops_x8"][cell]
    assert plain > 0 and sharded == plain


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_probes_rebuild_the_whole_trace(mesh_4x2, kind):
    out = dict(mesh_4x2["probes"][kind])
    assert out.pop("n") == (4 if kind == "train" else 2)
    for k, (rebuilt, whole) in out.items():
        assert rebuilt == whole, k


def test_reshard_state_hands_rank0_its_pieces(mesh_4x2):
    out = mesh_4x2["reshard"]
    assert out["leaves"] > 0 and out["bad"] == []


def test_reshard_state_one_rank_equals_reference(one_rank):
    assert one_rank["reshard"]["leaves"] > 0
    assert one_rank["reshard"]["bad"] == [] and one_rank["plain_ok"]
