"""The sharded steps on real ranks: four CPU processes of a ``gloo``
process group, a (2, 2) ``("data", "model")`` mesh, against the plain
steps each rank also runs, at ``smoke_config`` size in float32.

Each rank makes the same seeded parameters and batches, moves a copy of
the state onto the mesh (``reshard_state`` by ``train_state_specs``'
layout), and takes two Mode-U fused train steps of two microbatches
both ways, then two decode steps of one row, whose cache is split over
'data' by sequence (``seq_shard``: the decode attention's online
softmax across ranks).  Losses, parameters, first moments and decode
logits must agree within 1e-4 (float32; the ranks sum their partial
products in another order than one process does).  A dense model
(qwen2.5-3b: the tied embedding's gather over fsdp, the vocab-parallel
loss) and the hybrid (jamba-v0.1-52b: attention, Mamba-2 and MoE
sub-layers, routing by rank and the aux loss summed across ranks).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-4

PROGRAM = textwrap.dedent("""
    import dataclasses, json, socket, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def run(rank, world, port, arch, out):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        from repro_torch.configs import (MVStoreConfig, ParallelConfig,
                                         smoke_config)
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.core import mvstore
        from repro_torch.launch import sharding as SH
        from repro_torch.launch import steps
        from repro_torch.launch.mesh import make_rank_mesh
        from repro_torch.models import model_zoo as zoo
        from repro_torch.optim import adamw
        from repro_torch.runtime.elastic import reshard_state

        mesh = make_rank_mesh((2, 2), ("data", "model"), "cpu")
        rules = SH.default_rules(mesh)
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        shape = ShapeConfig("t", 32, 4, "train")
        pcfg = ParallelConfig(remat="block", attn_block_q=32,
                              attn_block_k=32, microbatches=2)
        mvcfg = MVStoreConfig(mode="U", fused_commit=True)
        opt = adamw.AdamWConfig(warmup_steps=1)
        g = torch.Generator().manual_seed(0)
        params = zoo.init_params(cfg, g, "cpu")
        plain = steps.TrainState(
            mvstore.mv_init(params, mvcfg, versioned="all"),
            adamw.init(params, opt))
        specs = SH.param_specs(zoo.model_meta(cfg), rules)
        layout = steps.train_state_specs(cfg, mvcfg, rules, mesh, opt)
        sharded = reshard_state(plain, mesh, rules, spec_tree=steps.TrainState(
            mvstore.MVStoreState(
                specs, {k: v.spec for k, v in layout.mv.ring.items()},
                {k: v.spec for k, v in layout.mv.ring_ts.items()}, None,
                None),
            adamw.AdamWState(specs, specs, ())))
        batches = [zoo.concrete_batch(cfg, shape, g) for _ in range(2)]
        ispecs = {k: v.spec for k, v in
                  zoo.input_specs(cfg, shape, rules).items()}
        plain_step = steps.make_train_step(cfg, pcfg, mvcfg, opt)
        sharded_step = steps.make_train_step(cfg, pcfg, mvcfg, opt, rules,
                                             mesh)
        err = {"loss": 0.0, "params": 0.0, "mu": 0.0, "decode": 0.0}
        for b in batches:
            plain, pm = plain_step(plain, b)
            sharded, sm = sharded_step(
                sharded, reshard_state(b, mesh, rules, spec_tree=ispecs))
            err["loss"] = max(err["loss"], abs(
                float(sm["loss"].full_tensor()) - float(pm["loss"])))
        for key, a, b in (("params", plain.mv.live, sharded.mv.live),
                          ("mu", plain.opt.mu, sharded.opt.mu)):
            for (_, x), (_, d) in zip(SH.leaves_with_path(a),
                                      SH.leaves_with_path(b)):
                err[key] = max(err[key], float(
                    (d.full_tensor() - x).abs().max()))
        # decode one row: the cache's sequence split over 'data'
        dshape = ShapeConfig("d", 64, 1, "decode")
        drules = SH.default_rules(mesh, shard_seq=True).with_(batch=None)
        dmv = MVStoreConfig(mode="U")
        dp = ParallelConfig(remat="none")
        _, cache, clen, _ = steps.make_prefill_step(cfg, dp, dmv)(
            plain.mv, {"tokens": batches[0]["tokens"][:1, :16]},
            plain.mv.clock)
        full = zoo.init_cache(cfg, 1, 64, torch.float32)
        for sub, leaves in cache.items():
            for n, t in leaves.items():
                if n in ("k", "v"):
                    full[sub][n][:, :, :t.shape[2]] = t
                else:
                    full[sub][n].copy_(t)
        cspecs = {s: {n: v.spec for n, v in leaves.items()} for s, leaves in
                  steps.cache_specs(cfg, dshape, drules).items()}
        scache = reshard_state(full, mesh, drules, spec_tree=cspecs)
        smv = reshard_state(plain.mv, mesh, drules)
        tok = torch.tensor([5], dtype=torch.int32)
        stok = reshard_state(tok, mesh, drules, spec_tree=(None,))
        scl = reshard_state(clen, mesh, drules, spec_tree=(None,))
        plain_decode = steps.make_decode_step(cfg, dp, dmv)
        sharded_decode = steps.make_decode_step(cfg, dp, dmv, drules, mesh)
        for _ in range(2):
            lp, full, clen, _ = plain_decode(plain.mv, full, clen, tok,
                                             plain.mv.clock)
            ls, scache, scl, _ = sharded_decode(smv, scache, scl, stok,
                                                plain.mv.clock)
            err["decode"] = max(err["decode"], float(
                (ls.full_tensor() - lp).abs().max()))
        if rank == 0:
            with open(out, "w") as f:
                json.dump(err, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(run, args=(4, port, sys.argv[1], sys.argv[2]), nprocs=4)
""")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "jamba-v0.1-52b"])
def test_sharded_steps_on_four_ranks_equal_plain(arch, tmp_path):
    script, out = tmp_path / "ranks.py", tmp_path / "err.json"
    script.write_text(PROGRAM)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script), arch, str(out)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    err = json.loads(out.read_text())
    assert all(v <= TOL for v in err.values()), err
