"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake ranks.

The reference lowers and compiles each cell's step for 512 fake CPU
devices.  The port traces it: the production mesh is a ``DeviceMesh``
over a fake process group of 512 ranks (``launch/mesh.
make_production_mesh``), this process being rank 0; the state and the
inputs are DTensors laid out by the cell's rules, whose local pieces are
``FakeTensor``s on the card's device type (``sharding.abstract``); the
step runs eagerly under a ``FakeTensorMode``, so every operation
propagates shapes and allocates nothing, and the hand-written kernels
take their fake route (``kernels/_lib.device_kind``).  No card is
touched.  ``launch.roofline.count(memory=True)`` watches the trace:

1. FIT (the deliverable): the full production config, traced once.
   The trace's largest live set is rank 0's peak (``memory``); its
   counts are rank 0's flops, bytes and collectives for the whole step
   (eager counting sees every operation, where XLA's cost analysis
   counts a loop body once), and ``roofline`` is priced from them for
   the H100 80GB HBM3 at 700 W (``roofline.roofline_terms``).

2. PROBES (``--probes``, single-pod): the reference's reconstruction,
   from 1- and 2-period traces (and 1 and 2 microbatches), by the same
   algebra:
     train:    P(g, m) = S(g) + m*F(g);  S, F linear in layer groups g
     prefill:  P(g)    linear in g  (jamba: quadratic-in-seq fit;
                                     mamba2: linear-in-seq scale)
     decode:   P(g)    linear in g
   Here it rebuilds the fit trace's own totals (exactly, where the step
   is linear in g and m), in the time of four small traces.

Rows go to ``--out`` as JSONL, with the reference's keys
(``launch/roofline_report.py`` reads them).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out build/dryrun.jsonl --jobs 8

On a CPU-only build of torch a fake CUDA tensor cannot take a gradient:
give ``--device cpu`` there (fake CPU tensors, a CPU mesh).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, MVStoreConfig,
                                 ParallelConfig, get_config, get_shape)
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import abstract, default_rules
from repro_torch.launch.steps import (cache_specs, make_decode_step,
                                      make_prefill_step, make_train_step,
                                      train_state_specs)
from repro_torch.models import model_zoo as zoo
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw


def default_parallel(cfg, shape, mesh, overrides=None) -> ParallelConfig:
    """Per-cell parallelism defaults (the reference's, sized for its
    16 GB chips; the hillclimb overrides these)."""
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    data_ways = axes.get("data", 1) * axes.get("pod", 1)
    kw = {}
    if shape.kind == "train":
        tokens_per_chip = shape.global_batch * shape.seq_len // max(
            data_ways, 1)
        # wide residual streams need smaller microbatches to fit
        mb_tokens = 4096 if cfg.d_model >= 8192 else 8192
        kw["microbatches"] = max(1, min(shape.global_batch // data_ways,
                                        tokens_per_chip // mb_tokens))
        kw["remat"] = "block"
        # two-level remat when the per-period residual saves exceed ~4GB
        periods = cfg.n_layers // (tfm.layer_period(cfg)
                                   if not cfg.is_encdec else cfg.n_layers)
        if not cfg.is_encdec:
            per_mb_tok = tokens_per_chip // kw["microbatches"]
            save_bytes = periods * per_mb_tok * cfg.d_model * 2
            if save_bytes > 4e9:
                for k in (2, 4, 8):
                    if periods % k == 0 and save_bytes / k <= 4e9:
                        kw["remat"] = f"group:{k}"
                        break
                else:
                    ks = [k for k in (2, 4, 8) if periods % k == 0]
                    if ks:
                        kw["remat"] = f"group:{ks[-1]}"
    else:
        kw["microbatches"] = 1
        kw["remat"] = "none"
    if shape.kind == "decode" and shape.seq_len >= 262144:
        kw["decode_attn_chunk"] = 8192
    if overrides:
        kw.update(overrides)
    return ParallelConfig(**kw)


def cell_rules(mesh, shape, pcfg, global_batch=None, rules_override=None):
    gb = global_batch if global_batch is not None else shape.global_batch
    ways = 1
    for ax in ("data", "pod"):
        if ax in mesh.axis_names:
            ways *= mesh.devices.shape[mesh.axis_names.index(ax)]
    rules = default_rules(mesh, fsdp=pcfg.fsdp,
                          shard_seq=shape.global_batch == 1)
    if gb % ways != 0:
        rules = rules.with_(batch=None)
    if rules_override:
        rules = rules.with_(**{
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in rules_override.items()})
    return rules


def _storages(tree) -> dict:
    """storage -> bytes of the tensors (DTensors: their local pieces) in
    ``tree``."""
    from torch.utils._pytree import tree_flatten
    from repro_torch.launch.sharding import is_dtensor

    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            if is_dtensor(t):
                t = t.to_local()
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


_PATCHED: list = []


def fake_mode():
    """A ``FakeTensorMode`` to trace a sharded step in.  DTensor works
    out a strided shard's local size on a small index tensor and reads
    it back (``_StridedShard.local_shard_size_and_offset``, where the
    torch build has it); under a fake mode that tensor is fake and the
    read raises, so that helper is made (once) to run with the fake mode
    set aside: it computes on host integers alone."""
    from torch._subclasses.fake_tensor import (FakeTensorMode,
                                               unset_fake_temporarily)
    if not _PATCHED:
        try:
            from torch.distributed.tensor.placement_types import \
                _StridedShard
        except ImportError:
            _StridedShard = None
        fn = getattr(_StridedShard, "local_shard_size_and_offset", None)
        if fn is not None:
            def real(*args, **kwargs):
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            _StridedShard.local_shard_size_and_offset = real
        _PATCHED.append(True)
    return FakeTensorMode()


def compile_once(cfg, shape, mesh, pcfg, mvcfg, opt_cfg, rules):
    """Trace one step of the cell on fake tensors (the reference's lower
    + compile); returns ``(record, memory, timings)``: the
    ``roofline.count`` record (rank 0's counts), the ``memory`` dict
    under the reference's keys, and the trace's seconds."""
    dev = mesh.device_mesh.device_type
    t0 = time.time()
    with fake_mode(), roofline.count(device=dev, memory=True) as rec:
        if shape.kind == "train":
            step = make_train_step(cfg, pcfg, mvcfg, opt_cfg, rules, mesh)
            state = abstract(train_state_specs(cfg, mvcfg, rules, mesh,
                                               opt_cfg), mesh)
            args = (state, abstract(zoo.input_specs(cfg, shape, rules,
                                                    mesh), mesh))
        elif shape.kind == "prefill":
            step = make_prefill_step(cfg, pcfg, mvcfg, rules, mesh)
            state = abstract(train_state_specs(cfg, mvcfg, rules, mesh,
                                               opt_cfg).mv, mesh)
            batch = abstract(zoo.input_specs(cfg, shape, rules, mesh), mesh)
            args = (state, batch, 0)
        else:  # decode
            step = make_decode_step(cfg, pcfg, mvcfg, rules, mesh)
            state = abstract(train_state_specs(cfg, mvcfg, rules, mesh,
                                               opt_cfg).mv, mesh)
            cache = abstract(cache_specs(cfg, shape, rules, mesh), mesh)
            inp = abstract(zoo.input_specs(cfg, shape, rules, mesh), mesh)
            args = (state, cache, inp["cache_len"], inp["token"], 0)
        arg_bytes = rec.live_bytes
        ins = _storages(args)
        out = step(*args)
        outs = _storages(out)
        del args, state, out
    output = sum(n for k, n in outs.items() if k not in ins)
    alias = sum(n for k, n in outs.items() if k in ins)
    peak = rec.peak_bytes
    memory = {"argument_bytes": arg_bytes, "output_bytes": output,
              "temp_bytes": peak - arg_bytes - output + alias,
              "alias_bytes": alias, "peak_bytes_per_device": peak}
    t = time.time() - t0
    return rec, memory, {"lower_s": round(t, 1), "compile_s": 0.0,
                         "trace_s": t}


_NUM_KEYS = ("flops", "bytes", "tpu_bytes", "wire_bytes",
             "coll_result_bytes")


def _metrics(rec):
    """Rank 0's totals from a trace's record, under the reference's keys
    (``tpu_bytes``: the HBM bytes, ``roofline.hbm_bytes_model``)."""
    coll = roofline.collective_bytes(rec)
    return {
        "flops": float(rec.flops),
        "bytes": float(rec.bytes),
        "tpu_bytes": float(roofline.hbm_bytes_model(rec)["hbm_bytes"]),
        "wire_bytes": float(coll["total_wire_bytes"]),
        "coll_result_bytes": float(coll["total_result_bytes"]),
        "coll_ops": coll["ops"],
        "coll_top": coll["top"],
    }


def _probe_cfgs(cfg):
    period = tfm.layer_period(cfg) if not cfg.is_encdec else 1

    def reduced(g):
        kw = {"n_layers": g * period}
        if cfg.is_encdec:
            kw["n_encoder_layers"] = g
        return dataclasses.replace(cfg, **kw)

    return reduced


def run_probes(arch, shape_name, *, mv_mode, overrides,
               rules_override=None, cfg=None, shape=None, mesh=None):
    """Roofline probes on the single-pod mesh (or ``mesh``; ``cfg`` and
    ``shape`` stand in for the registry's); returns the reconstructed
    per-device metrics + the probe ledger."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    mesh = mesh or make_production_mesh(multi_pod=False)
    pcfg0 = default_parallel(cfg, shape, mesh, overrides)
    mvcfg = MVStoreConfig(enabled=True, mode=mv_mode)
    opt_cfg = adamw.AdamWConfig()
    reduced = _probe_cfgs(cfg)
    G = (cfg.n_layers // tfm.layer_period(cfg)) if not cfg.is_encdec \
        else cfg.n_layers
    M = pcfg0.microbatches
    ledger = []

    def probe(g, m=1, seq=None):
        cfg_g = reduced(g)
        gb = shape.global_batch
        sq = shape.seq_len
        if shape.kind == "train":
            gb = m * (shape.global_batch // M)
        if seq is not None:
            sq = seq
        shp = ShapeConfig(shape.name, sq, gb, shape.kind)
        pcfg = dataclasses.replace(pcfg0, microbatches=m, probe_unroll=True,
                                   scan_layers=False)
        rules = cell_rules(mesh, shape, pcfg, global_batch=gb,
                           rules_override=rules_override)
        rec, _, t = compile_once(cfg_g, shp, mesh, pcfg, mvcfg, opt_cfg,
                                 rules)
        met = _metrics(rec)
        ledger.append({"g": g, "m": m, "seq": sq, "batch": gb, **t,
                       **{k: met[k] for k in ("flops", "bytes", "tpu_bytes",
                                              "wire_bytes")}})
        return met

    ssm_prefill = (cfg.family in ("ssm", "hybrid")
                   and shape.kind == "prefill")
    if shape.kind == "train":
        p11, p21 = probe(1, 1), probe(2, 1)
        p12, p22 = probe(1, 2), probe(2, 2)
        F1 = {k: p12[k] - p11[k] for k in _NUM_KEYS}
        F2 = {k: p22[k] - p21[k] for k in _NUM_KEYS}
        S1 = {k: 2 * p11[k] - p12[k] for k in _NUM_KEYS}
        S2 = {k: 2 * p21[k] - p22[k] for k in _NUM_KEYS}
        total = {k: S1[k] + (G - 1) * (S2[k] - S1[k])
                 + M * (F1[k] + (G - 1) * (F2[k] - F1[k]))
                 for k in _NUM_KEYS}
    elif ssm_prefill and cfg.family == "ssm":
        s1 = 4096
        p1, p2 = probe(1, seq=s1), probe(2, seq=s1)
        scale = shape.seq_len / s1
        total = {k: scale * (p1[k] + (G - 1) * (p2[k] - p1[k]))
                 for k in _NUM_KEYS}
    elif ssm_prefill:  # hybrid: quadratic-in-seq fit (attention layers)
        s1, s2, st = 4096, 8192, shape.seq_len

        def fit(pa, pb):
            out = {}
            for k in _NUM_KEYS:
                c2 = (pb[k] - 2 * pa[k]) / (2.0 * s1 * s1)
                b1 = (4 * pa[k] - pb[k]) / (2.0 * s1)
                out[k] = b1 * st + c2 * st * st
            return out

        q1 = fit(probe(1, seq=s1), probe(1, seq=s2))
        q2 = fit(probe(2, seq=s1), probe(2, seq=s2))
        total = {k: q1[k] + (G - 1) * (q2[k] - q1[k]) for k in _NUM_KEYS}
    else:
        p1, p2 = probe(1), probe(2)
        total = {k: p1[k] + (G - 1) * (p2[k] - p1[k]) for k in _NUM_KEYS}
    total = {k: max(v, 0.0) for k, v in total.items()}
    return total, ledger


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               mv_mode: str = "Q", overrides=None, probes: bool = False,
               rules_override=None, device_type: str = "cuda"):
    """Fit-trace one cell (+ optional roofline probes); result dict."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = cfg.supports_shape(shape)
    mesh_name = "multipod" if multi_pod else "pod"
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "mv_mode": mv_mode, "status": "skipped", "reason": reason}

    mesh = make_production_mesh(multi_pod=multi_pod,
                                device_type=device_type)
    pcfg = default_parallel(cfg, shape, mesh, overrides)
    rules = cell_rules(mesh, shape, pcfg, rules_override=rules_override)
    mvcfg = MVStoreConfig(enabled=True, mode=mv_mode)
    opt_cfg = adamw.AdamWConfig()

    rec, memory, times = compile_once(cfg, shape, mesh, pcfg, mvcfg,
                                      opt_cfg, rules)
    fit_metrics = _metrics(rec)
    n_chips = mesh.devices.size

    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mv_mode": mv_mode, "status": "ok", "n_chips": n_chips,
        "microbatches": pcfg.microbatches, "remat": pcfg.remat,
        "overrides": overrides or {},
        "rules_override": rules_override or {},
        **times,
        "memory": memory,
        # the whole step's counts (the reference's scanned artifact
        # counted each loop body once; an eager trace counts them all)
        "fit_metrics_scanned": {k: fit_metrics[k]
                                for k in ("flops", "bytes", "wire_bytes")},
        "collective_ops": fit_metrics["coll_ops"],
        "roofline": roofline.roofline_terms(
            cfg, shape, cost={"flops": fit_metrics["flops"],
                              "bytes accessed": fit_metrics["tpu_bytes"]},
            collectives={"total_wire_bytes": fit_metrics["wire_bytes"]},
            n_chips=n_chips),
    }
    if probes and not multi_pod:
        recon, ledger = run_probes(arch, shape_name, mv_mode=mv_mode,
                                   overrides=overrides,
                                   rules_override=rules_override)
        result["probe_metrics"] = recon
        result["probe_ledger"] = ledger
    return result


def _run_cell(job):
    """One cell, its error recorded (a worker of ``--jobs``)."""
    arch, shape, m, kw = job
    try:
        return lower_cell(arch, shape, multi_pod=(m == "multipod"), **kw)
    except Exception as e:  # noqa: BLE001 — record, keep sweeping
        return {"arch": arch, "shape": shape, "mesh": m,
                "mv_mode": kw.get("mv_mode", "Q"), "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--mvmode", default="Q", choices=["Q", "U"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--probes", action="store_true",
                    help="run roofline probes (single-pod cells only)")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ParallelConfig overrides")
    ap.add_argument("--rules-override", default=None,
                    help="JSON dict of logical-axis rule overrides, e.g. "
                         "'{\"tp\": null}' for no tensor parallelism")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type the fake ranks' tensors claim "
                         "(cpu on a CPU-only build of torch)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    kw = {"mv_mode": args.mvmode, "probes": args.probes,
          "overrides": json.loads(args.override) if args.override
          else None,
          "rules_override": (json.loads(args.rules_override)
                             if args.rules_override else None),
          "device_type": args.device}
    # the pod mesh first for every cell, then the multi-pod's train_4k;
    # within each, the longest traces (train, the deepest and widest
    # models) start first, so that ``--jobs`` workers end together
    def order(cell):
        a, s, m, _ = cell
        cfg = get_config(a)
        return (m != "pod", not (m == "pod" or s == "train_4k"),
                s != "train_4k", -cfg.n_layers * cfg.d_model)

    cells = sorted(((a, s, m, kw) for m in meshes for a in archs
                    for s in shapes), key=order)

    if args.jobs > 1:
        import multiprocessing as mp
        pool = mp.get_context("spawn").Pool(args.jobs, maxtasksperchild=1)
        results = pool.imap(_run_cell, cells)
    else:
        pool, results = None, map(_run_cell, cells)
    rc = 0
    try:
        for res in results:
            rc |= res["status"] == "error"
            line = json.dumps(res)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            brief = {k: v for k, v in res.items()
                     if k not in ("trace", "probe_ledger", "collective_ops")}
            print(json.dumps(brief), flush=True)
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
