#!/usr/bin/env python3
"""Print the top collectives of a one-layer, one-microbatch probe of an
arch's ``train_4k`` step on the fake 16x16 pod (hillclimb diag).

    PYTHONPATH=src python3 scripts/diag_moe_top_torch.py [arch]   # moonshot
    PYTHONPATH=src python3 scripts/diag_moe_top_torch.py qwen2.5-3b \\
        --device cpu

The step is traced on fake ranks (``repro_torch.launch.dryrun``): its
tensors are fake CUDA tensors, and autograd over those needs a CUDA build
of torch and a card's context, so the default runs on the card's machine
and raises without a card; ``--device cpu`` traces fake CPU tensors
instead (a CPU-only build).  Prints rank 0's wire bytes and HBM bytes,
then the ten largest collectives by wire bytes.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import MVStoreConfig, get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import (_metrics, cell_rules, compile_once,
                                       default_parallel)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="moonshot-v1-16b-a3b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type the fake ranks' tensors claim (cuda: "
                         "needs a card; cpu on a CPU-only build of torch)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "trace fake CPU tensors")

    cfg = dataclasses.replace(get_config(args.arch), n_layers=1)
    shape0 = get_shape("train_4k")
    mesh = make_production_mesh(device_type=args.device)
    pcfg0 = default_parallel(cfg, shape0, mesh)
    shape = ShapeConfig("train_4k", 4096,
                        shape0.global_batch // pcfg0.microbatches, "train")
    pcfg = dataclasses.replace(pcfg0, microbatches=1, probe_unroll=True,
                               scan_layers=False)
    rules = cell_rules(mesh, shape, pcfg, global_batch=shape.global_batch)
    rec, _, _ = compile_once(cfg, shape, mesh, pcfg,
                             MVStoreConfig(enabled=True, mode="Q"),
                             adamw.AdamWConfig(), rules)
    m = _metrics(rec)
    print(f"{args.arch} 1L/1mb: wire {m['wire_bytes']/1e9:.3f} GB/chip, "
          f"hbm_bytes {m['tpu_bytes']/1e9:.1f} GB")
    for e in m["coll_top"][:10]:
        print(f"  {e['wire_bytes']/1e9:8.3f} GB {e['kind']:18s} "
              f"g={e['group']:4d} {e['type'][:100]}")
    return m


if __name__ == "__main__":
    main()
