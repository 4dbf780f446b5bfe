"""The program's side of a cell: its configuration held against the
configuration file, its kernels built, its parameter layout."""
from __future__ import annotations

import dataclasses
import gc
from typing import List

import torch

from perfbench.harness.weights import Leaf, parse_path


def program_config(ctx):
    """The program's configuration of the cell: the file's
    ``program_settings`` (keys the program is given, as a user would set
    them) handed to it, then every published key checked against it (any
    difference fails the run)."""
    from repro_torch.configs import get_config
    cfg = ctx.program_config or get_config(ctx.config["program_arch"])
    fields = ctx.config["program_fields"]
    cfg = dataclasses.replace(cfg, **{
        fields[k]: ctx.config[k]
        for k in ctx.config.get("program_settings", [])})
    bad = []
    for key, attr in ctx.config["program_fields"].items():
        v = cfg
        for a in attr.split("."):
            v = getattr(v, a)
        if v != ctx.config[key]:
            bad.append(f"{key}: file {ctx.config[key]!r}, program {v!r}")
    if bad:
        raise ValueError("the program's configuration differs from "
                         f"{ctx.config['name']}: " + "; ".join(bad))
    return cfg


def build_kernels(device: torch.device) -> None:
    """Compile the program's kernels (first run in a checkout) or load
    them."""
    if device.type == "cuda":
        from repro_torch.kernels import _lib
        _lib.build()
        _lib.library()


def leaves(cfg) -> List[Leaf]:
    from repro_torch.launch.sharding import leaves_with_path
    from repro_torch.models import model_zoo
    return [Leaf(parse_path(p), tuple(m.shape), m.dtype, m.init,
                 float(m.scale))
            for p, m in leaves_with_path(model_zoo.model_meta(cfg))]


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def memory_peak(device: torch.device) -> int:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    return 0
