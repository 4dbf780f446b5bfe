"""Reduced cells for the CPU tests: the program's smoke configurations
with the configuration file's keys filled from them, and short mixes."""
from __future__ import annotations

import copy
import time

from perfbench.harness import common


def config_file(name: str, program_cfg) -> dict:
    """The configuration file ``name`` with every key the width check
    reads set from ``program_cfg`` (and the padded vocabulary)."""
    from repro_torch.models.transformer import VOCAB_PAD_MULTIPLE
    cfg = copy.deepcopy(common.load_json("configs", name))
    for key, attr in cfg["program_fields"].items():
        v = program_cfg
        for a in attr.split("."):
            v = getattr(v, a)
        cfg[key] = v
    cfg["vocab_padded"] = program_cfg.padded_vocab(VOCAB_PAD_MULTIPLE)
    return cfg


def context(cell: str, *, seconds: float = 1.5, seed: int = 2**31 + 7,
            trace: bool = False, mix: dict = None, calibrate: bool = False,
            limits: dict = None) -> common.Context:
    from repro_torch.configs import smoke_config
    wl = copy.deepcopy(common.load_json("workloads", cell))
    if limits:
        wl["limits"].update(limits)
    file_cfg = common.load_json("configs", wl["config"])
    pcfg = smoke_config(file_cfg["program_arch"])
    traffic = copy.deepcopy(common.load_json("traffic", wl["traffic"]))
    traffic.update(mix or {})
    return common.Context(
        cell=cell, seed=seed, seconds=seconds, trace=trace, workload=wl,
        config=config_file(wl["config"], pcfg), traffic=traffic,
        t_process=time.time(), device="cpu", program_config=pcfg,
        calibrate=calibrate)


SERVE_MIX = {"slots": 2, "queued": 4, "gen_tokens": 8,
             "prompt_len": {"min": 16, "max": 32, "step": 8},
             "check": {"requests": 6}}

TRAIN_MIX = {"train": {"rows": 2, "seq": 32}}
