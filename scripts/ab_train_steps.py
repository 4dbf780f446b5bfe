#!/usr/bin/env python3
"""Compare the trainer's step time of two checkouts on one GPU, in turns
(A, B, B, A for each arch), each turn a process of its own.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/ab_train_steps.py build/parent .

A turn builds its checkout's kernels, makes ``launch.train.Trainer`` over
the arch at full width and depth (qwen2.5-3b, then mamba2-780m; 4 x 512
tokens, Mode U with the fused commit, a 2-slot ring, seed 0) and times
10 steps, each until its loss is read.  It prints one JSON line a turn:
the median of steps 3-10 and every step's seconds.  Needs a CUDA card
and ``nvcc``; about 25 s a turn.
"""
import json
import os
import subprocess
import sys

ARCHS = ("qwen2.5-3b", "mamba2-780m")
STEPS = 10

TURN = r'''
import json, sys, time
import numpy as np
from repro_torch.configs import MVStoreConfig, ShapeConfig, get_config
from repro_torch.kernels import _lib
from repro_torch.launch.train import Trainer
from repro_torch.optim import adamw

_lib.library()
tr = Trainer(get_config(sys.argv[1]), ShapeConfig("t", 512, 4, "train"),
             mvcfg=MVStoreConfig(mode="U", fused_commit=True),
             opt_cfg=adamw.AdamWConfig(warmup_steps=10), seed=0)
state, tr.state = tr.state, None
ts = []
for i in range(int(sys.argv[2])):
    t0 = time.perf_counter()
    state, m = tr.train_step(state, tr.batch_at(i))
    float(m["loss"])
    ts.append(time.perf_counter() - t0)
tr.controller.stop()
print(json.dumps({"p50": float(np.median(ts[2:])), "steps": ts}))
'''


def main(a: str, b: str) -> None:
    for arch in ARCHS:
        for tree in (a, b, b, a):
            root = os.path.abspath(tree)
            env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
            r = subprocess.run([sys.executable, "-c", TURN, arch,
                                str(STEPS)], cwd=root, env=env,
                               capture_output=True, text=True, check=True)
            row = json.loads(r.stdout.strip().splitlines()[-1])
            print(json.dumps({"arch": arch, "tree": tree, **row}),
                  flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
