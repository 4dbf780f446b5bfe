"""End-to-end driver: train an LM with the full framework stack.

Uses the real substrate: config registry, MVStore parameter store, AdamW,
deterministic data pipeline, fault-tolerant supervisor with snapshot-
consistent async checkpoints.  Default is a CPU-friendly reduced config;
``--full`` selects the real arch (qwen2.5-3b: 3,397,627,904 parameters).
Runs on the card unless ``--device cpu`` says otherwise:

    python -m repro_torch.examples.train_lm --steps 100
    python -m repro_torch.examples.train_lm --arch mamba2-780m \\
        --steps 50 --inject-failure-at 30     # kill a node mid-run
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 4 \\
        --device cpu

A full-width run checkpoints every 20 steps (``launch.train``'s
``--ckpt-every``), ~40 GB of ``.npy`` for qwen2.5-3b: keep ``--full``
runs below 20 steps unless the disk holds that.
"""
import argparse

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (accelerator hosts)")
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    argv = ["--arch", args.arch, "--steps", str(args.steps),
            "--seq", "64", "--batch", "8",
            "--inject-failure-at", str(args.inject_failure_at)]
    if not args.full:
        argv.append("--smoke")
    argv += ["--device", args.device]
    raise SystemExit(train_main(argv))


if __name__ == "__main__":
    main()
