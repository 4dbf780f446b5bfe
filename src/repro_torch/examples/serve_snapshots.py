"""The paper's scenario at pod scale: SERVE from a model that is TRAINING.

A trainer commits optimizer steps into the MVStore while a server thread
answers generation requests from consistent parameter snapshots.  In Mode
Q the server's reads abort whenever training commits first (watch the
abort counter); once the store versions parameters (Mode U ring), every
request is served from the newest committed snapshot without ever pausing
training — the long-running-read guarantee of Multiverse.

The server rides the ``repro.serve`` continuous-batching scheduler: all
requests are submitted up front, the pump loop keeps the slot pool full
(a freed slot is re-prefilled immediately while the other slots keep
decoding), and each request records the snapshot clocks it was actually
served at.  The final line prints the serving counters in the normalized
TM stats schema — snapshot-read retries show up as ``aborts``.

    python -m repro_torch.examples.serve_snapshots --steps 30
    PYTHONPATH=src python -m repro_torch.examples.serve_snapshots \
        --steps 4 --requests 2 --device cpu

Both threads issue on the default stream, the port's one-stream rule.
Unlike the reference's functional ring, the port refreshes a ring slot
in place behind a seqlock, so a server read that a fast trainer
overtakes in a 2-slot ring retries; those retries are the printed
``aborts``, as in the reference.

(For the word-granularity spelling of the same begin/commit vocabulary —
and a store-level handle that speaks it too — see `repro_torch.api` and
`repro_torch.examples.quickstart`; `make_tm("mvstore", ...)` runs this
pattern as literal read-only transactions.)
"""
import argparse
import threading
import time

import numpy as np

from repro_torch.configs import MVStoreConfig, ShapeConfig, smoke_config
from repro_torch.core import mvcontroller
from repro_torch.core.engine import resolve_device
from repro_torch.launch.serve import Server
from repro_torch.launch.train import Trainer
from repro_torch.serve import Outcome


def main(argv=None):
    """Runs the scenario; returns the requests, the trainer's clock
    before its first step and after each step (``clocks``), the last
    step's loss, the server's stats and its snapshot-read retries."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(args.arch)
    shape = ShapeConfig("t", 32, 2, "train")
    controller = mvcontroller.MVController(
        mvcfg=MVStoreConfig(ring_slots=2, mode="U"))
    trainer = Trainer(cfg, shape, mvcfg=MVStoreConfig(mode="U"),
                      controller=controller, device=dev)
    server = Server(cfg, batch=2, prompt_len=16, max_len=32,
                    mvcfg=MVStoreConfig(mode="U"), controller=controller,
                    mv_state=trainer.state.mv, device=dev)

    rng = np.random.default_rng(0)
    reqs = [server.submit(rng.integers(0, cfg.vocab_size, size=(16,),
                                       dtype=np.int32), max_new=8)
            for _ in range(args.requests)]
    stop = threading.Event()

    def serve_loop():
        reported = set()
        while not stop.is_set() and any(
                r.outcome is Outcome.PENDING for r in reqs):
            server.mv_state = trainer.state.mv       # follow the trainer
            if not server.pump():
                time.sleep(1e-4)
            for r in reqs:
                if r.outcome is Outcome.COMPLETED and r.rid not in reported:
                    reported.add(r.rid)
                    print(f"  [server] request {r.rid} generated "
                          f"{len(r.tokens)} tokens at clocks "
                          f"{r.served_clocks[0]}..{r.served_clocks[-1]} "
                          f"(aborts so far: {server.aborts})", flush=True)

    th = threading.Thread(target=serve_loop)
    th.start()
    state = trainer.state
    clocks = [int(state.mv.clock)]
    metrics = {}
    try:
        for s in range(args.steps):
            state, metrics = trainer.train_step(state, trainer.batch_at(s))
            trainer.state = state
            clocks.append(int(state.mv.clock))
            if (s + 1) % 10 == 0:
                print(f"[trainer] step {s+1} "
                      f"loss={float(metrics['loss']):.4f}"
                      f" clock={int(state.mv.clock)} "
                      f"rings={len(state.mv.ring)}", flush=True)
        th.join(timeout=120.0)
    finally:
        stop.set()
        th.join()
        controller.stop()
    done = sum(r.outcome is Outcome.COMPLETED for r in reqs)
    m = server.metrics
    print(f"done: {args.steps} training steps interleaved with {done} "
          f"served requests; p50={m.latency.percentile(50) * 1e3:.0f}ms "
          f"p99={m.latency.percentile(99) * 1e3:.0f}ms "
          f"occupancy={m.occupancy:.2f}")
    stats = server.stats()
    print(f"stats: {stats}")
    return {"requests": reqs, "clocks": clocks,
            "loss": float(metrics["loss"]) if metrics else None,
            "stats": stats, "aborts": server.aborts}


if __name__ == "__main__":
    main()
