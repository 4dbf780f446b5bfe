"""The serving loop: queue -> continuous-batching scheduler -> metrics.

``SnapshotService`` wires the pieces from this package around a
``SlotExecutor`` and runs either an OPEN loop (requests arrive at
wall-clock times from ``OpenLoopLoadGen`` regardless of service speed —
the honest way to measure tail latency, since a closed loop hides
queueing collapse) or a CLOSED loop (``serve_requests``: offer a fixed
set, drain).  Both end with a graceful drain: the queue closes, slots
finish their in-flight requests, and the summary accounts for every
offered request (completed / shed / failed).

``StoreExecutor`` + ``SyntheticTrainer`` give the store-level scenario
the eval's ``serving`` workload measures: a trainer thread commits
parameter versions into an MVStore every few milliseconds while the
scheduler answers requests from snapshots.  Every committed version
writes CLOCK into every element of every block, so a torn read — a
resolved view mixing versions within one step — is detectable by
inspection (`violations`); serving policies:

  * ``U``     multiverse Mode-U ring: per-request pinned clock served
              from the version ring (one ``snapshot_select`` per block
              and resolve); commits never abort a reader.
  * ``Q``     Mode-Q validation: unversioned live reads validated
              against the clock; a commit since pin => ok=False, the
              request restarts at a fresh clock (abort/retry path).
  * ``live``  unversioned baseline: always reads the live value and
              never aborts — requests silently mix parameter versions
              across steps (reported, not gated).

The store's blocks are int32 tensors on the service's device (the card
unless the caller names another).  The trainer thread and the scheduler
issue on the one default stream, so a commit's copies and a resolve's
launches run in the order the two threads issued them.  A decode
step's resolve blocks on the card once: the torn-read check reduces the
whole view on the device, and its flag comes home in one copy with the
resolve's ``ok``.  A prefill's resolve blocks once, for its ``ok``.

CLI (also ``python -m repro_torch.serve``):

    python -m repro_torch.serve --mode U --duration 2 --target-qps 60
    python -m repro_torch.serve --quick --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import MVStoreConfig
from repro_torch.core import mvstore
from repro_torch.core.engine import resolve_device
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import Admission, Request, RequestQueue
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                         StepResult)

SERVE_POLICIES = ("U", "Q", "live")


@dataclasses.dataclass
class ServiceConfig:
    """Knobs for the synthetic store-serving scenario (CLI/eval both)."""

    mode: str = "U"                   # serving policy: U | Q | live
    n_slots: int = 4
    max_new: int = 12                 # tokens per request (incl. prefill)
    queue_depth: int = 64
    wait_budget_s: Optional[float] = 0.5
    # wait-budget autotune: admission plans for max(EMA, p99) of
    # observed service times, tightening the budget under a slow tail
    # (see RequestQueue); False pins the fixed-budget behavior
    autotune_wait_budget: bool = True
    max_request_aborts: int = 8
    target_qps: float = 60.0
    duration_s: float = 2.0
    arrival: str = "poisson"          # or "uniform"
    # trainer cadence relative to the ~max_new*(work_s+overhead) request
    # span picks the Mode-Q failure mode.  Mode-U requests ride the ring
    # through commits untouched either way.  Just ABOVE the span
    # (default): a Mode-Q request aborts once mid-flight, restarts
    # phase-aligned with the commit and completes — a latency tax.
    # BELOW the span: even phase-aligned restarts meet the next commit,
    # so Mode-Q requests abort until max_request_aborts sheds them — the
    # paper's reader-starvation regime (the serving eval's headline)
    commit_interval_s: float = 0.028
    ring_slots: int = 8
    n_blocks: int = 4
    block_size: int = 64
    work_s: float = 0.0015            # simulated decode compute per step
    seed: int = 0
    drain_timeout_s: float = 10.0


# ---------------------------------------------------------------------------
# the committing trainer (the writer side of the scenario)
# ---------------------------------------------------------------------------


class SyntheticTrainer:
    """Background thread committing versions into a small MVStore.

    Every commit writes the NEW clock value into every element of every
    block, so any consistent view satisfies "all elements equal one
    clock" — the invariant ``StoreExecutor`` checks per resolved step.
    ``state`` is an immutable ``MVStoreState`` swapped as one Python
    reference, the same publication discipline the real trainer uses.
    The blocks are int32 on ``device`` (the card unless named).
    """

    def __init__(self, mode: str = "U", n_blocks: int = 4,
                 block_size: int = 64, ring_slots: int = 8,
                 commit_interval_s: float = 0.02, device=None):
        store_mode = "U" if mode == "U" else "Q"
        self.cfg = MVStoreConfig(ring_slots=ring_slots, mode=store_mode)
        self.local_mode = store_mode
        self.device = resolve_device(device)
        versioned = "all" if store_mode == "U" else "none"
        params = {f"b{i}": torch.zeros((block_size,), dtype=torch.int32,
                                       device=self.device)
                  for i in range(n_blocks)}
        self.state = mvstore.mv_init(params, self.cfg, versioned=versioned)
        self.commit_interval_s = commit_interval_s
        self.commits = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def commit_once(self) -> None:
        state = self.state
        c = state.clock + 1
        new_params = {k: torch.full(v.shape, c, dtype=torch.int32,
                                    device=self.device)
                      for k, v in state.live.items()}
        self.state = mvstore.mv_commit(state, new_params,
                                       local_mode=self.local_mode,
                                       cfg=self.cfg)
        self.commits += 1

    def _run(self) -> None:
        while not self._stop.wait(self.commit_interval_s):
            self.commit_once()

    def start(self) -> "SyntheticTrainer":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


# ---------------------------------------------------------------------------
# the store-level slot executor (the reader side)
# ---------------------------------------------------------------------------


def torn_flag(view) -> torch.Tensor:
    """A 0-d bool tensor on the blocks' device, True unless every element
    of every block of ``view`` equals the first block's first element:
    one reduction per block, stacked, and no sync."""
    leaves = [t for _, t in mvstore._flatten(view)]
    first = leaves[0].reshape(-1)[0]
    return torch.stack([(t != first).any() for t in leaves]).any()


class StoreExecutor:
    """SlotExecutor answering requests from MVStore parameter snapshots.

    Stateless per slot (the synthetic "model" is the resolve itself plus
    ``work_s`` of simulated decode compute per step), so all the slot
    bookkeeping lives in the scheduler where it is testable.  Resolves
    once per DISTINCT pinned clock per step — the batched-decode shape —
    and checks the all-elements-equal-one-clock invariant on every
    successful resolve, counting breaks into ``metrics.violations``.
    """

    def __init__(self, state_fn, policy: str = "U", n_slots: int = 4,
                 work_s: float = 0.0015, check: bool = True,
                 metrics: Optional[ServeMetrics] = None):
        if policy not in SERVE_POLICIES:
            raise ValueError(f"policy must be one of {SERVE_POLICIES}")
        self.state_fn = state_fn
        self.policy = policy
        self.n_slots = n_slots
        self.work_s = work_s
        self.check = check
        self.metrics = metrics

    def current_clock(self) -> int:
        return int(self.state_fn().clock)

    def warmup(self) -> None:
        """Run the first resolve and torn-read check outside the measured
        window: on the card that builds and loads the kernel library and,
        in Mode U, launches the first ``snapshot_select``."""
        state = self.state_fn()
        view, ok, _ = self._snapshot(state, int(state.clock))
        self._ok_and_torn(view, ok)

    # -- resolution ------------------------------------------------------
    def _snapshot(self, state, rc: int) -> Tuple[Any, Any, int]:
        """-> (view, ok, clock the view actually came from); ``ok`` is
        True or, from ``mv_snapshot``, a 0-d bool tensor not yet home."""
        if self.policy == "live":
            return state.live, True, int(state.clock)
        view, ok = mvstore.mv_snapshot(
            state, rc, assume_versioned=self.policy == "U")
        return view, ok, rc

    def _resolve(self, state, rc: int) -> Tuple[Any, bool, int]:
        """-> (view, ok, clock the view actually came from)."""
        view, ok, served = self._snapshot(state, rc)
        return view, bool(ok), served

    @staticmethod
    def _ok_and_torn(view, ok) -> Tuple[bool, bool]:
        """``ok`` and the view's torn-read flag, brought home in one
        copy."""
        flag = torn_flag(view)
        if not isinstance(ok, torch.Tensor):
            ok = flag.new_full((), bool(ok))
        ok, is_torn = torch.stack([ok, flag]).tolist()
        return ok, is_torn

    def _verify(self, view, ok) -> bool:
        """-> ``ok`` as a bool; a torn view that resolved ok counts a
        violation."""
        ok, is_torn = self._ok_and_torn(view, ok)
        if ok and is_torn and self.metrics is not None:
            self.metrics.on_violation()
        return ok

    # -- SlotExecutor ----------------------------------------------------
    def prefill(self, slot: int, req: Request, clock: int) -> StepResult:
        _, ok, served = self._resolve(self.state_fn(), clock)
        if not ok:
            return StepResult(False, clock)
        return StepResult(True, served)

    def decode(self, slots: Sequence[int], clocks: Sequence[int]
               ) -> List[StepResult]:
        state = self.state_fn()
        if self.work_s:
            time.sleep(self.work_s)       # simulated batched decode step
        resolved: Dict[int, Tuple[Any, bool, int]] = {}
        for rc in set(clocks):
            view, ok, served = self._snapshot(state, rc)
            ok = self._verify(view, ok) if self.check else bool(ok)
            resolved[rc] = (view, ok, served)
        return [StepResult(resolved[rc][1], resolved[rc][2])
                for rc in clocks]


# ---------------------------------------------------------------------------
# open-loop load generation
# ---------------------------------------------------------------------------


class OpenLoopLoadGen:
    """Precomputed arrival schedule at ``target_qps`` for ``duration_s``.

    Open loop: arrivals fire at their scheduled offsets whether or not
    the service keeps up — back-pressure shows up as queue depth and
    shedding, not as a quietly slowed generator.
    """

    def __init__(self, target_qps: float, duration_s: float,
                 seed: int = 0, arrival: str = "poisson"):
        rng = random.Random(seed)
        self.arrivals: List[float] = []
        t = 0.0
        mean_gap = 1.0 / max(target_qps, 1e-9)
        while True:
            t += (rng.expovariate(target_qps) if arrival == "poisson"
                  else mean_gap)
            if t >= duration_s:
                break
            self.arrivals.append(t)
        self._next = 0

    def pop_due(self, t_rel: float) -> int:
        """Number of arrivals whose scheduled time has passed."""
        n = 0
        while (self._next < len(self.arrivals)
               and self.arrivals[self._next] <= t_rel):
            self._next += 1
            n += 1
        return n

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self.arrivals)

    @property
    def total(self) -> int:
        return len(self.arrivals)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


class SnapshotService:
    """Queue -> scheduler -> metrics, with graceful drain.

    Owns nothing it was handed (an external executor/queue/metrics is
    used as-is); ``synthetic()`` builds the self-contained store-level
    scenario with an owned ``SyntheticTrainer`` that ``run_open_loop``
    starts and stops around the measured window.
    """

    def __init__(self, executor, cfg: Optional[ServiceConfig] = None, *,
                 queue: Optional[RequestQueue] = None,
                 metrics: Optional[ServeMetrics] = None,
                 trainer: Optional[SyntheticTrainer] = None):
        self.cfg = cfg or ServiceConfig()
        self.metrics = metrics if metrics is not None \
            else ServeMetrics(seed=self.cfg.seed)
        self.queue = queue if queue is not None else RequestQueue(
            max_depth=self.cfg.queue_depth,
            wait_budget_s=self.cfg.wait_budget_s,
            n_servers=self.cfg.n_slots,
            est_service_s=self.cfg.max_new * max(self.cfg.work_s, 1e-4),
            autotune=self.cfg.autotune_wait_budget)
        self.executor = executor
        if getattr(executor, "metrics", None) is None \
                and hasattr(executor, "metrics"):
            executor.metrics = self.metrics
        self.scheduler = ContinuousBatchingScheduler(
            self.queue, executor, self.metrics,
            max_request_aborts=self.cfg.max_request_aborts)
        self.trainer = trainer
        self._rid = 0

    @classmethod
    def synthetic(cls, cfg: Optional[ServiceConfig] = None, device=None
                  ) -> "SnapshotService":
        """The store-level scenario on ``device`` (the card unless
        named; no card raises)."""
        cfg = cfg or ServiceConfig()
        trainer = SyntheticTrainer(
            mode=cfg.mode, n_blocks=cfg.n_blocks,
            block_size=cfg.block_size, ring_slots=cfg.ring_slots,
            commit_interval_s=cfg.commit_interval_s, device=device)
        metrics = ServeMetrics(seed=cfg.seed)
        executor = StoreExecutor(lambda: trainer.state, policy=cfg.mode,
                                 n_slots=cfg.n_slots, work_s=cfg.work_s,
                                 metrics=metrics)
        return cls(executor, cfg, metrics=metrics, trainer=trainer)

    # -- submission ------------------------------------------------------
    def submit(self, payload: Any = None, max_new: Optional[int] = None,
               now: Optional[float] = None) -> Tuple[Request, Admission]:
        self._rid += 1
        req = Request(rid=self._rid, payload=payload,
                      max_new=max_new or self.cfg.max_new)
        return req, self.queue.offer(req, now=now)

    # -- loops -----------------------------------------------------------
    def run_open_loop(self, load_gen: Optional[OpenLoopLoadGen] = None
                      ) -> Dict:
        cfg = self.cfg
        gen = load_gen or OpenLoopLoadGen(cfg.target_qps, cfg.duration_s,
                                          seed=cfg.seed,
                                          arrival=cfg.arrival)
        if hasattr(self.executor, "warmup"):
            self.executor.warmup()
        own_trainer = self.trainer is not None
        if own_trainer:
            self.trainer.start()
        t0 = time.perf_counter()
        try:
            while True:
                t_rel = time.perf_counter() - t0
                for _ in range(gen.pop_due(t_rel)):
                    self.submit()
                if gen.exhausted and t_rel >= cfg.duration_s:
                    break
                if not self.scheduler.step():
                    time.sleep(5e-5)
            drained = self.scheduler.run_until_drained(
                cfg.drain_timeout_s)
            measured = time.perf_counter() - t0
        finally:
            if own_trainer:
                self.trainer.stop()
        return self.summary(measured, drained=drained, offered=gen.total)

    def serve_requests(self, payloads: Sequence[Any]) -> Dict:
        """Closed loop: offer everything up front, drain, summarize."""
        if hasattr(self.executor, "warmup"):
            self.executor.warmup()
        own_trainer = self.trainer is not None
        if own_trainer:
            self.trainer.start()
        t0 = time.perf_counter()
        try:
            for p in payloads:
                self.submit(payload=p)
            drained = self.scheduler.run_until_drained(
                self.cfg.drain_timeout_s)
            measured = time.perf_counter() - t0
        finally:
            if own_trainer:
                self.trainer.stop()
        return self.summary(measured, drained=drained,
                            offered=len(payloads))

    # -- reporting -------------------------------------------------------
    def summary(self, measured_s: float, drained: bool = True,
                offered: Optional[int] = None) -> Dict:
        cfg = self.cfg
        row = self.metrics.summary(measured_s,
                                   backend=f"serve-{cfg.mode}",
                                   mode=cfg.mode if cfg.mode in ("Q", "U")
                                   else "-")
        row.update({
            "policy": cfg.mode,
            "target_qps": cfg.target_qps,
            "duration_s": measured_s,
            "n_slots": cfg.n_slots,
            "max_new": cfg.max_new,
            "drained": drained,
            "offered": offered if offered is not None
            else self.queue.counters["offered"],
            "trainer_commits": self.trainer.commits
            if self.trainer is not None else 0,
        })
        row.update({f"q_{k}": v for k, v in self.queue.counters.items()})
        row["shed"] = (self.queue.counters["shed_depth"]
                       + self.queue.counters["shed_wait"])
        return row


def format_summary(row: Dict) -> str:
    return (f"policy={row['policy']:<4s} qps={row['qps']:6.1f}"
            f"/{row['target_qps']:.0f} completed={row['completed']:4d} "
            f"shed={row['shed']:3d} failed={row['failed_aborts']:3d} "
            f"aborts={row['snapshot_aborts']:4d} "
            f"p50={row['p50_ms']:6.1f}ms p99={row['p99_ms']:6.1f}ms "
            f"occ={row['occupancy']:.2f} "
            f"commits={row['trainer_commits']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="snapshot-serving loop under a committing trainer")
    ap.add_argument("--mode", default="U", choices=SERVE_POLICIES)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--target-qps", type=float, default=60.0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--commit-interval-ms", type=float, default=28.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="short CI-sized run")
    ap.add_argument("--device", default=None,
                    help="where the store lives (default: the card; "
                         "'cpu' runs each kernel's plain version)")
    args = ap.parse_args(argv)

    cfg = ServiceConfig(
        mode=args.mode, n_slots=args.slots, max_new=args.max_new,
        target_qps=args.target_qps,
        duration_s=0.8 if args.quick else args.duration,
        commit_interval_s=args.commit_interval_ms / 1e3, seed=args.seed)
    svc = SnapshotService.synthetic(cfg, device=args.device)
    row = svc.run_open_loop()
    print(format_summary(row), flush=True)
    if row["violations"]:
        print(f"TORN READS: {row['violations']}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
