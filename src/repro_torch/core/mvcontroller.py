"""MVStore mode controller — the paper's background thread at pod scale.

Drives the Q -> QtoU -> U -> UtoQ -> Q cycle over the MVStore using the
same heuristics as the word-level STM (core/heuristics.py):

  * snapshot readers announce aborts/read-counts; K1 flips a reader to the
    versioned path, K2/K3 let it CAS the global mode Q -> QtoU;
  * the controller advances all other transitions only after every
    participant's announced local mode counter has caught up (the paper's
    local-mode-lags-by-one invariant).  A *participant* is the trainer
    (the single logical writer) or a snapshot reader;
  * in Mode Q it runs unversioning rounds with the L/P commit-delta
    threshold, dropping rings whose newest version is stale;
  * reference counting plays the role of EBR: a ring dropped at a step
    boundary is a tensor an in-flight reader still holds a reference to,
    so reclamation is structurally safe — the controller still tracks
    reader pins to mirror the paper's accounting and to bound ring
    growth.

State-mutating effects (version/unversion blocks, ring writes) are applied
by the writer at step boundaries via `trainer_tick`, so a commit picks up
its local mode at begin.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, FrozenSet, List, Optional, Set

from repro_torch.configs.base import MVStoreConfig
from repro_torch.configs.paper_stm import MultiverseParams
from repro_torch.core import heuristics as heur
from repro_torch.core import modes as M
from repro_torch.core import mvstore


class ReaderHandle:
    """Per-reader announcement + heuristic state."""

    def __init__(self, rid: int, controller: "MVController"):
        self.rid = rid
        self.ctl = controller
        self.ann = heur.ThreadAnnouncement()
        self.attempts = 0
        self.versioned = False
        self.local_mode_counter = 0
        self.initial_versioned_ts: Optional[int] = None
        self.stats = {"commits": 0, "aborts": 0, "versioned_commits": 0,
                      "mode_cas": 0}

    # -- reader lifecycle -----------------------------------------------
    def begin(self, read_clock: int) -> Dict:
        self.local_mode_counter = self.ctl.mode_counter
        self.ann.local_mode_counter = self.local_mode_counter
        self.ann.active_versioned = self.versioned
        if self.versioned and self.initial_versioned_ts is None:
            self.initial_versioned_ts = read_clock
        return {"mode": M.get_mode(self.local_mode_counter),
                "versioned": self.versioned,
                "read_clock": read_clock}

    def on_abort(self, read_cnt: int, wanted_blocks=()) -> None:
        """A snapshot read came back not-ok (writer advanced the clock or
        ring overflow) — the paper's reader abort path."""
        self.stats["aborts"] += 1
        p = self.ctl.params
        if heur.should_attempt_mode_cas(
                p, versioned=self.versioned, attempts=self.attempts,
                read_cnt=read_cnt,
                min_mode_u_reads=self.ctl.min_mode_u_reads.get()):
            self.ann.sticky_mode_u = True
            self.ann.small_txn_read_cnt = None
            self.ctl.try_cas_q_to_qtou(self)
        if not self.versioned and heur.should_go_versioned(p,
                                                           self.attempts):
            self.versioned = True
        if self.versioned and wanted_blocks:
            # Mode-Q versioned reader versions the blocks it needs
            self.ctl.request_versioning(wanted_blocks)
        self.attempts += 1

    def on_commit(self, read_cnt: int, commit_clock: int) -> None:
        self.stats["commits"] += 1
        if self.versioned:
            self.stats["versioned_commits"] += 1
            self.ann.commit_ts_delta = commit_clock - (
                self.initial_versioned_ts or 0)
            if M.get_mode(self.local_mode_counter) == M.MODE_U:
                self.ctl.min_mode_u_reads.update(read_cnt)
        if self.ann.sticky_mode_u and heur.sticky_cleared(
                self.ctl.params, self.ann, read_cnt):
            self.ann.sticky_mode_u = False
        self.attempts = 0
        self.versioned = False
        self.initial_versioned_ts = None


class MVController:
    def __init__(self, params: Optional[MultiverseParams] = None,
                 mvcfg: Optional[MVStoreConfig] = None,
                 poll_s: float = 0.002, start_bg: bool = True):
        self.params = params or MultiverseParams()
        self.mvcfg = mvcfg or MVStoreConfig()
        self.mode_counter = 0
        self._mode_lock = threading.Lock()
        self.min_mode_u_reads = heur.MinModeUReadCount()
        self.unversion_heur = heur.UnversionThreshold(self.params)
        self.first_obs_mode_u_ts: Optional[int] = None
        self._readers: List[ReaderHandle] = []
        self._trainer_mode_counter = 0
        self._trainer_clock = 0
        self._pending_version: Set[str] = set()
        self._pending_unversion: Set[str] = set()
        self._poll = poll_s
        self._stop = threading.Event()
        self.stats = {"mode_transitions": 0, "unversion_rounds": 0,
                      "blocks_unversioned": 0}
        self._bg = None
        if start_bg:
            self._bg = threading.Thread(target=self._bg_loop, daemon=True)
            self._bg.start()

    # -- registration -----------------------------------------------------
    def reader(self) -> ReaderHandle:
        h = ReaderHandle(len(self._readers), self)
        self._readers.append(h)
        return h

    # -- mode machinery -----------------------------------------------------
    @property
    def mode(self) -> int:
        return M.get_mode(self.mode_counter)

    def try_cas_q_to_qtou(self, reader: ReaderHandle) -> bool:
        with self._mode_lock:
            if M.get_mode(self.mode_counter) == M.MODE_Q:
                self.mode_counter += 1
                self.stats["mode_transitions"] += 1
                reader.stats["mode_cas"] += 1
                return True
        return False

    def _advance(self) -> None:
        with self._mode_lock:
            self.mode_counter += 1
            self.stats["mode_transitions"] += 1

    def request_versioning(self, paths) -> None:
        self._pending_version.update(paths)

    # -- trainer integration ------------------------------------------------
    def trainer_tick(self, state: mvstore.MVStoreState
                     ) -> (mvstore.MVStoreState):
        """Called by the trainer BETWEEN steps: adopt the global mode and
        apply pending (un)versioning.  Returns the updated store state;
        the trainer then selects the compiled variant for
        `current_local_mode()` and the store's versioned set."""
        cnt = self.mode_counter
        mode = M.get_mode(cnt)
        self._trainer_clock = int(state.clock)
        if M.writers_must_version(mode):
            missing = [p for p in mvstore.block_paths(state.live)
                       if p not in state.ring]
            if missing:
                state = mvstore.version_blocks(
                    state, set(missing), self.mvcfg,
                    first_obs_mode_u_ts=self.first_obs_mode_u_ts)
        if self._pending_version:
            want = self._pending_version
            self._pending_version = set()
            state = mvstore.version_blocks(
                state, want, self.mvcfg,
                first_obs_mode_u_ts=self.first_obs_mode_u_ts)
        if self._pending_unversion and M.unversioning_enabled(mode):
            pending = self._pending_unversion
            self._pending_unversion = set()
            drop = apply_stale_unversioning(state, pending)
            if drop:
                state = mvstore.unversion_blocks(state, drop)
                self.stats["blocks_unversioned"] += len(drop)
        self._trainer_mode_counter = cnt
        return state

    def current_local_mode(self) -> str:
        return M.MODE_NAMES[M.get_mode(self._trainer_mode_counter)]

    # -- background thread ----------------------------------------------------
    def _participants_caught_up(self, cnt: int) -> bool:
        if self._trainer_mode_counter < cnt:
            return False
        return all(r.ann.local_mode_counter >= cnt or
                   not r.ann.active_versioned
                   for r in self._readers)

    def _any_sticky(self) -> bool:
        return any(r.ann.sticky_mode_u for r in self._readers)

    def step_once(self) -> None:
        """One controller decision round — the body of the poll loop.

        Public so tests (and recovery drills) can drive the mode state
        machine SYNCHRONOUSLY with ``start_bg=False`` instead of
        sleeping until a background poller happens to observe the same
        announcements — the decision depends only on the announcement
        state, never on wall-clock timing."""
        cnt = self.mode_counter
        mode = M.get_mode(cnt)
        if mode == M.MODE_QTOU:
            if self._participants_caught_up(cnt):
                self._advance()                       # -> U
                self.first_obs_mode_u_ts = self._trainer_clock
        elif mode == M.MODE_U:
            if not self._any_sticky():
                self._advance()                       # -> UtoQ
        elif mode == M.MODE_UTOQ:
            if self._participants_caught_up(cnt):
                self.first_obs_mode_u_ts = None
                self._advance()                       # -> Q
        else:  # Mode Q: unversioning rounds (paper SS4.4)
            self._unversion_round()

    def _bg_loop(self) -> None:
        while not self._stop.is_set():
            self.step_once()
            time.sleep(self._poll)

    def _unversion_round(self) -> None:
        deltas = [r.ann.commit_ts_delta for r in self._readers
                  if r.ann.commit_ts_delta is not None]
        self.unversion_heur.observe_round(deltas)
        thresh = self.unversion_heur.threshold()
        if thresh is None:
            return
        self.stats["unversion_rounds"] += 1
        # the trainer applies the drop at the next step boundary; the
        # 'newest ts' of every ring equals the commit clock of its last
        # write, which the trainer knows — send the threshold along
        self._pending_unversion.add(f"__stale_older_than:{thresh}")

    def stop(self) -> None:
        self._stop.set()
        if self._bg is not None:
            self._bg.join(timeout=2.0)


def apply_stale_unversioning(state: mvstore.MVStoreState,
                             pending: Set[str]) -> FrozenSet[str]:
    """Resolve '__stale_older_than:<t>' markers against ring timestamps."""
    drop: Set[str] = set()
    thresh = None
    for p in pending:
        if p.startswith("__stale_older_than:"):
            thresh = float(p.split(":", 1)[1])
        else:
            drop.add(p)
    if thresh is not None:
        clock = int(state.clock)
        for path, ts in state.ring_ts.items():
            newest = int(ts.max())
            if clock - newest >= thresh:
                drop.add(path)
    return frozenset(drop)
