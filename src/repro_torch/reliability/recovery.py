"""Recovery: training state replayed from the newest checkpoint, and the
sharded store's cross-shard commit record.

Of the JAX package's ``reliability/recovery.py`` the ``TrainSupervisor``'s
restore path (``replay_from_checkpoint``) and the ``EpochRecord`` that
``core/shardstore.py`` parks during a cross-shard publish are ported
here; the heap, lock-table, ring and mirror repairs after a simulated
crash, ``recover_shardstore`` among them, come with the write-ahead log.
"""
from __future__ import annotations

import dataclasses

from repro_torch.checkpoint.snapshotter import restore_checkpoint
from repro_torch.configs.base import MVStoreConfig
from repro_torch.core import mvstore


def replay_from_checkpoint(ckpt_dir: str, template_state):
    """Restore (step, state) from the newest manifest under ``ckpt_dir``.

    ``template_state`` supplies the structure (a TrainState with
    ``.mv``/``.opt``) and each leaf's dtype and device; rings are
    re-seeded from the restored live values at the restored clock, and
    the template's block stamps are kept, as in the reference.  Raises
    FileNotFoundError when no checkpoint has landed (callers decide: cold
    restart).  ``save_checkpoint``'s atomic ``os.replace`` publish means
    a crash at ``pre_manifest_publish`` leaves only a ``.tmp`` directory,
    which the restore scan skips — replay always lands on a COMPLETE
    manifest.
    """
    tmpl = {"params": template_state.mv.live, "opt": template_state.opt}
    step, restored, _extra = restore_checkpoint(ckpt_dir, tmpl)
    mv = template_state.mv._replace(live=restored["params"], clock=step)
    if mv.ring:
        paths = set(mv.ring)
        slots = next(iter(template_state.mv.ring.values())).shape[0]
        mv = mv._replace(ring={}, ring_ts={})
        mv = mvstore.version_blocks(mv, paths,
                                    MVStoreConfig(ring_slots=slots))
    return step, template_state._replace(mv=mv, opt=restored["opt"])


@dataclasses.dataclass
class EpochRecord:
    """The cross-shard commit record: ``publish_started`` generalized
    from one transaction to one EPOCH of shard-local publishes.

    A multi-shard commit parks this in ``ShardStoreHandle._epoch_inflight``
    before bumping the epoch seqlock odd.  ``pins[s]`` is write shard
    ``s``'s clock at validation time; a shard whose clock still equals
    its pin after a crash has NOT published (each shard-local publish
    ticks its clock by exactly one), so a recovery can tell redo from
    done without any per-shard journal:

      * ``publish_started`` False — the epoch never decided: roll BACK.
        No shard published (the flag flips before the first shard-local
        publish), so rollback is dropping the record and re-evening the
        seqlock.
      * ``publish_started`` True — the epoch decided: roll FORWARD.
        Replay every write shard still at its pin through the exact
        publish path (``MVStoreHandle._publish_locked`` on the parked
        per-shard context), so either ALL shards carry the epoch's
        writes or the epoch is re-driven to completion — never a torn
        cut.
    """
    epoch: int
    write_shards: tuple
    pins: dict                      # shard id -> clock pinned at validate
    ctxs: dict                      # shard id -> parked _MVCtx (write_buf)
    tid: int = -1
    publish_started: bool = False
    published: list = dataclasses.field(default_factory=list)
    # the epoch's durable twin in the write-ahead log: one prepare per
    # write shard under one group decide
    wal_lsns: tuple = ()
