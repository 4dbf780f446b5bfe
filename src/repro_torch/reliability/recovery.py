"""Recovery: training state replayed from the newest checkpoint.

Of the JAX package's ``reliability/recovery.py`` only the
``TrainSupervisor``'s restore path is ported here
(``replay_from_checkpoint``); the heap, lock-table, ring and mirror
repairs after a simulated crash come with the write-ahead log.
"""
from __future__ import annotations

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
