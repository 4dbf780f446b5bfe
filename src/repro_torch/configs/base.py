"""Store configuration of the port (the model configs of the JAX
package's ``configs/base.py`` are not ported yet).

``MVStoreConfig`` is this package's own copy of the reference's
dataclass: the same fields, defaults and ``replace``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MVStoreConfig:
    """The paper's technique (dynamic multiversioning) at the parameter-store
    level.  ``ring_slots`` is R, the bounded version-list length.  ``mode``
    selects the local mode of a commit ('Q' = unversioned fast path, 'U' =
    copy-on-write versioned commit).  See core/mvstore.py.
    """

    enabled: bool = True
    ring_slots: int = 2
    mode: str = "Q"                   # local mode of the commit
    fused_commit: bool = False        # the trainer's fused optimizer path

    def replace(self, **kw) -> "MVStoreConfig":
        return dataclasses.replace(self, **kw)
