"""repro_torch.eval — the paper-figure evaluation subsystem, on the card.

Reproduces the paper's long-running-read experiments across every
registered backend, with the batched snapshot-read path
(``Txn.read_bulk``: one ``gather_bracketed`` launch a chunk) and the
frontier-at-a-time traversal as the measurement surface:

    python -m repro_torch.eval --workload longread            # the card
    python -m repro_torch.eval --workload structrq --quick --device cpu

    from repro_torch.eval import run_eval
    rows, path = run_eval("longread", seed=3)

Workload families live in ``workloads.py`` (longread / rwmix /
shardscale / structrq / serving / reliability / durability), the thread/warmup machinery in
``driver.py``, and the normalized ``{meta, rows}`` results schema in
``results.py``.
"""
from repro_torch.eval.driver import (  # noqa: F401
    durability_headline,
    longread_headline,
    reliability_headline,
    run_eval,
    rwmix_headline,
    serving_headline,
    shardscale_headline,
    structrq_headline,
    time_trial,
)
from repro_torch.eval.results import save_results  # noqa: F401
from repro_torch.eval.workloads import (  # noqa: F401
    DEFAULT_BACKENDS,
    UNVERSIONED,
    WORKLOADS,
    TrialSpec,
)

__all__ = [
    "DEFAULT_BACKENDS", "TrialSpec", "UNVERSIONED", "WORKLOADS",
    "durability_headline", "longread_headline", "reliability_headline",
    "run_eval", "rwmix_headline", "save_results", "serving_headline",
    "shardscale_headline", "structrq_headline", "time_trial",
]
