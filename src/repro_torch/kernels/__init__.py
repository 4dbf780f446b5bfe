"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``).

Each module holds one kernel's wrapper, its plain PyTorch version and
its launch counter; ``_lib`` builds and loads the shared library.  A
wrapper launches its kernel for a CUDA tensor and takes the plain
version only for a CPU tensor — there is no fallback from one to the
other.

    gather_read     out[i] = row[idx[i]]     (heap, lock words, MVStore rows);
                    a bulk read's pre/heap/post gathers in one launch
    scatter_write   row[idx[i]] = val[i], in place    (heap, lock words);
                    from host columns in one C call, pairs in the
                    launch's parameters up to 1024
    validate        read-set predicate + all-valid flag
    version_select  newest mirror slot below a snapshot; a versioned
                    bulk read's mirror resolve (seqlock bracket, way
                    match, selection) in one launch
    commit_fused    group verdict + scatter + release words (group commit,
                    MVStore publish with its ring refresh)
    snapshot_select newest ring slot at/below a clock, copied (MVStore)
    flash_attention causal/non-causal attention forward, grouped-query
                    heads (every prefill attention layer and every
                    training forward and recompute)
    fused_adamw     AdamW step + versioned ring write (every leaf of a
                    fused Mode-U train step)
    ssd_scan        Mamba-2 SSD chunked scan, final state carried out
                    (every Mamba layer of every prefill)
"""
from typing import Dict

from repro_torch.kernels import (
    commit_fused,
    flash_attention,
    fused_adamw,
    gather_read,
    scatter_write,
    snapshot_select,
    ssd_scan,
    validate,
    version_select,
)

#: every kernel's launch counter, by kernel name
COUNTERS = {m.launches.name: m.launches
            for m in (gather_read, scatter_write, validate, version_select,
                      commit_fused, snapshot_select, flash_attention,
                      fused_adamw, ssd_scan)}
#: the bracketed bulk-read gathers, also counted under ``gather_read``
COUNTERS[gather_read.bracketed_launches.name] = \
    gather_read.bracketed_launches
#: the versioned reads' mirror resolves, also counted under
#: ``version_select``
COUNTERS[version_select.mirror_launches.name] = \
    version_select.mirror_launches


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


def launch_counts() -> Dict[str, int]:
    return {name: c.value for name, c in COUNTERS.items()}
