"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``).

Each module holds one kernel's wrapper, its plain PyTorch version and
its launch counter; ``_lib`` builds and loads the shared library.  A
wrapper launches its kernel for a CUDA tensor and takes the plain
version only for a CPU tensor — there is no fallback from one to the
other.

    gather_read     out[i] = row[idx[i]]              (heap, lock words)
    scatter_write   row[idx[i]] = val[i], in place    (heap, lock words)
    validate        read-set predicate + all-valid flag
    version_select  newest mirror slot below a snapshot
"""
from typing import Dict

from repro_torch.kernels import (
    gather_read,
    scatter_write,
    validate,
    version_select,
)

#: every kernel's launch counter, by kernel name
COUNTERS = {m.launches.name: m.launches
            for m in (gather_read, scatter_write, validate, version_select)}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


def launch_counts() -> Dict[str, int]:
    return {name: c.value for name, c in COUNTERS.items()}
