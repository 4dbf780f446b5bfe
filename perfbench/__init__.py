"""The port's benchmark: one command runs one cell (a model configuration
under one traffic mix) on the card and prints one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: ``workloads/<cell>.json`` names
its configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``), the mix names its driver
(``drivers/<driver>.py``), and each per-layer metric of ``BENCHMARK.json``
is read by ``layer_metrics/<metric>.py``.  ``frozen/`` holds the
arithmetic the metrics are taken against, and ``reference/`` the plain
models the outputs are checked against.
"""
