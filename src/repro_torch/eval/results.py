"""Normalized results schema for every paper-figure experiment.

One writer for the port's eval results under ``results/``
(``python -m repro_torch.eval``), the same schema the JAX package's eval
and figure benches write

    {
      "meta": {
        "schema_version": 1,
        "bench":            experiment name ("longread", "rwmix", ...),
        "git_sha":          short SHA of the tree that produced the file,
        "seed":             RNG seed threaded into every workload,
        "backends":         sorted backend names appearing in rows,
        "mode_transitions": {row label -> mode-counter advances},
        ...                 experiment-specific extras (workload params)
      },
      "rows": [ {<flat measurement row>}, ... ]
    }

so a results file names exactly what it measured and can be re-run
bit-for-bit (`BENCHMARKS.md` documents the row schemas per experiment).
Every row that came from a TM run carries the normalized ``stm_stats``
dict (``repro_torch.core.stats_schema``) and its ``backend`` name; the meta
block is DERIVED from the rows, so it can never drift from them.
"""
from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, List, Optional

SCHEMA_VERSION = 1

#: default output directory (env-overridable for CI / scratch runs)
RESULTS_DIR = os.environ.get("REPRO_RESULTS_DIR", "results")


def git_sha() -> str:
    """Short SHA of the current tree, or "unknown" outside a checkout."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or "unknown"
    except Exception:  # noqa: BLE001 - sandboxed/bare checkouts
        return "unknown"


def _row_label(r: Dict) -> str:
    """Unique-enough row label: backend/variant (or workload), so one
    backend's rows across a variant ladder don't collide in the meta."""
    tm = str(r.get("tm", r.get("backend", "?")))
    qualifier = r.get("variant", r.get("workload"))
    if qualifier and str(qualifier) != tm:
        return f"{tm}/{qualifier}"
    return tm


def build_meta(bench: str, rows: List[Dict], seed: int,
               extra: Optional[Dict] = None) -> Dict:
    """Derive the meta block from the rows (single source of truth)."""
    meta: Dict = {
        "schema_version": SCHEMA_VERSION,
        "bench": bench,
        "git_sha": git_sha(),
        "seed": seed,
        "backends": sorted({r["backend"] for r in rows
                            if isinstance(r, dict) and "backend" in r}),
        "mode_transitions": {
            _row_label(r): r["mode_transitions"]
            for r in rows
            if isinstance(r, dict) and "mode_transitions" in r},
    }
    if extra:
        meta.update(extra)
    return meta


def save_results(bench: str, rows: List[Dict], seed: int,
                 out_dir: Optional[str] = None,
                 extra_meta: Optional[Dict] = None,
                 prefix: str = "eval") -> str:
    """Write ``{meta, rows}`` to ``<out_dir>/<prefix>_<bench>.json``.

    Returns the path written.
    """
    out_dir = out_dir or RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{prefix}_{bench}.json")
    payload = {"meta": build_meta(bench, rows, seed, extra_meta),
               "rows": rows}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path
