"""Render the roofline table from roofline JSONL files.

The counterpart of the JAX package's ``benchmarks/roofline_report.py``,
with the same row keys and the same table.  ``chip_smoke.py`` writes one
row a trainer step and a server decode step counted on the card
(``launch.roofline.count()``) to ``build/roofline.jsonl``; a second file
of rows, when given, supplies the roofline terms of the same cells.
Last entry per (arch, shape, mesh, mv_mode) wins, so re-runs of fixed
cells override earlier failures.

  PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
      build/roofline.jsonl
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional


def load_latest(path: str) -> Dict[tuple, dict]:
    out = {}
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            key = (d["arch"], d["shape"], d["mesh"], d.get("mv_mode", "Q"))
            out[key] = d
    return out


def render(fit_path: str, probes_path: Optional[str] = None,
           md_out: Optional[str] = None) -> List[dict]:
    fit = load_latest(fit_path)
    probes = load_latest(probes_path) if probes_path else {}
    rows = []
    for key in sorted(fit):
        arch, shape, mesh, mv = key
        f = fit[key]
        p = probes.get(key, {})
        row = {"arch": arch, "shape": shape, "mesh": mesh, "mv_mode": mv,
               "status": f["status"]}
        if f["status"] == "ok":
            row["peak_gb"] = f["memory"]["peak_bytes_per_device"] / 1e9
            row["compile_s"] = f.get("compile_s")
        if f["status"] == "skipped":
            row["reason"] = f.get("reason", "")
        rl = p.get("roofline") or f.get("roofline")
        if rl:
            row.update({
                "t_compute_s": rl["t_compute_s"],
                "t_memory_s": rl["t_memory_s"],
                "t_collective_s": rl["t_collective_s"],
                "dominant": rl["dominant"],
                "useful_flops_ratio": rl["useful_flops_ratio"],
                "roofline_fraction": rl["roofline_fraction"],
            })
        rows.append(row)
    if md_out:
        with open(md_out, "w") as f:
            f.write(to_markdown(rows))
    return rows


def to_markdown(rows: List[dict]) -> str:
    head = ("| arch | shape | mesh | status | peak GB | t_comp | t_mem | "
            "t_coll | dominant | useful | roofline |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|\n")
    body = []
    for r in rows:
        def fmt(k, scale=1.0, nd=4):
            v = r.get(k)
            return f"{v * scale:.{nd}g}" if isinstance(v, (int, float)) \
                else "-"
        body.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
            f"| {fmt('peak_gb', nd=3)} | {fmt('t_compute_s')} "
            f"| {fmt('t_memory_s')} | {fmt('t_collective_s')} "
            f"| {r.get('dominant', '-')} | {fmt('useful_flops_ratio',nd=3)} "
            f"| {fmt('roofline_fraction', nd=3)} |")
    return head + "\n".join(body) + "\n"


def main():
    fit = sys.argv[1] if len(sys.argv) > 1 else "build/roofline.jsonl"
    probes = sys.argv[2] if len(sys.argv) > 2 else None
    rows = render(fit, probes)
    print(to_markdown(rows))


if __name__ == "__main__":
    main()
