"""Finding a cell's files by name, the run's context, and the result line.

Nothing here imports torch at module level: ``run.py`` fixes the cache
directories in the environment first."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

#: the benchmark's folder and the checkout that holds it
BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: top-level module names that may not be loaded in a run (the JAX stack
#: and the JAX package the port was made from)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root: Path = ROOT) -> Dict[str, str]:
    """Fixed directories inside the checkout for every build and kernel
    cache, so the second run of a cell finds them."""
    base = root / "build" / "perfbench"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def load_json(kind: str, name: str, bench: Path = BENCH) -> dict:
    """``<bench>/<kind>/<name>.json``."""
    path = bench / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, bench: Path = BENCH):
    """The module ``<bench>/<kind>/<name>.py`` (a name may hold dots and
    dashes, so it is loaded from its path)."""
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    modname = f"perfbench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_metrics(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` prints: its end-to-end ones, or with
    ``trace`` its per-layer ones (a metric without ``workloads`` belongs
    to every cell)."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def process_start() -> float:
    """Wall-clock time at which this process started (its age from
    /proc, to the kernel's 10 ms ticks), so that set-up counts the
    interpreter's start and every import."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
        started = int(fields.split()[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that a run may not hold,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Check:
    """One number compared in the check of the outputs."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell's files and the run's arguments.
    ``program_config`` replaces the program's configuration (the CPU tests
    run a reduced one) and ``device`` the card; ``calibrate`` also reads
    the control (``calibrate.py``), which a benchmark run never does."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    workload: dict
    config: dict
    traffic: dict
    t_process: float
    device: str = "cuda"
    program_config: Any = None
    calibrate: bool = False


@dataclasses.dataclass
class Outcome:
    """What a driver returns: the window's figures and the check.
    ``control`` (calibrating only) holds the numbers the control gives in
    the program's place, each against the same limit."""
    e2e: Dict[str, float]
    readings: Dict[str, Any]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak: int
    device: Dict[str, Any]
    trace: Optional[dict] = None
    notes: List[str] = dataclasses.field(default_factory=list)
    control: Optional[List[Check]] = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) \
            and self.attempted > 0

    @property
    def control_correct(self) -> Optional[bool]:
        """``correct`` with the control's numbers in place of the
        program's (None where the control was not read)."""
        if self.control is None:
            return None
        by_name = {c.name: c for c in self.checks}
        by_name.update({c.name: c for c in self.control})
        return dataclasses.replace(self, checks=list(by_name.values()),
                                   control=None).correct


def result_line(out: Outcome, metrics: List[Tuple[str, str, float]],
                ) -> str:
    """The last line of standard output: the contract's keys, the numbers
    compared last."""
    dev = dict(out.device)
    dev["memory_peak_bytes"] = int(out.memory_peak)
    if out.trace is not None:
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.trace["window_s"]
    line = {"correct": out.correct, "attempted": int(out.attempted),
            "failed": int(out.failed),
            "metrics": {n: {"value": v, "unit": u} for n, u, v in metrics},
            "device": dev}
    if out.trace is not None:
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return json.dumps(line)
