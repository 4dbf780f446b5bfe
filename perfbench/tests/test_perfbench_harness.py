"""The harness on the CPU: its files found by name, the result line, and a
run without a card."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import common

SPEC = common.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_name_what_exists(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    wl = common.load_json("workloads", cell)
    for key in ("config", "traffic", "chips", "why"):
        assert wl[key] == entry[key], key
    cfg = common.load_json("configs", wl["config"])
    mix = common.load_json("traffic", wl["traffic"])
    assert (common.BENCH / "drivers" / f"{mix['driver']}.py").is_file()
    if "check" in mix:   # a served cell's sample can always be drained
        assert mix["check"]["requests"] <= mix["slots"] + mix["queued"]
    assert (common.BENCH / "reference" / f"{cfg['reference']}.py").is_file()
    conf = next(c for c in SPEC["configs"] if c["name"] == wl["config"])
    assert conf["reduced"] == cfg["reduced"]
    assert (common.ROOT / conf["file"]).is_file()
    e2e = {m["name"] for m in common.cell_metrics(SPEC, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = common.cell_metrics(SPEC, cell, True)
    assert layer
    for m in layer:
        assert (common.BENCH / "layer_metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_metric_workloads_name_cells():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m["name"]


def test_a_new_cell_is_found_by_its_files(tmp_path):
    """A cell, a mix and a per-layer metric added as files and entries, with
    no edit to a file that exists."""
    bench = tmp_path / "perfbench"
    shutil.copytree(common.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = dict(common.load_json("traffic", "serve_Q"), slots=2)
    (bench / "traffic" / "serve_Q_small.json").write_text(json.dumps(mix))
    (bench / "workloads" / "deepseek-7b.serve_Q_small.json").write_text(
        json.dumps({"config": "deepseek-7b", "traffic": "serve_Q_small",
                    "chips": 1, "why": "two slots",
                    "limits": {"served_logit_gap": 0.25}}))
    (bench / "layer_metrics" / "serve.decode_calls.py").write_text(
        "def read(out, ctx):\n    return out.readings.get('decode_calls')\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "deepseek-7b.serve_Q_small",
                              "config": "deepseek-7b",
                              "traffic": "serve_Q_small", "chips": 1,
                              "why": "two slots"})
    spec["per_layer"].append({"name": "serve.decode_calls", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "Server", "moves": "gen_tokens_per_s",
                              "workloads": ["deepseek-7b.serve_Q_small"]})
    wl = common.load_json("workloads", "deepseek-7b.serve_Q_small",
                          bench=bench)
    assert common.load_json("traffic", wl["traffic"], bench=bench)["slots"] \
        == 2
    names = [m["name"] for m in
             common.cell_metrics(spec, "deepseek-7b.serve_Q_small", True)]
    assert "serve.decode_calls" in names
    reader = common.load_module("layer_metrics", "serve.decode_calls",
                                bench=bench)
    out = common.Outcome(e2e={}, readings={"decode_calls": 7}, checks=[],
                         attempted=1, failed=0, memory_peak=0, device={})
    assert reader.read(out, None) == 7
    drv = common.load_module("drivers", mix["driver"], bench=bench)
    assert hasattr(drv, "run")


def _line(trace: bool) -> dict:
    from perfbench.harness.trace import Reduced
    red = Reduced(window_s=2.0, busy_s=1.5, kernels={}, by_label={},
                  launches={}, label_counts={}, lost=0,
                  device_ops=[["k", 1.5]], idle_gaps=[["serve.decode", 0.1]])
    out = common.Outcome(
        e2e={}, readings={}, checks=[common.Check("gap", 0.1, 0.2)],
        attempted=3, failed=0, memory_peak=123,
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                "count": 1}, trace=red.as_line() if trace else None)
    return json.loads(common.result_line(out, [("x_ms", "ms", 1.25)]))


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(trace):
    line = _line(trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] == 3
    assert line["metrics"] == {"x_ms": {"value": 1.25, "unit": "ms"}}
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] == 123
    if trace:
        assert dev["busy_s"] == 1.5 and dev["window_s"] == 2.0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "breakdown" not in line and "busy_s" not in dev
    assert line["checks"] == {"gap": {"value": 0.1, "limit": 0.2}}


def test_a_check_over_its_limit_is_not_correct():
    out = common.Outcome(e2e={}, readings={},
                         checks=[common.Check("gap", 0.3, 0.2)],
                         attempted=3, failed=0, memory_peak=0, device={})
    assert not out.correct
    out.checks = [common.Check("gap", float("nan"), 0.2)]
    assert not out.correct


def _run_cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "deepseek-7b.serve_Q", "--seed", "2147483655", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _run_cli(common.ROOT, env)
    assert res.returncode != 0
    assert not any(line.startswith("{") for line in res.stdout.splitlines())
    assert "CUDA" in res.stderr


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's folder but no
    program cannot produce a result."""
    shutil.copytree(common.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = _run_cli(tmp_path, env)
    assert res.returncode != 0
    assert not any(line.startswith("{") for line in res.stdout.splitlines())


def test_cache_directories_are_fixed_inside_the_checkout():
    env = common.cache_env()
    for key in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        assert env[key].startswith(str(common.ROOT / "build"))
    assert env == common.cache_env()


def test_traffic_gives_every_seed_the_same_sizes():
    from perfbench.harness.traffic import Batches, Requests
    mix = common.load_json("traffic", "serve_Q")
    a, b = Requests(mix, 2**31 + 11, 1000), Requests(mix, 5, 1000)
    n = 4 * len(a.grid)
    assert sorted(a.length(i) for i in range(n)) == \
        sorted(b.length(i) for i in range(n))
    assert [a.length(i) for i in range(n)] != [b.length(i) for i in range(n)]
    assert (a.prompt(3) == Requests(mix, 2**31 + 11, 1000).prompt(3)).all()
    mix = common.load_json("traffic", "train_U")
    ba = Batches(mix, 2**31 + 11, 1000)
    x = ba.at(0)
    assert x["tokens"].shape == (mix["train"]["rows"], mix["train"]["seq"])
    assert (x["labels"][:, :-1] == x["tokens"][:, 1:]).all()
    assert len({bytes(r) for r in x["tokens"]}) == mix["train"]["rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """One short run of each cell on the card: ``correct`` and the
    contract's keys (a card's run only)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "2147483901", "--seconds", "45", "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


