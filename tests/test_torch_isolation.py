"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, every port module
imports with both made unimportable, and the entry points (``make_tm``,
the model server, the trainer, the eval and their command lines) refuse
to fall back to the CPU when no card is there."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    """The port's modules, ``chip_smoke.py`` and the port's scripts (the
    A/B harnesses ``scripts/ab_*.py`` and ``scripts/*_torch.py``)."""
    scripts = ROOT / "scripts"
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted(scripts.glob("ab_*.py"))
            + sorted(scripts.glob("*_torch.py")))


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


@pytest.mark.parametrize("path", sorted((ROOT / "scripts").glob("*_torch.sh")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_shell_scripts_run_the_port(path):
    """A shell script of the port runs ``repro_torch`` and nothing of the
    JAX package (no ``examples/`` file, no ``repro`` module)."""
    text = path.read_text()
    assert "repro_torch" in text
    assert "examples/" not in text
    assert " repro." not in text and "-m repro " not in text


def test_every_module_imports_without_jax_or_reference():
    mods = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PORT)], "repro_torch.")]
    code = (
        "import sys\n"
        "for blocked in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[blocked] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'repro' or k.startswith(('repro.', 'jax'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(" + repr(mods) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(mods) >= 20


@pytest.mark.parametrize("backend", ["multiverse", "tl2", "dctl", "norec",
                                     "tinystm", "mvstore"])
def test_entry_points_default_to_the_card(backend):
    from repro_torch.api import make_tm
    from repro_torch.core.engine import ArrayHeap, resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    kw = {"start_bg": False} if backend in ("multiverse", "mvstore") else {}
    with pytest.raises(RuntimeError, match="CUDA"):
        make_tm(backend, 2, array_heap=True, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_tm(backend, 2, array_heap=True, device="cuda", **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        ArrayHeap()
    tm = make_tm(backend, 1, array_heap=True, device="cpu", **kw)
    if backend == "mvstore":
        assert tm.state.live["heap"].device.type == "cpu"
    else:
        assert tm.raw.locks._words.device.type == "cpu"
        assert tm.raw.heap.live().device.type == "cpu"
    tm.stop()


@pytest.mark.parametrize("entry", ["Server", "main"])
def test_the_model_server_defaults_to_the_card(entry):
    """``launch/serve.Server`` and ``python -m repro_torch.launch.serve``
    run on the card unless told otherwise; without one they raise."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "Server":
            serve.Server(smoke_config("qwen2.5-3b"), batch=1, prompt_len=4,
                         max_len=8)
        else:
            serve.main(["--smoke", "--requests", "1", "--gen", "2"])
    server = serve.Server(smoke_config("qwen2.5-3b"), batch=1, prompt_len=4,
                          max_len=8, device="cpu")
    assert server.mv_state.live["embed"].device.type == "cpu"


@pytest.mark.parametrize("entry", ["Trainer", "main"])
def test_the_trainer_defaults_to_the_card(entry, tmp_path):
    """``launch/train.Trainer`` and ``python -m repro_torch.launch.train``
    run on the card unless told otherwise; without one they raise before
    any state is built."""
    from repro_torch.configs import ShapeConfig, smoke_config
    from repro_torch.launch import train

    if torch.cuda.is_available():
        return
    shape = ShapeConfig("t", 8, 1, "train")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "Trainer":
            train.Trainer(smoke_config("qwen2.5-3b"), shape)
        else:
            train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                        str(tmp_path)])
    trainer = train.Trainer(smoke_config("qwen2.5-3b"), shape,
                            device="cpu")
    trainer.controller.stop()
    assert trainer.state.mv.live["embed"].device.type == "cpu"
    assert trainer.state.opt.count.device.type == "cpu"


@pytest.mark.parametrize("entry", ["run_eval", "main"])
def test_the_eval_defaults_to_the_card(entry):
    """``repro_torch.eval.run_eval`` and ``python -m repro_torch.eval`` run
    on the card unless told otherwise; without one they raise before any
    trial runs."""
    from repro_torch.eval import run_eval
    from repro_torch.eval.__main__ import main

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "run_eval":
            run_eval("structrq", quick=True, save=False)
        else:
            main(["--workload", "longread", "--quick", "--no-save"])
    if entry == "main":
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.eval", "--workload",
             "rwmix", "--quick", "--no-save"],
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert "CUDA is not available" in out.stderr
        assert "rwmix/" not in out.stdout


def test_unported_backends_say_so():
    """Every backend and eval workload of the JAX package is ported:
    ``shardstore`` builds a ``ShardStoreHandle`` on the CPU when asked
    and needs the card otherwise; ``serving`` runs on the CPU when
    asked, without a torn read."""
    from repro_torch.api import make_tm
    from repro_torch.core.shardstore import ShardStoreHandle

    tm = make_tm("shardstore", device="cpu", start_bg=False)
    assert isinstance(tm, ShardStoreHandle)
    assert all(sh.device.type == "cpu" for sh in tm._shards)
    tm.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_tm("shardstore", start_bg=False)
    from repro_torch.eval import run_eval

    rows, _ = run_eval("serving", device="cpu", quick=True, save=False)
    assert [r["backend"] for r in rows] == ["multiverse", "modeq",
                                            "unversioned"]
    assert all(r["violations"] == 0 and r["drained"] for r in rows)


#: each driver of the port, as a user starts it without ``--device``
DRIVERS = {
    "quickstart": ["-m", "repro_torch.examples.quickstart"],
    "bakeoff": ["-m", "repro_torch.examples.bakeoff", "--quick"],
    "serve_snapshots": ["-m", "repro_torch.examples.serve_snapshots",
                        "--steps", "1", "--requests", "1"],
    "train_lm": ["-m", "repro_torch.examples.train_lm", "--steps", "1"],
    "diag_moe_top_torch": [str(ROOT / "scripts" / "diag_moe_top_torch.py")],
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_the_drivers_default_to_the_card(name, tmp_path):
    """``python -m repro_torch.examples.<name>`` (and the port's diag
    script) without ``--device``, in a process that sees no card, raises
    before it runs anything on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable] + DRIVERS[name], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "audit 0" not in out.stdout and "done" not in out.stdout
