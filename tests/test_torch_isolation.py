"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, every port module
imports with both made unimportable, and the entry point refuses to fall
back to the CPU when no card is there."""
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
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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


def test_entry_points_default_to_the_card():
    from repro_torch.api import make_tm
    from repro_torch.core.engine import ArrayHeap, resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make_tm("multiverse")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_tm("multiverse", 2, array_heap=True, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ArrayHeap()
    tm = make_tm("multiverse", 1, device="cpu", start_bg=False)
    assert tm.raw.locks._words.device.type == "cpu"
    tm.stop()


def test_unported_backends_say_so():
    from repro_torch.api import make_tm

    for name in ("tl2", "dctl", "norec", "tinystm", "mvstore"):
        with pytest.raises(ValueError, match="not ported yet"):
            make_tm(name, device="cpu")
    tm = make_tm("multiverse", 1, device="cpu", start_bg=False)
    with pytest.raises(NotImplementedError):
        with tm.txn(0) as tx:
            tx.traverse_bulk([], None)
    tm.stop()
