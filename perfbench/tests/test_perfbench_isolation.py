"""Nothing the benchmark runs loads the JAX stack or the JAX package, and
the references import nothing of the program; names are compared by
their whole top-level part."""
from __future__ import annotations

import ast
import types

import pytest

from perfbench.harness import common


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


FILES = sorted(common.BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(common.BENCH)) for p in FILES])
def test_no_forbidden_import(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & set(common.FORBIDDEN), path
    if path.parent.name == "reference":
        assert "repro_torch" not in tops, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    """Judged on a module table of its own (another test in this process
    may have loaded the JAX package)."""
    table = {"repro_torch": 1, "repro_torch.core": 1, "jaxtyping": 1,
             "torch": 1}
    monkeypatch.setattr(common, "sys", types.SimpleNamespace(modules=table))
    assert common.forbidden_modules() == []
    table["repro.core"] = 1
    table["jax.numpy"] = 1
    assert common.forbidden_modules() == ["jax", "repro"]
