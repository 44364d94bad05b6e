"""Nothing a run loads may be JAX or the JAX package, compared by whole
top-level name (``nat_tpu_torch`` starts with ``nat_tpu``); the reference
loads nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from gpubench import devtrace

from conftest import REPO


def test_whole_name_comparison(monkeypatch):
    base = set(devtrace.forbidden_modules())
    monkeypatch.setitem(sys.modules, "nat_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert set(devtrace.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "nat_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert set(devtrace.forbidden_modules()) == base | {"nat_tpu", "jaxlib"}


def test_a_run_loads_none(tiny_root, tmp_path):
    """A whole CPU run of a cell, in a fresh process."""
    code = (
        "import sys; from pathlib import Path; sys.path[:0] = [%r, %r]\n"
        "from conftest import run_tiny\n"
        "res = run_tiny(Path(%r), 'tiny-files', 9, 1.0, False, Path(%r))\n"
        "from gpubench.devtrace import forbidden_modules\n"
        "print(res['correct'], forbidden_modules())\n"
        % (str(REPO), str(REPO / "gpubench" / "tests"), str(tiny_root),
           str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "json", "math", "typing", "numpy", "torch"}
    for path in (REPO / "gpubench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue            # gpubench's own modules
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, (path.name, name)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import gpubench.reference.tokenize, gpubench.weights\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('nat_tpu_torch', 'nat_tpu', 'jax')))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]
