"""What a run imports: never JAX or the JAX package, whose name
``nldsc_tpu`` is a prefix of the port's, so top-level names are compared
whole; and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys

import pytest

from .conftest import REPO

BENCH = REPO / "benchmark"
JAX = {"jax", "jaxlib", "flax", "nldsc_tpu"}


def imported(path) -> set:
    """Top-level names of the modules a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    assert not imported(path) & JAX


def test_reference_sources_import_no_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "nldsc_tpu_torch" not in imported(path), path


def run_py(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_holds_no_jax():
    """A whole run of a small cell on the CPU, through the window and the
    check, then the process's modules."""
    code = (
        "import sys; sys.path.insert(0, 'benchmark/tests'); "
        "sys.path.insert(0, '.'); "
        "from benchmark.tests.conftest import tiny_cell; "
        "from benchmark import harness, run; "
        "b, c, w = tiny_cell('ukb_hm3.split', 512, 101); "
        "r = harness.run(b, 'ukb_hm3.split', c, w, 3, 0.2, True, 'cpu', 0.0); "
        "assert r['correct'], r; print(run.forbidden_modules())")
    assert run_py(code) == "[]"


def test_reference_imports_no_program():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import benchmark.reference.ld, benchmark.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'nldsc_tpu_torch', 'nldsc_tpu', 'jax'}))")
    assert run_py(code) == "[]"


def test_run_without_a_card_prints_no_result(tmp_path):
    """Without CUDA (this machine), and in a directory holding only
    ``BENCHMARK.json`` and the benchmark's folder, a run exits non-zero and
    prints nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in (REPO, tmp_path):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "ukb_hm3.split", "--seed", "1", "--seconds", "1", "--trace",
             "0"], cwd=root, text=True, capture_output=True, timeout=300)
        assert out.returncode != 0 and not out.stdout.strip()
