"""What the benchmark runs loads neither JAX nor the JAX package, and the
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "rcnn_ocr_tpu"}


def _modules(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _imports(path):
    return {m.split(".")[0] for m in _modules(path)}


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package(path):
    assert not _imports(BENCH / path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p.name for p in (BENCH / "reference").glob("*.py")))
def test_the_reference_imports_nothing_of_the_program(path):
    mods = _modules(BENCH / "reference" / path)
    assert not {m.split(".")[0] for m in mods} & (FORBIDDEN | {"rcnn_ocr_tpu_torch"})
    # nothing of the harness either: only the reference's own modules
    assert all(m.startswith("benchmark.reference") for m in mods if m.startswith("benchmark"))


def test_a_run_loads_no_jax_module():
    code = ("import sys, torch; from benchmark import run; "
            "bench = run.load_json(run.ROOT / 'BENCHMARK.json'); "
            "run.run_cell(bench, 'bulk_ctc.default64', 1, 0.01, False, device='cpu', "
            "dtype=torch.float32, overrides={'lines': {'n_lines': 4}, 'call': {'batch_size': 4},"
            " 'check': {'sample_lines': 2, 'longest': 1}}); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().split("\n")[-1]))
    assert "rcnn_ocr_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_command_exits_nonzero_with_no_card_or_no_program(tmp_path):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "bulk_ctc.default64", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch
    if not torch.cuda.is_available():
        assert out.returncode != 0 and out.stdout.strip() == ""
    (tmp_path / "benchmark").mkdir()
    for p in BENCH.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            dst = tmp_path / "benchmark" / p.relative_to(BENCH)
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(p.read_bytes())
    (tmp_path / "BENCHMARK.json").write_bytes((ROOT / "BENCHMARK.json").read_bytes())
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "bulk_ctc.default64", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
