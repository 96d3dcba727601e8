"""The port stands alone: it imports nothing of JAX or the JAX package.

* a fresh interpreter imports every module of ``rcnn_ocr_tpu_torch`` and
  runs a tiny CPU forward, then must hold none of jax, flax, optax, cv2,
  PIL, msgpack or ``rcnn_ocr_tpu`` in ``sys.modules``;
* a source scan finds no such import in the package or in chip_smoke.py.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cv2", "PIL", "msgpack", "rcnn_ocr_tpu"}
SOURCES = sorted((REPO / "rcnn_ocr_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]

_PROBE = r"""
import importlib, pkgutil, sys
import numpy as np, torch
import rcnn_ocr_tpu_torch
for mod in pkgutil.walk_packages(rcnn_ocr_tpu_torch.__path__, "rcnn_ocr_tpu_torch."):
    importlib.import_module(mod.name)
from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_params
m = RCNN(num_classes=6, hidden_size=8, width_mult=0.0625, with_ctc_head=True).eval()
init_params(m, torch.Generator().manual_seed(0))
with torch.no_grad():
    x = torch.zeros(1, 32, 16, 3)
    assert m(x, batch_max_length=2).shape == (1, 3, 6)
    assert m.ctc_logits(x).shape == (1, 2, 6)
bad = sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_import_and_forward_leave_jax_out_of_sys_modules():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env["PYTHONPATH"] = str(REPO)
    code = f"FORBIDDEN = {sorted(FORBIDDEN)!r}\n" + _PROBE
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_sources_are_not_gitignored():
    """Every source of the port reaches a commit (a bare ``data/`` pattern
    in .gitignore once hid ``rcnn_ocr_tpu_torch/data/``)."""
    csrc = REPO / "rcnn_ocr_tpu_torch" / "csrc"
    files = SOURCES + sorted(csrc.glob("**/*.cu")) + sorted(csrc.glob("**/*.cpp"))
    assert csrc / "host" / "ctc_beam.cpp" in files
    assert csrc / "host" / "letterbox.cpp" in files
    port = REPO / "rcnn_ocr_tpu_torch"
    assert port / "parallel" / "mesh.py" in files and port / "hpo" / "driver.py" in files
    assert {port / "serve_loadtest.py", port / "export_torch.py",
            port / "interop" / "torch_export.py"} <= set(files)
    probe = subprocess.run(["git", "rev-parse", "--is-inside-work-tree"], cwd=str(REPO),
                           capture_output=True, text=True)
    if probe.returncode != 0:
        pytest.skip("not a git work tree")
    out = subprocess.run(["git", "check-ignore", "--no-index", *map(str, files)],
                         cwd=str(REPO), capture_output=True, text=True)
    assert out.stdout.strip() == "", f"ignored by .gitignore:\n{out.stdout}"
