"""``python -m rcnn_ocr_tpu_torch.make_default_charset`` vs the JAX
package's ``tools/make_default_charset.py``, both run as subprocesses:
the same bytes, the same printed line, the parent directories made alike,
and the shipped ``configs/charset.txt`` reproduced."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SHIPPED = REPO / "configs" / "charset.txt"


def _run(argv, cwd):
    done = subprocess.run([sys.executable, *argv], capture_output=True, text=True, cwd=cwd,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert done.returncode == 0, done.stderr
    return done.stdout


def _both(tmp_path, *args):
    """(JAX's stdout, the port's stdout, JAX's dir, the port's dir): each
    tool run in a directory of its own with the same arguments."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    want = _run([str(REPO / "tools" / "make_default_charset.py"), *args], jax_dir)
    got = _run(["-m", "rcnn_ocr_tpu_torch.make_default_charset", *args], port_dir)
    return want, got, jax_dir, port_dir


@pytest.mark.parametrize("out", ["charset.txt", "deep/nested/dir/cs.txt", None])
def test_writes_the_same_file_and_line_as_the_jax_tool(out, tmp_path):
    """A bare name, a path under directories that do not exist yet (both
    make them), and no argument (``configs/charset.txt`` under the cwd)."""
    args = [] if out is None else [out]
    want, got, jax_dir, port_dir = _both(tmp_path, *args)
    rel = out or "configs/charset.txt"
    assert got == want == f"wrote 194 tokens to {rel}\n"
    assert (port_dir / rel).read_bytes() == (jax_dir / rel).read_bytes()
    assert sorted(p.relative_to(port_dir) for p in port_dir.rglob("*")) == \
        sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*"))


def test_reproduces_the_shipped_charset(tmp_path):
    _run(["-m", "rcnn_ocr_tpu_torch.make_default_charset", str(tmp_path / "cs.txt")], tmp_path)
    assert (tmp_path / "cs.txt").read_bytes() == SHIPPED.read_bytes()


def test_tokens_equal_the_jax_tools_and_the_ports_charset_loader(tmp_path):
    """The token list itself, and the port's charset reader over the file
    (194 tokens, the specials first, ids in file order)."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import make_default_charset as jax_tool
    finally:
        sys.path.remove(str(REPO / "tools"))
    from rcnn_ocr_tpu_torch import make_default_charset as port_tool
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    assert port_tool.default_tokens() == jax_tool.default_tokens()
    port_tool.main(str(tmp_path / "cs.txt"))
    cs = Charset.from_file(str(tmp_path / "cs.txt"))
    assert len(cs.itos) == 194 and cs.itos[:3] == ("<PAD>", "<SOS>", "<EOS>")
    assert cs.itos == tuple(jax_tool.default_tokens())
