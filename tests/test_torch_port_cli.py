"""``python -m rcnn_ocr_tpu_torch.minimal_inference`` vs ``minimal_inference.py``, fp32 on the CPU.

One seeded checkpoint, its charset and bigram table, and line images in
the formats a user's file may take (PNG, lossless JPEG, BigTIFF, CIELab
TIFF); each script runs in-process with ``sys.argv`` set and its
``OCRInference`` fixed to fp32 (the port's also to ``device="cpu"`` where
no ``--device`` is given), and the printed ``Result:`` lines must be
equal:

* greedy, ``--serving``, ``--beam-width 3 --lm ... --lm-weight 0.5
  --length-penalty 0.6`` (plain and under ``--serving``), ``--width-buckets``,
  ``--img-h / --img-w`` and ``--quantize``;
* ``--lm-weight`` or ``--length-penalty`` without a beam raise
  ``ValueError`` in both;
* without ``--device`` the port asks for the card and raises where there
  is none (no fallback to the CPU); ``--device cpu`` runs.
"""

import functools
import shutil
import sys
from pathlib import Path

import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import minimal_inference  # noqa: E402
from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference  # noqa: E402
from rcnn_ocr_tpu_torch import minimal_inference as port_cli  # noqa: E402
from rcnn_ocr_tpu_torch.data.image_io import png_encode  # noqa: E402
from rcnn_ocr_tpu_torch.inference import OCRInference  # noqa: E402
from tests.test_torch_port_beam_engine import IMG_H, IMG_W, _images, files  # noqa: E402,F401

FIXTURES = Path(__file__).resolve().parent / "torch_port_data"


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_images")
    out = {}
    for i, img in enumerate(_images(2, seed=11, widths=(48, 64))):
        out[f"line{i}.png"] = root / f"line{i}.png"
        out[f"line{i}.png"].write_bytes(png_encode(img))
    for rel in ("jpeg/lossless_line_0.jpg", "tiff/bigtiff_line_0.tif", "tiff/cielab_line_0.tif"):
        out[Path(rel).name] = root / Path(rel).name
        shutil.copy(FIXTURES / rel, out[Path(rel).name])
    return {k: str(v) for k, v in out.items()}


def _result(main, argv, monkeypatch, capsys, script):
    monkeypatch.setattr(sys, "argv", [script, *argv])
    main()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Result: ")]
    assert len(lines) == 1
    return lines[0]


def _both(argv, monkeypatch, capsys, port_extra=("--device", "cpu")):
    monkeypatch.setattr(minimal_inference, "OCRInference",
                        functools.partial(JaxOCRInference, dtype=jnp.float32, verbose=False))
    monkeypatch.setattr(port_cli, "OCRInference",
                        functools.partial(OCRInference, dtype=torch.float32))
    want = _result(minimal_inference.main, argv, monkeypatch, capsys, "minimal_inference.py")
    got = _result(port_cli.main, [*argv, *port_extra], monkeypatch, capsys,
                  "rcnn_ocr_tpu_torch.minimal_inference")
    return got, want


FLAGS = {
    "greedy": [],
    "serving": ["--serving"],
    "beam_lm": ["--beam-width", "3", "--lm", "{lm}", "--lm-weight", "0.5",
                "--length-penalty", "0.6"],
    "serving_beam_lm": ["--serving", "--beam-width", "3", "--lm", "{lm}", "--lm-weight", "0.5",
                        "--length-penalty", "0.6"],
    "width_buckets": ["--width-buckets", "40,64"],
    "img_size": ["--img-h", "32", "--img-w", "48"],
    "quantize": ["--quantize"],
}


# each flag set on one or two of the images, every image at least once
CASES = [("greedy", "line0.png"), ("greedy", "lossless_line_0.jpg"),
         ("greedy", "bigtiff_line_0.tif"), ("serving", "line1.png"),
         ("serving", "cielab_line_0.tif"), ("beam_lm", "line0.png"),
         ("serving_beam_lm", "line1.png"), ("width_buckets", "lossless_line_0.jpg"),
         ("img_size", "line1.png"), ("quantize", "line0.png")]


@pytest.mark.parametrize("flags,image", CASES)
def test_result_line_matches_jax(files, images, monkeypatch, capsys, flags, image):
    ckpt, charset, lm = files
    size = [] if flags == "img_size" else ["--img-h", str(IMG_H), "--img-w", str(IMG_W)]
    argv = [ckpt, charset, images[image], *size, *(f.format(lm=lm) for f in FLAGS[flags])]
    got, want = _both(argv, monkeypatch, capsys)
    assert got == want


def test_the_images_read_apart(files, images):
    """The comparison means something: the random model reads the lines to
    different strings."""
    ckpt, charset, _ = files
    ocr = OCRInference(ckpt, charset, device="cpu", dtype=torch.float32, img_h=IMG_H,
                       img_w=IMG_W)
    assert len(set(ocr.predict([images[k] for k in sorted(images)]))) >= 2


@pytest.mark.parametrize("knob", [["--lm-weight", "0.5"], ["--length-penalty", "0.6"],
                                  ["--serving", "--lm-weight", "0.5"]])
def test_beam_knobs_without_a_beam_raise_in_both(files, images, monkeypatch, capsys, knob):
    ckpt, charset, lm = files
    argv = [ckpt, charset, images["line0.png"], "--lm", lm, *knob]
    with pytest.raises(ValueError):
        _result(minimal_inference.main, argv, monkeypatch, capsys,
                "minimal_inference.py")
    with pytest.raises(ValueError):
        _result(port_cli.main, [*argv, "--device", "cpu"], monkeypatch, capsys,
                "rcnn_ocr_tpu_torch.minimal_inference")


def test_default_device_is_the_card_and_raises_without_one(files, images, monkeypatch, capsys):
    ckpt, charset, _ = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _result(port_cli.main, [ckpt, charset, images["line0.png"]], monkeypatch, capsys,
                "rcnn_ocr_tpu_torch.minimal_inference")
    line = _result(port_cli.main, [ckpt, charset, images["line0.png"], "--device", "cpu"],
                   monkeypatch, capsys, "rcnn_ocr_tpu_torch.minimal_inference")
    assert line.startswith("Result: '")


def test_module_runs_as_a_script(files, images):
    """``python -m rcnn_ocr_tpu_torch.minimal_inference ... --device cpu``
    prints the engine's string for the image (bf16, the engine's default)."""
    import subprocess

    ckpt, charset, _ = files
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-m", "rcnn_ocr_tpu_torch.minimal_inference", ckpt,
                          charset, images["line1.png"], "--img-h", str(IMG_H), "--img-w",
                          str(IMG_W), "--device", "cpu"], cwd=repo, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = OCRInference(ckpt, charset, device="cpu", img_h=IMG_H, img_w=IMG_W).predict(
        images["line1.png"])
    assert out.stdout.strip().splitlines()[-1] == f"Result: '{want}'"
