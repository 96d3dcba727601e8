"""Synthetic text-line dataset generator, without PIL or OpenCV.

The port's counterpart of ``rcnn_ocr_tpu/data/synthetic.py``: the same
names, signatures, random draws and files.  Image ``i`` is rendered from
``default_rng([seed, i])`` (its first draw picks the font), labels come from
``default_rng([seed, 0xA11CE])``, and each difficulty's parameters are drawn
in the table's order, only for ranges that are not a single value.

The stages and what stands in for JAX's libraries:

* glyphs: :class:`~rcnn_ocr_tpu_torch.data.truetype.TrueTypeFont` (a
  hand-written TrueType reader, shaper and rasterizer) for PIL's
  ``ImageFont`` / ``textbbox`` / ``draw.text``.  Layout and widths follow
  PIL's; the outline is not hinted, so edge pixels differ (the bound is in
  ``tests/test_torch_port_synthetic.py``);
* shear and rotation: ``data/transforms.py``'s ``warp_affine`` and
  ``rotation_matrix`` (within one uint8 step of ``cv2.warpAffine``);
* blur, JPEG round trip and the area resize: ``data/effects.py``, bit for
  bit cv2's;
* gradient and noise: the same numpy as JAX's;
* files: PNG through ``data/image_io.py:png_encode``, the CSVs through
  ``csv`` as JAX writes them.

Generation runs on the host, as in JAX: nothing here touches a device.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import glob
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rcnn_ocr_tpu_torch.data.effects import area_resize_u8, gaussian_blur_u8, jpeg_round_trip
from rcnn_ocr_tpu_torch.data.image_io import png_encode
from rcnn_ocr_tpu_torch.data.transforms import rotation_matrix, warp_affine
from rcnn_ocr_tpu_torch.data.truetype import TrueTypeFont

__all__ = [
    "discover_fonts",
    "render_line",
    "sample_texts",
    "generate_dataset",
    "stage_seconds",
    "apply_effects",
    "DIFFICULTIES",
    "GENERATION_ALPHABET",
    "HOMOGLYPH_FREE_ALPHABET",
]

# The characters the DejaVu family covers with real glyphs (a subset of
# configs/charset.txt).  It holds Latin/Cyrillic homoglyph pairs (a/а, c/с,
# e/е, o/о, p/р, x/х, y/у and their uppers) that render alike, so
# exact-match accuracy on random labels saturates below 1.0.
GENERATION_ALPHABET = (
    " "
    + "abcdefghijklmnopqrstuvwxyz"
    + "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    + "0123456789"
    + "абвгдеёжзийклмнопрстуфхцчшщъыьэюя"
    + "АБВГДЕЁЖЗИЙКЛМНОПРСТУФХЦЧШЩЪЫЬЭЮЯ"
    + ".,:;!?-()\"'/%№"
)

# GENERATION_ALPHABET without the homoglyph pairs, sans-serif I / l, and
# з / З against the digit 3: every remaining pair is distinct in DejaVu.
HOMOGLYPH_FREE_ALPHABET = (
    " "
    + "bdfghijklmnqrstuvwz"
    + "DFGJLNQRSUVWZ"
    + "0123456789"
    + "бвгдёжийлмнптфцчшщъыьэюя"
    + "БГДЁЖИЙЛПФЦЧШЩЪЫЬЭЮЯ"
    + ".,:;!?-()\"'/%№"
)

_FONT_DIRS = ("/usr/share/fonts", "/usr/local/share/fonts")

# Effect-chain parameter ranges per difficulty, drawn per image from its own
# rng stream in this order.
DIFFICULTIES: Dict[str, Dict[str, Tuple[float, float]]] = {
    "clean": {
        "paper": (235, 255),
        "ink": (0, 45),
        "shear": (0.0, 0.0),
        "rotate_deg": (0.0, 0.0),
        "blur_sigma": (0.0, 0.0),
        "noise_std": (0.0, 2.0),
        "jpeg_q": (0, 0),  # 0 = off
        "gradient": (0.0, 0.0),
    },
    "medium": {
        "paper": (215, 255),
        "ink": (0, 70),
        "shear": (-0.18, 0.18),
        "rotate_deg": (-1.5, 1.5),
        "blur_sigma": (0.0, 0.7),
        "noise_std": (1.0, 6.0),
        "jpeg_q": (0, 0),
        "gradient": (0.0, 10.0),
    },
    "hard": {
        "paper": (190, 255),
        "ink": (0, 95),
        "shear": (-0.3, 0.3),
        "rotate_deg": (-3.0, 3.0),
        "blur_sigma": (0.0, 1.1),
        "noise_std": (2.0, 12.0),
        "jpeg_q": (35, 80),
        "gradient": (0.0, 25.0),
    },
}

STAGES = ("glyphs", "warp", "blur", "noise", "jpeg", "resize", "png")
_timing = threading.local()


@contextlib.contextmanager
def stage_seconds():
    """Within the block, this thread's :func:`render_line` and
    :func:`generate_dataset` calls add each stage's host seconds to the
    yielded dict (keys :data:`STAGES`; ``glyphs`` includes measuring and
    the canvas, ``noise`` the gradient)."""
    totals = dict.fromkeys(STAGES, 0.0)
    outer = getattr(_timing, "totals", None)
    _timing.totals = totals
    try:
        yield totals
    finally:
        _timing.totals = outer


class _Clock:
    def __init__(self):
        self.totals = getattr(_timing, "totals", None)
        self.t = time.perf_counter()

    def lap(self, stage: str) -> None:
        if self.totals is not None:
            now = time.perf_counter()
            self.totals[stage] += now - self.t
            self.t = now


@functools.lru_cache(maxsize=64)
def _font(path: str, size: int) -> TrueTypeFont:
    return TrueTypeFont(path, size)


def discover_fonts(dirs: Sequence[str] = _FONT_DIRS) -> List[str]:
    """TrueType font files under ``dirs`` that the reader parses, sorted
    (the per-image rng indexes this list, so its order is part of the
    dataset)."""
    found: List[str] = []
    for d in dirs:
        found.extend(glob.glob(os.path.join(d, "**", "*.ttf"), recursive=True))
    usable = []
    for path in sorted(found):
        try:
            TrueTypeFont(path, 24)
        except (OSError, ValueError):
            continue
        usable.append(path)
    return usable


def _draw_params(rng: np.random.Generator, spec: Dict[str, Tuple[float, float]]):
    out = {}
    for key, (lo, hi) in spec.items():
        out[key] = float(lo) if lo == hi else float(rng.uniform(lo, hi))
    return out


def render_line(
    text: str,
    font_path: str,
    *,
    img_h: int = 48,
    rng: Optional[np.random.Generator] = None,
    difficulty: str = "medium",
    max_w: int = 2048,
) -> np.ndarray:
    """Render ``text`` as an RGB uint8 line image of height ``img_h``:
    glyphs at twice the height, the difficulty's effects, then an area
    downsample; the width follows the text, squashed to at most ``max_w``."""
    if difficulty not in DIFFICULTIES:
        raise ValueError(f"difficulty must be one of {sorted(DIFFICULTIES)}")
    rng = rng if rng is not None else np.random.default_rng(0)
    clock = _Clock()
    p = _draw_params(rng, DIFFICULTIES[difficulty])

    render_h = img_h * 2
    font = _font(font_path, int(render_h * 0.7))
    bbox = font.getbbox(text or " ")
    text_w = max(1, bbox[2] - bbox[0])
    text_h = max(1, bbox[3] - bbox[1])
    pad_x = max(4, render_h // 6)
    canvas_w = min(int(text_w + 2 * pad_x + abs(p["shear"]) * render_h), 1 << 15)

    paper = int(p["paper"])
    arr = np.full((render_h, canvas_w), paper, np.uint8)
    y = (render_h - text_h) // 2 - bbox[1]
    font.draw(arr, (pad_x - bbox[0], y), text, int(p["ink"]))
    clock.lap("glyphs")
    return np.repeat(apply_effects(arr, p, rng, img_h=img_h, max_w=max_w, clock=clock)[:, :, None],
                     3, axis=2)


def apply_effects(arr: np.ndarray, p: Dict[str, float], rng: np.random.Generator, *,
                  img_h: int, max_w: int = 2048, clock: Optional[_Clock] = None) -> np.ndarray:
    """The effect chain of :func:`render_line` on a gray uint8 canvas drawn
    at twice ``img_h`` with paper ``p["paper"]``: shear, rotation,
    gradient, blur, noise, JPEG, then the area downsample to ``img_h`` (gray
    uint8 out).  ``rng`` continues the line's stream after the parameters."""
    clock = clock if clock is not None else _Clock()
    paper = int(p["paper"])
    render_h = arr.shape[0]
    if p["shear"] != 0.0:
        m = np.float32([[1.0, p["shear"], -p["shear"] * render_h / 2], [0.0, 1.0, 0.0]])
        arr = warp_affine(arr, m.astype(np.float64), fill=paper)
    if p["rotate_deg"] != 0.0:
        m = rotation_matrix((arr.shape[1] / 2, arr.shape[0] / 2), p["rotate_deg"], 1.0)
        arr = warp_affine(arr, m, fill=paper)
    clock.lap("warp")

    if p["gradient"] > 0.0:
        ramp = np.linspace(-p["gradient"], p["gradient"], arr.shape[1], dtype=np.float32)
        if rng.uniform() < 0.5:
            ramp = ramp[::-1]
        arr = np.clip(arr.astype(np.float32) + ramp[None, :], 0, 255).astype(np.uint8)
    clock.lap("noise")
    if p["blur_sigma"] > 0.05:
        arr = gaussian_blur_u8(arr, p["blur_sigma"])
    clock.lap("blur")
    if p["noise_std"] > 0.0:
        noise = rng.normal(0.0, p["noise_std"], size=arr.shape).astype(np.float32)
        arr = np.clip(arr.astype(np.float32) + noise, 0, 255).astype(np.uint8)
    clock.lap("noise")
    if p["jpeg_q"] > 0:
        arr = jpeg_round_trip(arr, int(p["jpeg_q"]))
    clock.lap("jpeg")

    out_w = max(8, min(max_w, int(round(arr.shape[1] * img_h / arr.shape[0]))))
    arr = area_resize_u8(arr, img_h, out_w)
    clock.lap("resize")
    return arr


def sample_texts(
    n: int,
    rng: np.random.Generator,
    *,
    alphabet: str = GENERATION_ALPHABET,
    corpus: Optional[Sequence[str]] = None,
    min_words: int = 1,
    max_words: int = 3,
    min_word_len: int = 2,
    max_word_len: int = 8,
    max_len: int = 25,
) -> List[str]:
    """Sample ``n`` labels: corpus words when given, else random words
    drawn from ``alphabet`` (space excluded inside words).  Every label is
    truncated to ``max_len`` characters (the decoder's label budget)."""
    letters = [c for c in alphabet if c != " "]
    if not letters and corpus is None:
        raise ValueError("alphabet has no non-space characters")
    out: List[str] = []
    for _ in range(n):
        k = int(rng.integers(min_words, max_words + 1))
        words = []
        for _ in range(k):
            if corpus:
                words.append(str(corpus[int(rng.integers(0, len(corpus)))]))
            else:
                wl = int(rng.integers(min_word_len, max_word_len + 1))
                words.append("".join(rng.choice(letters, size=wl)))
        label = " ".join(words)[:max_len].strip()
        out.append(label or "".join(rng.choice(letters, size=1)))
    return out


def generate_dataset(
    out_dir: str,
    n: int,
    *,
    seed: int = 0,
    img_h: int = 48,
    difficulty: str = "medium",
    alphabet: str = GENERATION_ALPHABET,
    corpus: Optional[Sequence[str]] = None,
    labels: Optional[Sequence[str]] = None,
    fonts: Optional[Sequence[str]] = None,
    csv_name: str = "labels.csv",
    header: bool = False,
    max_len: int = 25,
    ext: str = ".png",
) -> Tuple[str, str]:
    """Render a dataset into ``out_dir``; returns ``(csv_path, out_dir)``:
    one PNG a line (``ext`` must be ``.png``) plus a ``filename,text`` CSV
    (headerless, the training convention; ``header=True`` for the eval
    CLI's form)."""
    if ext.lower() != ".png":
        raise ValueError(f"the port writes PNG lines only, not {ext!r}")
    fonts = list(fonts) if fonts else discover_fonts()
    if not fonts:
        raise RuntimeError("no usable TrueType fonts found — pass fonts=[...]")
    os.makedirs(out_dir, exist_ok=True)
    if labels is None:
        labels = sample_texts(
            n, np.random.default_rng([seed, 0xA11CE]),
            alphabet=alphabet, corpus=corpus, max_len=max_len,
        )
    else:
        labels = [str(t)[:max_len] for t in labels][:n]
    csv_path = os.path.join(out_dir, csv_name)
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        wr = csv.writer(f)
        if header:
            wr.writerow(["filename", "text"])
        for i, label in enumerate(labels):
            rng = np.random.default_rng([seed, i])
            font = fonts[int(rng.integers(0, len(fonts)))]
            img = render_line(label, font, img_h=img_h, rng=rng, difficulty=difficulty)
            clock = _Clock()
            fname = f"syn_{i:06d}{ext}"
            with open(os.path.join(out_dir, fname), "wb") as out:
                out.write(png_encode(img))
            clock.lap("png")
            wr.writerow([fname, label])
    return csv_path, out_dir
