"""The port's synthetic line generator against the JAX package's (CPU).

``rcnn_ocr_tpu_torch/data/synthetic.py`` and ``python -m
rcnn_ocr_tpu_torch.make_synthetic_dataset`` take the place of
``rcnn_ocr_tpu/data/synthetic.py`` and ``tools/make_synthetic_dataset.py``
without PIL or cv2 (only this test imports them).  Held:

* bit-equal: labels (alphabet, corpus and ``max_len`` modes), each line's
  drawn parameters, its font pick and the draws after them, and both CLIs'
  CSVs, ``val/eval.csv``, ``charset.txt`` and ``config.json`` (paths aside)
  for each difficulty and for ``--chars homoglyph-free``;
* per stage against cv2 on seeded inputs: ``gaussian_blur_u8`` and the
  area resize bit-equal, ``jpeg_encode_gray`` byte-equal for q 35, 50 and
  80, the shear and the rotation within ``warp_affine``'s one uint8 step;
* the effect chain on PIL's own canvas (JAX's ``render_line`` lines
  184-200) against JAX's ``render_line``: ``clean`` bit-equal, ``medium``
  within one uint8 step, ``hard`` within 6 steps and 0.05 of mean |Δ| a
  line (measured: 3 and 0.0112, from warp differences of one step that the
  blur, noise and JPEG carry), every JPEG stage's bytes equal cv2's on its
  input;
* the glyph layer (the deliberate divergence: the port does not run the
  fonts' TrueType hinting), 64 seeded ``clean`` lines a DejaVu font at
  ``img_h`` 32 and 48: output widths equal on at least 98% of lines and
  within 1 px on every line (measured: all 768 equal); mean |Δ| over all
  lines of equal width at most 4 gray levels (measured 2.077) and at most
  13 on any line (measured 11.92: where the unhinted box puts the baseline
  one render row off PIL's, 70 of 768 lines, those lines' mean is 5.8-8.1);
  ink mass Σ(paper − pixel) over all lines within 5% of JAX's (measured
  +0.9%) and within 8% on any line (measured 7.45%: hinting thins DejaVu
  Serif's stems at font size 44, +3.5% on that font's lines);
* the font reader against PIL on prefixes of seeded labels: ``getlength``,
  the box's left and right, ``getmetrics`` equal;
* ``generate_dataset``'s output loads through the port's ``OCRDataset``
  with every row read; a seeded set a difficulty from the carried font
  gives ``tests/torch_port_data/synthetic/expected.json``'s digest;
* the port's CLI output trains through ``python -m
  rcnn_ocr_tpu_torch.training.train`` on the CPU (a shrunk model).
"""

import csv
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

import rcnn_ocr_tpu.data.synthetic as jax_synth
import rcnn_ocr_tpu_torch.data.synthetic as port_synth
from rcnn_ocr_tpu_torch import make_synthetic_dataset as port_cli
from rcnn_ocr_tpu_torch import native
from rcnn_ocr_tpu_torch.data.effects import area_resize_u8, gaussian_blur_u8, jpeg_round_trip
from rcnn_ocr_tpu_torch.data.transforms import rotation_matrix, warp_affine
from rcnn_ocr_tpu_torch.data.truetype import TrueTypeFont

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_port_data")
CARRIED = os.path.join(FIXTURES, "fonts", "DejaVuSans.ttf")
DIFFS = ("clean", "medium", "hard")


def _load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_cli = _load_module("jax_make_synthetic_dataset", os.path.join(REPO, "tools",
                                                                    "make_synthetic_dataset.py"))
fixtures = _load_module("make_synthetic_fixtures", os.path.join(FIXTURES,
                                                               "make_synthetic_fixtures.py"))


@pytest.fixture(scope="module")
def fonts():
    found = jax_synth.discover_fonts()
    if not any(os.path.basename(f).startswith("DejaVu") for f in found):
        pytest.skip("no DejaVu fonts on this host")
    return found


# ---- labels, draws, fonts ----------------------------------------------------


@pytest.mark.parametrize("mode", ["generation", "homoglyph_free", "corpus", "max_len_7",
                                  "narrow_alphabet"])
def test_labels_are_bit_equal(mode):
    kw = {"generation": {}, "homoglyph_free": {"alphabet": jax_synth.HOMOGLYPH_FREE_ALPHABET},
          "corpus": {"corpus": ["alpha", "бета", "gamma", "δ", "epsilon-zeta"]},
          "max_len_7": {"max_len": 7}, "narrow_alphabet": {"alphabet": " ab"}}[mode]
    for seed in (0, 1, 1_000_003):
        want = jax_synth.sample_texts(200, np.random.default_rng([seed, 0xA11CE]), **kw)
        got = port_synth.sample_texts(200, np.random.default_rng([seed, 0xA11CE]), **kw)
        assert got == want


def test_alphabets_and_difficulties_are_jax_s():
    assert port_synth.GENERATION_ALPHABET == jax_synth.GENERATION_ALPHABET
    assert port_synth.HOMOGLYPH_FREE_ALPHABET == jax_synth.HOMOGLYPH_FREE_ALPHABET
    assert port_synth.DIFFICULTIES == jax_synth.DIFFICULTIES
    assert list(port_synth.DIFFICULTIES) == list(jax_synth.DIFFICULTIES)
    for spec in port_synth.DIFFICULTIES.values():
        assert list(spec) == list(jax_synth.DIFFICULTIES["clean"])


@pytest.mark.parametrize("difficulty", DIFFS)
def test_parameters_font_picks_and_later_draws_are_bit_equal(fonts, difficulty):
    labels = jax_synth.sample_texts(24, np.random.default_rng([5, 0xA11CE]))
    for i, label in enumerate(labels):
        ra, rb = np.random.default_rng([5, i]), np.random.default_rng([5, i])
        fa, fb = fonts[int(ra.integers(0, len(fonts)))], fonts[int(rb.integers(0, len(fonts)))]
        assert fa == fb
        sa, sb = ra.bit_generator.state, rb.bit_generator.state
        assert jax_synth._draw_params(ra, jax_synth.DIFFICULTIES[difficulty]) == \
            port_synth._draw_params(rb, port_synth.DIFFICULTIES[difficulty])
        ra.bit_generator.state, rb.bit_generator.state = sa, sb
        jax_synth.render_line(label, fa, img_h=24, rng=ra, difficulty=difficulty)
        port_synth.render_line(label, fb, img_h=24, rng=rb, difficulty=difficulty)
        # the gradient's coin and the noise consumed the same draws
        assert ra.bit_generator.state == rb.bit_generator.state


def test_discover_fonts_is_jax_s_and_skips_what_it_cannot_parse(fonts, tmp_path):
    assert port_synth.discover_fonts() == fonts
    (tmp_path / "sub").mkdir()
    shutil.copy(CARRIED, tmp_path / "sub" / "good.ttf")
    (tmp_path / "bad.ttf").write_bytes(b"\x00\x01\x00\x00" + bytes(40))
    (tmp_path / "text.ttf").write_text("not a font")
    want = [str(tmp_path / "sub" / "good.ttf")]
    assert jax_synth.discover_fonts([str(tmp_path)]) == want
    assert port_synth.discover_fonts([str(tmp_path)]) == want


def test_render_line_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="difficulty"):
        port_synth.render_line("ab", CARRIED, difficulty="extreme")
    with pytest.raises(ValueError):
        TrueTypeFont(os.path.join(FIXTURES, "fonts", "DejaVuSans.LICENSE"), 20)


def test_damaged_fonts_raise_or_render(tmp_path):
    """A font is input from outside the program: bytes flipped inside each
    table the reader reads, and files cut short, either raise ValueError
    when opened or lay out and draw."""
    import struct

    data = open(CARRIED, "rb").read()
    tables = {}
    for k in range(struct.unpack(">H", data[4:6])[0]):
        tag, _, off, length = struct.unpack(">4sIII", data[12 + 16 * k: 28 + 16 * k])
        tables[tag.decode()] = (off, length)
    rng = np.random.default_rng(0)
    names = ["glyf", "cmap", "GSUB", "GPOS", "GDEF", "loca", "hmtx", "hhea", "head", "maxp"]
    opened = 0
    for k in range(300):
        raw = bytearray(data)
        if k % 11 == 10:
            raw = raw[: int(rng.integers(0, len(raw)))]
        else:
            off, length = tables[names[k % len(names)]]
            for _ in range(int(rng.integers(1, 20))):
                raw[int(rng.integers(off, off + min(length, 4000)))] = int(rng.integers(0, 256))
        path = str(tmp_path / "damaged.ttf")
        with open(path, "wb") as f:
            f.write(raw)
        try:
            font = TrueTypeFont(path, 44)
        except ValueError:
            continue
        opened += 1
        canvas = np.zeros((96, 900), np.uint8)
        for text in ("AV fi Wa ёй№ (xyz) 0123", "ffl To"):
            try:
                font.getbbox(text)
                font.draw(canvas, (5, 5), text, 0)
            except ValueError:
                pass
    assert 0 < opened < 300


# ---- the CLI ---------------------------------------------------------------


@pytest.mark.parametrize("args", [["--difficulty", "clean"], ["--difficulty", "medium"],
                                  ["--difficulty", "hard"], ["--chars", "homoglyph-free"]],
                         ids=["clean", "medium", "hard", "homoglyph-free"])
def test_cli_writes_jax_s_files(fonts, tmp_path, args, capsys):
    common = ["--n-train", "16", "--n-val", "8", "--img-h", "24", "--seed", "3", *args]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli.main(["--out", jax_out, *common]) == 0
    assert port_cli.main(["--out", port_out, *common]) == 0
    for rel in ("train/labels.csv", "val/labels.csv", "val/eval.csv", "charset.txt"):
        with open(os.path.join(jax_out, rel), "rb") as a, open(os.path.join(port_out, rel), "rb") as b:
            assert a.read() == b.read(), rel
    with open(os.path.join(jax_out, "config.json"), encoding="utf-8") as f:
        want = f.read().replace(jax_out, "OUT")
    with open(os.path.join(port_out, "config.json"), encoding="utf-8") as f:
        got = f.read().replace(port_out, "OUT")
    assert got == want
    for split in ("train", "val"):
        names = sorted(n for n in os.listdir(os.path.join(jax_out, split)) if n.endswith(".png"))
        assert names == sorted(n for n in os.listdir(os.path.join(port_out, split))
                               if n.endswith(".png"))
        for name in names:
            a = cv2.imread(os.path.join(jax_out, split, name))
            b = cv2.imread(os.path.join(port_out, split, name))
            assert a.shape[0] == b.shape[0] == 24 and abs(a.shape[1] - b.shape[1]) <= 1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[4]  # "[synth] wrote ... (difficulty, N fonts, T-token charset)"


def test_cli_corpus_extends_the_alphabet_as_jax_s(fonts, tmp_path, capsys):
    corpus = tmp_path / "words.txt"
    corpus.write_text("café\nnaïve\n\nword\n", encoding="utf-8")
    common = ["--n-train", "4", "--n-val", "2", "--img-h", "16", "--corpus", str(corpus)]
    assert jax_cli.main(["--out", str(tmp_path / "jax"), *common]) == 0
    assert port_cli.main(["--out", str(tmp_path / "port"), *common]) == 0
    for rel in ("train/labels.csv", "charset.txt"):
        assert (tmp_path / "jax" / rel).read_bytes() == (tmp_path / "port" / rel).read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[synth] extended alphabet") and out[0] == out[5]


# ---- stages against cv2 ------------------------------------------------------


@pytest.mark.parametrize("sigma", [0.0501, 0.08, 0.25, 0.4167, 0.5, 0.58, 0.7, 0.75, 0.9, 1.0,
                                   1.1])
def test_gaussian_blur_is_bit_equal_to_cv2(sigma):
    rng = np.random.default_rng(int(sigma * 1e4))
    for h, w in ((96, 300), (1, 7), (2, 2), (5, 1), (13, 40)):
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        np.testing.assert_array_equal(gaussian_blur_u8(img, sigma),
                                      cv2.GaussianBlur(img, (0, 0), sigmaX=sigma))


def test_gaussian_blur_fuzz_is_bit_equal_to_cv2():
    rng = np.random.default_rng(0)
    for _ in range(200):
        sigma = float(rng.uniform(0.05, 1.1))
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        np.testing.assert_array_equal(gaussian_blur_u8(img, sigma),
                                      cv2.GaussianBlur(img, (0, 0), sigmaX=sigma))


@pytest.mark.parametrize("quality", [35, 50, 80])
def test_jpeg_encode_is_byte_equal_to_cv2(quality):
    rng = np.random.default_rng(quality)
    for k in range(24):
        h, w = (int(v) for v in rng.integers(1, 120, 2))
        if k % 3 == 0:
            img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        elif k % 3 == 1:
            img = np.clip(rng.normal(200, 12, (h, w)), 0, 255).astype(np.uint8)
            img[:, : w // 3] = rng.integers(0, 60)
        else:
            img = np.full((h, w), int(rng.integers(0, 256)), np.uint8)
        want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
        assert native.jpeg_encode_gray(img, quality) == want
        np.testing.assert_array_equal(
            jpeg_round_trip(img, quality),
            cv2.imdecode(np.frombuffer(want, np.uint8), cv2.IMREAD_GRAYSCALE))


def test_jpeg_encode_all_qualities_on_a_line_is_byte_equal_to_cv2():
    img = np.clip(np.random.default_rng(1).normal(180, 40, (96, 517)), 0, 255).astype(np.uint8)
    for q in range(1, 101):
        assert native.jpeg_encode_gray(img, q) == \
            cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()


def test_area_resize_is_bit_equal_to_cv2():
    rng = np.random.default_rng(2)
    for k in range(120):
        h = int(rng.choice([16, 48, 64, 96]))
        w = int(rng.integers(9, 5000 if k % 10 == 0 else 700))
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        out_w = max(8, min(2048, int(round(w * (h // 2) / h))))
        if out_w > w:
            continue
        np.testing.assert_array_equal(area_resize_u8(img, h // 2, out_w),
                                      cv2.resize(img, (out_w, h // 2),
                                                 interpolation=cv2.INTER_AREA))


def test_shear_and_rotation_are_within_warp_affines_bound():
    rng = np.random.default_rng(3)
    for _ in range(16):
        h, w = 96, int(rng.integers(100, 600))
        img = np.full((h, w), int(rng.integers(190, 256)), np.uint8)
        img[30:70, 20:w - 20] = rng.integers(0, 256, (40, w - 40))
        paper = int(img[0, 0])
        shear = float(rng.uniform(-0.3, 0.3))
        m = np.float32([[1.0, shear, -shear * h / 2], [0.0, 1.0, 0.0]])
        angle = float(rng.uniform(-3, 3))
        r = rotation_matrix((w / 2, h / 2), angle, 1.0)
        np.testing.assert_allclose(r, cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0))
        for mat in (m.astype(np.float64), r):
            want = cv2.warpAffine(img, mat.astype(np.float32) if mat is not r else mat, (w, h),
                                  flags=cv2.INTER_LINEAR, borderValue=paper)
            got = warp_affine(img, mat, fill=paper)
            d = np.abs(got.astype(int) - want)
            assert d.max() <= 1 and (d > 0).mean() < 0.01


# ---- the effect chain on PIL's canvas ----------------------------------------


def _pil_canvas(text, font_path, img_h, p):
    """JAX's render_line lines 184-200: the glyphs PIL draws."""
    render_h = img_h * 2
    font = ImageFont.truetype(font_path, int(render_h * 0.7))
    probe = ImageDraw.Draw(Image.new("L", (4, 4)))
    bbox = probe.textbbox((0, 0), text or " ", font=font)
    text_w = max(1, bbox[2] - bbox[0])
    text_h = max(1, bbox[3] - bbox[1])
    pad_x = max(4, render_h // 6)
    canvas_w = min(int(text_w + 2 * pad_x + abs(p["shear"]) * render_h), 1 << 15)
    img = Image.new("L", (canvas_w, render_h), color=int(p["paper"]))
    y = (render_h - text_h) // 2 - bbox[1]
    ImageDraw.Draw(img).text((pad_x - bbox[0], y), text, font=font, fill=int(p["ink"]))
    return np.asarray(img, dtype=np.uint8).copy()


@pytest.mark.parametrize("difficulty,max_step,max_line_mean", [("clean", 0, 0.0),
                                                                ("medium", 1, 0.01),
                                                                ("hard", 6, 0.05)])
def test_effect_chain_on_pil_canvas_matches_jax(fonts, monkeypatch, difficulty, max_step,
                                                 max_line_mean):
    jpeg_inputs = []

    def recording(arr, q):
        jpeg_inputs.append((arr.copy(), q))
        return jpeg_round_trip(arr, q)

    monkeypatch.setattr(port_synth, "jpeg_round_trip", recording)
    labels = jax_synth.sample_texts(64, np.random.default_rng([7, 0xA11CE]))
    for i, label in enumerate(labels):
        ra = np.random.default_rng([7, i])
        font = fonts[int(ra.integers(0, len(fonts)))]
        want = jax_synth.render_line(label, font, img_h=32, rng=ra, difficulty=difficulty)
        rb = np.random.default_rng([7, i])
        rb.integers(0, len(fonts))
        p = port_synth._draw_params(rb, port_synth.DIFFICULTIES[difficulty])
        got = port_synth.apply_effects(_pil_canvas(label, font, 32, p), p, rb, img_h=32)
        assert got.shape == want.shape[:2]
        d = np.abs(got.astype(int) - want[:, :, 0])
        assert d.max() <= max_step and d.mean() <= max_line_mean, (i, label, d.max(), d.mean())
    assert bool(jpeg_inputs) == (difficulty == "hard")
    for arr, q in jpeg_inputs:  # the JPEG stage is cv2's on whatever it is given
        assert native.jpeg_encode_gray(arr, q) == \
            cv2.imencode(".jpg", arr, [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()


# ---- the glyph layer -----------------------------------------------------------


@pytest.fixture(scope="module")
def glyph_layer(fonts):
    rows = []
    dejavu = [f for f in fonts if os.path.basename(f).startswith("DejaVu")]
    for font in dejavu:
        for img_h in (32, 48):
            labels = jax_synth.sample_texts(64, np.random.default_rng([0, img_h]))
            for i, label in enumerate(labels):
                want = jax_synth.render_line(label, font, img_h=img_h,
                                             rng=np.random.default_rng([0, i]),
                                             difficulty="clean")[:, :, 0].astype(np.int64)
                got = port_synth.render_line(label, font, img_h=img_h,
                                             rng=np.random.default_rng([0, i]),
                                             difficulty="clean")[:, :, 0].astype(np.int64)
                paper = int(np.random.default_rng([0, i]).uniform(235, 255))
                row = dict(font=os.path.basename(font), img_h=img_h, label=label,
                           widths=(want.shape[1], got.shape[1]))
                if want.shape == got.shape:
                    row.update(mad=float(np.abs(want - got).mean()), pixels=want.size,
                               ink=(int((paper - want).sum()), int((paper - got).sum())))
                rows.append(row)
    return rows


def test_glyph_layer_widths_follow_pil(glyph_layer):
    assert len(glyph_layer) == 6 * 2 * 64
    equal = sum(r["widths"][0] == r["widths"][1] for r in glyph_layer)
    assert equal >= 0.98 * len(glyph_layer)
    assert all(abs(r["widths"][0] - r["widths"][1]) <= 1 for r in glyph_layer)


def test_glyph_layer_pixels_are_within_the_unhinted_bound(glyph_layer):
    rows = [r for r in glyph_layer if "mad" in r]
    total = sum(r["mad"] * r["pixels"] for r in rows) / sum(r["pixels"] for r in rows)
    assert total <= 4.0
    worst = max(rows, key=lambda r: r["mad"])
    assert worst["mad"] <= 13.0, worst


def test_glyph_layer_ink_mass_is_within_the_unhinted_bound(glyph_layer):
    rows = [r for r in glyph_layer if "ink" in r]
    jax_ink = sum(r["ink"][0] for r in rows)
    port_ink = sum(r["ink"][1] for r in rows)
    assert abs(port_ink / jax_ink - 1) <= 0.05
    worst = max(rows, key=lambda r: abs(r["ink"][1] / r["ink"][0] - 1))
    assert abs(worst["ink"][1] / worst["ink"][0] - 1) <= 0.08, worst


@pytest.mark.parametrize("size", [22, 44, 67])
def test_font_reader_lays_out_prefixes_as_pil(fonts, size):
    labels = jax_synth.sample_texts(40, np.random.default_rng([9, size]))
    labels += ["AV Wa To fi fl ffi", "«(ёй)» №5", "Tj yj ff", "  "]
    for path in fonts:
        pil, port = ImageFont.truetype(path, size), TrueTypeFont(path, size)
        assert port.metrics() == pil.getmetrics()
        for label in labels:
            for cut in range(1, len(label) + 1, 3):
                text = label[:cut]
                assert port.getlength(text) == pil.getlength(text), (path, text)
                a, b = pil.getbbox(text), port.getbbox(text)
                assert (b[0], b[2]) == (a[0], a[2]), (path, text, a, b)


def test_font_draw_blends_as_pil_in_mode_l():
    """The port's coverage (drawn in black on white, where the blend gives
    255 - coverage exactly) pasted by PIL's ``ImageDraw.bitmap`` over a
    ramp, which blends as ``draw.text`` does, equals the port's own draw."""
    font = TrueTypeFont(CARRIED, 60)
    white = np.full((80, 300), 255, np.uint8)
    font.draw(white, (5, 3), "Wg/ё,", 0)
    mask = Image.fromarray(255 - white)
    ramp = np.tile(np.linspace(0, 255, 300).astype(np.uint8), (80, 1))
    for ink in (0, 37, 200, 255):
        img = Image.fromarray(ramp.copy())
        ImageDraw.Draw(img).bitmap((0, 0), mask, fill=ink)
        got = ramp.copy()
        font.draw(got, (5, 3), "Wg/ё,", ink)
        np.testing.assert_array_equal(got, np.asarray(img))


# ---- datasets and the digest ---------------------------------------------------


def test_generated_dataset_loads_through_the_port_s_dataset(tmp_path):
    from rcnn_ocr_tpu_torch.data.dataset import OCRDataset
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    root = str(tmp_path / "lines")
    csv_path, _ = port_synth.generate_dataset(root, 12, seed=4, img_h=32, difficulty="hard",
                                              fonts=[CARRIED])
    cs_path = str(tmp_path / "charset.txt")
    port_cli.write_charset(cs_path, port_synth.GENERATION_ALPHABET)
    ds = OCRDataset(csv_path, root, Charset.from_file(cs_path).stoi, img_height=32)
    assert len(ds) == 12 and sum(ds.skip_counts.values()) == 0
    with open(csv_path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    for k, (name, text) in enumerate(rows):
        img, label = ds[k]
        assert label == text and img.shape[0] == 32 and img.ndim == 3
        np.testing.assert_array_equal(img[:, :, 0], img[:, :, 2])


@pytest.mark.parametrize("difficulty", DIFFS)
def test_seeded_set_from_the_carried_font_gives_the_digest(tmp_path, difficulty):
    with open(fixtures.EXPECTED, encoding="utf-8") as f:
        want = json.load(f)[difficulty]
    root = str(tmp_path / difficulty)
    csv_path, _ = port_synth.generate_dataset(root, want["n"], seed=want["seed"],
                                              img_h=want["img_h"], difficulty=difficulty,
                                              fonts=[CARRIED])
    got = fixtures.digest(csv_path, root)
    assert got["csv"] == want["csv"]
    assert got["images"] == want["images"]


def test_stage_seconds_cover_every_stage(tmp_path):
    with port_synth.stage_seconds() as spent:
        port_synth.generate_dataset(str(tmp_path), 3, seed=1, img_h=24, difficulty="hard",
                                    fonts=[CARRIED])
    assert set(spent) == set(port_synth.STAGES)
    assert all(v > 0 for v in spent.values()), spent


def test_cli_output_trains_on_the_cpu(fonts, tmp_path):
    out = str(tmp_path / "synth")
    assert port_cli.main(["--out", out, "--n-train", "16", "--n-val", "8", "--img-h", "32",
                          "--difficulty", "hard", "--epochs", "1"]) == 0
    cfg_path = os.path.join(out, "config.json")
    with open(cfg_path, encoding="utf-8") as f:
        cfg = json.load(f)
    assert cfg["epochs"] == 1 and cfg["device_augment"] is True
    cfg.update(width_mult=0.125, hidden_size=32, batch_size=8, max_len=25,
               compute_dtype="float32", eval_every=1, progress=False)
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    result = str(tmp_path / "result.json")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "rcnn_ocr_tpu_torch.training.train", cfg_path,
                           "--device", "cpu", "--result-json", result], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(result, encoding="utf-8") as f:
        res = json.load(f)
    assert len(res["epochs"]) == 1 and np.isfinite(res["epochs"][0]["train_loss"])
    assert np.isfinite(res["val_loss"])
    assert os.path.exists(os.path.join(out, "exp", "last_weights.msgpack"))
