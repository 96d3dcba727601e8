"""The port's GIF decoder (``data/gif.py``, LZW in
``csrc/host/gif_decode.cpp``) vs the JAX package's ``imdecode_cv2``, on
the CPU.

* Every fixture of ``tests/torch_port_data/gif/`` (PIL's 2-, 16- and
  256-colour files, interlaced and animated; cv2's; hand-written files with
  a first frame offset inside a larger screen, transparency, local tables
  short of the global one, no tables at all, a deferred clear, a full code
  table, End of Information mid-stream, sub-blocks of one byte): bit-equal
  to ``imdecode_cv2`` and to the pixels the card's smoke reads.
* A seeded fuzz over palettes of 2-256 colours, interlace, transparency,
  local tables, frame offsets, LZW options and cut files: bit-equal
  wherever cv2 decodes, ``ValueError`` where it returns ``None``.
* OpenCV's own rules, pinned: the canvas and a transparent pixel show the
  global table's background entry, End of Information reads as a Clear
  while data follows, a frame must be filled (codes past it fail unless
  the data ends in the byte that holds them), the trailer must come, a
  screen over 1 << 30 pixels fails before anything is allocated.
* ``image_size`` is JAX's (the logical screen) without a decode, on an
  animation whose first frame is smaller than its screen too.
* Application extensions as OpenCV's frame count reads them (a 3-byte
  sub-block outside ``NETSCAPE2.0`` read a byte short): named cases and a
  seeded fuzz, bit-equal or ``ValueError`` where cv2 gives ``None``.
"""

import io
import itertools
from pathlib import Path

import cv2
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from rcnn_ocr_tpu.data import transforms as jax_tf  # noqa: E402
from rcnn_ocr_tpu_torch.data import image_io  # noqa: E402
from tests.torch_port_data.make_web_fixtures import (  # noqa: E402
    _pack_lsb, application_extension, gif_bytes)

FIXTURES = Path(__file__).resolve().parent / "torch_port_data" / "gif"
NAMES = sorted(p.name for p in FIXTURES.glob("*.gif"))
PAL = np.array([[i * 30, i, 255 - i * 30] for i in range(8)])


@pytest.fixture(scope="module")
def expected():
    with np.load(FIXTURES / "expected.npz") as z:
        return {k: z[k] for k in z.files}


def _cv2(data):
    try:
        return jax_tf.imdecode_cv2(data)
    except (ValueError, cv2.error):
        return None


def _assert_as_cv2(data, info=""):
    want = _cv2(data)
    if want is None:
        with pytest.raises(ValueError) as err:
            image_io.imdecode(data)
        assert not isinstance(err.value, image_io.UnsupportedImageFormat), info
        return False
    got = image_io.imdecode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, info
    np.testing.assert_array_equal(got, want, err_msg=str(info))
    return True


# --- fixtures ---------------------------------------------------------------------------

def test_fixtures_cover_the_paths(expected):
    kinds = ("pil_2colors", "pil_16colors", "pil_256colors", "pil_interlaced", "cv2_",
             "pil_anim", "offset_transparent", "local_table_interlaced", "short_local_table",
             "no_global", "no_tables", "deferred_clear", "full_table", "eoi_midstream",
             "block1", "87a", "gif_line_")
    for kind in kinds:
        assert any(kind in n for n in NAMES), kind
    assert sorted(expected) == NAMES
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 96 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_fixture_is_bit_equal_to_cv2(name, expected):
    want = jax_tf.imread_cv2(str(FIXTURES / name))
    got = image_io.imread(str(FIXTURES / name))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, expected[name])


def test_image_size_reads_the_screen_as_jax_without_a_decode(monkeypatch, tmp_path):
    """JAX's ``image_size`` takes the logical screen; so does the port's,
    also where the first frame is smaller than the screen."""
    anim = tmp_path / "anim.gif"
    anim.write_bytes(gif_bytes([dict(idx=np.zeros((3, 4), np.uint8), left=2, top=1, mcs=3),
                                dict(idx=np.ones((9, 10), np.uint8), mcs=3)], (10, 9), PAL))
    paths = [str(FIXTURES / n) for n in NAMES] + [str(anim)]
    want = {p: jax_tf.image_size(p) for p in paths}
    assert want[str(anim)] == (9, 10)
    monkeypatch.setattr(image_io, "imread", lambda path: pytest.fail(f"decoded {path}"))
    assert {p: image_io.image_size(p) for p in paths} == want


# --- OpenCV's rules ---------------------------------------------------------------------

def test_canvas_and_transparency_show_the_global_background_entry():
    idx = np.array([[0, 1, 2], [3, 1, 5]], np.uint8)
    lpal = PAL[::-1]
    data = gif_bytes([dict(idx=idx, left=1, top=1, transparent=1, lpal=lpal, mcs=3)], (5, 4),
                     PAL, bg=6)
    want = np.empty((4, 5, 3), np.uint8)
    want[:] = PAL[6]
    want[1:3, 1:4] = np.where((idx == 1)[:, :, None], PAL[6], lpal[idx])
    np.testing.assert_array_equal(jax_tf.imdecode_cv2(data), want)
    np.testing.assert_array_equal(image_io.imdecode(data), want)


def _codes(*codes):
    return _pack_lsb([(c, 4) for c in codes])


# a 1x6 frame of indices 1 2 3 1 2 3, minimum code size 3 (Clear 8, EOI 9)
EOI_CASES = {
    "EOI ends the data": (_codes(8, 1, 2, 3, 1, 2, 3, 9), True),
    "EOI, then codes after it in the last byte": (_codes(8, 1, 2, 3, 1, 2, 3, 9, 3), True),
    "EOI mid-stream reads as a Clear": (_codes(8, 1, 2, 3, 9, 1, 2, 3, 0), True),
    "EOI mid-stream, then the next free entry": (_codes(8, 1, 2, 3, 9, 1, 10), True),
    "no EOI": (_codes(8, 1, 2, 3, 1, 2, 3), True),
    "data short of the frame": (_codes(8, 1, 2, 3, 1, 9), False),
    "an index past the full frame in its last byte": (_codes(8, 1, 2, 3, 1, 2, 3, 1), True),
    "an index past the full frame, then more data": (_codes(8, 1, 2, 3, 1, 2, 3, 1, 1, 1), False),
    "a string past the frame's end": (_codes(8, 1, 2, 3, 1, 2, 10), False),
    "the next free entry right after a Clear": (_codes(8, 10, 1, 2), False),
    "a code past the next free entry": (_codes(8, 1, 12, 2), False),
}


@pytest.mark.parametrize("case", sorted(EOI_CASES))
def test_lzw_stream_decodes_as_cv2_reads_it(case):
    raw, decodes = EOI_CASES[case]
    data = gif_bytes([dict(idx=np.array([[1, 2, 3, 1, 2, 3]]), raw=raw, mcs=3)], (6, 1), PAL)
    assert _assert_as_cv2(data, case) == decodes


@pytest.mark.parametrize("full_at", ["mid-byte", "byte end"])
@pytest.mark.parametrize("extra", [e for n in range(4) for e in itertools.product((1, 8, 9), repeat=n)],
                         ids=lambda e: "-".join(map(str, e)) or "none")
def test_codes_after_a_full_frame_fail_where_cv2_fails(full_at, extra):
    """Literals (1), Clears (8) and EOIs (9) after the frame's last index,
    which falls in the middle of a byte or at its end: OpenCV drops what
    the last byte holds and fails on a data code followed by more data."""
    prefix = (8, 1, 2, 3, 1, 2, 3) if full_at == "mid-byte" else (8, 8, 1, 2, 3, 1, 2, 3)
    data = gif_bytes([dict(idx=np.array([[1, 2, 3, 1, 2, 3]]), raw=_codes(*prefix, *extra),
                           mcs=3)], (6, 1), PAL)
    _assert_as_cv2(data, extra)


CV2_FAILS = {
    "no trailer": lambda d: d[:-1],
    "cut in half": lambda d: d[: len(d) // 2],
    "GIF88a": lambda d: None,
    "an unknown block": lambda d: d[:-1] + b"\x99\x3b",
    "frame past the screen": lambda d: gif_bytes([dict(idx=np.zeros((2, 2)), left=4, mcs=3)],
                                                 (5, 2), PAL),
    "background past the table": lambda d: gif_bytes([dict(idx=np.zeros((2, 2)), mcs=3)],
                                                     (2, 2), PAL, bg=9),
    "minimum code size 1": lambda d: gif_bytes([dict(idx=np.zeros((2, 2)), mcs=1)], (2, 2), PAL),
    "minimum code size 12": lambda d: gif_bytes([dict(idx=np.zeros((2, 2)), mcs=12, raw=b"\x00")],
                                                (2, 2), PAL),
    "index past both tables": lambda d: gif_bytes([dict(idx=np.full((2, 2), 6), mcs=3)], (2, 2),
                                                  PAL[:4]),
    "a graphic control extension of 5 bytes": lambda d: gif_bytes(
        [dict(idx=np.zeros((2, 2)), mcs=3, extensions=[b"\x21\xf9\x05\x01\x00\x00\x01\x00\x00"])],
        (2, 2), PAL),
    "no image": lambda d: gif_bytes([], (2, 2), PAL),
}


@pytest.mark.parametrize("kind", sorted(CV2_FAILS))
def test_value_error_where_cv2_fails(kind):
    base = gif_bytes([dict(idx=np.arange(12).reshape(3, 4) % 8, mcs=3)], (4, 3), PAL)
    data = CV2_FAILS[kind](base)
    if data is None:  # not a GIF signature at all: no image cv2 reads
        data = b"GIF88a" + base[6:]
    assert _cv2(data) is None
    with pytest.raises(ValueError) as err:
        image_io.imdecode(data)
    assert not isinstance(err.value, image_io.UnsupportedImageFormat)


SIZE_LIMIT = {  # case: (screen, whether cv2 decodes it)
    "65535x65535 screen": ((65535, 65535), False),
    "32768x32769 screen, one pixel over 1 << 30": ((32768, 32769), False),
    "65535x16385 screen": ((65535, 16385), False),
    "65535x7 screen": ((65535, 7), True),
}


@pytest.mark.parametrize("case", sorted(SIZE_LIMIT))
def test_screen_past_opencv_limit_raises_value_error(case):
    """A file of a few bytes that declares a huge screen around a 1x1 frame:
    cv2 refuses over 1 << 30 pixels before it allocates, and the port
    raises ``ValueError`` before it allocates the canvas."""
    screen, decodes = SIZE_LIMIT[case]
    data = gif_bytes([dict(idx=np.zeros((1, 1)), mcs=3)], screen, PAL)
    assert len(data) < 64
    assert _assert_as_cv2(data, case) == decodes


# --- fuzz -------------------------------------------------------------------------------

def _random_gif(rng):
    sw, sh = (int(v) for v in rng.integers(1, 40, 2))
    gpal = rng.integers(0, 256, (int(rng.integers(2, 257)), 3)) if rng.random() < 0.85 else None
    fw, fh = int(rng.integers(1, sw + 1)), int(rng.integers(1, sh + 1))
    lpal = rng.integers(0, 256, (int(rng.integers(2, 257)), 3)) if rng.random() < 0.3 else None
    n = max(len(lpal) if lpal is not None else 0, len(gpal) if gpal is not None else 0, 2)
    n = min(256, n + (3 if rng.random() < 0.05 else 0))
    idx = rng.integers(0, n, (fh, fw))
    if rng.random() < 0.5 and fw >= 3:  # runs, for longer LZW strings
        idx = np.repeat(idx[:, : fw // 3 + 1], 3, axis=1)[:, :fw]
    mcs = max(2, int(np.ceil(np.log2(max(int(idx.max()) + 1, 2))))) if rng.random() < 0.7 else 8
    frame = dict(idx=idx, left=int(rng.integers(0, sw - fw + 1)),
                 top=int(rng.integers(0, sh - fh + 1)), lpal=lpal, mcs=mcs,
                 interlace=bool(rng.random() < 0.3),
                 transparent=int(rng.integers(0, n)) if rng.random() < 0.4 else None,
                 lzw=dict(defer=bool(rng.random() < 0.3), initial_clear=bool(rng.random() < 0.8),
                          clear_every=int(rng.choice([0, 0, 7, 50])),
                          eoi_at=int(rng.choice([-1, -1, 5, 20]))),
                 block=int(rng.choice([255, 255, 1, 7])))
    frames = [frame] + ([dict(idx=rng.integers(0, 2, (3, 3)))] if rng.random() < 0.3 else [])
    bg = (int(rng.integers(0, len(gpal) + (rng.random() < 0.05))) if gpal is not None
          else int(rng.integers(0, 256)))
    data = gif_bytes(frames, (sw, sh), gpal, bg=bg, loop=bool(rng.random() < 0.3),
                     version=b"GIF87a" if rng.random() < 0.2 else b"GIF89a")
    if rng.random() < 0.1:
        data = data[: int(rng.integers(10, len(data)))]
    return data, (sw, sh, fw, fh, n, mcs)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_is_bit_equal(seed):
    rng = np.random.default_rng(1600 + seed)
    decoded = sum(_assert_as_cv2(*_random_gif(rng)) for _ in range(60))
    assert decoded >= 45


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_of_encoder_output_is_bit_equal(seed):
    """PIL's palettes of 2-256 colours (interlaced or not, animated with a
    transparent index) and cv2's encoder."""
    from PIL import Image

    rng = np.random.default_rng(1700 + seed)
    for k in range(8):
        h, w = (int(v) for v in rng.integers(1, 50, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        bio = io.BytesIO()
        Image.fromarray(img).quantize(colors=int(rng.integers(2, 257))).save(
            bio, format="GIF", interlace=bool(k % 2))
        assert _assert_as_cv2(bio.getvalue(), (seed, k))
        assert _assert_as_cv2(cv2.imencode(".gif", img)[1].tobytes(), (seed, k))
        frames = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).quantize(16)
                  for _ in range(3)]
        bio = io.BytesIO()
        frames[0].save(bio, format="GIF", save_all=True, append_images=frames[1:],
                       transparency=0, disposal=2)
        assert _assert_as_cv2(bio.getvalue(), (seed, k, "anim"))


def _with_extensions(exts, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 8, (5, 7))
    return gif_bytes([dict(idx=idx, mcs=3, extensions=exts)], (7, 5), PAL)


APPLICATION_CASES = {
    "NETSCAPE loop": [application_extension(b"NETSCAPE2.0", [b"\x01\x00\x00"])],
    "NETSCAPE 3 bytes not a loop": [application_extension(b"NETSCAPE2.0", [b"ABC"])],
    "NETSCAPE 11 bytes then 3": [application_extension(b"NETSCAPE2.0", [b"z" * 11, b"ABC"])],
    "NETSCAPE2.1 3 bytes": [application_extension(b"NETSCAPE2.1", [b"\x01\x00\x00"])],
    "XMP of 3 bytes": [application_extension(b"XMP DataXMP", [b"abc"])],
    "XMP of 1, 2, 4 bytes": [application_extension(b"XMP DataXMP", [b"a", b"ab", b"abcd"])],
    "ICC of 3 bytes last": [application_extension(b"ICCRGBG1012", [bytes(255), b"end"])],
    "ICC of 255 bytes": [application_extension(b"ICCRGBG1012", [bytes(255)])],
    "3-byte identifier": [application_extension(b"ICC", [])],
    "3 bytes that land on the end": [application_extension(b"ANIMEXTS1.0",
                                                           [b"\x05\x06\x02", b"\x00"])],
    "NETSCAPE then another of 3": [application_extension(b"NETSCAPE2.0", [b"\x01\x00\x00"]),
                                   application_extension(b"ABCDEFGHIJK", [b"abc"])],
    "comment of 3 bytes": [b"\x21\xfe\x03abc\x00"],
    "unknown label of 3 bytes": [b"\x21\x22\x03abc\x00"],
}


@pytest.mark.parametrize("case", sorted(APPLICATION_CASES))
def test_application_extensions_read_as_opencv_counts_frames(case):
    """OpenCV's frame count reads a 3-byte sub-block of an application
    extension as 2 bytes unless the last 11-byte sub-block was
    ``NETSCAPE2.0`` (then it is the loop count): the walk goes on a byte
    early and mostly meets a block type it does not know (cv2's None). The
    port raised on none of these and decoded files cv2 fails."""
    _assert_as_cv2(_with_extensions(APPLICATION_CASES[case]), case)


@pytest.mark.parametrize("seed", range(3))
def test_application_extension_fuzz_is_bit_equal(seed):
    """Application, comment and unknown extensions of random identifiers
    and sub-block sizes (3 among them) before or after the frame."""
    rng = np.random.default_rng(2600 + seed)
    idents = [b"NETSCAPE2.0", b"XMP DataXMP", b"ICCRGBG1012", b"ANIMEXTS1.0", b"NETSCAPE2.1"]
    decoded = failed = 0
    for k in range(150):
        exts = []
        for _ in range(int(rng.integers(1, 3))):
            label = int(rng.choice([0xFF, 0xFF, 0xFF, 0xFE, 0x01, 0x22]))
            blocks = [bytes(rng.integers(0, 256, int(rng.choice([1, 2, 3, 3, 4, 11, 255])))
                            .astype(np.uint8)) for _ in range(int(rng.integers(0, 4)))]
            if label == 0xFF:
                ident = idents[int(rng.integers(0, len(idents)))]
                if rng.random() < 0.15:
                    ident = ident[: int(rng.integers(0, 12))]
                exts.append(application_extension(ident, blocks))
            else:
                exts.append(b"\x21" + bytes([label]) + b"".join(bytes([len(b)]) + b
                                                                 for b in blocks) + b"\x00")
        data = _with_extensions(exts, seed * 1000 + k)
        if rng.random() < 0.3:  # after the frame, before the trailer
            data = _with_extensions([], seed * 1000 + k)[:-1] + b"".join(exts) + b"\x3b"
        if _assert_as_cv2(data, (seed, k)):
            decoded += 1
        else:
            failed += 1
    assert decoded >= 30 and failed >= 15
