"""The port's JPEG 2000 decoder (``data/jpeg2000.py``, the codestream in
``csrc/host/j2k_decode.cpp``) vs the JAX package's ``imdecode_cv2`` /
``imread_cv2`` (cv2 through OpenJPEG), on the CPU.

* Every fixture of ``tests/torch_port_data/jp2/`` (PIL's writer over its
  modes and options, cv2's writer, OpenJPEG through ctypes for every
  code-block style bit, SOP/EPH, POC, ROI, tile-parts, TLM/PLT, PPM/PPT,
  precisions 9-16 and sYCC, and JP2 boxes written by hand: palettes,
  channel definitions, ICC and unknown colour spaces): bit-equal to
  ``imdecode_cv2`` and to the pixels the card's smoke reads
  (``expected.npz``); a 2K digital-cinema codestream (PIL's
  ``cinema_mode``), written here as it is too large to commit.
* A seeded fuzz over PIL's writer (modes, both wavelets, the colour
  transform, resolutions, code-block and precinct sizes, the five
  progressions, tiles, quality layers, raw codestreams, PLT): bit-equal.
  PIL's encoder aborts the process on a tile too small for its resolution
  count, so the fuzz keeps the count at most log2 of the smallest tile
  side (edge tiles counted) plus 1.
* Seeded fuzzes of cuts and bit flips over the fixtures, and of random
  values in the codestream's SIZ, COD, QCD and SOT fields and in the JP2
  boxes: bit-equal where cv2 decodes, ``ValueError`` where it gives
  ``None`` (a flip that sets the HT code-block style included: OpenJPEG
  then reads the Part 1 data as HT, and so does the port).
* HTJ2K (Part 15): the ``ht_*`` fixtures (``make_htj2k_fixtures.py``'s
  own HT encoder over the VLC tables read back from cv2, which a rerun of
  ``derive_ht_tables.py`` reproduces byte for byte) bit-equal to cv2;
  regenerated here bit for bit, with every (context, codeword) entry of
  both VLC tables and every UVLC prefix reached; seeded cuts and flips
  inside the code-blocks' bytes agree with cv2.
* sYCC's conversion (OpenCV's ``YUV2BGR``) equal to cv2 on every triple.
* What cv2 refuses and the port raises ``ValueError`` for: signed, offset,
  subsampled and 4-bit components, five components, a gray raw
  codestream, CMYK and e-sYCC, damaged boxes, and the HT streams
  OpenJPEG fails (Scup or Lcup out of range, more than 3 passes, a
  second HT set, the refinement signalled as Part 15 signals it, ROI,
  a UVLC past its 5-bit suffix, the mixed style bit, a block of more
  than 4,096 samples, a quad significant past the block's edge, and
  OpenJPEG's own encoder given the HT style).
* Headers whose layer or tile count is far larger than their bytes fill
  (65535 layers, 65535 tiles): equal to cv2, the decode's peak memory
  held under 32 MiB in a process of its own.
* The codestream decoder under AddressSanitizer and UndefinedBehaviorSanitizer
  (``torch_port_data/sanitize_j2k.py``), called directly on every fixture,
  the streams that once faulted (an empty tile of a subsampled component),
  the HT streams OpenJPEG fails, and seeded cuts and flips (over the
  code-blocks' bytes of the HT fixtures too).
* A dataset and an eval-CLI run over ``.jp2`` and ``.j2k`` rows (HTJ2K
  among them), against JAX's, and ``image_size`` against JAX's.
"""

import csv
import io
import struct
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from rcnn_ocr_tpu.data import transforms as jax_tf  # noqa: E402
from rcnn_ocr_tpu_torch.data import image_io  # noqa: E402
from tests.test_torch_port_beam_engine import files  # noqa: E402,F401
from tests.test_torch_port_data import assert_datasets_agree  # noqa: E402
from tests.torch_port_data import make_htj2k_fixtures as ht  # noqa: E402
from tests.torch_port_data import sanitize_j2k  # noqa: E402
from tests.torch_port_data.make_jp2_fixtures import (  # noqa: E402
    box, jp2_file, many_layers, many_tiles, opj_encode)

FIXTURES = Path(__file__).resolve().parent / "torch_port_data" / "jp2"
NAMES = sorted(p.name for p in FIXTURES.iterdir() if p.suffix in (".jp2", ".j2k"))
HT_NAMES = [n for n in NAMES if n.startswith(("ht_", "htj2k_"))]


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
    """Bit-equal to cv2 where it decodes, ValueError (not a refusal) where
    it gives None or raises.  Returns whether cv2 decoded."""
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


def _pil(img, mode=None, **kw) -> bytes:
    from PIL import Image

    bio = io.BytesIO()
    (Image.fromarray(img) if mode is None else Image.fromarray(img, mode)).save(
        bio, format="JPEG2000", **kw)
    return bio.getvalue()


@pytest.mark.parametrize("name", NAMES)
def test_fixture_is_bit_equal_to_cv2(name, expected):
    data = (FIXTURES / name).read_bytes()
    assert _assert_as_cv2(data, name)
    np.testing.assert_array_equal(image_io.imread(str(FIXTURES / name)), expected[name])


def test_every_fixture_has_expected_pixels(expected):
    assert sorted(expected) == NAMES
    kinds = ("pil_L_", "pil_LA_", "pil_RGBA_", "pil_I16_", "irreversible", "no_mct", "res1_",
             "LRCP", "RLCP", "RPCL", "PCRL", "CPRL", "precinct", "cblk", "tiles", "layers_dB",
             "layers_rates", "codestream", "plt_comment", "cv2_x1000", "bypass", "reset",
             "termall", "vsc", "pterm", "segsym", "all_styles", "sop_eph", "poc", "roi",
             "tile_parts_R", "tile_parts_L", "tile_parts_C", "tlm_plt", "prec9", "prec10",
             "prec12", "prec16", "sycc", "ppm", "ppt", "palette_", "palette16", "cdef_swapped",
             "cdef_alpha", "icc", "unknown_enumcs", "two_colr", "65535_layers",
             "ht_gray_rev", "ht_rgb_rev", "ht_rgb_irr", "ht_gray_irr", "res1_cblk4x4",
             "res6_cblk64", "refine", "sigprop", "vsc", "layers3_late", "refine_split",
             "magref_split", "cleanup_split", "tiles_precincts_sop_eph", "rlcp", "coc_part1",
             "gray16", "rgb16", "zblk", "cblk1024x4", "uvlc_long", "ht_cover", "htj2k_line",
             "warn_zero_planes", "warn_four_passes")
    assert all(any(k in n for n in NAMES) for k in kinds), [k for k in kinds
                                                          if not any(k in n for n in NAMES)]


def test_2k_cinema_codestream_is_bit_equal_to_cv2():
    """PIL's ``cinema_mode``: the digital-cinema 2K profile (a 2048x1080
    irreversible codestream of fixed parameters, ~1 MB), bit-equal."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:1080, 0:2048]
    img = np.stack([(xx // 8) % 256, (yy // 4) % 256, ((xx + yy) // 16) % 256], axis=2)
    img = np.clip(img + rng.integers(-8, 9, img.shape), 0, 255).astype(np.uint8)
    assert _assert_as_cv2(_pil(img, cinema_mode="cinema2k-24"))


# --- fuzz -------------------------------------------------------------------------------

def _pil_case(rng):
    h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    mode = str(rng.choice(["L", "RGB", "RGBA", "LA", "I;16"]))
    c = {"L": 0, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 0}[mode]
    top = 65536 if mode == "I;16" else 256
    img = rng.integers(0, top, (h, w, c) if c else (h, w))
    if rng.random() < 0.5:  # smooth, so that the transforms have something to do
        img = np.cumsum(np.cumsum(img, 0), 1) % top
    img = img.astype(np.uint16 if mode == "I;16" else np.uint8)
    kw = dict(irreversible=bool(rng.random() < 0.5))
    side = min(h, w)
    if rng.random() < 0.5:
        kw["progression"] = str(rng.choice(["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"]))
    if rng.random() < 0.4:
        t = int(rng.choice([16, 32, 64]))
        kw["tile_size"] = (t, t)
        side = min(side, w % t or t, h % t or t)
    kw["num_resolutions"] = int(rng.integers(1, min(int(np.log2(side)) + 1, 6) + 1))
    if rng.random() < 0.4:
        kw["codeblock_size"] = [(4, 4), (8, 16), (16, 8), (32, 32), (16, 64)][rng.integers(5)]
    if rng.random() < 0.3 and kw.get("codeblock_size", (64, 64))[0] <= 16:
        p = int(rng.choice([16, 32]))
        kw["precinct_size"] = (p, p)
    if rng.random() < 0.4:
        kw["quality_mode"] = str(rng.choice(["rates", "dB"]))
        kw["quality_layers"] = [40, 20, 10] if kw["quality_mode"] == "rates" else [30, 40, 50]
    if mode == "RGB" and rng.random() < 0.3:
        kw["mct"] = 0
    kw["no_jp2"] = bool(rng.random() < 0.3)
    kw["plt"] = bool(rng.random() < 0.2)
    return img, (mode if mode in ("LA", "RGBA", "I;16") else None), kw


@pytest.mark.parametrize("seed", range(4))
def test_seeded_pil_fuzz_is_bit_equal(seed):
    rng = np.random.default_rng(100 + seed)
    decoded = 0
    for case in range(20):
        img, mode, kw = _pil_case(rng)
        try:
            data = _pil(img, mode, **kw)
        except OSError:  # a parameter set PIL's writer refuses
            continue
        decoded += _assert_as_cv2(data, (case, img.shape, kw))
    assert decoded >= 10


def _agree(data, outcomes, info):
    """One damaged stream: equal pixels, or ValueError (never a refusal)
    where cv2 gives None; counted in ``outcomes``."""
    want = _cv2(data)
    try:
        got = image_io.imdecode(data)
    except ValueError as err:
        assert not isinstance(err, image_io.UnsupportedImageFormat), (info, err)
        assert want is None, (info, "fails where cv2 decodes", err)
        outcomes["both fail"] += 1
        return
    assert want is not None, (info, "decoded where cv2 fails")
    np.testing.assert_array_equal(got, want, err_msg=str(info))
    outcomes["equal"] += 1


@pytest.mark.parametrize("seed", range(6))
def test_seeded_damage_fuzz_agrees_with_cv2(seed):
    """Cuts and bit flips: equal pixels, or ValueError where cv2 gives None.
    A flip that sets the HT code-block style gives cv2's outcome too: the
    port reads the Part 1 data as HT, as OpenJPEG does, and fails or
    decodes where it does."""
    rng = np.random.default_rng(200 + seed)
    outcomes = {"equal": 0, "both fail": 0}
    for case in range(60):
        name = NAMES[rng.integers(len(NAMES))]
        _agree(sanitize_j2k.damage((FIXTURES / name).read_bytes(), rng), outcomes, (case, name))
    print(f"seed {seed}: {outcomes}")
    assert outcomes["equal"] >= 10 and outcomes["both fail"] >= 10, outcomes


@pytest.mark.parametrize("seed", range(6))
def test_seeded_ht_block_damage_fuzz_agrees_with_cv2(seed):
    """Cuts, bit flips and stuffing bytes (0xFF, 0x7F, 0x8F, 0x90) inside
    the code-blocks' bytes of the ``ht_*`` fixtures (the cleanup's MagSgn,
    MEL and VLC streams and Scup, the SigProp and MagRef segment, the
    packet headers): equal pixels, or ValueError where cv2 gives None."""
    rng = np.random.default_rng(400 + seed)
    outcomes = {"equal": 0, "both fail": 0}
    for case in range(60):
        name = HT_NAMES[rng.integers(len(HT_NAMES))]
        _agree(sanitize_j2k.damage_blocks((FIXTURES / name).read_bytes(), rng), outcomes,
               (case, name))
    print(f"seed {seed}: {outcomes}")
    assert outcomes["equal"] >= 10 and outcomes["both fail"] >= 10, outcomes


def _mutate_markers(data: bytes, rng) -> bytes:
    """A random byte in the SIZ, COD or QCD segment or a tile-part's SOT
    (the codestream of a JP2 as well)."""
    data = bytearray(data)
    start = data.index(b"\xff\x4f\xff\x51")
    marker, lo, hi = [(b"\xff\x51", 4, 40), (b"\xff\x52", 2, 14), (b"\xff\x5c", 2, 12),
                      (b"\xff\x90", 2, 12)][rng.integers(4)]
    at = data.find(marker, start) + int(rng.integers(lo, hi))
    if at < len(data):
        data[at] = int(rng.integers(0, 256))
    return bytes(data)


def _mutate_boxes(data: bytes, rng) -> bytes:
    """A random byte, a bit flip, or a telling value in the JP2 boxes
    before the codestream."""
    data = bytearray(data)
    at = int(rng.integers(0, data.index(b"jp2c") + 4))
    data[at] = int(rng.choice([0, 1, 2, 255, ord("c"), ord("j"), int(rng.integers(0, 256))]))
    return bytes(data)


@pytest.mark.parametrize("kind", ["markers", "boxes"])
def test_seeded_header_fuzz_agrees_with_cv2(kind):
    """Random values in the codestream's SIZ, COD, QCD and SOT fields, or
    in the JP2 boxes: equal pixels, or ValueError where cv2 gives None
    (a COD whose style gains or loses the HT bit as well)."""
    rng = np.random.default_rng(300 + (kind == "boxes"))
    names = [n for n in NAMES if kind == "markers" or n.endswith(".jp2")]
    outcomes = {"equal": 0, "both fail": 0}
    for case in range(120):
        name = names[rng.integers(len(names))]
        data = (_mutate_markers if kind == "markers" else _mutate_boxes)(
            (FIXTURES / name).read_bytes(), rng)
        _agree(data, outcomes, (case, name))
    print(f"{kind}: {outcomes}")
    assert outcomes["equal"] >= 10 and outcomes["both fail"] >= 10, outcomes


# --- what cv2 refuses, and HTJ2K ----------------------------------------------------------

def _rgb_stream(**kw) -> bytes:
    rng = np.random.default_rng(3)
    return opj_encode([rng.integers(0, 256, (20, 24)) for _ in range(3)], numres=3, **kw)


def _colr(enumcs: int) -> bytes:
    return b"\x01\x00\x00" + struct.pack(">I", enumcs)


_GRAY = np.random.default_rng(4).integers(0, 256, (20, 24))
CV2_FAILS = {
    "signed components (PIL signed)": lambda: _pil(_GRAY.astype(np.uint8), signed=True),
    "an image offset (PIL offset)": lambda: _pil(np.zeros((40, 40, 3), np.uint8), offset=(3, 5),
                                                 tile_size=(64, 64), num_resolutions=2),
    "a tile offset (PIL tile_offset)": lambda: _pil(
        np.zeros((70, 70, 3), np.uint8), tile_size=(32, 32), tile_offset=(3, 5), offset=(3, 5),
        num_resolutions=2),
    "4-bit components": lambda: opj_encode([_GRAY // 16], prec=4, jp2=True, color_space=2,
                                           numres=2),
    "five components": lambda: opj_encode([_GRAY] * 5, numres=2),
    "subsampled chroma": lambda: opj_encode([_GRAY, _GRAY[::2, ::2], _GRAY[::2, ::2]],
                                            subsampling=[(1, 1), (2, 2), (2, 2)], numres=2, mct=0),
    "an empty tile of subsampled chroma": lambda: sanitize_j2k.named_streams()[
        "empty_tile_component_res2"],
    "a gray raw codestream": lambda: opj_encode([_GRAY], numres=2),
    "two components in sRGB": lambda: opj_encode([_GRAY, _GRAY], numres=2),
    "CMYK": lambda: jp2_file(_rgb_stream(), 20, 24, 3, colr=_colr(12)),
    "e-sYCC": lambda: jp2_file(_rgb_stream(), 20, 24, 3, colr=_colr(24)),
    "gray with an ICC profile": lambda: jp2_file(opj_encode([_GRAY], numres=2), 20, 24, 1,
                                                 colr=b"\x02\x00\x00" + bytes(20)),
    "a palette without cmap": lambda: jp2_file(
        opj_encode([_GRAY % 4], numres=2), 20, 24, 1, colr=_colr(16),
        header=[box(b"pclr", struct.pack(">HB", 4, 3) + bytes([7, 7, 7]) + bytes(12))]),
    "ihdr sides differing from SIZ": lambda: jp2_file(_rgb_stream(), 21, 24, 3),
    "ihdr of height 0": lambda: jp2_file(_rgb_stream(), 0, 24, 3),
    "a cdef missing a channel": lambda: jp2_file(
        _rgb_stream(), 20, 24, 3, header=[box(b"cdef", struct.pack(">HHHH", 1, 0, 0, 1))]),
    "jp2c before jp2h": lambda: (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + box(b"ftyp", b"jp2 " + bytes(4))
                                 + box(b"jp2c", _rgb_stream())),
    "ftyp not second": lambda: (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + box(b"xml ", b"<x/>")
                                + jp2_file(_rgb_stream(), 20, 24, 3)[12:]),
    "no EOC": lambda: _rgb_stream()[:-2],
    "cut in half": lambda: _rgb_stream()[: len(_rgb_stream()) // 2],
    "a missing EPH marker": lambda: _rgb_stream(csty=6).replace(b"\xff\x92", b"\xff\x93", 1),
    # OpenJPEG's encoder copies the HT style into COD over MQ-coded blocks
    "HT: OpenJPEG's encoder given the HT style": lambda: _rgb_stream(mode=0x40),
    **{f"HT: {what}": (lambda what=what: ht.none_streams()[what])
       for what in ("Scup under 2", "Scup over Lcup", "Scup over 4079", "Lcup under 2",
                    "an empty cleanup segment",
                    "four passes (placeholder passes before the cleanup)",
                    "a second HT set in a later layer",
                    "the refinement in a later layer as Part 15 signals it",
                    "HT with a region of interest", "a UVLC past the 5-bit suffix (its extension)",
                    "the mixed HT style bit", "a code-block of 128 x 64 samples",
                    "a quad significant past the block's edge")},
}


@pytest.mark.parametrize("case", sorted(CV2_FAILS))
def test_value_error_where_cv2_fails(case):
    assert not _assert_as_cv2(CV2_FAILS[case](), case)


@pytest.mark.parametrize("where", ["COD", "COC"])
def test_htj2k_code_blocks_are_refused_naming_it(where):
    """A Part 1 stream whose COD (or a COC, for component 1) claims HT
    code-blocks: once refused by name, now read as OpenJPEG reads it (the
    MQ-coded bytes as HT segments), so the port gives cv2's outcome."""
    data = bytearray(_rgb_stream())
    cod = data.index(b"\xff\x52")
    if where == "COD":
        data[cod + 12] |= 0x40  # SPcod's code-block style: HT
    else:  # a COC giving component 1 HT code-blocks
        coc = b"\xff\x53\x00\x0a\x01\x00" + bytes(data[cod + 9 : cod + 14])
        coc = coc[:9] + bytes([coc[9] | 0x40]) + coc[10:]
        data[cod + 14 : cod + 14] = coc
    _assert_as_cv2(bytes(data), where)


def test_ht_fixtures_regenerate_bit_for_bit_and_reach_every_codeword():
    """``make_htj2k_fixtures.py`` rewrites every committed ``ht_*`` file
    byte for byte (same seed), and its fixtures and probes reach every
    (context, codeword) entry of both VLC tables and every UVLC prefix,
    the 5-bit suffix's extension values included."""
    files = ht.fixtures(np.random.default_rng(20261020))
    ht.none_streams()
    on_disk = sorted(p.name for p in FIXTURES.iterdir() if p.name.startswith(("ht_", "htj2k_")))
    assert sorted(files) == on_disk
    for name, data in files.items():
        assert (FIXTURES / name).read_bytes() == data, name
    gaps, prefixes = ht.COVER.missing()
    assert not gaps and not prefixes, (gaps, prefixes, ht.coverage_report())


def test_ht_tables_are_read_back_from_cv2_byte_for_byte():
    """``derive_ht_tables.py`` finds one pair of VLC tables in cv2's shared
    object by their structure and renders the committed
    ``ht_tables.inc`` byte for byte."""
    from tests.torch_port_data import derive_ht_tables as derive

    _, tables = derive.find_tables(derive.shared_object())
    assert derive.render(tables) == Path(derive.OUT).read_text()


@pytest.mark.parametrize("other", [(0,), (1,), (2,), (0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("reversible", [True, False])
def test_colour_transform_over_mixed_wavelets_reads_bits_as_openjpeg(reversible, other):
    """A COC (with a QCC) giving components the other wavelet under the
    colour transform: OpenJPEG runs component 0's transform over the three
    buffers' bits (floats read as integers or integers as floats), and so
    does the port (it refused the stream); flat areas give exact zeros."""
    rng = np.random.default_rng(len(other) * 7 + other[0])
    img = ht._image(rng, int(rng.integers(8, 30)), int(rng.integers(8, 30)))
    if not reversible:
        img = (img // 64 * 64).astype(np.uint8)
    assert _assert_as_cv2(ht.encode_image(img, numres=2, cblk=(16, 16), reversible=reversible,
                                          other_wavelet=other), (reversible, other))


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("shift", range(8))
def test_ht_mel_start_is_checked_where_openjpeg_reads_it(shift, chunks):
    """OpenJPEG fails a MEL whose 0xFF is followed by a byte above 0x8F
    only among the bytes it reads singly up to a 4-byte address; the port
    keeps the address's low bits (the block's offset in the tile's data,
    or 0 for a joined copy), so it fails and decodes where cv2 does."""
    _assert_as_cv2(ht.mel_start_stream(shift, chunks), (shift, chunks))


@pytest.mark.parametrize("delta", [-3, -2, -1, 1, 2, 3])
def test_ht_mel_and_vlc_overlapping_or_apart_agree_with_cv2(delta):
    """Scup moved by a few bytes: the MEL read over the VLC's bytes, or over
    the MagSgn's; cv2's outcome, whichever it is."""
    _assert_as_cv2(ht.scup_shift_stream(delta), delta)


def test_htj2k_line_equals_its_png_twin():
    """The card's daemon line: lossless, so its pixels are its PNG twin's."""
    np.testing.assert_array_equal(image_io.imread(str(FIXTURES / "htj2k_line_0.jp2")),
                                  image_io.imread(str(FIXTURES / "htj2k_line_0.png")))


_PEAK = r"""
import resource, sys
import numpy as np
from rcnn_ocr_tpu_torch.data import image_io


def status(key):  # this process's own figures (ru_maxrss holds its parent's at the fork)
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) for line in f if line.startswith(key)) * 1024


image_io.imdecode(open(sys.argv[1], "rb").read())  # builds and loads the library
resource.setrlimit(resource.RLIMIT_AS, (status("VmSize:") + (1 << 30), resource.RLIM_INFINITY))
before = status("VmHWM:")
np.save(sys.argv[3], image_io.imdecode(open(sys.argv[2], "rb").read()))
print((status("VmHWM:") - before) >> 20)
"""


@pytest.mark.parametrize("case", ["65535 layers", "65535 tiles"])
def test_header_counts_cost_memory_only_as_the_bytes_fill_them(case, tmp_path):
    """A header that says 65535 layers over one written layer (5.7 M
    packets, all but the first layer's empty), or 65535 tiles of which one
    is sent: equal to cv2, in a process whose address space may grow by
    1 GiB and whose peak RSS grows by under 32 MiB (the decoder's memory
    follows the stream's bytes, not the header's counts)."""
    data = many_layers() if case == "65535 layers" else many_tiles()
    path = tmp_path / "in.jp2"
    path.write_bytes(data)
    done = subprocess.run(
        [sys.executable, "-c", _PEAK, str(FIXTURES / "pil_L_37x53.jp2"), str(path),
         str(tmp_path / "out.npy")],
        capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parent.parent)
    assert done.returncode == 0, done.stderr[-3000:]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), _cv2(data))
    grown_mib = int(done.stdout.split()[-1])
    assert grown_mib < 32, grown_mib


def test_decoder_is_clean_under_sanitizers():
    """``j2k_decode.cpp`` built with ``-fsanitize=address,undefined`` and
    libstdc++'s index checks, called directly (past the Python checks that
    refuse subsampled components) on every fixture, the named streams
    (among them an empty tile of a subsampled component) and 300 seeded
    cuts and flips: no report."""
    rc, out = sanitize_j2k.run()
    assert rc == 0, out[-4000:]
    assert "empty_tile_component_res2.j2k 0" in out


def test_sycc_conversion_equals_opencv_on_every_triple():
    """sYCC goes through OpenCV's ``COLOR_YUV2BGR``: the port's 14-bit
    fixed-point copy equals it on all 2^24 (Y, U, V) triples."""
    from rcnn_ocr_tpu_torch.data.jpeg2000 import _yuv_to_rgb

    uv = np.arange(256, dtype=np.uint8)
    u, v = np.meshgrid(uv, uv, indexing="ij")
    for y0 in range(0, 256, 16):  # 16 planes of Y at a time
        y = np.repeat(np.arange(y0, y0 + 16, dtype=np.uint8), 65536).reshape(16 * 256, 256)
        uu, vv = np.tile(u, (16, 1)), np.tile(v, (16, 1))
        want = cv2.cvtColor(np.dstack([y, uu, vv]), cv2.COLOR_YUV2BGR)[:, :, ::-1]
        np.testing.assert_array_equal(_yuv_to_rgb(y, uu, vv), want)


def test_image_size_decodes_as_jax_does(tmp_path):
    for name in ("pil_RGB_37x53.jp2", "pil_RGB_codestream_37x53.j2k", "jp2_line_0.jp2"):
        assert image_io.image_size(str(FIXTURES / name)) == jax_tf.image_size(str(FIXTURES / name))


# --- datasets and the eval CLI ----------------------------------------------------------

def _write_lines(root: Path, labels):
    """Lines as lossless and irreversible JP2 and raw codestreams, each its
    own extension (and a 16-bit gray JP2), and as HTJ2K: a lossless JP2 and
    an irreversible codestream with SigProp and MagRef."""
    from tests.test_torch_port_beam_engine import _images
    from tests.test_torch_port_eval_cli import WIDTHS

    rows = []
    for i, (img, label) in enumerate(zip(_images(len(labels), seed=8, widths=WIDTHS), labels)):
        kind = i % 6
        if kind == 4:
            name, data = f"line{i}.jp2", ht.encode_image(img, numres=3, cblk=(16, 16), seed=i)
        elif kind == 5:
            name, data = f"line{i}.j2k", ht.encode_image(img, numres=3, reversible=False, passes=3,
                                                         seed=i, jp2=False)
        elif kind == 0:
            name, data = f"line{i}.jp2", _pil(img, num_resolutions=3)
        elif kind == 1:
            name, data = f"line{i}.j2k", _pil(img, num_resolutions=3, irreversible=True,
                                              no_jp2=True)
        elif kind == 2:
            name, data = f"line{i}.jp2", _pil(img, num_resolutions=2, irreversible=True,
                                              quality_mode="rates", quality_layers=[10])
        else:
            gray = img.mean(axis=2).astype(np.uint16) * 257
            name, data = f"line{i}.jp2", _pil(gray, "I;16", num_resolutions=3)
        (root / name).write_bytes(data)
        rows.append((name, label))
    return rows


def test_dataset_reads_jp2_and_j2k_rows_as_the_jax_dataset(tmp_path):
    """JAX's dataset reads a CSV of ``.jp2`` and ``.j2k`` lines through
    cv2; the port's refused them by name and stopped the run (HTJ2K ones
    until Part 15 was decoded).  Both now read every row to the same
    pixels; a JP2 cut short and an HTJ2K line whose cleanup segment's Scup
    is damaged are quarantined in both, the same substitute served in
    their place."""
    root = tmp_path / "ds"
    root.mkdir()
    rows = _write_lines(root, list("abcdefgh"))
    cut = (root / rows[0][0]).read_bytes()
    (root / "cut.jp2").write_bytes(cut[: len(cut) // 2])
    rows.insert(3, ("cut.jp2", "j"))
    (root / "ht_scup.jp2").write_bytes(ht.none_streams()["Scup under 2"])
    rows.insert(6, ("ht_scup.jp2", "a"))
    csv_path = root / "labels.csv"
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows(rows)
    assert assert_datasets_agree(csv_path, root, len(rows)) == [3, 6]


def test_eval_cli_on_jp2_and_j2k_lines_matches_jax(files, tmp_path, monkeypatch):  # noqa: F811
    import evaluate_dataset
    from rcnn_ocr_tpu_torch import evaluate
    from tests.test_torch_port_eval_cli import LABELS, _run_both

    ckpt, charset, _ = files
    root = tmp_path / "lines"
    root.mkdir()
    rows = _write_lines(root, LABELS)
    csv_path = root / "labels.csv"
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows([("filename", "text"), *rows])
    kw = dict(csv_path=str(csv_path), root_path=str(root), batch_size=3, img_h=32, img_w=64,
              decode="ctc_greedy", max_length=5)
    (want, want_csv), (got, got_csv) = _run_both(
        tmp_path, monkeypatch,
        lambda: evaluate_dataset.evaluate_model(model_path=ckpt, charset_path=charset, **kw),
        lambda: evaluate.evaluate_model(ckpt, charset, device="cpu", dtype=torch.float32, **kw))
    assert got == want and got["n"] == len(LABELS)
    assert list(got_csv.values()) == list(want_csv.values())
