"""Write the APNG fixtures the port's PNG decoder is held to on the card.

    python tests/torch_port_data/make_apng_fixtures.py

Needs cv2 and PIL (the card's script reads only the files).  Writes into
``tests/torch_port_data/apng/``:

* ``hidden_*``: APNGs whose ``IDAT`` image is not a frame (an ``acTL`` of
  at least two frames and no ``fcTL`` before ``IDAT``), where cv2 returns
  the first ``fcTL`` frame, decoded from ``fdAT``: every colour type at
  every depth (palettes with ``tRNS``), plain and Adam7, full-size and
  offset sub-rectangle first frames under each blend and dispose op, a
  split ``fdAT`` run, and PIL's writer (``default_image=True``) in RGB,
  RGBA, L, LA and P at 23x61, 9x5 and 1x300.  PIL writes full-size first
  frames only, so :func:`apng_bytes` below writes the rest by hand.
* ``hidden_damaged_*``: hidden-default files that libpng under OpenCV
  reads with a warning: a bad Adler-32, a damaged or short frame stream
  (the rows it leaves keep the ``IDAT`` image's), wrong ``fdAT`` CRCs and
  sequence numbers, stray chunks once the stream has ended.
* ``first_frame_*``: APNGs whose ``IDAT`` is the first frame, which cv2
  reads through the same APNG path (no CRC checked, the frame's rectangle
  on a zero canvas).
* ``none_*``: files cv2 gives ``None`` on (:data:`CV2_NONE`, with the words
  the port's ``ValueError`` names each by).  Files on which cv2 crashes
  are not written: the tests hold those in a child process.
* ``expected.npz``: cv2's RGB pixels of every file cv2 decodes.

Everything is seeded, so a rerun writes the same bytes with the same cv2
and PIL.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "apng")
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def chunk(kind: bytes, body: bytes, crc=None) -> bytes:
    """A chunk, its CRC computed unless ``crc`` gives it."""
    c = zlib.crc32(kind + body) if crc is None else crc
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", c & 0xFFFFFFFF)


def scanlines(img: np.ndarray, depth: int, interlace: bool = False) -> bytes:
    """``[h, w, c]`` samples (uint16 at depth 16) -> filter-None scanlines,
    in Adam7 passes with ``interlace``."""
    def rows(part):
        out = []
        for r in part:
            if depth == 16:
                b = r.astype(">u2").tobytes()
            elif depth == 8:
                b = r.astype(np.uint8).tobytes()
            else:
                bits = np.unpackbits(r.reshape(-1, 1).astype(np.uint8), axis=1)[:, 8 - depth :]
                b = np.packbits(bits.reshape(-1)).tobytes()
            out.append(b"\x00" + b)
        return b"".join(out)

    if not interlace:
        return rows(img)
    return b"".join(rows(img[y0::dy, x0::dx]) for x0, y0, dx, dy in _ADAM7
                    if img[y0::dy, x0::dx].size)


def fctl(seq: int, w: int, h: int, x: int = 0, y: int = 0, dispose: int = 0, blend: int = 0,
         delay=(1, 10)) -> bytes:
    return chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, x, y, delay[0], delay[1],
                                      dispose, blend))


def apng_bytes(default: np.ndarray, frames, depth: int = 8, ctype: int = 2, pre=(),
               hidden: bool = True, interlace: bool = False, split: int = 0,
               num_frames=None) -> bytes:
    """An APNG of IHDR's size ``default.shape``: ``frames`` is a list of
    ``(samples, x, y, dispose, blend)``; with ``hidden`` the ``IDAT`` image
    (``default``) is not a frame, else it is the first; ``split`` cuts each
    frame's zlib stream into ``fdAT`` chunks of that many bytes; ``pre``
    are chunks before ``acTL`` (PLTE, tRNS)."""
    h, w = default.shape[:2]
    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                 int(interlace)))
    out += b"".join(pre)
    n = len(frames) + (0 if hidden else 1) if num_frames is None else num_frames
    out += chunk(b"acTL", struct.pack(">II", n, 0))
    seq = 0
    if not hidden:
        out += fctl(seq, w, h)
        seq += 1
    out += chunk(b"IDAT", zlib.compress(scanlines(default, depth, interlace)))
    for img, x, y, dispose, blend in frames:
        out += fctl(seq, img.shape[1], img.shape[0], x, y, dispose, blend)
        seq += 1
        z = zlib.compress(scanlines(img, depth, interlace))
        for a in range(0, len(z), split or len(z)):
            out += chunk(b"fdAT", struct.pack(">I", seq) + z[a : a + (split or len(z))])
            seq += 1
    return out + chunk(b"IEND", b"")


def apng_chunks(data: bytes):
    """``[(type, body), ...]`` of a PNG file."""
    pos, out = 8, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        out.append((kind, data[pos + 8 : pos + 8 + n]))
        pos += 12 + n
    return out


def rejoin(parts, crcs=None) -> bytes:
    """A PNG of these ``(type, body)`` chunks (``crcs``: index -> CRC)."""
    crcs = crcs or {}
    return SIGNATURE + b"".join(chunk(k, b, crcs.get(i)) for i, (k, b) in enumerate(parts))


def samples(rng, h: int, w: int, ctype: int, depth: int, n_pal: int = 0) -> np.ndarray:
    if ctype == 3:
        return rng.integers(0, n_pal, (h, w, 1)).astype(np.uint8)
    return rng.integers(0, 1 << depth, (h, w, CHANNELS[ctype])).astype(
        np.uint16 if depth == 16 else np.uint8)


def _hand_fixtures(rng) -> dict:
    files = {}
    H, W = 9, 13
    kinds = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
    for ctype, depth in kinds:
        pre, n_pal = [], 0
        if ctype == 3:
            n_pal = 1 << depth
            pal = rng.integers(0, 256, (n_pal, 3)).astype(np.uint8)
            pre = [chunk(b"PLTE", pal[: max(1, n_pal - 1)].tobytes()),  # the last index past it
                   chunk(b"tRNS", bytes(rng.integers(0, 256, max(1, n_pal // 2)).tolist()))]
        elif ctype in (0, 2) and depth == 8:
            pre = [chunk(b"tRNS", bytes(2 * CHANNELS[ctype]))]
        for interlace in (False, True):
            d = samples(rng, H, W, ctype, depth, n_pal)
            f1 = samples(rng, 5, 7, ctype, depth, n_pal)
            f2 = samples(rng, H, W, ctype, depth, n_pal)
            name = f"hidden_c{ctype}_{depth}{'_adam7' if interlace else ''}_sub_{H}x{W}.png"
            files[name] = apng_bytes(d, [(f1, 4, 3, 1, 1), (f2, 0, 0, 0, 0)], depth, ctype, pre,
                                     interlace=interlace)
    # each blend and dispose op on an offset sub-rectangle, RGBA with every alpha
    d = samples(rng, H, W, 6, 8)
    for dispose in range(3):
        for blend in range(2):
            f1 = samples(rng, 4, 6, 6, 8)
            f1[0, :4, 3] = (0, 1, 128, 255)
            files[f"hidden_rgba_d{dispose}_b{blend}_sub_{H}x{W}.png"] = apng_bytes(
                d, [(f1, 7, 5, dispose, blend), (samples(rng, 3, 3, 6, 8), 1, 1, 0, 1)], 8, 6)
    f1 = samples(rng, H, W, 2, 8)
    files[f"hidden_rgb_full_split_{H}x{W}.png"] = apng_bytes(
        samples(rng, H, W, 2, 8), [(f1, 0, 0, 0, 0), (f1[::-1].copy(), 0, 0, 0, 0)], split=7)
    files[f"hidden_rgb_corner_{H}x{W}.png"] = apng_bytes(
        samples(rng, H, W, 2, 8), [(samples(rng, 1, 1, 2, 8), W - 1, H - 1, 0, 0),
                                   (samples(rng, 2, 2, 2, 8), 0, 0, 0, 0)])
    files[f"hidden_rgb_three_frames_{H}x{W}.png"] = apng_bytes(
        samples(rng, H, W, 2, 8), [(samples(rng, 4, 4, 2, 8), 2, 2, 2, 0),
                                   (samples(rng, 5, 5, 2, 8), 0, 0, 0, 0),
                                   (samples(rng, 6, 6, 2, 8), 3, 3, 0, 0)])
    files.update(_damaged(rng, H, W))
    # the IDAT is the first frame: the same APNG path
    d = samples(rng, H, W, 2, 8)
    files[f"first_frame_rgb_{H}x{W}.png"] = apng_bytes(d, [(samples(rng, 4, 5, 2, 8), 3, 2, 0, 0)],
                                                       hidden=False)
    parts = apng_chunks(files[f"first_frame_rgb_{H}x{W}.png"])
    i_idat = [k for k, _ in parts].index(b"IDAT")
    files[f"first_frame_idat_crc_{H}x{W}.png"] = rejoin(parts, {i_idat: 1})
    narrow = list(parts)
    narrow[2] = (b"fcTL", fctl(0, W - 3, H - 2)[8:-4])
    files[f"first_frame_narrow_fctl_{H}x{W}.png"] = rejoin(narrow)
    return files


def _frame_parts(rng, H, W):
    d = np.full((H, W, 3), 50, np.uint8)
    f1 = samples(rng, 5, 7, 2, 8)
    data = apng_bytes(d, [(f1, 4, 3, 0, 0), (samples(rng, H, W, 2, 8), 0, 0, 0, 0)])
    parts = apng_chunks(data)
    return parts, [k for k, _ in parts].index(b"fdAT"), f1


def _damaged(rng, H, W) -> dict:
    """Hidden-default files libpng under OpenCV reads with a warning."""
    files = {}
    parts, i, f1 = _frame_parts(rng, H, W)
    body = parts[i][1]
    z = body[4:]

    def with_fdat(new_body):
        p = list(parts)
        p[i] = (b"fdAT", new_body)
        return rejoin(p)

    raw = scanlines(f1, 8)
    files[f"hidden_damaged_adler_{H}x{W}.png"] = with_fdat(body[:-4] + b"\x00\x01\x02\x03")
    files[f"hidden_damaged_zlib_header_{H}x{W}.png"] = with_fdat(body[:4] + b"\x78\x00" + z[2:])
    files[f"hidden_damaged_stream_short_{H}x{W}.png"] = with_fdat(
        body[:4] + zlib.compress(raw[: 2 * len(raw) // 5]))
    files[f"hidden_damaged_stream_long_{H}x{W}.png"] = with_fdat(
        body[:4] + zlib.compress(raw + raw[:40]))
    files[f"hidden_damaged_trailing_{H}x{W}.png"] = with_fdat(body + b"junk")
    files[f"hidden_damaged_fdat_crc_{H}x{W}.png"] = rejoin(parts, {i: 0})
    files[f"hidden_damaged_idat_crc_{H}x{W}.png"] = rejoin(parts, {2: 0})
    files[f"hidden_damaged_fctl_crc_{H}x{W}.png"] = rejoin(parts, {3: 0})
    files[f"hidden_damaged_sequence_{H}x{W}.png"] = with_fdat(struct.pack(">I", 77) + z)
    p = list(parts)
    p.insert(i + 1, (b"tEXt", b"k\x00v"))
    p.insert(i + 1, (b"IDAT", b"after the stream"))
    files[f"hidden_damaged_chunks_after_stream_{H}x{W}.png"] = rejoin(p)
    p = list(parts)
    p.insert(2, (b"tEXt", b"k\x00v"))
    p.insert(3 + 1, (b"fdAT", struct.pack(">I", 9) + b"before its fcTL"))
    files[f"hidden_damaged_fdat_before_fctl_{H}x{W}.png"] = rejoin(p)
    p = list(parts)
    p[-2] = (b"fcTL", fctl(3, 0, 0)[8:-4])  # the next frame's sides are not read
    files[f"hidden_damaged_next_fctl_empty_{H}x{W}.png"] = rejoin(p)
    files[f"hidden_damaged_no_iend_{H}x{W}.png"] = rejoin(parts[:-1])
    return files


def _none(rng, H=9, W=13) -> dict:
    parts, i, _ = _frame_parts(rng, H, W)
    body = parts[i][1]

    def with_fdat(new_body):
        p = list(parts)
        p[i] = (b"fdAT", new_body)
        return rejoin(p)

    j = [k for k, _ in parts].index(b"fcTL")
    ctl = bytearray(parts[j][1])
    ctl[24] = 3
    p = list(parts)
    p[j] = (b"fcTL", bytes(ctl))
    outside = list(parts)
    outside[j] = (b"fcTL", fctl(0, 7, 5, 7, 3)[8:-4])
    empty = list(parts)
    empty[j] = (b"fcTL", fctl(0, 0, 5, 1, 1)[8:-4])
    return {
        "none_fdat_stream_cut.png": with_fdat(body[:-1]),
        "none_fdat_no_data.png": with_fdat(body[:4]),
        "none_fctl_dispose_3.png": rejoin(p),
        "none_fctl_outside.png": rejoin(outside),
        "none_fctl_empty.png": rejoin(empty),
        "none_no_frame_after_idat.png": rejoin(parts[:j]),
        "none_two_fctl_no_data.png": rejoin(parts[: j + 1] + parts[j:j + 1] + parts[j + 1:]),
    }


# the files cv2 gives None on, and the words the port's ValueError names each by
CV2_NONE = {"none_fdat_stream_cut.png": "ends before its zlib stream does",
            "none_fdat_no_data.png": "ends before its zlib stream does",
            "none_fctl_dispose_3.png": "dispose op 3",
            "none_fctl_outside.png": "outside the image",
            "none_fctl_empty.png": "0x5 pixels",
            "none_no_frame_after_idat.png": "truncated",
            "none_two_fctl_no_data.png": "without image data"}


def _pil_fixtures(rng) -> dict:
    from PIL import Image

    files = {}
    for mode in ("RGB", "RGBA", "L", "LA", "P"):
        for h, w in ((23, 61), (9, 5), (1, 300)):
            ims = []
            for _ in range(3):
                a = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
                im = Image.fromarray(a, "RGBA")
                ims.append(im.convert(mode) if mode != "P" else im.convert("RGB").quantize(16))
            kw = {}
            if mode == "RGBA":
                kw = dict(blend=[1, 0], disposal=[2, 1])
            elif mode == "P":
                kw = dict(transparency=3)
            bio = io.BytesIO()
            ims[0].save(bio, format="PNG", save_all=True, append_images=ims[1:],
                        default_image=True, **kw)
            files[f"hidden_pil_{mode.lower()}_{h}x{w}.png"] = bio.getvalue()
    return files


def fixtures() -> dict:
    rng = np.random.default_rng(20261021)
    files = _hand_fixtures(rng)
    files.update(_pil_fixtures(rng))
    files.update(_none(rng))
    return files


def main() -> None:
    import cv2

    os.makedirs(OUT, exist_ok=True)
    expected = {}
    files = fixtures()
    for name, data in files.items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if name in CV2_NONE:
            assert bgr is None, name
            continue
        assert bgr is not None, name
        expected[name] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    np.savez_compressed(os.path.join(OUT, "expected.npz"), **expected)
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"wrote {len(files)} APNGs and expected.npz into {OUT}: {total} bytes")
    for name in sorted(set(os.listdir(OUT)) - set(files) - {"expected.npz"}):
        print(f"  {name} is written by no fixture any more")


if __name__ == "__main__":
    main()
