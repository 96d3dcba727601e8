"""Write the WebP, GIF and Netpbm fixtures the port's decoders are held to
on the card.

    python tests/torch_port_data/make_web_fixtures.py

Needs cv2 and PIL (the card's script reads only the files).  Writes into
``tests/torch_port_data/{webp,gif,pnm}/``:

* files written by cv2 and PIL: lossy WebP (qualities, methods, odd sides,
  a 1x1), lossless WebP, WebP with alpha (lossy and lossless, colour under
  alpha 0), animated WebP and GIF, GIFs of 2 to 256 colours, PBM / PGM /
  PPM / PAM from cv2;
* hand-written bytes where no encoder writes the case: VP8 key frames from
  :func:`vp8_frame` (B_PRED and 16x16 modes at every edge, four segments
  with relative and absolute deltas, the normal and simple loop filters
  with sharpness and mode / reference deltas, 1-8 token partitions, large
  coefficients), VP8L images from :func:`vp8l_bytes` (all four transforms,
  every predictor mode, colour cache, LZ77 with the distance map, a meta
  prefix image), containers from :func:`riff` (an animation's first frame
  inside a larger canvas, metadata chunks, raw and VP8L-coded ALPH with
  each filter), GIFs from :func:`gif_bytes` (interlace, transparency,
  local tables, a first frame offset inside a larger screen, deferred
  clear, a full code table, End of Information mid-stream) and Netpbm from
  :func:`pnm_bytes` (every magic, ASCII spacing and comments, maxval 1,
  15, 100, 255, 1000 and 65535, PAM tuple types);
* ``app_*.gif`` (:func:`gif_app_fixtures`): application extensions that
  OpenCV's frame count reads through;
* ``exif*.webp`` (:func:`webp_exif_fixtures`): an ``EXIF`` chunk of each
  orientation, both byte orders, before and after the image, in an
  animation, with the VP8X flag unset, a leading ``Exif\0\0``, two
  chunks, and a file libwebp's demuxer refuses (its image still decodes);
* ``*_line_N.*``: text lines for the card's daemon phase (lossy WebP,
  lossless WebP with alpha, interlaced GIF with a transparent index, binary
  PGM, and ``webpo_line_0.webp``, a lossless line stored on its side with
  orientation 6);
* ``expected.npz`` in each folder: cv2's RGB pixels
  (``cv2.imdecode(IMREAD_COLOR)`` then BGR -> RGB) of every file, keyed by
  file name.

RFC 6386's tables (VP8's default coefficient, update and B_PRED mode
probabilities) and VP8L's distance map are read from the port's own
``csrc/host/webp_decode.cpp``, the code under test, by :func:`_table`:
renaming one of them there, or changing its layout, breaks this writer.
What keeps the hand-written frames an independent check is that every
one is held to cv2's (libwebp's) pixels, not to the port's: a wrong table
would give a stream that libwebp decodes differently, or not at all.
Everything is seeded, so a rerun writes the same bytes with the same cv2
and PIL.
"""

from __future__ import annotations

import heapq
import io
import os
import re
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "..", "..", "rcnn_ocr_tpu_torch", "csrc", "host", "webp_decode.cpp")


def _table(name: str, shape) -> np.ndarray:
    text = open(SOURCE).read()
    body = re.search(name + r"\[[^=]*=\s*\{([^}]*)\}", text).group(1)
    return np.array([int(v) for v in re.findall(r"\d+", body)], np.int64).reshape(shape)


# --- GIF --------------------------------------------------------------------------------

def lzw_encode(idx, mcs: int, defer: bool = False, initial_clear: bool = True,
               clear_every: int = 0, eoi_at: int = -1) -> bytes:
    """GIF LZW of a flat index sequence (not yet cut into sub-blocks).
    ``defer``: no Clear when the table is full (a deferred clear);
    ``clear_every``: a Clear after every so many codes; ``eoi_at``: an End
    of Information after that many codes (OpenCV reads on after it)."""
    clear, eoi = 1 << mcs, (1 << mcs) + 1
    codes = []
    st = {}

    def reset():
        st.update(table={bytes([i]): i for i in range(clear)}, enc_next=eoi + 1,
                  dn=eoi + 1, width=mcs + 1, first=True)

    def emit(code):  # the decoder's state, mirrored, gives each code its width
        codes.append((code, st["width"]))
        if code in (clear, eoi):
            reset()
            return
        if not st["first"] and st["dn"] < 4096:
            st["dn"] += 1
            if st["dn"] == (1 << st["width"]) and st["width"] < 12:
                st["width"] += 1
        st["first"] = False

    reset()
    if initial_clear:
        emit(clear)
    w, count = b"", 0
    for k in idx:
        wk = w + bytes([int(k)])
        if wk in st["table"]:
            w = wk
            continue
        emit(st["table"][w])
        count += 1
        if count == eoi_at:
            emit(eoi)
            w = bytes([int(k)])
            continue
        if st["enc_next"] < 4096:
            st["table"][wk] = st["enc_next"]
            st["enc_next"] += 1
        elif not defer:
            emit(clear)
        if clear_every and count % clear_every == 0:
            emit(clear)
        w = bytes([int(k)])
    if w:
        emit(st["table"][w])
    codes.append((eoi, st["width"]))
    return _pack_lsb(codes)


def _pack_lsb(codes) -> bytes:
    acc = nacc = 0
    out = bytearray()
    for code, width in codes:
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes, size: int = 255) -> bytes:
    out = bytearray()
    for i in range(0, len(data), size):
        part = data[i : i + size]
        out += bytes([len(part)]) + part
    return bytes(out + b"\x00")


def _gif_table(pal, flags_bits: int) -> bytes:
    table = np.zeros((2 << flags_bits, 3), np.uint8)
    pal = np.asarray(pal, np.uint8).reshape(-1, 3)
    table[: len(pal)] = pal[: len(table)]
    return table.tobytes()


def _bits_for(n: int) -> int:
    return max(0, int(np.ceil(np.log2(max(n, 2)))) - 1)


def gif_bytes(frames, screen, gpal=None, bg: int = 0, version: bytes = b"GIF89a",
              loop: bool = False) -> bytes:
    """A GIF of ``frames`` on a ``screen`` of (width, height).  Each frame is
    a dict: ``idx`` [h, w] indices, and optionally ``left``, ``top``,
    ``lpal`` (a local table), ``interlace``, ``transparent``, ``disposal``,
    ``mcs`` (minimum code size), ``lzw`` (keyword arguments of
    :func:`lzw_encode`), ``raw`` (LZW bytes as they are), ``block``
    (sub-block size), ``extensions`` (raw blocks before the descriptor)."""
    sw, sh = screen
    flags = 0
    if gpal is not None:
        gb = _bits_for(len(gpal))
        flags = 0x80 | gb | (gb << 4)
    out = bytearray(version + struct.pack("<HHBBB", sw, sh, flags, bg, 0))
    if gpal is not None:
        out += _gif_table(gpal, gb)
    if loop:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        idx = np.asarray(f["idx"], np.uint8)
        h, w = idx.shape
        t = f.get("transparent")
        if t is not None or f.get("disposal"):
            packed = ((f.get("disposal", 0) & 7) << 2) | (t is not None)
            out += struct.pack("<BBBBHBB", 0x21, 0xF9, 4, packed, f.get("delay", 10), t or 0, 0)
        for ext in f.get("extensions", ()):
            out += ext
        iflags = 0x40 if f.get("interlace") else 0
        lpal = f.get("lpal")
        if lpal is not None:
            lb = _bits_for(len(lpal))
            iflags |= 0x80 | lb
        out += struct.pack("<BHHHHB", 0x2C, f.get("left", 0), f.get("top", 0), w, h, iflags)
        if lpal is not None:
            out += _gif_table(lpal, lb)
        rows = idx
        if f.get("interlace"):
            rows = idx[np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                       np.arange(1, h, 2)])]
        mcs = f.get("mcs", 8)
        data = f["raw"] if "raw" in f else lzw_encode(rows.reshape(-1), mcs, **f.get("lzw", {}))
        out += bytes([mcs]) + _sub_blocks(data, f.get("block", 255))
    return bytes(out + b"\x3b")


# --- Netpbm -----------------------------------------------------------------------------

def pnm_bytes(img, magic: int, maxval: int = 255, sep: bytes = b" ", row_sep: bytes = b"\n",
              comment: bytes = b"", header_sep: bytes = b"\n", packed: bool = False) -> bytes:
    """A P1-P6 file of ``img`` ([h, w] for P1/P2/P4/P5, [h, w, 3] for P3/P6;
    P1/P4 take 1 for black).  ``sep`` / ``row_sep`` space the ASCII samples,
    ``comment`` (``#...\\n``) goes after each header number, ``packed`` writes
    P1 digits with no space."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    head = b"P%d" % magic + header_sep + comment + b"%d" % w + header_sep + comment + b"%d" % h
    if magic not in (1, 4):
        head += header_sep + comment + b"%d" % maxval
    head += b"\n"
    if magic == 4:
        return head + np.packbits(img.astype(np.uint8) != 0, axis=1).tobytes()
    if magic in (5, 6):
        if maxval > 255:
            return head + img.astype(">u2").tobytes()
        return head + img.astype(np.uint8).tobytes()
    rows = img.reshape(h, -1)
    joiner = b"" if (magic == 1 and packed) else sep
    return head + row_sep.join(joiner.join(b"%d" % int(v) for v in row) for row in rows) + b"\n"


def pam_bytes(img, maxval: int = 255, tupltype: bytes = b"GRAYSCALE",
              extra: bytes = b"") -> bytes:
    """A P7 file of ``img`` [h, w, depth]; ``extra`` header lines go before
    ENDHDR (comments, a repeated TUPLTYPE)."""
    img = np.asarray(img)
    h, w, d = img.shape
    head = (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (w, h, d, maxval)
            + (b"TUPLTYPE " + tupltype + b"\n" if tupltype else b"") + extra + b"ENDHDR\n")
    return head + (img.astype(">u2") if maxval > 255 else img.astype(np.uint8)).tobytes()


# --- WebP container ---------------------------------------------------------------------

def chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\x00" if len(body) & 1 else b"")


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(w: int, h: int, flags: int = 0) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


def anmf(x: int, y: int, w: int, h: int, frame_chunks: bytes, duration: int = 100,
         flags: int = 0) -> bytes:
    return chunk(b"ANMF", (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                 + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                 + duration.to_bytes(3, "little") + bytes([flags]) + frame_chunks)


def webp_chunks(data: bytes):
    """The (tag, payload) chunks of a RIFF WebP file."""
    pos, out = 12, []
    while pos + 8 <= len(data):
        tag, n = data[pos : pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((tag, data[pos + 8 : pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


# --- VP8L -------------------------------------------------------------------------------

class _LsbWriter:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value: int, nbits: int):
        self.acc |= (int(value) & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def data(self) -> bytes:
        return bytes(self.out + (bytes([self.acc]) if self.n else b""))


def _huffman_lengths(freq, max_len: int):
    """Code lengths of a complete prefix code for the symbols with a
    non-zero count (at most ``max_len`` bits; one symbol gets length 1)."""
    freq = [int(f) for f in freq]
    used = [s for s, f in enumerate(freq) if f > 0]
    lengths = [0] * len(freq)
    if len(used) == 1:
        lengths[used[0]] = 1
        return lengths
    while True:
        heap = [(freq[s], i, (s,)) for i, s in enumerate(used)]
        heapq.heapify(heap)
        depth = dict.fromkeys(used, 0)
        tie = len(heap)
        while len(heap) > 1:
            f1, _, a = heapq.heappop(heap)
            f2, _, b = heapq.heappop(heap)
            for s in a + b:
                depth[s] += 1
            heapq.heappush(heap, (f1 + f2, tie, a + b))
            tie += 1
        if max(depth.values()) <= max_len:
            for s in used:
                lengths[s] = depth[s]
            return lengths
        freq = [(f + 1) // 2 if f else 0 for f in freq]


def _canonical(lengths):
    codes, code = [0] * len(lengths), 0
    for length in range(1, 16):
        for s, ln in enumerate(lengths):
            if ln == length:
                codes[s] = int(format(code, f"0{length}b")[::-1], 2)  # bit-reversed
                code += 1
        code <<= 1
    return codes


_CL_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _write_code(bw: _LsbWriter, freq, use_max_symbol: bool = False):
    """Write a prefix code for symbol counts ``freq`` -> (lengths, codes)."""
    used = [s for s, f in enumerate(freq) if f > 0]
    if not used:
        used, freq = [0], [1] + [0] * (len(freq) - 1)
    if len(used) <= 2 and max(used) < 256:
        bw.put(1, 1)  # simple code
        bw.put(len(used) - 1, 1)
        first_8 = used[0] > 1
        bw.put(first_8, 1)
        bw.put(used[0], 8 if first_8 else 1)
        if len(used) == 2:
            bw.put(used[1], 8)
        lengths = [0] * len(freq)
        for s in used:
            lengths[s] = 1 if len(used) == 2 else 0
        codes = [0] * len(freq)
        if len(used) == 2:
            codes[used[1]] = 1
        return lengths, codes
    lengths = _huffman_lengths(freq, 15)
    last = max(s for s, ln in enumerate(lengths) if ln)
    tokens = []  # (symbol, extra bits value, extra bits)
    s = 0
    while s <= last:
        if lengths[s] == 0:
            run = 1
            while s + run <= last and lengths[s + run] == 0 and run < 138:
                run += 1
            if run >= 11:
                tokens.append((18, run - 11, 7))
            elif run >= 3:
                tokens.append((17, run - 3, 3))
            else:
                tokens += [(0, 0, 0)] * run
            s += run
        else:
            tokens.append((lengths[s], 0, 0))
            s += 1
    cl_freq = [0] * 19
    for t, _, _ in tokens:
        cl_freq[t] += 1
    cl_lengths = _huffman_lengths(cl_freq, 7)
    cl_codes = _canonical(cl_lengths)
    if sum(1 for v in cl_lengths if v) == 1:
        cl_codes = [0] * 19
    n_codes = max(4, max(i for i, sym in enumerate(_CL_ORDER) if cl_lengths[sym]) + 1)
    bw.put(0, 1)
    bw.put(n_codes - 4, 4)
    for i in range(n_codes):
        bw.put(cl_lengths[_CL_ORDER[i]], 3)
    if use_max_symbol or last + 1 < len(freq):
        bw.put(1, 1)  # max_symbol: the number of tokens written
        nbits = 2
        while len(tokens) - 2 >= 1 << nbits:
            nbits += 2
        bw.put((nbits - 2) // 2, 3)
        bw.put(len(tokens) - 2, nbits)
    else:
        bw.put(0, 1)
    single = sum(1 for v in cl_lengths if v) == 1
    for t, extra, nextra in tokens:
        if not single:
            bw.put(cl_codes[t], cl_lengths[t])
        if nextra:
            bw.put(extra, nextra)
    return lengths, _canonical(lengths)


def _prefix(v: int):
    """LZ77 length or distance ``v`` >= 1 -> (symbol, extra bits, value)."""
    if v <= 4:
        return v - 1, 0, 0
    v -= 1
    high = v.bit_length() - 1
    second = (v >> (high - 1)) & 1
    return 2 * high + second, high - 1, v & ((1 << (high - 1)) - 1)


def _plane_codes(xsize: int):
    """distance -> the smallest 2-D plane code giving it (for this width)."""
    out = {}
    for code, d in enumerate(_table("kCodeToPlane", (120,)), start=1):
        dist = max(1, (int(d) >> 4) * xsize + 8 - (int(d) & 15))
        out.setdefault(dist, code)
    return out


def _entropy_image(bw: _LsbWriter, px: np.ndarray, xsize: int, cache_bits: int = 0,
                   lz77: bool = False, meta_bits: int = 0, groups=None, level0: bool = False,
                   rng=None):
    """Write the colour cache bits, (level 0) the meta prefix image, the
    prefix codes and the pixels of ``px`` (flat uint32 ARGB)."""
    px = [int(v) for v in px]
    n = len(px)
    ysize = n // xsize
    bw.put(cache_bits > 0, 1)
    if cache_bits:
        bw.put(cache_bits, 4)
    if level0:
        bw.put(meta_bits > 0, 1)
    mw = -(-xsize // (1 << meta_bits)) if meta_bits else 1
    group_of = [0] * n
    if meta_bits:
        mh = -(-ysize // (1 << meta_bits))
        gmap = np.asarray(groups, np.int64).reshape(mh, mw)
        bw.put(meta_bits - 2, 3)
        _entropy_image(bw, (0xFF000000 | (gmap.reshape(-1) << 8)).astype(np.uint64), mw)
        for i in range(n):
            group_of[i] = int(gmap[(i // xsize) >> meta_bits, (i % xsize) >> meta_bits])
    n_groups = max(group_of) + 1
    # tokens: ("lit", argb) | ("cache", key) | ("copy", length, dist code)
    cache = [None] * (1 << cache_bits) if cache_bits else None
    plane = _plane_codes(xsize)
    tokens, i = [], 0
    last_pos = {}
    while i < n:
        best = None
        if lz77 and i > 0:
            cands = [i - 1, i - xsize] + ([last_pos[px[i]]] if px[i] in last_pos else [])
            for j in cands:
                if 0 <= j < i:
                    length = 0
                    while i + length < n and length < 4096 and px[j + length] == px[i + length]:
                        length += 1
                    if length >= 3 and (best is None or length > best[0]):
                        best = (length, i - j)
        if best is not None and (rng is None or rng.random() < 0.9):
            length, dist = best
            code = plane.get(dist, dist + 120)
            tokens.append(("copy", length, code, i))
            for k in range(length):
                last_pos[px[i + k]] = i + k
                if cache is not None:
                    cache[((0x1E35A7BD * px[i + k]) & 0xFFFFFFFF) >> (32 - cache_bits)] = px[i + k]
            i += length
            continue
        key = ((0x1E35A7BD * px[i]) & 0xFFFFFFFF) >> (32 - cache_bits) if cache is not None else 0
        if cache is not None and cache[key] == px[i]:
            tokens.append(("cache", key, 0, i))
        else:
            tokens.append(("lit", px[i], 0, i))
        if cache is not None:
            cache[key] = px[i]
        last_pos[px[i]] = i
        i += 1
    green_size = 280 + ((1 << cache_bits) if cache_bits else 0)
    freqs = [[[0] * green_size, [0] * 256, [0] * 256, [0] * 256, [0] * 40]
             for _ in range(n_groups)]
    for kind, a, b, pos in tokens:
        f = freqs[group_of[pos]]
        if kind == "lit":
            f[0][(a >> 8) & 255] += 1
            f[1][(a >> 16) & 255] += 1
            f[2][a & 255] += 1
            f[3][a >> 24] += 1
        elif kind == "cache":
            f[0][280 + a] += 1
        else:
            f[0][256 + _prefix(a)[0]] += 1
            f[4][_prefix(b)[0]] += 1
    codes = []
    for g in range(n_groups):
        codes.append([_write_code(bw, freqs[g][j], use_max_symbol=(g + j) % 3 == 0)
                      for j in range(5)])
    for kind, a, b, pos in tokens:
        (gl, gc), (rl, rc), (bl, bc), (al, ac), (dl, dc) = codes[group_of[pos]]
        if kind == "lit":
            g_, r_, b_, a_ = (a >> 8) & 255, (a >> 16) & 255, a & 255, a >> 24
            bw.put(gc[g_], gl[g_])
            bw.put(rc[r_], rl[r_])
            bw.put(bc[b_], bl[b_])
            bw.put(ac[a_], al[a_])
        elif kind == "cache":
            bw.put(gc[280 + a], gl[280 + a])
        else:
            sym, nb, extra = _prefix(a)
            bw.put(gc[256 + sym], gl[256 + sym])
            bw.put(extra, nb)
            sym, nb, extra = _prefix(b)
            bw.put(dc[sym], dl[sym])
            bw.put(extra, nb)


def _avg2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clamp_full(a, b, c):
    return sum(min(255, max(0, ((a >> k) & 255) + ((b >> k) & 255) - ((c >> k) & 255))) << k
               for k in (0, 8, 16, 24))


def _clamp_half(a, b):
    out = 0
    for k in (0, 8, 16, 24):
        x, y = (a >> k) & 255, (b >> k) & 255
        out |= min(255, max(0, x + int((x - y) / 2))) << k
    return out


def _select(t, l, tl):
    d = sum(abs(((l >> k) & 255) - ((tl >> k) & 255)) - abs(((t >> k) & 255) - ((tl >> k) & 255))
            for k in (0, 8, 16, 24))
    return t if d <= 0 else l


def _predict(mode, d, i, w):
    L, T, TR, TL = d[i - 1], d[i - w], d[i - w + 1], d[i - w - 1]
    return {1: L, 2: T, 3: TR, 4: TL, 5: _avg2(_avg2(L, TR), T), 6: _avg2(L, TL), 7: _avg2(L, T),
            8: _avg2(TL, T), 9: _avg2(T, TR), 10: _avg2(_avg2(L, TL), _avg2(T, TR)),
            11: _select(T, L, TL), 12: _clamp_full(L, T, TL),
            13: _clamp_half(_avg2(L, T), TL)}.get(mode, 0xFF000000)


def _sub(a, b):
    return sum((((a >> k) - (b >> k)) & 255) << k for k in (0, 8, 16, 24))


def _delta(t, c):
    t = t - 256 if t > 127 else t
    c = c - 256 if c > 127 else c
    return (t * c) >> 5


def vp8l_bytes(argb, transforms=(), cache_bits: int = 0, lz77: bool = False, meta_bits: int = 0,
               seed: int = 0, header: bool = True, alpha_hint: bool = True) -> bytes:
    """A VP8L stream of ``argb`` [h, w] uint32.  ``transforms``, in stream
    order: ``("index",)`` (a palette of the image's colours, bundled),
    ``("predict", bits)`` (a random mode 0-15 a block), ``("color", bits)``
    (random multipliers a block), ``("green",)``.  ``meta_bits``: a meta
    prefix image of 3 groups.  ``header=False`` writes an ALPH chunk's
    headerless stream."""
    rng = np.random.default_rng(seed)
    argb = np.asarray(argb, np.uint64).astype(np.int64)
    h, w = argb.shape
    bw = _LsbWriter()
    if header:
        bw.put(0x2F, 8)
        bw.put(w - 1, 14)
        bw.put(h - 1, 14)
        bw.put(int(alpha_hint), 1)
        bw.put(0, 3)
    px = [int(v) for v in argb.reshape(-1)]
    xs = w
    for t in transforms:
        bw.put(1, 1)
        if t[0] == "index":
            pal = sorted(set(px))
            assert len(pal) <= 256
            bits = 0 if len(pal) > 16 else 1 if len(pal) > 4 else 2 if len(pal) > 2 else 3
            bw.put(3, 2)
            bw.put(len(pal) - 1, 8)
            deltas = [pal[0]] + [_sub(pal[i], pal[i - 1]) for i in range(1, len(pal))]
            _entropy_image(bw, np.array(deltas, np.uint64), len(pal))
            index = {c: i for i, c in enumerate(pal)}
            per, bpp = 1 << bits, 8 >> bits
            nxs = -(-xs // per)
            packed = []
            for y in range(len(px) // xs):
                for xb in range(nxs):
                    v = 0
                    for k in range(per):
                        x = xb * per + k
                        if x < xs:
                            v |= index[px[y * xs + x]] << (k * bpp)
                    packed.append(0xFF000000 | (v << 8))
            px, xs = packed, nxs
        elif t[0] == "predict":
            bits = t[1]
            bw.put(0, 2)
            bw.put(bits - 2, 3)
            ys = len(px) // xs
            bwid, bh = -(-xs // (1 << bits)), -(-ys // (1 << bits))
            modes = rng.integers(0, 16, (bh, bwid))
            modes.flat[: min(16, modes.size)] = np.arange(16)[: min(16, modes.size)]
            _entropy_image(bw, (0xFF000000 | (modes.reshape(-1).astype(np.int64) << 8)), bwid)
            res = []
            for i in range(len(px)):
                x, y = i % xs, i // xs
                if i == 0:
                    pred = 0xFF000000
                elif y == 0:
                    pred = px[i - 1]
                elif x == 0:
                    pred = px[i - xs]
                else:
                    pred = _predict(int(modes[y >> bits, x >> bits]), px, i, xs)
                res.append(_sub(px[i], pred))
            px = res
        elif t[0] == "color":
            bits = t[1]
            bw.put(1, 2)
            bw.put(bits - 2, 3)
            ys = len(px) // xs
            bwid, bh = -(-xs // (1 << bits)), -(-ys // (1 << bits))
            mult = rng.integers(0, 256, (bh, bwid, 3))
            _entropy_image(bw, (0xFF000000 | (mult[..., 2] << 16) | (mult[..., 1] << 8)
                                | mult[..., 0]).reshape(-1).astype(np.int64), bwid)
            res = []
            for i, p in enumerate(px):
                g2r, g2b, r2b = (int(v) for v in mult[(i // xs) >> bits, (i % xs) >> bits])
                g, r, b = (p >> 8) & 255, (p >> 16) & 255, p & 255
                nr = (r - _delta(g2r, g)) & 255
                nb = (b - _delta(g2b, g) - _delta(r2b, r)) & 255
                res.append((p & 0xFF00FF00) | (nr << 16) | nb)
            px = res
        else:
            bw.put(2, 2)
            px = [(p & 0xFF00FF00) | ((((p >> 16) - (p >> 8)) & 255) << 16)
                  | (((p & 255) - ((p >> 8) & 255)) & 255) for p in px]
    bw.put(0, 1)
    groups = None
    if meta_bits:
        ys = len(px) // xs
        mw, mh = -(-xs // (1 << meta_bits)), -(-ys // (1 << meta_bits))
        groups = rng.integers(0, 3, mh * mw)
        groups[:3] = [0, 1, 2][: len(groups[:3])]
    _entropy_image(bw, np.array(px, np.int64), xs, cache_bits, lz77, meta_bits, groups,
                   level0=True, rng=rng)
    return bw.data()


# --- VP8 --------------------------------------------------------------------------------

class _BoolWriter:
    """RFC 6386's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def put(self, bit, prob: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                i = len(self.out) - 1
                while i >= 0 and self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if self.bit_count == 0:
                self.out.append((self.bottom >> 24) & 255)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v: int, nbits: int):
        for k in range(nbits - 1, -1, -1):
            self.put((v >> k) & 1, 128)

    def signed(self, v: int, nbits: int):
        self.value(abs(v), nbits)
        self.put(v < 0, 128)

    def data(self) -> bytes:
        for _ in range(32):
            self.put(0, 128)
        return bytes(self.out)


_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
_BMODE_TREE = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)


def _tree_path(tree, leaf):
    """(index, bit) pairs that lead the tree walk to ``-leaf``."""
    def walk(i, path):
        for bit in (0, 1):
            nxt = tree[i + bit]
            if nxt <= 0 and -nxt == leaf:
                return path + [(i, bit)]
            if nxt > 0:
                found = walk(2 * nxt, path + [(i, bit)])
                if found:
                    return found
        return None
    return walk(0, [])


def _put_coeffs(bw, probs, ctx, levels, first):
    """Tokens of one block (``levels`` in zigzag order) -> the decoder's
    return value (the position after the last non-zero, or ``first``)."""
    nz = [n for n in range(first, 16) if levels[n]]
    last = nz[-1] if nz else -1
    p = probs[_BANDS[first]][ctx]
    if last < 0:
        bw.put(0, p[0])
        return first
    n = first
    while True:
        bw.put(1, p[0])
        while levels[n] == 0:
            bw.put(0, p[1])
            n += 1
            p = probs[_BANDS[n]][0]
        bw.put(1, p[1])
        v = abs(int(levels[n]))
        if v == 1:
            bw.put(0, p[2])
            nctx = 1
        else:
            bw.put(1, p[2])
            if v <= 4:
                bw.put(0, p[3])
                bw.put(v > 2, p[4])
                if v > 2:
                    bw.put(v - 3, p[5])
            elif v <= 10:
                bw.put(1, p[3])
                bw.put(0, p[6])
                bw.put(v > 6, p[7])
                if v <= 6:
                    bw.put(v - 5, 159)
                else:
                    bw.put((v - 7) >> 1, 165)
                    bw.put((v - 7) & 1, 145)
            else:
                bw.put(1, p[3])
                bw.put(1, p[6])
                cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                bw.put(cat >> 1, p[8])
                bw.put(cat & 1, p[9 + (cat >> 1)])
                extra = v - (3 + (8 << cat))
                tab = _CAT[cat]
                for k, prob in enumerate(tab):
                    bw.put((extra >> (len(tab) - 1 - k)) & 1, prob)
            nctx = 2
        bw.put(levels[n] < 0, 128)
        n += 1
        if n == 16:
            return 16
        p = probs[_BANDS[n]][nctx]
        if n > last:
            bw.put(0, p[0])
            return n


def vp8_frame(width: int, height: int, seed: int = 0, q: int = 40, simple: bool = False,
              level: int = 40, sharpness: int = 0, segments: int = 0, absolute: bool = True,
              lf_deltas=None, partitions: int = 0, skip_prob: int = 0, b_pred: float = 0.5,
              big: float = 0.02, big_max: int = 150, coeff: float = 0.3,
              quant_deltas=(0, 0, 0, 0, 0), update_probs: float = 0.0) -> bytes:
    """A VP8 key frame (a ``VP8 `` chunk's payload) with random modes and
    coefficients.  ``segments`` 0: none, else a segment map with quantiser
    and filter values per segment (``absolute`` or relative); ``lf_deltas``
    (ref, mode) adds the reference and mode loop filter deltas;
    ``partitions`` is log2 of the token partitions; ``skip_prob`` 0: no
    skip flags; ``b_pred`` the share of 4x4-predicted macroblocks; ``big``
    the share of large coefficients (11 to ``big_max``: keep them times the
    quantiser within libwebp's [-2048, 2047]); ``coeff`` the share of
    non-zero ones."""
    rng = np.random.default_rng(seed)
    proba0 = _table("kCoeffsProba0", (4, 8, 3, 11))
    update = _table("kCoeffsUpdateProba", (4, 8, 3, 11))
    bmodes = _table("kBModesProba", (10, 10, 9))
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    hdr = _BoolWriter()
    hdr.put(0, 128)  # colour space
    hdr.put(0, 128)  # clamping type
    hdr.put(segments > 0, 128)
    seg_probs = (255, 255, 255)
    if segments:
        hdr.put(1, 128)  # update map
        hdr.put(1, 128)  # update data
        hdr.put(int(absolute), 128)
        for s in range(4):
            v = int(rng.integers(0, 100)) if absolute else int(rng.integers(-20, 21))
            hdr.put(1, 128)
            hdr.signed(v, 7)
        for s in range(4):
            v = int(rng.integers(0, 64)) if absolute else int(rng.integers(-20, 21))
            hdr.put(s != 3, 128)
            if s != 3:
                hdr.signed(v, 6)
        seg_probs = tuple(int(v) for v in rng.integers(1, 256, 3))
        for p in seg_probs:
            hdr.put(1, 128)
            hdr.value(p, 8)
    hdr.put(int(simple), 128)
    hdr.value(level, 6)
    hdr.value(sharpness, 3)
    hdr.put(lf_deltas is not None, 128)
    if lf_deltas is not None:
        hdr.put(1, 128)
        for group in lf_deltas:
            for v in group:
                hdr.put(v is not None, 128)
                if v is not None:
                    hdr.signed(v, 6)
    hdr.value(partitions, 2)
    hdr.value(q, 7)
    for d in quant_deltas:
        hdr.put(d != 0, 128)
        if d:
            hdr.signed(d, 4)
    hdr.put(0, 128)  # refresh entropy probs
    probs = proba0.copy()
    for idx in np.ndindex(4, 8, 3, 11):
        if rng.random() < update_probs:
            hdr.put(1, int(update[idx]))
            probs[idx] = int(rng.integers(1, 256))
            hdr.value(int(probs[idx]), 8)
        else:
            hdr.put(0, int(update[idx]))
    hdr.put(skip_prob > 0, 128)
    if skip_prob:
        hdr.value(skip_prob, 8)
    parts = [_BoolWriter() for _ in range(1 << partitions)]
    intra_t = [0] * (4 * mb_w)
    t_nz = [[0] * 4 for _ in range(mb_w)]
    t_uv = [[0] * 4 for _ in range(mb_w)]  # u0 u1 v0 v1 columns
    t_dc = [0] * mb_w
    tree_paths = {m: _tree_path(_BMODE_TREE, m) for m in range(10)}
    for mb_y in range(mb_h):
        intra_l = [0] * 4
        l_nz, l_uv, l_dc = [0] * 4, [0] * 4, 0
        tbw = parts[mb_y % len(parts)]
        for mb_x in range(mb_w):
            seg = int(rng.integers(0, 4)) if segments else 0
            if segments:
                hdr.put(seg >= 2, seg_probs[0])
                hdr.put(seg & 1, seg_probs[1 + (seg >> 1)])
            skip = bool(skip_prob and rng.random() < 0.3)
            if skip_prob:
                hdr.put(int(skip), skip_prob)
            i4 = rng.random() < b_pred
            hdr.put(0 if i4 else 1, 145)
            if not i4:
                ymode = int(rng.integers(0, 4))  # DC, TM, V, H as libwebp numbers them
                if ymode in (1, 3):
                    hdr.put(1, 156)
                    hdr.put(ymode == 1, 128)
                else:
                    hdr.put(0, 156)
                    hdr.put(ymode == 2, 163)
                intra_t[4 * mb_x : 4 * mb_x + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    left = intra_l[y]
                    for x in range(4):
                        m = int(rng.integers(0, 10))
                        prob = bmodes[intra_t[4 * mb_x + x], left]
                        for i, bit in tree_paths[m]:
                            hdr.put(bit, int(prob[i // 2]))  # node i reads prob[i / 2]
                        intra_t[4 * mb_x + x] = m
                        left = m
                    intra_l[y] = left
            uv = int(rng.integers(0, 4))
            hdr.put(uv != 0, 142)
            if uv:
                hdr.put(uv != 2, 114)
                if uv != 2:
                    hdr.put(uv == 1, 183)
            if skip:
                t_nz[mb_x], t_uv[mb_x], l_nz, l_uv = [0] * 4, [0] * 4, [0] * 4, [0] * 4
                if not i4:
                    t_dc[mb_x] = l_dc = 0
                continue

            def levels(first=0):
                lv = np.zeros(16, np.int64)
                for n in range(first, 16):
                    if rng.random() < coeff * (1.0 if n < 4 else 0.3):
                        v = int(rng.integers(1, 4))
                        if rng.random() < big and big_max > 11:
                            v = int(rng.integers(11, big_max))
                        lv[n] = -v if rng.random() < 0.5 else v
                return lv

            first = 0
            if not i4:
                r = _put_coeffs(tbw, probs[1], t_dc[mb_x] + l_dc, levels(), 0)
                t_dc[mb_x] = l_dc = int(r > 0)
                first = 1
            ytype = probs[0] if not i4 else probs[3]
            for y in range(4):
                for x in range(4):
                    r = _put_coeffs(tbw, ytype, t_nz[mb_x][x] + l_nz[y], levels(first), first)
                    t_nz[mb_x][x] = l_nz[y] = int(r > first)
            for ch in (0, 2):
                for y in range(2):
                    for x in range(2):
                        r = _put_coeffs(tbw, probs[2], t_uv[mb_x][ch + x] + l_uv[ch + y],
                                        levels(), 0)
                        t_uv[mb_x][ch + x] = l_uv[ch + y] = int(r > 0)
    first_part = hdr.data()
    tokens = [p.data() for p in parts]
    tag = (0 | (0 << 1) | (1 << 4) | (len(first_part) << 5)).to_bytes(3, "little")
    out = tag + b"\x9d\x01\x2a" + struct.pack("<HH", width, height) + first_part
    for t in tokens[:-1]:
        out += len(t).to_bytes(3, "little")
    return out + b"".join(tokens)



# --- the fixtures -----------------------------------------------------------------------

def _image(rng, h: int, w: int) -> np.ndarray:
    """A smooth gradient with dark strokes and noise: something for every
    predictor, filter and palette to do."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                    ((xx + yy) * 7) % 256], axis=2).astype(np.int16)
    for _ in range(4):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0 : y0 + 5, x0 : x0 + 2] = rng.integers(0, 60, 3)
    return np.clip(img + rng.integers(-6, 7, img.shape), 0, 255).astype(np.uint8)


def _pil(img, fmt: str, **kw) -> bytes:
    from PIL import Image

    bio = io.BytesIO()
    if isinstance(img, (list, tuple)):
        frames = [Image.fromarray(f) for f in img]
        frames[0].save(bio, format=fmt, save_all=True, append_images=frames[1:], **kw)
    else:
        Image.fromarray(img).save(bio, format=fmt, **kw)
    return bio.getvalue()


def webp_fixtures(rng) -> dict:
    import cv2

    files = {}
    img = _image(rng, 23, 37)
    bgr = img[:, :, ::-1]
    for q in (5, 50, 95):
        files[f"cv2_lossy_q{q}_23x37.webp"] = cv2.imencode(".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, q])[1].tobytes()
    files["cv2_lossless_23x37.webp"] = cv2.imencode(".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes()
    for m in (0, 6):
        files[f"pil_lossy_m{m}_23x37.webp"] = _pil(img, "WEBP", quality=75, method=m)
    files["pil_lossless_m6_23x37.webp"] = _pil(img, "WEBP", lossless=True, method=6, quality=100)
    files["pil_lossy_1x1.webp"] = _pil(img[:1, :1], "WEBP", quality=80)
    files["pil_lossless_1x1.webp"] = _pil(img[:1, :1], "WEBP", lossless=True)
    files["pil_lossy_odd_5x3.webp"] = _pil(img[:5, :3], "WEBP", quality=60)
    rgba = np.dstack([img, rng.integers(0, 256, img.shape[:2]).astype(np.uint8)])
    rgba[:8, :, 3] = 0  # colour under alpha 0 comes out as coded
    files["pil_alpha_lossy_23x37.webp"] = _pil(rgba, "WEBP", quality=70, exact=True)
    files["pil_alpha_lossless_23x37.webp"] = _pil(rgba, "WEBP", lossless=True, exact=True)
    frames = [_image(rng, 16, 20) for _ in range(3)]
    files["pil_anim_lossy_16x20.webp"] = _pil(frames, "WEBP", quality=60, duration=100, loop=0)
    files["pil_anim_lossless_16x20.webp"] = _pil(frames, "WEBP", lossless=True, duration=100)
    # VP8 key frames no encoder here writes
    vp8 = {"vp8_segments_rel_lfdelta_sharp3_2parts_33x47": dict(
               segments=1, absolute=False, sharpness=3, partitions=1, level=36,
               lf_deltas=((6, -2, None, 4), (-8, 3, None, 5))),
           "vp8_segments_abs_normal_40x24": dict(segments=1, absolute=True, level=20),
           "vp8_simple_sharp5_31x18": dict(simple=True, sharpness=5, level=50),
           "vp8_8parts_skip_57x35": dict(partitions=3, skip_prob=90),
           "vp8_bigcoeffs_probupdate_17x29": dict(q=1, big=0.2, big_max=250, update_probs=0.08),
           "vp8_level0_segments_21x21": dict(level=0, segments=1),
           "vp8_bpred_edges_quantdeltas_35x19": dict(b_pred=1.0, quant_deltas=(2, -3, 5, -4, 7)),
           "vp8_i16_only_high_level_50x34": dict(b_pred=0.0, level=63, sharpness=1)}
    for k, (name, kw) in enumerate(vp8.items()):
        w, h = (int(v) for v in name.rsplit("_", 1)[1].split("x"))
        files[f"hand_{name}.webp"] = riff(chunk(b"VP8 ", vp8_frame(w, h, seed=100 + k, **kw)))
    # VP8L streams
    pal = (0xFF000000 | rng.integers(0, 1 << 24, 16)).astype(np.int64)
    pal[3] &= 0x00FFFFFF  # a colour with alpha 0
    small = pal[rng.integers(0, 12, (19, 27))]
    photo = (img[:, :, 0].astype(np.int64) << 16 | img[:, :, 1].astype(np.int64) << 8
             | img[:, :, 2] | (0xFF << 24))
    files["hand_vp8l_all_transforms_19x27.webp"] = riff(chunk(b"VP8L", vp8l_bytes(
        small, [("index",), ("predict", 2), ("color", 2), ("green",)], seed=1)))
    files["hand_vp8l_predict_16_modes_cache_lz77_23x37.webp"] = riff(chunk(b"VP8L", vp8l_bytes(
        photo, [("green",), ("predict", 2), ("color", 3)], cache_bits=6, lz77=True, seed=2)))
    files["hand_vp8l_meta_groups_lz77_23x37.webp"] = riff(chunk(b"VP8L", vp8l_bytes(
        photo, [("predict", 3)], meta_bits=2, lz77=True, cache_bits=2, seed=3)))
    for n, bits in ((2, 3), (4, 2), (16, 1)):
        files[f"hand_vp8l_bundle{bits}_{n}colors_13x21.webp"] = riff(chunk(b"VP8L", vp8l_bytes(
            pal[np.arange(13 * 21).reshape(13, 21) * 7 % n], [("index",)], seed=4 + bits)))
    # containers
    lossless_frame = vp8l_bytes(small, [("index",)], seed=8)
    files["hand_anim_offset_vp8l_19x27_in_40x30.webp"] = riff(
        vp8x(40, 30, 0x12), chunk(b"ANIM", bytes(6)),
        anmf(4, 2, 27, 19, chunk(b"VP8L", lossless_frame)),
        anmf(0, 0, 27, 19, chunk(b"VP8L", lossless_frame)))
    frame = vp8_frame(17, 13, seed=9, segments=1)
    alpha = vp8l_bytes((0xFF000000 | (rng.integers(0, 256, (13, 17)) << 8)).astype(np.int64),
                       [("predict", 2)], header=False, seed=10)
    files["hand_anim_offset_vp8_alpha_17x13_in_30x20.webp"] = riff(
        vp8x(30, 20, 0x12), chunk(b"ANIM", bytes(6)),
        anmf(6, 4, 17, 13, chunk(b"ALPH", b"\x01" + alpha) + chunk(b"VP8 ", frame)))
    for filt in (1, 2, 3):
        files[f"hand_alph_raw_filter{filt}_17x13.webp"] = riff(
            vp8x(17, 13, 0x10), chunk(b"ALPH", bytes([filt << 2]) + bytes(
                rng.integers(0, 256, 17 * 13).astype(np.uint8))), chunk(b"VP8 ", frame))
    files["hand_alph_vp8l_preprocessed_17x13.webp"] = riff(
        vp8x(17, 13, 0x10), chunk(b"ALPH", bytes([0x01 | (2 << 2) | (1 << 4)]) + alpha),
        chunk(b"VP8 ", frame))
    files["hand_vp8x_metadata_19x27.webp"] = riff(
        vp8x(27, 19, 0x2C), chunk(b"ICCP", b"not a real profile"), chunk(b"ZZZZ", b"unknown"),
        chunk(b"VP8L", lossless_frame), chunk(b"EXIF", b"II*\x00"), chunk(b"XMP ", b"<x/>"))
    from tests.torch_port_data.make_bmp_fixtures import _line

    for k in range(2):  # text lines for the card's daemon phase
        line = _line(rng)
        files[f"webp_line_{k}.webp"] = cv2.imencode(".webp", line[:, :, ::-1],
                                                    [cv2.IMWRITE_WEBP_QUALITY, 90])[1].tobytes()
        line = _line(rng)
        a = np.full(line.shape[:2], 255, np.uint8)
        a[:, : line.shape[1] // 5] = 0  # a transparent margin, its colour kept
        files[f"webpa_line_{k}.webp"] = _pil(np.dstack([line, a]), "WEBP", lossless=True,
                                            exact=True)
    return files


def gif_fixtures(rng) -> dict:
    import cv2

    files = {}
    img = _image(rng, 21, 33)
    for n in (2, 16, 256):
        from PIL import Image

        files[f"pil_{n}colors_21x33.gif"] = _save_p(Image.fromarray(img).quantize(colors=n))
    files["pil_interlaced_21x33.gif"] = _pil(img, "GIF", interlace=True)
    files["cv2_21x33.gif"] = cv2.imencode(".gif", img[:, :, ::-1])[1].tobytes()
    frames = [_image(rng, 14, 18) for _ in range(3)]
    files["pil_anim_14x18.gif"] = _pil(frames, "GIF", duration=80, loop=0, disposal=2)
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (9, 13))
    files["hand_offset_transparent_9x13_in_20x16.gif"] = gif_bytes(
        [dict(idx=idx, left=5, top=4, transparent=3, mcs=4)], (20, 16), pal, bg=7)
    files["hand_local_table_interlaced_19x13.gif"] = gif_bytes(
        [dict(idx=rng.integers(0, 8, (19, 13)), lpal=rng.integers(0, 256, (8, 3)),
              interlace=True, mcs=3)], (13, 19), pal, bg=2)
    files["hand_short_local_table_falls_back_9x13.gif"] = gif_bytes(
        [dict(idx=idx, lpal=rng.integers(0, 256, (4, 3)), mcs=4)], (13, 9), pal)
    files["hand_no_global_local_offset_transparent_9x13_in_15x12.gif"] = gif_bytes(
        [dict(idx=idx, left=1, top=2, lpal=pal, transparent=5, mcs=4)], (15, 12), None)
    files["hand_no_tables_9x13.gif"] = gif_bytes([dict(idx=idx, mcs=4)], (13, 9), None)
    big = rng.integers(0, 256, (70, 80))
    pal256 = rng.integers(0, 256, (256, 3))
    files["hand_deferred_clear_70x80.gif"] = gif_bytes(
        [dict(idx=big, lzw=dict(defer=True))], (80, 70), pal256)
    files["hand_full_table_clear_70x80.gif"] = gif_bytes([dict(idx=big)], (80, 70), pal256)
    files["hand_eoi_midstream_no_initial_clear_9x13.gif"] = gif_bytes(
        [dict(idx=idx, mcs=4, lzw=dict(eoi_at=20, initial_clear=False))], (13, 9), pal)
    files["hand_clear_every_7_block1_mcs2_9x13.gif"] = gif_bytes(
        [dict(idx=idx % 4, mcs=2, block=1, lzw=dict(clear_every=7))], (13, 9), pal[:4])
    files["hand_87a_two_gce_comment_9x13.gif"] = gif_bytes(
        [dict(idx=idx, mcs=4, transparent=1, extensions=[
            b"\x21\xfe\x05hello\x00", b"\x21\xf9\x04\x01\x00\x00\x06\x00"]),
         dict(idx=idx[:3, :3], mcs=4)], (13, 9), pal, bg=9, version=b"GIF87a", loop=True)
    from tests.torch_port_data.make_bmp_fixtures import _line, _quantize

    for k in range(2):  # interlaced lines with a transparent index (the ground)
        q, gray = _quantize(_line(rng), 16)
        ground = int(np.bincount(q.reshape(-1)).argmax())
        files[f"gif_line_{k}.gif"] = gif_bytes(
            [dict(idx=q, interlace=True, transparent=ground, mcs=4)], (q.shape[1], q.shape[0]),
            gray, bg=ground)
    return files


def _save_p(p) -> bytes:
    bio = io.BytesIO()
    p.save(bio, format="GIF")
    return bio.getvalue()


def pnm_fixtures(rng) -> dict:
    import cv2

    files = {}
    h, w = 7, 11
    bits = rng.integers(0, 2, (h, w))
    files["p1_spaced_comments_7x11.pbm"] = pnm_bytes(bits, 1, comment=b"# a comment\n")
    files["p1_packed_digits_7x11.pbm"] = pnm_bytes(bits, 1, packed=True)
    files["p4_7x11.pbm"] = pnm_bytes(bits, 4)
    for maxval in (15, 100, 255, 1000, 65535):
        gray = rng.integers(0, maxval + 1, (h, w))
        files[f"p2_maxval{maxval}_7x11.pgm"] = pnm_bytes(gray, 2, maxval, sep=b"  ",
                                                        row_sep=b"\r\n", comment=b"#x\r")
        files[f"p5_maxval{maxval}_7x11.pgm"] = pnm_bytes(np.minimum(gray, 255) if maxval < 256
                                                        else gray, 5, maxval)
        rgb = rng.integers(0, maxval + 1, (h, w, 3))
        files[f"p3_maxval{maxval}_7x11.ppm"] = pnm_bytes(rgb, 3, maxval, sep=b"\t")
        files[f"p6_maxval{maxval}_7x11.ppm"] = pnm_bytes(np.minimum(rgb, 255) if maxval < 256
                                                        else rgb, 6, maxval)
    files["p5_over_maxval_raw_7x11.pgm"] = pnm_bytes(rng.integers(0, 256, (h, w)), 5, 100)
    files["p2_over_maxval_clamped_7x11.pgm"] = pnm_bytes(rng.integers(0, 40, (h, w)), 2, 15)
    files["p7_gray_7x11.pam"] = pam_bytes(rng.integers(0, 256, (h, w, 1)))
    files["p7_rgb_16bit_7x11.pam"] = pam_bytes(rng.integers(0, 65536, (h, w, 3)), 65535, b"RGB")
    files["p7_blackandwhite_7x11.pam"] = pam_bytes(rng.integers(0, 2, (h, w, 1)), 1,
                                                   b"BLACKANDWHITE")
    files["p7_inferred_rgb_comments_7x11.pam"] = pam_bytes(
        rng.integers(0, 100, (h, w, 3)), 99, b"", extra=b"# a comment\n\nTUPLTYPE\n")
    files["p7_two_tupltypes_7x11.pam"] = pam_bytes(rng.integers(0, 256, (h, w, 3)), 255,
                                                   b"GRAYSCALE", extra=b"TUPLTYPE RGB\n")
    img = _image(rng, 13, 17)
    for ext in (".pbm", ".pgm", ".ppm", ".pam"):
        src = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if ext in (".pbm", ".pgm") else img[:, :, ::-1]
        for binary in (1, 0) if ext != ".pam" else (1,):
            files[f"cv2_{'bin' if binary else 'ascii'}_13x17{ext}"] = cv2.imencode(
                ext, src, [cv2.IMWRITE_PXM_BINARY, binary])[1].tobytes()
    from tests.torch_port_data.make_bmp_fixtures import _line

    for k in range(2):  # binary PGM lines for the card's daemon phase
        gray = _line(rng).mean(axis=2).astype(np.uint8)
        files[f"pgm_line_{k}.pgm"] = pnm_bytes(gray, 5, 255)
    return files


def application_extension(ident: bytes, blocks) -> bytes:
    """A GIF application extension: the identifier sub-block, then
    ``blocks`` as data sub-blocks."""
    return (b"\x21\xff" + bytes([len(ident)]) + ident
            + b"".join(bytes([len(b)]) + b for b in blocks) + b"\x00")


def gif_app_fixtures() -> dict:
    """GIFs with application extensions that OpenCV's frame count walks
    through (their own seed, so the other fixtures keep their bytes): XMP
    and an ICC profile of even sub-blocks, a NETSCAPE loop of any bytes,
    and a 3-byte sub-block of another application whose one-byte-short read
    happens to land on the extension's end."""
    rng = np.random.default_rng(20261019)
    idx = rng.integers(0, 8, (7, 10))
    pal = rng.integers(0, 256, (8, 3))
    frame = dict(idx=idx, mcs=3)
    exts = {
        "app_xmp_icc": [application_extension(b"XMP DataXMP", [b"<x:xmpmeta/>", b"ab"]),
                        application_extension(b"ICCRGBG1012", [bytes(255), bytes(20)])],
        "app_netscape_any_loop": [application_extension(b"NETSCAPE2.0", [b"ABC", b"xy"])],
        "app_three_resyncs": [application_extension(b"ANIMEXTS1.0",
                                                    [b"\x05\x06\x02", b"\x00"])],
    }
    return {f"{name}_10x7.gif": gif_bytes([dict(frame, extensions=e)], (10, 7), pal)
            for name, e in exts.items()}


def webp_exif_fixtures() -> dict:
    """WebP files with an EXIF chunk (their own seed, so the other
    fixtures keep their bytes)."""
    from tests.torch_port_data.make_bmp_fixtures import _line
    from tests.torch_port_data.make_png_fixtures import exif_tiff, unturned

    rng = np.random.default_rng(20261019)
    h, w = 13, 21
    px = rng.integers(0, 1 << 24, (h, w)).astype(np.int64) | (0xFF << 24)
    lossless = chunk(b"VP8L", vp8l_bytes(px.astype(np.uint32), seed=1))
    lossy = chunk(b"VP8 ", vp8_frame(w, h, seed=2))
    files = {}
    for o in range(1, 9):
        order = "MM" if o % 2 else "II"
        x = chunk(b"EXIF", exif_tiff(o, order))
        files[f"exif{o}_{order.lower()}_vp8l_13x21.webp"] = riff(vp8x(w, h, 0x08), lossless, x)
        files[f"exif{o}_{order.lower()}_before_vp8_13x21.webp"] = riff(vp8x(w, h, 0x08), x, lossy)
    x6, x3 = chunk(b"EXIF", exif_tiff(6)), chunk(b"EXIF", exif_tiff(3, "II"))
    files["exif6_no_flag_13x21.webp"] = riff(vp8x(w, h, 0), lossless, x6)
    files["exif6_prefixed_13x21.webp"] = riff(vp8x(w, h, 0x08), lossless, chunk(
        b"EXIF", exif_tiff(6, prefix=b"Exif\x00\x00")))
    files["exif6_then_exif3_13x21.webp"] = riff(vp8x(w, h, 0x08), lossless, x6, x3)
    files["exif6_after_junk_13x21.webp"] = riff(vp8x(w, h, 0x08), lossless, b"\x01\x02", x6)
    files["exif6_anim_13x21.webp"] = riff(vp8x(w + 4, h + 2, 0x08 | 0x02),
                                          chunk(b"ANIM", bytes(6)), anmf(2, 2, w, h, lossless),
                                          x6)
    line = _line(rng)
    argb = unturned(line, 6).astype(np.int64)
    argb = (0xFF << 24) | argb[:, :, 0] << 16 | argb[:, :, 1] << 8 | argb[:, :, 2]
    lh, lw = argb.shape
    files["webpo_line_0.webp"] = riff(vp8x(lw, lh, 0x08),
                                      chunk(b"VP8L", vp8l_bytes(argb.astype(np.uint32), seed=3)),
                                      x6)
    return files


def main() -> None:
    import sys

    import cv2

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # for tests.torch_port_data
    rng = np.random.default_rng(20261017)
    webp = lambda rng: {**webp_fixtures(rng), **webp_exif_fixtures()}  # noqa: E731
    gif = lambda rng: {**gif_fixtures(rng), **gif_app_fixtures()}  # noqa: E731
    for folder, make in (("webp", webp), ("gif", gif), ("pnm", pnm_fixtures)):
        out = os.path.join(HERE, folder)
        os.makedirs(out, exist_ok=True)
        expected = {}
        for name, data in make(rng).items():
            with open(os.path.join(out, name), "wb") as f:
                f.write(data)
            bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            assert bgr is not None, name
            expected[name] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        np.savez_compressed(os.path.join(out, "expected.npz"), **expected)
        total = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        print(f"wrote {len(expected)} files and expected.npz into {out}: {total} bytes")


if __name__ == "__main__":
    main()
