"""Write the JPEG 2000 fixtures the port's decoder is held to on the card.

    python tests/torch_port_data/make_jp2_fixtures.py

Needs cv2 and PIL, and PIL's bundled OpenJPEG (``pillow.libs/libopenjp2-*.so*``,
driven through ctypes by :func:`opj_encode` for what PIL's writer does not
reach); the card's script reads only the files.  Writes into
``tests/torch_port_data/jp2/``:

* ``pil_*``: PIL's writer (OpenJPEG underneath): modes L, LA, RGB, RGBA and
  I;16, reversible and irreversible, with and without the colour
  transform, 1 to 6 resolutions, code-block and precinct sizes, the five
  progression orders, tiles, quality layers in rates and in dB, raw
  codestreams (``.j2k``), PLT markers and a comment;
* ``cv2_*``: cv2's own writer, lossless and lossy;
* ``opj_*``: OpenJPEG through ctypes: every code-block style bit alone
  (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM) and all together, SOP and
  EPH markers, progression order changes (POC), a region of interest
  (RGN), tile-parts split by resolution, layer and component, TLM and
  PLT markers, precisions 9, 10, 12 and 16, sYCC, and packet headers
  moved into PPM and PPT markers (:func:`pack_headers`);
* ``box_*``: JP2 boxes written here (:func:`jp2_file`) around OpenJPEG's
  codestreams: palettes (``pclr`` + ``cmap``, 8- and 16-bit), channel definitions that
  swap colours or mark an alpha, an ICC and an unknown colour space, a
  header box placed after ``jp2h``, an XL box;
* ``jp2_line_N.jp2`` (lossless RGB JP2) and ``j2k_line_N.j2k``
  (irreversible raw codestream): text lines for the card's daemon phase;
* ``expected.npz``: cv2's RGB pixels (``cv2.imdecode(IMREAD_COLOR)`` then
  BGR -> RGB) of every file, keyed by file name.

Everything is seeded, so a rerun writes the same bytes with the same cv2,
PIL and OpenJPEG.  OpenJPEG's encoder aborts the process (an assertion)
on a tile too small for its resolution count: every call here keeps the
count at most log2 of the smallest tile side, edge tiles counted, plus 1.
"""

from __future__ import annotations

import ctypes
import glob
import io
import os
import struct
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# --- OpenJPEG's encoder through ctypes ---------------------------------------------------

# opj_cparameters_t (OpenJPEG 2.5, x86-64): the byte offsets of the fields set here
_PARAMS_SIZE = 18720
_POC_SIZE = 148
_OFF = dict(tile_size_on=0, cp_tx0=4, cp_ty0=8, cp_tdx=12, cp_tdy=16, cp_disto_alloc=20,
            csty=48, prog_order=52, POC=56, numpocs=4792, tcp_numlayers=4796, tcp_rates=4800,
            numresolution=5600, cblockw_init=5604, cblockh_init=5608, mode=5612,
            irreversible=5616, roi_compno=5620, roi_shift=5624, res_spec=5628, prcw_init=5632,
            prch_init=5764, image_offset_x0=18188, image_offset_y0=18192, tp_on=18696,
            tp_flag=18697, tcp_mct=18698)
PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
# code-block style bits
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32


class _CmptParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _ImageComp(ctypes.Structure):
    _fields_ = [*[(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp",
                                                  "sgnd", "resno_decoded", "factor")],
                ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class _Image(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32), ("x1", ctypes.c_uint32),
                ("y1", ctypes.c_uint32), ("numcomps", ctypes.c_uint32),
                ("color_space", ctypes.c_int), ("comps", ctypes.POINTER(_ImageComp)),
                ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", ctypes.c_uint32)]


_LIB = None


def _openjpeg():
    global _LIB
    if _LIB is None:
        import PIL

        found = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                       "pillow.libs", "libopenjp2*.so*"))
        if not found:
            raise RuntimeError("PIL's bundled libopenjp2 was not found")
        lib = ctypes.CDLL(found[0])
        lib.opj_image_create.restype = ctypes.POINTER(_Image)
        lib.opj_image_create.argtypes = [ctypes.c_uint32, ctypes.POINTER(_CmptParm), ctypes.c_int]
        lib.opj_create_compress.restype = ctypes.c_void_p
        lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
        lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
        for fn in ("opj_setup_encoder", "opj_start_compress"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        for fn in ("opj_encode", "opj_end_compress"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.opj_encoder_set_extra_options.argtypes = [ctypes.c_void_p,
                                                      ctypes.POINTER(ctypes.c_char_p)]
        for fn in ("opj_stream_destroy", "opj_destroy_codec"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]
        _LIB = lib
    return _LIB


def _set(buf, name: str, value, fmt: str = "<i", index: int = 0) -> None:
    struct.pack_into(fmt, buf, _OFF[name] + index * struct.calcsize(fmt), value)


def opj_encode(planes, prec=8, sgnd=0, subsampling=None, offset=(0, 0), jp2=False,
               color_space=1, irreversible=False, mct=None, numres=6, cblk=(64, 64), mode=0,
               csty=0, progression="LRCP", pocs=(), rates=(0.0,), tiles=None,
               tile_offset=(0, 0), precincts=None, roi=None, tile_parts=None,
               extra=()) -> bytes:
    """Encode ``planes`` (one 2-D integer array a component, sized for its
    subsampling) with OpenJPEG, as a raw codestream or a JP2 file.

    ``mode`` is the code-block style, ``csty`` 2 for SOP and 4 for EPH,
    ``pocs`` tuples ``(resno0, compno0, layno1, resno1, compno1, order)``,
    ``rates`` one compression ratio a layer (0: lossless), ``precincts``
    ``(width, height)`` sizes from the highest resolution down, ``roi``
    ``(component, shift)``, ``tile_parts`` ``"R"``, ``"L"`` or ``"C"``,
    ``extra`` OpenJPEG's encoder options (``"PLT=YES"``, ``"TLM=YES"``)."""
    lib = _openjpeg()
    n = len(planes)
    subsampling = subsampling or [(1, 1)] * n
    h0, w0 = planes[0].shape
    x0, y0 = offset
    x1, y1 = x0 + (w0 - 1) * subsampling[0][0] + 1, y0 + (h0 - 1) * subsampling[0][1] + 1
    parms = (_CmptParm * n)()
    for i, plane in enumerate(planes):
        dx, dy = subsampling[i]
        parms[i].dx, parms[i].dy = dx, dy
        parms[i].w, parms[i].h = plane.shape[1], plane.shape[0]
        parms[i].x0, parms[i].y0 = -(-x0 // dx), -(-y0 // dy)
        parms[i].prec = parms[i].bpp = prec
        parms[i].sgnd = sgnd
    image = lib.opj_image_create(n, parms, color_space)
    img = image.contents
    img.x0, img.y0, img.x1, img.y1 = x0, y0, x1, y1
    for i, plane in enumerate(planes):
        flat = np.ascontiguousarray(plane, np.int32).reshape(-1)
        ctypes.memmove(img.comps[i].data, flat.ctypes.data, flat.nbytes)
    params = (ctypes.c_char * _PARAMS_SIZE)()
    lib.opj_set_default_encoder_parameters(params)
    _set(params, "tcp_numlayers", len(rates))
    for i, rate in enumerate(rates):
        _set(params, "tcp_rates", float(rate), "<f", i)
    _set(params, "cp_disto_alloc", 1)
    _set(params, "numresolution", numres)
    _set(params, "cblockw_init", cblk[0])
    _set(params, "cblockh_init", cblk[1])
    _set(params, "mode", mode)
    _set(params, "irreversible", int(irreversible))
    _set(params, "csty", csty | (1 if precincts else 0))
    _set(params, "prog_order", PROGRESSIONS[progression])
    _set(params, "tcp_mct", int((n >= 3) if mct is None else mct), "<b")
    _set(params, "image_offset_x0", x0)
    _set(params, "image_offset_y0", y0)
    if tiles:
        _set(params, "tile_size_on", 1)
        _set(params, "cp_tdx", tiles[0])
        _set(params, "cp_tdy", tiles[1])
        _set(params, "cp_tx0", tile_offset[0])
        _set(params, "cp_ty0", tile_offset[1])
    if precincts:
        _set(params, "res_spec", len(precincts))
        for i, (pw, ph) in enumerate(precincts):
            _set(params, "prcw_init", pw, "<i", i)
            _set(params, "prch_init", ph, "<i", i)
    if roi:
        _set(params, "roi_compno", roi[0])
        _set(params, "roi_shift", roi[1])
    if tile_parts:
        _set(params, "tp_on", 1, "<b")
        _set(params, "tp_flag", ord(tile_parts), "<b")
    if pocs:
        _set(params, "numpocs", len(pocs), "<I")
        for i, (r0, c0, l1, r1, c1, order) in enumerate(pocs):
            base = _OFF["POC"] + i * _POC_SIZE
            struct.pack_into("<8I", params, base, r0, c0, l1, r1, c1, 0, 0, 0)
            struct.pack_into("<ii", params, base + 32, PROGRESSIONS[order], PROGRESSIONS[order])
            struct.pack_into("<5s", params, base + 40, order.encode())
            struct.pack_into("<I", params, base + 48, 1)  # tile 1 (the first)
    codec = lib.opj_create_compress(2 if jp2 else 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.jp2" if jp2 else "out.j2k")
        try:
            if extra:
                opts = (ctypes.c_char_p * (len(extra) + 1))(*[e.encode() for e in extra], None)
                if not lib.opj_encoder_set_extra_options(codec, opts):
                    raise RuntimeError(f"OpenJPEG refused the options {extra}")
            if not lib.opj_setup_encoder(codec, params, image):
                raise RuntimeError("OpenJPEG refused the encoder parameters")
            stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
            try:
                ok = (lib.opj_start_compress(codec, image, stream)
                      and lib.opj_encode(codec, stream) and lib.opj_end_compress(codec, stream))
            finally:
                lib.opj_stream_destroy(stream)
            if not ok:
                raise RuntimeError("OpenJPEG failed to encode")
        finally:
            lib.opj_destroy_codec(codec)
            lib.opj_image_destroy(image)
        with open(path, "rb") as f:
            return f.read()


def pack_headers(stream: bytes, where: str) -> bytes:
    """A codestream written with SOP and EPH markers (one tile, one
    tile-part, one layer of packets) with its packet headers moved out of
    the tile data into a PPM marker of the main header (``where="PPM"``) or
    a PPT marker of the tile-part header (``"PPT"``), split into two
    markers to exercise their joining.  The SOP markers stay in the data;
    each header keeps its EPH.  Neither a header nor a body can hold the
    bytes FF91 or FF92, so the split is exact."""
    sot = stream.index(b"\xff\x90")
    end = sot + struct.unpack_from(">I", stream, sot + 6)[0]
    sod = stream.index(b"\xff\x93", sot)
    data = stream[sod + 2 : end]
    headers, bodies = [], []
    for packet in data.split(b"\xff\x91")[1:]:
        eph = packet.index(b"\xff\x92")
        headers.append(packet[4 : eph + 2])  # after Lsop (2) and Nsop (2)
        bodies.append(b"\xff\x91" + packet[:4] + packet[eph + 2 :])
    packed = b"".join(headers)
    half = len(packed) // 2
    body = b"".join(bodies)
    tile_header = stream[sot + 12 : sod]
    if where == "PPM":
        chunks = [struct.pack(">I", len(packed)) + packed[:half], packed[half:]]
        main = stream[:sot] + b"".join(
            b"\xff\x60" + struct.pack(">HB", 3 + len(c), z) + c for z, c in enumerate(chunks))
        tile = tile_header
    else:
        main = stream[:sot]
        tile = tile_header + b"".join(
            b"\xff\x61" + struct.pack(">HB", 3 + len(c), z) + c
            for z, c in ((1, packed[half:]), (0, packed[:half])))  # Zppt order, not stream order
    psot = 12 + len(tile) + 2 + len(body)
    return (main + stream[sot : sot + 6] + struct.pack(">I", psot) + stream[sot + 10 : sot + 12]
            + tile + b"\xff\x93" + body + stream[end:])


def box(kind: bytes, body: bytes, xl: bool = False) -> bytes:
    if xl:
        return struct.pack(">I4sII", 1, kind, 0, 16 + len(body)) + body
    return struct.pack(">I4s", 8 + len(body), kind) + body


def jp2_file(codestream: bytes, height: int, width: int, ncomps: int, colr: bytes = None,
             header=(), after_header=(), xl: bool = False) -> bytes:
    """A JP2 file around ``codestream``: the signature, ``ftyp``, a ``jp2h``
    of ``ihdr`` (8-bit), ``colr`` (default sRGB, or gray for one component)
    and the boxes in ``header``, the boxes in ``after_header``, then
    ``jp2c`` (an XL box with ``xl``)."""
    if colr is None:
        colr = b"\x01\x00\x00" + struct.pack(">I", 17 if ncomps < 3 else 16)
    ihdr = struct.pack(">IIHBBBB", height, width, ncomps, 7, 7, 0, 0)
    jp2h = box(b"ihdr", ihdr) + box(b"colr", colr) + b"".join(header)
    return (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
            + box(b"jp2h", jp2h) + b"".join(after_header) + box(b"jp2c", codestream, xl=xl))


def pclr(table: np.ndarray, bits) -> bytes:
    """A ``pclr`` box body: ``table`` ``[entries, columns]``, ``bits`` a column."""
    out = struct.pack(">HB", table.shape[0], table.shape[1]) + bytes(b - 1 for b in bits)
    for row in table:
        for v, b in zip(row, bits):
            out += int(v).to_bytes((b + 7) // 8, "big")
    return out


# --- the fixtures ------------------------------------------------------------------------

def _pil(img, mode=None, **kw) -> bytes:
    from PIL import Image

    bio = io.BytesIO()
    (Image.fromarray(img) if mode is None else Image.fromarray(img, mode)).save(
        bio, format="JPEG2000", **kw)
    return bio.getvalue()


def _image(rng, h: int, w: int, c: int = 3) -> np.ndarray:
    """A smooth gradient with dark strokes and noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                    ((xx + yy) * 7) % 256, (xx * yy) % 256][:c], axis=2).astype(np.int16)
    for _ in range(4):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0 : y0 + 5, x0 : x0 + 2] = rng.integers(0, 60, c)
    return np.clip(img + rng.integers(-6, 7, img.shape), 0, 255).astype(np.uint8)


def pil_fixtures(rng) -> dict:
    files = {}
    rgb = _image(rng, 37, 53)
    gray = rgb[:, :, 1]
    files["pil_L_37x53.jp2"] = _pil(gray)
    files["pil_LA_37x53.jp2"] = _pil(np.dstack([gray, rgb[:, :, 2]]), "LA")
    files["pil_RGB_37x53.jp2"] = _pil(rgb)
    files["pil_RGBA_37x53.jp2"] = _pil(_image(rng, 37, 53, 4), "RGBA")
    files["pil_I16_37x53.jp2"] = _pil((gray.astype(np.uint16) * 257
                                       + rng.integers(0, 256, gray.shape)).astype(np.uint16),
                                      "I;16")
    files["pil_RGB_irreversible_37x53.jp2"] = _pil(rgb, irreversible=True)
    files["pil_RGB_no_mct_37x53.jp2"] = _pil(rgb, mct=0)
    files["pil_RGB_irreversible_no_mct_37x53.jp2"] = _pil(rgb, irreversible=True, mct=0)
    for res in (1, 3, 6):
        files[f"pil_RGB_res{res}_37x53.jp2"] = _pil(rgb, num_resolutions=res, irreversible=res == 3)
    files["pil_RGB_cblk16x8_37x53.jp2"] = _pil(rgb, codeblock_size=(16, 8))
    big = _image(rng, 70, 90)
    files["pil_RGB_precinct32_cblk16_70x90.jp2"] = _pil(big, precinct_size=(32, 32),
                                                        codeblock_size=(16, 16))
    for order in PROGRESSIONS:  # each order over tiles, precincts and layers
        files[f"pil_RGB_{order}_tiles_precincts_layers_70x90.jp2"] = _pil(
            big, progression=order, tile_size=(32, 32), num_resolutions=3,
            precinct_size=(16, 16), codeblock_size=(8, 8), quality_mode="rates",
            quality_layers=[30, 10, 1], irreversible=order in ("RPCL", "CPRL"))
    files["pil_RGB_tiles_70x90.jp2"] = _pil(big, tile_size=(32, 32), num_resolutions=3)
    files["pil_RGB_layers_dB_70x90.jp2"] = _pil(big, quality_mode="dB",
                                                quality_layers=[25, 35, 45], irreversible=True)
    files["pil_RGB_layers_rates_70x90.jp2"] = _pil(big, quality_mode="rates",
                                                   quality_layers=[60, 20, 5])
    files["pil_RGB_codestream_37x53.j2k"] = _pil(rgb, no_jp2=True)
    files["pil_RGB_irreversible_codestream_37x53.j2k"] = _pil(rgb, no_jp2=True, irreversible=True)
    files["pil_RGB_plt_comment_37x53.jp2"] = _pil(rgb, plt=True, comment="a comment")
    return files


def cv2_fixtures(rng) -> dict:
    import cv2

    files = {}
    img = _image(rng, 64, 80)
    for x1000 in (1000, 250):
        files[f"cv2_x{x1000}_64x80.jp2"] = cv2.imencode(
            ".jp2", img[:, :, ::-1], [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000])[1].tobytes()
    return files


def opj_fixtures(rng) -> dict:
    files = {}
    img = _image(rng, 40, 48)
    rgb = [img[:, :, c] for c in range(3)]
    styles = {"bypass": BYPASS, "reset": RESET, "termall": TERMALL, "vsc": VSC, "pterm": PTERM,
              "segsym": SEGSYM, "all_styles": 63}
    for name, mode in styles.items():
        for irr in (False, True):
            files[f"opj_{name}_{'irr' if irr else 'rev'}_40x48.j2k"] = opj_encode(
                rgb, mode=mode, irreversible=irr, numres=4, cblk=(16, 16),
                rates=(20.0, 5.0, 0.0) if not irr else (20.0, 5.0))
    files["opj_sop_eph_40x48.j2k"] = opj_encode(rgb, csty=6, numres=3, rates=(10.0, 0.0))
    files["opj_poc_40x48.j2k"] = opj_encode(
        rgb, numres=3, rates=(10.0, 0.0), tiles=(48, 40),
        pocs=[(0, 0, 1, 2, 3, "RLCP"), (0, 0, 2, 3, 3, "CPRL")])
    files["opj_roi_40x48.j2k"] = opj_encode(rgb, roi=(0, 5), numres=3, irreversible=True)
    for tp in "RLC":
        files[f"opj_tile_parts_{tp}_40x48.j2k"] = opj_encode(
            rgb, tiles=(24, 20), numres=3, rates=(8.0, 0.0), tile_parts=tp)
    files["opj_tlm_plt_40x48.j2k"] = opj_encode(rgb, tiles=(24, 20), numres=3,
                                                extra=("PLT=YES", "TLM=YES"))
    gray = img[:, :, 1].astype(np.int32)
    files["opj_prec12_gray_40x48.jp2"] = opj_encode([gray * 16 + 7], prec=12, jp2=True,
                                                    color_space=2)
    files["opj_prec10_rgb_40x48.jp2"] = opj_encode([p.astype(np.int32) * 4 for p in rgb], prec=10,
                                                   jp2=True, irreversible=True)
    files["opj_prec9_rgb_40x48.j2k"] = opj_encode([p.astype(np.int32) * 2 + 1 for p in rgb],
                                                  prec=9)
    files["opj_prec16_irr_40x48.j2k"] = opj_encode([p.astype(np.int32) * 257 for p in rgb],
                                                   prec=16, irreversible=True, numres=4)
    files["opj_sycc_40x48.jp2"] = opj_encode(rgb, jp2=True, color_space=3, mct=0, numres=4)
    sop_eph = opj_encode(rgb, csty=6, numres=3)
    files["opj_ppm_40x48.j2k"] = pack_headers(sop_eph, "PPM")
    files["opj_ppt_40x48.j2k"] = pack_headers(sop_eph, "PPT")
    return files


def box_fixtures(rng) -> dict:
    files = {}
    h, w = 29, 41
    idx = rng.integers(0, 12, (h, w))
    index_stream = opj_encode([idx], numres=3)
    table = rng.integers(0, 256, (12, 3))
    cmap = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(3))
    files["box_palette_29x41.jp2"] = jp2_file(
        index_stream, h, w, 1, colr=b"\x01\x00\x00" + struct.pack(">I", 16),
        header=[box(b"pclr", pclr(table, (8, 8, 8))), box(b"cmap", cmap)])
    files["box_palette16_gray_29x41.jp2"] = jp2_file(
        index_stream, h, w, 1, colr=b"\x01\x00\x00" + struct.pack(">I", 17),
        header=[box(b"pclr", pclr(rng.integers(0, 65536, (12, 3)), (16, 16, 16))),
                box(b"cmap", cmap)])
    img = _image(rng, h, w)
    rgb_stream = opj_encode([img[:, :, c] for c in range(3)], numres=3)
    cdef = struct.pack(">H", 3) + b"".join(struct.pack(">HHH", cn, 0, asoc)
                                           for cn, asoc in ((0, 3), (1, 2), (2, 1)))
    files["box_cdef_swapped_29x41.jp2"] = jp2_file(rgb_stream, h, w, 3,
                                                   header=[box(b"cdef", cdef)])
    rgba_stream = opj_encode([img[:, :, c] for c in range(3)] + [idx * 20], numres=3, mct=1)
    cdef_alpha = struct.pack(">H", 4) + b"".join(struct.pack(">HHH", cn, typ, asoc) for cn, typ, asoc
                                                 in ((3, 1, 0), (0, 0, 1), (1, 0, 2), (2, 0, 3)))
    files["box_cdef_alpha_29x41.jp2"] = jp2_file(rgba_stream, h, w, 4,
                                                 header=[box(b"cdef", cdef_alpha)])
    files["box_icc_rgb_29x41.jp2"] = jp2_file(rgb_stream, h, w, 3,
                                              colr=b"\x02\x00\x00" + bytes(64))
    files["box_unknown_enumcs_29x41.jp2"] = jp2_file(
        rgb_stream, h, w, 3, colr=b"\x01\x00\x00" + struct.pack(">I", 20))
    files["box_two_colr_xl_jp2c_29x41.jp2"] = jp2_file(
        rgb_stream, h, w, 3, header=[box(b"colr", b"\x01\x00\x00" + struct.pack(">I", 17)),
                                     box(b"res ", bytes(18))],
        after_header=[box(b"xml ", b"<x/>", xl=True), box(b"colr", b"\x01\x00\x00" + bytes(4))],
        xl=True)
    return files


def many_layers() -> bytes:
    """A 64x64 gray JP2 of one layer of 8x8 precincts over six resolutions
    whose COD then says 65535 layers: OpenJPEG reads the first layer and
    finds the other 5.7 M packets empty."""
    img = np.random.default_rng(1).integers(0, 256, (64, 64))
    stream = bytearray(opj_encode([img], numres=6, precincts=[(8, 8)] * 6, cblk=(4, 4)))
    struct.pack_into(">H", stream, stream.index(b"\xff\x52") + 6, 65535)  # COD's layers
    return jp2_file(bytes(stream), 64, 64, 1, colr=b"\x01\x00\x00" + struct.pack(">I", 17))


def many_tiles() -> bytes:
    """A 255x257 gray JP2 of 1x1 tiles, 65535 (the most SIZ allows), of
    which only the first is sent: OpenJPEG leaves the others 0."""
    stream = bytearray(opj_encode([np.array([[200]])], numres=1))
    struct.pack_into(">II", stream, stream.index(b"\xff\x51") + 6, 255, 257)  # Xsiz, Ysiz
    return jp2_file(bytes(stream), 257, 255, 1, colr=b"\x01\x00\x00" + struct.pack(">I", 17))


def line_fixtures(rng) -> dict:
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # for tests.torch_port_data
    from tests.torch_port_data.make_bmp_fixtures import _line

    files = {}
    for k in range(2):  # text lines for the card's daemon phase
        files[f"jp2_line_{k}.jp2"] = _pil(_line(rng), num_resolutions=4)
        files[f"j2k_line_{k}.j2k"] = _pil(_line(rng), num_resolutions=4, irreversible=True,
                                          no_jp2=True, quality_mode="rates", quality_layers=[8])
    return files


def fixtures(rng) -> dict:
    files = {}
    for make in (pil_fixtures, cv2_fixtures, opj_fixtures, box_fixtures, line_fixtures):
        files.update(make(rng))
    files["opj_65535_layers_64x64.jp2"] = many_layers()
    return files


def main() -> None:
    import cv2

    out = os.path.join(HERE, "jp2")
    os.makedirs(out, exist_ok=True)
    expected = {}
    for name, data in fixtures(np.random.default_rng(20261019)).items():
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
