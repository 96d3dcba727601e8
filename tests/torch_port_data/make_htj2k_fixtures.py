"""Write the HTJ2K (JPEG 2000 Part 15) fixtures the port's decoder is held to.

    python tests/torch_port_data/make_htj2k_fixtures.py

Nothing in this container writes HTJ2K: cv2's writer has no parameter
for the code-block style, and PIL's bundled OpenJPEG 2.5.4 encoder, given
the HT style bit, copies it into COD over MQ-coded blocks, which cv2 gives
None on (the test's ``CV2_FAILS`` holds that stream).  So this script holds
an HT block encoder of its own, for fixtures only
(it is never part of the package), over the VLC tables the decoder
compiles (``rcnn_ocr_tpu_torch/csrc/host/ht_tables.inc``, read back
from cv2 by ``derive_ht_tables.py``):

* the cleanup pass (T.814 clause 7): the MagSgn stream read forward from
  the segment's start, the MEL and VLC streams read forward and backward
  from the segment's end (the last 12 bits hold Scup, their joint
  length), each with its bit-stuffing; the quad contexts, the u_off, e_k
  and e_1 choices the tables allow (a seeded choice among the valid
  codewords, so that every codeword is reached), the UVLC prefixes and
  suffixes of the first line pair and the others, the MEL events;
* the SigProp and MagRef passes one bit-plane below, sharing a second
  segment (SigProp forward, MagRef backward), in the scan order of
  OpenJPEG's decoder, whose membership rules this mirrors;
* a tier-2 writer (tag trees, pass counts, Lblock, segment lengths read
  as OpenJPEG's t2 reads HT code-blocks), tiles, precincts, layers,
  SOP/EPH, the LRCP and RLCP orders, the forward 5/3 (exact) and 9/7
  transforms and the RCT/ICT, and a CAP marker (Pcap bit 15) with the HT
  style (0x40) in COD or COC.

Families, all seeded: gray and RGB, lossless 5/3 and quantized 9/7, 1-6
resolutions, code-blocks from 4x4 to 64x64 and 1024x4, cleanup-only
blocks and blocks with SigProp + MagRef, quality layers, tiles,
precincts, SOP/EPH, a COC that gives one component HT blocks and leaves
the others Part 1, 16-bit samples, blocks with no significant sample
and blocks never included, and ``htj2k_line_0.jp2`` (a lossless text
line) with its PNG twin ``htj2k_line_0.png`` for the card's daemon
phase.  The ``ht_none_*`` files are streams cv2 gives ``None`` on (the
test holds the port to ``ValueError`` there).

Writes the files into ``tests/torch_port_data/jp2/`` and adds cv2's RGB
pixels of every decodable one to its ``expected.npz``; prints the
coverage: every (context, codeword) entry of both VLC tables and every
UVLC prefix (with the 5-bit suffix's top values, where Part 15 adds an
extension) reached by a fixture.
"""

from __future__ import annotations

import os
import re
import struct
import sys
from collections import Counter

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # for tests.torch_port_data

from tests.torch_port_data.make_jp2_fixtures import jp2_file  # noqa: E402

TABLES = os.path.join(HERE, "..", "..", "rcnn_ocr_tpu_torch", "csrc", "host", "ht_tables.inc")
OUT = os.path.join(HERE, "jp2")
MEL_E = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)  # T.814 Table 2
HT = 0x40


def vlc_tables():
    """The two decode tables, [2, 1024], from the committed file."""
    text = open(TABLES).read()
    out = []
    for name in ("kHtVlc0", "kHtVlc1"):
        start = text.index(f"{name}[1024]")
        body = text[start : text.index("};", start)]
        out.append([int(v, 16) for v in re.findall(r"0x[0-9a-f]{4}", body)])
    return out


def codebooks():
    """Per table, per context: ``[(codeword, length, entry)]``."""
    books = []
    for table in vlc_tables():
        per = [dict() for _ in range(8)]
        for i, v in enumerate(table):
            n = v & 7
            per[i >> 7][((i & 0x7F) & ((1 << n) - 1), n)] = v
        books.append([[(w, n, v) for (w, n), v in sorted(d.items())] for d in per])
    return books


BOOKS = codebooks()


class Coverage:
    """What the fixtures reach: VLC (table, context, codeword) entries and
    UVLC prefixes."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.vlc = Counter()
        self.uvlc = Counter()

    def missing(self):
        want = {(t, c, w, n) for t in range(2) for c in range(8) for w, n, _ in BOOKS[t][c]}
        gaps = sorted(want - set(self.vlc))
        prefixes = {"1", "01", "001", "000", "000+ext"} - set(self.uvlc)
        return gaps, sorted(prefixes)


COVER = Coverage()


# --- bit writers --------------------------------------------------------------------------

def forward_bytes(bits, pad: int) -> bytes:
    """MagSgn and SigProp: bits least significant first; a byte after 0xFF
    carries 7 (its MSB a stuffed 0); the last byte padded with ``pad``."""
    out, cur, used, cap = [], 0, 0, 8
    for b in bits:
        cur |= b << used
        used += 1
        if used == cap:
            out.append(cur)
            cap = 7 if cur == 0xFF else 8
            cur, used = 0, 0
    if used:
        if pad:
            cur |= ((1 << (cap - used)) - 1) << used
        out.append(cur)
    return bytes(out)


def backward_bytes(bits, first_nibble: bool) -> list:
    """VLC and MagRef, in the order they are read (backward from the
    segment's end): bits least significant first; a byte whose
    predecessor exceeds 0x8F and whose low 7 bits are all 1 carries 7 (its
    MSB a stuffed 0).  The VLC (``first_nibble``) starts in the upper half
    of the byte whose lower half holds Scup's low 4 bits, as if after a
    byte above 0x8F; the MagRef starts likewise after such a byte."""
    out, gt8f = [], True
    cur, used = (0xF, 4) if first_nibble else (0, 0)
    cap = 7
    for b in bits:
        cur |= b << used
        used += 1
        if used == cap:
            if cap == 7 and gt8f and cur != 0x7F:
                cap = 8
                continue
            out.append(cur)
            gt8f = cur > 0x8F
            cur, used = 0, 0
            cap = 7 if gt8f else 8
    if used:
        out.append(cur)
    return out


def mel_bytes(events) -> bytes:
    """The MEL: an adaptive run-length code of the events (T.814 7.3.3),
    bits most significant first, a byte after 0xFF carrying 7."""
    bits, k, run = [], 0, 0
    for e in events:
        if e == 0:
            run += 1
            if run == 1 << MEL_E[k]:
                bits.append(1)
                run, k = 0, min(k + 1, 12)
        else:
            bits.append(0)
            bits += [(run >> i) & 1 for i in reversed(range(MEL_E[k]))]
            run, k = 0, max(k - 1, 0)
    if run:
        bits.append(1)
    out, cur, used, cap = [], 0, 0, 8
    for b in bits:
        cur = (cur << 1) | b
        used += 1
        if used == cap:
            out.append(cur)
            cap = 7 if cur == 0xFF else 8
            cur, used = 0, 0
    if used:
        out.append(cur << (cap - used))
    elif out and out[-1] == 0xFF:  # a stuffed byte follows a 0xFF
        out.append(0)
    return bytes(out)


def uvlc_prefix(u: int):
    """(prefix bits, suffix bits) of u >= 1, least significant first."""
    if u == 1:
        return [1], []
    if u == 2:
        return [0, 1], []
    if u <= 4:
        return [0, 0, 1], [u - 3]
    s = u - 5
    assert s < 32, u
    return [0, 0, 0], [(s >> i) & 1 for i in range(5)]


def _prefix_name(u: int) -> str:
    return "1" if u == 1 else "01" if u == 2 else "001" if u <= 4 else (
        "000+ext" if u - 5 >= 28 else "000")


# --- the cleanup pass ---------------------------------------------------------------------

def exponent(mu: int) -> int:
    """E of a significant sample: the bit length of 2 (mu - 1) + 1."""
    mu = int(mu)
    return (2 * (mu - 1) + 1).bit_length() if mu else 0


def choose(book, rho, kappa, es, rng, force_uoff=None, where=None):
    """A (codeword, length, entry, U_q) for a quad of significance ``rho``
    and exponents ``es`` (4, 0 where insignificant) under ``kappa``: the
    codewords of the context whose entry decodes the quad, one picked at
    random (T.814 7.3.5: e_k the samples read with an implicit MSB, e_1
    its value, which must be 1 exactly where E equals U_q).  ``where``
    ``(table, context)``: a codeword no fixture has reached yet is
    preferred."""
    emax = max(es)
    options = []
    for w, n, v in book:
        if (v >> 4) & 0xF != rho:
            continue
        uoff, e1, ek = (v >> 3) & 1, (v >> 8) & 0xF, (v >> 12) & 0xF
        if force_uoff is not None and uoff != force_uoff:
            continue
        u_q = max(emax, kappa + 1) if uoff else kappa
        if not uoff and emax > kappa:
            continue
        if ek & ~rho or e1 & ~ek:
            continue
        ok = True
        for s in range(4):
            if ek >> s & 1:
                if u_q < 2 or ((e1 >> s) & 1) != (es[s] == u_q):
                    ok = False
        if ok:
            options.append((w, n, v, u_q))
    if not options:
        return None
    if where is not None:
        fresh = [o for o in options if not COVER.vlc[(*where, o[0], o[1])]]
        options = fresh or options
    return options[int(rng.integers(len(options)))]


def cleanup(mu, neg, rng, u_extra=0, u_limit=32):
    """The HT cleanup segment of magnitudes ``mu`` (>= 0) and signs ``neg``
    (code-block rows x columns).  Returns the segment's bytes.
    ``u_extra`` raises U_q past what the data needs on some quads (to
    reach the long UVLC suffixes), up to ``u_limit``."""
    h, w = mu.shape
    sig = mu > 0
    E = np.vectorize(exponent)(mu) if mu.size else mu

    def at(a, y, x):
        return int(a[y, x]) if 0 <= y < h and 0 <= x < w else 0

    mel, vlc, ms = [], [], []
    for y in range(0, h, 2):
        first = y == 0
        book = BOOKS[0 if first else 1]
        cq_carry = 0
        quads = list(range((w + 1) // 2))
        for pair in range(0, len(quads), 2):
            qs = quads[pair : pair + 2]
            info = []
            for q in qs:
                x = 2 * q
                samples = [(y, x), (y + 1, x), (y, x + 1), (y + 1, x + 1)]
                rho = sum(at(sig, yy, xx) << s for s, (yy, xx) in enumerate(samples))
                es = [at(E, yy, xx) for yy, xx in samples]
                if first:
                    c_q = cq_carry
                    kappa = 1
                else:
                    c_q = (cq_carry | (at(sig, y - 1, x - 1) | at(sig, y - 1, x))
                           | ((at(sig, y - 1, x + 1) | at(sig, y - 1, x + 2)) << 2))
                    gamma = bin(rho).count("1") > 1
                    emax_above = max(at(E, y - 1, xx) for xx in range(x - 1, x + 3))
                    kappa = max(emax_above - 1, 1) if gamma else 1
                if c_q == 0:
                    mel.append(int(rho != 0))
                chosen = None
                if not (c_q == 0 and rho == 0):
                    force = None
                    if u_extra and rho and (rng.random() < 0.3 or u_extra >= u_limit):
                        force = 1
                    where = (0 if first else 1, c_q)
                    chosen = choose(book[c_q], rho, kappa, es, rng, force, where)
                    if chosen is None:
                        chosen = choose(book[c_q], rho, kappa, es, rng, None, where)
                    assert chosen is not None, (c_q, rho, kappa, es)
                    wd, n, v, u_q = chosen
                    if force and u_extra and (v >> 3) & 1 and not (v >> 8) & 0xF:
                        # no implicit MSB depends on U_q; u_extra >= u_limit: U_q to the limit
                        if u_extra >= u_limit:
                            u_q = max(u_q, u_limit)
                        elif rng.random() < 0.5:
                            u_q = min(u_q + int(rng.integers(1, u_extra + 1)), max(u_q, u_limit))
                    vlc += [(wd >> i) & 1 for i in range(n)]
                    COVER.vlc[(0 if first else 1, c_q, wd, n)] += 1
                    entry = v
                else:
                    entry, u_q = 0, kappa
                info.append((q, samples, entry, u_q, kappa))
                if first:
                    cq_carry = ((entry >> 4) & 1) | ((entry & 0xE0) >> 5)
                else:
                    cq_carry = ((entry & 0x40) >> 5) | ((entry & 0x80) >> 6)
            # UVLC
            uoffs = [(e >> 3) & 1 for _, _, e, _, _ in info]
            us = [u_q - kappa for _, _, _, u_q, kappa in info]
            if first and len(info) == 2 and uoffs == [1, 1]:
                event = int(us[0] > 2 and us[1] > 2)
                mel.append(event)
                if event:
                    p0, s0 = uvlc_prefix(us[0] - 2)
                    p1, s1 = uvlc_prefix(us[1] - 2)
                    vlc += p0 + p1 + s0 + s1
                    COVER.uvlc[_prefix_name(us[0] - 2)] += 1
                    COVER.uvlc[_prefix_name(us[1] - 2)] += 1
                else:
                    p0, s0 = uvlc_prefix(us[0])
                    COVER.uvlc[_prefix_name(us[0])] += 1
                    if len(p0) == 3:
                        assert us[1] <= 2
                        vlc += p0 + [us[1] - 1] + s0
                    else:
                        p1, s1 = uvlc_prefix(us[1])
                        COVER.uvlc[_prefix_name(us[1])] += 1
                        vlc += p0 + p1 + s0 + s1
            else:
                coded = [(u, uo) for u, uo in zip(us, uoffs) if uo]
                pre = [uvlc_prefix(u) for u, _ in coded]
                for u, _ in coded:
                    COVER.uvlc[_prefix_name(u)] += 1
                for p, _ in pre:
                    vlc += p
                for _, s in pre:
                    vlc += s
            # MagSgn
            for q, samples, e, u_q, _ in info:
                for s, (yy, xx) in enumerate(samples):
                    if not (e >> (4 + s)) & 1:
                        continue
                    m = u_q - ((e >> (12 + s)) & 1)
                    v = 2 * (int(mu[yy, xx]) - 1) + int(neg[yy, xx])
                    ms += [(v >> i) & 1 for i in range(m)]
    ms_b = forward_bytes(ms, 1)
    mel_b = mel_bytes(mel)
    vlc_b = backward_bytes(vlc, True)
    vlc_rev = bytes([0xFF] + vlc_b)[::-1] if vlc_b else b"\x0f\xff"
    scup = len(mel_b) + len(vlc_rev)
    assert 2 <= scup <= 4079, scup
    seg = bytearray(ms_b + mel_b + vlc_rev)
    seg[-1] = scup >> 4
    seg[-2] = (seg[-2] & 0xF0) | (scup & 0xF)
    return bytes(seg)


# --- SigProp and MagRef -------------------------------------------------------------------

M32 = 0xFFFFFFFF
PROP = (0x32, 0x74, 0xE8, 0xC0)  # who a newly significant row-r sample makes a member


def refinement(mag, neg, p: int, passes: int, vsc: bool) -> bytes:
    """The SigProp (and with ``passes`` 3 the MagRef) segment for bit-plane
    ``p - 1`` below a cleanup at ``p``, in the scan OpenJPEG's decoder
    makes: stripes of 4 rows, groups of 8 columns held as 32-bit masks (a
    nibble a column, a bit a row)."""
    h, w = mag.shape
    ng = (w + 7) // 8 + 2
    ns = (h + 3) // 4
    sig = [[0] * ng for _ in range(ns + 1)]
    for y in range(h):
        for x in range(w):
            if mag[y, x] >> p:
                sig[y // 4][x // 8] |= 1 << (4 * (x % 8) + y % 4)

    def bit(y, x):
        return int(mag[y, x] >> (p - 1)) & 1

    mr = []
    if passes > 2:
        for s in range(ns):
            for g in range((w + 7) // 8):
                v = sig[s][g]
                for j in range(8):
                    for r in range(4):
                        if v >> (4 * j + r) & 1:
                            mr.append(bit(4 * s + r, 8 * g + j))
    mbr = [[0] * ng for _ in range(ns + 1)]
    for s in range(ns):
        prev = 0
        for g in range(ng - 1):
            v = sig[s][g]
            m = (v | (prev >> 28) | (v << 4) | (v >> 4) | (sig[s][g + 1] << 28)) & M32
            prev = v
            z = m | ((m & 0x77777777) << 1) | ((m & 0xEEEEEEEE) >> 1)
            mbr[s][g] = z & ~v & M32
    sp = []
    for s in range(ns):
        left = h - 4 * s
        pattern = {1: 0x11111111, 2: 0x33333333, 3: 0x77777777}.get(left, M32)
        cur_sig, cur_mbr, nxt_sig, nxt_mbr = sig[s], mbr[s], sig[s + 1], mbr[s + 1]
        if left > 4:  # members from the stripe below
            prev = 0
            for g in range(ng - 1):
                t = (nxt_sig[g] | (prev >> 28) | (nxt_sig[g] << 4) | (nxt_sig[g] >> 4)
                     | (nxt_sig[g + 1] << 28)) & M32
                prev = nxt_sig[g]
                if not vsc:
                    cur_mbr[g] |= (t & 0x11111111) << 3
                cur_mbr[g] &= ~cur_sig[g] & M32
        for g in range((w + 7) // 8):
            i = 8 * g
            m = cur_mbr[g] & pattern
            new_sig = 0
            if m:
                for n in (0, 4):
                    inv_sig = ~cur_sig[g] & pattern & M32
                    end = n + 4 if n + 4 + i < w else w - i
                    for j in range(n, end):
                        if not (m >> (4 * j)) & 0xF:
                            continue
                        for r in range(4):
                            if m >> (4 * j + r) & 1:
                                b = bit(4 * s + r, i + j)
                                sp.append(b)
                                if b:
                                    new_sig |= 1 << (4 * j + r)
                                    m |= (PROP[r] << (4 * j)) & inv_sig & M32
                    if new_sig & (0xFFFF << (4 * n)):
                        for j in range(n, end):
                            for r in range(4):
                                if new_sig >> (4 * j + r) & 1:
                                    sp.append(int(neg[4 * s + r, i + j]))
                    if n == 4:
                        t = new_sig >> 28
                        t |= ((t & 0xE) >> 1) | ((t & 7) << 1)
                        cur_mbr[g + 1] |= t & ~cur_sig[g + 1] & M32
            new_sig |= cur_sig[g]
            ux = (new_sig & 0x88888888) >> 3
            tx = (ux | (ux << 4) | (ux >> 4)) & M32
            if g > 0:
                nxt_mbr[g - 1] |= (ux << 28) & ~nxt_sig[g - 1] & M32
            nxt_mbr[g] |= tx & ~nxt_sig[g] & M32
            nxt_mbr[g + 1] |= (ux >> 28) & ~nxt_sig[g + 1] & M32
    sp_b = forward_bytes(sp, 0)
    mr_b = bytes(backward_bytes(mr, False)[::-1]) if mr else b""
    return sp_b, mr_b


def encode_block(q, p: int, passes: int, rng, vsc=False, u_extra=0, u_limit=32,
                 keep_empty=False):
    """One HT code-block of quantization indices ``q``: the cleanup at
    bit-plane ``p``, then (``passes`` 2 or 3) SigProp and MagRef at
    ``p - 1``.  Returns ``(segments, passes)``: [cleanup] or [cleanup,
    refinement]; no segment where no sample is significant at ``p - 1``
    or above (the block is then left out, unless ``keep_empty``).  The
    refinement segment is returned as its SigProp and MagRef parts."""
    mag = np.abs(q).astype(np.int64)
    neg = (q < 0).astype(np.int64)
    if not keep_empty and not np.any(mag >> max(p - 1 if passes > 1 else p, 0)):
        return [], 0
    seg0 = cleanup(mag >> p, neg, rng, u_extra, u_limit)
    if passes == 1 or p == 0:
        return [seg0], 1
    return [seg0, refinement(mag, neg, p, passes, vsc)], passes


# --- wavelets and colour ------------------------------------------------------------------

def ceildivpow2(a, b):
    return -((-a) >> b)


def fdwt53_line(x, sn, cas):
    n = len(x)
    if n == 1:
        return x * 2 if cas else x.copy()
    x = x.astype(np.int64)

    def m(k):
        if k < 0:
            k = -k
        if k >= n:
            k = 2 * (n - 1) - k
        return k

    d = x.copy()
    for k in range(1 - cas, n, 2):
        d[k] = x[k] - ((x[m(k - 1)] + x[m(k + 1)]) >> 1)
    for k in range(cas, n, 2):
        d[k] = x[k] + ((d[m(k - 1)] + d[m(k + 1)] + 2) >> 2)
    return np.concatenate([d[cas::2], d[1 - cas :: 2]])


def fdwt97_line(x, sn, cas):
    n = len(x)
    if n == 1:
        return x * 2 if cas else x.copy()
    v = x.astype(np.float64).copy()

    def m(k):
        if k < 0:
            k = -k
        if k >= n:
            k = 2 * (n - 1) - k
        return k

    alpha, beta, gamma, delta = -1.586134342, -0.052980118, 0.882911075, 0.443506852
    for c, start in ((alpha, 1 - cas), (beta, cas), (gamma, 1 - cas), (delta, cas)):
        src = v.copy()
        for k in range(start, n, 2):
            v[k] = src[k] + c * (src[m(k - 1)] + src[m(k + 1)])
    v[cas::2] /= 1.230174105
    v[1 - cas :: 2] /= 1.625732422
    return np.concatenate([v[cas::2], v[1 - cas :: 2]])


def fdwt(a, x0, y0, numres, reversible):
    """The forward transform of a tile-component whose origin is (x0, y0)."""
    a = a.astype(np.int64 if reversible else np.float64).copy()
    h, w = a.shape
    line = fdwt53_line if reversible else fdwt97_line
    for r in range(numres - 1, 0, -1):
        lv = numres - 1 - r
        rx0, ry0 = ceildivpow2(x0, lv), ceildivpow2(y0, lv)
        rw = ceildivpow2(x0 + w, lv) - rx0
        rh = ceildivpow2(y0 + h, lv) - ry0
        snh = ceildivpow2(x0 + w, lv + 1) - ceildivpow2(x0, lv + 1)
        snv = ceildivpow2(y0 + h, lv + 1) - ceildivpow2(y0, lv + 1)
        if rw == 0 or rh == 0:
            continue
        for i in range(rw):
            a[:rh, i] = line(a[:rh, i], snv, ry0 % 2)
        for j in range(rh):
            a[j, :rw] = line(a[j, :rw], snh, rx0 % 2)
    return a


# --- geometry and tier 2 ------------------------------------------------------------------

class TagTree:
    def __init__(self, w, h, values):
        self.levels = []
        lw, lh = w, h
        vals = np.array(values, np.int64).reshape(h, w) if w * h else np.zeros((0, 0), np.int64)
        while True:
            self.levels.append({"w": lw, "h": lh, "value": vals.copy(),
                                "low": np.zeros_like(vals), "known": np.zeros_like(vals)})
            if lw * lh <= 1:
                break
            nw, nh = (lw + 1) // 2, (lh + 1) // 2
            nv = np.full((nh, nw), 1 << 30, np.int64)
            for j in range(lh):
                for i in range(lw):
                    nv[j // 2, i // 2] = min(nv[j // 2, i // 2], vals[j, i])
            vals, lw, lh = nv, nw, nh

    def encode(self, bits, leaf, threshold):
        x, y = leaf % self.levels[0]["w"], leaf // self.levels[0]["w"]
        path = []
        for lev in self.levels:
            path.append((lev, y, x))
            x, y = x // 2, y // 2
        low = 0
        for lev, y, x in reversed(path):
            if low > lev["low"][y, x]:
                lev["low"][y, x] = low
            else:
                low = int(lev["low"][y, x])
            while low < threshold:
                if low >= lev["value"][y, x]:
                    if not lev["known"][y, x]:
                        bits.append(1)
                        lev["known"][y, x] = 1
                    break
                bits.append(0)
                low += 1
            lev["low"][y, x] = low


def header_bytes(bits) -> bytes:
    """Packet-header bits, most significant first, a byte after 0xFF
    carrying 7; a 0xFF at the end followed by 0x00."""
    out, cur, used, cap = [], 0, 0, 8
    for b in bits:
        cur = (cur << 1) | b
        used += 1
        if used == cap:
            out.append(cur)
            cap = 7 if cur == 0xFF else 8
            cur, used = 0, 0
    if used:
        out.append(cur << (cap - used))
    if out and out[-1] == 0xFF:
        out.append(0)
    return bytes(out)


def passes_code(n, bits):
    if n == 1:
        bits.append(0)
    elif n == 2:
        bits += [1, 0]
    elif n <= 5:
        bits += [1, 1] + [((n - 3) >> i) & 1 for i in (1, 0)]
    elif n <= 36:
        bits += [1, 1, 1, 1] + [((n - 6) >> i) & 1 for i in range(4, -1, -1)]
    else:
        bits += [1] * 9 + [((n - 37) >> i) & 1 for i in range(6, -1, -1)]


def floorlog2(n):
    return n.bit_length() - 1


class Block:
    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.contrib = {}  # layer -> [(bytes, passes)], in segment order
        self.first = None
        self.P = 0
        self.lblock = 3
        self.sent = False


def build_tile_comp(tx0, ty0, tx1, ty1, numres, cblk, precincts):
    """Resolutions -> bands -> precincts -> code-blocks, as the decoder
    lays them out (``init_tile``)."""
    res = []
    for r in range(numres):
        lv = numres - 1 - r
        rx0, ry0 = ceildivpow2(tx0, lv), ceildivpow2(ty0, lv)
        rx1, ry1 = ceildivpow2(tx1, lv), ceildivpow2(ty1, lv)
        pdx, pdy = precincts[r] if precincts else (15, 15)
        tlx, tly = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
        brx, bry = ceildivpow2(rx1, pdx) << pdx, ceildivpow2(ry1, pdy) << pdy
        pw = 0 if rx0 == rx1 else (brx - tlx) >> pdx
        ph = 0 if ry0 == ry1 else (bry - tly) >> pdy
        if r == 0:
            cbgx0, cbgy0, cbgw, cbgh = tlx, tly, pdx, pdy
        else:
            cbgx0, cbgy0, cbgw, cbgh = ceildivpow2(tlx, 1), ceildivpow2(tly, 1), pdx - 1, pdy - 1
        cw, ch = min(cblk[0], cbgw), min(cblk[1], cbgh)
        bands = []
        for b in ([0] if r == 0 else [1, 2, 3]):
            if r == 0:
                bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
            else:
                xob, yob = b & 1, b >> 1
                bx0 = ceildivpow2(tx0 - (xob << lv), lv + 1)
                by0 = ceildivpow2(ty0 - (yob << lv), lv + 1)
                bx1 = ceildivpow2(tx1 - (xob << lv), lv + 1)
                by1 = ceildivpow2(ty1 - (yob << lv), lv + 1)
            precs = []
            for pi in range(pw * ph):
                sx = cbgx0 + (pi % pw) * (1 << cbgw)
                sy = cbgy0 + (pi // pw) * (1 << cbgh)
                px0, py0 = max(sx, bx0), max(sy, by0)
                px1, py1 = min(sx + (1 << cbgw), bx1), min(sy + (1 << cbgh), by1)
                cx0, cy0 = (px0 >> cw) << cw, (py0 >> ch) << ch
                cx1, cy1 = ceildivpow2(px1, cw) << cw, ceildivpow2(py1, ch) << ch
                ncw = (cx1 - cx0) >> cw if cx1 > cx0 else 0
                nch = (cy1 - cy0) >> ch if cy1 > cy0 else 0
                blocks = []
                for k in range(ncw * nch):
                    bx = cx0 + (k % ncw) * (1 << cw)
                    by = cy0 + (k // ncw) * (1 << ch)
                    blocks.append(Block(max(bx, px0), max(by, py0), min(bx + (1 << cw), px1),
                                        min(by + (1 << ch), py1)))
                precs.append({"cw": ncw, "ch": nch, "blocks": blocks})
            bands.append({"b": b, "x0": bx0, "y0": by0, "x1": bx1, "y1": by1, "precs": precs})
        res.append({"x0": rx0, "y0": ry0, "x1": rx1, "y1": ry1, "pw": pw, "ph": ph,
                    "bands": bands})
    return res


def write_packet(res, pi, layer, numlayers, sop_eph, nsop):
    """One packet (tier 2, B.10) of precinct ``pi`` of a resolution."""
    bits = []
    bands = [b for b in res["bands"] if b["x1"] > b["x0"] and b["y1"] > b["y0"]]
    present = any(blk.contrib.get(layer) for b in bands for blk in b["precs"][pi]["blocks"])
    body = b""
    for band in bands:
        prec = band["precs"][pi]
        if "incl" not in prec:
            blocks = prec["blocks"]
            prec["incl"] = TagTree(prec["cw"], prec["ch"],
                                   [blk.first if blk.first is not None else numlayers
                                    for blk in blocks])
            prec["imsb"] = TagTree(prec["cw"], prec["ch"], [blk.P for blk in blocks])
    if present:
        bits.append(1)
        for band in bands:
            prec = band["precs"][pi]
            blocks = prec["blocks"]
            for k, blk in enumerate(blocks):
                segs = blk.contrib.get(layer)
                if not blk.sent:
                    prec["incl"].encode(bits, k, layer + 1)
                    if not segs:
                        continue
                    prec["imsb"].encode(bits, k, 1 << 20)
                else:
                    bits.append(1 if segs else 0)
                    if not segs:
                        continue
                npass = sum(n for _, n in segs)
                passes_code(npass, bits)
                need = 0
                for data, n in segs:
                    need = max(need, len(data).bit_length() - floorlog2(n) - blk.lblock)
                bits += [1] * max(need, 0) + [0]
                blk.lblock += max(need, 0)
                for data, n in segs:
                    nb = blk.lblock + floorlog2(n)
                    bits += [(len(data) >> i) & 1 for i in range(nb - 1, -1, -1)]
                    body += data
                blk.sent = True
    else:
        bits.append(0)
    head = header_bytes(bits)
    if sop_eph & 4:
        head += b"\xff\x92"
    if sop_eph & 2:
        head = b"\xff\x91\x00\x04" + struct.pack(">H", nsop & 0xFFFF) + head
    return head + body


def segments_for_layers(segs, passes, split, first_layer):
    """How a block's HT segments spread over layers (``{layer: [(bytes,
    passes)]}``): all in ``first_layer``, or with ``split``:

    * ``"refine"``: SigProp and MagRef one layer later, signalled as
      OpenJPEG's t2 reads a later layer of an HT block (its first length
      field still adds to the cleanup segment, here 0 bytes; the second
      opens the refinement segment);
    * ``"magref"``: MagRef one layer after SigProp, its bytes joining the
      refinement segment;
    * ``"cleanup"``: the cleanup's bytes over two layers (OpenJPEG joins
      them and warns of the missing refinement);
    * ``"part15"``: the refinement one layer later in a single length
      field of ``Lblock + 1`` bits, which OpenJPEG reads as a segment past
      the tile's data (cv2 gives None)."""
    out = {}
    if not segs:
        return out
    cln = segs[0]
    ref = segs[1][0] + segs[1][1] if len(segs) > 1 else None
    if split == "cleanup":
        k = max(len(cln) // 2, 1)
        out[first_layer] = [(cln[:k], 1)]
        out[first_layer + 1] = [(cln[k:], 1)]
        return out
    if ref is None or not split:
        out[first_layer] = [(cln, 1)] + ([(ref, passes - 1)] if ref is not None else [])
    elif split == "part15":
        out[first_layer] = [(cln, 1)]
        out[first_layer + 1] = [(ref, passes - 1)]
    elif split == "magref":
        assert passes == 3
        out[first_layer] = [(cln, 1), (segs[1][0], 1)]
        out[first_layer + 1] = [(segs[1][1], 1)]
    else:
        assert passes == 3
        out[first_layer] = [(cln, 1)]
        out[first_layer + 1] = [(b"", 1), (ref, 1)]
    return out


def quantize(c, step):
    return np.sign(c) * np.floor(np.abs(c) / step)


def encode_image(img, *, prec=8, reversible=True, numres=3, cblk=(64, 64), passes=1,
                 layers=1, layers_split=False, late_blocks=0.0, tiles=None, precincts=None,
                 sop_eph=0, order="LRCP", mct=None, coc_part1=(), vsc=False, u_extra=0,
                 seed=0, zero_blocks=0.0, guard=2, roi=None,
                 cod_style_extra=0, jp2=True, empty_blocks=0.0, tamper=None,
                 contrib_hook=None, u_limit=None, pad_column=False, other_wavelet=(),
                 p_claim=None):
    """A codestream (and JP2 around it) of ``img`` ([h, w] or [h, w, c]
    integers of ``prec`` bits) with HT code-blocks.  ``passes`` 1 codes the
    cleanup at bit-plane 0 (lossless for 5/3), 3 the cleanup at 1 and
    SigProp + MagRef at 0; ``layers_split`` spreads a block over two
    layers (:func:`segments_for_layers`); ``late_blocks`` the share of
    blocks first sent in a later layer;
    ``coc_part1`` components whose COC leaves them Part 1 (their blocks
    hold seeded bytes, which cv2 decodes as it decodes them);
    ``zero_blocks`` the share of blocks zeroed (left out),
    ``empty_blocks`` the share zeroed but sent (a cleanup of no
    significant sample); ``tamper(segments) -> segments`` rewrites the
    first HT block's segments and ``contrib_hook(contributions)`` what it
    sends in each layer, ``u_limit`` lifts the bound on U_q and
    ``pad_column`` codes a significant sample in a column past each
    block's odd width (the probes of what cv2 gives None on);
    ``other_wavelet`` components take the other wavelet in a COC and a QCC
    (and the colour transform, still signalled, is not applied here);
    ``p_claim`` signals each block's cleanup at that bit-plane, whatever
    plane it was coded at."""
    rng = np.random.default_rng(seed)
    planes = img if img.ndim == 3 else img[:, :, None]
    h, w, nc = planes.shape
    if mct is None:
        mct = nc >= 3
    tdx, tdy = tiles or (w, h)
    ntx, nty = -(-w // tdx), -(-h // tdy)
    lg = lambda v: v.bit_length() - 1  # noqa: E731
    cbw, cbh = lg(cblk[0]), lg(cblk[1])
    prc = [(lg(pw), lg(ph)) for pw, ph in reversed(precincts)] if precincts else None
    # quantization: reversible, or a step per band for 9/7
    nbands = 3 * (numres - 1) + 1
    gains = [0] + [g for _ in range(numres - 1) for g in (1, 1, 2)]
    quant = {True: ([prec + g for g in gains], [0] * nbands), False: ([], [])}
    for b in range(nbands if not reversible or other_wavelet else 0):
        e, m = prec + 1 - (b > 0), int(rng.integers(0, 2048))
        quant[False][0].append(e)
        quant[False][1].append(m)
    rev_of = [reversible != (c in other_wavelet) for c in range(nc)]
    # the code-blocks
    tiles_out = []
    for t in range(ntx * nty):
        tx, ty = t % ntx, t // ntx
        x0, y0 = tx * tdx, ty * tdy
        x1, y1 = min(x0 + tdx, w), min(y0 + tdy, h)
        region = planes[y0:y1, x0:x1].astype(np.int64) - (1 << (prec - 1))
        if mct and not other_wavelet:
            r_, g_, b_ = region[:, :, 0], region[:, :, 1], region[:, :, 2]
            if reversible:
                comps = [(r_ + 2 * g_ + b_) >> 2, b_ - g_, r_ - g_]
            else:
                comps = [0.299 * r_ + 0.587 * g_ + 0.114 * b_,
                         -0.16875 * r_ - 0.331260 * g_ + 0.5 * b_,
                         0.5 * r_ - 0.41869 * g_ - 0.08131 * b_]
            comps += [region[:, :, c] for c in range(3, nc)]
        else:
            comps = [region[:, :, c] for c in range(nc)]
        tile_comps = []
        for c, comp in enumerate(comps):
            rev = rev_of[c]
            expn, mant = quant[rev]
            coef = fdwt(comp, x0, y0, numres, rev)
            res = build_tile_comp(x0, y0, x1, y1, numres, (cbw, cbh), prc)
            for r, rr in enumerate(res):
                for band in rr["bands"]:
                    bidx = 0 if r == 0 else 3 * (r - 1) + band["b"]
                    mb = guard + expn[bidx] - 1
                    xoff = (res[r - 1]["x1"] - res[r - 1]["x0"]) if band["b"] & 1 else 0
                    yoff = (res[r - 1]["y1"] - res[r - 1]["y0"]) if band["b"] & 2 else 0
                    for pr in band["precs"]:
                        for blk in pr["blocks"]:
                            sl = coef[yoff + blk.y0 - band["y0"] : yoff + blk.y1 - band["y0"],
                                      xoff + blk.x0 - band["x0"] : xoff + blk.x1 - band["x0"]]
                            if rev:
                                q = sl.astype(np.int64)
                            else:
                                step = (1 + mant[bidx] / 2048) * 2.0 ** (prec - expn[bidx])
                                q = quantize(sl, step).astype(np.int64)
                            keep = False
                            if rng.random() < zero_blocks:
                                q = np.zeros_like(q)
                            elif rng.random() < empty_blocks:
                                q, keep = np.zeros_like(q), True
                            assert np.all(np.abs(q) < (1 << mb)), (np.abs(q).max(), mb)
                            if c in coc_part1:
                                if np.any(q) or rng.random() < 0.5:
                                    blk.P = mb - 2  # two bit-planes of seeded MQ bytes
                                    n = int(rng.integers(1, 4))
                                    blk.first = 0
                                    blk.contrib = {0: [(bytes(rng.integers(0, 256, int(
                                        rng.integers(1, 6))).astype(np.uint8)), n)]}
                                continue
                            bp = 1 if passes > 1 else 0
                            # U_q may reach the missing MSBs plus 2 (OpenJPEG's bound)
                            if pad_column and q.shape[1] % 2:
                                q = np.pad(q, ((0, 0), (0, 1)), constant_values=1)
                            segs, npass = encode_block(q, bp, passes, rng, vsc, u_extra,
                                                       u_limit or mb + 1 - bp, keep)
                            if not segs:
                                continue
                            if tamper is not None:
                                segs, tamper = tamper(segs), None
                            blk.P = mb - 1 - (bp if p_claim is None else p_claim)
                            first = 0
                            if late_blocks and rng.random() < late_blocks and layers > 1:
                                first = int(rng.integers(1, layers - (1 if layers_split else 0)))
                            blk.first = first
                            blk.contrib = segments_for_layers(segs, npass, layers_split, first)
                            if contrib_hook is not None:
                                blk.contrib, contrib_hook = contrib_hook(blk.contrib), None
            tile_comps.append(res)
        tiles_out.append(tile_comps)
    # the codestream
    rsiz = 0x4000
    siz = struct.pack(">HIIIIIIIIH", rsiz, w, h, 0, 0, tdx, tdy, 0, 0, nc) + b"".join(
        struct.pack(">BBB", prec - 1, 1, 1) for _ in range(nc))
    out = b"\xff\x4f" + b"\xff\x51" + struct.pack(">H", 2 + len(siz)) + siz
    out += b"\xff\x50" + struct.pack(">HIH", 8, 0x00020000, 0)  # CAP: Part 15
    scod = (1 if precincts else 0) | sop_eph
    style = (HT if coc_part1 != tuple(range(nc)) else 0) | cod_style_extra
    spcod = struct.pack(">BBBBB", numres - 1, cbw - 2, cbh - 2, style, 1 if reversible else 0)
    if precincts:
        spcod += bytes((ph << 4) | pw for pw, ph in prc)
    cod = struct.pack(">BBHB", scod, {"LRCP": 0, "RLCP": 1}[order], layers, int(mct)) + spcod
    out += b"\xff\x52" + struct.pack(">H", 2 + len(cod)) + cod
    for c in coc_part1:
        body = struct.pack(">BB", c, scod & 1) + spcod[:3] + bytes([cod_style_extra & ~HT]) \
            + spcod[4:]
        out += b"\xff\x53" + struct.pack(">H", 2 + len(body)) + body
    for c in other_wavelet:
        body = struct.pack(">BB", c, scod & 1) + spcod[:4] + bytes([int(rev_of[c])]) + spcod[5:]
        out += b"\xff\x53" + struct.pack(">H", 2 + len(body)) + body

    def sqcd(rev):
        expn, mant = quant[rev]
        if rev:
            return bytes([guard << 5]) + bytes(e << 3 for e in expn)
        return bytes([(guard << 5) | 2]) + b"".join(struct.pack(">H", (e << 11) | m)
                                                    for e, m in zip(expn, mant))

    qcd = sqcd(reversible)
    out += b"\xff\x5c" + struct.pack(">H", 2 + len(qcd)) + qcd
    for c in other_wavelet:
        qcc = bytes([c]) + sqcd(rev_of[c])
        out += b"\xff\x5d" + struct.pack(">H", 2 + len(qcc)) + qcc
    if roi:
        out += b"\xff\x5e" + struct.pack(">HBBB", 5, roi[0], 0, roi[1])
    nsop = 0
    for t, tile_comps in enumerate(tiles_out):
        data = b""
        order_list = []
        maxres = max(len(r) for r in tile_comps)
        if order == "LRCP":
            for l in range(layers):
                for r in range(maxres):
                    for c in range(nc):
                        order_list.append((l, r, c))
        else:
            for r in range(maxres):
                for l in range(layers):
                    for c in range(nc):
                        order_list.append((l, r, c))
        for l, r, c in order_list:
            rr = tile_comps[c][r]
            for pi in range(rr["pw"] * rr["ph"]):
                data += write_packet(rr, pi, l, layers, sop_eph, nsop)
                nsop += 1
        sot = struct.pack(">HIBB", t, 12 + 2 + len(data), 0, 1)
        out += b"\xff\x90\x00\x0a" + sot + b"\xff\x93" + data
    out += b"\xff\xd9"
    if not jp2:
        return out
    data = bytearray(jp2_file(out, h, w, nc))
    data[data.index(b"ihdr") + 14] = prec - 1  # BPC
    return bytes(data)


# --- the fixtures -------------------------------------------------------------------------

def _image(rng, h: int, w: int, c: int = 3) -> np.ndarray:
    """A smooth gradient with dark strokes and noise."""
    from tests.torch_port_data.make_jp2_fixtures import _image as image

    return image(rng, h, w, c)


def _cover_image(rng, h: int, w: int) -> np.ndarray:
    """Gray samples around 128 whose quads mix every significance pattern
    with magnitudes of every exponent (coefficients themselves under one
    resolution): what reaches every VLC codeword."""
    mag = np.exp2(rng.uniform(0, 7, (h, w))).astype(np.int64)
    mag = np.where(rng.random((h, w)) < rng.uniform(0.2, 0.7), 1, mag)  # quads of only 1s
    mag = np.where(rng.random((h, w)) < rng.uniform(0.2, 0.8), 0, mag)
    same = rng.random((h, w)) < 0.3  # exponents equal to a neighbour's, for e_1 patterns
    mag = np.where(same, np.roll(mag, 1, axis=1), mag)
    sign = np.where(rng.random((h, w)) < 0.5, -1, 1)
    return np.clip(128 + sign * np.minimum(mag, 127), 0, 255).astype(np.uint8)


def _mu(e: int) -> int:
    """A magnitude of exponent ``e``."""
    return 1 if e <= 1 else (1 << (e - 2)) + 1


def _target_image(rng, gaps) -> np.ndarray:
    """A 4-row gray image of 4x4 code-blocks (one resolution, so the
    samples are the coefficients), one a codeword of ``gaps``: for the
    first line pair's table, a left quad that makes the context and the
    quad right of it; for the other table, a row 1 that makes the context
    above (and kappa) and the quad in rows 2-3.  Each quad's magnitudes
    fit the codeword's rho, u_off, e_k and e_1."""
    cols = []
    for t, c, w, n in gaps:
        v = next(v for ww, nn, v in BOOKS[t][c] if (ww, nn) == (w, n))
        rho, uoff, e1, ek = (v >> 4) & 0xF, (v >> 3) & 1, (v >> 8) & 0xF, (v >> 12) & 0xF
        blk = np.zeros((4, 4), np.int64)
        gamma = bin(rho).count("1") > 1
        if t == 0:
            kappa, y = 1, 0
            blk[0, 0] = c & 1
            blk[0, 1] = (c >> 1) & 1
            blk[1, 1] = (c >> 2) & 1
        else:
            y = 2
            above = c & 5
            kappa = int(rng.integers(2, 4)) if above and (ek and not uoff or rng.random() < .5) \
                else 1
            ea = kappa + 1 if kappa > 1 else 1
            if c & 1:
                blk[1, 2] = _mu(ea)
            if c & 4:
                blk[1, 3] = _mu(ea)
            if not gamma:
                kappa = 1
            blk[2, 1] = (c >> 1) & 1
        u = kappa + 1 + int(rng.integers(0, 3)) if uoff else kappa
        if uoff and not e1:
            u = kappa + 1
        for s_, (dy, dx) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
            if not (rho >> s_) & 1:
                continue
            if (e1 >> s_) & 1:
                e = u
            elif (ek >> s_) & 1 or not uoff:
                e = min(u - 1, int(rng.integers(1, max(u - 1, 1) + 1))) if u > 1 else 1
                e = max(e, 1)
            else:
                e = int(rng.integers(1, u + 1))
            blk[y + dy, 2 + dx] = _mu(e)
        cols.append(blk * np.where(rng.random((4, 4)) < 0.5, -1, 1))
    return np.clip(128 + np.concatenate(cols, axis=1), 0, 255).astype(np.uint8)


def _line_image(rng) -> np.ndarray:
    from tests.torch_port_data.make_bmp_fixtures import _line

    return _line(rng)


def fixtures(rng) -> dict:
    """``{name: bytes}`` of every decodable HT fixture (``htj2k_line_0.png``
    the line's PNG twin)."""
    import cv2

    COVER.reset()
    files = {}
    rgb = _image(rng, 37, 53)
    gray = rgb[:, :, 1]
    big = _image(rng, 70, 90)
    files["ht_gray_rev_res1_cblk4x4_37x53.jp2"] = encode_image(gray, numres=1, cblk=(4, 4),
                                                              seed=1)
    files["ht_gray_rev_res6_cblk64_70x90.jp2"] = encode_image(big[:, :, 0], numres=6, seed=2)
    files["ht_rgb_rev_res3_cblk16_37x53.jp2"] = encode_image(rgb, numres=3, cblk=(16, 16),
                                                             seed=3)
    files["ht_rgb_irr_res4_cblk32x8_37x53.j2k"] = encode_image(
        rgb, reversible=False, numres=4, cblk=(32, 8), seed=4, jp2=False)
    files["ht_gray_irr_res2_cblk8x16_37x53.jp2"] = encode_image(
        gray, reversible=False, numres=2, cblk=(8, 16), seed=5)
    files["ht_rgb_refine_res3_cblk16_37x53.jp2"] = encode_image(rgb, numres=3, cblk=(16, 16),
                                                                passes=3, seed=6)
    files["ht_rgb_irr_refine_res5_cblk8_37x53.j2k"] = encode_image(
        rgb, reversible=False, numres=5, cblk=(8, 8), passes=3, seed=7, jp2=False)
    files["ht_gray_sigprop_res3_cblk16_37x53.jp2"] = encode_image(gray, numres=3,
                                                                  cblk=(16, 16), passes=2, seed=8)
    files["ht_gray_refine_vsc_res4_cblk8x4_37x53.jp2"] = encode_image(
        gray, numres=4, cblk=(8, 4), passes=3, vsc=True, cod_style_extra=0x08, seed=9)
    files["ht_rgb_layers3_late_res3_cblk16_70x90.jp2"] = encode_image(
        big, numres=3, cblk=(16, 16), passes=3, layers=3, late_blocks=0.5, seed=10)
    files["ht_rgb_layers2_refine_split_res3_cblk16_37x53.jp2"] = encode_image(
        rgb, numres=3, cblk=(16, 16), passes=3, layers=2, layers_split="refine", seed=11)
    files["ht_rgb_layers2_magref_split_res3_cblk16_37x53.jp2"] = encode_image(
        rgb, numres=3, cblk=(16, 16), passes=3, layers=2, layers_split="magref", seed=12)
    files["ht_gray_layers2_cleanup_split_res2_cblk32_37x53.jp2"] = encode_image(
        gray, numres=2, cblk=(32, 32), layers=2, layers_split="cleanup", seed=13)
    files["ht_rgb_tiles_precincts_sop_eph_res3_70x90.j2k"] = encode_image(
        big, numres=3, cblk=(8, 8), tiles=(32, 32), precincts=[(16, 16)] * 3, sop_eph=6,
        layers=2, late_blocks=0.4, seed=14, jp2=False)
    files["ht_rgb_rlcp_tiles_precincts_res2_70x90.jp2"] = encode_image(
        big, numres=2, cblk=(8, 8), passes=3, tiles=(40, 24), precincts=[(16, 16), (8, 8)],
        order="RLCP", layers=2, late_blocks=0.5, seed=15)
    files["ht_rgb_coc_part1_res3_37x53.jp2"] = encode_image(rgb, numres=3, cblk=(16, 16),
                                                            coc_part1=(0, 2), seed=16)
    files["ht_gray16_rev_res3_cblk16_37x53.jp2"] = encode_image(
        gray.astype(np.int64) * 257 + rng.integers(0, 256, gray.shape), prec=16, numres=3,
        cblk=(16, 16), seed=17)
    files["ht_rgb16_refine_res2_cblk64_37x53.jp2"] = encode_image(
        rgb.astype(np.int64) * 256 + rng.integers(0, 256, rgb.shape), prec=16, numres=2,
        passes=3, seed=18)
    files["ht_rgb_zblk_res3_cblk8_70x90.jp2"] = encode_image(
        big, numres=3, cblk=(8, 8), passes=3, zero_blocks=0.3, empty_blocks=0.2, seed=19)
    files["ht_gray_cblk1024x4_res1_9x1030.jp2"] = encode_image(
        _image(rng, 9, 1030)[:, :, 0], numres=1, cblk=(1024, 4), seed=20)
    files["ht_gray_uvlc_long_res1_cblk32_32x40.jp2"] = encode_image(
        _cover_image(rng, 32, 40), numres=1, cblk=(32, 32), u_extra=24, guard=7, seed=21)
    for k, cb in enumerate([(4, 4), (8, 8), (16, 4), (32, 32)]):
        files[f"ht_cover_{k}_cblk{cb[0]}x{cb[1]}_32x48.jp2"] = encode_image(
            _cover_image(rng, 32, 48), numres=1, cblk=cb, passes=3 if k % 2 else 1,
            seed=100 + k)
    k = 0
    while True:  # quads made for the codewords not reached yet
        gaps, _ = COVER.missing()
        if not gaps:
            break
        assert k < 8, gaps
        img = _target_image(rng, gaps)
        files[f"ht_cover_target_{k}_cblk4x4_4x{img.shape[1]}.jp2"] = encode_image(
            img, numres=1, cblk=(4, 4), seed=200 + k)
        k += 1
    line = _line_image(rng)
    files["htj2k_line_0.jp2"] = encode_image(line, numres=4, cblk=(32, 16), seed=22)
    files["htj2k_line_0.png"] = cv2.imencode(".png", line[:, :, ::-1])[1].tobytes()
    # where OpenJPEG warns and goes on: refinement passes under zero bit-planes
    # equal to the band's (only the cleanup is decoded, at the plane signalled),
    # and four passes whose refinement segment is empty (the cleanup alone)
    img = _image(np.random.default_rng(3), 20, 24)[:, :, 0]
    files["ht_gray_warn_zero_planes_refine_dropped_20x24.jp2"] = encode_image(
        img, numres=2, cblk=(16, 16), passes=3, p_claim=0)
    files["ht_gray_warn_four_passes_empty_refinement_20x24.jp2"] = encode_image(
        img, numres=1, cblk=(16, 16), passes=3, contrib_hook=lambda c: {0: [c[0][0], (b"", 3)]})
    return files


def _set_scup(scup: int):
    def tamper(segs):
        seg = bytearray(segs[0])
        seg[-1] = scup >> 4
        seg[-2] = (seg[-2] & 0xF0) | (scup & 0xF)
        return [bytes(seg)] + segs[1:]
    return tamper


def _big_block():
    return np.random.default_rng(5).integers(0, 65536, (64, 64))


def none_streams() -> dict:
    """``{what: bytes}``: HT streams cv2 gives None on (OpenJPEG's checks
    of HT code-blocks), each a probe of one rule."""
    rng = np.random.default_rng(31)
    img = _image(rng, 20, 24)
    gray = img[:, :, 0]
    out = {
        "Scup under 2": encode_image(gray, numres=1, cblk=(16, 16), tamper=_set_scup(1)),
        "Scup over Lcup": encode_image(gray, numres=1, cblk=(16, 16), tamper=_set_scup(4000)),
        "Scup over 4079": encode_image(_big_block(), prec=16, numres=1, cblk=(64, 64),
                                       tamper=_set_scup(4080)),
        "Lcup under 2": encode_image(gray, numres=1, cblk=(16, 16),
                                     tamper=lambda segs: [segs[0][-1:]]),
        "an empty cleanup segment": encode_image(gray, numres=1, cblk=(16, 16),
                                                 contrib_hook=lambda c: {0: [(b"", 1)]}),
        "four passes (placeholder passes before the cleanup)": encode_image(
            gray, numres=1, cblk=(16, 16), passes=3,
            contrib_hook=lambda c: {0: [c[0][0], (c[0][1][0], 3)]}),
        "a second HT set in a later layer": encode_image(
            gray, numres=1, cblk=(16, 16), passes=3, layers=2,
            contrib_hook=lambda c: {0: c[0], 1: [(b"\x00\x00\x00", 1)]}),
        "the refinement in a later layer as Part 15 signals it": encode_image(
            img, numres=2, cblk=(16, 16), passes=3, layers=2, layers_split="part15"),
        "HT with a region of interest": encode_image(gray, numres=1, cblk=(16, 16), roi=(0, 3)),
        "a UVLC past the 5-bit suffix (its extension)": encode_image(
            _cover_image(rng, 16, 16), numres=1, cblk=(16, 16), u_extra=36, guard=7, seed=3,
            u_limit=36),
        "the mixed HT style bit": encode_image(gray, numres=1, cblk=(16, 16),
                                               cod_style_extra=0x80),
        "a code-block of 128 x 64 samples": _cod_byte(
            encode_image(gray, numres=1, cblk=(16, 16)), 5, 7 - 2),
        "a quad significant past the block's edge": encode_image(
            gray[:, :15], numres=1, cblk=(16, 16), pad_column=True),
    }
    return out


def mel_start_stream(shift: int, chunks: int) -> bytes:
    """An 8x8 HT block whose MEL starts 0xFF 0x90 (a stuffed byte above
    0x8F) after ``shift`` filler bytes at the front of its cleanup segment,
    the segment in one contribution or (``chunks`` 2) over two layers.
    OpenJPEG tests that pair only in the bytes it reads one at a time to
    reach an address that is a multiple of 4: the block's data in place in
    the tile's buffer for one contribution, a joined copy (aligned) for
    more, so whether cv2 gives None follows ``shift`` modulo 4."""
    img = _cover_image(np.random.default_rng(0), 8, 8)

    def tamper(segs):
        seg = segs[0]
        scup = (seg[-1] << 4) | (seg[-2] & 0xF)
        rest = bytearray(seg[len(seg) - scup :])
        rest[0:2] = b"\xff\x90"
        return [b"\x55" * shift + seg[: len(seg) - scup] + bytes(rest)]

    return encode_image(img, numres=1, cblk=(8, 8), tamper=tamper, layers=chunks,
                        layers_split="cleanup" if chunks == 2 else False)


def scup_shift_stream(delta: int) -> bytes:
    """A 16x16 HT block whose Scup claims ``delta`` bytes more than its MEL
    and VLC hold: negative, the MEL starts inside the VLC (the two streams
    overlap); positive, the MagSgn's last bytes are read as the MEL's."""
    img = _cover_image(np.random.default_rng(1), 16, 16)

    def tamper(segs):
        seg = segs[0]
        return _set_scup(((seg[-1] << 4) | (seg[-2] & 0xF)) + delta)(segs)

    return encode_image(img, numres=1, cblk=(16, 16), tamper=tamper)


def _cod_byte(data: bytes, at: int, value: int) -> bytes:
    """``data`` with byte ``at`` of COD's body (after Lcod) set."""
    data = bytearray(data)
    data[data.index(b"\xff\x52") + 4 + at] = value
    return bytes(data)


def coverage_report() -> str:
    gaps, prefixes = COVER.missing()
    total = sum(len(BOOKS[t][c]) for t in range(2) for c in range(8))
    return (f"VLC codewords reached: {total - len(gaps)} of {total}; UVLC prefixes missing: "
            f"{prefixes or 'none'} ({dict(sorted(COVER.uvlc.items()))})")


def main() -> None:
    import cv2

    expected_path = os.path.join(OUT, "expected.npz")
    with np.load(expected_path) as z:
        expected = {k: z[k] for k in z.files if not k.startswith(("ht_", "htj2k_"))}
    for stale in os.listdir(OUT):
        if stale.startswith(("ht_", "htj2k_")):
            os.remove(os.path.join(OUT, stale))
    files = fixtures(np.random.default_rng(20261020))
    total = 0
    for name, data in files.items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        total += len(data)
        if name.endswith(".png"):
            continue
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert bgr is not None, name
        expected[name] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    np.savez_compressed(expected_path, **expected)
    for what, data in none_streams().items():
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None, what
    print(f"wrote {len(files)} HT files ({total} bytes) into {OUT}; {coverage_report()}")


if __name__ == "__main__":
    main()
