"""Read the HTJ2K (JPEG 2000 Part 15) cleanup-pass VLC tables back from cv2.

    python tests/torch_port_data/derive_ht_tables.py

Needs cv2 (only its shared object is read, as bytes; nothing of it runs).
The HT cleanup pass codes each quad's significance pattern with a
variable-length code whose codebook depends on a 3-bit context: one
codebook for the first line pair of a code-block, another for the rest
(ITU-T T.814 Annex C, tables C.1 and C.2).  No file here holds them;
OpenCV's bundled OpenJPEG keeps both as decode lookup tables of 1,024
little-endian ``uint16`` entries each, indexed by
``(context << 7) | (the next 7 bits of the VLC stream)``.  This script
finds them in ``cv2.abi3.so`` by their structure, not by an offset:

* every entry's low 3 bits are a codeword length ``L`` from 1 to 7;
* in each context's block of 128, an entry is the same for every
  look-ahead that agrees in its low ``L`` bits (the bits above a codeword
  are the next codeword's), so index ``i`` holds the entry of index
  ``i & ((1 << L) - 1)``;
* the codewords of a block are prefix-free, and every block uses a
  codeword of length at most 7 for each index (all 8 contexts covered);
* the two tables stand one after the other (2 x 2,048 bytes).

Which table is which the structure does not say: the round trip does.
cv2's OpenJPEG lays the table of the later line pairs first and that of
the first line pair after it; written the other way round, every fixture
of ``make_htj2k_fixtures.py`` with a significant quad in both decodes to
other pixels in ``cv2.imdecode``.

An entry packs, from the low bits up (checked by the fixtures' round trip
through ``cv2.imdecode``, ``make_htj2k_fixtures.py``)::

    bits 0-2    the codeword's length L (its bits are the index's low L,
                read least significant first from the VLC stream)
    bit  3      u_off: the quad has a u_q (unsigned residual) in the UVLC
    bits 4-7    rho: the significance of the quad's samples (bit 4 the
                top-left, 5 the bottom-left, 6 the top-right, 7 the
                bottom-right)
    bits 8-11   e_1: the implicit magnitude MSB of each sample in e_k
    bits 12-15  e_k: the samples whose MSB is implicit (read U_q - 1
                magnitude-sign bits, not U_q)

The UVLC prefix and suffix code and the MEL exponents are short rules of
T.814 (clause 7.3.6 and Table 2) and are written as rules in the decoder.

It writes ``rcnn_ocr_tpu_torch/csrc/host/ht_tables.inc``, which
``j2k_decode.cpp`` includes, and prints where it found the tables.  A
rerun writes the same bytes; the build and every decode read only that
file.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "..", "..", "rcnn_ocr_tpu_torch", "csrc", "host", "ht_tables.inc")


def shared_object() -> str:
    import cv2

    folder = os.path.dirname(cv2.__file__)
    names = [n for n in os.listdir(folder) if n.startswith("cv2") and ".so" in n]
    if len(names) != 1:
        raise SystemExit(f"expected one cv2 shared object in {folder}, found {names}")
    return os.path.join(folder, names[0])


def block_is_vlc(block: np.ndarray) -> bool:
    """One context's 128 entries: lengths 1-7, repeated over the look-ahead
    bits above each length, the codewords prefix-free, of more than one
    length, and each decoding to an entry of its own."""
    lengths = block & 7
    if not np.all(lengths > 0):
        return False
    idx = np.arange(128)
    if not np.array_equal(block, block[idx & ((1 << lengths.astype(np.int64)) - 1)]):
        return False
    words = {(int(i) & ((1 << int(n)) - 1), int(n)): int(v)
             for i, n, v in zip(idx, lengths, block)}
    if len({n for _, n in words}) < 2 or len(set(words.values())) != len(words):
        return False
    for w, n in words:  # no codeword is the start of a longer one
        for w2, n2 in words:
            if n2 > n and (w2 & ((1 << n) - 1)) == w:
                return False
    return True


def repeats(a: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """For each start, whether the 128 entries there repeat over their
    look-ahead bits (the first test of block_is_vlc, over many starts)."""
    ok = np.ones(len(starts), bool)
    for i in range(128):
        v = a[starts + i].astype(np.int64)
        ok &= v == a[starts + (i & ((1 << (v & 7)) - 1))]
    return ok


def table_at(a: np.ndarray, start: int) -> bool:
    return start + 1024 <= len(a) and all(
        block_is_vlc(a[start + 128 * c : start + 128 * (c + 1)]) for c in range(8))


def find_tables(path: str):
    """The byte offset of the pair and both tables, [2, 1024]: the first
    line pair's first (it stands second in the shared object)."""
    raw = np.fromfile(path, np.uint8)
    found = []
    for parity in (0, 1):
        a = raw[parity : parity + (len(raw) - parity) // 2 * 2].view("<u2")
        bad = np.flatnonzero((a & 7) == 0)
        starts = np.concatenate([[0], bad + 1])
        ends = np.concatenate([bad, [len(a)]])
        runs = [np.arange(s, e - 2047) for s, e in zip(starts, ends) if e - s >= 2048]
        if not runs:  # two tables of valid lengths, back to back
            continue
        cand = np.concatenate(runs)
        for c in range(16):  # every block of both tables repeats
            cand = cand[repeats(a, cand + 128 * c)]
        for t in cand:
            if table_at(a, int(t)) and table_at(a, int(t) + 1024):
                found.append((parity + 2 * int(t), a[t : t + 2048].reshape(2, 1024)[::-1].copy()))
    if len(found) != 1:
        raise SystemExit(f"expected one pair of VLC tables, found {len(found)}")
    return found[0]


def codebook(table: np.ndarray) -> dict:
    """``{(context, codeword, length): entry}`` of one table."""
    out = {}
    for i, v in enumerate(table):
        n = int(v) & 7
        out[(i >> 7, (i & 0x7F) & ((1 << n) - 1), n)] = int(v)
    return out


def render(tables: np.ndarray) -> str:
    lines = ["// The HTJ2K cleanup pass's VLC decode tables (T.814 Annex C), read back",
             "// from cv2's OpenJPEG by tests/torch_port_data/derive_ht_tables.py, which",
             "// explains the packing; do not edit by hand.  Indexed by",
             "// (context << 7) | (7 bits of the VLC stream); kHtVlc0 for the first line",
             "// pair of a code-block, kHtVlc1 for the others.", ""]
    for name, t in zip(("kHtVlc0", "kHtVlc1"), tables):
        lines.append(f"constexpr uint16_t {name}[1024] = {{")
        for r in range(0, 1024, 8):
            lines.append("    " + " ".join(f"0x{int(v):04x}," for v in t[r : r + 8]))
        lines.append("};")
        lines.append("")
    return "\n".join(lines)


def main() -> None:
    path = shared_object()
    offset, tables = find_tables(path)
    for k, t in enumerate(tables):
        book = codebook(t)
        rho0 = sum(1 for (c, _, _), v in book.items() if c == 0 and (v >> 4) & 0xF == 0)
        print(f"kHtVlc{k}: {len(book)} codewords over 8 contexts, {len(set(t.tolist()))} "
              f"distinct entries, {rho0} codeword(s) of rho 0 in context 0")
    text = render(tables)
    with open(OUT, "w") as f:
        f.write(text)
    print(f"found at byte 0x{offset:x} of {os.path.basename(path)}; wrote {os.path.normpath(OUT)}")


if __name__ == "__main__":
    sys.exit(main())
