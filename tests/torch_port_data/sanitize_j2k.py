"""Run the port's JPEG 2000 codestream decoder under AddressSanitizer and
UndefinedBehaviorSanitizer.

    python tests/torch_port_data/sanitize_j2k.py

Builds ``rcnn_ocr_tpu_torch/csrc/host/j2k_decode.cpp`` with a small test program
(``g++ -fsanitize=address,undefined -D_GLIBCXX_ASSERTIONS``, which also
checks every ``std::vector`` index) into a temporary directory, then calls
``rcnn_j2k_header`` and ``rcnn_j2k_decode`` on every stream of
:func:`streams`: the codestream of each fixture in ``jp2/`` (the HTJ2K
``ht_*`` ones among them), the named streams of :func:`named_streams`
(with the HT streams OpenJPEG fails), seeded cuts and bit flips of the
fixtures (300, seed 0) and seeded damage inside the code-blocks' bytes of
the HT fixtures (300 more, :func:`damage_blocks`).  The program calls the
C++ directly, so it reaches what ``data/jpeg2000.py`` refuses before
decoding (subsampled and offset components, more than four components).  Exits non-zero, naming the
stream, on the first fault a sanitizer reports.  Needs g++ with libasan
and libubsan; the named streams need PIL's bundled OpenJPEG (through
``make_jp2_fixtures.opj_encode``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
SOURCE = REPO / "rcnn_ocr_tpu_torch" / "csrc" / "host" / "j2k_decode.cpp"
FIXTURES = HERE / "jp2"
CODESTREAM = b"\xff\x4f\xff\x51"

MAIN = r"""
#include <cstdint>
#include <cstdio>
#include <vector>
extern "C" int64_t rcnn_j2k_header(const uint8_t*, int64_t, int64_t*, char*, int64_t);
extern "C" int64_t rcnn_j2k_decode(const uint8_t*, int64_t, int32_t*, int64_t, char*, int64_t);
int main(int argc, char** argv) {
  std::vector<int64_t> info(5 + 8 * 16384);
  char msg[256];
  for (int i = 1; i < argc; ++i) {
    std::printf("%s ", argv[i]);
    std::fflush(stdout);
    FILE* f = std::fopen(argv[i], "rb");
    if (!f) return 2;
    std::vector<uint8_t> data;
    int ch;
    while ((ch = std::fgetc(f)) != EOF) data.push_back(static_cast<uint8_t>(ch));
    std::fclose(f);
    int64_t rc = rcnn_j2k_header(data.data(), data.size(), info.data(), msg, sizeof msg);
    if (rc == 0) {
      int64_t total = 0;
      for (int64_t c = 0; c < info[4]; ++c) total += info[5 + 8 * c + 2] * info[5 + 8 * c + 3];
      if (total <= (int64_t(1) << 26)) {
        std::vector<int32_t> out(total > 0 ? total : 1);
        rc = rcnn_j2k_decode(data.data(), data.size(), out.data(), total, msg, sizeof msg);
      }
    }
    std::printf("%lld\n", static_cast<long long>(rc));
  }
  return 0;
}
"""

FLAGS = ["-O1", "-g", "-std=c++17", "-ffp-contract=off", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", "-fno-omit-frame-pointer", "-D_GLIBCXX_ASSERTIONS"]


def build(out_dir: Path) -> Path:
    """The sanitized test program, built into ``out_dir``."""
    main = out_dir / "main.cpp"
    main.write_text(MAIN)
    exe = out_dir / "j2k_sanitized"
    subprocess.run([os.environ.get("CXX", "g++"), *FLAGS, "-o", str(exe), str(SOURCE),
                    str(main)], check=True, capture_output=True, text=True, timeout=600)
    return exe


def codestream(data: bytes) -> bytes:
    at = data.find(CODESTREAM)
    return data[at:] if at >= 0 else data


def named_streams() -> dict:
    """Streams built to reach corners the fixtures do not:

    * ``empty_tile_component_res{1,2,3}``: a tile one sample wide at an odd
      x, so that the chroma components subsampled by 2 have no sample in
      it (their wavelet runs over an empty plane);
    * ``layers_65535``: :func:`make_jp2_fixtures.many_layers`, 5.7 M
      packets of which all but the first layer's are empty;
    * ``tiles_65535``: :func:`make_jp2_fixtures.many_tiles`, 65535 tiles
      of which one is sent;
    * ``ht_*``: :func:`make_htj2k_fixtures.none_streams`, the HT streams
      OpenJPEG fails (Scup and Lcup out of range, too many passes, a quad
      past the block's edge, ...);
    * ``mixed_wavelets_*``: a colour transform over a component of the
      other wavelet (its buffer's bits read as the other kind)."""
    sys.path.insert(0, str(REPO))
    from tests.torch_port_data.make_jp2_fixtures import many_layers, many_tiles, opj_encode

    g = np.random.default_rng(4).integers(0, 256, (40, 42))
    out = {}
    for numres in (1, 2, 3):
        out[f"empty_tile_component_res{numres}"] = opj_encode(
            [g, g[::2, ::2], g[::2, ::2]], subsampling=[(1, 1), (2, 2), (2, 2)], numres=numres,
            mct=0, tiles=(41, 39))
    out["layers_65535"] = codestream(many_layers())
    out["tiles_65535"] = codestream(many_tiles())
    from tests.torch_port_data.make_htj2k_fixtures import encode_image, none_streams

    for k, data in enumerate(none_streams().values()):
        out[f"ht_none_{k}"] = codestream(data)
    img = np.random.default_rng(5).integers(0, 256, (20, 22, 3)).astype(np.uint8)
    for rev in (True, False):  # a colour transform over buffers of the other kind
        out[f"mixed_wavelets_{int(rev)}"] = codestream(encode_image(
            img, numres=2, cblk=(16, 16), reversible=rev, other_wavelet=(1,)))
    return out


def damage(data: bytes, rng) -> bytes:
    """A cut, one to three bit flips (in the first 120 bytes or anywhere),
    or one random byte in the second half."""
    data = bytearray(data)
    kind = rng.integers(0, 4)
    if kind == 0:
        return bytes(data[: int(rng.integers(0, len(data)))])
    if kind == 3:
        data[int(rng.integers(len(data) // 2, len(data)))] = int(rng.integers(0, 256))
        return bytes(data)
    span = min(120, len(data)) if kind == 1 else len(data)
    for _ in range(int(rng.integers(1, 4))):
        data[int(rng.integers(0, span))] ^= 1 << int(rng.integers(0, 8))
    return bytes(data)


def damage_blocks(data: bytes, rng) -> bytes:
    """Damage inside the code-blocks' bytes (after the first SOD): a cut,
    one to three bit flips, or a byte set to a random value or to one the
    bit-stuffing rules test (0xFF, 0x7F, 0x8F, 0x90)."""
    data = bytearray(data)
    start = data.index(b"\xff\x93") + 2
    at = int(rng.integers(start, len(data)))
    kind = rng.integers(0, 4)
    if kind == 0:
        return bytes(data[:at])
    if kind == 1:
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(start, len(data)))] ^= 1 << int(rng.integers(0, 8))
    elif kind == 2:
        data[at] = int(rng.integers(0, 256))
    else:
        data[at] = int(rng.choice([0xFF, 0x7F, 0x8F, 0x90]))
    return bytes(data)


def streams(cases: int, seed: int) -> dict:
    fixtures = {p.name: codestream(p.read_bytes()) for p in sorted(FIXTURES.iterdir())
                if p.suffix in (".jp2", ".j2k")}
    out = dict(fixtures)
    out.update(named_streams())
    rng = np.random.default_rng(seed)
    names = sorted(fixtures)
    for k in range(cases):
        name = names[rng.integers(len(names))]
        out[f"damaged_{k}_{name}"] = damage(fixtures[name], rng)
    ht_names = [n for n in names if n.startswith(("ht_", "htj2k_"))]
    for k in range(cases):
        name = ht_names[rng.integers(len(ht_names))]
        out[f"ht_damaged_{k}_{name}"] = damage_blocks(fixtures[name], rng)
    return out


def run(cases: int = 300, seed: int = 0):
    """Build the test program and run it over :func:`streams`; returns
    ``(returncode, output)``, the output one ``name rc`` line a stream."""
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        exe = build(work)
        paths = []
        for name, data in streams(cases, seed).items():
            path = work / (name + ".j2k")
            path.write_bytes(data)
            paths.append(str(path))
        env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
                   UBSAN_OPTIONS="print_stacktrace=1")
        done = subprocess.run([str(exe), *paths], capture_output=True, text=True, env=env,
                              timeout=600)
        return done.returncode, done.stdout + done.stderr


def main() -> None:
    rc, out = run()
    lines = out.splitlines()
    print("\n".join(lines[-40:]) if rc else f"{len(lines)} streams, no sanitizer report")
    sys.exit(rc)


if __name__ == "__main__":
    main()

