"""Write the digest the port's synthetic generator is held to, here and on
the card's host.

    python tests/torch_port_data/make_synthetic_fixtures.py

Renders one seeded set a difficulty with the port's ``generate_dataset``
and the carried font (``tests/torch_port_data/fonts/DejaVuSans.ttf``, its
license beside it) and writes ``tests/torch_port_data/synthetic/expected.json``:
for each difficulty the set's parameters, the sha256 of its CSV and of each
image's decoded pixels (``imread``: RGB uint8).  The generator's arithmetic
is integer or element-wise float32, so every host must give these bytes.
Needs only the port (no cv2, no PIL).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
FONT = os.path.join(HERE, "fonts", "DejaVuSans.ttf")
EXPECTED = os.path.join(HERE, "synthetic", "expected.json")
SETS = {"clean": dict(n=32, seed=11, img_h=48),
        "medium": dict(n=32, seed=12, img_h=48),
        "hard": dict(n=32, seed=13, img_h=48)}


def digest(csv_path: str, root: str) -> dict:
    """sha256 of the CSV's bytes and of each listed image's decoded pixels."""
    import csv

    from rcnn_ocr_tpu_torch.data.image_io import imread

    with open(csv_path, "rb") as f:
        out = {"csv": hashlib.sha256(f.read()).hexdigest(), "images": []}
    with open(csv_path, newline="", encoding="utf-8") as f:
        for name, _ in csv.reader(f):
            img = imread(os.path.join(root, name))
            out["images"].append(hashlib.sha256(
                repr(img.shape).encode() + img.tobytes()).hexdigest())
    return out


def render_digests(work: str) -> dict:
    from rcnn_ocr_tpu_torch.data.synthetic import generate_dataset

    got = {}
    for difficulty, spec in SETS.items():
        root = os.path.join(work, difficulty)
        csv_path, _ = generate_dataset(root, spec["n"], seed=spec["seed"], img_h=spec["img_h"],
                                       difficulty=difficulty, fonts=[FONT])
        got[difficulty] = dict(spec, **digest(csv_path, root))
    return got


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    with tempfile.TemporaryDirectory() as work:
        got = render_digests(work)
    os.makedirs(os.path.dirname(EXPECTED), exist_ok=True)
    with open(EXPECTED, "w", encoding="utf-8") as f:
        json.dump(got, f, indent=1)
        f.write("\n")
    print(f"wrote {EXPECTED}")


if __name__ == "__main__":
    main()
