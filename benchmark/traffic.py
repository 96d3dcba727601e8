"""The general traffic generator: line images from a mix file
(``benchmark/workloads/<cell>.json``) and a seed.

Lines are seeded uint8 RGB images of text-line shape: white with dark
glyph-like blobs and pixel noise (the generator of ``chip_smoke.py``, with
the heights and width cap the mix gives).  Every seed gets the same set of
line sizes, drawn from the mix's ``geometry_seed``, in its own order and with
its own pixels, so seeds change the inputs and not the amount of work.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _geometry(spec: dict) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(spec["geometry_seed"])
    n = spec["n_lines"]
    bands = spec["height_bands"]  # alternate between [lo, hi) bands
    h = np.array([rng.integers(*bands[i % len(bands)]) for i in range(n)])
    aspect = rng.uniform(*spec["aspect"], size=n)
    w = np.minimum((h * aspect).astype(np.int64), spec["max_width"])
    return h, np.maximum(w, 1)


def make_lines(spec: dict, seed: int) -> List[np.ndarray]:
    """``spec["n_lines"]`` seeded line images ``[h, w, 3]`` uint8."""
    rng = np.random.default_rng(seed)
    h_all, w_all = _geometry(spec)
    order = rng.permutation(len(h_all))
    noise_lo, noise_hi = spec["noise"]
    pool = rng.integers(noise_lo, noise_hi, size=1 << 22, dtype=np.int16)
    out = []
    for i in order:
        h, w = int(h_all[i]), int(w_all[i])
        img = np.full((h, w, 3), 255, np.int16)
        for _ in range(int(rng.integers(*spec["blobs"]))):  # dark glyph-like blobs
            y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
            img[y0:y0 + int(rng.integers(2, h // 2 + 3)),
                x0:x0 + int(rng.integers(1, 6))] = int(rng.integers(*spec["ink"]))
        size = h * w * 3
        start = int(rng.integers(0, pool.size - size))
        img += pool[start:start + size].reshape(h, w, 3)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out
