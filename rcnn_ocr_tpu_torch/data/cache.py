"""Disk-backed transform cache: decode and resize once, memmap afterwards.

Counterpart of ``rcnn_ocr_tpu/data/cache.py:TransformCache``, file layout
included (``cache_dir/tc_<digest>/{meta.json, data.u8, valid.u8}``):

* only deterministic transforms cache: a transform opts in with a
  ``cache_key`` (``ResizeAndPad`` does; random augmentations have none) and
  must give uint8 rows;
* the directory is keyed by a hash of every sample's path and label, the
  transform key and the row shape, so a changed CSV, charset filter or
  geometry misses into a fresh directory (edits to an image's content in
  place are not seen);
* a row is cached only when the served label is the indexed sample's (a
  quarantine substitute is never stored under another index);
* loader threads fill distinct rows; a row's valid flag is set after its
  bytes, and a re-fill writes the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable, Optional, Tuple

import numpy as np


def _dataset_signature(dataset) -> Optional[str]:
    """Hash over the (path, label) rows; None for a dataset without them."""
    path_of = getattr(dataset, "sample_path", None)
    label_of = getattr(dataset, "sample_label", None)
    if path_of is None or label_of is None:
        return None
    h = hashlib.sha1()
    n = len(dataset)
    h.update(str(n).encode())
    for i in range(n):
        h.update(path_of(i).encode("utf-8", "replace"))
        h.update(b"\x00")
        h.update(label_of(i).encode("utf-8", "replace"))
        h.update(b"\x01")
    return h.hexdigest()


class TransformCache:
    """Memmap of ``transform(decode(sample))`` rows for one dataset and one
    deterministic transform; the signature scan and the mapping happen on
    first use."""

    def __init__(self, dataset, transform, cache_dir: str):
        self.dataset = dataset
        self.transform = transform
        self.cache_dir = cache_dir
        self._ready = False
        self._enabled = False
        self._data = None
        self._valid = None
        self._label_of = getattr(dataset, "sample_label", None)
        self._warned_nonint = False

    def _probe_row(self) -> Optional[Tuple[tuple, np.dtype]]:
        out = self.transform(np.full((16, 16, 3), 255, np.uint8))
        if not isinstance(out, np.ndarray) or out.dtype != np.uint8:
            return None  # only the uint8 feed is cached
        return tuple(out.shape), out.dtype

    def _init(self) -> bool:
        if self._ready:
            return self._enabled
        self._ready = True
        key = getattr(self.transform, "cache_key", None)
        if not key or self._label_of is None:
            return False
        sig = _dataset_signature(self.dataset)
        probed = self._probe_row() if sig is not None else None
        if probed is None:
            return False
        row_shape, dtype = probed
        n = len(self.dataset)
        digest = hashlib.sha1(f"{sig}|{key}|{row_shape}|{dtype}|{n}".encode()).hexdigest()[:20]
        d = os.path.join(self.cache_dir, f"tc_{digest}")
        try:
            os.makedirs(d, exist_ok=True)
            meta_path = os.path.join(d, "meta.json")
            if not os.path.exists(meta_path):
                tmp = meta_path + f".tmp{os.getpid()}"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump({"n": n, "row_shape": list(row_shape), "dtype": str(dtype),
                               "transform": key, "signature": sig}, f)
                os.replace(tmp, meta_path)
            data_path = os.path.join(d, "data.u8")
            valid_path = os.path.join(d, "valid.u8")
            # create without truncating, then always open "r+": a second
            # process must never truncate rows a first one already wrote
            for path, size in ((data_path, n * int(np.prod(row_shape)) * np.dtype(dtype).itemsize),
                               (valid_path, n)):
                with open(path, "ab") as f:
                    if f.tell() < size:
                        f.truncate(size)
            self._data = np.memmap(data_path, dtype=dtype, mode="r+", shape=(n,) + row_shape)
            self._valid = np.memmap(valid_path, dtype=np.uint8, mode="r+", shape=(n,))
        except OSError as err:  # an unwritable cache dir: serve uncached
            print(f"[cache] transform cache disabled ({d}: {err})")
            self._data = self._valid = None
            return False
        self._row_shape = row_shape
        self._dtype = dtype
        self._enabled = True
        return True

    @property
    def enabled(self) -> bool:
        return self._init()

    def hits(self) -> int:
        """Rows currently cached."""
        return int(np.count_nonzero(self._valid)) if self.enabled else 0

    def fetch(self, idx: Any, fetch_fn: Callable[[], Tuple[np.ndarray, str]]):
        """``(image, label)`` for ``idx``: the memmap row when cached, else
        ``fetch_fn()`` (cached afterwards when safe)."""
        if not isinstance(idx, (int, np.integer)):
            # (ds_idx, sample_idx) indices of the proportional MultiDataset
            # have no row position
            if not self._warned_nonint:
                self._warned_nonint = True
                print("[cache] transform cache inactive for this dataset: non-integer "
                      "sample indices (proportional MultiDataset) - rows serve uncached")
            return fetch_fn()
        if not self._init():
            return fetch_fn()
        i = int(idx)
        if 0 <= i < self._valid.shape[0] and self._valid[i]:
            return np.array(self._data[i]), self._label_of(i)
        img, label = fetch_fn()
        if (0 <= i < self._valid.shape[0] and isinstance(img, np.ndarray)
                and img.dtype == self._dtype and tuple(img.shape) == self._row_shape
                and label == self._label_of(i)):
            self._data[i] = img
            self._valid[i] = 1
        return img, label
