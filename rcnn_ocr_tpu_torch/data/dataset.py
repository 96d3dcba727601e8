"""CSV/TSV OCR datasets, splits and batch samplers.

Counterpart of ``rcnn_ocr_tpu/data/dataset.py`` (``SkipLog``,
``OCRDataset``, ``SubsetDataset``, ``random_split``, ``MultiDataset``,
``ConcatDataset``, ``exact_quotas``, ``ProportionalBatchSampler``,
``ShuffleBatchSampler``), with the same contract:

* delimiter by extension (``.tsv`` -> tab, else comma) unless given; a
  header when the first cell is one of {file, filename, image, path, img,
  name};
* rows screened in CSV order (threaded, order kept) under the first reason
  that rejects them: ``bad_row``, ``empty_fname``, ``empty_label``,
  ``charset``, ``too_long`` (characters in the charset > ``max_len``),
  ``missing_path``; ``ambiguous`` basenames are counted and the first
  candidate used; per-reason counts with up to 8 examples;
* an image that fails to decode is quarantined on first access and a
  healthy sample substituted (at most 8 tries);
* samplers draw from ``numpy.random.default_rng(seed)`` exactly as JAX's do,
  so the same seeds give the same index sequences.

Images are read by :mod:`rcnn_ocr_tpu_torch.data.image_io` (PNG, BMP, JPEG,
JPEG 2000, TIFF, WebP, GIF, Netpbm, Sun raster, PFM and Radiance HDR,
whatever extension the CSV gives them, as JAX's reads any file it names
through cv2).  A file cv2 cannot read either (empty, cut short, not an
image, OpenEXR, which this cv2 lacks, a 32-bit float or ZSTD TIFF, a
12-bit or hierarchical JPEG, ...) raises ``ValueError`` and is
quarantined as JAX's quarantines it; a file in a format or variant cv2
reads and the port refuses (AVIF) raises its
``UnsupportedImageFormat`` instead of being quarantined.  ``fetch`` passes
an ``rng`` on to the transform (the loader seeds one per sample); the
substitute draw is seeded too.
"""

from __future__ import annotations

import csv
import os
import random
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rcnn_ocr_tpu_torch.data.image_io import UnsupportedImageFormat, build_file_index, imread
from rcnn_ocr_tpu_torch.utils.progress import progress

HEADER_TOKENS = {"file", "filename", "image", "path", "img", "name"}
SKIP_REASONS = ("bad_row", "empty_fname", "empty_label", "charset", "too_long",
                "missing_path", "ambiguous", "readfail")
EXAMPLES_PER_REASON = 8


class SkipLog:
    """Counts and capped examples of rejected rows and images, per reason,
    plus a frequency table of characters outside the charset."""

    def __init__(self, reasons: Sequence[str] = SKIP_REASONS, cap: int = EXAMPLES_PER_REASON):
        self.counts: Dict[str, int] = dict.fromkeys(reasons, 0)
        self.examples: Dict[str, List] = {r: [] for r in reasons}
        self.missing_chars: Counter = Counter()
        self.cap = cap
        self._lock = threading.Lock()  # note() runs on the indexing pool

    def note(self, reason: str, example=None, missing_chars=None) -> None:
        with self._lock:
            self.counts[reason] += 1
            if example is not None and len(self.examples[reason]) < self.cap:
                self.examples[reason].append(example)
            if missing_chars:
                self.missing_chars.update(missing_chars)

    def total(self) -> int:
        return sum(self.counts.values())

    def render(self) -> List[str]:
        """Report lines for the non-zero reasons."""
        lines: List[str] = []
        for reason, n in self.counts.items():
            if n == 0:
                continue
            lines.append(f"  - {reason}: {n}")
            if self.examples[reason]:
                lines.append(f"    examples: {self.examples[reason][: self.cap]}")
        if self.counts.get("charset") and self.missing_chars:
            lines.append("  Missing characters (TOP 30):")
            for ch, n in self.missing_chars.most_common(30):
                lines.append(f"    '{ch}' (U+{ord(ch):04X}, repr={ch!r}): {n}x")
        return lines


def _clean_label(raw: str) -> str:
    """NBSP -> space, strip whitespace and BOM."""
    return raw.replace("\u00a0", " ").strip().replace("\ufeff", "")


def _clean_filename(raw: str) -> str:
    """Strip whitespace/BOM, Windows separators -> POSIX."""
    return raw.strip().replace("\ufeff", "").replace("\\", "/")


def _sniff_delimiter(csv_path: str) -> str:
    return "\t" if csv_path.lower().endswith(".tsv") else ","


class OCRDataset:
    """A validated (image path, label) dataset backed by a CSV/TSV file."""

    def __init__(self, csv_path: str, images_dir, stoi: Dict[str, int], img_height: int = 32,
                 img_max_width: int = 128, encoding: str = "utf-8",
                 transform: Optional[Callable] = None, num_workers: int = -1,
                 delimiter: Optional[str] = None, has_header: Optional[bool] = None,
                 strict_charset: bool = True, validate_image: bool = True,
                 max_len: Optional[int] = None, strict_max_len: bool = True,
                 verbose: bool = True):
        self.images_dir = images_dir
        self.img_h = img_height
        self.img_w = img_max_width
        self.stoi = stoi
        self.transform = transform
        self._file_index = build_file_index(images_dir)
        self._encoding = encoding
        self._delimiter = delimiter if delimiter is not None else _sniff_delimiter(csv_path)
        self._has_header = has_header
        self._strict_charset = strict_charset
        self._validate_image = validate_image
        self._max_len = max_len
        self._strict_max_len = strict_max_len
        self._verbose = verbose
        self._audit = SkipLog()
        self._retry_budget = 8
        self._substitute_rng = random.Random(0)
        self._quarantine_lock = threading.Lock()
        self._quarantine_announced = False

        rows = self._load_rows(csv_path)
        self.samples: List[Tuple[str, str]] = self._index_rows(rows, num_workers)
        self._n_rejected = len(rows) - len(self.samples)
        self._invalid_mask = [False] * len(self.samples)
        if verbose and self._n_rejected > 0:
            print(f"[OCRDataset] {csv_path}: skipped {self._n_rejected} rows.")
            for line in self._audit.render():
                print(line)
        if not self.samples:
            raise RuntimeError(f"No valid samples left in dataset {csv_path}!")

    @property
    def skip_counts(self) -> Dict[str, int]:
        return self._audit.counts

    @property
    def skip_examples(self) -> Dict[str, List]:
        return self._audit.examples

    @property
    def missing_chars(self) -> Counter:
        return self._audit.missing_chars

    # -- iteration ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        return self.fetch(idx)

    def fetch(self, idx: int, transform=None, rng: Optional[np.random.Generator] = None):
        """``(image, label)``: the image through ``transform`` (else the
        dataset's own; float32 / 255 when there is none), which gets ``rng``."""
        if not (0 <= idx < len(self.samples)):
            raise IndexError(idx)
        if not self._validate_image:
            path, label = self.samples[idx]
            return self._finish(imread(path), transform, rng), label
        cursor = idx
        for _ in range(self._retry_budget):
            if self._invalid_mask[cursor]:
                cursor = self._pick_substitute(cursor)
                continue
            path, label = self.samples[cursor]
            try:
                image = imread(path)
            except UnsupportedImageFormat:
                raise
            except (OSError, ValueError) as err:
                self._quarantine(cursor, path, err)
                cursor = self._pick_substitute(cursor)
                continue
            return self._finish(image, transform, rng), label
        raise RuntimeError(f"Gave up after {self._retry_budget} substitution attempts; "
                           "too many unreadable images.")

    def _finish(self, image: np.ndarray, override, rng) -> np.ndarray:
        fn = override if override is not None else self.transform
        if fn is None:
            return image.astype(np.float32) / 255.0
        return fn(image, rng)

    def _quarantine(self, idx: int, path: str, error: Exception) -> None:
        """Mark a sample unreadable; it is never served again."""
        self._invalid_mask[idx] = True
        self._audit.note("readfail", f"{path} :: {type(error).__name__}")
        if self._verbose and not self._quarantine_announced:
            print("[OCRDataset] Unreadable image found during iteration; "
                  "quarantined samples are replaced by random healthy ones.")
            self._quarantine_announced = True

    def _pick_substitute(self, avoid: int) -> int:
        n = len(self.samples)
        with self._quarantine_lock:
            for _ in range(32):
                i = self._substitute_rng.randrange(n)
                if i != avoid and not self._invalid_mask[i]:
                    return i
            healthy = [i for i in range(n) if i != avoid and not self._invalid_mask[i]]
            if not healthy:
                raise RuntimeError("Every sample is quarantined; nothing left to serve.")
            return self._substitute_rng.choice(healthy)

    # -- indexing -------------------------------------------------------------------
    def _load_rows(self, csv_path: str) -> List[List[str]]:
        with open(csv_path, newline="", encoding=self._encoding) as f:
            rows = list(csv.reader(f, delimiter=self._delimiter))
        if self._has_header is None:
            self._has_header = bool(rows) and bool(rows[0]) and (
                str(rows[0][0]).strip().lower() in HEADER_TOKENS)
        return rows[1:] if (self._has_header and rows) else rows

    def _index_rows(self, rows: List[List[str]], num_workers: int) -> List[Tuple[str, str]]:
        if num_workers == -1:
            workers = os.cpu_count() or 4
        elif num_workers is None:
            workers = 8
        else:
            workers = max(1, num_workers)
        bar = progress(enabled=self._verbose, total=len(rows), desc="indexing dataset",
                       unit="row", leave=False)
        with bar:
            if workers > 1 and len(rows) > 256:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    screened = list(pool.map(self._screen_row, rows))
            else:
                screened = [self._screen_row(r) for r in rows]
            bar.update(len(rows))
        return [s for s in screened if s is not None]

    def _screen_row(self, row: List[str]) -> Optional[Tuple[str, str]]:
        """One row -> (path, label), or None under the first reason that
        rejects it (the order is part of the contract)."""
        if len(row) < 2:
            self._audit.note("bad_row", row)
            return None
        fname = _clean_filename(row[0])
        label = _clean_label(row[1])
        if not fname:
            self._audit.note("empty_fname", row)
            return None
        if label == "":
            self._audit.note("empty_label", fname)
            return None
        if self._strict_charset:
            foreign = [c for c in label if c not in self.stoi]
            if foreign:
                uniq = "".join(sorted(set(foreign)))[:20]
                self._audit.note("charset", (fname, label[:50], uniq), missing_chars=foreign)
                return None
        if self._strict_max_len and self._max_len is not None:
            if self._usable_length(label) > self._max_len:
                self._audit.note("too_long", (fname, len(label), f"eff>{self._max_len}"))
                return None
        path = self._locate_image(fname)
        if path is None or not os.path.exists(path):
            self._audit.note("missing_path", fname)
            return None
        return path, label

    def sample_path(self, idx: int) -> str:
        return self.samples[idx][0]

    def sample_label(self, idx: int) -> str:
        return self.samples[idx][1]

    def _usable_length(self, label: str) -> int:
        if not self._strict_charset:
            return len(label)
        return sum(c in self.stoi for c in label)

    def _locate_image(self, fname: str) -> Optional[str]:
        """Absolute path -> join with each root -> basename-index fallback."""
        if os.path.isabs(fname) and os.path.exists(fname):
            return fname
        roots = [self.images_dir] if isinstance(self.images_dir, str) else self.images_dir
        for root in roots:
            if root and os.path.exists(os.path.join(root, fname)):
                return os.path.join(root, fname)
        matches = self._file_index.get(os.path.basename(fname).lower(), [])
        if not matches:
            return None
        if len(matches) > 1:
            self._audit.note("ambiguous", (fname, matches[:3]))
        return matches[0]


class SubsetDataset:
    """A view of a dataset restricted to some indices, with a transform of
    its own."""

    def __init__(self, dataset, indices: Sequence[int], transform: Optional[Callable] = None):
        self.dataset = dataset
        self.indices = list(indices)
        self.transform = transform

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.fetch(idx)

    def fetch(self, idx: int, transform=None, rng=None):
        """The parent's sample through ``transform``, else the subset's own."""
        return self.dataset.fetch(self.indices[idx], transform=transform or self.transform,
                                  rng=rng)

    def sample_path(self, idx: int) -> str:
        return self.dataset.sample_path(self.indices[idx])

    def sample_label(self, idx: int) -> str:
        return self.dataset.sample_label(self.indices[idx])


def random_split(dataset, n_train: int, n_val: int, seed: int = 42
                 ) -> Tuple[SubsetDataset, SubsetDataset]:
    """Deterministic random train/val split (``default_rng(seed).permutation``)."""
    if n_train + n_val > len(dataset):
        raise ValueError("split sizes exceed dataset length")
    perm = np.random.default_rng(seed).permutation(len(dataset))
    return (SubsetDataset(dataset, perm[:n_train].tolist()),
            SubsetDataset(dataset, perm[n_train : n_train + n_val].tolist()))


class MultiDataset:
    """Indexes a list of datasets by ``(ds_idx, sample_idx)`` tuples."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)

    def __getitem__(self, index):
        return self.fetch(index)

    def fetch(self, index, transform=None, rng=None):
        ds_idx, sample_idx = index
        return self.datasets[ds_idx].fetch(sample_idx, transform=transform, rng=rng)

    def sample_path(self, index) -> str:
        ds_idx, sample_idx = index
        return self.datasets[ds_idx].sample_path(sample_idx)

    def sample_label(self, index) -> str:
        ds_idx, sample_idx = index
        return self.datasets[ds_idx].sample_label(sample_idx)

    def __len__(self) -> int:
        return sum(len(ds) for ds in self.datasets)


class ConcatDataset:
    """Concatenation of datasets under one flat index."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _locate(self, idx: int) -> Tuple[int, int]:
        if idx < 0:
            idx += len(self)
        ds = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return ds, idx - int(self._offsets[ds])

    def __getitem__(self, idx: int):
        return self.fetch(idx)

    def fetch(self, idx: int, transform=None, rng=None):
        ds, local = self._locate(idx)
        return self.datasets[ds].fetch(local, transform=transform, rng=rng)

    def sample_path(self, idx: int) -> str:
        ds, local = self._locate(idx)
        return self.datasets[ds].sample_path(local)

    def sample_label(self, idx: int) -> str:
        ds, local = self._locate(idx)
        return self.datasets[ds].sample_label(local)

    @property
    def transform(self):
        """The members' shared transform (None when they differ)."""
        first = getattr(self.datasets[0], "transform", None) if self.datasets else None
        for d in self.datasets[1:]:
            if getattr(d, "transform", None) is not first:
                return None
        return first


def exact_quotas(batch_size: int, proportions) -> List[int]:
    """Per-dataset batch quotas summing exactly to ``batch_size``
    (largest-remainder apportionment)."""
    floors = [int(batch_size * p) for p in proportions]
    remainders = [batch_size * p - f for p, f in zip(proportions, floors)]
    short = batch_size - sum(floors)
    for i in sorted(range(len(proportions)), key=lambda i: -remainders[i])[:short]:
        floors[i] += 1
    return floors


class ProportionalBatchSampler:
    """Batches mixing K datasets at fixed per-batch quotas: one endless
    shuffled stream per dataset (a pass finishes before the reshuffle);
    epoch length = the fewest full quota batches any weighted dataset holds;
    yields shuffled lists of ``(ds_idx, sample_idx)``."""

    def __init__(self, datasets, batch_size: int, proportions, seed: Optional[int] = None):
        if abs(sum(proportions) - 1.0) >= 1e-6:
            raise ValueError("proportions must sum to 1")
        self.datasets = list(datasets)
        self.batch_size = batch_size
        self.proportions = list(proportions)
        self._rng = np.random.default_rng(seed)
        self._quotas = exact_quotas(batch_size, proportions)
        self._streams = [self._endless_shuffle(len(ds)) for ds in self.datasets]

    def _endless_shuffle(self, n: int) -> Iterator[int]:
        while True:
            for i in self._rng.permutation(n):
                yield int(i)

    def __iter__(self):
        for _ in range(len(self)):
            batch = [(ds_idx, next(stream))
                     for ds_idx, (quota, stream) in enumerate(zip(self._quotas, self._streams))
                     for _ in range(quota)]
            order = self._rng.permutation(len(batch))
            yield [batch[i] for i in order]

    def __len__(self) -> int:
        return min(len(ds) // max(1, quota)
                   for ds, quota, prop in zip(self.datasets, self._quotas, self.proportions)
                   if prop > 0)


class ShuffleBatchSampler:
    """Plain shuffled batching over one dataset (the last batch may be short)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        order = (self._rng.permutation(len(self.dataset)) if self.shuffle
                 else np.arange(len(self.dataset)))
        for i in range(0, len(order), self.batch_size):
            yield [int(j) for j in order[i : i + self.batch_size]]

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size
