"""Batch assembly, the threaded loader, and width bucketing.

Counterpart of ``rcnn_ocr_tpu/data/loader.py`` (``collate_batch``,
``DataLoader``, ``BucketBatch``, ``BucketedBatchSampler``,
``BucketedProportionalBatchSampler``, ``bucket_for_width``,
``scaled_width``, ``assign_width_buckets``, ``optimal_width_buckets``,
``probe_scaled_widths``, ``lift_buckets_for_ctc``,
``probe_dataset_buckets``, ``ProcessShardedBatchSampler``):

* ``collate_batch``: (image, label) pairs become one fixed-shape NHWC batch
  of numpy arrays with packed targets; a short batch is padded to
  ``batch_size`` by repeating its rows, and ``valid`` marks the real ones;
* ``DataLoader``: ``num_workers`` threads decode and transform the samples
  of a batch, one prefetch thread assembles and queues up to ``prefetch``
  batches, a producer's error is raised in the consumer.  Each sample's
  transform gets its own ``numpy`` Generator seeded from ``(seed, epoch,
  batch, row)``, so host augmentation repeats run to run (set the epoch
  with :meth:`DataLoader.set_epoch`); ``row`` is the global row, so a rank
  that holds block ``shard_index`` of each global batch draws what one
  process draws for those rows.  ``wait_seconds`` is the time the last pass
  spent blocked on the queue;
* width buckets: a handful of static widths, chosen by a waste-minimizing
  DP (``optimal_width_buckets``) and lifted until a CTC label fits its
  bucket's time axis (``lift_buckets_for_ctc``); bucketed samplers draw from
  ``default_rng(seed)`` exactly as JAX's do;
* ``ProcessShardedBatchSampler``: one rank's contiguous block of every
  global batch of a replicated sampler (data parallelism across processes).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rcnn_ocr_tpu_torch.data.dataset import exact_quotas
from rcnn_ocr_tpu_torch.data.image_io import UnsupportedImageFormat, image_size
from rcnn_ocr_tpu_torch.vocab.charset import Charset, pack_attention_targets, pack_ctc_targets


class BucketBatch:
    """A batch's index list tagged with its static padded width."""

    __slots__ = ("width", "indices")

    def __init__(self, width: int, indices: List):
        self.width = int(width)
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __iter__(self):
        return iter(self.indices)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return BucketBatch(self.width, self.indices[key])
        return self.indices[key]


def collate_batch(items: Sequence, charset: Charset, max_len: int,
                  batch_size: Optional[int] = None, with_ctc: bool = False) -> Dict[str, object]:
    """Stack (image, label) pairs: ``image`` (uint8 kept, else float32),
    ``text_in``, ``target_y``, ``lengths``, ``valid``, ``labels`` (strings)
    and, with ``with_ctc``, ``ctc_labels`` and ``ctc_paddings``."""
    imgs, labels = zip(*items)
    n_real = len(imgs)
    images = np.stack(imgs)
    if images.dtype != np.uint8:
        images = images.astype(np.float32)
    valid = np.ones((n_real,), dtype=np.bool_)
    labels = list(labels)
    if batch_size is not None and n_real < batch_size:
        pad_idx = np.arange(batch_size - n_real) % n_real
        images = np.concatenate([images, images[pad_idx]], axis=0)
        labels = labels + [labels[i] for i in pad_idx]
        valid = np.concatenate([valid, np.zeros((len(pad_idx),), dtype=np.bool_)])
    text_in, target_y, lengths = pack_attention_targets(labels, charset.stoi, max_len)
    batch = {"image": images, "text_in": text_in, "target_y": target_y, "lengths": lengths,
             "valid": valid, "labels": labels}
    if with_ctc:
        batch["ctc_labels"], batch["ctc_paddings"] = pack_ctc_targets(labels, charset, max_len)
    return batch


class DataLoader:
    """Threaded batch loader over a dataset and a batch sampler."""

    def __init__(self, dataset, batch_sampler: Iterable[List], charset: Charset, max_len: int,
                 num_workers: int = 0, static_batch_size: Optional[int] = None,
                 with_ctc: bool = False, prefetch: int = 2, drop_invalid: bool = True,
                 bucket_of: Optional[Sequence[int]] = None,
                 transform_for_width: Optional[Callable] = None,
                 cache_dir: Optional[str] = None, seed: int = 0, shard_index: int = 0):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.charset = charset
        self.max_len = max_len
        self.num_workers = max(0, num_workers)
        self.static_batch_size = static_batch_size
        self.with_ctc = with_ctc
        self.prefetch = max(1, prefetch)
        self.drop_invalid = drop_invalid
        if (bucket_of is None) != (transform_for_width is None):
            raise ValueError("bucket_of and transform_for_width must be given together")
        self.bucket_of = bucket_of
        self._transform_for_width = transform_for_width
        self._bucket_transforms: dict = {}
        self.cache_dir = cache_dir
        self._disk_caches: dict = {}
        self.seed = int(seed)
        self.shard_index = int(shard_index)
        self.epoch = 0
        self.wait_seconds = 0.0

    def set_epoch(self, epoch: int) -> None:
        """The epoch that seeds the next pass's per-sample generators."""
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.batch_sampler)  # type: ignore[arg-type]

    def _disk_cache(self, transform):
        if self.cache_dir is None:
            return None
        eff = transform if transform is not None else getattr(self.dataset, "transform", None)
        key = getattr(eff, "cache_key", None)
        if key is None:
            return None
        if key not in self._disk_caches:
            from rcnn_ocr_tpu_torch.data.cache import TransformCache

            self._disk_caches[key] = TransformCache(self.dataset, eff, self.cache_dir)
        return self._disk_caches[key]

    def _bucket_transform(self, width: int):
        if width not in self._bucket_transforms:
            self._bucket_transforms[width] = self._transform_for_width(width)
        return self._bucket_transforms[width]

    def _fetch(self, idx, transform, rng: np.random.Generator):
        def fetch_fn():
            return self.dataset.fetch(idx, transform=transform, rng=rng)

        try:
            cache = self._disk_cache(transform)
            return cache.fetch(idx, fetch_fn) if cache is not None else fetch_fn()
        except UnsupportedImageFormat:
            raise
        except Exception:  # noqa: BLE001 - a bad sample drops out of its batch
            if self.drop_invalid:
                return None
            raise

    def _make_batch(self, batch_no: int, indices, pool: Optional[ThreadPoolExecutor]):
        transform = None
        if isinstance(indices, BucketBatch):
            transform = self._bucket_transform(indices.width)
            indices = indices.indices
        elif self.bucket_of is not None:
            transform = self._bucket_transform(self.bucket_of[indices[0]])
        first = self.shard_index * len(indices)  # the block's first global row
        rngs = [np.random.default_rng([self.seed, self.epoch, batch_no, first + row])
                for row in range(len(indices))]
        if pool is not None:
            items = list(pool.map(lambda a: self._fetch(a[0], transform, a[1]),
                                  zip(indices, rngs)))
        else:
            items = [self._fetch(i, transform, r) for i, r in zip(indices, rngs)]
        items = [it for it in items if it is not None]
        if not items:
            return None
        return collate_batch(items, self.charset, self.max_len,
                             batch_size=self.static_batch_size, with_ctc=self.with_ctc)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        pool = ThreadPoolExecutor(self.num_workers) if self.num_workers > 0 else None
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        producer_error: List[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():  # a bounded put that notices an early break
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch_no, indices in enumerate(self.batch_sampler):
                    if stop.is_set():
                        return
                    batch = self._make_batch(batch_no, indices, pool)
                    if batch is not None and not put(batch):
                        return
            except BaseException as e:  # noqa: BLE001 - raised in the consumer below
                producer_error.append(e)
            finally:
                put(sentinel)

        self.wait_seconds = 0.0
        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                batch = q.get()
                self.wait_seconds += time.perf_counter() - t0
                if batch is sentinel:
                    if producer_error:
                        raise producer_error[0]
                    break
                yield batch
        finally:
            stop.set()
            thread.join(timeout=2.0)
            if pool is not None:
                pool.shutdown(wait=False)


def bucket_for_width(width: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= width (the largest bucket when none fits)."""
    for b in sorted(buckets):
        if width <= b:
            return int(b)
    return int(max(buckets))


def scaled_width(h: int, w: int, img_h: int) -> int:
    """Width of an (h, w) image after height-normalizing to ``img_h`` (the
    one rounding every bucketing site uses)."""
    return max(1, int(round(w * (img_h / max(h, 1)))))


def assign_width_buckets(sizes: Sequence, img_h: int, buckets: Sequence[int]) -> List[int]:
    """The padded width bucket of each (h, w) image after height-normalizing."""
    return [bucket_for_width(scaled_width(h, w, img_h), buckets) for h, w in sizes]


def optimal_width_buckets(scaled_widths: Sequence[int], k: int, multiple: int = 8,
                          max_width: Optional[int] = None) -> List[int]:
    """At most ``k`` bucket widths (multiples of ``multiple``) minimizing the
    total right-pad waste ``sum(bucket(w) - w)``: an exact DP over the
    sorted unique widths, each group padded to its largest; ``max_width``
    clamps every width first and every bucket after rounding."""

    def up(w: int) -> int:
        return ((max(int(w), 1) + multiple - 1) // multiple) * multiple

    widths = [max(1, int(w)) for w in scaled_widths]
    if max_width is not None:
        widths = [min(w, int(max_width)) for w in widths]
    if not widths or k <= 0:
        raise ValueError("need at least one width and k >= 1")
    uniq = sorted(set(widths))
    counts = [widths.count(u) for u in uniq]
    u = len(uniq)
    if u <= k:
        return [up(x) for x in uniq]
    pref_n = [0] * (u + 1)
    pref_wsum = [0] * (u + 1)
    for i in range(u):
        pref_n[i + 1] = pref_n[i] + counts[i]
        pref_wsum[i + 1] = pref_wsum[i] + counts[i] * uniq[i]

    def cost(i: int, j: int) -> int:  # uniq[i..j] padded to up(uniq[j])
        return up(uniq[j]) * (pref_n[j + 1] - pref_n[i]) - (pref_wsum[j + 1] - pref_wsum[i])

    inf = float("inf")
    dp = [[inf] * u for _ in range(k + 1)]
    cut = [[-1] * u for _ in range(k + 1)]
    for j in range(u):
        dp[1][j] = cost(0, j)
    for g in range(2, k + 1):
        for j in range(g - 1, u):
            for m in range(g - 2, j):
                c = dp[g - 1][m] + cost(m + 1, j)
                if c < dp[g][j]:
                    dp[g][j] = c
                    cut[g][j] = m
    best_g = min(range(1, k + 1), key=lambda g: dp[g][u - 1])
    bounds = []
    g, j = best_g, u - 1
    while g >= 1:
        bounds.append(j)
        j = cut[g][j]
        g -= 1
    buckets = {up(uniq[b]) for b in bounds}
    if max_width is not None:
        buckets = {min(b, int(max_width)) for b in buckets}
    return sorted(buckets)


def probe_scaled_widths(dataset, img_h: int, num_workers: int = 8) -> List[int]:
    """Height-normalized width of every sample, from the file headers."""
    paths = [dataset.sample_path(i) for i in range(len(dataset))]
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        sizes = list(pool.map(image_size, paths))
    return [scaled_width(h, w, img_h) for h, w in sizes]


def lift_buckets_for_ctc(dataset, bucket_of: Sequence[int], charset, max_len: int,
                         buckets: Sequence[int], time_downsample: int = 8) -> List[int]:
    """Raise each sample's bucket until its CTC label fits: an alignment
    needs ``len(label) + adjacent repeats`` of the bucket's ``W /
    time_downsample`` frames (the widest bucket when none fits; the CTC loss
    masks those rows)."""
    blank = charset.ctc_blank_id
    out = list(bucket_of)
    for i in range(len(dataset)):
        ids = [t for t in charset.encode(dataset.sample_label(i)) if t != blank][:max_len]
        reps = sum(a == b for a, b in zip(ids, ids[1:]))
        need_w = (len(ids) + reps) * time_downsample
        if need_w > out[i]:
            out[i] = bucket_for_width(need_w, buckets)
    return out


def probe_dataset_buckets(dataset, img_h: int, buckets: Sequence[int],
                          num_workers: int = 8) -> List[int]:
    """Every sample's width bucket from its header-probed size."""
    scaled = probe_scaled_widths(dataset, img_h, num_workers=num_workers)
    return [bucket_for_width(w, buckets) for w in scaled]


class BucketedProportionalBatchSampler:
    """Proportional mixing of datasets where every batch is single-bucket.

    * ``quota_mode="expected"``: each batch's per-dataset counts follow that
      dataset's mass in the drawn bucket (``count_d ∝ prop_d · |pool[d][b]| /
      |dataset_d|``, rounded systematically so the expectation is exact); no
      sample leaves its bucket;
    * ``quota_mode="batch"``: exactly ``exact_quotas`` rows per dataset in
      every batch; a dataset with no samples in the drawn bucket fills its
      quota from its nearest non-empty bucket.

    One endless shuffled stream per non-empty (dataset, bucket) pool; the
    bucket of a batch is drawn with probability ∝ ``Σ_d prop_d ·
    |pool[d][b]| / |dataset_d|``; yields :class:`BucketBatch`; the epoch
    length is :class:`ProportionalBatchSampler`'s.
    """

    def __init__(self, datasets, batch_size: int, proportions,
                 bucket_ofs: Sequence[Sequence[int]], seed: Optional[int] = None,
                 quota_mode: str = "expected"):
        if quota_mode not in ("expected", "batch"):
            raise ValueError(f"quota_mode must be 'expected' or 'batch', got {quota_mode!r}")
        if abs(sum(proportions) - 1.0) >= 1e-6:
            raise ValueError("proportions must sum to 1")
        if len(bucket_ofs) != len(datasets):
            raise ValueError("bucket_ofs must align with datasets")
        self.datasets = list(datasets)
        self.batch_size = batch_size
        self.proportions = list(proportions)
        self.quota_mode = quota_mode
        self._rng = np.random.default_rng(seed)
        self._quotas = exact_quotas(batch_size, proportions)
        self.buckets = sorted({int(b) for bo in bucket_ofs for b in bo})
        self._pools: List[Dict[int, np.ndarray]] = []
        for bo in bucket_ofs:
            arr = np.asarray(list(bo), dtype=np.int64)
            pools = {}
            for b in self.buckets:
                members = np.nonzero(arr == b)[0]
                if len(members):
                    pools[b] = members
            self._pools.append(pools)

        def bucket_weights(b: int) -> np.ndarray:
            return np.array([p * len(pools.get(b, ())) / max(1, len(ds))
                             for p, pools, ds in zip(self.proportions, self._pools, self.datasets)])

        mass = np.array([bucket_weights(b).sum() for b in self.buckets])
        if mass.sum() <= 0:
            raise ValueError("no samples in any bucket")
        self._bucket_p = mass / mass.sum()
        self._streams: List[Dict[int, Iterator[int]]] = [
            {b: self._endless_shuffle(members) for b, members in pools.items()}
            for pools in self._pools]
        self._bucket_raw: Dict[int, np.ndarray] = {}
        if quota_mode == "expected":
            for b in self.buckets:
                weights = bucket_weights(b)
                if weights.sum() > 0:
                    self._bucket_raw[b] = weights / weights.sum() * batch_size
        self.bucket_of: Dict[Tuple[int, int], int] = {
            (d, int(i)): int(b) for d, bo in enumerate(bucket_ofs) for i, b in enumerate(bo)}

    def _endless_shuffle(self, members: np.ndarray) -> Iterator[int]:
        while True:
            for i in self._rng.permutation(len(members)):
                yield int(members[i])

    def _nearest_pool(self, d: int, bucket: int) -> int:
        """Nearest non-empty bucket of dataset ``d`` (ties -> smaller)."""
        return min(sorted(self._pools[d]), key=lambda b: (abs(b - bucket), b))

    def _systematic_round(self, raw: np.ndarray) -> np.ndarray:
        """Integer rounding of ``raw`` that keeps its sum and its expectation:
        floors, then the remaining slots by systematic sampling on the
        fractional parts."""
        base = np.floor(raw)
        short = int(round(raw.sum() - base.sum()))
        if short > 0:
            pts = self._rng.uniform() + np.arange(short)
            hit = np.searchsorted(np.cumsum(raw - base), pts, side="right")
            base[np.minimum(hit, len(base) - 1)] += 1
        return base.astype(int)

    def __iter__(self):
        for _ in range(len(self)):
            bucket = int(self._rng.choice(np.asarray(self.buckets), p=self._bucket_p))
            quotas = (self._systematic_round(self._bucket_raw[bucket])
                      if self.quota_mode == "expected" else self._quotas)
            rows: List[Tuple[int, int]] = []
            for d, quota in enumerate(quotas):
                if quota <= 0:
                    continue
                stream = (self._streams[d].get(bucket)
                          or self._streams[d][self._nearest_pool(d, bucket)])
                rows.extend((d, next(stream)) for _ in range(quota))
            order = self._rng.permutation(len(rows))
            yield BucketBatch(bucket, [rows[i] for i in order])

    def __len__(self) -> int:
        return min(len(ds) // max(1, quota)
                   for ds, quota, prop in zip(self.datasets, self._quotas, self.proportions)
                   if prop > 0)


class BucketedBatchSampler:
    """Batches from one width bucket each: shuffle within buckets, chunk
    (the last chunk of a bucket may be short), then shuffle the batch order."""

    def __init__(self, bucket_of: Sequence[int], batch_size: int, shuffle: bool = True,
                 seed: Optional[int] = None):
        self.bucket_of = list(bucket_of)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._groups: Dict[int, np.ndarray] = {}
        for width in sorted(set(self.bucket_of)):
            self._groups[width] = np.asarray(
                [i for i, w in enumerate(self.bucket_of) if w == width], dtype=np.int64)

    def __iter__(self) -> Iterator[BucketBatch]:
        batches: List[BucketBatch] = []
        for width, members in self._groups.items():
            order = (self._rng.permutation(len(members)) if self.shuffle
                     else np.arange(len(members)))
            shuffled = members[order]
            for i in range(0, len(shuffled), self.batch_size):
                batches.append(BucketBatch(width, [int(j) for j in shuffled[i : i + self.batch_size]]))
        if self.shuffle:
            batches = [batches[i] for i in self._rng.permutation(len(batches))]
        return iter(batches)

    def __len__(self) -> int:
        return sum((len(m) + self.batch_size - 1) // self.batch_size
                   for m in self._groups.values())


class ProcessShardedBatchSampler:
    """One rank's view of a replicated global batch sampler (data parallelism).

    Every rank builds the same underlying sampler (same seed), so the global
    batch sequence is common knowledge; rank ``p`` of ``P`` keeps rows
    ``[p*B/P, (p+1)*B/P)`` of each global batch.  A :class:`BucketBatch`
    keeps its width tag.  Rows a P-way split cannot place (``len % P``) carry
    into the next batch of the same width; at the end of an epoch at most
    ``P - 1`` rows per width stay unplaced.  A copy of
    ``rcnn_ocr_tpu/data/loader.py:ProcessShardedBatchSampler``.
    """

    def __init__(self, sampler, process_index: int, process_count: int):
        if not 0 <= process_index < process_count:
            raise ValueError("process_index out of range")
        self.sampler = sampler
        self.pidx = process_index
        self.pcount = process_count

    @staticmethod
    def _parts(batch):
        if isinstance(batch, BucketBatch):
            return batch.width, list(batch.indices)
        return None, list(batch)

    def _emit(self, width, rows):
        per = len(rows) // self.pcount
        local = rows[self.pidx * per:(self.pidx + 1) * per]
        return BucketBatch(width, local) if width is not None else local

    def __iter__(self):
        carries: dict = {}
        for batch in self.sampler:
            width, rows = self._parts(batch)
            rows = carries.pop(width, []) + rows
            placeable = (len(rows) // self.pcount) * self.pcount
            if placeable == 0:
                carries[width] = rows
                continue
            carries[width] = rows[placeable:]
            yield self._emit(width, rows[:placeable])
        for width, rows in carries.items():
            placeable = (len(rows) // self.pcount) * self.pcount
            if placeable:
                yield self._emit(width, rows[:placeable])

    def __len__(self) -> int:
        # advisory (progress bars): the carry can add one batch per width
        return len(self.sampler)  # type: ignore[arg-type]
