"""Unbounded-width (long-line) decoding: tile, trim, stitch.

Counterpart of ``rcnn_ocr_tpu/long_lines.py``.  A fixed-width decode squashes
a line into one canvas; a long line instead is height-normalized, cut into
overlapping ``tile_w``-wide tiles (one static shape), decoded tile by tile in
batches, and put back together:

* CTC (``predict_ctc_long``): each junction's overlap frames are split
  (:func:`long_line_spans`, at the midpoint or the most blank-dominant
  frame) and the stitched frame sequence is collapsed greedily or by the
  host prefix beam, as if from one wide encoder pass;
* hybrid (``predict_hybrid_long``): the stitched CTC frames locate
  character groups (:func:`segment_spans`), each cropped from the
  height-normalized line at full resolution and read by the attention head;
* attention (``predict_long``): each tile decoded by the attention head and
  the junctions merged by the attention alignment (``merge="align"``) or in
  text space (``merge="text"``).

The pure functions here are held to JAX's one for one; :class:`LongLineMixin`
is mixed into :class:`rcnn_ocr_tpu_torch.inference.OCRInference` and calls its
decode kernels.  Height normalization is the port's ``resize_uint8`` (cv2's
INTER_AREA / INTER_LINEAR within one uint8 step), not cv2.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rcnn_ocr_tpu_torch.data.loader import scaled_width
from rcnn_ocr_tpu_torch.data.transforms import ResizeAndPad, resize_uint8
from rcnn_ocr_tpu_torch.models.rcnn import TIME_DOWNSAMPLE
from rcnn_ocr_tpu_torch.ops.ctc import ctc_beam_search, ctc_greedy_collapse_np, ids_to_text
from rcnn_ocr_tpu_torch.postprocess import pad_rows
from rcnn_ocr_tpu_torch.training.metrics import levenshtein
from rcnn_ocr_tpu_torch.vocab.charset import decode_tokens


def _host(x) -> np.ndarray:
    """A kernel's output (a tensor on any device, or an array) on the host."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def long_line_spans(starts: Sequence[int], tile_w: int, frames_t: int,
                    blank_scores: Optional[np.ndarray] = None) -> List[Tuple[int, int, int]]:
    """Per tile, the ``(tile_index, frame_from, frame_to)`` it keeps.

    ``starts`` are the tiles' x-offsets in the height-normalized line
    (increasing, neighbours overlapping).  Each junction's overlap is split
    so every encoder frame of the line is kept once (up to stride rounding):
    at the overlap midpoint, or with ``blank_scores [n_tiles, frames_t]``
    (per-frame blank log-probs) at the most blank-dominant shared frame.
    Cuts are kept monotone, so overlaps above ``tile_w / 2`` never keep a
    frame twice.
    """
    stride = tile_w / frames_t
    cuts: List[int] = []  # per junction: the global cut frame (left keeps < cut)
    for j in range(1, len(starts)):
        g_right = starts[j] / stride  # the right tile's first global frame
        g_left_end = starts[j - 1] / stride + frames_t
        lo = int(np.ceil(g_right)) + 1  # keep >= 1 frame in the right tile
        hi = int(np.floor(g_left_end)) - 1  # and >= 1 in the left
        mid = int(round((g_right + g_left_end) / 2))
        cut = min(max(mid, lo), hi)
        if blank_scores is not None and hi > lo:
            g0 = int(round(starts[j - 1] / stride))
            g1 = int(round(g_right))
            best, best_score = cut, -np.inf
            for g in range(lo, hi + 1):
                fl, fr = g - g0, g - g1  # the frame in the left / right tile
                score = 0.0
                if 0 <= fl < frames_t:
                    score += float(blank_scores[j - 1, fl])
                if 0 <= fr < frames_t:
                    score += float(blank_scores[j, fr])
                if score > best_score:
                    best, best_score = g, score
            cut = best
        if cuts:
            cut = max(cut, cuts[-1])
        cuts.append(cut)

    spans = []
    for j, s in enumerate(starts):
        g0 = int(round(s / stride))
        f_from = 0 if j == 0 else min(max(cuts[j - 1] - g0, 0), frames_t - 1)
        f_to = frames_t if j + 1 == len(starts) else min(max(cuts[j] - g0, f_from + 1), frames_t)
        spans.append((j, f_from, f_to))
    return spans


def height_normalize(rgb: np.ndarray, img_h: int) -> np.ndarray:
    """Aspect-preserving resize to ``img_h`` rows: INTER_AREA when either
    side shrinks, else INTER_LINEAR (``resize_uint8``)."""
    h, w = rgb.shape[:2]
    return resize_uint8(rgb, img_h, scaled_width(h, w, img_h))


def plan_tiles(rgb_images: List[np.ndarray], img_h: int, tile_w: int, overlap: int, pad_one,
               keep_resized: bool = False):
    """Height-normalize and tile decoded RGB images.

    An image whose scaled width fits one tile takes ``pad_one`` (the
    ordinary resize-pad), so a short line decodes as the fixed-width engine
    decodes it.  Returns the flat tile list and, per image, ``(first tile
    index, tile start offsets)``; with ``keep_resized`` also the
    height-normalized images (the hybrid decode crops from them), and the
    one-tile canvases are then built from those (equal to ``pad_one``'s)."""
    tiles: List[np.ndarray] = []
    plans: List[Tuple[int, List[int]]] = []
    resized_images: List[np.ndarray] = []
    for rgb in rgb_images:
        h, w = rgb.shape[:2]
        new_w = scaled_width(h, w, img_h)
        if new_w <= tile_w:
            plans.append((len(tiles), [0]))
            if keep_resized:
                resized = height_normalize(rgb, img_h)
                resized_images.append(resized)
                canvas = np.full((img_h, tile_w, 3), 255, dtype=resized.dtype)
                canvas[:, : resized.shape[1]] = resized
                tiles.append(canvas)
            else:
                tiles.append(pad_one(rgb))
            continue
        resized = height_normalize(rgb, img_h)
        if keep_resized:
            resized_images.append(resized)
        starts = list(range(0, new_w - tile_w, tile_w - overlap))
        if starts[-1] != new_w - tile_w:
            starts.append(new_w - tile_w)  # right-aligned final tile
        plans.append((len(tiles), starts))
        tiles.extend(resized[:, s : s + tile_w] for s in starts)
    if keep_resized:
        return tiles, plans, resized_images
    return tiles, plans


def resolve_tiling(img_w: int, tile_w: Optional[int], overlap: Optional[int],
                   require_frame_aligned: bool = False) -> Tuple[int, int]:
    """Default and validate ``(tile_w, overlap)``: ``tile_w`` defaults to
    ``img_w``, ``overlap`` to ``min(64, tile_w // 2)``, and each tile must
    advance by at least one encoder frame.  The aligned attention merge
    computes frames as ``tile_w // TIME_DOWNSAMPLE`` and passes
    ``require_frame_aligned``: a ``tile_w`` that is no multiple is refused."""
    tile_w = int(tile_w or img_w)
    if require_frame_aligned and tile_w % TIME_DOWNSAMPLE != 0:
        raise ValueError(
            f"the aligned attention merge needs tile_w to be a multiple of "
            f"{TIME_DOWNSAMPLE} (the model's time downsample), got {tile_w}; "
            f"use merge='text' or pick an aligned tile_w"
        )
    overlap = int(overlap) if overlap is not None else min(64, tile_w // 2)
    if not 0 < overlap <= tile_w - TIME_DOWNSAMPLE:
        raise ValueError(
            f"overlap must be in (0, {tile_w - TIME_DOWNSAMPLE}] "
            f"(tile_w - one {TIME_DOWNSAMPLE}-px encoder frame) so every "
            f"tile contributes unique frames, got {overlap}"
        )
    return tile_w, overlap


def extract_tile_frames(tiles: List[np.ndarray], batch_size: int, run) -> Tuple[np.ndarray, np.ndarray]:
    """Run ``run(uint8 batch [B, H, W, 3]) -> (top-k vals, ids)`` over the
    tiles in static batches: ``(vals [n_tiles, T, k], ids [n_tiles, T, k])``."""
    all_vals: List[np.ndarray] = []
    all_idx: List[np.ndarray] = []
    for i in range(0, len(tiles), batch_size):
        chunk, n_real = pad_rows(tiles[i : i + batch_size], batch_size)
        vals, idx = run(np.stack(chunk))
        all_vals.append(_host(vals)[:n_real])
        all_idx.append(_host(idx)[:n_real])
    return np.concatenate(all_vals), np.concatenate(all_idx)


def extract_tile_ids(tiles: List[np.ndarray], batch_size: int, run, with_maxp: bool = False):
    """The argmax flavour of :func:`extract_tile_frames`: ``ids [n_tiles,
    T]``, and ``(ids, maxp)`` with ``with_maxp`` (``run`` then returns the
    per-frame max-softmax too)."""
    out: List[np.ndarray] = []
    out_p: List[np.ndarray] = []
    for i in range(0, len(tiles), batch_size):
        chunk, n_real = pad_rows(tiles[i : i + batch_size], batch_size)
        got = run(np.stack(chunk))
        if with_maxp:
            ids, maxp = got
            out_p.append(_host(maxp)[:n_real])
        else:
            ids = got
        out.append(_host(ids)[:n_real])
    if with_maxp:
        return np.concatenate(out), np.concatenate(out_p)
    return np.concatenate(out)


def merge_tile_texts(texts: List[str], tile_w: int, starts: Sequence[int]) -> str:
    """Merge adjacent tiles' texts in text space: both tiles read the shared
    pixels, so the right one's prefix repeats the left one's suffix.  Per
    junction the overlap length ``c`` maximizing ``c - 2 * edit_distance``
    wins (0: plain concatenation), capped by how many characters the shared
    pixels can hold at the two tiles' own characters per pixel."""
    merged = texts[0]
    for i in range(1, len(texts)):
        shared_px = starts[i - 1] + tile_w - starts[i]
        cpp = (len(texts[i - 1]) + len(texts[i])) / (2.0 * tile_w)
        max_c = int(np.ceil(shared_px * cpp * 1.5)) + 2
        right = texts[i]
        limit = min(max_c, len(merged), len(right))
        best_c, best_score = 0, 0.0
        for c in range(1, limit + 1):
            score = c - 2.0 * levenshtein(merged[len(merged) - c :], right[:c])
            if score > best_score:
                best_score, best_c = score, c
        merged = merged + right[best_c:]
    return merged


def stitch_frames(vals: np.ndarray, idx: np.ndarray, first: int, starts: Sequence[int],
                  tile_w: int, frames_t: int,
                  blank_lp: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """One image's tiles -> its line's top-k frames ``[T_line, k]`` (vals,
    ids), cut at the junctions of :func:`long_line_spans`."""
    scores = blank_lp[first : first + len(starts)] if blank_lp is not None else None
    spans = [(first + j, a, b) for j, a, b in long_line_spans(starts, tile_w, frames_t,
                                                              blank_scores=scores)]
    return (np.concatenate([vals[t, a:b] for t, a, b in spans]),
            np.concatenate([idx[t, a:b] for t, a, b in spans]))


def stitch_frame_ids(ids: np.ndarray, first: int, starts: Sequence[int], tile_w: int,
                     frames_t: int) -> np.ndarray:
    """Ids-only :func:`stitch_frames` at midpoint cuts: ``[T_line]``."""
    spans = long_line_spans(starts, tile_w, frames_t)
    return np.concatenate([ids[first + j, a:b] for j, a, b in spans])


def _emitted_frame_confidence(i_cat: np.ndarray, maxp_cat: np.ndarray, blank_id: int) -> float:
    """Mean max-softmax over the emitted (non-blank, non-repeat) frames of a
    stitched line; the mean over every frame when none is emitted."""
    keep = i_cat != blank_id
    keep[1:] &= i_cat[1:] != i_cat[:-1]
    if not keep.any():
        return float(maxp_cat.mean()) if maxp_cat.size else 1.0
    return float(maxp_cat[keep].mean())


def decode_stitched_ids(ids: np.ndarray, plans: List[Tuple[int, List[int]]], tile_w: int, *,
                        blank_id: int, itos: List[str], skip_ids,
                        maxp: Optional[np.ndarray] = None) -> List:
    """The greedy, midpoint path of :func:`decode_stitched` over argmax ids
    (the same text: the argmax is the top-1 of the top k).  With ``maxp``
    ``[n_tiles, T]`` each element is ``(text, confidence)``."""
    frames_t = ids.shape[1]
    results: List = []
    for first, starts in plans:
        i_cat = stitch_frame_ids(ids, first, starts, tile_w, frames_t)
        row = ctc_greedy_collapse_np(i_cat[None], blank_id)[0]
        text = ids_to_text([row], itos, skip_ids=skip_ids)[0]
        if maxp is not None:
            p_cat = stitch_frame_ids(maxp, first, starts, tile_w, frames_t)
            results.append((text, _emitted_frame_confidence(i_cat, p_cat, blank_id)))
        else:
            results.append(text)
    return results


def segment_spans(frame_ids: np.ndarray, blank_id: int, *, min_gap: int = 2, margin: int = 1,
                  max_frames: Optional[int] = None) -> List[Tuple[int, int]]:
    """Character-group frame spans of a CTC frame sequence ``[T]``.

    Maximal non-blank runs, merged across blank gaps shorter than
    ``min_gap`` frames, with ``margin`` frames of context each side (which
    may share blank frames with a neighbour but never its character
    frames); with ``max_frames`` each span is split at its interior blank
    nearest the middle (else the midpoint) and its margin trimmed, so no span
    exceeds ``max_frames`` margins included.
    """
    T = int(frame_ids.shape[0])
    nz = np.flatnonzero(np.asarray(frame_ids) != blank_id)
    if nz.size == 0:
        return []
    breaks = np.flatnonzero(np.diff(nz) > 1)
    runs = []
    start = 0
    for b in breaks:
        runs.append((int(nz[start]), int(nz[b]) + 1))
        start = b + 1
    runs.append((int(nz[start]), int(nz[-1]) + 1))
    merged = [runs[0]]
    for s, e in runs[1:]:
        if s - merged[-1][1] < min_gap:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))

    def split(s: int, e: int) -> List[Tuple[int, int]]:
        if max_frames is None or e - s <= max_frames:
            return [(s, e)]
        interior = np.flatnonzero(np.asarray(frame_ids[s + 1 : e - 1]) == blank_id)
        mid = (e - s) // 2
        cut = (s + 1 + int(interior[np.argmin(np.abs(interior - (mid - 1)))])
               if interior.size else s + mid)
        return split(s, cut) + split(cut, e)

    out: List[Tuple[int, int]] = []
    for s, e in merged:
        out.extend(split(s, e))
    padded: List[Tuple[int, int]] = []
    for i, (s, e) in enumerate(out):
        lo = max(0, s - margin, out[i - 1][1] if i else 0)
        hi = min(T, e + margin, out[i + 1][0] if i + 1 < len(out) else T)
        if max_frames is not None and hi - lo > max_frames:
            # trim margin frames only: the content run fits after the split
            excess = (hi - lo) - max_frames
            cut_hi = min(hi - e, (excess + 1) // 2)
            cut_lo = min(s - lo, excess - cut_hi)
            cut_hi = min(hi - e, excess - cut_lo)  # rebalance a short side
            lo += cut_lo
            hi -= cut_hi
        padded.append((lo, hi))
    return padded


def hybrid_decode_driver(rgb_images: List[np.ndarray], img_h: int, tile_w: int, overlap: int,
                         pad_one, batch_size: int, tile_fn, decode_fn, decode_row, blank_id: int,
                         min_gap: int, margin: int, return_confidence: bool = False):
    """Segment, then read: the stitched CTC frame ids of each line
    (``tile_fn(uint8 tiles) -> ids [B, T]``) give character groups
    (:func:`segment_spans`, at most one tile wide), each cropped from the
    height-normalized line (never wider than ``tile_w``), resize-padded by
    ``pad_one`` and decoded by ``decode_fn(uint8 batch) -> (tokens, aux)``;
    ``decode_row(tokens row, aux row | None)`` makes the text.  With
    ``return_confidence`` each result is ``(text, confidence)``, the
    segments' confidences weighted by their characters (0.0 with none)."""
    tiles, plans, resized = plan_tiles(rgb_images, img_h, tile_w, overlap, pad_one,
                                       keep_resized=True)
    ids = extract_tile_ids(tiles, batch_size, tile_fn)
    frames_t = ids.shape[1]
    stride = tile_w / frames_t  # px per frame

    crops: List[np.ndarray] = []
    crop_of_image: List[int] = []
    for img_i, (first, starts) in enumerate(plans):
        i_cat = stitch_frame_ids(ids, first, starts, tile_w, frames_t)
        full_w = resized[img_i].shape[1]
        for s, e in segment_spans(i_cat, blank_id, min_gap=min_gap, margin=margin,
                                  max_frames=frames_t):
            px_lo = max(0, int(s * stride))
            # at a fractional stride floor(lo) + round(hi) can reach tile_w + 1
            # px; a crop wider than the canvas would be shrunk by pad_one
            px_hi = min(full_w, int(round(e * stride)), px_lo + tile_w)
            if px_hi <= px_lo:
                continue
            crops.append(resized[img_i][:, px_lo:px_hi])
            crop_of_image.append(img_i)

    n = len(rgb_images)
    texts = [""] * n
    conf_num = [0.0] * n
    conf_den = [0] * n
    padded = [pad_one(c) for c in crops]
    for i in range(0, len(padded), batch_size):
        chunk, n_real = pad_rows(padded[i : i + batch_size], batch_size)
        pred, aux = decode_fn(np.stack(chunk))[:2]
        pred = _host(pred)[:n_real]
        aux = _host(aux)[:n_real] if return_confidence else None
        for j in range(n_real):
            img_i = crop_of_image[i + j]
            out = decode_row(pred[j], aux[j] if aux is not None else None)
            if return_confidence:
                text, conf = out
                if text:
                    conf_num[img_i] += conf * len(text)
                    conf_den[img_i] += len(text)
            else:
                text = out
            texts[img_i] += text
    if return_confidence:
        return [(t, conf_num[i] / conf_den[i] if conf_den[i] else 0.0)
                for i, t in enumerate(texts)]
    return texts


def stitch_aligned_rows(tokens: np.ndarray, aligns: np.ndarray, starts: Sequence[int],
                        tile_w: int, frames_t: int, *, eos_id: int, skip_ids,
                        itos: Sequence[str]) -> str:
    """The attention head's frame-aligned junction merge: each tile keeps
    the characters whose attention argmax (``aligns``) falls in its span of
    :func:`long_line_spans` (midpoint cuts), so each character is emitted
    once, by the tile that owns its x-position.  A row stops at EOS."""
    chars: List[str] = []
    for j, f_from, f_to in long_line_spans(starts, tile_w, frames_t):
        for tok, al in zip(tokens[j], aligns[j]):
            tok = int(tok)
            if tok == eos_id:
                break
            if tok in skip_ids or tok >= len(itos):
                continue
            if f_from <= int(al) < f_to:
                chars.append(itos[tok])
    return "".join(chars)


def decode_stitched(vals: np.ndarray, idx: np.ndarray, plans: List[Tuple[int, List[int]]],
                    tile_w: int, *, blank_id: int, num_classes: int, itos: List[str], skip_ids,
                    method: str = "greedy", beam_width: int = 16, snap: str = "midpoint",
                    return_confidence: bool = False) -> List:
    """Stitch each image's top-k tile frames (cuts at the overlap midpoint,
    or with ``snap="blank"`` at the most blank-dominant shared frame) and
    collapse the line greedily or by the host prefix beam over the frames
    rebuilt dense at -1e30.  Confidence: greedy, the emitted-frame mean
    max-softmax; beam, the winner's posterior among the final beams."""
    if snap not in ("blank", "midpoint"):
        raise ValueError(f"snap must be 'blank' or 'midpoint', got {snap!r}")
    frames_t = vals.shape[1]
    # per-tile per-frame blank log-prob (-inf where blank left the top k)
    blank_lp = np.where(idx == blank_id, vals, -np.inf).max(-1) if snap == "blank" else None
    results: List = []
    for first, starts in plans:
        v_cat, i_cat = stitch_frames(vals, idx, first, starts, tile_w, frames_t,
                                     blank_lp=blank_lp)
        conf = None
        if method == "greedy":
            row = ctc_greedy_collapse_np(i_cat[None, :, 0], blank_id)[0]
            if return_confidence:
                # slot 0 is the argmax: exp(top-1 log-prob) is the max-softmax
                conf = _emitted_frame_confidence(i_cat[:, 0], np.exp(v_cat[:, 0]), blank_id)
        else:
            dense = np.full((1, v_cat.shape[0], num_classes), -1e30, np.float32)
            np.put_along_axis(dense, i_cat[None].astype(np.int64), v_cat[None], -1)
            got = ctc_beam_search(dense, blank_id=blank_id, beam_width=beam_width,
                                  already_log_probs=True, return_totals=return_confidence)
            if return_confidence:
                conf = float(np.exp(got[1][0] - got[2][0]))
            row = got[0][0]
        text = ids_to_text([row], itos, skip_ids=skip_ids)[0]
        results.append((text, conf) if return_confidence else text)
    return results


class LongLineMixin:
    """``predict_ctc_long``, ``predict_hybrid_long`` and ``predict_long`` of
    ``OCRInference`` (``rcnn_ocr_tpu/long_lines.py:LongLineMixin``)."""

    def _plan(self, images, tile_w, overlap, require_frame_aligned=False):
        """The resolved tiling, the one-tile resize-pad and the decoded RGB lines."""
        tile_w, overlap = resolve_tiling(self.img_w, tile_w, overlap, require_frame_aligned)
        pad_one = ResizeAndPad(img_h=self.img_h, img_w=tile_w)
        rgb = [self._to_rgb(img) for img in images]
        return tile_w, overlap, pad_one, rgb

    def predict_ctc_long(self, images, tile_w: Optional[int] = None,
                         overlap: Optional[int] = None, batch_size: int = 32,
                         method: str = "greedy", beam_width: int = 16, prune_k: int = 16,
                         snap: str = "midpoint", return_confidence: bool = False):
        """Unbounded-width CTC decode: tiles of ``tile_w`` (default ``img_w``)
        overlapping by ``overlap`` px (default ``min(64, tile_w // 2)``),
        encoded in batches, their frames stitched at the junction cuts and
        the line collapsed greedily or by the host prefix beam.  A line that
        fits one tile decodes as ``predict_ctc`` decodes it.

        Greedy at midpoint cuts fetches only each frame's argmax id (and
        with ``return_confidence`` its max-softmax); the other modes fetch
        each frame's ``prune_k`` best log-probs.  Confidence: greedy, the
        mean max-softmax over the stitched line's emitted frames; beam, the
        winner's posterior among the final beams.
        """
        if not self.model.with_ctc_head:
            raise ValueError("this checkpoint has no CTC head")
        if method not in ("greedy", "beam"):
            raise ValueError(f"Unsupported decode method: {method}")
        is_single = not isinstance(images, list)
        images_list: List[Any] = [images] if is_single else list(images)
        if not images_list:
            return []
        tile_w, overlap, pad_one, rgb = self._plan(images_list, tile_w, overlap)
        tiles, plans = plan_tiles(rgb, self.img_h, tile_w, overlap, pad_one)
        skip = self._ctc_skip()
        blank = self.charset.ctc_blank_id
        if method == "greedy" and snap == "midpoint":
            kernel = self.tile_ids_kernel(with_maxp=return_confidence)
            got = extract_tile_ids(tiles, batch_size, lambda b: kernel(self._device_batch(b)),
                                   with_maxp=return_confidence)
            ids, maxp = got if return_confidence else (got, None)
            results = decode_stitched_ids(ids, plans, tile_w, blank_id=blank, itos=self._itos,
                                          skip_ids=skip, maxp=maxp)
            return results[0] if is_single else results
        kernel = self.tile_kernel(prune_k)
        vals, idx = extract_tile_frames(tiles, batch_size, lambda b: kernel(self._device_batch(b)))
        results = decode_stitched(vals, idx, plans, tile_w, blank_id=blank,
                                  num_classes=self.charset.num_classes, itos=self._itos,
                                  skip_ids=skip, method=method, beam_width=beam_width, snap=snap,
                                  return_confidence=return_confidence)
        return results[0] if is_single else results

    def predict_hybrid_long(self, images, tile_w: Optional[int] = None,
                            overlap: Optional[int] = None, batch_size: int = 32,
                            max_length: int = 25, beam: bool = False, beam_width: int = 16,
                            length_penalty: float = 0.0, lm_weight: float = 0.0,
                            prune_k: int = 16, min_gap: int = 3, margin: int = 1,
                            return_confidence: bool = False):
        """Hybrid unbounded-width decode (both heads): the CTC head's stitched
        frame ids locate character groups (:func:`segment_spans`, ``min_gap``
        and ``margin`` in frames), each cropped at full resolution and read by
        the attention head like a short line, greedily or with the beam
        (``beam``, with length penalty and fusion as ``predict``).
        ``prune_k`` is accepted as JAX's is and unused: the segmenter reads
        argmax ids.  Confidence: the segments' attention confidences
        weighted by their characters (0.0 for a line with none)."""
        if not (self.model.with_ctc_head and self.model.with_attention_head):
            raise ValueError("hybrid long-line decode needs BOTH heads")
        is_single = not isinstance(images, list)
        images_list: List[Any] = [images] if is_single else list(images)
        if not images_list:
            return []
        tile_w, overlap, pad_one, rgb = self._plan(images_list, tile_w, overlap)
        tile = self.tile_ids_kernel()
        steps = max_length + 1
        run = (self._attn_beam_fn(steps, int(beam_width), length_penalty, lm_weight) if beam
               else self._greedy_fn(steps))
        row_fn = self._decode_beam_row if beam else self._decode_attention_row
        texts = hybrid_decode_driver(
            rgb, self.img_h, tile_w, overlap, pad_one, batch_size,
            tile_fn=lambda b: tile(self._device_batch(b)),
            decode_fn=lambda b: run(self._device_batch(b)),
            decode_row=lambda pred, aux: row_fn(pred, aux, return_confidence),
            blank_id=self.charset.ctc_blank_id, min_gap=min_gap, margin=margin,
            return_confidence=return_confidence,
        )
        return texts[0] if is_single else texts

    def predict_long(self, images, method: str = "attention", tile_w: Optional[int] = None,
                     overlap: Optional[int] = None, batch_size: int = 32, max_length: int = 25,
                     beam_width: int = 16, length_penalty: float = 0.0, lm_weight: float = 0.0,
                     prune_k: int = 16, snap: str = "midpoint", merge: str = "align",
                     return_confidence: bool = False):
        """Unbounded-width decode for every head, one entry point.

        ``ctc_greedy`` / ``ctc_beam`` go to :meth:`predict_ctc_long`,
        ``hybrid`` / ``hybrid_beam`` to :meth:`predict_hybrid_long`.
        ``attention`` / ``attention_beam`` decode each tile with the
        attention head (``max_length`` per tile; a line of one tile decodes
        as ``predict`` does) and merge the junctions by ``merge``:
        ``"align"`` keeps each character in the tile that owns its attention
        position (needs ``tile_w`` a multiple of 8), ``"text"`` finds the
        repeat in text space.  The tiled attention merge has no confidence
        and refuses ``return_confidence``.
        """
        if return_confidence and method in ("attention", "attention_beam"):
            raise ValueError(
                "return_confidence is not supported by the tiled attention "
                "merge (junction-merged decodes have no step-aligned "
                "confidence) — use the hybrid or ctc methods"
            )
        if method in ("ctc_greedy", "ctc_beam", "greedy", "beam"):
            return self.predict_ctc_long(
                images, tile_w=tile_w, overlap=overlap, batch_size=batch_size,
                method="beam" if method.endswith("beam") else "greedy",
                beam_width=beam_width, prune_k=prune_k, snap=snap,
                return_confidence=return_confidence,
            )
        if method in ("hybrid", "hybrid_beam"):
            return self.predict_hybrid_long(
                images, tile_w=tile_w, overlap=overlap, batch_size=batch_size,
                max_length=max_length, beam=method.endswith("beam"), beam_width=beam_width,
                length_penalty=length_penalty, lm_weight=lm_weight, prune_k=prune_k,
                return_confidence=return_confidence,
            )
        if method not in ("attention", "attention_beam"):
            raise ValueError(f"Unsupported decode method: {method}")
        if merge not in ("align", "text"):
            raise ValueError(f"merge must be 'align' or 'text', got {merge!r}")
        if not self.model.with_attention_head:
            raise ValueError("this checkpoint has no attention head")
        is_single = not isinstance(images, list)
        images_list: List[Any] = [images] if is_single else list(images)
        if not images_list:
            return []
        tile_w, overlap, pad_one, rgb = self._plan(images_list, tile_w, overlap,
                                                   require_frame_aligned=merge == "align")
        tiles, plans = plan_tiles(rgb, self.img_h, tile_w, overlap, pad_one)
        # the text merge never reads the alignment: it takes the plain kernels
        need_align = merge == "align"
        steps = max_length + 1
        if method == "attention_beam":
            run = (self._attn_beam_align_fn if need_align else self._attn_beam_fn)(
                steps, int(beam_width), length_penalty, lm_weight)
        else:
            run = (self._greedy_align_fn if need_align else self._greedy_fn)(steps)
        tok_rows: List[np.ndarray] = []
        align_rows: List[np.ndarray] = []
        for i in range(0, len(tiles), batch_size):
            chunk, n_real = pad_rows(tiles[i : i + batch_size], batch_size)
            out = run(self._device_batch(np.stack(chunk)))
            tok_rows.extend(out[0][:n_real].cpu().numpy())
            if need_align:
                align_rows.extend(out[-1][:n_real].cpu().numpy())

        cs = self.charset

        def tile_text(row: np.ndarray) -> str:
            return decode_tokens(row, self._itos, pad_id=cs.pad_id, eos_id=cs.eos_id,
                                 blank_id=cs.blank_id)

        skip_ids = {v for v in (cs.pad_id, cs.blank_id) if v is not None}
        results: List[str] = []
        for first, starts in plans:
            if len(starts) == 1:
                results.append(tile_text(tok_rows[first]))
            elif need_align:
                results.append(stitch_aligned_rows(
                    np.stack(tok_rows[first : first + len(starts)]),
                    np.stack(align_rows[first : first + len(starts)]),
                    starts, tile_w, tile_w // TIME_DOWNSAMPLE,
                    eos_id=cs.eos_id, skip_ids=skip_ids, itos=self._itos))
            else:
                results.append(merge_tile_texts(
                    [tile_text(tok_rows[first + j]) for j in range(len(starts))], tile_w, starts))
        return results[0] if is_single else results
