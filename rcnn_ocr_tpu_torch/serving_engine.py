"""The serving path: resize-pad on the device, behind a double-buffered host
letterbox.

Counterpart of ``rcnn_ocr_tpu/serving_engine.py:ServingEngineMixin``
(``_serving_fn``, ``serving_kernel``, ``decode_kernel``, ``tile_kernel``,
``tile_ids_kernel``, ``predict_serving``), mixed into
:class:`rcnn_ocr_tpu_torch.inference.OCRInference`.  The host only pastes raw
uint8 pixels into a fixed canvas (the C++ letterbox); the device resizes,
pads and normalizes them (:mod:`rcnn_ocr_tpu_torch.ops.preprocess`) and
decodes.  The kernels returned here are functions of device tensors: the
weights live in the module, so they take no ``variables`` argument as the
JAX ones do.  Under a mesh each replica copies its block of rows of the
pinned canvas batch to its device and resizes and decodes it there.
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from rcnn_ocr_tpu_torch.ops.preprocess import host_letterbox, host_resize_geometry, resize_pad_u8
from rcnn_ocr_tpu_torch.parallel.mesh import gather_rows, to_host
from rcnn_ocr_tpu_torch.postprocess import decode_ctc_batch, pad_rows
from rcnn_ocr_tpu_torch.utils.profiling import span

CTC_METHODS = ("ctc", "ctc_greedy", "ctc_beam")
# the id of each predict_serving call, which its chunk spans carry
_CALL_IDS = itertools.count()


class ServingEngineMixin:
    """``serving_kernel`` / ``predict_serving`` and the kernel accessors of
    ``OCRInference``."""

    def _serving_fn(self, steps: int, target_w: int, ctc: bool = False, beam_width: int = 0,
                    prune_k: int = 16, attn_beam: int = 0, length_penalty: float = 0.0,
                    lm_weight: float = 0.0, with_conf: bool = False):
        """``run(raw uint8 [B, Hc, Wc, 3], sizes [B, 2 or 5])``: resize-pad on
        the device to ``img_h x target_w``, then one of the decode kernels
        (``rcnn_ocr_tpu/serving_engine.py:_serving_fn``)."""
        if ctc and beam_width:
            # prune_k <= 0 means the whole vocabulary
            prune_k = (self.charset.num_classes if prune_k <= 0
                       else min(int(prune_k), self.charset.num_classes))
            decode = self._ctc_beam_device_fn(beam_width, prune_k, lm_weight, with_conf)
        elif ctc:
            decode = self._ctc_fn(True, with_conf=with_conf)
        elif attn_beam:
            decode = self._attn_beam_fn(steps, attn_beam, length_penalty, lm_weight)
        else:
            decode = self._greedy_fn(steps)
        img_h = self.img_h

        @torch.inference_mode()
        def run(raw, sizes, replica: int = 0):
            return decode(resize_pad_u8(raw, sizes, img_h, target_w), replica=replica)
        return run

    def serving_kernel(self, method: str = "attention", max_length: int = 25,
                       target_w: Optional[int] = None, beam_width: int = 16, prune_k: int = 16,
                       length_penalty: float = 0.0, lm_weight: float = 0.0,
                       with_confidence: bool = False):
        """The serving decode for one configuration: ``kernel(raw uint8 [B,
        Hc, Wc, 3], sizes [B, 5])``, what ``predict_serving`` runs per chunk.
        ``with_confidence`` shapes only the CTC kernels (a third ``[B]``
        row); the attention kernels always return their max-softmax / score
        row.  Knobs the kernel would drop are refused."""
        ctc = method in CTC_METHODS
        if not ctc and method not in ("attention", "attention_beam"):
            raise ValueError(f"Unsupported serving decode method: {method}")
        if ctc and not self.model.with_ctc_head:
            raise ValueError("this checkpoint has no CTC head")
        if not ctc and not self.model.with_attention_head:
            raise ValueError("this checkpoint has no attention head")
        beam_method = method in ("attention_beam", "ctc_beam")
        if beam_method and beam_width <= 1:
            raise ValueError(
                f"method={method!r} needs beam_width > 1, got {beam_width} "
                "(a width-<=1 'beam' would silently run the greedy kernel)"
            )
        if lm_weight and not beam_method:
            raise ValueError(f"lm_weight is not supported with method={method!r}")
        if length_penalty and method != "attention_beam":
            raise ValueError(f"length_penalty is not supported with method={method!r}")
        return self._serving_fn(
            max_length + 1, target_w or self.img_w, ctc=ctc,
            beam_width=beam_width if method == "ctc_beam" else 0, prune_k=prune_k,
            attn_beam=beam_width if method == "attention_beam" else 0,
            length_penalty=length_penalty, lm_weight=lm_weight,
            with_conf=ctc and with_confidence,
        )

    def decode_kernel(self, max_length: int = 25, beam_width: int = 0,
                      length_penalty: float = 0.0, lm_weight: float = 0.0,
                      with_alignment: bool = False):
        """The attention decode ``predict`` and ``predict_long`` run per batch
        or tile batch: ``kernel(uint8 images [B, H, W, 3]) -> (tokens, aux)``,
        aux the max-softmax rows (greedy) or cumulative log-probs
        (``beam_width > 1``).  ``with_alignment`` returns the alignment
        flavour: greedy ``(tokens, align)``, beam ``(tokens, scores, align)``."""
        if not self.model.with_attention_head:
            raise ValueError("this checkpoint has no attention head")
        steps = max_length + 1
        if beam_width and beam_width > 1:
            fn = self._attn_beam_align_fn if with_alignment else self._attn_beam_fn
            return fn(steps, int(beam_width), length_penalty, lm_weight)
        # the greedy kernels have no fusion or rank hook: refuse, do not drop
        if lm_weight:
            raise ValueError(
                "lm_weight requires beam_width > 1 (the greedy decode "
                "kernel has no fusion hook)"
            )
        if length_penalty:
            raise ValueError("length_penalty requires beam_width > 1")
        return self._greedy_align_fn(steps) if with_alignment else self._greedy_fn(steps)

    def tile_kernel(self, prune_k: int = 16):
        """The long-line frame kernel: ``kernel(uint8 tiles [B, H, tile_w,
        3]) -> (top-k frame log-probs [B, T, k], class ids [B, T, k])``."""
        if not self.model.with_ctc_head:
            raise ValueError("this checkpoint has no CTC head")
        return self._ctc_fn(False, max(1, min(prune_k, self.charset.num_classes)))

    def tile_ids_kernel(self, with_maxp: bool = False):
        """The argmax flavour of :meth:`tile_kernel`: ``kernel(uint8 tiles)
        -> per-frame class ids [B, T] int32`` (plus the per-frame max-softmax
        ``[B, T]`` with ``with_maxp``), all the midpoint stitcher and the
        hybrid segmenter read."""
        if not self.model.with_ctc_head:
            raise ValueError("this checkpoint has no CTC head")
        return self._ctc_frame_ids_fn(with_maxp=with_maxp)

    @torch.inference_mode()
    def predict_serving(self, images, max_length: int = 25, batch_size: int = 256,
                        canvas: Union[Tuple[int, int], str] = (64, 512),
                        method: str = "attention", return_confidence: bool = False,
                        beam_width: int = 16, prune_k: int = 16, length_penalty: float = 0.0,
                        lm_weight: float = 0.0):
        """Decode with resize-pad on the device.

        The host pastes each chunk's raw uint8 pixels into a ``canvas`` batch
        (``"auto"``: the largest height and width among the inputs, from
        their headers); images larger than the canvas are cropped, so size
        it to the data.  The device resizes, pads and normalizes each image
        exactly as ``ResizeAndPad`` does (rects from
        :func:`host_resize_geometry`), then decodes with ``method``:
        ``attention``, ``attention_beam``, ``ctc_greedy`` or ``ctc_beam``.

        Double-buffered: a worker thread letterboxes the next chunk into the
        other of two (pinned, on the card) host buffers while the device
        decodes this one; a buffer is refilled only after the CUDA events
        recorded behind its last copies (one per replica, on the replica's
        stream) have completed.  Under a mesh ``batch_size`` rounds up to
        tile the replicas, and each replica copies, resizes and decodes its
        block of rows on its own device.  Width buckets apply
        (each decodes at its own width).  ``return_confidence`` works for
        every method, with ``predict`` / ``predict_ctc``'s definitions.

        Spans (:mod:`rcnn_ocr_tpu_torch.utils.profiling`, kept while a
        profiler runs): ``serving.predict`` around the call, with a call id
        that every chunk's spans carry beside the chunk's index; on the
        caller's thread ``serving.input_wait`` (for the chunk's letterbox),
        ``serving.dispatch`` (H2D and the enqueue of resize, encoder and
        head; ``rows`` dispatched), ``serving.fetch`` (the outputs to the
        host: waits for the device) and ``serving.strings`` (rows to text);
        on the worker ``serving.letterbox`` (``_to_rgb``, ``pad_rows``, the
        wait for the buffer's last copies, which are done by then, the C++
        letterbox, the geometry).
        """
        ctc = method in CTC_METHODS
        ctc_beam_w = beam_width if method == "ctc_beam" else 0
        attn_beam = method == "attention_beam"
        if ctc and not self.model.with_ctc_head:
            raise ValueError("this checkpoint has no CTC head")
        if not ctc and method not in ("attention", "attention_beam"):
            raise ValueError(f"Unsupported serving decode method: {method}")
        if lm_weight and not (attn_beam or ctc_beam_w):
            raise ValueError("lm_weight requires method='attention_beam' or 'ctc_beam'")
        if length_penalty and not attn_beam:
            raise ValueError("length_penalty requires method='attention_beam'")
        if (attn_beam or method == "ctc_beam") and beam_width <= 1:
            raise ValueError(
                f"method={method!r} needs beam_width > 1, got {beam_width} "
                "(a width-<=1 'beam' would silently run the greedy kernel "
                "and mis-decode its output as beam results)"
            )
        if not ctc and not self.model.with_attention_head:
            raise ValueError("this checkpoint has no attention head; use predict_ctc()")
        is_single = not isinstance(images, list)
        images_list: List[Any] = [images] if is_single else list(images)
        if not images_list:
            return []
        call = next(_CALL_IDS)
        with span("serving.predict", call=call, rows=len(images_list)):
            if isinstance(canvas, str):
                if canvas != "auto":
                    raise ValueError(f"canvas: unknown spec {canvas!r}")
                hw = [self._probe_hw(img) for img in images_list]
                canvas = (max(h for h, _ in hw), max(w for _, w in hw))
            canvas_h, canvas_w = (int(v) for v in canvas)
            batch_size = self._round_batch(batch_size)
            chunks = self._bucket_chunks(images_list, batch_size)

            cuda = self.device.type == "cuda"
            bufs = [torch.empty((batch_size, canvas_h, canvas_w, 3), dtype=torch.uint8,
                                pin_memory=cuda) for _ in range(2)]
            # per buffer, the events behind its last copies: one per replica
            copied: List[List[torch.cuda.Event]] = [[], []]

            def letterbox_chunk(k: int):
                bucket, idxs = chunks[k]
                slot = k % 2
                with span("serving.letterbox", call=call, chunk=k, rows=len(idxs)):
                    rgb, _ = pad_rows([self._to_rgb(images_list[j]) for j in idxs], batch_size)
                    for event in copied[slot]:  # the buffer's last copies must be done
                        event.synchronize()
                    _, sizes = host_letterbox(rgb, canvas_h, canvas_w, out=bufs[slot].numpy())
                    geom = host_resize_geometry(sizes, self.img_h, bucket or self.img_w)
                    return bucket, idxs, slot, np.concatenate([sizes, geom], axis=1)

            results: List[Any] = [None] * len(images_list)
            with ThreadPoolExecutor(max_workers=1) as pool:
                pending = pool.submit(letterbox_chunk, 0)
                for k in range(len(chunks)):
                    with span("serving.input_wait", call=call, chunk=k):
                        bucket, idxs, slot, sizes = pending.result()
                    # the worker fills the other buffer, whose copies the last
                    # chunk's decode waited for
                    if k + 1 < len(chunks):
                        pending = pool.submit(letterbox_chunk, k + 1)
                    run = self._serving_fn(
                        max_length + 1, bucket or self.img_w, ctc=ctc, beam_width=ctc_beam_w,
                        prune_k=prune_k, attn_beam=beam_width if attn_beam else 0,
                        length_penalty=length_penalty if attn_beam else 0.0,
                        lm_weight=lm_weight if (attn_beam or ctc_beam_w) else 0.0,
                        with_conf=ctc and return_confidence,
                    )
                    events: List[torch.cuda.Event] = []

                    def work(i: int, lo: int, hi: int):
                        dev = self._replicas.devices[i]
                        with span("serving.dispatch", call=call, chunk=k, rows=hi - lo):
                            raw = bufs[slot][lo:hi].to(dev, non_blocking=True)
                            if cuda:  # on this replica's stream, behind its copy
                                event = torch.cuda.Event()
                                event.record()
                                events.append(event)
                            block = torch.from_numpy(np.ascontiguousarray(sizes[lo:hi])).to(dev)
                            out = run(raw, block, replica=i)
                        # fetching the outputs waits for the device while the
                        # worker letterboxes the next chunk
                        with span("serving.fetch", call=call, chunk=k):
                            return to_host(out)

                    out = gather_rows(self._replicas.run(work, batch_size))
                    copied[slot] = events
                    with span("serving.strings", call=call, chunk=k, rows=len(idxs)):
                        if ctc:
                            texts = decode_ctc_batch(out[0], out[1], len(idxs), self._itos,
                                                     self._ctc_skip())
                            rows = [(t, float(c)) for t, c in zip(texts, out[2])] \
                                if return_confidence else texts
                        else:
                            decode_row = (self._decode_beam_row if attn_beam
                                          else self._decode_attention_row)
                            rows = [decode_row(out[0][j], out[1][j], return_confidence)
                                    for j in range(len(idxs))]
                        for j, out_idx in enumerate(idxs):
                            results[out_idx] = rows[j]
        return results[0] if is_single else results
