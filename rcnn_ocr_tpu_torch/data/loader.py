"""Training batch assembly.

Counterpart of ``rcnn_ocr_tpu/data/loader.py:collate_batch``: (image, label)
pairs become one fixed-shape NHWC batch of numpy arrays with packed targets;
a short batch is padded to ``batch_size`` by repeating its rows, and
``valid`` marks the real ones.  The threaded loader and the samplers arrive
with the training loop.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from rcnn_ocr_tpu_torch.vocab.charset import Charset, pack_attention_targets, pack_ctc_targets


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
