"""On-device input normalization.

Counterpart of ``rcnn_ocr_tpu/ops/augment.py:device_normalize``.  The
training augmentations arrive with the training slice.
"""

from __future__ import annotations

import numpy as np
import torch

# all 256 normalized uint8 values, computed once with host IEEE fp32
# arithmetic; the device applies them by lookup, so device- and
# host-normalized pixels are bit-identical
U8_NORM_TABLE = (
    (np.arange(256, dtype=np.float32) / np.float32(255.0)) - np.float32(0.5)
) / np.float32(0.5)


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC batch -> normalized [-1, 1] float32 on the batch's device;
    float inputs pass through unchanged."""
    if images.dtype == torch.uint8:
        table = torch.from_numpy(U8_NORM_TABLE).to(images.device)
        return table[images.long()]
    return images
