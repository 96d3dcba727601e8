"""DropBlock2D on NHWC activations, and dropout.

:func:`dropblock_2d` is the counterpart of
``rcnn_ocr_tpu/models/dropblock.py:dropblock_2d``: a
Bernoulli seed map of rate γ over the positions where a whole block fits,
zero-padded to the map and max-pooled to ``bs × bs`` blocks; the surviving
activations are rescaled by the kept fraction of each sample's channel.
:func:`dropout` is flax's ``nn.Dropout``: keep each element with
probability ``1 - p`` and scale it by ``1 / (1 - p)``.  The bits come from
the caller's ``torch.Generator``, so they are not JAX's; under a
data-parallel step both draw for the global batch and keep this rank's rows
(:func:`rcnn_ocr_tpu_torch.parallel.mesh.rand_rows`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from rcnn_ocr_tpu_torch.parallel.mesh import rand_rows


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Zero each element with probability ``p``, scale the rest by ``1 / (1 - p)``."""
    if generator is None:
        raise ValueError("dropout draws its mask from a torch.Generator; pass one")
    keep = rand_rows(x.shape, generator, x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def dropblock_2d(x: torch.Tensor, p: float, block_size: int, train: bool,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Apply DropBlock to NHWC ``x``; a no-op when ``p <= 0`` or not training."""
    if not train or p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropblock_2d draws its mask from a torch.Generator; pass one")
    n, h, w, c = x.shape
    bs = min(block_size, h, w)
    valid_h, valid_w = max(h - bs + 1, 1), max(w - bs + 1, 1)
    gamma = (p / (bs * bs)) * (h * w) / (valid_h * valid_w)
    seeds = rand_rows((n, c, valid_h, valid_w), generator, x.device) < gamma
    lo = bs // 2
    seeds = F.pad(seeds.to(x.dtype), (lo, w - valid_w - lo, lo, h - valid_h - lo))
    # "SAME" max-pool of stride 1 with zero padding (the seeds are 0/1)
    low = (bs - 1) // 2
    block = F.max_pool2d(F.pad(seeds, (low, bs - 1 - low, low, bs - 1 - low)), bs, stride=1)
    keep = (1.0 - block).permute(0, 2, 3, 1)  # NHWC
    denom = keep.mean(dim=(1, 2), keepdim=True).clamp_min(1e-6)
    return x * keep / denom
