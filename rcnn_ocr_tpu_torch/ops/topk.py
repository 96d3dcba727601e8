"""Top-k with ``jax.lax.top_k``'s order on every device.

``lax.top_k`` returns the k largest values in descending order, equal
values lower index first.  ``torch.topk`` promises no order among ties, and
the beams meet ties wherever fewer live candidates than slots exist
(-inf / -1e30 rows, a beam wider than the vocabulary, early CTC frames): a
tie taken in another order there changes which dead slot holds what, and
with it later merges.  A stable descending sort gives JAX's order.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of the last axis,
    descending, ties to the lower index."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
