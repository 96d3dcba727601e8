"""Space-to-depth stem convolution (an exact rewrite of a 3x3/s1/p1 conv).

Counterpart of ``rcnn_ocr_tpu/ops/stem.py``:

    y = conv3x3_p1(x, K)
      = depth_to_space( conv2x2_valid( space_to_depth_pad1(x), s2d_kernel(K) ) )

which quarters the spatial positions and multiplies the contraction depth
and the output channels by four (the extra kernel taps are zeros); only the
float summation order changes.  The functions take the port's layouts:
images NCHW-shaped (``[B, C, H, W]``), kernels OIHW (``[F, C, 3, 3]``).
The channel groups keep JAX's parity-major order, not the channel-major
one of ``pixel_unshuffle`` / ``pixel_shuffle``: input channel
``(sr*2+sc)*C + c`` holds the padded input at row parity ``sr`` and column
parity ``sc``, output channel ``(dp*2+dq)*F + o`` the original output at
row parity ``dp`` and column parity ``dq``.  The 2x2 kernel is built from
the original parameter at call time, so checkpoints, interop and the int8
path see the 3x3 one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``[F, C, 3, 3]`` conv3x3-pad1 kernel -> ``[4F, 4C, 2, 2]``."""
    f, c, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"s2d rewrite expects a 3x3 kernel, got {kh}x{kw}")
    groups = []
    for dp in range(2):
        for dq in range(2):
            # the kernel padded to 4x4 at offset (dp, dq); tap (u, v) lands in
            # block (a, b) at parity (sr, sc) with dp+u = 2a+sr, dq+v = 2b+sc
            kp = F.pad(w, (dq, 1 - dq, dp, 1 - dp))  # [F, C, 4, 4]
            kp = kp.reshape(f, c, 2, 2, 2, 2).permute(0, 3, 5, 1, 2, 4)  # o, sr, sc, c, a, b
            groups.append(kp.reshape(f, 4 * c, 2, 2))
    return torch.cat(groups, dim=0)


def space_to_depth_pad1(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` -> pad 1 -> block-2 s2d ``[B, 4C, (H+2)/2, (W+2)/2]``."""
    b, c, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    xp = xp.reshape(b, c, (h + 2) // 2, 2, (w + 2) // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return xp.reshape(b, 4 * c, (h + 2) // 2, (w + 2) // 2)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """``[B, 4F, H, W]`` (parity-major channel groups) -> ``[B, F, 2H, 2W]``."""
    b, c4, h, w = y.shape
    f = c4 // 4
    y = y.reshape(b, 2, 2, f, h, w).permute(0, 3, 4, 1, 5, 2)  # b, o, h, dp, w, dq
    return y.reshape(b, f, 2 * h, 2 * w)


def conv3x3_s2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv2d(x, w, padding=1)`` of a ``[F, C, 3, 3]`` kernel through the
    space-to-depth rewrite (H and W even); in ``x``'s dtype."""
    xs = space_to_depth_pad1(x)
    return depth_to_space(F.conv2d(xs, s2d_kernel(w).to(x.dtype)))
