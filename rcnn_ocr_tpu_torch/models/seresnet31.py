"""SE-ResNet31 backbone.

Counterpart of ``rcnn_ocr_tpu/models/seresnet31.py``, module for module and
with the same names (``stem0``, ``layer3_block2.se.fc1``, ...), so a JAX
checkpoint maps onto it key by key (``interop/jax_params.py``).  The public
``forward`` takes and returns NHWC like the JAX module; inside, the tensors
are NCHW-shaped and ``channels_last`` in memory, which is the NHWC layout the
squeeze-excite kernel reads.

* stem: conv3x3(3->64)-BN-ReLU, conv3x3(64->128)-BN-ReLU, maxpool2;
* stages of (1, 2, 5, 3) ``SEBasicBlock``s at widths (256, 256, 512, 512),
  first strides (2, 1, 2, 1); every block ends in squeeze-excite
  (:func:`rcnn_ocr_tpu_torch.ops.se_scale.se_scale`);
* out head: conv2x2 stride (2,1) pad (0,1), then conv2x2 VALID, each BN-ReLU.

Convolutions run in the compute dtype; batch norm runs in fp32 on eval
statistics and casts back.  Eval only: no DropBlock, no int8, no
space-to-depth stem (later slices).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rcnn_ocr_tpu_torch.ops.se_scale import se_scale


class SELayer(nn.Module):
    """Squeeze-and-excite gate; ``fc1 [C, C/r]`` and ``fc2 [C/r, C]`` as in JAX."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        squeeze = max(1, channels // reduction)
        self.fc1 = nn.Parameter(torch.zeros(channels, squeeze))
        self.fc2 = nn.Parameter(torch.zeros(squeeze, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NCHW-shaped channels_last -> an NHWC-contiguous view, and back
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        return se_scale(nhwc, self.fc1, self.fc2).permute(0, 3, 1, 2)


class ConvBN(nn.Module):
    """Bias-free conv (explicit symmetric padding) -> fp32 eval batch norm."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError("ConvBN runs in eval mode only (training is a later slice)")
        c = self.conv
        y = F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding)
        bn = self.bn
        z = F.batch_norm(y.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         False, 0.0, bn.eps)
        return z.to(x.dtype)


class SEBasicBlock(nn.Module):
    """conv3x3-BN-ReLU -> conv3x3-BN -> SE -> +identity -> ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, reduction: int = 16):
        super().__init__()
        self.conv1 = ConvBN(in_ch, features, stride=(stride, stride))
        self.conv2 = ConvBN(features, features)
        self.se = SELayer(features, reduction)
        self.downsample = None
        if stride != 1 or in_ch != features:
            self.downsample = ConvBN(in_ch, features, kernel=(1, 1), stride=(stride, stride),
                                     padding=(0, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.conv1(x))
        out = self.se(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


STAGES = ((256, 1, 2), (256, 2, 1), (512, 5, 2), (512, 3, 1))  # width, blocks, first stride


class SEResNet31(nn.Module):
    """NHWC image batch -> NHWC feature map ``[B, H/32, W/8, 512*width]``."""

    def __init__(self, out_channels: int = 512, reduction: int = 16,
                 width_mult: float = 1.0, dtype: torch.dtype = torch.float32,
                 dropblock_p: float = 0.0, quantize: bool = False, stem_s2d: bool = False):
        super().__init__()
        if dropblock_p or quantize or stem_s2d:
            raise NotImplementedError(
                "DropBlock, int8 and the space-to-depth stem arrive in later slices of the port"
            )
        self.width_mult = width_mult
        self.dtype = dtype
        self.stem0 = ConvBN(3, self._w(64))
        self.stem1 = ConvBN(self._w(64), self._w(128))
        self.block_names = []
        in_ch = self._w(128)
        for li, (width, blocks, stride) in enumerate(STAGES, start=1):
            for bi in range(blocks):
                name = f"layer{li}_block{bi}"
                features = self._w(width)
                setattr(self, name, SEBasicBlock(in_ch, features, stride if bi == 0 else 1,
                                                 reduction))
                self.block_names.append(name)
                in_ch = features
        out_ch = self._w(out_channels)
        self.out0 = ConvBN(in_ch, out_ch, kernel=(2, 2), stride=(2, 1), padding=(0, 1))
        self.out1 = ConvBN(out_ch, out_ch, kernel=(2, 2), stride=(1, 1), padding=(0, 0))

    def _w(self, c: int) -> int:
        return max(8, int(round(c * self.width_mult)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW-shaped channels_last (a view when x is contiguous NHWC)
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = torch.relu(self.stem0(x))
        x = torch.relu(self.stem1(x))
        x = F.max_pool2d(x, 2, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = torch.relu(self.out0(x))
        x = torch.relu(self.out1(x))
        return x.permute(0, 2, 3, 1)
