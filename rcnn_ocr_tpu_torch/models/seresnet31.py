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

Convolutions run in the compute dtype; batch norm runs in fp32 and casts
back.  As in JAX, ``train`` is an argument of ``forward`` (``nn.Module``'s
own ``training`` flag is not read): with ``train=False`` batch norm uses the
running statistics; with ``train=True`` it normalizes with the batch's and
updates the running ones as flax's ``nn.BatchNorm(momentum=0.9)`` does, and
DropBlock follows each squeeze-excite when ``dropblock_p > 0``.

``quantize=True`` runs the 24 convs of the stages and the out head in int8
in eval mode (:mod:`rcnn_ocr_tpu_torch.ops.quant`, JAX's ``_RawConv``): the
fp32 weight quantized per output channel, the activation per tensor, with a
scale computed per call (``act_quant="dynamic"``) or a calibrated one
(``"static"``: each quantized conv holds an ``act_absmax`` buffer, JAX's
``quant_stats`` leaf of the same path, recorded inside
:func:`recording_act_absmax`).  The stem and the 1x1 ``downsample`` stay
float, as in JAX, unless ``quantize_stem``: then ``stem0`` and ``stem1``
run in int8 too (``q_stem = quantize and quantize_stem``, so the flag does
nothing without ``quantize``), with their own ``act_absmax`` under
``act_quant="static"``.

``stem_s2d=True`` runs ``stem0`` (3x3, stride 1, pad 1, C=3 input) through
the exact space-to-depth rewrite of :mod:`rcnn_ocr_tpu_torch.ops.stem` in
eval mode when H and W are even (JAX's ``_RawConv(s2d=True)``); train mode
and odd sizes take the plain conv.  It composes with the float stem only:
``stem_s2d`` with an int8 stem raises ``ValueError``, as in JAX.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rcnn_ocr_tpu_torch.models.dropblock import dropblock_2d
from rcnn_ocr_tpu_torch.ops.quant import int8_conv_nhwc, int8_conv_nhwc_static
from rcnn_ocr_tpu_torch.ops.se_scale import se_scale
from rcnn_ocr_tpu_torch.ops.stem import conv3x3_s2d
from rcnn_ocr_tpu_torch.parallel.mesh import (
    copy_to_model,
    current_shard,
    gather_from_model,
    global_sum,
    tp_shard,
)

BN_MOMENTUM = 0.9  # flax's convention: running = 0.9 * running + 0.1 * batch


class SELayer(nn.Module):
    """Squeeze-and-excite gate; ``fc1 [C, C/r]`` and ``fc2 [C/r, C]`` as in JAX.

    The fp32 weights are rounded to the compute dtype before ``se_scale``
    (which computes in fp32), as JAX's ``SELayer(use_pallas=True)`` does.
    """

    def __init__(self, channels: int, reduction: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        squeeze = max(1, channels // reduction)
        self.dtype = dtype
        self.fc1 = nn.Parameter(torch.zeros(channels, squeeze))
        self.fc2 = nn.Parameter(torch.zeros(squeeze, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NCHW-shaped channels_last -> an NHWC-contiguous view, and back
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        out = se_scale(nhwc, self.fc1.to(self.dtype), self.fc2.to(self.dtype))
        return out.permute(0, 3, 1, 2)


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Normalize fp32 NCHW ``y`` with its batch statistics and advance
    ``bn``'s running ones, as flax's ``nn.BatchNorm`` does in training: the
    fast variance ``E[y²] - E[y]²`` clipped at 0 and biased, and
    ``running = 0.9 * running + 0.1 * batch`` for mean and variance alike
    (torch's ``F.batch_norm`` would update with the unbiased variance).

    The batch is the global one: under a data-parallel step
    (:func:`rcnn_ocr_tpu_torch.parallel.mesh.batch_shard`) the per-channel
    sums of ``y`` and ``y²`` are summed over the ranks with autograd and
    divided by the global count, as JAX's one program over the mesh averages
    over every device.  Without a group the same arithmetic runs with no
    sum, so a one-rank job gives the same bits."""
    dims = (0, 2, 3)
    sums = global_sum(torch.stack([y.sum(dim=dims), (y * y).sum(dim=dims)]))
    shard = current_shard()
    count = y.numel() // y.shape[1] * (shard.count if shard is not None else 1)
    mean, mean_sq = sums[0] / count, sums[1] / count
    var = torch.clamp_min(mean_sq - mean * mean, 0.0)
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (y - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]


class ConvBN(nn.Module):
    """Bias-free conv (explicit symmetric padding) -> fp32 batch norm; the
    conv in int8 in eval mode when ``quantize``, or through the
    space-to-depth rewrite when ``s2d`` and the conv is 3x3/s1/p1 on an
    even-sized eval-mode input (see the module docstring).  A conv weight
    sharded on a model axis (``layer3``/``layer4`` ``conv1``/``conv2``)
    computes its output channels and gathers them before the batch norm."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (1, 1),
                 quantize: bool = False, act_quant: str = "dynamic", s2d: bool = False):
        super().__init__()
        if act_quant not in ("dynamic", "static"):
            raise ValueError(f"act_quant must be 'dynamic' or 'static', got {act_quant!r}")
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.quantize = quantize
        self.act_quant = act_quant
        self.s2d = s2d
        self.recording = False  # set by recording_act_absmax
        if quantize and act_quant == "static":
            self.conv.register_buffer("act_absmax", torch.zeros(()))

    def _int8(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        ph, pw = c.padding
        nhwc = x.permute(0, 2, 3, 1)
        w = c.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO, the fp32 parameter
        pads = ((ph, ph), (pw, pw))
        if self.act_quant == "static":
            y = int8_conv_nhwc_static(nhwc, w, c.stride, pads, c.act_absmax / 127.0)
        else:
            y = int8_conv_nhwc(nhwc, w, c.stride, pads)
        # JAX casts the int8 result to the compute dtype before the batch norm
        return y.permute(0, 3, 1, 2).to(x.dtype).float()

    def _takes_s2d(self, x: torch.Tensor, train: bool) -> bool:
        """JAX's conditions for the rewrite (``seresnet31.py:_RawConv``)."""
        c = self.conv
        return (self.s2d and not train and tuple(c.kernel_size) == (3, 3)
                and tuple(c.stride) == (1, 1) and tuple(c.padding) == (1, 1)
                and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = self.conv
        if self.recording:
            # calibration: keep the running abs-max, run full precision
            c.act_absmax.copy_(torch.maximum(c.act_absmax, x.float().abs().amax()))
        if self.quantize and not train and not self.recording:
            y = self._int8(x)
        elif self._takes_s2d(x, train):
            y = conv3x3_s2d(x, c.weight).contiguous(memory_format=torch.channels_last).float()
        elif tp_shard(c.weight) is not None:
            # this rank's output channels from the whole input; the batch
            # norm (the first consumer) takes them gathered
            mesh = tp_shard(c.weight).mesh
            y = F.conv2d(copy_to_model(x, mesh), c.weight.to(x.dtype), None, c.stride,
                         c.padding)
            y = gather_from_model(y.permute(0, 2, 3, 1), -1, mesh).permute(0, 3, 1, 2).float()
        else:
            y = F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding).float()
        bn = self.bn
        if train:
            z = batch_norm_train(y, bn)
        else:
            z = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             False, 0.0, bn.eps)
        return z.to(x.dtype)


@contextlib.contextmanager
def recording_act_absmax(model: nn.Module) -> Iterator[None]:
    """Within the block, every static int8 conv of ``model`` records the
    running max of ``|x|`` over its inputs into its ``act_absmax`` buffer and
    runs in full precision (JAX's calibration pass, ``quant_stats``
    mutable)."""
    convs = [m for m in model.modules()
             if isinstance(m, ConvBN) and m.quantize and m.act_quant == "static"]
    if not convs:
        raise ValueError("the model has no static int8 convs to calibrate")
    for m in convs:
        m.recording = True
    try:
        yield
    finally:
        for m in convs:
            m.recording = False


class SEBasicBlock(nn.Module):
    """conv3x3-BN-ReLU -> conv3x3-BN -> SE -> +identity -> ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, reduction: int = 16,
                 dtype: torch.dtype = torch.float32, dropblock_p: float = 0.0,
                 dropblock_block_size: int = 5, quantize: bool = False,
                 act_quant: str = "dynamic"):
        super().__init__()
        self.dropblock_p = dropblock_p
        self.dropblock_block_size = dropblock_block_size
        self.conv1 = ConvBN(in_ch, features, stride=(stride, stride), quantize=quantize,
                            act_quant=act_quant)
        self.conv2 = ConvBN(features, features, quantize=quantize, act_quant=act_quant)
        self.se = SELayer(features, reduction, dtype)
        self.downsample = None
        if stride != 1 or in_ch != features:
            self.downsample = ConvBN(in_ch, features, kernel=(1, 1), stride=(stride, stride),
                                     padding=(0, 0))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = torch.relu(self.conv1(x, train))
        out = self.se(self.conv2(out, train))
        if self.dropblock_p > 0.0 and train:
            out = dropblock_2d(out.permute(0, 2, 3, 1), self.dropblock_p,
                               self.dropblock_block_size, train, generator).permute(0, 3, 1, 2)
        identity = x if self.downsample is None else self.downsample(x, train)
        return torch.relu(out + identity)


STAGES = ((256, 1, 2), (256, 2, 1), (512, 5, 2), (512, 3, 1))  # width, blocks, first stride


class SEResNet31(nn.Module):
    """NHWC image batch -> NHWC feature map ``[B, H/32, W/8, 512*width]``."""

    def __init__(self, out_channels: int = 512, reduction: int = 16,
                 width_mult: float = 1.0, dtype: torch.dtype = torch.float32,
                 dropblock_p: float = 0.0, dropblock_block_size: int = 5,
                 quantize: bool = False, act_quant: str = "dynamic",
                 quantize_stem: bool = False, stem_s2d: bool = False):
        super().__init__()
        q_stem = quantize and quantize_stem
        if q_stem and stem_s2d:
            # JAX's int8 branch returns before the s2d rewrite is considered:
            # accepting both would run the plain int8 conv under an s2d label
            raise ValueError(
                "stem_s2d composes with the fp/bf16 stem only; the int8 "
                "stem (quantize_stem) bypasses the space-to-depth rewrite "
                "— pick one"
            )
        self.width_mult = width_mult
        self.dtype = dtype
        self.quantize = quantize
        self.act_quant = act_quant
        q = dict(quantize=quantize, act_quant=act_quant)
        self.stem0 = ConvBN(3, self._w(64), quantize=q_stem, act_quant=act_quant, s2d=stem_s2d)
        self.stem1 = ConvBN(self._w(64), self._w(128), quantize=q_stem, act_quant=act_quant)
        self.block_names = []
        in_ch = self._w(128)
        for li, (width, blocks, stride) in enumerate(STAGES, start=1):
            for bi in range(blocks):
                name = f"layer{li}_block{bi}"
                features = self._w(width)
                setattr(self, name, SEBasicBlock(in_ch, features, stride if bi == 0 else 1,
                                                 reduction, dtype, dropblock_p,
                                                 dropblock_block_size, **q))
                self.block_names.append(name)
                in_ch = features
        out_ch = self._w(out_channels)
        self.out0 = ConvBN(in_ch, out_ch, kernel=(2, 2), stride=(2, 1), padding=(0, 1), **q)
        self.out1 = ConvBN(out_ch, out_ch, kernel=(2, 2), stride=(1, 1), padding=(0, 0), **q)

    def _w(self, c: int) -> int:
        return max(8, int(round(c * self.width_mult)))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # NHWC -> NCHW-shaped channels_last, always as a copy: `contiguous`
        # would be a view here when x is contiguous NHWC, and `torch.export`
        # decides that from the traced strides, so a program fed another
        # layout (the device resize's output is strided) would give the stem
        # convs NCHW input and other rounding than the live engine's
        x = x.to(self.dtype).permute(0, 3, 1, 2).clone(memory_format=torch.channels_last)
        x = torch.relu(self.stem0(x, train))
        x = torch.relu(self.stem1(x, train))
        x = F.max_pool2d(x, 2, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train, generator)
        x = torch.relu(self.out0(x, train))
        x = torch.relu(self.out1(x, train))
        return x.permute(0, 2, 3, 1)
