"""The text-line recognizer: SE-ResNet31 -> height mean -> BiLSTMs -> heads.

Counterpart of ``rcnn_ocr_tpu/models/rcnn.py:RCNN``.  Inputs are NHWC
float images normalized to [-1, 1]; module names match the JAX parameter
tree (``cnn``, ``enc_rnn0``, ``enc_rnn1``, ``attn``, ``ctc_proj``).

Train mode is the ``train`` argument, as in JAX: batch statistics in batch
norm (running ones advanced), DropBlock after each squeeze-excite when
``dropblock_p > 0``, dropout of ``enc_dropout_p`` on the encoder states, and
the attention decoder's α-dropout (``p = 0.1``, as JAX fixes it) and
scheduled sampling.  Every random bit comes from the ``generator`` argument.

``quantize`` / ``act_quant`` select the backbone's int8 inference path,
``quantize_stem`` extends it to the stem and ``stem_s2d`` takes the
space-to-depth rewrite of the first stem conv
(``rcnn_ocr_tpu/models/rcnn.py:67-83``; see
:mod:`rcnn_ocr_tpu_torch.models.seresnet31`).

On a model axis (:func:`rcnn_ocr_tpu_torch.interop.jax_params.shard_model`)
each module computes on its shards and gathers (see its docstring);
``ctc_proj`` holds vocabulary rows and gathers its logits.

Device ranges (:class:`rcnn_ocr_tpu_torch.utils.profiling.span`, kept
while a profiler runs): ``rcnn.encode`` over the CNN, the height mean and
the BiLSTMs; ``rcnn.decode`` over the heads that follow it.  They do not
nest: the encoder's ends where the decoder's begins.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from rcnn_ocr_tpu_torch.models.attention import AttentionDecoder
from rcnn_ocr_tpu_torch.models.dropblock import dropout
from rcnn_ocr_tpu_torch.models.lstm import BiLSTM
from rcnn_ocr_tpu_torch.models.seresnet31 import SEResNet31
from rcnn_ocr_tpu_torch.parallel.mesh import copy_to_model, gather_from_model, tp_shard
from rcnn_ocr_tpu_torch.utils.profiling import span

# encoder time steps per input width: T = W / TIME_DOWNSAMPLE
TIME_DOWNSAMPLE = 8


class RCNN(nn.Module):
    def __init__(self, num_classes: int, hidden_size: int = 256, sos_id: int = 1,
                 eos_id: int = 2, pad_id: int = 0, blank_id: Optional[int] = None,
                 with_attention_head: bool = True, with_ctc_head: bool = False,
                 lstm_layers: int = 2, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32, enc_dropout_p: float = 0.1,
                 dropblock_p: float = 0.0, dropblock_block_size: int = 5,
                 sampling_prob: float = 0.0, quantize: bool = False,
                 act_quant: str = "dynamic", quantize_stem: bool = False,
                 stem_s2d: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.hidden_size = hidden_size
        self.with_attention_head = with_attention_head
        self.with_ctc_head = with_ctc_head
        self.lstm_layers = lstm_layers
        self.dtype = dtype
        self.enc_dropout_p = enc_dropout_p
        self.quantize = quantize
        self.act_quant = act_quant
        self.cnn = SEResNet31(out_channels=512, width_mult=width_mult, dtype=dtype,
                              dropblock_p=dropblock_p, dropblock_block_size=dropblock_block_size,
                              quantize=quantize, act_quant=act_quant,
                              quantize_stem=quantize_stem, stem_s2d=stem_s2d)
        in_size = self.cnn._w(512)
        for i in range(lstm_layers):
            setattr(self, f"enc_rnn{i}", BiLSTM(in_size, hidden_size, hidden_size, dtype=dtype))
            in_size = hidden_size
        self.attn = None
        if with_attention_head:
            self.attn = AttentionDecoder(num_classes, hidden_size, hidden_size, sos_id=sos_id,
                                         eos_id=eos_id, pad_id=pad_id, blank_id=blank_id,
                                         dropout_p=0.1, sampling_prob=sampling_prob,
                                         dtype=dtype)
        self.ctc_proj = nn.Linear(hidden_size, num_classes) if with_ctc_head else None

    def encode(self, x: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC image batch -> ``[B, T=W/8, hidden]`` encoder states."""
        with span("rcnn.encode", device=x.device):
            f = self.cnn(x, train, generator)  # [B, H', W', C]
            f = f.float().mean(dim=1).to(self.dtype)  # height collapse in fp32
            for i in range(self.lstm_layers):
                f = getattr(self, f"enc_rnn{i}")(f)
            if train and self.enc_dropout_p > 0.0:
                f = dropout(f, self.enc_dropout_p, generator)
            return f

    def _ctc_head(self, enc: torch.Tensor) -> torch.Tensor:
        p, dt = self.ctc_proj, self.dtype
        s = tp_shard(p.weight)
        if s is None:
            return nn.functional.linear(enc.to(dt), p.weight.to(dt), p.bias.to(dt)).float()
        # vocabulary-sharded (weight rows and bias alike): this rank's V/M
        # columns, gathered
        part = nn.functional.linear(copy_to_model(enc.to(dt), s.mesh), p.weight.to(dt),
                                    p.bias.to(dt))
        return gather_from_model(part, -1, s.mesh).float()

    def ctc_logits(self, x: torch.Tensor, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """CTC head: per-frame class logits ``[B, T, V]`` fp32."""
        enc = self.encode(x, train, generator)
        with span("rcnn.decode", device=x.device):
            return self._ctc_head(enc)

    def forward(self, x: torch.Tensor, text: Optional[torch.Tensor] = None,
                batch_max_length: int = 25, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Attention logits: teacher-forced with ``text``, greedy without."""
        enc = self.encode(x, train, generator)
        with span("rcnn.decode", device=x.device):
            return self.attn(enc, text=text, batch_max_length=batch_max_length, train=train,
                             generator=generator)

    def forward_both(self, x: torch.Tensor, text: Optional[torch.Tensor] = None,
                     batch_max_length: int = 25, train: bool = False,
                     generator: Optional[torch.Generator] = None):
        """One encode, both heads: ``(attention logits, CTC logits)``."""
        enc = self.encode(x, train, generator)
        with span("rcnn.decode", device=x.device):
            attn = self.attn(enc, text=text, batch_max_length=batch_max_length, train=train,
                             generator=generator)
            return attn, self._ctc_head(enc)

    def greedy_decode_aligned(self, x: torch.Tensor, batch_max_length: int = 25):
        """Greedy logits ``[B, steps, V]`` and the attention argmax ``[B, steps]``."""
        enc = self.encode(x)
        with span("rcnn.decode", device=x.device):
            return self.attn(enc, batch_max_length=batch_max_length, return_alignment=True)

    def beam_decode(self, x: torch.Tensor, beam_width: int = 5, batch_max_length: int = 25,
                    length_penalty: float = 0.0, lm_logp=None, lm_weight: float = 0.0,
                    return_alignment: bool = False):
        """Attention beam search: ``(tokens [B, steps], scores [B])`` (and the
        alignment); see :meth:`AttentionDecoder.beam_search`."""
        enc = self.encode(x)
        with span("rcnn.decode", device=x.device):
            return self.attn.beam_search(enc, beam_width, batch_max_length,
                                         length_penalty=length_penalty, lm_logp=lm_logp,
                                         lm_weight=lm_weight, return_alignment=return_alignment)

    def eval_outputs(self, x: torch.Tensor, text: Optional[torch.Tensor] = None,
                     batch_max_length: int = 25, with_attention: bool = True,
                     with_ctc: bool = False):
        """Every eval output from one encoder pass: ``tf_logits`` (needs
        ``text``), ``greedy_logits``, ``ctc_logits``."""
        enc = self.encode(x)
        out = {}
        with span("rcnn.decode", device=x.device):
            if with_attention:
                if text is not None:
                    out["tf_logits"] = self.attn(enc, text=text,
                                                 batch_max_length=batch_max_length)
                out["greedy_logits"] = self.attn(enc, batch_max_length=batch_max_length)
            if with_ctc:
                out["ctc_logits"] = self._ctc_head(enc)
        return out


@torch.no_grad()
def init_train_params(model: nn.Module, generator: torch.Generator) -> None:
    """Training's starting weights, drawn as the JAX model's flax initializers
    draw them (the distributions, not the bits): every weight LeCun-normal,
    truncated at two standard deviations with flax's fan-in (the product of
    all but the output axis), biases zero, batch norm at identity (scale 1,
    shift 0, running mean 0, running variance 1).  Draws on the CPU."""

    def lecun(p: torch.Tensor, fan_in: int) -> None:
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # unit variance after truncation
        p.copy_(nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std, -2 * std, 2 * std,
                                      generator=generator))

    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            lecun(mod.weight, mod.weight[0].numel())
        elif isinstance(mod, nn.Linear):
            lecun(mod.weight, mod.in_features)
            mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
        else:
            for name, p in mod.named_parameters(recurse=False):
                if p.dim() < 2 or name.startswith("b"):
                    p.zero_()
                else:
                    lecun(p, p.numel() // p.shape[-1])


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: LeCun-normal kernels, zero biases, and batch
    norm scales, shifts and running statistics drawn away from identity so
    a random model exercises the whole eval batch norm.  Draws on the CPU."""

    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(normal(mod.weight.shape, 1.0 / math.sqrt(fan_in)))
        elif isinstance(mod, nn.Linear):
            mod.weight.copy_(normal(mod.weight.shape, 1.0 / math.sqrt(mod.in_features)))
            mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            n = mod.num_features
            mod.weight.copy_(uniform((n,), 0.8, 1.2))
            mod.bias.copy_(normal((n,), 0.1))
            mod.running_mean.copy_(normal((n,), 0.1))
            mod.running_var.copy_(uniform((n,), 0.5, 1.5))
        else:
            for name, p in mod.named_parameters(recurse=False):
                if p.dim() < 2 or name.startswith("b"):
                    p.zero_()
                else:
                    fan_in = p.shape[-2]
                    p.copy_(normal(p.shape, 1.0 / math.sqrt(fan_in)))
