"""Plain float32 reference of the text-line recognizer the benchmark runs.

SE-ResNet31 -> mean over height -> two bidirectional LSTMs -> the CTC head
and the additive-attention LSTM decoder (sherstpasha/RCNN-OCR, as the JAX
package and its PyTorch port lay it out).  Weights are a flat dict from
JAX-style paths (``params/cnn/stem0/conv/kernel``, HWIO convs, ``[in, out]``
dense kernels, ``batch_stats/.../mean``) to float32 tensors;
:func:`param_layout` lists every leaf with its shape and fan-in.

Plain ``torch`` operations in float32 with TF32 off (:func:`plain_fp32`), no
custom kernel, no cache, no batching logic.  Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

# (width, blocks, first stride) per stage
STAGES = ((256, 1, 2), (256, 2, 1), (512, 5, 2), (512, 3, 1))
SE_REDUCTION = 16

Leaf = Tuple[str, Tuple[int, ...], str, int]  # path, shape, kind, fan-in


def _conv_leaves(prefix: str, cin: int, cout: int, kh: int, kw: int) -> List[Leaf]:
    return [(f"params/{prefix}/conv/kernel", (kh, kw, cin, cout), "he", kh * kw * cin),
            (f"params/{prefix}/bn/scale", (cout,), "one", 0),
            (f"params/{prefix}/bn/bias", (cout,), "zero", 0),
            (f"batch_stats/{prefix}/bn/mean", (cout,), "zero", 0),
            (f"batch_stats/{prefix}/bn/var", (cout,), "one", 0)]


def conv_specs(cfg: dict) -> List[dict]:
    """Every convolution of the backbone in order: name, channels, kernel,
    stride, padding and the input's height and width for one line."""
    out = []

    def add(name, hw, cin, cout, k, s, p):
        ho = (hw[0] + 2 * p[0] - k[0]) // s[0] + 1
        wo = (hw[1] + 2 * p[1] - k[1]) // s[1] + 1
        out.append(dict(name=name, cin=cin, cout=cout, k=k, s=s, p=p, h=hw[0], w=hw[1],
                        ho=ho, wo=wo))
        return ho, wo

    hw = add("stem0", (cfg["img_h"], cfg["img_w"]), 3, 64, (3, 3), (1, 1), (1, 1))
    hw = add("stem1", hw, 64, 128, (3, 3), (1, 1), (1, 1))
    hw = (hw[0] // 2, hw[1] // 2)  # max pool 2x2
    cin = 128
    for li, (width, blocks, stride) in enumerate(STAGES, start=1):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            name = f"layer{li}_block{bi}"
            hw_out = add(f"{name}/conv1", hw, cin, width, (3, 3), (s, s), (1, 1))
            add(f"{name}/conv2", hw_out, width, width, (3, 3), (1, 1), (1, 1))
            if s != 1 or cin != width:
                add(f"{name}/downsample", hw, cin, width, (1, 1), (s, s), (0, 0))
            hw, cin = hw_out, width
    hw = add("out0", hw, cin, 512, (2, 2), (2, 1), (0, 1))
    add("out1", hw, 512, 512, (2, 2), (1, 1), (0, 0))
    return out


def se_specs(cfg: dict) -> List[dict]:
    """Every squeeze-excite of the backbone: its block, channels and map size."""
    convs = {c["name"]: c for c in conv_specs(cfg)}
    out = []
    for name in block_names():
        c2 = convs[f"{name}/conv2"]
        out.append(dict(name=name, c=c2["cout"], squeeze=c2["cout"] // SE_REDUCTION,
                        h=c2["ho"], w=c2["wo"]))
    return out


def block_names() -> List[str]:
    return [f"layer{li}_block{bi}" for li, (_, blocks, _) in enumerate(STAGES, start=1)
            for bi in range(blocks)]


def frames(cfg: dict) -> int:
    """Encoder time steps T (the last conv's output width)."""
    return conv_specs(cfg)[-1]["wo"]


def param_layout(cfg: dict) -> List[Leaf]:
    """Every weight leaf: JAX-style path, shape, how it is drawn
    (``he``: N(0, 2 / fan-in), the convolutions, each followed by a ReLU;
    ``normal``: N(0, 1 / fan-in); ``zero``; ``one``) and its fan-in."""
    hid, v = cfg["hidden_size"], cfg["num_classes"]
    leaves: List[Leaf] = []
    for c in conv_specs(cfg):
        leaves += _conv_leaves(f"cnn/{c['name']}", c["cin"], c["cout"], *c["k"])
    for s in se_specs(cfg):
        leaves += [(f"params/cnn/{s['name']}/se/fc1", (s["c"], s["squeeze"]), "normal", s["c"]),
                   (f"params/cnn/{s['name']}/se/fc2", (s["squeeze"], s["c"]), "normal",
                    s["squeeze"])]
    d = 512
    for i in range(cfg["lstm_layers"]):
        p = f"params/enc_rnn{i}"
        leaves += [(f"{p}/w_ih", (2, d, 4 * hid), "normal", d),
                   (f"{p}/w_hh", (2, hid, 4 * hid), "normal", hid),
                   (f"{p}/bias", (2, 4 * hid), "zero", 0),
                   (f"{p}/proj/kernel", (2 * hid, hid), "normal", 2 * hid),
                   (f"{p}/proj/bias", (hid,), "zero", 0)]
        d = hid
    a = "params/attn"
    leaves += [(f"{a}/w_i2h", (hid, hid), "normal", hid),
               (f"{a}/w_h2h", (hid, hid), "normal", hid),
               (f"{a}/b_h2h", (hid,), "zero", 0),
               (f"{a}/v_score", (hid, 1), "normal", hid),
               (f"{a}/w_ctx", (hid, 4 * hid), "normal", hid),
               (f"{a}/w_emb", (v, 4 * hid), "normal", v),
               (f"{a}/w_hh", (hid, 4 * hid), "normal", hid),
               (f"{a}/b_cell", (4 * hid,), "zero", 0),
               (f"{a}/w_gen", (hid, v), "normal", hid),
               (f"{a}/b_gen", (v,), "zero", 0),
               ("params/ctc_proj/kernel", (hid, v), "normal", hid),
               ("params/ctc_proj/bias", (v,), "zero", 0)]
    return leaves


@contextlib.contextmanager
def plain_fp32() -> Iterator[None]:
    """TF32 off for matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _conv_bn(W: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, stride, padding,
             calibrate: bool):
    k = W[f"params/cnn/{prefix}/conv/kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x, k, None, stride, padding)
    if calibrate:  # the running statistics become this batch's, per channel
        W[f"batch_stats/cnn/{prefix}/bn/mean"] = y.mean(dim=(0, 2, 3))
        W[f"batch_stats/cnn/{prefix}/bn/var"] = y.var(dim=(0, 2, 3), unbiased=False)
    mean = W[f"batch_stats/cnn/{prefix}/bn/mean"]
    var = W[f"batch_stats/cnn/{prefix}/bn/var"]
    scale = W[f"params/cnn/{prefix}/bn/scale"] * torch.rsqrt(var + 1e-5)
    shift = W[f"params/cnn/{prefix}/bn/bias"] - mean * scale
    return y * scale[:, None, None] + shift[:, None, None]


def backbone(W: Dict[str, torch.Tensor], x: torch.Tensor,
             calibrate: bool = False) -> torch.Tensor:
    """NHWC images in [-1, 1] -> NCHW feature map.  With ``calibrate`` every
    batch norm first takes the batch's own statistics as its running ones
    (written into ``W``), as training leaves them measured on its data."""
    def conv_bn(prefix, x, stride, padding):
        return _conv_bn(W, prefix, x, stride, padding, calibrate)

    x = x.permute(0, 3, 1, 2)
    x = torch.relu(conv_bn("stem0", x, 1, 1))
    x = torch.relu(conv_bn("stem1", x, 1, 1))
    x = F.max_pool2d(x, 2, 2)
    cin = 128
    for li, (width, blocks, stride) in enumerate(STAGES, start=1):
        for bi in range(blocks):
            name = f"layer{li}_block{bi}"
            s = stride if bi == 0 else 1
            out = torch.relu(conv_bn(f"{name}/conv1", x, s, 1))
            out = conv_bn(f"{name}/conv2", out, 1, 1)
            m = out.mean(dim=(2, 3))
            g = torch.sigmoid(torch.relu(m @ W[f"params/cnn/{name}/se/fc1"])
                              @ W[f"params/cnn/{name}/se/fc2"])
            out = out * g[:, :, None, None]
            identity = x
            if s != 1 or cin != width:
                identity = conv_bn(f"{name}/downsample", x, s, 0)
            x = torch.relu(out + identity)
            cin = width
    x = torch.relu(conv_bn("out0", x, (2, 1), (0, 1)))
    return torch.relu(conv_bn("out1", x, 1, 0))


def _lstm_cell(gates: torch.Tensor, c: torch.Tensor, hid: int):
    i, f, g, o = gates.split(hid, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def bilstm(W: Dict[str, torch.Tensor], i: int, x: torch.Tensor, hid: int) -> torch.Tensor:
    """One bidirectional LSTM layer and its output projection: [B, T, D] -> [B, T, hid]."""
    p = f"params/enc_rnn{i}"
    batch, steps, _ = x.shape
    outs = []
    for d, order in ((0, range(steps)), (1, range(steps - 1, -1, -1))):
        proj = x @ W[f"{p}/w_ih"][d] + W[f"{p}/bias"][d]
        h = x.new_zeros(batch, hid)
        c = torch.zeros_like(h)
        ys = [None] * steps
        for t in order:
            h, c = _lstm_cell(proj[:, t] + h @ W[f"{p}/w_hh"][d], c, hid)
            ys[t] = h
        outs.append(torch.stack(ys, dim=1))
    return torch.cat(outs, dim=-1) @ W[f"{p}/proj/kernel"] + W[f"{p}/proj/bias"]


def encode(W: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """NHWC images in [-1, 1] -> encoder states [B, T, hidden]."""
    f = backbone(W, x).mean(dim=2).transpose(1, 2)  # height mean -> [B, T, C]
    for i in range(cfg["lstm_layers"]):
        f = bilstm(W, i, f, cfg["hidden_size"])
    return f


def ctc_logits(W: Dict[str, torch.Tensor], enc: torch.Tensor) -> torch.Tensor:
    return enc @ W["params/ctc_proj/kernel"] + W["params/ctc_proj/bias"]


def _attention_step(W: Dict[str, torch.Tensor], enc, keys, h, c, tokens, hid: int):
    """One decoder step: attention over ``enc``, the LSTM cell fed the
    previous ``tokens``; returns (logits, h, c)."""
    a = "params/attn"
    e = (torch.tanh(keys + (h @ W[f"{a}/w_h2h"] + W[f"{a}/b_h2h"])[:, None])
         @ W[f"{a}/v_score"])[..., 0]
    alpha = torch.softmax(e, dim=1)
    context = torch.bmm(alpha[:, None, :], enc)[:, 0]
    gates = (context @ W[f"{a}/w_ctx"] + W[f"{a}/w_emb"][tokens] + h @ W[f"{a}/w_hh"]
             + W[f"{a}/b_cell"])
    h, c = _lstm_cell(gates, c, hid)
    return h @ W[f"{a}/w_gen"] + W[f"{a}/b_gen"], h, c


def attention_logits(W: Dict[str, torch.Tensor], enc: torch.Tensor, inputs: torch.Tensor,
                     hid: int) -> torch.Tensor:
    """Teacher-forced decoder: ``inputs [B, S]`` (SOS first) -> logits [B, S, V]."""
    keys = enc @ W["params/attn/w_i2h"]
    h = enc.new_zeros(enc.shape[0], hid)
    c = torch.zeros_like(h)
    logits = []
    for t in range(inputs.shape[1]):
        step, h, c = _attention_step(W, enc, keys, h, c, inputs[:, t], hid)
        logits.append(step)
    return torch.stack(logits, dim=1)


def attention_greedy(W: Dict[str, torch.Tensor], enc: torch.Tensor, sos: int, steps: int,
                     hid: int) -> torch.Tensor:
    """Greedy decoder: each step's best token fed back -> tokens [B, steps]."""
    keys = enc @ W["params/attn/w_i2h"]
    h = enc.new_zeros(enc.shape[0], hid)
    c = torch.zeros_like(h)
    tokens = torch.full((enc.shape[0],), sos, dtype=torch.long, device=enc.device)
    out = []
    for _ in range(steps):
        logits, h, c = _attention_step(W, enc, keys, h, c, tokens, hid)
        tokens = logits.argmax(dim=-1)
        out.append(tokens)
    return torch.stack(out, dim=1)
