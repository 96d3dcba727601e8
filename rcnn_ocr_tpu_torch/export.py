"""Serving artifacts: the engine's decode programs exported with
``torch.export``, beside the weights in JAX's layout and a manifest.

Counterpart of ``rcnn_ocr_tpu/export.py`` (``validate_export_request``,
``export_serving_artifact``, ``ServingArtifact``).  A serving host loads the
directory and runs the programs; no model class is rebuilt:

* each decode kernel of :class:`~rcnn_ocr_tpu_torch.inference.OCRInference`
  (``serving_kernel``, ``tile_kernel``, ``tile_ids_kernel``,
  ``decode_kernel``) is traced once per static width by ``torch.export`` and
  saved with ``torch.export.save``: ``serving_w<W>.pt2``, ``tiles_w<W>.pt2``
  and, for the hybrid methods, ``decode_w<W>.pt2``;
* a program takes ``(params, raw, sizes)`` (``(params, tiles)`` for the
  long-line and hybrid methods), as JAX's take ``(variables, raw, sizes)``:
  ``params`` is a flat dict of tensors by the port's state names, swapped
  into the model by ``torch.func.functional_call``.  So ``params.msgpack``
  (flax's layout, ``quant_stats`` included, readable by JAX's
  ``msgpack_restore``) stays the one copy of the weights, no ``.pt2``
  carries them, and an int8 program quantizes its weights on every call, as
  JAX's artifact does;
* both hand-written kernels are registered operators
  (``torch.ops.rcnn_ocr_tpu_torch.se_scale`` / ``bilstm_scan``), so a
  program launches them on the card and runs their plain versions on the
  CPU, and counts its launches as the live engine does.

``platforms`` names torch devices (``"cuda"``, ``"cpu"``).  A program runs
on the device it was exported on; the loader moves it to another device
type only when the manifest lists that type, and raises otherwise, and to
another card of the same type freely
(``torch.export.passes.move_to_device_pass``).  The manifest has every
field of JAX's, with the ``.pt2`` file names and ``torch_version`` in place
of ``jax_version``.

A program's batch dimension is symbolic: it decodes the manifest's
``batch_size`` rows, or a replica's block of them.
``ServingArtifact.load(dir, mesh=)`` serves data-parallel as
``OCRInference(mesh=)`` does: a copy of the weights and of every program on
each device (shared by the replicas a device holds), each batch split into
contiguous row blocks, one per replica (:class:`rcnn_ocr_tpu_torch.parallel.mesh.ReplicaSet`).  An engine
with a mesh does not export.

Artifact directory layout::

    manifest.json        shapes, decode method, charset, token ids
    params.msgpack       the engine's variables in flax's layout
    serving_w<W>.pt2     exported program, one per decode width
"""

from __future__ import annotations

import io
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

# importing the wrappers registers the kernels' operators, which a loaded
# program calls
from rcnn_ocr_tpu_torch.ops import bilstm_scan as _bilstm_scan  # noqa: F401
from rcnn_ocr_tpu_torch.ops import se_scale as _se_scale  # noqa: F401
from rcnn_ocr_tpu_torch.parallel.mesh import ReplicaSet, gather_rows, serving_devices, to_host

# Format ladder: each artifact stamps the MINIMUM loader version that reads
# it correctly, so older loaders refuse loudly (the stamping rule is in
# export_serving_artifact):
# v2: explicit per-method decode dispatch; fixed-width methods, text-merge
#     attention_long and top-k tile kernels (ctc_long_beam / blank snap);
# v3: frame-aligned attention_long: the tile program has an extra
#     alignment output;
# v4: argmax tile programs (hybrid_long* and greedy/midpoint ctc_long): one
#     [B, T] ids output, manifest tile_kernel="argmax";
# v5: CTC confidence (opt-in, with_confidence=True): the fixed-width
#     ctc_greedy / ctc_beam programs have a third [B] fp32 output, and
#     greedy/midpoint ctc_long ships the (ids, maxp) tile program
#     (tile_kernel="argmax_maxp").  Confidence-free exports keep the older
#     stamps.
MANIFEST_VERSION = 5

CTC_LONG_METHODS = ("ctc_long", "ctc_long_beam")
ATTN_LONG_METHODS = ("attention_long", "attention_long_beam")
HYBRID_LONG_METHODS = ("hybrid_long", "hybrid_long_beam")
LONG_METHODS = CTC_LONG_METHODS + ATTN_LONG_METHODS + HYBRID_LONG_METHODS
FIXED_METHODS = ("attention", "attention_beam", "ctc_greedy", "ctc_beam")
ALL_METHODS = FIXED_METHODS + LONG_METHODS
PLATFORMS = ("cuda", "cpu")
KERNEL_PREFIXES = ("serving_w", "tiles_w", "decode_w")

# Knobs a config's ``export_artifact`` block may carry, mapped onto
# export_serving_artifact (plus slot / out_dir / quantize / lm / calibrate,
# which steer the checkpoint choice and the engine in the training loop).
EXPORT_REQUEST_KEYS = frozenset({
    "method", "slot", "out_dir", "quantize", "lm", "calibrate",
    "batch_size", "canvas",
    "max_length", "beam_width", "prune_k", "length_penalty", "lm_weight",
    "width_buckets", "platforms", "tile_w", "overlap", "snap", "merge",
    "min_gap", "margin", "confidence",
})

_NO_FUSION_METHODS = CTC_LONG_METHODS + ("hybrid_long", "attention_long", "attention",
                                         "ctc_greedy")
_PENALTY_METHODS = ("attention_beam", "attention_long_beam", "hybrid_long_beam")


def validate_export_request(req: Any, head: str = "both") -> Dict[str, Any]:
    """Normalize and validate a config ``export_artifact`` block at training
    start: ``req`` is ``True`` (all defaults) or a dict of
    :data:`EXPORT_REQUEST_KEYS`; ``head`` is the training head, and a method
    whose decode head is not trained is refused.  Returns the normalized
    dict (method and slot filled in)."""
    if req is True:
        out: Dict[str, Any] = {}
    elif isinstance(req, dict):
        out = dict(req)
    else:
        raise ValueError(f"export_artifact must be true or a dict of export knobs, got {req!r}")
    unknown = sorted(set(out) - EXPORT_REQUEST_KEYS)
    if unknown:
        raise ValueError(f"export_artifact: unknown key(s) {unknown}; "
                         f"known: {sorted(EXPORT_REQUEST_KEYS)}")
    has_attn = head in ("attention", "both")
    has_ctc = head in ("ctc", "both")
    method = out.setdefault("method", "ctc_greedy" if head == "ctc" else "attention")
    if method not in ALL_METHODS:
        raise ValueError(f"export_artifact: unknown method {method!r}; known: {ALL_METHODS}")
    if method.startswith(("attention", "hybrid")) and not has_attn:
        raise ValueError(f"export_artifact: method {method!r} decodes with the attention "
                         f"head, but head={head!r} does not train one")
    if method.startswith(("ctc", "hybrid")) and not has_ctc:
        raise ValueError(f"export_artifact: method {method!r} decodes with the CTC head, "
                         f"but head={head!r} does not train one")
    slot = out.setdefault("slot", "best_acc")
    if slot not in ("best_acc", "best_loss", "last"):
        raise ValueError(f"export_artifact: slot must be best_acc|best_loss|last, got {slot!r}")
    if out.get("snap", "midpoint") not in ("midpoint", "blank"):
        raise ValueError(f"export_artifact: bad snap {out['snap']!r}")
    if out.get("merge", "align") not in ("align", "text"):
        raise ValueError(f"export_artifact: bad merge {out['merge']!r}")
    # a policy knob the exporter would never read signals a misconfigured
    # block: refuse it on presence rather than drop it
    for knob, methods, what in (
        ("snap", CTC_LONG_METHODS, "the ctc_long junction stitcher"),
        ("merge", ATTN_LONG_METHODS, "the attention_long junction merge"),
        ("min_gap", HYBRID_LONG_METHODS, "the hybrid_long segmenter"),
        ("margin", HYBRID_LONG_METHODS, "the hybrid_long segmenter"),
    ):
        if knob in out and method not in methods:
            raise ValueError(f"export_artifact: {knob} only steers {what} "
                             f"(method={method!r} never reads it)")
    if (out.get("tile_w") is not None or out.get("overlap") is not None) \
            and method not in LONG_METHODS:
        raise ValueError(f"export_artifact: tile_w/overlap require a *_long method, got {method!r}")
    # export_serving_artifact's own refusals, checked here so that they fail
    # before the first epoch and not after the last
    if out.get("width_buckets") and method in LONG_METHODS:
        raise ValueError("export_artifact: width_buckets does not apply to *_long "
                         "methods (they tile at a single tile_w)")
    if out.get("lm_weight") and method in _NO_FUSION_METHODS:
        raise ValueError(f"export_artifact: lm_weight is not supported with method="
                         f"{method!r} (the greedy/stitched decode has no fusion hook)")
    if out.get("lm_weight") and not out.get("lm"):
        raise ValueError("export_artifact: lm_weight requires lm (path to a bigram LM.npz "
                         "from python -m rcnn_ocr_tpu_torch.lm)")
    if out.get("lm") and not out.get("lm_weight"):
        raise ValueError("export_artifact: lm without lm_weight never fuses — set "
                         "lm_weight > 0 (the beam program bakes the table in only when "
                         "the fusion weight is nonzero)")
    if out.get("length_penalty") and method not in _PENALTY_METHODS:
        raise ValueError(f"export_artifact: length_penalty is not supported with "
                         f"method={method!r}")
    cal = out.get("calibrate")
    # identity, not equality: 0 == False would slip past an `in` check
    if cal is not None and cal is not False:
        if cal is not True and (not isinstance(cal, int) or cal < 1):
            raise ValueError(f"export_artifact: calibrate must be true or a positive "
                             f"image count, got {cal!r}")
        if not out.get("quantize"):
            raise ValueError("export_artifact: calibrate records static int8 activation "
                             "scales — it requires quantize: true")
    if out.get("canvas") is not None:
        canvas = tuple(int(v) for v in out["canvas"])
        if len(canvas) != 2 or min(canvas) <= 0:
            raise ValueError(f"export_artifact: canvas must be [H, W], got {out['canvas']!r}")
        out["canvas"] = canvas
    return out


class _Decode(nn.Module):
    """The engine's model as a submodule, and one of its decode kernels."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *batch):
        return self.fn(*batch)


class _Program(nn.Module):
    """What ``torch.export`` traces: ``(params, *batch)``, the parameters
    swapped into the model for the call.  The decode module is held outside
    the module tree, so no weight is captured by the program."""

    def __init__(self, decode: _Decode):
        super().__init__()
        object.__setattr__(self, "decode", decode)

    def forward(self, params: Dict[str, torch.Tensor], *batch):
        return torch.func.functional_call(
            self.decode, {f"model.{k}": v for k, v in params.items()}, batch)


def _program_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every tensor a decode reads, by state name, in sorted order (the
    order a program's input spec records; the loader builds the same)."""
    named = dict(model.named_parameters())
    named.update((k, v) for k, v in model.named_buffers() if not k.endswith("num_batches_tracked"))
    return {k: named[k].detach() for k in sorted(named)}


def _export_program(model: nn.Module, fn, params, example) -> bytes:
    """Trace ``fn`` over ``(params, *example)`` and serialize the program,
    without its example inputs (which would carry the weights).  The batch
    dimension of every example is symbolic where ``torch.export`` can keep
    it so (``Dim.AUTO``: the range the traced operators allow, on the CUDA
    build up to 65535 rows), so the program also runs a replica's block of
    a batch."""
    batch = torch.export.Dim.AUTO
    dynamic = ({k: None for k in params}, tuple({0: batch} for _ in example))
    with torch.no_grad():
        ep = torch.export.export(_Program(_Decode(model, fn)), (params, *example),
                                 dynamic_shapes=dynamic)
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_serving_artifact(
    ocr,  # OCRInference
    out_dir: str,
    method: str = "ctc_greedy",
    batch_size: int = 256,
    canvas: Tuple[int, int] = (64, 512),
    max_length: int = 25,
    beam_width: int = 16,
    prune_k: int = 16,
    length_penalty: float = 0.0,  # attention_beam: score / len**p
    lm_weight: float = 0.0,  # beam shallow fusion (the engine's lm=)
    width_buckets: Optional[Sequence[int]] = None,
    platforms: Optional[Sequence[str]] = None,
    tile_w: Optional[int] = None,  # *_long: tile width (default img_w)
    overlap: Optional[int] = None,  # *_long: junction overlap px
    snap: str = "midpoint",  # ctc_long*: junction cuts ("midpoint"|"blank")
    merge: str = "align",  # attention_long*: junction merge ("align"|"text")
    min_gap: int = 3,  # hybrid_long*: blank frames that split segments
    margin: int = 1,  # hybrid_long*: context frames around each segment
    with_confidence: bool = False,  # ctc methods: confidence outputs
) -> str:
    """Export an :class:`OCRInference` serving configuration to ``out_dir``.

    ``width_buckets`` defaults to the engine's own buckets (or its single
    ``img_w``); every width becomes one program.  ``platforms`` lists the
    torch devices the artifact may run on (default: the exporting engine's
    device only).  ``ctc_long*`` exports the per-tile frame program with the
    tiling and stitch policy in the manifest, ``attention_long*`` the
    per-tile decode (with the alignment output for ``merge="align"``), and
    ``hybrid_long*`` both the CTC tile program and the attention decode
    program; the loader runs the live engine's host drivers around them.
    Every knob is validated and every program traced in memory before the
    directory is touched.  Returns ``out_dir``.
    """
    from rcnn_ocr_tpu_torch.long_lines import resolve_tiling
    from rcnn_ocr_tpu_torch.models.rcnn import TIME_DOWNSAMPLE
    from rcnn_ocr_tpu_torch.training.checkpoint import msgpack_serialize

    if getattr(ocr, "_mesh", None) is not None:
        raise ValueError(
            "export requires a single-device OCRInference (mesh=None); "
            "shard the exported artifact at load time instead: "
            "ServingArtifact.load(dir, mesh=True)"
        )
    if method not in ALL_METHODS:
        raise ValueError(f"unknown method {method!r}; known: {ALL_METHODS}")
    if platforms is not None:
        unknown = [p for p in platforms if p not in PLATFORMS]
        if unknown:
            raise ValueError(f"platforms: unknown device(s) {unknown}; known: {PLATFORMS}")
    long_mode = method in LONG_METHODS
    if method in CTC_LONG_METHODS and snap not in ("midpoint", "blank"):
        raise ValueError(f"snap must be 'midpoint' or 'blank', got {snap!r}")
    if method in ATTN_LONG_METHODS and merge not in ("align", "text"):
        raise ValueError(f"merge must be 'align' or 'text', got {merge!r}")
    if long_mode and width_buckets:
        raise ValueError("width_buckets does not apply to long-line methods — they tile "
                         "at a single tile_w; pass tile_w/overlap instead")
    # the manifest must never record a knob the programs do not apply
    if lm_weight and method in _NO_FUSION_METHODS:
        raise ValueError(f"lm_weight is not supported with method={method!r} "
                         "(the greedy/stitched decode has no fusion hook)")
    if length_penalty and method not in _PENALTY_METHODS:
        raise ValueError(f"length_penalty is not supported with method={method!r}")
    if long_mode:
        tile_w, overlap = resolve_tiling(
            ocr.img_w, tile_w, overlap,
            require_frame_aligned=method in ATTN_LONG_METHODS and merge == "align")
        widths = [int(tile_w)]
    else:
        widths = [int(w) for w in (width_buckets or ocr.width_buckets or [ocr.img_w])]
    canvas_h, canvas_w = int(canvas[0]), int(canvas[1])

    dev = ocr.device
    params = _program_params(ocr.model)
    raw = torch.zeros((batch_size, canvas_h, canvas_w, 3), dtype=torch.uint8, device=dev)
    # [h, w] + the host's float64 placed rect [dst_h, dst_w, y0]
    sizes = torch.ones((batch_size, 5), dtype=torch.int32, device=dev)

    def tiles(w: int):
        return (torch.zeros((batch_size, ocr.img_h, w, 3), dtype=torch.uint8, device=dev),)

    def export(fn, example) -> bytes:
        return _export_program(ocr.model, fn, params, example)

    files: Dict[str, str] = {}
    decode_files: Dict[str, str] = {}
    # traced and serialized in memory before any file is touched: a failed
    # re-export leaves a previously good artifact intact
    pending: List[Tuple[str, bytes]] = []
    for w in widths:
        if method in HYBRID_LONG_METHODS:
            # the segmenter reads per-frame argmax ids; the decode program
            # reads each cropped segment
            pending.append((f"tiles_w{w}.pt2", export(ocr.tile_ids_kernel(), tiles(w))))
            files[str(w)] = f"tiles_w{w}.pt2"
            dec = ocr.decode_kernel(
                max_length=max_length,
                beam_width=beam_width if method == "hybrid_long_beam" else 0,
                length_penalty=length_penalty, lm_weight=lm_weight)
            pending.append((f"decode_w{w}.pt2", export(dec, tiles(w))))
            decode_files[str(w)] = f"decode_w{w}.pt2"
            continue
        if long_mode:
            if method in ATTN_LONG_METHODS:
                kernel = ocr.decode_kernel(
                    max_length=max_length,
                    beam_width=beam_width if method == "attention_long_beam" else 0,
                    length_penalty=length_penalty, lm_weight=lm_weight,
                    with_alignment=merge == "align")
            elif method == "ctc_long" and snap == "midpoint":
                # greedy/midpoint reads only each frame's argmax (and, with
                # confidence, its max-softmax); beam and blank snap need top k
                kernel = ocr.tile_ids_kernel(with_maxp=with_confidence)
            else:
                kernel = ocr.tile_kernel(prune_k=prune_k)
            fname = f"tiles_w{w}.pt2"
            blob = export(kernel, tiles(w))
        else:
            kernel = ocr.serving_kernel(
                method=method, max_length=max_length, target_w=w, beam_width=beam_width,
                prune_k=prune_k, length_penalty=length_penalty, lm_weight=lm_weight,
                with_confidence=with_confidence and method in ("ctc_greedy", "ctc_beam"))
            fname = f"serving_w{w}.pt2"
            blob = export(kernel, (raw, sizes))
        pending.append((fname, blob))
        files[str(w)] = fname

    # every program traced: now touch the directory (the directory is the
    # deployment unit, so programs of an earlier width set go)
    os.makedirs(out_dir, exist_ok=True)
    for fname in os.listdir(out_dir):
        if fname.startswith(KERNEL_PREFIXES) and fname.endswith(".pt2"):
            os.remove(os.path.join(out_dir, fname))
    for fname, blob in pending:
        with open(os.path.join(out_dir, fname), "wb") as f:
            f.write(blob)
    with open(os.path.join(out_dir, "params.msgpack"), "wb") as f:
        f.write(msgpack_serialize(ocr.variables))

    cs = ocr.charset
    # the MINIMUM loader version that reads this artifact correctly
    ctc_conf = bool(with_confidence) and (
        method in ("ctc_greedy", "ctc_beam") or (method == "ctc_long" and snap == "midpoint"))
    if ctc_conf:
        fmt = 5
    elif method in HYBRID_LONG_METHODS or (method == "ctc_long" and snap == "midpoint"):
        fmt = 4
    elif method in ATTN_LONG_METHODS and merge == "align":
        fmt = 3
    else:
        fmt = 2
    manifest: Dict[str, Any] = {
        "format_version": fmt,
        "method": method,
        "max_length": max_length,
        "batch_size": batch_size,
        "canvas": [canvas_h, canvas_w],
        "img_h": ocr.img_h,
        "widths": widths,
        "beam_width": beam_width,
        "prune_k": prune_k,
        "length_penalty": length_penalty,
        "lm_weight": lm_weight,
        "itos": list(cs.itos),
        "ids": {"pad": cs.pad_id, "sos": cs.sos_id, "eos": cs.eos_id, "blank": cs.blank_id,
                "ctc_blank": cs.ctc_blank_id},
        "quantize": bool(ocr.model.quantize),
        "act_quant": ocr.model.act_quant,
        "ctc_confidence": ctc_conf,
        "platforms": list(platforms) if platforms else None,
        "torch_version": torch.__version__,
        "files": files,
    }
    if long_mode:
        manifest["tile_w"] = int(tile_w)
        manifest["overlap"] = int(overlap)
        if method in CTC_LONG_METHODS:
            manifest["snap"] = snap
            if method == "ctc_long" and snap == "midpoint":
                manifest["tile_kernel"] = "argmax_maxp" if ctc_conf else "argmax"
            else:
                manifest["tile_kernel"] = "topk"
        elif method in HYBRID_LONG_METHODS:
            manifest["decode_files"] = decode_files
            manifest["min_gap"] = int(min_gap)
            manifest["margin"] = int(margin)
            manifest["tile_kernel"] = "argmax"
        else:
            manifest["merge"] = merge
            if merge == "align":
                manifest["frames_t"] = int(tile_w) // TIME_DOWNSAMPLE
    tmp = os.path.join(out_dir, "manifest.json.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, ensure_ascii=False, indent=1)
    os.replace(tmp, os.path.join(out_dir, "manifest.json"))
    return out_dir


def _program_device(ep) -> str:
    """The device a program was exported on (``"cuda:0"``, ``"cpu"``): its
    first user input's (lifted constants, which come first, may lie
    elsewhere)."""
    user_inputs = set(ep.graph_signature.user_inputs)
    for node in ep.graph.nodes:
        val = node.meta.get("val") if node.op == "placeholder" else None
        if node.name in user_inputs and isinstance(val, torch.Tensor):
            return str(val.device)
    raise ValueError("the program has no tensor input")


def _children(spec) -> list:
    # TreeSpec.children() in newer torch, children_specs before it
    kids = getattr(spec, "children", None)
    return kids() if callable(kids) else spec.children_specs


def _param_names(ep) -> List[str]:
    """The keys of a program's ``params`` argument, in its input spec's order."""
    args_spec = _children(ep.call_spec.in_spec)[0]
    return list(_children(args_spec)[0].context)


class ServingArtifact:
    """Serve from an exported artifact directory, with no model code.

    Mirrors ``OCRInference.predict_serving``'s host side (letterbox canvas,
    bucket routing, pad to the static batch, decode rules) while the device
    runs the loaded programs.  ``device="auto"`` is the card (raising
    without one); ``"cpu"`` when asked for.  ``mesh`` serves data-parallel
    as ``OCRInference(mesh=)`` does (the manifest's ``batch_size`` must tile
    the replicas).
    """

    def __init__(self, base_dir: str, device: Union[str, torch.device] = "auto",
                 mesh: Any = None):
        from rcnn_ocr_tpu_torch.inference import resolve_device
        from rcnn_ocr_tpu_torch.interop.jax_params import port_state_from_jax
        from rcnn_ocr_tpu_torch.training.checkpoint import msgpack_restore

        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._mesh = serving_devices(mesh, self.device)
        if self._mesh is not None:
            self.device = self._mesh[0]
        self._replicas = ReplicaSet(self._mesh or [self.device], mesh=self._mesh is not None)
        self.base_dir = base_dir
        with open(os.path.join(base_dir, "manifest.json"), encoding="utf-8") as f:
            m = self.manifest = json.load(f)
        if m["format_version"] > MANIFEST_VERSION:
            raise ValueError(f"artifact format {m['format_version']} is newer than this "
                             f"loader ({MANIFEST_VERSION})")
        self.method: str = m["method"]
        self.batch_size: int = int(m["batch_size"])
        n = len(self._replicas)
        if self._mesh is not None and self.batch_size % n:
            raise ValueError(f"artifact batch_size {self.batch_size} does not tile the mesh "
                             f"data axis ({n} devices); re-export with a divisible batch size")
        with open(os.path.join(base_dir, "params.msgpack"), "rb") as f:
            self.variables = msgpack_restore(f.read())
        # on each device once: the programs read them on every call
        state = port_state_from_jax(self.variables)
        self._states = {d: {k: torch.tensor(v, device=d) for k, v in state.items()}
                        for d in dict.fromkeys(self._replicas.devices)}
        self._itos: List[str] = list(m["itos"])
        self._ids = m["ids"]
        self.canvas: Tuple[int, int] = (int(m["canvas"][0]), int(m["canvas"][1]))
        self.img_h: int = int(m["img_h"])
        self.widths: List[int] = [int(w) for w in m["widths"]]
        self.tile_w: Optional[int] = int(m["tile_w"]) if "tile_w" in m else None
        self.overlap: Optional[int] = int(m["overlap"]) if "overlap" in m else None
        self._calls: Dict[int, Any] = {int(w): self._load(f) for w, f in m["files"].items()}
        # hybrid artifacts carry a second program set: the attention decode
        self._decode_calls: Dict[int, Any] = {
            int(w): self._load(f) for w, f in m.get("decode_files", {}).items()}

    @classmethod
    def load(cls, base_dir: str, device: Union[str, torch.device] = "auto",
             mesh: Any = None) -> "ServingArtifact":
        """Open an artifact directory on ``device``, or data-parallel over
        ``mesh`` (``True``: every visible card; or a sequence of devices)."""
        return cls(base_dir, device=device, mesh=mesh)

    def _load(self, fname: str):
        """A program as a call of host batch arrays returning host arrays:
        one copy of it on each device, each replica taking its block of the
        batch's rows (the whole batch without a mesh)."""
        path = os.path.join(self.base_dir, fname)
        programs: Dict[torch.device, Tuple[nn.Module, Dict[str, torch.Tensor]]] = {}
        for dev, state in self._states.items():
            # the move pass changes a program in place: a fresh one per device
            ep = torch.export.load(path)
            exported_on = torch.device(_program_device(ep))
            if exported_on.type != dev.type:
                listed = self.manifest.get("platforms") or [exported_on.type]
                if dev.type not in listed:
                    raise ValueError(
                        f"{fname} was exported on {exported_on.type!r} and the artifact lists "
                        f"platforms {listed}, not {dev.type!r}; re-export with platforms "
                        f"including {dev.type!r}")
            if exported_on != dev:  # another type, or another card
                from torch.export.passes import move_to_device_pass

                ep = move_to_device_pass(ep, dev)
            missing = [k for k in _param_names(ep) if k not in state]
            if missing:
                raise KeyError(f"{fname} reads tensors params.msgpack does not hold: {missing}")
            programs[dev] = ep.module(), {k: state[k] for k in _param_names(ep)}

        @torch.inference_mode()
        def call(*batch: np.ndarray):
            def work(i: int, lo: int, hi: int):
                dev = self._replicas.devices[i]
                module, params = programs[dev]
                return to_host(module(params, *(
                    torch.from_numpy(np.ascontiguousarray(b[lo:hi])).to(dev) for b in batch)))
            return gather_rows(self._replicas.run(work, len(batch[0])))
        return call

    # -- host pipeline (predict_serving parity) -----------------------------
    def _decode_rows(self, pred, aux, n_real: int, return_confidence: bool, conf=None):
        """Token rows -> texts through the live engine's postprocess
        functions; ``conf`` is the v5 CTC programs' ``[B]`` confidence row."""
        from rcnn_ocr_tpu_torch.postprocess import (
            ctc_skip_ids,
            decode_attention_row,
            decode_beam_row,
            decode_ctc_batch,
        )

        ids = self._ids
        pred = np.asarray(pred)
        row_kw = dict(pad_id=ids["pad"], eos_id=ids["eos"], blank_id=ids["blank"],
                      return_confidence=return_confidence)
        if self.method == "attention_beam":
            scores = np.asarray(aux)
            return [decode_beam_row(pred[j], scores[j], self._itos, **row_kw)
                    for j in range(n_real)]
        if self.method in ("ctc", "ctc_greedy", "ctc_beam"):
            texts = decode_ctc_batch(pred, aux, n_real, self._itos,
                                     ctc_skip_ids(ids["pad"], ids["sos"], ids["eos"],
                                                  ids["ctc_blank"]))
            if return_confidence:
                conf_rows = np.asarray(conf)
                return [(texts[j], float(conf_rows[j])) for j in range(n_real)]
            return texts
        if self.method != "attention":
            raise ValueError(
                f"artifact decode method {self.method!r} is unknown to this loader "
                f"(format {self.manifest['format_version']}); upgrade rcnn_ocr_tpu_torch "
                "on the serving host")
        maxp = np.asarray(aux)
        return [decode_attention_row(pred[j], maxp[j], self._itos, **row_kw)
                for j in range(n_real)]

    def _predict_long(self, images_list: List[Any], return_confidence: bool = False) -> List[Any]:
        """Unbounded-width decode from the tile program through the live
        engine's host drivers (:mod:`rcnn_ocr_tpu_torch.long_lines`)."""
        from rcnn_ocr_tpu_torch.data.transforms import ResizeAndPad, load_rgb_uint8
        from rcnn_ocr_tpu_torch.long_lines import (
            decode_stitched,
            decode_stitched_ids,
            extract_tile_frames,
            extract_tile_ids,
            merge_tile_texts,
            plan_tiles,
            stitch_aligned_rows,
        )
        from rcnn_ocr_tpu_torch.postprocess import ctc_skip_ids, pad_rows
        from rcnn_ocr_tpu_torch.vocab.charset import decode_tokens

        m = self.manifest
        tile_w, overlap = self.tile_w, self.overlap
        pad_one = ResizeAndPad(img_h=self.img_h, img_w=tile_w)
        if self.method in HYBRID_LONG_METHODS:
            return self._predict_hybrid(images_list, tile_w, overlap, pad_one, return_confidence)
        rgb = [np.ascontiguousarray(load_rgb_uint8(img)) for img in images_list]
        tiles, plans = plan_tiles(rgb, self.img_h, tile_w, overlap, pad_one)
        call = self._calls[tile_w]
        ids = self._ids

        if self.method in ATTN_LONG_METHODS:
            aligned = m.get("merge", "text") == "align"
            tok_rows: List[np.ndarray] = []
            align_rows: List[np.ndarray] = []
            for i in range(0, len(tiles), self.batch_size):
                chunk, n_real = pad_rows(tiles[i : i + self.batch_size], self.batch_size)
                outs = call(np.stack(chunk))
                tok_rows.extend(outs[0][:n_real])
                if aligned:
                    align_rows.extend(outs[-1][:n_real])

            def tile_text(row: np.ndarray) -> str:
                return decode_tokens(row, self._itos, pad_id=ids["pad"], eos_id=ids["eos"],
                                     blank_id=ids["blank"])

            skip_ids = {v for v in (ids["pad"], ids["blank"]) if v is not None}
            out: List[str] = []
            for first, starts in plans:
                if len(starts) == 1:
                    out.append(tile_text(tok_rows[first]))
                elif aligned:
                    out.append(stitch_aligned_rows(
                        np.stack(tok_rows[first : first + len(starts)]),
                        np.stack(align_rows[first : first + len(starts)]),
                        starts, tile_w, int(m["frames_t"]), eos_id=ids["eos"],
                        skip_ids=skip_ids, itos=self._itos))
                else:
                    out.append(merge_tile_texts(
                        [tile_text(tok_rows[first + j]) for j in range(len(starts))],
                        tile_w, starts))
            return out

        skip = ctc_skip_ids(ids["pad"], ids["sos"], ids["eos"], ids["ctc_blank"])
        tk = m.get("tile_kernel")
        if tk in ("argmax", "argmax_maxp"):
            with_maxp = tk == "argmax_maxp"
            got = extract_tile_ids(tiles, self.batch_size, call, with_maxp=with_maxp)
            frame_ids, maxp = got if with_maxp else (got, None)
            return decode_stitched_ids(frame_ids, plans, tile_w, blank_id=ids["ctc_blank"],
                                       itos=self._itos, skip_ids=skip,
                                       maxp=maxp if return_confidence else None)
        vals, idx = extract_tile_frames(tiles, self.batch_size, call)
        return decode_stitched(
            vals, idx, plans, tile_w, blank_id=ids["ctc_blank"], num_classes=len(self._itos),
            itos=self._itos, skip_ids=skip,
            method="beam" if self.method == "ctc_long_beam" else "greedy",
            beam_width=int(m.get("beam_width", 16)), snap=m.get("snap", "midpoint"),
            return_confidence=return_confidence)

    def _predict_hybrid(self, images_list: List[Any], tile_w: int, overlap: int, pad_one,
                        return_confidence: bool = False) -> List[Any]:
        """The hybrid decode from the artifact's two programs through the
        live engine's driver (``long_lines.hybrid_decode_driver``)."""
        from rcnn_ocr_tpu_torch.data.transforms import load_rgb_uint8
        from rcnn_ocr_tpu_torch.long_lines import hybrid_decode_driver
        from rcnn_ocr_tpu_torch.postprocess import decode_attention_row, decode_beam_row

        m = self.manifest
        ids = self._ids
        row_fn = decode_beam_row if self.method == "hybrid_long_beam" else decode_attention_row

        def decode_row(pred_row, aux_row):
            return row_fn(pred_row, aux_row, self._itos, pad_id=ids["pad"], eos_id=ids["eos"],
                          blank_id=ids["blank"], return_confidence=return_confidence)

        return hybrid_decode_driver(
            [np.ascontiguousarray(load_rgb_uint8(img)) for img in images_list],
            self.img_h, tile_w, overlap, pad_one, self.batch_size,
            tile_fn=self._calls[tile_w], decode_fn=self._decode_calls[tile_w],
            decode_row=decode_row, blank_id=ids["ctc_blank"],
            min_gap=int(m.get("min_gap", 3)), margin=int(m.get("margin", 1)),
            return_confidence=return_confidence)

    def predict(self, images: Union[Any, List[Any]], return_confidence: bool = False):
        """Decode image paths / arrays / PIL-like images to strings (or
        ``(text, confidence)``).  A single image in gives a single result."""
        from rcnn_ocr_tpu_torch.data.loader import bucket_for_width, scaled_width
        from rcnn_ocr_tpu_torch.data.transforms import load_rgb_uint8
        from rcnn_ocr_tpu_torch.ops.preprocess import host_letterbox, host_resize_geometry
        from rcnn_ocr_tpu_torch.postprocess import chunk_indices, pad_rows

        if return_confidence and self.method in ATTN_LONG_METHODS:
            raise ValueError(
                "return_confidence is not supported by tiled attention-merge artifacts "
                "(junction-merged decodes have no step-aligned confidence) — use "
                "hybrid_long or a ctc method")
        if (return_confidence and not self.manifest.get("ctc_confidence", False)
                and (self.method in ("ctc", "ctc_greedy", "ctc_beam")
                     or (self.method == "ctc_long"
                         and self.manifest.get("tile_kernel") != "topk"))):
            raise ValueError(
                "this artifact was exported without the CTC confidence outputs — "
                "re-export with with_confidence=True (export_serving_artifact) / "
                "--confidence (the CLI) to serve confidences")
        is_single = not isinstance(images, list)
        images_list = [images] if is_single else list(images)
        if not images_list:
            return []
        if self.method in LONG_METHODS:
            results_long = self._predict_long(images_list, return_confidence)
            return results_long[0] if is_single else results_long

        rgb = [np.ascontiguousarray(load_rgb_uint8(img)) for img in images_list]
        groups: Dict[int, List[int]] = {}
        for i, arr in enumerate(rgb):
            w = bucket_for_width(scaled_width(arr.shape[0], arr.shape[1], self.img_h),
                                 self.widths)
            groups.setdefault(w, []).append(i)
        chunks = chunk_indices(groups, self.batch_size)
        canvas_h, canvas_w = self.canvas

        def letterbox_chunk(chunk):
            w, idxs = chunk
            rows, n_real = pad_rows([rgb[j] for j in idxs], self.batch_size)
            raw, sizes = host_letterbox(rows, canvas_h, canvas_w)
            geom = host_resize_geometry(sizes, self.img_h, w)
            return w, idxs, n_real, raw, np.concatenate([sizes, geom], axis=1)

        results: List[Any] = [None] * len(images_list)
        # letterbox chunk k+1 on a worker thread while chunk k decodes
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(letterbox_chunk, chunks[0])
            for k in range(len(chunks)):
                w, idxs, n_real, raw, sizes = pending.result()
                if k + 1 < len(chunks):
                    pending = pool.submit(letterbox_chunk, chunks[k + 1])
                out = self._calls[w](raw, sizes)
                # v5 CTC programs ship (pred, aux, conf); the others (pred, aux)
                texts = self._decode_rows(out[0], out[1], n_real, return_confidence,
                                          conf=out[2] if len(out) == 3 else None)
                for j, out_idx in enumerate(idxs):
                    results[out_idx] = texts[j]
        return results[0] if is_single else results
