"""Describe an exported serving artifact without loading it.

The port's copy of the JAX package's ``tools/artifact_info.py``, with the
same arguments and output, for the port's artifacts.  Reads only
``manifest.json`` + file sizes (no torch import, no program loading), so
it is safe to run anywhere — a deploy pipeline can gate on it before
shipping an artifact to a fleet:

    python -m rcnn_ocr_tpu_torch.artifact_info exp1/artifact
    python -m rcnn_ocr_tpu_torch.artifact_info exp1/artifact --json

Exit codes: 0 readable by this tree's loader; 1 missing/corrupt; 2 the
artifact is NEWER than this loader understands (refuse to deploy).

The manifest layout is written by
:func:`rcnn_ocr_tpu_torch.export.export_serving_artifact`; the
``format_version`` gate mirrors ``ServingArtifact.load``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# keep in sync with rcnn_ocr_tpu_torch.export.MANIFEST_VERSION — duplicated
# on purpose so this tool stays import-free (usable on hosts with no torch)
KNOWN_MANIFEST_VERSION = 5


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024.0
    return f"{n} B"


def artifact_info(artifact_dir: str) -> dict:
    """Collect a summary dict for ``artifact_dir`` (raises on missing)."""
    manifest_path = os.path.join(artifact_dir, "manifest.json")
    with open(manifest_path, encoding="utf-8") as f:
        m = json.load(f)
    kernel_files = dict(m.get("files", {}))
    kernel_files.update(m.get("decode_files", {}))
    files = []
    total = 0
    for name in sorted(os.listdir(artifact_dir)):
        path = os.path.join(artifact_dir, name)
        if not os.path.isfile(path):
            continue
        size = os.path.getsize(path)
        total += size
        files.append({"name": name, "bytes": size})
    info = {
        "dir": artifact_dir,
        "format_version": m.get("format_version", 1),
        "readable": m.get("format_version", 1) <= KNOWN_MANIFEST_VERSION,
        "method": m.get("method"),
        "batch_size": m.get("batch_size"),
        "widths": m.get("widths"),
        "canvas": m.get("canvas"),
        "img_h": m.get("img_h"),
        "max_length": m.get("max_length"),
        "beam_width": m.get("beam_width"),
        "lm_fused": bool(m.get("lm_weight")),
        "quantize": m.get("quantize"),
        "act_quant": m.get("act_quant"),
        "charset_size": len(m.get("itos", [])),
        "platforms": m.get("platforms"),
        "torch_version": m.get("torch_version"),
        "kernel_count": len(kernel_files),
        "files": files,
        "total_bytes": total,
    }
    for key in ("tile_w", "overlap", "snap", "tile_kernel", "merge",
                "min_gap", "margin", "frames_t"):
        if key in m:
            info[key] = m[key]
    return info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                prog="python -m rcnn_ocr_tpu_torch.artifact_info")
    p.add_argument("artifact", help="artifact directory")
    p.add_argument("--json", action="store_true", help="print as one JSON object")
    args = p.parse_args(argv)
    try:
        info = artifact_info(args.artifact)
    except FileNotFoundError:
        print(f"not an artifact (no manifest.json): {args.artifact}")
        return 1
    except (json.JSONDecodeError, OSError) as e:
        print(f"unreadable manifest: {e}")
        return 1

    if args.json:
        print(json.dumps(info))
    else:
        print(f"artifact:        {info['dir']}")
        ver_note = "" if info["readable"] else (
            f"  <-- NEWER than this loader (knows <= {KNOWN_MANIFEST_VERSION})"
        )
        print(f"format_version:  {info['format_version']}{ver_note}")
        print(f"method:          {info['method']}")
        geom = f"img_h {info['img_h']}, widths {info['widths']}"
        if "tile_w" in info:
            geom += f", tile_w {info['tile_w']}, overlap {info['overlap']}"
        print(f"geometry:        {geom}  (canvas {info['canvas']})")
        print(f"batch_size:      {info['batch_size']}")
        decode = f"max_length {info['max_length']}"
        if info["method"] and "beam" in info["method"]:
            decode += f", beam_width {info['beam_width']}"
        for key in ("snap", "tile_kernel", "merge", "min_gap", "margin"):
            if key in info:
                decode += f", {key} {info[key]}"
        if info["lm_fused"]:
            decode += ", LM fused"
        print(f"decode:          {decode}")
        quant = "int8" if info["quantize"] else "off"
        if info["quantize"] and info.get("act_quant"):
            quant += f" ({info['act_quant']} activation scales)"
        print(f"quantization:    {quant}")
        print(f"charset:         {info['charset_size']} tokens")
        print(
            f"platforms:       {info['platforms'] or ['(export default)']}"
            f"  (exported with torch {info['torch_version']})"
        )
        print(f"kernels:         {info['kernel_count']}")
        for f in info["files"]:
            print(f"  {f['name']:<28} {_fmt_bytes(f['bytes'])}")
        print(f"total:           {_fmt_bytes(info['total_bytes'])}")

    if not info["readable"]:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
