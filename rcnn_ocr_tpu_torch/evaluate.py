"""Dataset evaluation CLI of the port (counterpart of ``evaluate_dataset.py``).

    python -m rcnn_ocr_tpu_torch.evaluate --model model.msgpack \\
        --charset charset.txt --csv labels.csv --root images/ \\
        [--decode attention|attention_beam|ctc_greedy|ctc_beam|ctc_long|...] \\
        [--serving] [--tile-w PX --overlap PX] [--quantize [--static-quant \\
        [--save-calibration PATH]]] [--device cuda]
    python -m rcnn_ocr_tpu_torch.evaluate --artifact exp1/artifact \\
        --csv labels.csv --root images/

Loads a labeled CSV (a header row naming ``filename`` and ``text``; a
filename without its extension is completed from the image extensions),
decodes the images with :class:`OCRInference` (or, with ``--artifact``, an
exported :class:`~rcnn_ocr_tpu_torch.export.ServingArtifact`, whose decode
configuration is baked in: the flags it fixes are refused beside it), prints exact-match
accuracy, mean CER and WER with their min / max / median and the five worst
rows by CER, and writes ``evaluation_results_<model file name>.csv`` (one
row per sample: ``image_path, true_text, predicted_text, cer, wer,
exact_match``) into the working directory.

``--lm`` / ``--lm-weight`` fuse a bigram table into the beams; a comma list
of weights evaluates each and prints a comparison table.
``--length-penalty`` ranks the attention beam's final hypotheses.
``--width-buckets`` is a list of widths or ``auto:K`` (K widths fitted to
the data's header sizes).  ``--serving`` decodes through
``predict_serving`` (resize-pad on the device) with any of the four
fixed-width decodes; the ``*_long`` decodes (``ctc_long[_beam]``,
``attention_long[_beam]``, ``hybrid_long[_beam]``) tile each line at
``--tile-w`` px (default ``--img-w``) overlapping by ``--overlap`` px.  ``--error-analysis`` adds accuracy by text length
and the top character confusions; ``--report-json`` writes the metrics.
``--quantize`` runs the int8 engine; ``--static-quant`` (which implies it)
calibrates static scales on up to 256 of the images first, and
``--save-calibration`` writes the calibrated checkpoint.  The engine runs
on the card unless ``--device cpu`` is given.

The CSV is read by the ``csv`` module: every field is the literal string
(pandas, in the JAX CLI, would read an empty text as ``nan`` and ``007`` as
``7``).  ``--compile-cache-dir`` (XLA's compile cache) is accepted by the
parser and refused with exit code 1.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
from collections import Counter
from typing import List, Optional, Tuple

import numpy as np
import torch

from rcnn_ocr_tpu_torch.data.image_io import image_size
from rcnn_ocr_tpu_torch.data.loader import optimal_width_buckets, scaled_width
from rcnn_ocr_tpu_torch.inference import OCRInference
from rcnn_ocr_tpu_torch.training.metrics import (
    batch_character_error_rate,
    compute_accuracy,
    edit_ops,
    word_error_rate,
)
from rcnn_ocr_tpu_torch.utils.progress import progress

IMAGE_EXTS = [".png", ".jpg", ".jpeg", ".bmp", ".tiff"]
DECODES = ("attention", "attention_beam", "ctc_greedy", "ctc_beam")
LONG_DECODES = ("ctc_long", "ctc_long_beam", "attention_long", "attention_long_beam",
                "hybrid_long", "hybrid_long_beam")
# the predict_long method of each tiled attention / hybrid decode
LONG_METHODS = {"attention_long": "attention", "attention_long_beam": "attention_beam",
                "hybrid_long": "hybrid", "hybrid_long_beam": "hybrid_beam"}
# option -> why the port refuses it today
LATER = {
    "--compile-cache-dir": "has no counterpart in the port: XLA's compile cache does not "
                           "apply (the port's kernels build once into build/rcnn_ocr_tpu_torch/); "
                           "a later slice of the port may take the flag",
}


def load_dataset(csv_path: str, root_path: str) -> Tuple[List[str], List[str]]:
    """CSV with ``filename`` and ``text`` columns -> (image paths, texts);
    rows whose image is missing are reported and skipped."""
    if not os.path.exists(csv_path):
        raise FileNotFoundError(f"CSV file not found: {csv_path}")
    if not os.path.exists(root_path):
        raise FileNotFoundError(f"Images folder not found: {root_path}")
    with open(csv_path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
        columns = rows[0].keys() if rows else []
    if "filename" not in columns or "text" not in columns:
        raise ValueError("CSV must contain 'filename' and 'text' columns")

    image_paths: List[str] = []
    texts: List[str] = []
    for row in rows:
        filename, text = row["filename"], row["text"] or ""
        image_path = os.path.join(root_path, filename)
        if not os.path.exists(image_path):
            for ext in IMAGE_EXTS:
                candidate = os.path.join(root_path, filename + ext)
                if os.path.exists(candidate):
                    image_path = candidate
                    break
        if os.path.exists(image_path):
            image_paths.append(image_path)
            texts.append(text)
        else:
            print(f"  image not found: {filename}")
    return image_paths, texts


def evaluate_model(
    model_path: str,
    charset_path: str,
    csv_path: str,
    root_path: str,
    batch_size: int = 16,
    max_samples: Optional[int] = None,
    img_h: int = 32,
    img_w: int = 128,
    decode: str = "attention",
    max_length: int = 25,
    beam_width: int = 16,
    lm: Optional[str] = None,
    lm_weight: float = 0.0,
    length_penalty: float = 0.0,
    width_buckets=None,
    serving: bool = False,
    tile_w: Optional[int] = None,
    overlap: Optional[int] = None,
    error_analysis: bool = False,
    device: str = "cuda",
    dtype: torch.dtype = torch.bfloat16,
    quantize: bool = False,
    static_quant: bool = False,
    save_calibration: Optional[str] = None,
    artifact: Optional[str] = None,
):
    """Decode the dataset with one configuration and report its metrics
    (``evaluate_dataset.py:evaluate_model``); returns ``{"accuracy", "cer",
    "wer", "n"}`` (and ``"analysis"``), or None when no image was found."""
    if decode not in DECODES + LONG_DECODES:
        raise ValueError(f"unknown decode mode: {decode}")
    if serving and decode not in DECODES:
        raise ValueError(f"--serving does not support --decode {decode!r}")
    long_decode = decode in LONG_DECODES
    if (tile_w or overlap) and not long_decode:
        raise ValueError("--tile-w/--overlap require a *_long --decode")
    print("Evaluating model on dataset")
    if artifact:
        print(f"  artifact: {artifact}")
    else:
        print(f"  model:   {model_path}")
        print(f"  charset: {charset_path}")
    print(f"  csv:     {csv_path}")
    print(f"  images:  {root_path}")
    if not artifact:
        print(f"  size:    {img_h}x{img_w}   decode: {decode}"
              f"{'   int8' if quantize else ''}{'-static' if static_quant else ''}"
              f"{'   serving' if serving else ''}   device: {device}")
    print("-" * 60)

    image_paths, true_texts = load_dataset(csv_path, root_path)
    if max_samples:
        image_paths = image_paths[:max_samples]
        true_texts = true_texts[:max_samples]
    print(f"Found {len(image_paths)} samples")
    if not image_paths:
        print("No data to evaluate!")
        return None

    if isinstance(width_buckets, str) and width_buckets.startswith("auto"):
        # "auto" / "auto:K": K waste-minimizing widths from the data's headers
        k = int(width_buckets.split(":")[1]) if ":" in width_buckets else 4
        scaled = [scaled_width(*image_size(p), img_h) for p in image_paths]
        width_buckets = optimal_width_buckets(scaled, k, multiple=8, max_width=img_w)
        print(f"Auto width buckets (k={k}): {width_buckets}")

    if artifact:
        from rcnn_ocr_tpu_torch.export import ServingArtifact

        art = ServingArtifact.load(artifact, device=device)
        print(f"  artifact method: {art.method}   batch: {art.batch_size}")
        predicted: List[str] = []
        for i in progress(range(0, len(image_paths), art.batch_size), desc="Predict"):
            out = art.predict(image_paths[i : i + art.batch_size])
            predicted.extend(out if isinstance(out, list) else [out])
        return _report_metrics(true_texts, predicted, image_paths,
                               os.path.basename(artifact.rstrip("/")),
                               error_analysis=error_analysis)

    if lm_weight and decode not in ("attention_beam", "ctc_beam", "attention_long_beam",
                                    "hybrid_long_beam"):
        raise ValueError("--lm-weight requires --decode attention_beam, ctc_beam, "
                         "attention_long_beam, or hybrid_long_beam")
    if length_penalty and decode not in ("attention_beam", "attention_long_beam",
                                         "hybrid_long_beam"):
        raise ValueError("--length-penalty requires --decode attention_beam, "
                         "attention_long_beam, or hybrid_long_beam")
    ocr = OCRInference(model_path, charset_path, device=device, img_h=img_h, img_w=img_w,
                       dtype=dtype, width_buckets=width_buckets, lm=lm, quantize=quantize)
    if static_quant:
        n_cal = min(256, len(image_paths))
        print(f"Calibrating static int8 scales on {n_cal} images ...")
        ocr.calibrate(image_paths[:n_cal], batch_size=min(batch_size, n_cal))
        if save_calibration:
            ocr.save_calibration(save_calibration)
            print(f"Calibrated checkpoint written to: {save_calibration}")

    predicted: List[str] = []
    for i in progress(range(0, len(image_paths), batch_size), desc="Predict"):
        chunk = image_paths[i : i + batch_size]
        if serving:
            out = ocr.predict_serving(chunk, max_length=max_length, batch_size=batch_size,
                                      method=decode, beam_width=beam_width,
                                      length_penalty=length_penalty, lm_weight=lm_weight)
        elif decode in ("ctc_long", "ctc_long_beam"):
            out = ocr.predict_ctc_long(chunk, tile_w=tile_w, overlap=overlap,
                                       batch_size=batch_size,
                                       method="beam" if decode.endswith("beam") else "greedy",
                                       beam_width=beam_width)
        elif long_decode:
            out = ocr.predict_long(chunk, method=LONG_METHODS[decode], tile_w=tile_w,
                                   overlap=overlap, batch_size=batch_size, max_length=max_length,
                                   beam_width=beam_width, lm_weight=lm_weight,
                                   length_penalty=length_penalty)
        elif decode == "attention":
            out = ocr.predict(chunk, max_length=max_length, batch_size=batch_size)
        elif decode == "attention_beam":
            out = ocr.predict(chunk, max_length=max_length, batch_size=batch_size,
                              beam_width=beam_width, lm_weight=lm_weight,
                              length_penalty=length_penalty)
        elif decode == "ctc_greedy":
            out = ocr.predict_ctc(chunk, batch_size=batch_size, method="greedy")
        else:
            out = ocr.predict_ctc(chunk, batch_size=batch_size, method="beam",
                                  beam_width=beam_width, lm_weight=lm_weight)
        predicted.extend(out)

    return _report_metrics(true_texts, predicted, image_paths, os.path.basename(model_path),
                           error_analysis=error_analysis)


def _error_analysis(true_texts, predicted, cers) -> dict:
    """Accuracy and CER by true-text length, and the most frequent
    substitutions, insertions and deletions of a minimal-edit alignment."""
    buckets = [(0, 5), (6, 10), (11, 15), (16, 20), (21, None)]
    by_length = []
    for lo, hi in buckets:
        rows = [(t, p, c) for t, p, c in zip(true_texts, predicted, cers)
                if len(t) >= lo and (hi is None or len(t) <= hi)]
        if not rows:
            continue
        by_length.append({
            "length": f"{lo}-{hi}" if hi is not None else f"{lo}+",
            "n": len(rows),
            "accuracy": sum(1 for t, p, _ in rows if t == p) / len(rows),
            "cer": float(np.mean([c for _, _, c in rows])),
        })

    subs: Counter = Counter()
    ins: Counter = Counter()
    dels: Counter = Counter()
    skipped_long = 0
    for t, p in zip(true_texts, predicted):
        if t == p:
            continue
        if len(t) * len(p) > 4_000_000:  # the alignment is an O(nm) table
            skipped_long += 1
            continue
        for op, rc, hc in edit_ops(t, p):
            if op == "sub":
                subs[(rc, hc)] += 1
            elif op == "ins":
                ins[hc] += 1
            else:
                dels[rc] += 1
    return {
        "by_length": by_length,
        "top_substitutions": [{"true": rc, "predicted": hc, "count": n}
                              for (rc, hc), n in subs.most_common(15)],
        "top_insertions": [{"predicted": hc, "count": n} for hc, n in ins.most_common(10)],
        "top_deletions": [{"true": rc, "count": n} for rc, n in dels.most_common(10)],
        "pairs_skipped_too_long": skipped_long,
    }


def _print_error_analysis(analysis: dict) -> None:
    print("\nAccuracy by true-text length:")
    print(f"{'length':>8} {'n':>6} {'accuracy':>10} {'CER':>8}")
    for row in analysis["by_length"]:
        print(f"{row['length']:>8} {row['n']:>6} {row['accuracy']:>10.4f} {row['cer']:>8.4f}")
    if analysis["top_substitutions"]:
        print("\nTop character confusions (true -> predicted x count):")
        for row in analysis["top_substitutions"]:
            print(f"  {row['true']!r} -> {row['predicted']!r} x {row['count']}")
    if analysis["top_insertions"]:
        ins = ", ".join(f"{r['predicted']!r} x {r['count']}" for r in analysis["top_insertions"])
        print(f"Top spurious insertions: {ins}")
    if analysis["top_deletions"]:
        dels = ", ".join(f"{r['true']!r} x {r['count']}" for r in analysis["top_deletions"])
        print(f"Top dropped characters:  {dels}")
    if analysis["pairs_skipped_too_long"]:
        print(f"(confusions skipped for {analysis['pairs_skipped_too_long']} "
              "pathologically long pairs)")


def _report_metrics(true_texts, predicted, image_paths, result_name, error_analysis=False):
    """Print accuracy / CER / WER and the worst rows, write the per-sample CSV."""
    accuracy = compute_accuracy(true_texts, predicted)
    cers = batch_character_error_rate(true_texts, predicted)
    wers = []
    for t, p in zip(true_texts, predicted):
        w = word_error_rate(t, p)
        wers.append(1.0 if not math.isfinite(w) else w)
    avg_cer = float(np.mean(cers))
    avg_wer = float(np.mean(wers))

    print("\n" + "=" * 60)
    print("EVALUATION RESULTS")
    print("=" * 60)
    print(f"Samples:               {len(image_paths)}")
    print(f"Accuracy (exact match): {accuracy:.4f} ({accuracy * 100:.2f}%)")
    print(f"Mean CER:               {avg_cer:.4f} ({avg_cer * 100:.2f}%)")
    print(f"Mean WER:               {avg_wer:.4f} ({avg_wer * 100:.2f}%)")
    print("\nError stats:")
    print(f"CER: min={min(cers):.3f}, max={max(cers):.3f}, median={np.median(cers):.3f}")
    print(f"WER: min={min(wers):.3f}, max={max(wers):.3f}, median={np.median(wers):.3f}")

    print("\nWorst examples (top-5 by CER):")
    worst = sorted(zip(true_texts, predicted, cers), key=lambda x: x[2], reverse=True)
    for i, (true, pred, cer) in enumerate(worst[:5]):
        print(f"{i + 1}. CER={cer:.3f}")
        print(f"   true:      '{true}'")
        print(f"   predicted: '{pred}'")
        print()

    output_path = f"evaluation_results_{result_name}.csv"
    with open(output_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["image_path", "true_text", "predicted_text", "cer", "wer", "exact_match"])
        for p, t, h, c, w in zip(image_paths, true_texts, predicted, cers, wers):
            writer.writerow([os.path.basename(p), t, h, repr(float(c)), repr(float(w)), t == h])
    print(f"Per-sample results written to: {output_path}")
    out = {"accuracy": accuracy, "cer": avg_cer, "wer": avg_wer, "n": len(image_paths)}
    if error_analysis:
        out["analysis"] = _error_analysis(true_texts, predicted, cers)
        _print_error_analysis(out["analysis"])
    return out


def _parse_lm_weights(raw) -> List[float]:
    """``--lm-weight`` comma list -> floats (raises ValueError on garbage)."""
    return [float(v) for v in str(raw).split(",") if v.strip() != ""]


def _lm_weight_given(raw) -> bool:
    """Whether ``--lm-weight`` asks for fusion (numerically non-zero)."""
    try:
        return _parse_lm_weights(raw) != [0.0]
    except ValueError:
        return True


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Evaluate an OCR model on a dataset (PyTorch port)")
    ap.add_argument("--model", type=str, default=None, help="model checkpoint (.msgpack or .pth)")
    ap.add_argument("--artifact", type=str, default=None,
                    help="exported serving artifact directory (instead of --model)")
    ap.add_argument("--charset", type=str, default=None, help="charset file (with --model)")
    ap.add_argument("--csv", type=str, required=True, help="labels CSV with a filename,text header")
    ap.add_argument("--root", type=str, required=True, help="images folder")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--max-samples", type=int, default=None)
    ap.add_argument("--img-h", type=int, default=32)
    ap.add_argument("--img-w", type=int, default=128)
    ap.add_argument("--decode", type=str, default="attention", choices=DECODES + LONG_DECODES)
    ap.add_argument("--max-length", type=int, default=25)
    ap.add_argument("--beam-width", type=int, default=16)
    ap.add_argument("--lm", default=None, metavar="LM.npz",
                    help="bigram LM for beam shallow fusion (python -m rcnn_ocr_tpu_torch.lm)")
    ap.add_argument("--length-penalty", type=float, default=0.0,
                    help="attention_beam rank normalization: score / len**p (0 = off)")
    ap.add_argument("--lm-weight", type=str, default="0.0",
                    help="fusion weight (0 = off); requires --decode attention_beam or "
                         "ctc_beam.  A comma list (0,0.2,0.4) sweeps the values and prints a "
                         "comparison table")
    ap.add_argument("--width-buckets", type=str, default=None,
                    help="comma-separated static widths, e.g. 64,128,256; or auto:K to derive "
                         "K widths from the eval data")
    ap.add_argument("--error-analysis", action="store_true",
                    help="append accuracy by text length and the top character confusion, "
                         "insertion and deletion tables")
    ap.add_argument("--report-json", metavar="PATH", default=None,
                    help="write the metrics (and the analysis tables, and the lm-weight sweep "
                         "when given a list) as JSON")
    ap.add_argument("--serving", action="store_true",
                    help="resize-pad on the device behind a double-buffered host letterbox "
                         "(the four fixed-width decodes)")
    ap.add_argument("--tile-w", type=int, default=None,
                    help="*_long decodes: tile width in px (default: --img-w)")
    ap.add_argument("--overlap", type=int, default=None,
                    help="*_long decodes: junction overlap in px (default: min(64, tile_w/2))")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 inference for the wide conv stages")
    ap.add_argument("--static-quant", action="store_true",
                    help="with --quantize: calibrate static int8 activation scales on up to "
                         "256 eval images (drops the per-conv abs-max pass)")
    ap.add_argument("--save-calibration", metavar="PATH", default=None,
                    help="with --static-quant: write a copy of the checkpoint with the "
                         "calibrated scales embedded (reopens straight onto the static path)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # accepted, then refused: XLA's compile cache has no counterpart
    ap.add_argument("--compile-cache-dir", default=None)
    return ap


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    later = [flag for flag in LATER
             if getattr(args, flag[2:].replace("-", "_")) not in (None, False)]
    if later:
        print("not in the PyTorch port yet: " + "; ".join(f"{f} {LATER[f]}" for f in later))
        return 1
    if bool(args.artifact) == bool(args.model):
        print("Pass exactly one of --model or --artifact")
        return 1
    if args.artifact:
        # the artifact bakes its decode configuration at export time: refuse
        # knobs that cannot apply instead of silently ignoring them
        baked = {
            "--charset": args.charset is not None,
            "--decode": args.decode != parser.get_default("decode"),
            "--beam-width": args.beam_width != parser.get_default("beam_width"),
            "--max-length": args.max_length != parser.get_default("max_length"),
            "--lm": args.lm is not None,
            "--lm-weight": _lm_weight_given(args.lm_weight),
            "--length-penalty": args.length_penalty != 0.0,
            "--width-buckets": args.width_buckets is not None,
            "--quantize": args.quantize,
            "--serving": args.serving,
            "--static-quant": args.static_quant,
            "--tile-w": args.tile_w is not None,
            "--overlap": args.overlap is not None,
            "--img-h": args.img_h != parser.get_default("img_h"),
            "--img-w": args.img_w != parser.get_default("img_w"),
            "--batch-size": args.batch_size != parser.get_default("batch_size"),
            "--save-calibration": args.save_calibration is not None,
        }
        conflicting = [flag for flag, given in baked.items() if given]
        if conflicting:
            print(f"{', '.join(conflicting)} cannot be used with --artifact "
                  "(baked in at export time; re-export to change them)")
            return 1
        if not os.path.exists(os.path.join(args.artifact, "manifest.json")):
            print(f"Artifact not found: {args.artifact}")
            return 1
    else:
        if args.charset is None:
            print("--charset is required with --model")
            return 1
        if not os.path.exists(args.model):
            print(f"Model not found: {args.model}")
            return 1
        if not os.path.exists(args.charset):
            print(f"Charset not found: {args.charset}")
            return 1
    try:
        lm_weights = _parse_lm_weights(args.lm_weight)
    except ValueError:
        print(f"--lm-weight is not a comma list of numbers: {args.lm_weight!r}")
        return 1
    if not lm_weights:
        print(f"--lm-weight parsed to an empty sweep: {args.lm_weight!r}")
        return 1
    width_buckets = args.width_buckets
    if width_buckets and not width_buckets.startswith("auto"):
        width_buckets = [int(v) for v in width_buckets.split(",")]
    try:
        sweep = []
        for w in lm_weights:
            if len(lm_weights) > 1:
                print(f"\n##### lm_weight = {w} #####")
            metrics = evaluate_model(
                model_path=args.model, charset_path=args.charset, csv_path=args.csv,
                root_path=args.root, batch_size=args.batch_size, max_samples=args.max_samples,
                img_h=args.img_h, img_w=args.img_w, decode=args.decode,
                max_length=args.max_length, beam_width=args.beam_width, lm=args.lm,
                lm_weight=w, length_penalty=args.length_penalty, width_buckets=width_buckets,
                serving=args.serving, tile_w=args.tile_w, overlap=args.overlap,
                error_analysis=args.error_analysis, device=args.device,
                quantize=args.quantize or args.static_quant, static_quant=args.static_quant,
                save_calibration=args.save_calibration, artifact=args.artifact,
            )
            sweep.append((w, metrics))
        if len(sweep) > 1:
            print("\nLM-weight sweep (pick the CER minimum):")
            print(f"{'lm_weight':>10} {'accuracy':>10} {'CER':>8} {'WER':>8}")
            for w, m in sweep:
                if m:
                    print(f"{w:>10.3f} {m['accuracy']:>10.4f} {m['cer']:>8.4f} {m['wer']:>8.4f}")
        if args.report_json:
            payload = (sweep[0][1] if len(sweep) == 1
                       else {"sweep": [dict(m, lm_weight=w) for w, m in sweep if m]})
            if payload is None or payload == {"sweep": []}:
                # an empty dataset must not hand a gate `null` with exit code 0
                print(f"No metrics to report — {args.report_json} not written")
                return 1
            with open(args.report_json, "w", encoding="utf-8") as f:
                json.dump(payload, f, ensure_ascii=False, indent=2)
            print(f"JSON report written to: {args.report_json}")
    except Exception as e:  # the CLI's boundary: report and exit 1
        print(f"Error: {type(e).__name__}: {e}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
