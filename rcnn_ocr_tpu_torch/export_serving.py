"""Export a serving artifact (torch.export programs + params + manifest)
from a checkpoint.

The port's copy of the JAX package's ``tools/export_serving.py``, with the
same arguments and output, plus ``--device`` (where the engine runs and
the programs are traced: ``cuda``, or ``cpu`` when asked for).

Example:
    python -m rcnn_ocr_tpu_torch.export_serving \
        --model exp1/best_acc_weights.msgpack --charset configs/charset.txt \
        --out exp1/artifact --method ctc_greedy --img-h 32 --img-w 128 \
        --canvas 64,512 --batch-size 256 --width-buckets 64,128 \
        --platforms cuda,cpu

Serve it back with::

    from rcnn_ocr_tpu_torch.export import ServingArtifact
    art = ServingArtifact.load("exp1/artifact")
    print(art.predict(["line1.png", "line2.png"]))
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                prog="python -m rcnn_ocr_tpu_torch.export_serving")
    p.add_argument("--model", required=True, help="checkpoint (.msgpack or .pth)")
    p.add_argument("--charset", required=True, help="charset file")
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument(
        "--confidence", action="store_true",
        help="bake CTC confidence outputs into the programs (manifest v5; "
        "one extra [B] fp32 fetch per batch — leave off unless the "
        "deployment serves confidences)",
    )
    p.add_argument(
        "--method",
        default="ctc_greedy",
        choices=[
            "attention", "attention_beam", "ctc_greedy", "ctc_beam",
            "ctc_long", "ctc_long_beam",  # unbounded-width stitched decode
            "attention_long", "attention_long_beam",  # tiled seq2seq + merge
            "hybrid_long", "hybrid_long_beam",  # CTC segments, attention reads
        ],
    )
    p.add_argument("--img-h", type=int, default=None)
    p.add_argument("--img-w", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--canvas", default="64,512", help="letterbox canvas H,W")
    p.add_argument("--max-length", type=int, default=25)
    p.add_argument("--beam-width", type=int, default=16)
    p.add_argument("--prune-k", type=int, default=16)
    p.add_argument(
        "--length-penalty", type=float, default=0.0,
        help="attention_beam rank normalization: score / len**p (0 = off)",
    )
    p.add_argument(
        "--lm", default=None, metavar="LM.npz",
        help="bigram LM baked into the beam programs (python -m rcnn_ocr_tpu_torch.lm)",
    )
    p.add_argument(
        "--lm-weight", type=float, default=0.0,
        help="fusion weight (requires --method attention_beam and --lm)",
    )
    p.add_argument(
        "--width-buckets",
        default=None,
        help="comma-separated static decode widths (default: the model img_w)",
    )
    p.add_argument(
        "--tile-w", type=int, default=None,
        help="ctc_long*: tile width in px (default: the model img_w)",
    )
    p.add_argument(
        "--overlap", type=int, default=None,
        help="ctc_long*: junction overlap in px (default: min(64, tile_w/2))",
    )
    p.add_argument(
        "--snap", default="midpoint", choices=["midpoint", "blank"],
        help="ctc_long*: junction cut policy (midpoint is the simpler default)",
    )
    p.add_argument(
        "--merge", default="align", choices=["align", "text"],
        help="attention_long*: junction merge policy — frame-aligned via "
        "the decoder's attention positions (default) or text-space edit "
        "alignment",
    )
    p.add_argument(
        "--min-gap", type=int, default=3,
        help="hybrid_long*: blank-gap frames that split segments",
    )
    p.add_argument(
        "--margin", type=int, default=1,
        help="hybrid_long*: context frames around each segment crop",
    )
    p.add_argument(
        "--platforms",
        default=None,
        help="comma-separated torch devices the artifact may run on, e.g. "
        "cuda,cpu (default: the device it is exported on)",
    )
    p.add_argument(
        "--quantize",
        action="store_true",
        help="int8 path (static scales when the checkpoint carries them)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="where the engine runs and the programs are traced: cuda (the "
        "default) or cpu",
    )
    args = p.parse_args(argv)

    from rcnn_ocr_tpu_torch.export import export_serving_artifact
    from rcnn_ocr_tpu_torch.inference import OCRInference

    canvas = tuple(int(v) for v in args.canvas.split(","))
    buckets = (
        [int(v) for v in args.width_buckets.split(",")]
        if args.width_buckets
        else None
    )
    platforms = args.platforms.split(",") if args.platforms else None

    if args.lm_weight and args.method not in (
        "attention_beam", "ctc_beam", "attention_long_beam", "hybrid_long_beam"
    ):
        p.error(
            "--lm-weight requires --method attention_beam, ctc_beam, "
            "attention_long_beam, or hybrid_long_beam"
        )
    if args.length_penalty and args.method not in (
        "attention_beam", "attention_long_beam", "hybrid_long_beam"
    ):
        p.error(
            "--length-penalty requires --method attention_beam, "
            "attention_long_beam, or hybrid_long_beam"
        )
    long_methods = (
        "ctc_long", "ctc_long_beam", "attention_long", "attention_long_beam",
        "hybrid_long", "hybrid_long_beam",
    )
    if (args.tile_w or args.overlap) and args.method not in long_methods:
        p.error("--tile-w/--overlap require a *_long method")
    if (
        args.min_gap != p.get_default("min_gap")
        or args.margin != p.get_default("margin")
    ) and args.method not in ("hybrid_long", "hybrid_long_beam"):
        p.error("--min-gap/--margin require a hybrid_long method")
    if args.width_buckets and args.method in long_methods:
        p.error(
            "--width-buckets does not apply to *_long methods (they tile "
            "at a single --tile-w)"
        )
    if args.snap != p.get_default("snap") and args.method not in (
        "ctc_long", "ctc_long_beam"
    ):
        p.error("--snap requires a ctc_long method")
    if args.merge != p.get_default("merge") and args.method not in (
        "attention_long", "attention_long_beam"
    ):
        p.error("--merge requires an attention_long method")
    ocr = OCRInference(
        args.model,
        args.charset,
        device=args.device,
        img_h=args.img_h,
        img_w=args.img_w,
        quantize=args.quantize,
        width_buckets=buckets,
        lm=args.lm,
    )
    out = export_serving_artifact(
        ocr,
        args.out,
        method=args.method,
        batch_size=args.batch_size,
        canvas=canvas,
        max_length=args.max_length,
        beam_width=args.beam_width,
        prune_k=args.prune_k,
        length_penalty=args.length_penalty,
        lm_weight=args.lm_weight,
        width_buckets=buckets,
        platforms=platforms,
        tile_w=args.tile_w,
        overlap=args.overlap,
        snap=args.snap,
        merge=args.merge,
        min_gap=args.min_gap,
        margin=args.margin,
        with_confidence=args.confidence,
    )
    print(f"Artifact written to: {out}")


if __name__ == "__main__":
    main()
