"""Run the micro-batching OCR HTTP server on the card.

From an exported artifact (no model code; cold start = load the programs):

    python -m rcnn_ocr_tpu_torch.serve --artifact exp1/artifact --port 8000

or from a live checkpoint (the full engine; pass the serving knobs):

    python -m rcnn_ocr_tpu_torch.serve --model exp1/best_acc_weights.msgpack \
        --charset configs/charset.txt --img-h 32 --img-w 128 \
        --method ctc_greedy --canvas 64,512 --batch-size 256 --port 8000

The counterpart of the JAX package's ``tools/serve.py`` with the same flags,
defaults and checks, plus ``--device`` (``cuda``, or ``cpu`` when asked
for).  ``--model`` takes a msgpack checkpoint or one of the reference's
``.pth`` layouts; ``--quantize`` serves it in int8 (static scales when the
checkpoint carries them).  With ``--artifact`` the flags an artifact bakes
in at export time are ignored with a warning.  ``--mesh`` serves
data-parallel over every visible card (``mesh=True`` of the engine or the
artifact; one replica with ``--device cpu``), the micro-batcher's batch
rounded up to tile the replicas as the engine rounds it.  Refused:
``--compile-cache-dir`` (there is no XLA compile cache on the card).

Query it:

    curl -s -X POST --data-binary @line.jpg http://127.0.0.1:8000/predict
    curl -s http://127.0.0.1:8000/healthz
    curl -s http://127.0.0.1:8000/metrics   # Prometheus scrape target

SIGTERM / SIGINT drain and exit; SIGHUP rebuilds the engine from the
checkpoint or artifact directory on disk and swaps it in without dropping a
request (taking the artifact's batch size when it changed), with the same
mesh.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, prog="python -m rcnn_ocr_tpu_torch.serve")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", help="exported artifact directory")
    src.add_argument("--model", help="checkpoint (.msgpack or .pth)")
    p.add_argument("--charset", help="charset file (with --model)")
    p.add_argument("--img-h", type=int, default=None)
    p.add_argument("--img-w", type=int, default=None)
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--width-buckets", default=None)
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
    p.add_argument("--canvas", default="64,512")
    p.add_argument("--max-length", type=int, default=25)
    p.add_argument("--beam-width", type=int, default=16)
    p.add_argument(
        "--lm", default=None, metavar="LM.npz",
        help="bigram LM for beam shallow fusion",
    )
    p.add_argument(
        "--lm-weight", type=float, default=0.0,
        help="fusion weight; requires --method attention_beam or ctc_beam",
    )
    p.add_argument(
        "--length-penalty", type=float, default=0.0,
        help="attention_beam rank normalization: score / len**p (0 = off)",
    )
    p.add_argument(
        "--merge", default="align", choices=["align", "text"],
        help="attention_long*: junction merge — frame-aligned via the "
        "decoder's attention positions (default) or text-space",
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
        "--tile-w", type=int, default=None,
        help="*_long methods: tile width px (default: the engine img_w)",
    )
    p.add_argument(
        "--overlap", type=int, default=None,
        help="*_long methods: junction overlap px between adjacent tiles",
    )
    p.add_argument(
        "--snap", default="midpoint", choices=["midpoint", "blank"],
        help="ctc_long*: junction cut policy — overlap midpoint (default) "
        "or snap to the widest blank run",
    )
    p.add_argument(
        "--confidence", action="store_true",
        help="responses carry per-text confidences ({'texts': [...], "
        "'confidences': [...]}); every method except the tiled "
        "attention merge (attention_long*)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument(
        "--mesh", action="store_true",
        help="shard serving data-parallel across the visible cards",
    )
    p.add_argument(
        "--max-wait-ms",
        type=float,
        default=5.0,
        help="micro-batch coalescing window after the first queued image",
    )
    p.add_argument(
        "--compile-cache-dir",
        default=None,
        help="the JAX daemon's persistent XLA compile cache (refused: "
        "there is none on the card)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="where the engine runs: cuda (the default) or cpu",
    )
    args = p.parse_args(argv)

    if (
        args.min_gap != p.get_default("min_gap")
        or args.margin != p.get_default("margin")
    ) and not args.artifact and args.method not in (
        "hybrid_long", "hybrid_long_beam"
    ):
        p.error("--min-gap/--margin require a hybrid_long method")
    if (
        args.merge != p.get_default("merge")
        and not args.artifact
        and args.method not in ("attention_long", "attention_long_beam")
    ):
        p.error("--merge requires an attention_long method")
    long_method = args.method.startswith(
        ("ctc_long", "attention_long", "hybrid_long")
    )
    if (
        (args.tile_w is not None or args.overlap is not None)
        and not args.artifact
        and not long_method
    ):
        p.error("--tile-w/--overlap require a *_long method")
    if (
        args.snap != p.get_default("snap")
        and not args.artifact
        and not args.method.startswith("ctc_long")
    ):
        p.error("--snap requires a ctc_long method")
    if (
        args.confidence
        and not args.artifact  # artifact method known only after load
        and args.method in ("attention_long", "attention_long_beam")
    ):
        p.error("--confidence is not supported by the tiled attention "
                "merge (attention_long*) — every other method carries a "
                "confidence contract")

    if args.compile_cache_dir:
        p.error("--compile-cache-dir: there is no XLA compile cache on the card (the CUDA "
                "kernels build at first use)")

    from rcnn_ocr_tpu_torch.serving import serving_predict_fn

    if args.artifact:
        from rcnn_ocr_tpu_torch.export import ServingArtifact

        # an artifact bakes these in at export time: flags cannot change it
        baked = {
            "--method": args.method != p.get_default("method"),
            "--canvas": args.canvas != p.get_default("canvas"),
            "--max-length": args.max_length != p.get_default("max_length"),
            "--beam-width": args.beam_width != p.get_default("beam_width"),
            "--batch-size": args.batch_size != p.get_default("batch_size"),
            "--quantize": args.quantize,
            "--width-buckets": args.width_buckets is not None,
            "--lm": args.lm is not None,
            "--lm-weight": args.lm_weight != 0.0,
            "--length-penalty": args.length_penalty != 0.0,
            "--merge": args.merge != p.get_default("merge"),
            "--min-gap": args.min_gap != p.get_default("min_gap"),
            "--margin": args.margin != p.get_default("margin"),
            "--tile-w": args.tile_w is not None,
            "--overlap": args.overlap is not None,
            "--snap": args.snap != p.get_default("snap"),
        }
        overridden = [flag for flag, changed in baked.items() if changed]
        if overridden:
            print(
                f"WARNING: {', '.join(overridden)} ignored with --artifact "
                "(baked in at export time; re-export to change them)",
                flush=True,
            )

        # the build runs again on SIGHUP (hot reload): it re-reads the
        # deployment unit from disk each time
        def build_predict():
            engine = ServingArtifact.load(args.artifact, device=args.device,
                                          mesh=args.mesh or None)
            fn = serving_predict_fn(engine, return_confidence=args.confidence)
            return fn, engine.batch_size

        return _serve(args, build_predict)

    from rcnn_ocr_tpu_torch.inference import OCRInference

    buckets = (
        [int(v) for v in args.width_buckets.split(",")]
        if args.width_buckets
        else None
    )
    canvas = tuple(int(v) for v in args.canvas.split(","))

    # the build runs again on SIGHUP (hot reload): it re-reads the
    # checkpoint from disk each time
    def build_predict():
        engine = OCRInference(
            args.model,
            args.charset,
            device=args.device,
            img_h=args.img_h,
            img_w=args.img_w,
            quantize=args.quantize,
            width_buckets=buckets,
            lm=args.lm,
            mesh=args.mesh or None,
        )
        fn = serving_predict_fn(
            engine,
            method=args.method,
            batch_size=args.batch_size,
            canvas=canvas,
            max_length=args.max_length,
            beam_width=args.beam_width,
            length_penalty=args.length_penalty,
            lm_weight=args.lm_weight,
            merge=args.merge,
            min_gap=args.min_gap,
            margin=args.margin,
            tile_w=args.tile_w,
            overlap=args.overlap,
            snap=args.snap,
            return_confidence=args.confidence,
        )
        # a dispatch the engine would pad to tile the replicas is filled instead
        return fn, engine._round_batch(args.batch_size)

    return _serve(args, build_predict)


def _serve(args, build_predict) -> None:
    """Build the engine and serve until drained; SIGHUP rebuilds it."""
    from rcnn_ocr_tpu_torch.serving import (
        OCRServer,
        install_graceful_shutdown,
        install_hot_reload,
    )

    predict, max_batch = build_predict()

    server = OCRServer(
        predict,
        host=args.host,
        port=args.port,
        max_batch=max_batch,
        max_wait_ms=args.max_wait_ms,
        confidence=args.confidence,
    )
    host, port = server.address[:2]
    print(
        f"Serving on http://{host}:{port}  "
        "(POST /predict, GET /healthz, GET /metrics; "
        "SIGHUP reloads the model from disk without downtime)",
        flush=True,
    )
    # SIGTERM (what container runtimes send) and SIGINT both drain: stop
    # accepting, 503 new submissions, answer everything queued, exit 0
    install_graceful_shutdown(server)
    # SIGHUP = zero-downtime upgrade: replace the checkpoint or artifact on
    # disk, signal, and the daemon swaps engines between batches (a failed
    # build logs and keeps serving on the old engine)
    def rebuild_for_reload():
        import numpy as _np

        fn, mb = build_predict()
        # warm OFF the serving path: one dummy predict runs the new engine's
        # first call (kernel loads, allocator growth) on the reload thread,
        # so the swap does not stall the dispatcher
        fn([_np.full((16, 32, 3), 255, _np.uint8)])
        return fn, mb

    install_hot_reload(server, rebuild_for_reload)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()
    print("Drained; exiting.", flush=True)


if __name__ == "__main__":
    main()
