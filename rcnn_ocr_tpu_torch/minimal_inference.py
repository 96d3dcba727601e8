"""Recognize one image with the port: the counterpart of ``minimal_inference.py``.

    python -m rcnn_ocr_tpu_torch.minimal_inference [MODEL [CHARSET [IMAGE]]] \\
        [--quantize] [--serving] [--width-buckets 64,128|auto[:K]] \\
        [--img-h H] [--img-w W] [--beam-width K [--lm LM.npz] [--lm-weight X] \\
        [--length-penalty P]] [--device cuda|cpu]

Loads a msgpack checkpoint (or a reference ``.pth``) and a charset into
:class:`~rcnn_ocr_tpu_torch.inference.OCRInference`, reads IMAGE with the
port's own decoders and prints ``Result: '<text>'``.  The positional
arguments, their defaults and the flags are ``minimal_inference.py``'s:
``--quantize`` runs the int8 engine, ``--serving`` decodes through
``predict_serving`` (the uint8 letterbox and resize-pad on the device),
``--width-buckets`` decodes at bucketed widths, ``--img-h`` / ``--img-w``
override the checkpoint's training size, ``--beam-width`` > 1 runs the
attention beam, which ``--lm`` / ``--lm-weight`` fuse with a bigram table
and ``--length-penalty`` ranks.  A knob that needs a beam raises without
one, as the JAX script's does.  The engine runs on the card (bf16) unless
``--device cpu`` is given; without a card the default raises, and nothing
falls back to the CPU.
"""

from __future__ import annotations

import argparse

from rcnn_ocr_tpu_torch.inference import OCRInference


def parse_buckets(spec):
    if spec is None or spec.startswith("auto"):
        return spec
    return [int(b) for b in spec.split(",") if b]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 prog="python -m rcnn_ocr_tpu_torch.minimal_inference",
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model", nargs="?", default="exp1/best_acc_weights.msgpack")
    ap.add_argument("charset", nargs="?", default="configs/charset.txt")
    ap.add_argument("image", nargs="?", default="test.png")
    ap.add_argument("--quantize", action="store_true", help="int8 serving path")
    ap.add_argument("--serving", action="store_true",
                    help="predict_serving: uint8 letterbox + on-device preprocess")
    ap.add_argument("--width-buckets", default=None,
                    help="comma list (64,128) or auto[:K] - decode at bucketed widths")
    ap.add_argument("--img-h", type=int, default=None)
    ap.add_argument("--img-w", type=int, default=None)
    ap.add_argument("--beam-width", type=int, default=None,
                    help="attention beam search with K hypotheses (default: greedy)")
    ap.add_argument("--lm", default=None, metavar="LM.npz",
                    help="bigram LM for beam shallow fusion (python -m rcnn_ocr_tpu_torch.lm)")
    ap.add_argument("--lm-weight", type=float, default=0.0,
                    help="fusion weight; requires --beam-width > 1")
    ap.add_argument("--length-penalty", type=float, default=0.0,
                    help="beam rank normalization: score / len**p; requires --beam-width > 1")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: raises without a card) or cpu")
    args = ap.parse_args(argv)

    ocr = OCRInference(
        args.model, args.charset, device=args.device, quantize=args.quantize,
        img_h=args.img_h, img_w=args.img_w,
        width_buckets=parse_buckets(args.width_buckets), lm=args.lm,
    )
    beam = args.beam_width is not None and args.beam_width > 1
    if args.serving:
        # the knobs pass through unmasked: predict_serving refuses them
        # without a beam, as the JAX script relies on it to
        text = ocr.predict_serving(
            args.image, canvas="auto", method="attention_beam" if beam else "attention",
            beam_width=args.beam_width or 16, length_penalty=args.length_penalty,
            lm_weight=args.lm_weight,
        )
    else:
        text = ocr.predict(args.image, beam_width=args.beam_width,
                           length_penalty=args.length_penalty, lm_weight=args.lm_weight)
    print(f"Result: '{text}'")


if __name__ == "__main__":
    main()
