"""Export a checkpoint to the reference's PyTorch ``.pth`` layouts.

    python -m rcnn_ocr_tpu_torch.export_torch --ckpt exp1/best_acc_ckpt.msgpack \
        --out model_torch.pth [--layout full|legacy|bare] \
        [--charset configs/charset.txt] [--hidden 256]

The port's copy of the JAX package's ``tools/export_torch.py``, with the
same arguments: the reverse of the ``.pth`` importer, so a model trained in
either package becomes a drop-in checkpoint for the reference stack.
``--layout full`` (the default) embeds the charset and config, so the
reference opens the file with no side inputs.  Runs on the CPU: it only
re-lays out weights.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 prog="python -m rcnn_ocr_tpu_torch.export_torch")
    ap.add_argument("--ckpt", required=True, help="msgpack checkpoint/weights (or .pth)")
    ap.add_argument("--out", required=True, help="output .pth path")
    ap.add_argument("--layout", default="full", choices=("full", "legacy", "bare"))
    ap.add_argument("--charset", default=None, help="token-per-line charset file")
    ap.add_argument("--hidden", type=int, default=None)
    ap.add_argument("--img-h", type=int, default=None, help="config hint (full layout)")
    ap.add_argument("--img-w", type=int, default=None, help="config hint (full layout)")
    args = ap.parse_args(argv)

    from rcnn_ocr_tpu_torch.interop.torch_export import save_torch_checkpoint
    from rcnn_ocr_tpu_torch.utils.common import load_model

    model, variables, charset = load_model(args.ckpt, charset_path=args.charset,
                                           hidden_size=args.hidden, device="cpu")
    if model.cnn.width_mult != 1.0:
        raise SystemExit(
            f"width_mult={model.cnn.width_mult} has no reference counterpart; "
            "only width 1.0 checkpoints can be exported"
        )
    if model.with_ctc_head:
        print("note: the CTC head has no torch counterpart and is not exported")

    config = {"hidden_size": model.hidden_size}
    if args.img_h:
        config["img_h"] = args.img_h
    if args.img_w:
        config["img_w"] = args.img_w
    save_torch_checkpoint(args.out, variables, layout=args.layout, itos=list(charset.itos),
                          stoi=dict(charset.stoi), config=config, hidden_size=model.hidden_size)
    size_mb = os.path.getsize(args.out) / 1e6
    print(
        f"wrote {args.layout} layout -> {args.out} ({size_mb:.1f} MB, "
        f"vocab {charset.num_classes}, hidden {model.hidden_size})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
