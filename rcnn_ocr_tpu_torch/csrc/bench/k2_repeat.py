"""Is K2 (``csrc/bilstm_scan.cu``) deterministic, and which side of a
kernel-vs-plain check rounds worse?  Runs on one card:

    python3 rcnn_ocr_tpu_torch/csrc/bench/k2_repeat.py [--json-out PATH]

1. ``chip_smoke.kernel_phase`` three times from the smoke's seed, printing
   each run's K2 lines at batch 2048 and whether the phase passed.
2. At H=256, w_hh fp32 and bf16, batch 128 / 256 / 2048: the same seeded
   inputs launched 100 times (300 at batch 2048), each output compared
   bitwise with the first; the plain version 20 times likewise; the first
   of each against the recurrence in fp64.
3. Twenty more seeds at batch 2048, fp32: max abs error kernel vs plain,
   kernel vs fp64, plain vs fp64.

Prints the card (``nvidia-smi``'s name and power limit) first and a JSON
object of every number last.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from rcnn_ocr_tpu_torch.ops import kernels  # noqa: E402
from rcnn_ocr_tpu_torch.ops.bilstm_scan import bilstm_scan, scan_reference  # noqa: E402

H, T = 256, 16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_repeat: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": chip_smoke.card(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    print(out["card"], flush=True)
    chip_smoke.build(kernels)

    reps = []
    for rep in range(3):
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                chip_smoke.kernel_phase(torch.Generator(device="cuda").manual_seed(0))
            reps.append("ok")
        except RuntimeError as e:
            reps.append(f"failed: {e}")
        lines = [s.strip() for s in buf.getvalue().splitlines() if "bilstm_scan [16,2,2048" in s]
        print(f"kernel phase {rep}: {reps[-1]}", *lines, sep="\n  ", flush=True)
    out["kernel_phase_runs"] = reps

    det = {}
    for wdt in (torch.float32, torch.bfloat16):
        for batch in (128, 256, 2048):
            g = torch.Generator(device="cuda").manual_seed(1)
            w = (torch.randn(2, H, 4 * H, device="cuda", generator=g) / H ** 0.5).to(wdt)
            xs = torch.randn(T, 2, batch, 4 * H, device="cuda", generator=g)
            first = bilstm_scan(xs, w, H)
            n = 300 if batch == 2048 else 100
            moved = sum(not torch.equal(bilstm_scan(xs, w, H), first) for _ in range(n))
            plain = scan_reference(xs, w, H)
            plain_moved = sum(not torch.equal(scan_reference(xs, w, H), plain) for _ in range(20))
            exact = chip_smoke.scan_fp64(xs, w, H)
            key = f"{'fp32' if wdt == torch.float32 else 'bf16'} B={batch}"
            det[key] = dict(kernel_launches=n, kernel_not_bit_equal=moved,
                            plain_runs=20, plain_not_bit_equal=plain_moved,
                            kernel_vs_plain=(first - plain).abs().max().item(),
                            kernel_vs_fp64=(first.double() - exact).abs().max().item(),
                            plain_vs_fp64=(plain.double() - exact).abs().max().item())
            print(key, det[key], flush=True)
    out["repeat"] = det

    seeds = []
    for s in range(2, 22):
        g = torch.Generator(device="cuda").manual_seed(s)
        w = torch.randn(2, H, 4 * H, device="cuda", generator=g) / H ** 0.5
        xs = torch.randn(T, 2, 2048, 4 * H, device="cuda", generator=g)
        k, p, e = bilstm_scan(xs, w, H), scan_reference(xs, w, H), chip_smoke.scan_fp64(xs, w, H)
        seeds.append(dict(seed=s, kernel_vs_plain=(k - p).abs().max().item(),
                          kernel_vs_fp64=(k.double() - e).abs().max().item(),
                          plain_vs_fp64=(p.double() - e).abs().max().item()))
    out["seeds_fp32_b2048"] = seeds
    out["seeds_max"] = {k: max(s[k] for s in seeds)
                        for k in ("kernel_vs_plain", "kernel_vs_fp64", "plain_vs_fp64")}
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
