"""Image comparison gate: SSIM / PSNR / max-abs between two renders, on
the port's image reader and SSIM.  Counterpart of the repository's
`tools/compare_images.py`, with the same flags, JSON line and exit codes.
For the BASELINE.md parity gate (SSIM > 0.99 against the OptiX reference
on the suitcase scene):

    python -m tpu_pathtracer_torch.tools.compare_images ours.png reference.png [--ssim-min 0.99]

Accepts PNG, binary PPM and EXR (any pair); images are compared as [0,1]
floats after a shape check.  Exit code 0 iff the SSIM gate passes, 1 if
it fails, 2 on a shape mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from tpu_pathtracer_torch.utils.image import load_image
from tpu_pathtracer_torch.utils.ssim import ssim


def load(path: str) -> np.ndarray:
    return np.asarray(load_image(path), np.float64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_pathtracer_torch.tools.compare_images")
    ap.add_argument("image_a")
    ap.add_argument("image_b")
    ap.add_argument("--ssim-min", type=float, default=0.99)
    ap.add_argument("--flip-b", action="store_true", help="flip B vertically first")
    args = ap.parse_args(argv)

    a = load(args.image_a)
    b = load(args.image_b)
    if args.flip_b:
        b = b[::-1]
    if a.shape != b.shape:
        print(json.dumps({"error": f"shape mismatch {a.shape} vs {b.shape}"}))
        return 2

    s = ssim(a, b)
    mse = float(np.mean((a - b) ** 2))
    psnr = float(10 * np.log10(1.0 / mse)) if mse > 0 else 999.0  # JSON-safe
    out = {
        "ssim": round(s, 6),
        "psnr_db": round(psnr, 3),
        "max_abs": round(float(np.abs(a - b).max()), 6),
        "pass": s >= args.ssim_min,
        "ssim_min": args.ssim_min,
    }
    print(json.dumps(out))
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
