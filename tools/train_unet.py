"""Train the articular UNet on the pipeline-extracted corpus.

Inputs: one or more .npz corpora (tools/make_unet_corpus.py for synthetic
bones with generative labels; tools/export_polar_data.py for real fixtures
with sphere-consensus labels).  Real-fixture pairs are oversampled by
--real-repeat so the 4 fixtures are seen regularly without dominating.

Run:
  python tools/train_unet.py corpus.npz [real.npz ...] \
      [--steps 3000] [--batch 16] [--real-repeat 8] [--resume]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("corpora", nargs="+")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--real-repeat", type=int, default=8,
                    help="oversampling factor for corpora named *real*")
    ap.add_argument("--frac-procedural", type=float, default=0.25)
    ap.add_argument("--resume", action="store_true",
                    help="fine-tune from the shipped weights")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from shoulder_tpu.models import unet, unet_train

    images, masks = [], []
    for path in args.corpora:
        d = np.load(path)
        im = np.asarray(d["images"], np.float32)
        mk = np.asarray(d["masks"], np.float32)
        rep = args.real_repeat if "real" in Path(path).stem else 1
        for _ in range(rep):
            images.append(im)
            masks.append(mk)
        print(f"[data] {path}: {im.shape[0]} pairs x{rep}")
    images = np.concatenate(images)
    masks = np.concatenate(masks)
    print(f"[data] total {images.shape[0]} pairs")

    init = unet.load_params(unet.PARAMS_PATH) if args.resume else None
    params, losses = unet_train.train_mixture(
        images, masks, steps=args.steps, batch=args.batch, lr=args.lr,
        frac_procedural=args.frac_procedural, init_params=init,
    )
    out = args.out or unet.PARAMS_PATH
    unet.save_params(params, out)
    print(f"[unet] saved {out} (final loss {losses[-1]:.4f})")


if __name__ == "__main__":
    main()
