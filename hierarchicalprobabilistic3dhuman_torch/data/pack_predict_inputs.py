"""Pack a folder of images into pre-decoded npz shards for serving.

A copy of hierarchicalprobabilistic3dhuman_tpu/data/pack_predict_inputs.py
(it imports no JAX), kept in the port so that it imports nothing of the JAX
package.

The batched predict CLI (run_predict_torch.py --batch_size N) accepts, next to
.png/.jpg, pre-decoded inputs: single-image .npy files and multi-image .npz
packs (uint8 HWC RGB; see predict/_prefetch_images). On a small serving
host the PNG decode is a real per-image cost; packs skip it entirely and
amortise per-file open syscalls, so the host pipeline runs at raw disk
speed.

Usage:
  python -m hierarchicalprobabilistic3dhuman_torch.data.pack_predict_inputs \
      --image_dir demo/ --out_dir demo_packed/ [--shard_size 64]

Entry names inside each pack are the original fnames, so outputs keep the
same names as a run over the original folder. Images of different
resolutions can share a shard (the predict pipeline regroups by resolution
internally).
"""

import argparse
import os

import cv2
import numpy as np


def pack_folder(image_dir, out_dir, shard_size=64):
    fnames = sorted(f for f in os.listdir(image_dir)
                    if f.endswith((".jpg", ".jpeg", ".png")))
    if not fnames:
        raise SystemExit(f"no images in {image_dir}")
    os.makedirs(out_dir, exist_ok=True)
    n_shards = -(-len(fnames) // shard_size)
    for s in range(n_shards):
        chunk = fnames[s * shard_size:(s + 1) * shard_size]
        entries = {}
        for fname in chunk:
            bgr = cv2.imread(os.path.join(image_dir, fname))
            if bgr is None:
                raise ValueError(
                    f"{os.path.join(image_dir, fname)}: cv2.imread failed "
                    "(corrupt or unsupported image) — fix or remove the file")
            rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
            # _prefetch_images loads pack entries verbatim and the device
            # pipeline assumes uint8 3-channel HWC; enforce the contract at
            # pack time where the bad file can still be named.
            if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
                raise ValueError(
                    f"{fname}: decoded to {rgb.dtype} shape {rgb.shape}, "
                    "expected uint8 HxWx3 — the predict pipeline's "
                    "pre-decoded input contract")
            entries[fname] = rgb
        out = os.path.join(out_dir, f"shard_{s:05d}.npz")
        # savez (uncompressed): loads are raw copies, no inflate cost.
        np.savez(out, **entries)
        print(f"{out}: {len(chunk)} images "
              f"({os.path.getsize(out) / 1e6:.1f} MB)")
    print(f"packed {len(fnames)} images into {n_shards} shard(s) in {out_dir}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image_dir", "-I", required=True)
    p.add_argument("--out_dir", "-O", required=True)
    p.add_argument("--shard_size", type=int, default=64,
                   help="images per npz shard (match --batch_size)")
    args = p.parse_args(argv)
    pack_folder(args.image_dir, args.out_dir, args.shard_size)


if __name__ == "__main__":
    main()
