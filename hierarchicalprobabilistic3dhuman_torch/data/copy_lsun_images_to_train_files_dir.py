"""One-off dataset prep: copy LSUN category images into train_files dirs
(reference: data/copy_lsun_images_to_train_files_dir.py:7-26).

A copy of hierarchicalprobabilistic3dhuman_tpu/data/
copy_lsun_images_to_train_files_dir.py, which imports no JAX.

Usage: python -m hierarchicalprobabilistic3dhuman_torch.data.copy_lsun_images_to_train_files_dir \
           --lsun_dir /path/to/lsun --train_files_dir ./train_files
"""

import argparse
import os
import shutil


def copy_lsun_images(lsun_dir, train_files_dir, categories=None,
                     val_fraction=0.02):
    categories = categories or sorted(
        d for d in os.listdir(lsun_dir) if os.path.isdir(os.path.join(lsun_dir, d)))
    train_out = os.path.join(train_files_dir, "lsun_backgrounds", "train")
    val_out = os.path.join(train_files_dir, "lsun_backgrounds", "val")
    os.makedirs(train_out, exist_ok=True)
    os.makedirs(val_out, exist_ok=True)

    n_train = n_val = 0
    for cat in categories:
        cat_dir = os.path.join(lsun_dir, cat)
        fnames = sorted(f for f in os.listdir(cat_dir)
                        if f.lower().endswith((".jpg", ".jpeg", ".webp")))
        n_val_cat = max(1, int(len(fnames) * val_fraction))
        for i, f in enumerate(fnames):
            dst_dir = val_out if i < n_val_cat else train_out
            shutil.copy(os.path.join(cat_dir, f),
                        os.path.join(dst_dir, f"{cat}_{f}"))
            if i < n_val_cat:
                n_val += 1
            else:
                n_train += 1
    print(f"Copied {n_train} train / {n_val} val backgrounds.")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--lsun_dir", type=str, required=True)
    parser.add_argument("--train_files_dir", type=str, default="./train_files")
    args = parser.parse_args()
    copy_lsun_images(args.lsun_dir, args.train_files_dir)
