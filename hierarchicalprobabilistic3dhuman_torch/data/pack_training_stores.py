"""Pack training data (poses / textures / backgrounds) into native tensor
stores for the C++ batch sampler.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/data/
pack_training_stores.py: the same functions, flags and paths, with the
port's configs/paths.py and its renderer's DensePose UVs; the arithmetic is
the JAX package's, in its order, so the stores come out byte-equal.

One-off preprocessing: decodes every LSUN background jpg once, resizes to the
proxy size, and writes fixed-record .bin stores. Afterwards the training input
pipeline does no image decoding: batches are assembled by mmap+memcpy on
C++ threads (data/native_loader.py). The three stores hold different record
counts (every pose, every texture, every background); the port's sampler
draws each store's records on its own (csrc/batch_sampler.cpp).

Textures are packed grey and non-grey alike into one store, so a packed run
draws a grey one with the share of grey atlases in the file, where
OnTheFlySMPLTrainDataset draws one with grey_tex_prob = 0.05 (as in the JAX
package).

Usage: python -m hierarchicalprobabilistic3dhuman_torch.data.pack_training_stores \
           --out_dir ./train_files/native [--img_wh 256]
"""

import argparse
import os

import cv2
import numpy as np

from hierarchicalprobabilistic3dhuman_torch.configs import paths
from hierarchicalprobabilistic3dhuman_torch.data.native_loader import write_tensor_store


def pack_backgrounds(backgrounds_dir, out_path, img_wh=256, limit=None):
    fnames = sorted(f for f in os.listdir(backgrounds_dir) if f.endswith(".jpg"))
    if limit:
        fnames = fnames[:limit]
    out = np.empty((len(fnames), 3, img_wh, img_wh), np.uint8)
    for i, f in enumerate(fnames):
        bg = cv2.cvtColor(cv2.imread(os.path.join(backgrounds_dir, f)),
                          cv2.COLOR_BGR2RGB)
        bg = cv2.resize(bg, (img_wh, img_wh), interpolation=cv2.INTER_LINEAR)
        out[i] = np.transpose(bg, (2, 0, 1))
    return write_tensor_store(out_path, out)


def pack_poses(poses_path, out_path):
    data = np.load(poses_path)
    return write_tensor_store(out_path, np.asarray(data["poses"], np.float32))


def sample_texture_atlas_at_vertices(textures):
    """(N, tH, tW, 3) uint8 atlases -> (N, 7829, 3) uint8 per-vertex texels.

    Bilinear sampling at the DensePose per-vertex atlas UVs: what the
    renderer's texture_mode='vertex' does per training step on the device;
    done once at pack time, it shrinks each texture record ~125x.
    """
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        preprocess_densepose_UV)

    uv = preprocess_densepose_UV()["verts_uv_offset"]          # (7829, 2)
    N, tH, tW = textures.shape[:3]
    x = np.clip(uv[:, 0], 0.0, 1.0) * (tW - 1)
    y = (1.0 - np.clip(uv[:, 1], 0.0, 1.0)) * (tH - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    wx = (x - x0)[None, :, None]
    wy = (y - y0)[None, :, None]
    x1 = np.minimum(x0 + 1, tW - 1)
    y1 = np.minimum(y0 + 1, tH - 1)
    t = textures.astype(np.float32)
    out = ((1 - wx) * (1 - wy) * t[:, y0, x0]
           + wx * (1 - wy) * t[:, y0, x1]
           + (1 - wx) * wy * t[:, y1, x0]
           + wx * wy * t[:, y1, x1])
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def pack_textures(textures_path, out_path, per_vertex=True):
    data = np.load(textures_path)
    tex = np.concatenate([data["grey"], data["nongrey"]], axis=0)
    tex = np.asarray(tex, np.uint8)
    if per_vertex:
        tex = sample_texture_atlas_at_vertices(tex)
    return write_tensor_store(out_path, tex)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--img_wh", type=int, default=256)
    parser.add_argument("--full_atlas_textures", action="store_true",
                        help="Store full texture atlases instead of the "
                             "default pre-sampled per-vertex texels (needed "
                             "only for texture_mode='pixel' training).")
    args = parser.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    pack_poses(paths.TRAIN_POSES_PATH, os.path.join(args.out_dir, "poses.bin"))
    pack_textures(paths.TRAIN_TEXTURES_PATH,
                  os.path.join(args.out_dir, "textures.bin"),
                  per_vertex=not args.full_atlas_textures)
    pack_backgrounds(paths.TRAIN_BACKGROUNDS_PATH,
                     os.path.join(args.out_dir, "backgrounds.bin"),
                     img_wh=args.img_wh)
    print(f"Packed stores into {args.out_dir}")
