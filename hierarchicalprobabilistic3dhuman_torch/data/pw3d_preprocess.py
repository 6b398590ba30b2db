"""Offline 3DPW test-set preprocessing (reference: data/pw3d_preprocess.py:102-233).

Counterpart of hierarchicalprobabilistic3dhuman_tpu/data/pw3d_preprocess.py
(pw3d_eval_extract :30-112). Reads the official 3DPW sequence pkls and, for
every person/frame with a valid camera pose: computes the tight bbox from
SMPL-projected vertices, saves a 512x512 person crop, composes the global
orientation with the camera extrinsic rotation, and writes `3dpw_test.npz`
(imgname/center/wh/pose/shape/gender).

SMPL, the projection and the rotation maps run on `device` (the card by
default), batched over one person's valid frames as in the JAX package;
image I/O stays host-side cv2.

Usage: python -m hierarchicalprobabilistic3dhuman_torch.data.pw3d_preprocess \
           --dataset_path /path/to/3DPW [--device cpu]
"""

import argparse
import os
import pickle

import cv2
import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_torch.data.crop_utils_np import crop_opencv_affine
from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
from hierarchicalprobabilistic3dhuman_torch.utils.cam_utils import perspective_project
from hierarchicalprobabilistic3dhuman_torch.utils.device import resolve_device
from hierarchicalprobabilistic3dhuman_torch.utils.rotation_utils import so3_exp, so3_log


def pw3d_eval_extract(dataset_path, out_path, crop_wh=512, smpl_models=None,
                      device="cuda"):
    """:param smpl_models: {"m": SMPL, "f": SMPL} on `device`; by default
        the licensed male and female models from configs/paths.py's SMPL
        directory."""
    bbox_scale_factor = 1.2
    device = resolve_device(device)

    if smpl_models is None:
        smpl_models = {"m": SMPL.from_files(device, gender="male"),
                       "f": SMPL.from_files(device, gender="female")}

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    fnames_, whs_, centers_ = [], [], []
    poses_, shapes_, genders_ = [], [], []

    seq_dir = os.path.join(dataset_path, "sequenceFiles", "test")
    sequence_files = sorted(os.path.join(seq_dir, f) for f in os.listdir(seq_dir)
                            if f.endswith(".pkl"))

    for filename in sequence_files:
        print(filename)
        with open(filename, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        smpl_poses = data["poses"]
        smpl_betas = data["betas"]
        cam_extrinsics = data["cam_poses"]     # (num frames, 4, 4)
        cam_K = np.asarray(data["cam_intrinsics"], np.float32)
        genders = data["genders"]
        valid = data["campose_valid"]
        trans = data["trans"]
        seq_name = str(data["sequence"])
        num_people = len(smpl_poses)
        num_frames = len(smpl_poses[0])

        for person_num in range(num_people):
            valid_frames = np.asarray(valid[person_num]).astype(bool)
            shape = np.asarray(smpl_betas[person_num][:10], np.float32)
            gender = genders[person_num]
            smpl = smpl_models[gender]

            frame_ids = np.nonzero(valid_frames[:num_frames])[0]
            if len(frame_ids) == 0:
                continue
            # Batched SMPL + projection over all valid frames of this person.
            n = len(frame_ids)
            pose_batch = np.asarray(smpl_poses[person_num])[frame_ids].astype(np.float32)
            trans_batch = np.asarray(trans[person_num])[frame_ids].astype(np.float32)
            R_batch = tensor(cam_extrinsics[frame_ids, :3, :3])
            t_batch = tensor(cam_extrinsics[frame_ids, :3, 3])
            pose_t = tensor(pose_batch)
            with torch.no_grad():
                out = smpl(body_pose=pose_t[:, 3:], global_orient=pose_t[:, :3],
                           betas=tensor(shape).expand(n, 10),
                           transl=tensor(trans_batch))
                projected = perspective_project(
                    out["vertices"], R_batch, t_batch,
                    cam_K=tensor(cam_K).expand(n, 3, 3)).cpu().numpy()
                # Compose global orient with camera rotation (reference :195-198).
                new_glob = so3_log(R_batch @ so3_exp(pose_t[:, :3])).cpu().numpy()

            for k, frame_num in enumerate(frame_ids):
                pv = projected[k]
                bbox = [pv[:, 0].min(), pv[:, 1].min(), pv[:, 0].max(), pv[:, 1].max()]
                center = [(bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2]
                wh = max(bbox[2] - bbox[0], bbox[3] - bbox[1])

                image_fpath = os.path.join(dataset_path, "imageFiles", seq_name,
                                           f"image_{frame_num:05d}.jpg")
                image = cv2.imread(image_fpath)
                crop = crop_opencv_affine(
                    (crop_wh, crop_wh),
                    rgb=np.transpose(image, (2, 0, 1)),
                    bbox_centre=np.array([center[1], center[0]]),  # (vert, hor)
                    bbox_wh=wh, orig_scale_factor=bbox_scale_factor)
                cropped = np.transpose(crop["rgb"], (1, 2, 0))
                fname = f"{seq_name}_image_{frame_num:05d}_person_{person_num:03d}.png"
                cv2.imwrite(os.path.join(out_path, "cropped_frames", fname), cropped)

                pose = pose_batch[k].copy()
                pose[:3] = new_glob[k]
                fnames_.append(fname)
                centers_.append(center)
                whs_.append(wh)
                poses_.append(pose)
                shapes_.append(shape)
                genders_.append(gender)

    np.savez(os.path.join(out_path, "3dpw_test.npz"),
             imgname=fnames_, center=centers_, wh=whs_,
             pose=poses_, shape=shapes_, gender=genders_)
    print(f"Wrote {len(fnames_)} frames to {out_path}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_path", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; fails without a card) or cpu.")
    args = parser.parse_args()
    out_path = os.path.join(args.dataset_path, "test")
    os.makedirs(os.path.join(out_path, "cropped_frames"), exist_ok=True)
    pw3d_eval_extract(args.dataset_path, out_path, device=args.device)
