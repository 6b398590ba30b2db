"""SSP-3D evaluation dataset (reference: data/ssp3d_eval_dataset.py:11-94).

A copy of hierarchicalprobabilistic3dhuman_tpu/data/ssp3d_eval_dataset.py
with the port's imports.

Reads labels.npz (fnames/shapes/poses/joints2D/bbox/genders), crops images,
keypoints and silhouettes around the provided bbox, builds heatmaps.
"""

import os

import cv2
import numpy as np

from hierarchicalprobabilistic3dhuman_torch.data.crop_utils_np import crop_opencv_affine
from hierarchicalprobabilistic3dhuman_torch.utils.label_conversions import (
    convert_2Djoints_to_gaussian_heatmaps)

ALWAYS_VISIBLE = [0, 1, 2, 3, 4, 5, 6, 11, 12]


class SSP3DEvalDataset:
    def __init__(self, ssp3d_dir_path, config, visible_joints_threshold=None):
        self.images_dir = os.path.join(ssp3d_dir_path, "images")
        self.silhouettes_dir = os.path.join(ssp3d_dir_path, "silhouettes")
        data = np.load(os.path.join(ssp3d_dir_path, "labels.npz"))
        self.frame_fnames = data["fnames"]
        self.body_shapes = data["shapes"]
        self.body_poses = data["poses"]
        self.keypoints = data["joints2D"]
        self.bbox_centres = data["bbox_centres"]
        self.bbox_whs = data["bbox_whs"]
        self.genders = data["genders"]

        self.img_wh = config.DATA.PROXY_REP_SIZE
        self.hmaps_gaussian_std = config.DATA.HEATMAP_GAUSSIAN_STD
        self.bbox_scale_factor = config.DATA.BBOX_SCALE_FACTOR
        self.visible_joints_threshold = visible_joints_threshold

    def __len__(self):
        return len(self.frame_fnames)

    def __getitem__(self, index):
        fname = str(self.frame_fnames[index])
        image = cv2.cvtColor(cv2.imread(os.path.join(self.images_dir, fname)),
                             cv2.COLOR_BGR2RGB)
        keypoints = np.copy(self.keypoints[index])
        confs = keypoints[:, 2]

        crop = crop_opencv_affine((self.img_wh, self.img_wh),
                                  rgb=np.transpose(image, (2, 0, 1)),
                                  joints2D=keypoints[:, :2],
                                  bbox_centre=self.bbox_centres[index],
                                  bbox_wh=self.bbox_whs[index],
                                  orig_scale_factor=self.bbox_scale_factor)
        image = crop["rgb"].astype(np.float32) / 255.0
        kps = crop["joints2D"]

        heatmaps = np.asarray(convert_2Djoints_to_gaussian_heatmaps(
            kps.astype(np.int16), self.img_wh, std=self.hmaps_gaussian_std))
        if self.visible_joints_threshold is not None:
            vis = confs > self.visible_joints_threshold
            vis[ALWAYS_VISIBLE] = True
            heatmaps = heatmaps * vis[None, None, :]
        heatmaps = np.transpose(heatmaps, (2, 0, 1)).astype(np.float32)

        silhouette = cv2.imread(os.path.join(self.silhouettes_dir, fname), 0)
        silhouette = crop_opencv_affine((self.img_wh, self.img_wh),
                                        seg=silhouette,
                                        bbox_centre=self.bbox_centres[index],
                                        bbox_wh=self.bbox_whs[index],
                                        orig_scale_factor=self.bbox_scale_factor)["seg"]

        return {"image": image,
                "heatmaps": heatmaps,
                "shape": self.body_shapes[index].astype(np.float32),
                "pose": self.body_poses[index].astype(np.float32),
                "silhouette": silhouette.astype(np.float32),
                "keypoints": kps.astype(np.float32),
                "fname": fname,
                "gender": str(self.genders[index])}
