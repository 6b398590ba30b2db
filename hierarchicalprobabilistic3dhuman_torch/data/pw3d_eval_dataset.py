"""3DPW evaluation dataset (reference: data/pw3d_eval_dataset.py:10-77).

Reads pre-cropped square frames + 3dpw_test.npz (imgname/pose/shape/gender)
+ precomputed HRNet keypoints; resizes to the proxy size and builds
visibility-masked gaussian heatmaps.

A copy of hierarchicalprobabilistic3dhuman_tpu/data/pw3d_eval_dataset.py
with one addition: items carry the HRNet keypoints at the proxy size as
"keypoints", the ground truth of joints2D-L2E, which the 3DPW metric set
asks for (the JAX package's items lack it, so its 3DPW evaluation stops at
the driver's KeyError for missing ground truth).
"""

import os

import cv2
import numpy as np

from hierarchicalprobabilistic3dhuman_torch.utils.label_conversions import (
    convert_2Djoints_to_gaussian_heatmaps)

ALWAYS_VISIBLE = [0, 1, 2, 3, 4, 5, 6, 11, 12]


class PW3DEvalDataset:
    def __init__(self, pw3d_dir_path, config, visible_joints_threshold=None):
        self.cropped_frames_dir = os.path.join(pw3d_dir_path, "cropped_frames")
        data = np.load(os.path.join(pw3d_dir_path, "3dpw_test.npz"))
        self.frame_fnames = data["imgname"]
        self.pose = data["pose"]
        self.shape = data["shape"]
        self.gender = data["gender"]
        self.keypoints = np.load(os.path.join(pw3d_dir_path,
                                              "hrnet_results_centred.npy"))
        self.img_wh = config.DATA.PROXY_REP_SIZE
        self.hmaps_gaussian_std = config.DATA.HEATMAP_GAUSSIAN_STD
        self.visible_joints_threshold = visible_joints_threshold

    def __len__(self):
        return len(self.frame_fnames)

    def __getitem__(self, index):
        fname = self.frame_fnames[index]
        image = cv2.cvtColor(cv2.imread(os.path.join(self.cropped_frames_dir, str(fname))),
                             cv2.COLOR_BGR2RGB)
        orig_h, orig_w = image.shape[:2]
        assert orig_h == orig_w, \
            "Resizing non-square image to square will cause unwanted stretching!"
        image = cv2.resize(image, (self.img_wh, self.img_wh),
                           interpolation=cv2.INTER_LINEAR)
        image = np.transpose(image, (2, 0, 1)).astype(np.float32) / 255.0

        keypoints = self.keypoints[index]
        confs = keypoints[:, 2]
        kps = keypoints[:, :2] * np.array([self.img_wh / float(orig_w),
                                           self.img_wh / float(orig_h)])
        heatmaps = np.asarray(convert_2Djoints_to_gaussian_heatmaps(
            kps.round().astype(np.int16), self.img_wh, std=self.hmaps_gaussian_std))
        if self.visible_joints_threshold is not None:
            vis = confs > self.visible_joints_threshold
            vis[ALWAYS_VISIBLE] = True
            heatmaps = heatmaps * vis[None, None, :]
        heatmaps = np.transpose(heatmaps, (2, 0, 1)).astype(np.float32)

        return {"image": image,
                "heatmaps": heatmaps,
                "pose": self.pose[index].astype(np.float32),
                "shape": self.shape[index].astype(np.float32),
                "keypoints": kps.astype(np.float32),
                "fname": str(fname),
                "gender": str(self.gender[index])}
