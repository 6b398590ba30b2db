"""On-the-fly synthetic-training dataset (reference: data/on_the_fly_smpl_train_dataset.py:8-96).

A copy of hierarchicalprobabilistic3dhuman_tpu/data/
on_the_fly_smpl_train_dataset.py, which imports no JAX.

Per item returns only {pose (72,), texture (1200, 800, 3), background
(3, wh, wh)}; everything else (shape, camera, lights, rendering, augmentation)
is sampled on the device inside the train step's synthetic-data stage.

Includes a synthetic fallback (`OnTheFlySMPLTrainDataset.synthetic()`) that
fabricates poses/textures/backgrounds so the training pipeline can run without
the (non-shipped) AMASS/H36M/LSUN files.
"""

import os

import cv2
import numpy as np


class OnTheFlySMPLTrainDataset:
    def __init__(self,
                 poses_path=None,
                 textures_path=None,
                 backgrounds_dir_path=None,
                 params_from="all",
                 grey_tex_prob=0.05,
                 img_wh=256,
                 _synthetic=None,
                 seed=0):
        assert params_from in ["all", "h36m", "up3d", "3dpw", "amass", "not_amass"]
        self.img_wh = img_wh
        self.grey_tex_prob = grey_tex_prob
        self._rng = np.random.RandomState(seed)

        if _synthetic is not None:
            n, tex_hw = _synthetic
            rng = np.random.RandomState(seed)
            self.fnames = np.array([f"synthetic_{i:06d}" for i in range(n)])
            self.poses = (rng.randn(n, 72) * 0.3).astype(np.float32)
            self.grey_textures = (rng.rand(2, *tex_hw, 3) * 255).astype(np.uint8)
            self.nongrey_textures = (rng.rand(4, *tex_hw, 3) * 255).astype(np.uint8)
            self.backgrounds_paths = None
            self._synthetic_bgs = (rng.rand(4, 3, img_wh, img_wh) * 255).astype(np.uint8)
            return

        data = np.load(poses_path)
        fnames = data["fnames"]
        poses = data["poses"]
        if params_from != "all":
            def keep(x):
                known = x.startswith("h36m") or x.startswith("up3d") or x.startswith("3dpw")
                if params_from == "not_amass":
                    return known
                if params_from == "amass":
                    return not known
                return x.startswith(params_from)
            indices = [i for i, x in enumerate(fnames) if keep(str(x))]
            fnames = [fnames[i] for i in indices]
            poses = [poses[i] for i in indices]
        self.fnames = np.asarray(fnames)
        self.poses = np.stack(poses, axis=0).astype(np.float32)

        textures = np.load(textures_path)
        self.grey_textures = textures["grey"]
        self.nongrey_textures = textures["nongrey"]

        self.backgrounds_paths = sorted(
            os.path.join(backgrounds_dir_path, f)
            for f in os.listdir(backgrounds_dir_path) if f.endswith(".jpg"))
        self._synthetic_bgs = None

    @classmethod
    def synthetic(cls, n=64, img_wh=256, tex_hw=(1200, 800), seed=0):
        return cls(_synthetic=(n, tex_hw), img_wh=img_wh, seed=seed)

    def __len__(self):
        return len(self.poses)

    # Textures/backgrounds stay uint8 on the host: the synthetic-data stage
    # normalises them on the device (train driver make_synth_data_fn), so
    # the big tensors cross host->device at 1/4 the float32 byte count.
    def _sample_texture(self):
        if self._rng.rand() < self.grey_tex_prob:
            tex = self.grey_textures[self._rng.randint(len(self.grey_textures))]
        else:
            tex = self.nongrey_textures[self._rng.randint(len(self.nongrey_textures))]
        return np.asarray(tex, np.uint8)

    def _sample_background(self):
        if self.backgrounds_paths is None:
            bg = self._synthetic_bgs[self._rng.randint(len(self._synthetic_bgs))]
            return np.asarray(bg, np.uint8)
        path = self.backgrounds_paths[self._rng.randint(len(self.backgrounds_paths))]
        bg = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        bg = cv2.resize(bg, (self.img_wh, self.img_wh), interpolation=cv2.INTER_LINEAR)
        return np.ascontiguousarray(np.transpose(bg, (2, 0, 1)))

    def __getitem__(self, index):
        return {"pose": self.poses[index],
                "texture": self._sample_texture(),
                "background": self._sample_background()}
