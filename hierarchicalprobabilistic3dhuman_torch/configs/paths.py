"""Model-file paths (reference: configs/paths.py:1-20).

Every path can be overridden via an environment variable; by default the
shipped model files resolve relative to the repository root. Training
dataset paths arrive with the training slice of the port.
"""

import os

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def _p(env_var, default):
    return os.environ.get(env_var, default)


# ------------------- SMPL Files -------------------
SMPL = _p("HP3D_SMPL_DIR", os.path.join(_REPO_ROOT, "model_files", "smpl"))
J_REGRESSOR_EXTRA = _p("HP3D_J_REGRESSOR_EXTRA",
                       os.path.join(_REPO_ROOT, "model_files", "J_regressor_extra.npy"))
COCOPLUS_REGRESSOR = _p("HP3D_COCOPLUS_REGRESSOR",
                        os.path.join(_REPO_ROOT, "model_files", "cocoplus_regressor.npy"))
H36M_REGRESSOR = _p("HP3D_H36M_REGRESSOR",
                    os.path.join(_REPO_ROOT, "model_files", "J_regressor_h36m.npy"))

# ------------------- DensePose Files for Textured Rendering -------------------
DP_UV_PROCESSED_FILE = _p("HP3D_DP_UV_PROCESSED_FILE",
                          os.path.join(_REPO_ROOT, "model_files", "UV_Processed.mat"))

# ------------------------- Eval Datasets -------------------------
PW3D_PATH = _p("HP3D_PW3D_PATH", "./datasets/3DPW/test")
SSP3D_PATH = _p("HP3D_SSP3D_PATH", "./datasets/ssp_3d")
