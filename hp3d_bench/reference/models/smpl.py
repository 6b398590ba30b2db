"""SMPL body model in torch: shape/pose blendshapes + linear blend skinning.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/models/smpl.py (lbs :342,
smpl_forward :491 with the 90-joint output :539-543, synthetic_smpl_params
:225, the SMPL wrapper :552; the official .pkl loader :78-158; per-example
genders, lbs_mixed :378 and smpl_forward_mixed :436). Joints (B, 90, 3):
  [0:24]   SMPL kinematic joints (posed)
  [24:45]  21 surface landmark joints
  [45:54]  J_regressor_extra (9)
  [54:73]  cocoplus regressor (19)
  [73:90]  H36M regressor (17)
"""

import os
import pickle
from dataclasses import dataclass, fields

import numpy as np
import torch

from hp3d_bench.reference.configs import paths
from hp3d_bench.reference.renderers.textured_iuv_renderer import (
    preprocess_densepose_UV)
from hp3d_bench.reference.utils.rotation_utils import so3_exp

NUM_VERTS = 6890
NUM_JOINTS = 24  # kinematic joints (1 root + 23 body)
NUM_BODY_JOINTS = 23

# SMPL kinematic tree: parent of joint i (root = -1).
SMPL_PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8,
                         9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21], dtype=np.int32)

# Surface landmark vertex ids, in smplx VertexJointSelector order.
EXTRA_LANDMARK_VERTEX_IDS = np.array([
    332, 6260, 2800, 4071, 583,
    3216, 3226, 3387, 6617, 6624, 6787,
    2746, 2319, 2445, 2556, 2673,
    6191, 5782, 5905, 6016, 6133,
], dtype=np.int64)


@dataclass
class SMPLParams:
    """SMPL model tensors, all on one device."""
    v_template: torch.Tensor      # (V, 3)
    shapedirs: torch.Tensor       # (V, 3, num_betas)
    posedirs: torch.Tensor        # (23*9, V*3) pose-corrective basis
    J_regressor: torch.Tensor     # (24, V)
    lbs_weights: torch.Tensor     # (V, 24)
    faces: torch.Tensor           # (F, 3) int64
    J_regressor_extra: torch.Tensor     # (9, V)
    J_regressor_cocoplus: torch.Tensor  # (19, V)
    J_regressor_h36m: torch.Tensor      # (17, V)

    @classmethod
    def from_numpy(cls, arrays, device):
        """Build from a mapping of the field names to numpy arrays (as the
        JAX package's SMPLParams holds them)."""
        out = {}
        for f in fields(cls):
            a = np.asarray(arrays[f.name])
            dtype = torch.int64 if f.name == "faces" else torch.float32
            out[f.name] = torch.as_tensor(a, dtype=dtype, device=device)
        return cls(**out)


def _as_dense(x):
    """Handle scipy sparse matrices and chumpy-wrapped arrays from SMPL pkls."""
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    if hasattr(x, "x") and not isinstance(x, np.ndarray):  # chumpy Ch object
        return np.asarray(x.x)
    return np.asarray(x)


class _ChumpyStub:
    """Stand-in for chumpy objects during unpickling (chumpy is not installed)."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {"x": state})


class _SMPLUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def load_smpl_pkl(pkl_path):
    """Load an official SMPL .pkl (chumpy-free) into a dict of its fields.
    Unpickling runs code the file names: load only the official files."""
    with open(pkl_path, "rb") as f:
        return _SMPLUnpickler(f, encoding="latin1").load()


def convert_smpl_pkl_to_npz(pkl_path, npz_path, num_betas=10):
    """One-off converter: official SMPL pkl -> npz of plain numpy arrays."""
    data = load_smpl_pkl(pkl_path)
    np.savez(
        npz_path,
        v_template=_as_dense(data["v_template"]).astype(np.float32),
        shapedirs=np.asarray(_as_dense(data["shapedirs"]), np.float32)[:, :, :num_betas],
        posedirs=_as_dense(data["posedirs"]).astype(np.float32),
        J_regressor=_as_dense(data["J_regressor"]).astype(np.float32),
        weights=_as_dense(data["weights"]).astype(np.float32),
        f=_as_dense(data["f"]).astype(np.int32),
        kintree_table=_as_dense(data["kintree_table"]).astype(np.int64),
    )


def _load_extra_regressors():
    return (np.load(paths.J_REGRESSOR_EXTRA).astype(np.float32),
            np.load(paths.COCOPLUS_REGRESSOR).astype(np.float32),
            np.load(paths.H36M_REGRESSOR).astype(np.float32))


def smpl_arrays_from_native(data, num_betas=10):
    """Numpy SMPL arrays from a dict with native SMPL fields (npz or pkl)."""
    def dense(key):
        return _as_dense(data[key]).astype(np.float32)
    posedirs = dense("posedirs")                                   # (V, 3, 207)
    jre, jrc, jrh = _load_extra_regressors()
    return {
        "v_template": dense("v_template"),
        "shapedirs": dense("shapedirs")[:, :, :num_betas],
        "posedirs": posedirs.reshape(-1, posedirs.shape[-1]).T,
        "J_regressor": dense("J_regressor"),
        "lbs_weights": dense("weights"),
        "faces": _as_dense(data["f"]).astype(np.int64),
        "J_regressor_extra": jre,
        "J_regressor_cocoplus": jrc,
        "J_regressor_h36m": jrh,
    }


def _synthetic_template_from_densepose(rng, dp):
    """Body-shaped synthetic template from the shipped DensePose (part, U, V)
    vertex coordinates: per-part boxes arranged as a T-pose figure."""
    def box(cx, cy, su, sv, depth=0.05):
        return np.array([cx, cy, su, sv, depth], np.float32)

    placement = {
        1: box(0.0, 0.15, 0.18, 0.30), 2: box(0.0, 0.15, 0.18, 0.30, -0.05),
        3: box(0.62, 0.28, 0.05, 0.05), 4: box(-0.62, 0.28, 0.05, 0.05),
        5: box(-0.12, -0.92, 0.06, 0.08), 6: box(0.12, -0.92, 0.06, 0.08),
        7: box(0.10, -0.35, 0.08, 0.18), 9: box(0.10, -0.35, 0.08, 0.18, -0.04),
        8: box(-0.10, -0.35, 0.08, 0.18), 10: box(-0.10, -0.35, 0.08, 0.18, -0.04),
        11: box(-0.11, -0.68, 0.06, 0.16), 13: box(-0.11, -0.68, 0.06, 0.16, -0.04),
        12: box(0.11, -0.68, 0.06, 0.16), 14: box(0.11, -0.68, 0.06, 0.16, -0.04),
        15: box(-0.32, 0.30, 0.10, 0.06), 17: box(-0.32, 0.30, 0.10, 0.06, -0.03),
        16: box(0.32, 0.30, 0.10, 0.06), 18: box(0.32, 0.30, 0.10, 0.06, -0.03),
        19: box(-0.50, 0.29, 0.09, 0.05), 21: box(-0.50, 0.29, 0.09, 0.05, -0.03),
        20: box(0.50, 0.29, 0.09, 0.05), 22: box(0.50, 0.29, 0.09, 0.05, -0.03),
        23: box(0.0, 0.52, 0.08, 0.09), 24: box(0.0, 0.52, 0.08, 0.09, -0.04),
    }
    template = np.zeros((NUM_VERTS, 3), np.float32)
    counts = np.zeros(NUM_VERTS, np.int32)
    parts = dp["verts_iuv"][:, 0].astype(np.int32)
    uu = dp["verts_iuv"][:, 1]
    vv = dp["verts_iuv"][:, 2]
    vmap = dp["verts_map"]
    for i in range(len(vmap)):
        cx, cy, su, sv, depth = placement[int(parts[i])]
        x = cx + su * (uu[i] - 0.5) * 2
        y = cy + sv * (vv[i] - 0.5) * 2
        z = depth * (1.0 - (2 * uu[i] - 1) ** 2) * (1.0 - (2 * vv[i] - 1) ** 2)
        smpl_idx = int(vmap[i])
        template[smpl_idx] += np.array([x, y, z], np.float32)
        counts[smpl_idx] += 1
    covered = counts > 0
    template[covered] /= counts[covered, None]
    template[~covered] = 0.05 * rng.randn((~covered).sum(), 3)
    template += 0.002 * rng.randn(NUM_VERTS, 3)  # break exact coplanarity
    return template.astype(np.float32)


def synthetic_smpl_params(num_betas=10, seed=0):
    """Structurally-correct random SMPL arrays (numpy) for runs without the
    licensed SMPL files: real topology sizes, a body-shaped template,
    normalised regressors and locality-biased skinning weights. Draws the
    same numbers in the same order as the JAX package's generator, so both
    build identical models from one seed.
    """
    rng = np.random.RandomState(seed)
    dp = preprocess_densepose_UV()
    v_template = _synthetic_template_from_densepose(rng, dp)
    shapedirs = (rng.randn(NUM_VERTS, 3, num_betas) * 0.01).astype(np.float32)
    posedirs_native = (rng.randn(NUM_VERTS, 3, 207) * 0.001).astype(np.float32)

    # Kinematic joints placed anatomically on the template.
    joint_centres = np.array([
        [0.00, -0.12, 0.0],
        [-0.10, -0.17, 0.0], [0.10, -0.17, 0.0],
        [0.00, 0.02, 0.0],
        [-0.10, -0.52, 0.0], [0.10, -0.52, 0.0],
        [0.00, 0.14, 0.0],
        [-0.12, -0.84, 0.0], [0.12, -0.84, 0.0],
        [0.00, 0.26, 0.0],
        [-0.12, -0.93, 0.0], [0.12, -0.93, 0.0],
        [0.00, 0.40, 0.0],
        [-0.07, 0.36, 0.0], [0.07, 0.36, 0.0],
        [0.00, 0.51, 0.0],
        [-0.24, 0.31, 0.0], [0.24, 0.31, 0.0],
        [-0.42, 0.30, 0.0], [0.42, 0.30, 0.0],
        [-0.58, 0.29, 0.0], [0.58, 0.29, 0.0],
        [-0.64, 0.28, 0.0], [0.64, 0.28, 0.0],
    ], dtype=np.float32)
    joint_centres += (0.01 * rng.randn(NUM_JOINTS, 3)).astype(np.float32)

    d2 = ((v_template[None, :, :] - joint_centres[:, None, :]) ** 2).sum(-1)
    J_regressor = np.exp(-d2 / 0.005)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)
    w = np.exp(-d2.T / 0.02)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    # Faces: the DensePose triangulation mapped to SMPL vertex indexing,
    # padded to the real SMPL face count.
    faces = dp["verts_map"][dp["faces"]].astype(np.int64)
    faces = np.concatenate([faces, np.zeros((2, 3), np.int64)], axis=0)

    jre, jrc, jrh = _load_extra_regressors()
    return {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs_native.reshape(-1, 207).T,
        "J_regressor": J_regressor.astype(np.float32),
        "lbs_weights": lbs_weights,
        "faces": faces,
        "J_regressor_extra": jre,
        "J_regressor_cocoplus": jrc,
        "J_regressor_h36m": jrh,
    }


def _batch_rigid_transform(rot_mats, joints, parents):
    """World transforms along the kinematic tree.

    :param rot_mats: (B, 24, 3, 3)
    :param joints: (B, 24, 3) rest-pose joint locations
    :return: posed_joints (B, 24, 3), rel_transforms (B, 24, 4, 4)
    """
    B, J = rot_mats.shape[:2]
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parents[1:]]],
                           dim=1)
    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)     # (B, J, 3, 4)
    bottom = torch.zeros((B, J, 1, 4), dtype=rot_mats.dtype, device=rot_mats.device)
    bottom[..., 0, 3] = 1.0
    transforms_mat = torch.cat([top, bottom], dim=-2)              # (B, J, 4, 4)

    chain = [transforms_mat[:, 0]]
    for i in range(1, NUM_JOINTS):
        chain.append(chain[parents[i]] @ transforms_mat[:, i])
    transforms = torch.stack(chain, dim=1)

    posed_joints = transforms[:, :, :3, 3]
    joints_hom = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    init_bone = (transforms @ joints_hom[..., None])[..., :3, 0]   # (B, J, 3)
    rel_transforms = transforms.clone()
    rel_transforms[:, :, :3, 3] -= init_bone
    return posed_joints, rel_transforms


def lbs(params, betas, full_pose_rotmats):
    """Core SMPL forward: betas + 24 rotation matrices -> vertices, joints.

    :param betas: (B, num_betas)
    :param full_pose_rotmats: (B, 24, 3, 3) [global_orient, 23 body rotations]
    :return: vertices (B, 6890, 3), kinematic joints (B, 24, 3)
    """
    B = betas.shape[0]
    v_shaped = params.v_template[None] + torch.einsum("vcn,bn->bvc",
                                                      params.shapedirs, betas)
    J = torch.einsum("jv,bvc->bjc", params.J_regressor, v_shaped)
    eye = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    pose_feature = (full_pose_rotmats[:, 1:] - eye).reshape(B, -1)  # (B, 207)
    v_posed = v_shaped + (pose_feature @ params.posedirs).reshape(B, -1, 3)
    posed_joints, rel_transforms = _batch_rigid_transform(
        full_pose_rotmats, J, SMPL_PARENTS)
    T = torch.einsum("vj,bjpq->bvpq", params.lbs_weights, rel_transforms)
    v_hom = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvpq,bvq->bvp", T, v_hom)[..., :3]
    return verts, posed_joints


def vertices2joints(J_regressor, vertices):
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("jv,bvc->bjc", J_regressor, vertices)


def smpl_forward(params, betas=None, body_pose=None, global_orient=None,
                 transl=None, pose2rot=True, batch_size=None):
    """Full SMPL forward with the reference wrapper's 90-joint output.

      - pose2rot=True: body_pose (B, 69) and global_orient (B, 3) axis-angle
      - pose2rot=False: body_pose (B, 23, 3, 3), global_orient (B, 1, 3, 3)
      - any argument may be None -> neutral (zeros / identity)
      - transl (B, 3), if given, is added to the vertices and joints

    :return: dict with 'vertices' (B, 6890, 3) and 'joints' (B, 90, 3).
    """
    if batch_size is None:
        batch_size = next(a.shape[0] for a in (betas, body_pose, global_orient)
                          if a is not None)
    B = batch_size
    if betas is None:
        betas = torch.zeros((B, params.shapedirs.shape[-1]),
                            dtype=params.v_template.dtype,
                            device=params.v_template.device)
    verts, kin_joints = lbs(params, betas, _rotmats(params, B, body_pose,
                                                    global_orient, pose2rot))
    joints = _joints90(params, verts, kin_joints)
    if transl is not None:
        verts = verts + transl[:, None, :]
        joints = joints + transl[:, None, :]
    return {"vertices": verts, "joints": joints}


def lbs_mixed(params_list, gender_onehot, betas, full_pose_rotmats):
    """SMPL forward where each example uses its OWN gendered model params.

    Every place the gendered parameters enter is linear in them, so mixing
    the G per-gender contraction results (or the small parameter tensors
    themselves) with the (B, G) one-hot reproduces
    ``lbs(params_list[g[b]], ...)`` row by row; kinematics and skinning run
    once on the mixed quantities.

    :param params_list: sequence of G SMPLParams (same shapes).
    :param gender_onehot: (B, G) float one-hot rows.
    :param betas: (B, num_betas)
    :param full_pose_rotmats: (B, 24, 3, 3)
    :return: vertices (B, 6890, 3), kinematic joints (B, 24, 3)
    """
    B = betas.shape[0]
    oh = gender_onehot.to(betas.dtype)

    def mix(per_gender):
        # per_gender: G of (B, ...) -> (B, ...)
        return torch.einsum("gb...,bg->b...", torch.stack(per_gender), oh)

    v_shaped = mix([p.v_template[None]
                    + torch.einsum("vcn,bn->bvc", p.shapedirs, betas)
                    for p in params_list])
    J_reg = torch.einsum("gjv,bg->bjv",
                         torch.stack([p.J_regressor for p in params_list]), oh)
    J = torch.einsum("bjv,bvc->bjc", J_reg, v_shaped)

    eye = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    pose_feature = (full_pose_rotmats[:, 1:] - eye).reshape(B, -1)
    pose_offsets = mix([(pose_feature @ p.posedirs).reshape(B, -1, 3)
                        for p in params_list])
    v_posed = v_shaped + pose_offsets

    posed_joints, rel_transforms = _batch_rigid_transform(
        full_pose_rotmats, J, SMPL_PARENTS)
    lbs_w = torch.einsum("gvj,bg->bvj",
                         torch.stack([p.lbs_weights for p in params_list]), oh)
    T = torch.einsum("bvj,bjpq->bvpq", lbs_w, rel_transforms)
    v_hom = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvpq,bvq->bvp", T, v_hom)[..., :3]
    return verts, posed_joints


def _rotmats(params, B, body_pose, global_orient, pose2rot):
    """(B, 24, 3, 3) [global_orient, 23 body rotations], neutral where an
    argument is None."""
    dtype, device = params.v_template.dtype, params.v_template.device
    if pose2rot:
        if body_pose is None:
            body_pose = torch.zeros((B, NUM_BODY_JOINTS * 3), dtype=dtype,
                                    device=device)
        if global_orient is None:
            global_orient = torch.zeros((B, 3), dtype=dtype, device=device)
        body_rotmats = so3_exp(body_pose.reshape(B, NUM_BODY_JOINTS, 3))
        glob_rotmats = so3_exp(global_orient.reshape(B, 1, 3))
    else:
        eye = torch.eye(3, dtype=dtype, device=device)
        body_rotmats = (body_pose.reshape(B, NUM_BODY_JOINTS, 3, 3)
                        if body_pose is not None
                        else eye.expand(B, NUM_BODY_JOINTS, 3, 3))
        glob_rotmats = (global_orient.reshape(B, 1, 3, 3)
                        if global_orient is not None else eye.expand(B, 1, 3, 3))
    return torch.cat([glob_rotmats, body_rotmats], dim=1)


def _joints90(params, verts, kin_joints):
    """The reference wrapper's 90 joints from the posed vertices."""
    landmark_ids = torch.as_tensor(EXTRA_LANDMARK_VERTEX_IDS,
                                   device=verts.device)
    return torch.cat([kin_joints,
                      verts[:, landmark_ids],
                      vertices2joints(params.J_regressor_extra, verts),
                      vertices2joints(params.J_regressor_cocoplus, verts),
                      vertices2joints(params.J_regressor_h36m, verts)], dim=1)


def smpl_forward_mixed(params_list, gender_code, betas=None, body_pose=None,
                       global_orient=None, pose2rot=True, batch_size=None):
    """`smpl_forward` for per-example gendered params via `lbs_mixed`.

    :param params_list: sequence of G SMPLParams, indexed by gender_code.
    :param gender_code: (B,) int — index into params_list per example.

    The three extra joint regressors are the same for every gender in the
    reference, so the 90-joint assembly runs once, from params_list[0].
    """
    if batch_size is None:
        batch_size = next(a.shape[0] for a in (betas, body_pose, global_orient)
                          if a is not None)
    B = batch_size
    p0 = params_list[0]
    if betas is None:
        betas = torch.zeros((B, p0.shapedirs.shape[-1]),
                            dtype=p0.v_template.dtype, device=p0.v_template.device)
    onehot = torch.nn.functional.one_hot(gender_code.to(torch.int64),
                                         len(params_list))
    verts, kin_joints = lbs_mixed(params_list, onehot, betas,
                                  _rotmats(p0, B, body_pose, global_orient,
                                           pose2rot))
    return {"vertices": verts, "joints": _joints90(p0, verts, kin_joints)}


class SMPL:
    """Callable SMPL model (reference models/smpl_official.py:13-41 surface).

    `SMPL.from_files(device, gender)` reads SMPL_{GENDER}.npz under
    `paths.SMPL`, or SMPL_{GENDER}.pkl where there is no .npz; the licensed
    files are not shipped, so runs without them use `SMPL.synthetic(device)`.
    """

    def __init__(self, params):
        self.params = params

    @classmethod
    def from_files(cls, device, gender="neutral", num_betas=10,
                   model_path=None):
        base = os.path.join(model_path or paths.SMPL, f"SMPL_{gender.upper()}")
        if os.path.exists(base + ".npz"):
            data = dict(np.load(base + ".npz", allow_pickle=True))
        elif os.path.exists(base + ".pkl"):
            data = load_smpl_pkl(base + ".pkl")
        else:
            raise FileNotFoundError(
                f"No SMPL model file at {base}.(npz|pkl). Official SMPL files "
                f"are licensed and must be downloaded separately.")
        arrays = smpl_arrays_from_native(data, num_betas=num_betas)
        return cls(SMPLParams.from_numpy(arrays, device))

    @classmethod
    def synthetic(cls, device, num_betas=10, seed=0):
        return cls(SMPLParams.from_numpy(
            synthetic_smpl_params(num_betas=num_betas, seed=seed), device))

    @property
    def faces(self):
        return self.params.faces

    def __call__(self, betas=None, body_pose=None, global_orient=None,
                 transl=None, pose2rot=True, batch_size=None):
        return smpl_forward(self.params, betas=betas, body_pose=body_pose,
                            global_orient=global_orient, transl=transl,
                            pose2rot=pose2rot, batch_size=batch_size)
