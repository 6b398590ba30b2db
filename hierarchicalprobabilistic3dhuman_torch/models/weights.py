"""Seeded random initialisation, reference checkpoints, and weights carried
across from the JAX package's flax variables.

Reference checkpoints (`.tar`/`.pth`/`.pt`, as the reference's training
wrote them) load with `load_predictor_state_dict` and
`load_hrnet_state_dict`, the counterparts of the JAX package's
cli/predict.py::_load_predictor_variables :18 and _load_hrnet_variables :37.

The port's modules use the reference checkpoints' state-dict keys, so the
JAX package's converters (`torch_to_flax_resnet`, `torch_to_flax_hrnet`,
`torch_to_flax_predictor`) map a state dict of the port to flax variables,
and the functions here are their exact inverses: flax variables (nested
dicts of numpy arrays, e.g. `jax.tree.map(np.asarray, variables)`) -> a
state dict for `module.load_state_dict`.
"""

import numpy as np
import torch
import torch.nn as nn

CHECKPOINT_SUFFIXES = (".tar", ".pth", ".pt")


def init_weights(module, generator):
    """Re-draw every conv/linear weight from N(0, 1/fan_in) with `generator`
    (a CPU torch.Generator); biases and BatchNorm statistics start at the
    identity (zero bias, unit scale, zero mean, unit variance)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return module


def _numpy_scalar_globals():
    """What a reference checkpoint's non-tensor entries (epoch, validation
    metrics) unpickle through: numpy scalars and their dtypes, under
    numpy 2's module names and numpy 1's."""
    multiarray = getattr(np, "_core", None) or np.core
    dtypes = [type(np.dtype(t)) for t in (np.float16, np.float32, np.float64,
                                          np.int32, np.int64, np.bool_)]
    return ([multiarray.multiarray.scalar, np.dtype, *dtypes,
             (multiarray.multiarray.scalar, "numpy.core.multiarray.scalar")])


def load_checkpoint(path):
    """A reference checkpoint's dict, its tensors on the CPU.

    torch.load runs with weights_only=True and admits, besides tensors, only
    numpy scalars. Other formats (the JAX package's flax msgpack
    checkpoints, runtime/checkpointing.py) are ported with training.
    """
    if not str(path).endswith(CHECKPOINT_SUFFIXES):
        raise NotImplementedError(
            f"{path}: only reference checkpoints ({', '.join(CHECKPOINT_SUFFIXES)}) "
            "load in the port; the JAX package's flax checkpoints come with "
            "the training slice (ROADMAP slice 4)")
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_predictor_state_dict(path):
    """The distribution predictor's state dict from a reference checkpoint:
    its best_model_state_dict, else its model_state_dict, else the file's
    dict itself; for PoseMFShapeGaussianNet.load_state_dict(strict=True)."""
    ckpt = load_checkpoint(path)
    return dict(ckpt.get("best_model_state_dict",
                         ckpt.get("model_state_dict", ckpt)))


def load_hrnet_state_dict(path):
    """HRNet-W48's state dict from a reference checkpoint: its state_dict,
    else the file's dict itself, without the keys of the training loss."""
    ckpt = load_checkpoint(path)
    return {k: v for k, v in ckpt.get("state_dict", ckpt).items()
            if not k.startswith("loss")}


def _leaf(tree, path):
    for name in path:
        tree = tree[name]
    return np.asarray(tree)


def _flax_to_state_dict(variables, module, module_path):
    """Fill each entry of `module.state_dict()` from the flax variable that
    `module_path(list of key parts)` names. Conv kernels HWIO -> OIHW, dense
    kernels (in, out) -> (out, in), BatchNorm scale/bias/mean/var ->
    weight/bias/running_mean/running_var."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    for key, ref in module.state_dict().items():
        *mod, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            sd[key] = ref.clone()
            continue
        path = module_path(mod)
        if leaf == "weight" and ref.ndim == 4:
            a = _leaf(params, path + ("kernel",)).transpose(3, 2, 0, 1)
        elif leaf == "weight" and ref.ndim == 2:
            a = _leaf(params, path + ("kernel",)).T
        elif leaf == "weight":
            a = _leaf(params, path + ("scale",))
        elif leaf == "bias":
            a = _leaf(params, path + ("bias",))
        elif leaf == "running_mean":
            a = _leaf(stats, path + ("mean",))
        elif leaf == "running_var":
            a = _leaf(stats, path + ("var",))
        else:
            raise KeyError(f"no flax counterpart for {key}")
        if a.shape != tuple(ref.shape):
            raise ValueError(f"{key}: flax {a.shape} vs torch {tuple(ref.shape)}")
        sd[key] = torch.tensor(np.asarray(a, np.float32))
    return sd


_DOWNSAMPLE = {"0": "downsample_conv", "1": "downsample_bn"}


def _resnet_path(mod):
    if len(mod) == 1:                                   # conv1, bn1
        return (mod[0],)
    block = f"{mod[0]}_{mod[1]}"                        # layer{s}.{i} -> layer{s}_{i}
    if mod[2] == "downsample":
        return (block, _DOWNSAMPLE[mod[3]])
    return (block, mod[2])


def _predictor_path(mod):
    if mod[0] == "image_encoder":
        return ("ResNet_0",) + _resnet_path(mod[1:])
    if mod[0] == "fc_pose":                             # fc_pose.{j}.{0|2}
        return (f"fc_pose_{mod[1]}_{int(mod[2]) // 2}",)
    return (mod[0],)


def _hrnet_path(mod):
    head = mod[0]
    if head == "layer1":
        return _resnet_path(mod)
    if head.startswith("transition"):                   # transition{t}.{b}...{0|1}
        return (f"{head}_{mod[1]}_{'conv' if mod[-1] == '0' else 'bn'}",)
    if head.startswith("stage"):
        module = f"{head}_{mod[1]}"
        if mod[2] == "branches":                        # branches.{b}.{k}.conv1
            return (module, f"branch{mod[3]}_block{mod[4]}", mod[5])
        i, j = int(mod[3]), int(mod[4])                 # fuse_layers.{i}.{j}...
        if j > i:
            return (module, f"fuse{i}_{j}_{'conv' if mod[5] == '0' else 'bn'}")
        kind = "conv" if mod[6] == "0" else "bn"
        return (module, f"fuse{i}_{j}_{kind}{mod[5]}")
    return (head,)                                      # conv1/bn1/.../final_layer


def flax_to_torch_resnet(variables, model):
    """Inverse of the JAX package's torch_to_flax_resnet."""
    return _flax_to_state_dict(variables, model, _resnet_path)


def flax_to_torch_hrnet(variables, model):
    """Inverse of the JAX package's torch_to_flax_hrnet (models/hrnet.py:401).
    Read the flax variables of the unfolded-or-folded PoseHighResolutionNet:
    both share one parameter tree."""
    return _flax_to_state_dict(variables, model, _hrnet_path)


def flax_to_torch_predictor(variables, model):
    """Inverse of the JAX package's torch_to_flax_predictor
    (models/pose_mf_shape_gaussian_net.py:244)."""
    return _flax_to_state_dict(variables, model, _predictor_path)
