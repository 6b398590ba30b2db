"""Seeded random initialisation, and weights carried between the port's
state dicts and the JAX package's files.

`load_predictor_state_dict` and `load_hrnet_state_dict` are the
counterparts of the JAX package's cli/predict.py::_load_predictor_variables
:18 and _load_hrnet_variables :37: they read a reference checkpoint (a
torch file) or a flax variables file (JAX's save_variables), told apart by
the file's content (runtime/checkpointing.py::checkpoint_format).

The port's modules use the reference checkpoints' state-dict keys, so the
JAX package's converters (`torch_to_flax_resnet`, `torch_to_flax_hrnet`,
`torch_to_flax_predictor`) map a state dict of the port to flax variables,
and the `flax_to_torch_*` functions here are their exact inverses: flax
variables (nested dicts of numpy arrays) -> a state dict for
`module.load_state_dict`. The port keeps its own copies of the first and
the last, to write its predictors in JAX's layout, and maps a JAX training
checkpoint's optax.adam state to and from torch.optim.Adam's
(`to_reference_layout`, `to_jax_layout`).
"""

import numpy as np
import torch
import torch.nn as nn

from hierarchicalprobabilistic3dhuman_torch.models.vit import ViT
from hierarchicalprobabilistic3dhuman_torch.runtime.checkpointing import (
    EmptyState, ScaleByAdamState, checkpoint_format, load_checkpoint,
    load_variables)


# A ViT's position table is drawn from N(0, POS_EMBED_STD^2).
POS_EMBED_STD = 0.02
NO_JAX_VIT = ("the JAX package has no ViT encoder, so a ViT predictor has no "
              "JAX (flax) layout: keep its weights and training checkpoints in "
              "the reference's torch layout")


def init_weights(module, generator):
    """Re-draw every conv/linear weight from N(0, 1/fan_in) with `generator`
    (a CPU torch.Generator), in module order; biases, BatchNorm statistics
    and LayerNorms start at the identity (zero bias, unit scale, zero mean,
    unit variance); a ViT's position table from N(0, POS_EMBED_STD^2),
    drawn before its layers."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, ViT):
                m.pos_embed.copy_(torch.randn(m.pos_embed.shape, generator=generator)
                                  * POS_EMBED_STD)
    return module


def _refuse_vit(model):
    """Raise for a predictor whose encoder the JAX package lacks."""
    if model.encoder != "resnet":
        raise ValueError(NO_JAX_VIT)


def _weights_file(path, model, flax_to_torch):
    """A torch checkpoint's dict, or a flax variables file mapped to
    `model`'s state dict; a JAX training checkpoint raises."""
    fmt = checkpoint_format(path)
    if fmt == "torch":
        return load_checkpoint(path)
    if fmt == "flax":
        return flax_to_torch(load_variables(path), model)
    raise ValueError(
        f"{path} is a JAX training checkpoint (a pickle): predict and "
        "evaluate read a reference checkpoint or a flax variables file; "
        "resume training from it with run_train_torch.py -R")


def load_predictor_state_dict(path, model):
    """The distribution predictor's state dict for
    `model.load_state_dict(strict=True)`: from a reference checkpoint its
    best_model_state_dict, else its model_state_dict, else the file's dict
    itself; from a flax variables file, the variables mapped to `model`."""
    ckpt = _weights_file(path, model, flax_to_torch_predictor)
    return dict(ckpt.get("best_model_state_dict",
                         ckpt.get("model_state_dict", ckpt)))


def load_hrnet_state_dict(path, model):
    """HRNet-W48's state dict: from a reference checkpoint its state_dict,
    else the file's dict itself, without the keys of the training loss;
    from a flax variables file, the variables mapped to `model`."""
    ckpt = _weights_file(path, model, flax_to_torch_hrnet)
    return {k: v for k, v in ckpt.get("state_dict", ckpt).items()
            if not k.startswith("loss")}


def _leaf(tree, path):
    for name in path:
        tree = tree[name]
    return np.asarray(tree)


def _flax_to_state_dict(variables, module, module_path, params_only=False):
    """Fill each entry of `module.state_dict()` (of its parameters alone
    with `params_only`) from the flax variable that `module_path(list of
    key parts)` names. Conv kernels HWIO -> OIHW, dense kernels (in, out) ->
    (out, in), BatchNorm scale/bias/mean/var ->
    weight/bias/running_mean/running_var."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    entries = (module.named_parameters() if params_only
               else module.state_dict().items())
    sd = {}
    for key, ref in entries:
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


def torch_to_flax_resnet(state_dict, layers=None):
    """The JAX package's torch_to_flax_resnet (models/resnet.py:139-179), in
    numpy: a torchvision-style ResNet state dict (numpy arrays or CPU
    tensors, no final fc) -> {'params', 'batch_stats'}. JAX's default
    `layers` is (2, 2, 2, 2), which drops blocks of a ResNet-50; here the
    default reads the blocks of each stage from the keys."""
    state_dict = {k: np.asarray(v) for k, v in state_dict.items()}
    if layers is None:
        layers = tuple(len({k.split(".")[1] for k in state_dict
                            if k.startswith(f"layer{s}.")}) for s in range(1, 5))

    def conv_w(key):
        return np.transpose(state_dict[key], (2, 3, 1, 0))   # OIHW -> HWIO

    def bn(prefix):
        return ({"scale": state_dict[prefix + ".weight"],
                 "bias": state_dict[prefix + ".bias"]},
                {"mean": state_dict[prefix + ".running_mean"],
                 "var": state_dict[prefix + ".running_var"]})

    params = {"conv1": {"kernel": conv_w("conv1.weight")}}
    stats = {}
    params["bn1"], stats["bn1"] = bn("bn1")
    is_bottleneck = any(k.startswith("layer1.0.conv3") for k in state_dict)
    convs_per_block = 3 if is_bottleneck else 2
    for stage, num_blocks in enumerate(layers, start=1):
        for i in range(num_blocks):
            tp, fp = f"layer{stage}.{i}", f"layer{stage}_{i}"
            block_p, block_s = {}, {}
            for c in range(1, convs_per_block + 1):
                block_p[f"conv{c}"] = {"kernel": conv_w(f"{tp}.conv{c}.weight")}
                block_p[f"bn{c}"], block_s[f"bn{c}"] = bn(f"{tp}.bn{c}")
            if f"{tp}.downsample.0.weight" in state_dict:
                block_p["downsample_conv"] = {
                    "kernel": conv_w(f"{tp}.downsample.0.weight")}
                block_p["downsample_bn"], block_s["downsample_bn"] = bn(
                    f"{tp}.downsample.1")
            params[fp], stats[fp] = block_p, block_s
    return {"params": params, "batch_stats": stats}


def torch_to_flax_predictor(state_dict, num_joints=23, resnet_layers=None):
    """The JAX package's torch_to_flax_predictor
    (models/pose_mf_shape_gaussian_net.py:244), in numpy: a predictor state
    dict -> flax variables. `resnet_layers` as torch_to_flax_resnet's. A
    ViT predictor's state dict raises (NO_JAX_VIT)."""
    if "image_encoder.pos_embed" in state_dict:
        raise ValueError(NO_JAX_VIT)
    state_dict = {k: np.asarray(v) for k, v in state_dict.items()}
    enc = torch_to_flax_resnet(
        {k[len("image_encoder."):]: v for k, v in state_dict.items()
         if k.startswith("image_encoder.")}, layers=resnet_layers)

    def dense(prefix):
        return {"kernel": state_dict[prefix + ".weight"].T,
                "bias": state_dict[prefix + ".bias"]}

    params = {"ResNet_0": enc["params"]}
    for name in ["fc1", "fc_shape", "fc_cam", "fc_glob", "fc_embed"]:
        params[name] = dense(name)
    for j in range(num_joints):
        params[f"fc_pose_{j}_0"] = dense(f"fc_pose.{j}.0")
        params[f"fc_pose_{j}_1"] = dense(f"fc_pose.{j}.2")
    return {"params": params, "batch_stats": {"ResNet_0": enc["batch_stats"]}}


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


def flax_to_torch_predictor(variables, model, params_only=False):
    """Inverse of the JAX package's torch_to_flax_predictor
    (models/pose_mf_shape_gaussian_net.py:244); of the parameters alone
    with `params_only` (e.g. optax's moments, a tree like the params). A
    ViT predictor raises (NO_JAX_VIT)."""
    _refuse_vit(model)
    return _flax_to_state_dict(variables, model, _predictor_path, params_only)


# --------------------------------------------------------------------------
# Training checkpoints: the JAX package's layout <-> the reference's
# --------------------------------------------------------------------------

def to_reference_layout(checkpoint, model, optimizer):
    """A training checkpoint in the reference's layout. One in the JAX
    package's (runtime/checkpointing.py::load_jax_training_checkpoint) is
    carried across: its flax trees through flax_to_torch_predictor, and
    optax.adam's count / mu / nu into torch.optim.Adam's step / exp_avg /
    exp_avg_sq of each of `model.parameters()`, kernels transposed as the
    weights are (HWIO -> OIHW, (in, out) -> (out, in)). `optimizer` is
    `model`'s Adam, whose hyperparameters the state keeps. A checkpoint in
    the reference's layout is returned as it is; one in JAX's for a ViT
    predictor raises (NO_JAX_VIT)."""
    opt_state = checkpoint["optimiser_state_dict"]
    if not isinstance(opt_state, tuple):
        return checkpoint
    _refuse_vit(model)
    adam, _ = opt_state
    if not isinstance(adam, ScaleByAdamState):
        raise ValueError(f"optimiser state {type(adam).__name__}: only "
                         "optax.adam's is read")
    mu = flax_to_torch_predictor({"params": adam.mu}, model, params_only=True)
    nu = flax_to_torch_predictor({"params": adam.nu}, model, params_only=True)
    step = torch.tensor(float(np.asarray(adam.count)))
    names = [n for n, _ in model.named_parameters()]
    (group,) = optimizer.state_dict()["param_groups"]   # optax.adam's one group
    return {
        "epoch": int(checkpoint["epoch"]),
        "best_epoch": int(checkpoint["best_epoch"]),
        "best_epoch_val_metrics": {k: float(v) for k, v in
                                   checkpoint["best_epoch_val_metrics"].items()},
        "model_state_dict": flax_to_torch_predictor(
            checkpoint["model_state_dict"], model),
        "best_model_state_dict": flax_to_torch_predictor(
            checkpoint["best_model_state_dict"], model),
        "optimiser_state_dict": {
            "state": {i: {"step": step.clone(), "exp_avg": mu[n],
                          "exp_avg_sq": nu[n]} for i, n in enumerate(names)},
            "param_groups": [group]},
    }


def to_jax_layout(checkpoint, model):
    """A training checkpoint in the reference's layout (the port's
    trainer's, for `model`) -> the keyword arguments of
    runtime/checkpointing.py::save_jax_training_checkpoint: flax variables
    through torch_to_flax_predictor, and torch.optim.Adam's state as
    (ScaleByAdamState(count, mu, nu), EmptyState()) with mu and nu in the
    params tree's layout. No entry point calls it: chip_smoke.py and the
    tests do. A ViT predictor raises (NO_JAX_VIT)."""
    _refuse_vit(model)
    names = [n for n, _ in model.named_parameters()]
    state = checkpoint["optimiser_state_dict"]["state"]
    buffers = {k: v for k, v in checkpoint["model_state_dict"].items()
               if k not in names}

    def params_tree(key):
        moments = {n: state[i][key] for i, n in enumerate(names)}
        return torch_to_flax_predictor({**buffers, **moments})["params"]

    steps = {int(s["step"]) for s in state.values()}
    if len(state) != len(names) or len(steps) != 1:
        raise ValueError("Adam state of every parameter at one step expected")
    return {
        "epoch": int(checkpoint["epoch"]),
        "best_epoch": int(checkpoint["best_epoch"]),
        "best_epoch_val_metrics": dict(checkpoint["best_epoch_val_metrics"]),
        "model_variables": torch_to_flax_predictor(checkpoint["model_state_dict"]),
        "best_model_variables": torch_to_flax_predictor(
            checkpoint["best_model_state_dict"]),
        "opt_state": (ScaleByAdamState(count=np.asarray(steps.pop(), np.int32),
                                       mu=params_tree("exp_avg"),
                                       nu=params_tree("exp_avg_sq")),
                      EmptyState()),
    }
