"""Checkpoint files: the reference's torch checkpoints, and the JAX package's
flax variables and training checkpoints, told apart by their content.

Counterpart of hierarchicalprobabilistic3dhuman_tpu/runtime/checkpointing.py
(save_variables :23, load_variables :30, checkpoint_path :35,
save_training_checkpoint :40, load_training_checkpoint :56,
load_training_info_from_checkpoint :61). Three formats:

  * "torch": a torch.save file (a zip holding data.pkl, or the legacy
    pickle that starts with torch's magic number), as the reference and the
    port's trainer write them: {epoch, best_epoch, best_epoch_val_metrics,
    model_state_dict, best_model_state_dict, optimiser_state_dict} with the
    state dicts under the reference checkpoint's key names, at
    saved_models/epoch_{N:03d}.tar, or a predictor's or HRNet's weights.
    Read with weights_only=True;
  * "flax": a msgpack map of flax variables, as JAX's save_variables writes
    them (runtime/flax_msgpack.py reads and writes it);
  * "pickle": the JAX package's training checkpoint, a pickle of the same
    dict with flax trees of numpy arrays and optax.adam's state
    (ScaleByAdamState(count, mu, nu), EmptyState()). It is read by an
    unpickler that admits numpy's array globals and maps optax's two classes
    to the stand-ins below, so neither optax nor anything else is imported,
    and written with those stand-ins under optax's names, so the JAX
    package's pickle.load reads it back as its own.

models/weights.py maps the flax trees to and from the port's state dicts.
"""

import os
import pickle
import zipfile
from typing import Any, NamedTuple

import numpy as np
import torch

from hierarchicalprobabilistic3dhuman_torch.runtime import flax_msgpack

_TORCH_LEGACY_MAGIC = b"\x80\x02\x8a\x0al\xfc\x9cF\xf9 j\xa8P\x19"


def checkpoint_format(path):
    """"torch", "flax" or "pickle" (see the module docstring), from the
    file's first bytes; anything else raises ValueError."""
    with open(path, "rb") as f:
        head = f.read(len(_TORCH_LEGACY_MAGIC))
    if head.startswith(b"PK\x03\x04"):
        with zipfile.ZipFile(path) as z:
            if any(n.endswith("data.pkl") for n in z.namelist()):
                return "torch"
    elif head.startswith(_TORCH_LEGACY_MAGIC):
        return "torch"
    elif len(head) > 1 and head[0] == 0x80 and 2 <= head[1] <= 5:
        return "pickle"
    elif head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "flax"
    raise ValueError(f"{path}: neither a torch checkpoint, a flax variables "
                     f"file nor a JAX training checkpoint")


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
    """A torch checkpoint's dict, its tensors on the CPU. torch.load runs
    with weights_only=True and admits, besides tensors, only numpy scalars."""
    if checkpoint_format(path) != "torch":
        raise ValueError(f"{path}: not a torch checkpoint")
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        return torch.load(path, map_location="cpu", weights_only=True)


def save_variables(path, variables):
    """A tree of numpy arrays (flax variables) as JAX's save_variables
    writes it: flax's msgpack."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(flax_msgpack.serialize(variables))


def load_variables(path):
    """The tree of a flax variables file; its arrays are read-only views
    into the file's bytes."""
    with open(path, "rb") as f:
        return flax_msgpack.restore(f.read())


def checkpoint_path(model_save_dir, epoch):
    """The reference's naming: epoch_{N:03d}.tar."""
    return os.path.join(model_save_dir, f"epoch_{epoch:03d}.tar")


def state_dict_on_cpu(module):
    """A copy of a module's state dict on the CPU (for best weights and
    checkpoints)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}


def save_training_checkpoint(path, *, epoch, best_epoch, best_epoch_val_metrics,
                             model_state_dict, best_model_state_dict,
                             optimiser_state_dict):
    """Write the reference's training checkpoint dict with torch.save."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({
        "epoch": int(epoch),
        "best_epoch": int(best_epoch),
        "best_epoch_val_metrics": {k: float(v)
                                   for k, v in best_epoch_val_metrics.items()},
        "model_state_dict": model_state_dict,
        "best_model_state_dict": best_model_state_dict,
        "optimiser_state_dict": optimiser_state_dict,
    }, path)


# --------------------------------------------------------------------------
# The JAX package's training checkpoint
# --------------------------------------------------------------------------

class ScaleByAdamState(NamedTuple):
    """Stand-in for optax._src.transform.ScaleByAdamState."""
    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """Stand-in for optax._src.base.EmptyState."""


_OPTAX_NAMES = {ScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
                EmptyState: ("optax._src.base", "EmptyState")}


def _admitted_globals():
    """(module, name) -> object for what a JAX training checkpoint may
    name: optax's two state classes (as the stand-ins) and numpy's array
    and scalar reconstruction, under numpy 2's module names and numpy 1's."""
    core = getattr(np, "_core", None) or np.core
    admitted = {names: cls for cls, names in _OPTAX_NAMES.items()}
    admitted[("numpy", "ndarray")] = np.ndarray
    admitted[("numpy", "dtype")] = np.dtype
    for prefix in ("numpy._core", "numpy.core"):
        admitted[(f"{prefix}.numeric", "_frombuffer")] = core.numeric._frombuffer
        admitted[(f"{prefix}.multiarray", "_reconstruct")] = core.multiarray._reconstruct
        admitted[(f"{prefix}.multiarray", "scalar")] = core.multiarray.scalar
    return admitted


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def __init__(self, file):
        super().__init__(file)
        self.admitted = _admitted_globals()

    def find_class(self, module, name):
        obj = self.admitted.get((module, name))
        if obj is None:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not admitted in a JAX training checkpoint")
        return obj


class _OptaxNamePickler(pickle._Pickler):
    """The pure-Python pickler, writing the stand-ins under optax's names
    (the C pickler would import optax to check them)."""

    def save_global(self, obj, name=None):
        names = _OPTAX_NAMES.get(obj)
        if names is None:
            return super().save_global(obj, name)
        self.save(names[0])
        self.save(names[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def load_jax_training_checkpoint(path):
    """The JAX package's training checkpoint dict: flax trees of numpy
    arrays, and optimiser_state_dict = (ScaleByAdamState, EmptyState) of
    the stand-ins."""
    with open(path, "rb") as f:
        return _JaxCheckpointUnpickler(f).load()


def save_jax_training_checkpoint(path, *, epoch, best_epoch,
                                 best_epoch_val_metrics, model_variables,
                                 best_model_variables, opt_state):
    """The JAX package's save_training_checkpoint: a pickle (the highest
    protocol) of its dict, with flax trees of numpy arrays and opt_state =
    (ScaleByAdamState(count, mu, nu), EmptyState()). The port's trainer
    writes the reference's layout (save_training_checkpoint); this writer
    serves chip_smoke.py's JAX-layout resume and the tests, which hand its
    files to the JAX package."""
    ckpt = {"epoch": epoch, "best_epoch": best_epoch,
            "best_epoch_val_metrics": best_epoch_val_metrics,
            "model_state_dict": model_variables,
            "best_model_state_dict": best_model_variables,
            "optimiser_state_dict": opt_state}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        _OptaxNamePickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(ckpt)


def load_training_checkpoint(path):
    """A training checkpoint's dict in either layout: the reference's (a
    torch file, its tensors on the CPU) or the JAX package's (a pickle; see
    models/weights.py::to_reference_layout)."""
    fmt = checkpoint_format(path)
    if fmt == "torch":
        return load_checkpoint(path)
    if fmt == "pickle":
        return load_jax_training_checkpoint(path)
    raise ValueError(f"{path}: flax variables, not a training checkpoint")


def load_training_info_from_checkpoint(checkpoint, save_val_metrics):
    """Resume bookkeeping: start epoch, best epoch, best model weights and
    best metric values, a save metric the checkpoint lacks reset to inf."""
    current_epoch = checkpoint["epoch"] + 1
    best_epoch = checkpoint["best_epoch"]
    best_model_wts = checkpoint["best_model_state_dict"]
    best_epoch_val_metrics = {}
    for metric in save_val_metrics:
        if metric in checkpoint["best_epoch_val_metrics"]:
            best_epoch_val_metrics[metric] = checkpoint["best_epoch_val_metrics"][metric]
        else:
            print(f"{metric} not in best_epoch_val_metrics — resetting to inf.")
            best_epoch_val_metrics[metric] = float("inf")
    return current_epoch, best_epoch, best_model_wts, best_epoch_val_metrics
