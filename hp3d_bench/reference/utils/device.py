"""Device selection and float32 precision for the port's entry points."""

from contextlib import contextmanager

import torch


def resolve_device(device="cuda"):
    """Return `torch.device(device)`; raise if CUDA is asked for and absent.

    Entry points run on the card unless the caller asks for the CPU. There is
    no silent fall-back: a run that asked for `cuda` either gets it or fails.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but torch finds no "
                           "CUDA device; pass device='cpu' (--device cpu) to "
                           "run on the CPU")
    return device


def set_full_f32(device):
    """Run float32 matmuls and convolutions in full float32 on the card.

    cuDNN convolutions default to TF32 (about three decimal digits); the port
    holds its outputs to the JAX package's float32 numbers, so both switches
    are set explicitly. No effect on the CPU.
    """
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@contextmanager
def full_f32_matmul():
    """TF32 off for float32 matmuls inside the block (a no-op on the CPU)."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
