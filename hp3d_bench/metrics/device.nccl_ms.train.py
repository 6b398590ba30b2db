"""device.nccl_ms.train: Device time a profiled train step of the kernels whose
names begin with `nccl` (NCCL's collectives: DDP's gradient all-reduce, the
synced BatchNorms' moments, the loss and sums), on rank 0's card."""

NAME = "device.nccl_ms.train"
UNIT = "ms"
LAYER = "collectives"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(layer):
    prof = layer.get("profile")
    if not prof or not prof["ops"]:
        return None
    ns = sum(dur for name, _, dur in prof["ops"] if name.startswith("nccl"))
    if ns == 0:
        return None
    return ns / 1e6 / layer["profile_calls"]
