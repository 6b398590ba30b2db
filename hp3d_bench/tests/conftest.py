"""The benchmark's tests: the repository root on the path, and cells cut
to a size the CPU runs in seconds (`tiny`)."""

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny(cell):
    """The cell's files at a CPU size: proxy 32^2, batch 4 (train,
    evaluate) or 2 (predict), 2 loss and evaluation samples, EMBED_DIM 64,
    HRNet at 96 x 128, 4 uncertainty samples, 64^2 photos and frames, small
    stores, 16 SSP-3D frames."""
    from hp3d_bench import harness
    workload, config, traffic = (copy.deepcopy(x) for x in harness.cell_files(cell))
    cfg = config["pose_shape_cfg"]
    cfg["DATA"]["PROXY_REP_SIZE"] = 32
    cfg["TRAIN"]["BATCH_SIZE"] = 4
    cfg["LOSS"]["NUM_SAMPLES"] = 2
    cfg["MODEL"]["EMBED_DIM"] = 64
    cfg["TRAIN"]["SYNTH_DATA"]["FOCAL_LENGTH"] = 300.0 * 32 / 256
    config["hrnet_cfg"]["MODEL"]["IMAGE_SIZE"] = [96, 128]
    config["hrnet_cfg"]["MODEL"]["HEATMAP_SIZE"] = [24, 32]
    config["num_uncertainty_samples"] = 4
    params = traffic["params"]
    if traffic["path"] == "train":
        params.update(batch=4, poses=512, textures=16, backgrounds=16)
    elif traffic["path"] == "evaluate":
        params.update(frames=16, frame_wh=64, batch=4, num_samples=2,
                      check_batches=2)
    else:
        params.update(batch=2, photo_wh=64, stacks=3, check_batches=3)
    return workload, config, traffic
