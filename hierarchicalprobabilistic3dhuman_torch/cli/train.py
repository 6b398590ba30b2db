"""Training CLI of the port: the flags of run_train.py.

python run_train_torch.py -E experiments/exp_001 [-O TRAIN.BATCH_SIZE 8 ...] [-R 20]
python run_train_torch.py -E <dir> --device cpu -O DATA.PROXY_REP_SIZE 32 TRAIN.BATCH_SIZE 2

Counterpart of hierarchicalprobabilistic3dhuman_tpu/cli/train.py
(resolve_encoder_precision :16, run_train :45, build_parser :224). The
experiment directory has the reference's layout:
    <experiment_dir>/saved_models/epoch_{N:03d}.tar
    <experiment_dir>/log.pkl
    <experiment_dir>/pose_shape_cfg.yaml
Without the training files (AMASS/H36M poses, textures, LSUN backgrounds)
the datasets fall back to OnTheFlySMPLTrainDataset.synthetic(), and without
the licensed SMPL files the model to SMPL.synthetic(), as in the JAX
package. MODEL.NUM_RESNET_LAYERS (-O) picks ResNet-18 or ResNet-50. The
checkpoints it writes are the reference's torch dicts; a port-trained
predictor was trained on the Jacobi SVD's signs, so evaluate it with
--svd_impl jacobi. -R N resumes from epoch_{N:03d}.tar in either layout,
told apart by the content: the reference's, or the JAX package's pickle
(flax trees and optax.adam's state, carried into torch.optim.Adam's), so
a JAX experiment directory (its pose_shape_cfg.yaml and
encoder_precision.txt too) resumes here. Added: --device (default cuda; a
run that asks for cuda and finds none fails). Not ported yet, and refused
when given: more than one device or process (--num_devices > 1,
--sample_parallel > 1, --coordinator_address, --num_processes,
--process_id), the native loader (--native_data_dir) and --profile_dir.
"""

import argparse
import os


def resolve_encoder_precision(experiment_dir, bf16_flag, resuming):
    """Persist/restore the encoder compute precision for an experiment.

    Encoder precision is experiment state, not a per-invocation flag: a
    resumed run keeps the mode it trained with. Stored as a sidecar file
    rather than a cfg key to keep the yacs tree the reference's.

    :returns: the effective bf16 flag (the saved mode wins on resume).
    """
    marker = os.path.join(experiment_dir, "encoder_precision.txt")
    if not resuming:
        with open(marker, "w") as f:
            f.write("bfloat16" if bf16_flag else "float32")
        return bf16_flag
    if os.path.exists(marker):
        with open(marker) as f:
            saved_mode = f.read().strip()
        resumed_bf16 = saved_mode == "bfloat16"
        if bf16_flag != resumed_bf16:
            print(f"WARNING: experiment was trained with encoder precision "
                  f"'{saved_mode}'; ignoring the command line and resuming "
                  f"in that mode.")
        return resumed_bf16
    return bf16_flag


def _refuse_unported(args):
    """Flags of run_train.py whose code is not ported yet raise rather than
    being ignored."""
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(
            f"--num_devices {args.num_devices}: the multi-device paths "
            "(parallel/mesh.py, parallel/sharded_train.py) are not ported "
            "yet; the port trains on one device")
    if args.sample_parallel > 1:
        raise NotImplementedError(
            f"--sample_parallel {args.sample_parallel}: sharding the samples "
            "across devices (parallel/sharded_train.py) is not ported yet")
    for flag in ("coordinator_address", "num_processes", "process_id"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag}: multi-process training (parallel/mesh.py's "
                "distributed_init) is not ported yet")
    if args.native_data_dir is not None:
        raise NotImplementedError(
            "--native_data_dir: the native loader (data/native_loader.py, "
            "native/batch_sampler.cpp) is not ported yet")
    if args.profile_dir is not None:
        raise NotImplementedError(
            "--profile_dir: profiling (runtime/profiling.py) is not ported yet")


def build_model_and_optimizer(pose_shape_cfg, device, rng_seed=0,
                              bf16_encoder=False, checkpoint=None):
    """The predictor the config describes, its weights drawn from
    `rng_seed`, and its Adam (optax.adam's defaults), on `device`; with a
    training checkpoint in either layout
    (runtime/checkpointing.py::load_training_checkpoint), both resumed
    from it.

    :return: model, optimizer, the checkpoint in the reference's layout
        (None without one)
    """
    import torch

    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_pose_shape_model)
    from hierarchicalprobabilistic3dhuman_torch.models.weights import (
        init_weights, to_reference_layout)
    model = build_pose_shape_model(pose_shape_cfg, "jacobi")
    init_weights(model, torch.Generator().manual_seed(rng_seed))
    model.encoder_bf16 = bf16_encoder
    model = model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=pose_shape_cfg.TRAIN.LR,
                                 betas=(0.9, 0.999), eps=1e-8)
    if checkpoint is not None:
        checkpoint = to_reference_layout(checkpoint, model, optimizer)
        model.load_state_dict(checkpoint["model_state_dict"])
        optimizer.load_state_dict(checkpoint["optimiser_state_dict"])
    return model, optimizer, checkpoint


def run_train(args):
    from hierarchicalprobabilistic3dhuman_torch.configs import (
        get_pose_shape_cfg_defaults, paths)
    from hierarchicalprobabilistic3dhuman_torch.data.on_the_fly_smpl_train_dataset import (
        OnTheFlySMPLTrainDataset)
    from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
        CannyEdgeDetector)
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    from hierarchicalprobabilistic3dhuman_torch.renderers.textured_iuv_renderer import (
        TexturedIUVRenderer)
    from hierarchicalprobabilistic3dhuman_torch.runtime.checkpointing import (
        checkpoint_path, load_training_checkpoint)
    from hierarchicalprobabilistic3dhuman_torch.train.train_pose_mf_shape_gaussian_net import (
        train_pose_mf_shape_gaussian_net)
    from hierarchicalprobabilistic3dhuman_torch.utils.device import (
        resolve_device, set_full_f32)

    _refuse_unported(args)
    device = resolve_device(args.device)
    set_full_f32(device)

    # Experiment directory layout (reference run_train.py:28-33)
    experiment_dir = args.experiment_dir
    model_save_dir = os.path.join(experiment_dir, "saved_models")
    logs_save_path = os.path.join(experiment_dir, "log.pkl")
    cfg_save_path = os.path.join(experiment_dir, "pose_shape_cfg.yaml")
    os.makedirs(model_save_dir, exist_ok=True)

    pose_shape_cfg = get_pose_shape_cfg_defaults()
    checkpoint = None
    if args.resume_from_epoch is not None:
        # Resume: the saved config and checkpoint (reference :45-50)
        pose_shape_cfg.merge_from_file(cfg_save_path)
        args.bf16_encoder = resolve_encoder_precision(
            experiment_dir, args.bf16_encoder, resuming=True)
        ckpt_path = checkpoint_path(model_save_dir, args.resume_from_epoch)
        print(f"\nResuming from {ckpt_path}")
        checkpoint = load_training_checkpoint(ckpt_path)
    else:
        if args.pose_shape_cfg_opts is not None:
            pose_shape_cfg.merge_from_list(args.pose_shape_cfg_opts)
        with open(cfg_save_path, "w") as f:
            f.write(pose_shape_cfg.dump())
        resolve_encoder_precision(experiment_dir, args.bf16_encoder,
                                  resuming=False)
        print(f"\nSaved config to {cfg_save_path}")

    # Datasets (reference :54-69); the synthetic fallback without the files.
    D = pose_shape_cfg.DATA.PROXY_REP_SIZE
    try:
        train_dataset = OnTheFlySMPLTrainDataset(
            poses_path=paths.TRAIN_POSES_PATH,
            textures_path=paths.TRAIN_TEXTURES_PATH,
            backgrounds_dir_path=paths.TRAIN_BACKGROUNDS_PATH,
            params_from="not_amass", img_wh=D)
        val_dataset = OnTheFlySMPLTrainDataset(
            poses_path=paths.VAL_POSES_PATH,
            textures_path=paths.VAL_TEXTURES_PATH,
            backgrounds_dir_path=paths.VAL_BACKGROUNDS_PATH,
            params_from="all", img_wh=D)
    except (FileNotFoundError, OSError) as e:
        print(f"WARNING: training data files unavailable ({e}); "
              f"using synthetic fallback data.")
        train_dataset = OnTheFlySMPLTrainDataset.synthetic(
            n=max(pose_shape_cfg.TRAIN.BATCH_SIZE * 4, 64), img_wh=D)
        val_dataset = OnTheFlySMPLTrainDataset.synthetic(
            n=max(pose_shape_cfg.TRAIN.BATCH_SIZE * 2, 32), img_wh=D, seed=1)
    print("Training poses:", len(train_dataset))
    print("Validation poses:", len(val_dataset))

    # Models (reference :72-92)
    edge_detect_model = CannyEdgeDetector(
        device,
        non_max_suppression=pose_shape_cfg.DATA.EDGE_NMS,
        gaussian_filter_std=pose_shape_cfg.DATA.EDGE_GAUSSIAN_STD,
        gaussian_filter_size=pose_shape_cfg.DATA.EDGE_GAUSSIAN_SIZE,
        threshold=pose_shape_cfg.DATA.EDGE_THRESHOLD)
    num_betas = pose_shape_cfg.MODEL.NUM_SMPL_BETAS
    try:
        smpl_model = SMPL.from_files(device, gender="neutral", num_betas=num_betas)
    except FileNotFoundError:
        print("WARNING: SMPL model files missing; using synthetic SMPL.")
        smpl_model = SMPL.synthetic(device, num_betas=num_betas)
    renderer = TexturedIUVRenderer(
        device, img_wh=D, render_rgb=True, projection_type="perspective",
        perspective_focal_length=pose_shape_cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH)

    pose_shape_model, optimizer, checkpoint = build_model_and_optimizer(
        pose_shape_cfg, device, args.rng_seed, args.bf16_encoder, checkpoint)

    # Metric list (reference :115)
    metrics = ['PVE', 'PVE-SC', 'PVE-T-SC', 'MPJPE', 'MPJPE-SC', 'MPJPE-PA',
               'joints2D-L2E']

    return train_pose_mf_shape_gaussian_net(
        pose_shape_model=pose_shape_model,
        pose_shape_cfg=pose_shape_cfg,
        smpl_model=smpl_model,
        edge_detect_model=edge_detect_model,
        renderer=renderer,
        train_dataset=train_dataset,
        val_dataset=val_dataset,
        optimizer=optimizer,
        metrics=metrics,
        model_save_dir=model_save_dir,
        logs_save_path=logs_save_path,
        device=device,
        checkpoint=checkpoint,
        rng_seed=args.rng_seed,
        num_epochs=args.num_epochs)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="run_train_torch.py",
        description="Synthetic-data distribution-predictor training with the "
                    "PyTorch/CUDA port (reference run_train.py flags).")
    parser.add_argument("--experiment_dir", "-E", type=str, required=True)
    parser.add_argument("--pose_shape_cfg_opts", "-O", nargs="*", default=None,
                        help="Config option overrides: KEY VALUE pairs.")
    parser.add_argument("--resume_from_epoch", "-R", type=int, default=None)
    parser.add_argument("--rng_seed", type=int, default=0)
    parser.add_argument("--num_epochs", type=int, default=None,
                        help="Override TRAIN.NUM_EPOCHS (e.g. for smoke runs).")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Only 1 is ported (more raise).")
    parser.add_argument("--sample_parallel", type=int, default=1,
                        help="Only 1 is ported (more raise).")
    parser.add_argument("--native_data_dir", type=str, default=None,
                        help="The native loader is not ported (raises).")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="Multi-process training is not ported (raises).")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--bf16_encoder", action="store_true",
                        help="Run the ResNet encoder under bfloat16 autocast "
                             "(parameters, BatchNorm and head stay float32; "
                             "checkpoints unchanged).")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Profiling is not ported (raises).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; fails without a card) or cpu.")
    return parser


def main(argv=None):
    return run_train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
