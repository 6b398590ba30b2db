"""Training CLI of the port: the flags of run_train.py.

python run_train_torch.py -E experiments/exp_001 [-O TRAIN.BATCH_SIZE 8 ...] [-R 20]
python run_train_torch.py -E <dir> --device cpu -O DATA.PROXY_REP_SIZE 32 TRAIN.BATCH_SIZE 2
python run_train_torch.py -E <dir> --native_data_dir train_files/native [--profile_dir <dir>]

Counterpart of hierarchicalprobabilistic3dhuman_tpu/cli/train.py
(resolve_encoder_precision :16, run_train :45, build_parser :224). The
experiment directory has the reference's layout:
    <experiment_dir>/saved_models/epoch_{N:03d}.tar
    <experiment_dir>/log.pkl
    <experiment_dir>/pose_shape_cfg.yaml
Without the training files (AMASS/H36M poses, textures, LSUN backgrounds)
the datasets fall back to OnTheFlySMPLTrainDataset.synthetic(), and without
the licensed SMPL files the model to SMPL.synthetic(), as in the JAX
package. --native_data_dir DIR trains from stores packed by
data/pack_training_stores.py (DIR/train and DIR/val where they exist,
else DIR for both), read by the C++ sampler of data/native_loader.py (the
stores' record counts may differ; an epoch is the poses store's count over
the batch size); no dataset is built then. --profile_dir DIR writes a
torch.profiler Chrome trace of the run to DIR/trace.json.
MODEL.NUM_RESNET_LAYERS (-O) picks ResNet-18 or ResNet-50. The
checkpoints it writes are the reference's torch dicts; a port-trained
predictor was trained on the Jacobi SVD's signs, so evaluate it with
--svd_impl jacobi. -R N resumes from epoch_{N:03d}.tar in either layout,
told apart by the content: the reference's, or the JAX package's pickle
(flax trees and optax.adam's state, carried into torch.optim.Adam's), so
a JAX experiment directory (its pose_shape_cfg.yaml and
encoder_precision.txt too) resumes here. Added: --device (default cuda; a
run that asks for cuda and finds none fails).

Several devices (parallel/launch.py): --num_devices N (default: every
visible card; 1 keeps the plain single-device path) starts N ranks,
--sample_parallel S splits them into a (N / S) x S ("data", "sample")
mesh, and --coordinator_address host:port --num_processes P --process_id
p join P such processes into one world; the global batch
(TRAIN.BATCH_SIZE) must divide the data axis. Ranks run NCCL on the card
and gloo with --device cpu (several ranks on the CPU). Each rank resumes
-R on its own; rank 0 writes the experiment directory.
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


def native_loaders(native_data_dir, batch_size, rng_seed, n_threads=2):
    """NativeTrainLoaders of the train and val stores under
    `native_data_dir` (its train/ and val/ where they exist, else the
    directory itself for both), seeded rng_seed and rng_seed + 1 (JAX's
    cli/train.py:184-202). Batches come in one order only from one
    thread: the ranks of a mesh, which must all see the same batches,
    take n_threads=1."""
    from hierarchicalprobabilistic3dhuman_torch.data.native_loader import (
        NativeTrainLoader)

    def store_dir(split):
        sub = os.path.join(native_data_dir, split)
        return sub if os.path.isdir(sub) else native_data_dir

    train = NativeTrainLoader(store_dir("train"), batch_size, n_threads=n_threads,
                              seed=rng_seed)
    try:
        val = NativeTrainLoader(store_dir("val"), batch_size, n_threads=n_threads,
                                seed=rng_seed + 1)
    except BaseException:
        train.close()
        raise
    return {"train": train, "val": val}


def run_train(args):
    """Train on the devices the flags ask for (parallel/launch.py)."""
    from hierarchicalprobabilistic3dhuman_torch.parallel.launch import launch
    from hierarchicalprobabilistic3dhuman_torch.utils.device import resolve_device
    resolve_device(args.device)
    return launch(_run_train, args, sample_parallel=args.sample_parallel)


def _run_train(args, mesh):
    """The run of one rank (mesh: a parallel Mesh, or None)."""
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

    device = resolve_device(args.device) if mesh is None else mesh.device
    set_full_f32(device)
    main = mesh is None or mesh.is_main

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
        if main:
            with open(cfg_save_path, "w") as f:
                f.write(pose_shape_cfg.dump())
            resolve_encoder_precision(experiment_dir, args.bf16_encoder,
                                      resuming=False)
            print(f"\nSaved config to {cfg_save_path}")
    if mesh is not None:
        n_data = mesh.shape["data"]
        if pose_shape_cfg.TRAIN.BATCH_SIZE % n_data:
            raise ValueError(
                f"TRAIN.BATCH_SIZE={pose_shape_cfg.TRAIN.BATCH_SIZE} must "
                f"divide the mesh data axis ({n_data})")
        print(f"Training on mesh {mesh.shape} ({mesh.size} ranks)")

    D = pose_shape_cfg.DATA.PROXY_REP_SIZE
    train_dataset = val_dataset = None
    if args.native_data_dir is None:
        # Datasets (reference :54-69); the synthetic fallback without the
        # files.
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

    loaders = None
    if args.native_data_dir is not None:
        # The native C++ input pipeline: batches assembled by mmap+memcpy
        # on C++ threads from packed stores, uint8 textures and backgrounds
        # end to end (normalised on the device).
        loaders = native_loaders(args.native_data_dir,
                                 pose_shape_cfg.TRAIN.BATCH_SIZE, args.rng_seed,
                                 n_threads=2 if mesh is None else 1)
        print(f"Native input pipeline: {args.native_data_dir} "
              f"({loaders['train'].steps_per_epoch} train steps/epoch)")
    try:
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
            num_epochs=args.num_epochs,
            loaders=loaders,
            mesh=mesh)
    finally:
        for loader in (loaders or {}).values():
            loader.close()


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
                        help="Devices to train on (default: every visible "
                             "card, one with --device cpu; 1 keeps the "
                             "single-device path). More than torch sees "
                             "raise.")
    parser.add_argument("--sample_parallel", type=int, default=1,
                        help="Size of the mesh 'sample' axis (stage 2's "
                             "distribution samples split across it).")
    parser.add_argument("--native_data_dir", type=str, default=None,
                        help="Directory of packed .bin stores (see "
                             "data/pack_training_stores.py); enables the "
                             "C++ batch-assembly input pipeline.")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of rank 0's process group "
                             "(several processes, one or more hosts).")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Processes of the run, each with "
                             "--num_devices ranks.")
    parser.add_argument("--process_id", type=int, default=None,
                        help="This process's index among them.")
    parser.add_argument("--bf16_encoder", action="store_true",
                        help="Run the ResNet encoder under bfloat16 autocast "
                             "(parameters, BatchNorm and head stay float32; "
                             "checkpoints unchanged).")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Write a torch.profiler Chrome trace of "
                             "training to DIR/trace.json (every event is "
                             "held until the run ends: keep such runs "
                             "short).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; fails without a card) or cpu.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import trace
    with trace(args.profile_dir, args.device):
        return run_train(args)


if __name__ == "__main__":
    main()
