"""Evaluation CLI of the port: the flags of run_evaluate.py.

python run_evaluate_torch.py --dataset ssp3d [--pose_shape_weights X.tar] [--batch_size 8]
python run_evaluate_torch.py --dataset 3dpw --dataset_path datasets/3DPW/test -N 10

Counterpart of hierarchicalprobabilistic3dhuman_tpu/cli/evaluate.py
(run_evaluate :13, build_parser :148): the dataset and metric selection of
the reference's run_evaluate.py:56-70, SMPL for the three genders from the
licensed files or synthetic, the distribution predictor (ResNet-18 or
ResNet-50, MODEL.NUM_RESNET_LAYERS; ViT-H/16, MODEL.ENCODER vit_h) from
a reference checkpoint, the JAX package's flax variables file (told apart
by the content; none holds a ViT) or random weights, and --svd_impl auto
taking the LAPACK-sign SVD exactly for a reference checkpoint. Added: --device (default cuda; a run that asks for
cuda and finds none fails). `lapack_callback` is numpy's sgesdd on a host
copy on every device: it is never swapped for `lapack`. --profile_dir DIR
writes one torch.profiler Chrome trace of the evaluation to DIR/trace.json:
the card's kernels, copies and memsets (the CPU's operators with --device
cpu) and the program's spans (eval.step with pose_head; host_syncs counts)
on one timeline.

Several devices (parallel/launch.py): --num_devices N (default: every
visible card; 1 keeps the plain single-device path) starts N ranks and
--sample_parallel S splits them into a (N / S) x S ("data", "sample")
mesh: the dataset batch shards over "data", the samples over "sample".
A --batch_size that does not divide the data axis raises (JAX's CLI
quietly evaluates on one device then), as do more devices than torch
sees. Ranks run NCCL on the card and gloo with --device cpu.
"""

import argparse
import os


def select_dataset(args, pose_shape_cfg):
    """The dataset and its metrics (reference run_evaluate.py:56-70)."""
    from hierarchicalprobabilistic3dhuman_torch.configs import paths
    from hierarchicalprobabilistic3dhuman_torch.data.pw3d_eval_dataset import (
        PW3DEvalDataset)
    from hierarchicalprobabilistic3dhuman_torch.data.ssp3d_eval_dataset import (
        SSP3DEvalDataset)
    if args.dataset == "3dpw":
        metrics = ['PVE', 'PVE-SC', 'PVE-PA', 'PVE-T-SC', 'MPJPE', 'MPJPE-SC',
                   'MPJPE-PA', 'joints2D-L2E']
        metrics.extend([metric + '_samples_min' for metric in metrics
                        if metric != 'joints2D-L2E'])
        dataset = PW3DEvalDataset(args.dataset_path or paths.PW3D_PATH,
                                  pose_shape_cfg, visible_joints_threshold=0.6)
    elif args.dataset == "ssp3d":
        metrics = ['PVE-PA', 'PVE-T-SC', 'silhouette-IOU', 'joints2D-L2E',
                   'joints2Dsamples-L2E', 'silhouettesamples-IOU']
        dataset = SSP3DEvalDataset(args.dataset_path or paths.SSP3D_PATH,
                                   pose_shape_cfg, visible_joints_threshold=0.6)
    else:
        raise ValueError(f"Unknown dataset {args.dataset}")
    return dataset, metrics


def build_evaluator(args, mesh=None):
    """Models, config, dataset and options of the evaluation, from the flags
    (on a mesh, this rank's: its device, and rank 0 alone makes the save
    directory).

    :return: keyword arguments for evaluate_pose_mf_shape_gaussian_net
    """
    import torch

    from hierarchicalprobabilistic3dhuman_torch.cli.predict import (
        build_pose_shape_model, load_or_init, resolve_svd_impl)
    from hierarchicalprobabilistic3dhuman_torch.configs import (
        get_pose_shape_cfg_defaults)
    from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
        CannyEdgeDetector)
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    from hierarchicalprobabilistic3dhuman_torch.models.weights import (
        load_predictor_state_dict)
    from hierarchicalprobabilistic3dhuman_torch.utils.device import (
        resolve_device, set_full_f32)

    device = resolve_device(args.device) if mesh is None else mesh.device
    set_full_f32(device)

    pose_shape_cfg = get_pose_shape_cfg_defaults()
    if args.pose_shape_cfg is not None:
        pose_shape_cfg.merge_from_file(args.pose_shape_cfg)
    eval_dataset, metrics = select_dataset(args, pose_shape_cfg)
    print(f"\nEvaluating on {args.dataset} with {len(eval_dataset)} examples.")

    edge_detect_model = CannyEdgeDetector(
        device,
        non_max_suppression=pose_shape_cfg.DATA.EDGE_NMS,
        gaussian_filter_std=pose_shape_cfg.DATA.EDGE_GAUSSIAN_STD,
        gaussian_filter_size=pose_shape_cfg.DATA.EDGE_GAUSSIAN_SIZE,
        threshold=pose_shape_cfg.DATA.EDGE_THRESHOLD)
    num_betas = pose_shape_cfg.MODEL.NUM_SMPL_BETAS

    def load_smpl(gender):
        try:
            return SMPL.from_files(device, gender=gender, num_betas=num_betas)
        except FileNotFoundError:
            print(f"WARNING: SMPL {gender} model files missing; using synthetic.")
            return SMPL.synthetic(device, num_betas=num_betas)

    svd_impl = resolve_svd_impl(args.svd_impl, args.pose_shape_weights)
    print(f"3x3 SVD of the pose head: {svd_impl}")
    pose_shape_model = load_or_init(
        build_pose_shape_model(pose_shape_cfg, svd_impl),
        args.pose_shape_weights, load_predictor_state_dict,
        torch.Generator().manual_seed(0), "pose_shape_weights")

    save_path = args.save_path or os.path.join("./evaluations", args.dataset)
    if mesh is None or mesh.is_main:
        os.makedirs(save_path, exist_ok=True)
    return dict(
        pose_shape_model=pose_shape_model.to(device).eval(),
        pose_shape_cfg=pose_shape_cfg,
        smpl_neutral=load_smpl("neutral"),
        smpl_male=load_smpl("male"),
        smpl_female=load_smpl("female"),
        edge_detect_model=edge_detect_model,
        metrics=metrics,
        eval_dataset=eval_dataset,
        device=device,
        batch_size=args.batch_size,
        num_workers=args.num_workers,
        num_samples_for_metrics=args.num_samples,
        save_path=save_path,
        save_per_frame_metrics=True,
        mesh=mesh)


def run_evaluate(args):
    """Evaluate on the devices the flags ask for (parallel/launch.py);
    returns the final metrics."""
    from hierarchicalprobabilistic3dhuman_torch.parallel.launch import (
        is_parallel, launch, world_size)
    from hierarchicalprobabilistic3dhuman_torch.utils.device import resolve_device
    device_type = resolve_device(args.device).type
    if is_parallel(args, device_type):
        n_data = world_size(args, device_type) // args.sample_parallel
        if args.batch_size % n_data:
            raise ValueError(
                f"batch_size={args.batch_size} must divide the mesh data axis "
                f"({n_data}) for dataset-sharded eval")
    return launch(_run_evaluate, args, sample_parallel=args.sample_parallel)


def _run_evaluate(args, mesh):
    from hierarchicalprobabilistic3dhuman_torch.evaluate.evaluate_pose_mf_shape_gaussian_net import (
        evaluate_pose_mf_shape_gaussian_net)
    return evaluate_pose_mf_shape_gaussian_net(**build_evaluator(args, mesh))


def build_parser():
    parser = argparse.ArgumentParser(
        prog="run_evaluate_torch.py",
        description="3DPW / SSP-3D benchmark evaluation (PyTorch/CUDA port; "
                    "the flags of run_evaluate.py).")
    parser.add_argument("--dataset", "-D", type=str, required=True,
                        choices=["3dpw", "ssp3d"])
    parser.add_argument("--dataset_path", type=str, default=None,
                        help="Override configs.paths dataset location.")
    parser.add_argument("--pose_shape_weights", "-W3D", type=str, default=None,
                        help="Reference predictor checkpoint (torch file) "
                             "or flax variables file; random weights "
                             "without one.")
    parser.add_argument("--pose_shape_cfg", type=str, default=None)
    parser.add_argument("--svd_impl", type=str, default="auto",
                        choices=["auto", "jacobi", "lapack",
                                 "lapack_callback"],
                        help="3x3 SVD of the pose head: 'jacobi', 'lapack' "
                             "(sgesdd's signs on the device) or "
                             "'lapack_callback' (numpy's sgesdd on the "
                             "host); 'auto' takes 'lapack' for a reference "
                             "checkpoint, else 'jacobi'.")
    parser.add_argument("--save_path", type=str, default=None)
    parser.add_argument("--num_samples", "-N", type=int, default=10,
                        help="Number of samples for sample-based metrics.")
    parser.add_argument("--batch_size", "-B", type=int, default=1,
                        help="Eval batch size (the reference is locked to 1; "
                             "larger is supported and faster).")
    parser.add_argument("--num_workers", type=int, default=2,
                        help="Loader threads (0 loads in the main thread).")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Devices for dataset-sharded eval (default: "
                             "every visible card, one with --device cpu; 1 "
                             "keeps the single-device path).")
    parser.add_argument("--sample_parallel", type=int, default=1,
                        help="Size of the mesh 'sample' axis (distribution "
                             "samples shard across it).")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Write one torch.profiler Chrome trace of "
                             "evaluation to DIR/trace.json: the card's "
                             "activity (the CPU's operators with --device "
                             "cpu) and the program's spans on one "
                             "timeline.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' (default) fails if there "
                             "is no card, 'cpu' runs the plain versions.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import trace
    with trace(args.profile_dir, args.device):
        return run_evaluate(args)


if __name__ == "__main__":
    main()
