"""Prediction CLI of the port: the flags of run_predict.py.

python run_predict_torch.py --image_dir demo/ --save_dir out/ --cropped_images
python run_predict_torch.py --image_dir photos/ --save_dir out/ --batch_size 8 --no_vis

Counterpart of hierarchicalprobabilistic3dhuman_tpu/cli/predict.py
(run_predict :53, build_parser :248): one folder predict at any batch
size, on cropped photos or on uncropped ones through the HRNet
keypoint-bootstrap detector, with the uncrop and samples figures and a
bfloat16 HRNet, plus --device (default cuda; a run that asks for cuda and
finds none fails), the figure size and the sample count. --pose_shape_weights and
--pose2D_hrnet_weights take a reference checkpoint (a torch file) or the
JAX package's flax variables file, told apart by the content; without one
the network is randomly initialised from seed 0. --svd_impl auto takes the
LAPACK-sign SVD exactly when a reference predictor checkpoint is given
(the JAX package's cli/evaluate.py:81-83). MODEL.NUM_RESNET_LAYERS of
--pose_shape_cfg picks ResNet-18 or ResNet-50, MODEL.ENCODER vit_h
ViT-H/16. --num_devices N
(default: every visible card; 1 keeps the single-device path) starts N
ranks on one "sample" axis: the uncertainty samples split over them and
rank 0 writes (JAX's :194-202; parallel/launch.py); more devices than
torch sees raise. Without the licensed SMPL files the synthetic SMPL model
is used.
"""

import argparse

import torch


def resolve_svd_impl(svd_impl, pose_shape_weights):
    """--svd_impl auto: the LAPACK-sign SVD for a reference checkpoint
    (trained on torch.svd's signs), else (random weights, or the JAX
    package's flax variables, trained on the Jacobi SVD's) the Jacobi
    SVD."""
    from hierarchicalprobabilistic3dhuman_torch.runtime.checkpointing import (
        checkpoint_format)
    if svd_impl != "auto":
        return svd_impl
    return ("lapack" if pose_shape_weights
            and checkpoint_format(pose_shape_weights) == "torch" else "jacobi")


def load_or_init(module, path, load_state_dict, generator, flag):
    """The module with the checkpoint's weights, or drawn from `generator`
    (with a warning) when no checkpoint was given. The draw is made either
    way, so one network's checkpoint leaves the other's random weights as
    they were."""
    from hierarchicalprobabilistic3dhuman_torch.models.weights import init_weights
    init_weights(module, generator)
    if path is None:
        print(f"WARNING: no --{flag} given; using random init.")
    else:
        module.load_state_dict(load_state_dict(path, module), strict=True)
        print(f"Loaded --{flag} from {path}")
    return module


def _make_detector(args, hrnet, hrnet_cfg, device):
    """The person detector for uncropped photos, or None (cropped photos,
    or --detector none: whole-image boxes)."""
    from hierarchicalprobabilistic3dhuman_torch.predict.keypoint_detector import (
        make_keypoint_bootstrap_detector, make_multi_person_bootstrap_detector)
    if args.cropped_images or args.detector == "none":
        return None
    if args.detector == "maskrcnn":
        raise RuntimeError(
            "--detector maskrcnn: torchvision's Mask-RCNN and its weights are "
            "not part of the PyTorch port; use --detector keypoint (or "
            "keypoint-multi, auto, none)")
    if args.detector == "auto":
        print("NOTE: torchvision Mask-RCNN unavailable (not part of the "
              "PyTorch port); using the torch-free HRNet keypoint-bootstrap "
              "detector.")
    if args.detector == "keypoint-multi":
        # N-person boxes; the driver still selects the centre-most.
        return make_multi_person_bootstrap_detector(hrnet, hrnet_cfg, device)
    return make_keypoint_bootstrap_detector(hrnet, hrnet_cfg, device)


def build_predictor(args, mesh=None):
    """Models, config and options of the predict, from the flags (on a
    mesh, on this rank's device).

    :return: keyword arguments of predict_folder_batched
    """
    from hierarchicalprobabilistic3dhuman_torch.configs import (
        get_pose2d_hrnet_cfg_defaults, get_pose_shape_cfg_defaults)
    from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
        CannyEdgeDetector)
    from hierarchicalprobabilistic3dhuman_torch.models.hrnet import (
        PoseHighResolutionNet)
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    from hierarchicalprobabilistic3dhuman_torch.models.weights import (
        load_hrnet_state_dict, load_predictor_state_dict)
    from hierarchicalprobabilistic3dhuman_torch.utils.device import (
        resolve_device, set_full_f32)
    from hierarchicalprobabilistic3dhuman_torch.utils.precision import bf16_apply

    device = resolve_device(args.device) if mesh is None else mesh.device
    set_full_f32(device)

    pose_shape_cfg = get_pose_shape_cfg_defaults()
    if args.pose_shape_cfg is not None:
        pose_shape_cfg.merge_from_file(args.pose_shape_cfg)
        print(f"\nLoaded Distribution Predictor config from {args.pose_shape_cfg}")
    hrnet_cfg = get_pose2d_hrnet_cfg_defaults()

    generator = torch.Generator().manual_seed(0)
    hrnet = load_or_init(
        PoseHighResolutionNet(num_joints=hrnet_cfg.MODEL.NUM_JOINTS),
        args.pose2D_hrnet_weights, load_hrnet_state_dict, generator,
        "pose2D_hrnet_weights")
    svd_impl = resolve_svd_impl(args.svd_impl, args.pose_shape_weights)
    print(f"3x3 SVD of the pose head: {svd_impl}")
    pose_shape_model = load_or_init(
        build_pose_shape_model(pose_shape_cfg, svd_impl),
        args.pose_shape_weights, load_predictor_state_dict, generator,
        "pose_shape_weights")
    hrnet = hrnet.to(device).eval()
    if args.bf16:
        # Parameters and activations in bfloat16, heatmaps back in float32.
        hrnet = bf16_apply(hrnet)
    pose_shape_model = pose_shape_model.to(device).eval()

    edge_detect_model = CannyEdgeDetector(
        device,
        non_max_suppression=pose_shape_cfg.DATA.EDGE_NMS,
        gaussian_filter_std=pose_shape_cfg.DATA.EDGE_GAUSSIAN_STD,
        gaussian_filter_size=pose_shape_cfg.DATA.EDGE_GAUSSIAN_SIZE,
        threshold=pose_shape_cfg.DATA.EDGE_THRESHOLD)
    num_betas = pose_shape_cfg.MODEL.NUM_SMPL_BETAS
    try:
        smpl_model = SMPL.from_files(device, gender=args.gender,
                                     num_betas=num_betas)
    except FileNotFoundError as e:
        print(f"WARNING: {e}\nFalling back to a synthetic SMPL model "
              f"(geometry will not be human).")
        smpl_model = SMPL.synthetic(device, num_betas=num_betas)

    return dict(
        pose_shape_model=pose_shape_model,
        pose_shape_cfg=pose_shape_cfg,
        smpl_model=smpl_model,
        hrnet=hrnet,
        hrnet_cfg=hrnet_cfg,
        edge_detect_model=edge_detect_model,
        image_dir=args.image_dir,
        save_dir=args.save_dir,
        device=device,
        object_detect_fn=_make_detector(args, hrnet, hrnet_cfg, device),
        joints2Dvisib_threshold=args.joints2Dvisib_threshold,
        visualise_wh=args.visualise_wh,
        visualise_uncropped=args.visualise_uncropped,
        num_uncertainty_samples=args.num_uncertainty_samples,
        mesh=mesh)


def build_pose_shape_model(pose_shape_cfg, svd_impl):
    """The distribution predictor the config describes: its encoder by
    MODEL.ENCODER ("resnet" where a tree lacks the key, as the reference's
    own trees do)."""
    from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
        PoseMFShapeGaussianNet)
    model_cfg = pose_shape_cfg.MODEL
    return PoseMFShapeGaussianNet(
        num_in_channels=model_cfg.NUM_IN_CHANNELS,
        num_resnet_layers=model_cfg.NUM_RESNET_LAYERS,
        embed_dim=model_cfg.EMBED_DIM,
        delta_i=model_cfg.DELTA_I,
        delta_i_weight=model_cfg.DELTA_I_WEIGHT,
        num_smpl_betas=model_cfg.NUM_SMPL_BETAS,
        svd_impl=svd_impl,
        encoder=model_cfg.get("ENCODER", "resnet"),
        proxy_size=pose_shape_cfg.DATA.PROXY_REP_SIZE)


def run_predict(args):
    """Predict on the devices the flags ask for, every one on the "sample"
    axis (parallel/launch.py)."""
    from hierarchicalprobabilistic3dhuman_torch.parallel.launch import (
        launch, world_size)
    from hierarchicalprobabilistic3dhuman_torch.utils.device import resolve_device
    n = world_size(args, resolve_device(args.device).type)
    return launch(_run_predict, args, sample_parallel=n)


def _run_predict(args, mesh):
    """The folder driver, at --batch_size, with or without figures."""
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        predict_folder_batched)
    return predict_folder_batched(batch_size=args.batch_size,
                                  save_vis=not args.no_vis,
                                  visualise_samples=args.visualise_samples,
                                  **build_predictor(args, mesh))


def build_parser():
    parser = argparse.ArgumentParser(
        prog="run_predict_torch.py",
        description="3D human shape/pose distribution prediction "
                    "(PyTorch/CUDA port; the flags of run_predict.py).")
    parser.add_argument("--image_dir", "-I", type=str, required=True,
                        help="Directory of images to run prediction on; "
                             "also pre-decoded uint8 HWC .npy files and "
                             ".npz packs (data/pack_predict_inputs.py).")
    parser.add_argument("--save_dir", "-S", type=str, required=True,
                        help="Directory to save predictions/visualisations.")
    parser.add_argument("--pose_shape_weights", "-W3D", type=str, default=None,
                        help="Reference predictor checkpoint (torch file) "
                             "or flax variables file; random weights "
                             "without one.")
    parser.add_argument("--pose_shape_cfg", type=str, default=None)
    parser.add_argument("--svd_impl", type=str, default="auto",
                        choices=["auto", "jacobi", "lapack", "lapack_callback"],
                        help="3x3 SVD of the pose head: 'jacobi', 'lapack' "
                             "(sgesdd's signs on the device) or "
                             "'lapack_callback' (numpy's sgesdd on the "
                             "host); 'auto' takes 'lapack' for a reference "
                             "checkpoint, else 'jacobi'.")
    parser.add_argument("--pose2D_hrnet_weights", "-W2D", type=str, default=None,
                        help="Reference HRNet-W48 checkpoint (torch file) "
                             "or flax variables file; random weights "
                             "without one.")
    parser.add_argument("--cropped_images", "-C", action="store_true",
                        help="Images are already cropped and centred.")
    parser.add_argument("--detector", type=str, default="auto",
                        choices=["auto", "maskrcnn", "keypoint",
                                 "keypoint-multi", "none"],
                        help="Person detector for uncropped inputs: the "
                             "HRNet keypoint bootstrap (single- or "
                             "multi-person), or none (whole-image boxes). "
                             "'auto' takes the keypoint bootstrap; "
                             "'maskrcnn' is refused (torchvision is not part "
                             "of the port).")
    parser.add_argument("--visualise_samples", "-VS", action="store_true")
    parser.add_argument("--visualise_uncropped", "-VU", action="store_true")
    parser.add_argument("--joints2Dvisib_threshold", "-T", type=float,
                        default=0.75)
    parser.add_argument("--gender", "-G", type=str, default="neutral",
                        choices=["neutral", "male", "female"])
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Devices for the sample-parallel uncertainty "
                             "pass (default: every visible card, one with "
                             "--device cpu; 1 keeps the single-device "
                             "path).")
    parser.add_argument("--num_workers", type=int, default=0,
                        help="Unused; kept for CLI parity.")
    parser.add_argument("--batch_size", "-B", type=int, default=1,
                        help="Images per batched HRNet + core call; the "
                             "folder is grouped by resolution and decoded "
                             "on a thread.")
    parser.add_argument("--no_vis", action="store_true",
                        help="No render or figure; save "
                             "pose/shape/cam/uncertainty to outputs.npz "
                             "(the serving path).")
    parser.add_argument("--bf16", action="store_true",
                        help="Run HRNet-W48 in bfloat16 (parameters and "
                             "activations; heatmaps in float32).")
    parser.add_argument("--visualise_wh", type=int, default=512,
                        help="Side of each rendered view in the figures.")
    parser.add_argument("--num_uncertainty_samples", type=int, default=50,
                        help="Pose samples behind the per-vertex uncertainty.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' (default) fails if there "
                             "is no card, 'cpu' runs the plain versions.")
    return parser


def main(argv=None):
    return run_predict(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
