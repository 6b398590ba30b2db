"""Prediction CLI of the port: the flags of run_predict.py.

python run_predict_torch.py --image_dir demo/ --save_dir out/ --cropped_images
python run_predict_torch.py --image_dir photos/ --save_dir out/ --batch_size 8 --no_vis

Counterpart of hierarchicalprobabilistic3dhuman_tpu/cli/predict.py
(run_predict :53, build_parser :248): per-image or batched predict, on
cropped photos or on uncropped ones through the HRNet keypoint-bootstrap
detector, with the uncrop and samples figures and a bfloat16 HRNet, plus
--device (default cuda; a run that asks for cuda and finds none fails), the
figure size and the sample count. Not ported yet, and refused when given:
checkpoint loading (--pose_shape_weights, --pose2D_hrnet_weights), the
LAPACK-sign SVD (--svd_impl lapack, lapack_callback) and more than one
device (--num_devices > 1). The networks are randomly initialised from
seed 0; without the licensed SMPL files the synthetic SMPL model is used.
"""

import argparse

import torch


def _refuse_unported(args):
    """Flags of run_predict.py whose code is not ported yet raise rather
    than being ignored."""
    for flag in ("pose_shape_weights", "pose2D_hrnet_weights"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag}: checkpoint loading is not ported yet (ROADMAP "
                "'Waiting' item: lapack_svd3 with checkpoint loading)")
    if args.svd_impl not in ("auto", "jacobi"):
        raise NotImplementedError(
            f"--svd_impl {args.svd_impl}: the LAPACK-sign SVD "
            "(ops/lapack_svd3.py) is not ported yet; the port runs the Jacobi "
            "SVD, which is what 'auto' selects without a checkpoint")
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(
            f"--num_devices {args.num_devices}: the multi-device paths are "
            "ROADMAP slice 5, not ported yet; the port runs on one device")


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


def build_predictor(args):
    """Models, config and options of the predict, from the flags.

    :return: keyword arguments shared by predict_pose_mf_shape_gaussian_net
        and predict_folder_batched
    """
    from hierarchicalprobabilistic3dhuman_torch.configs import (
        get_pose2d_hrnet_cfg_defaults, get_pose_shape_cfg_defaults)
    from hierarchicalprobabilistic3dhuman_torch.models.canny_edge_detector import (
        CannyEdgeDetector)
    from hierarchicalprobabilistic3dhuman_torch.models.hrnet import (
        PoseHighResolutionNet)
    from hierarchicalprobabilistic3dhuman_torch.models.pose_mf_shape_gaussian_net import (
        PoseMFShapeGaussianNet)
    from hierarchicalprobabilistic3dhuman_torch.models.smpl import SMPL
    from hierarchicalprobabilistic3dhuman_torch.models.weights import init_weights
    from hierarchicalprobabilistic3dhuman_torch.utils.device import (
        resolve_device, set_full_f32)
    from hierarchicalprobabilistic3dhuman_torch.utils.precision import bf16_apply

    _refuse_unported(args)
    device = resolve_device(args.device)
    set_full_f32(device)

    pose_shape_cfg = get_pose_shape_cfg_defaults()
    if args.pose_shape_cfg is not None:
        pose_shape_cfg.merge_from_file(args.pose_shape_cfg)
        print(f"\nLoaded Distribution Predictor config from {args.pose_shape_cfg}")
    hrnet_cfg = get_pose2d_hrnet_cfg_defaults()

    generator = torch.Generator().manual_seed(0)
    print("WARNING: checkpoint loading is not ported yet; HRNet and the "
          "distribution predictor use random weights.")
    hrnet = init_weights(
        PoseHighResolutionNet(num_joints=hrnet_cfg.MODEL.NUM_JOINTS), generator)
    model_cfg = pose_shape_cfg.MODEL
    if model_cfg.NUM_RESNET_LAYERS != 18:
        raise NotImplementedError("only the ResNet-18 encoder is ported")
    pose_shape_model = init_weights(PoseMFShapeGaussianNet(
        num_in_channels=model_cfg.NUM_IN_CHANNELS,
        embed_dim=model_cfg.EMBED_DIM,
        delta_i=model_cfg.DELTA_I,
        delta_i_weight=model_cfg.DELTA_I_WEIGHT,
        num_smpl_betas=model_cfg.NUM_SMPL_BETAS), generator)
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
    try:
        smpl_model = SMPL.from_files(device, gender=args.gender,
                                     num_betas=model_cfg.NUM_SMPL_BETAS)
    except FileNotFoundError as e:
        print(f"WARNING: {e}\nFalling back to a synthetic SMPL model "
              f"(geometry will not be human).")
        smpl_model = SMPL.synthetic(device,
                                    num_betas=model_cfg.NUM_SMPL_BETAS)

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
        num_uncertainty_samples=args.num_uncertainty_samples)


def run_predict(args):
    """The batched folder driver for --batch_size > 1 or --no_vis, else the
    per-image driver."""
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        predict_folder_batched, predict_pose_mf_shape_gaussian_net)
    kwargs = build_predictor(args)
    if args.batch_size > 1 or args.no_vis:
        if args.visualise_samples:
            print("NOTE: --visualise_samples is per-image only; ignored "
                  "with --batch_size > 1 or --no_vis.")
        return predict_folder_batched(batch_size=args.batch_size,
                                      save_vis=not args.no_vis, **kwargs)
    return predict_pose_mf_shape_gaussian_net(
        visualise_samples=args.visualise_samples, **kwargs)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="run_predict_torch.py",
        description="3D human shape/pose distribution prediction "
                    "(PyTorch/CUDA port; the flags of run_predict.py).")
    parser.add_argument("--image_dir", "-I", type=str, required=True,
                        help="Directory of images to run prediction on. "
                             "The batched driver also accepts pre-decoded "
                             "uint8 HWC .npy files and .npz packs "
                             "(data/pack_predict_inputs.py).")
    parser.add_argument("--save_dir", "-S", type=str, required=True,
                        help="Directory to save predictions/visualisations.")
    parser.add_argument("--pose_shape_weights", "-W3D", type=str, default=None,
                        help="Not ported yet: refused.")
    parser.add_argument("--pose_shape_cfg", type=str, default=None)
    parser.add_argument("--svd_impl", type=str, default="auto",
                        choices=["auto", "jacobi", "lapack", "lapack_callback"],
                        help="3x3 SVD: the port runs 'jacobi' (which 'auto' "
                             "selects without a checkpoint); the LAPACK-sign "
                             "modes are not ported yet and are refused.")
    parser.add_argument("--pose2D_hrnet_weights", "-W2D", type=str, default=None,
                        help="Not ported yet: refused.")
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
                        help="Devices to use; the port runs on one, more "
                             "are refused.")
    parser.add_argument("--num_workers", type=int, default=0,
                        help="Unused; kept for CLI parity.")
    parser.add_argument("--batch_size", "-B", type=int, default=1,
                        help="Images per batched HRNet + core call; > 1 "
                             "groups the folder by resolution and decodes "
                             "on a thread.")
    parser.add_argument("--no_vis", action="store_true",
                        help="Batched driver without any render or figure; "
                             "save pose/shape/cam/uncertainty to "
                             "outputs.npz (the serving path).")
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
