"""Prediction CLI of the port: the per-image, cropped, figures-on path.

python run_predict_torch.py --image_dir demo/ --save_dir out/ --cropped_images

Counterpart of hierarchicalprobabilistic3dhuman_tpu/cli/predict.py
::run_predict for that path, with the same flags it needs plus --device
(default cuda; a run that asks for cuda and finds none fails) and the
figure size and sample count of the per-image predict. Checkpoint loading
is not ported yet: the networks are randomly initialised from seed 0.
Without the licensed SMPL files the synthetic SMPL model is used.
"""

import argparse

import torch


def build_predictor(args):
    """Models, config and options of the per-image predict, from the flags.

    :return: keyword arguments for predict_pose_mf_shape_gaussian_net
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

    device = resolve_device(args.device)
    set_full_f32(device)
    if not args.cropped_images:
        raise NotImplementedError("the port predicts on cropped images only "
                                  "(--cropped_images); person detection is "
                                  "not ported yet")

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
        joints2Dvisib_threshold=args.joints2Dvisib_threshold,
        visualise_wh=args.visualise_wh,
        num_uncertainty_samples=args.num_uncertainty_samples)


def run_predict(args):
    from hierarchicalprobabilistic3dhuman_torch.predict.predict_pose_mf_shape_gaussian_net import (
        predict_pose_mf_shape_gaussian_net)
    return predict_pose_mf_shape_gaussian_net(**build_predictor(args))


def build_parser():
    parser = argparse.ArgumentParser(
        prog="run_predict_torch.py",
        description="3D human shape/pose distribution prediction on cropped "
                    "images (PyTorch/CUDA port).")
    parser.add_argument("--image_dir", "-I", type=str, required=True,
                        help="Directory of cropped images to predict on.")
    parser.add_argument("--save_dir", "-S", type=str, required=True,
                        help="Directory to save the figures.")
    parser.add_argument("--pose_shape_cfg", type=str, default=None)
    parser.add_argument("--cropped_images", "-C", action="store_true",
                        help="Images are already cropped and centred "
                             "(required by the port).")
    parser.add_argument("--joints2Dvisib_threshold", "-T", type=float,
                        default=0.75)
    parser.add_argument("--gender", "-G", type=str, default="neutral",
                        choices=["neutral", "male", "female"])
    parser.add_argument("--visualise_wh", type=int, default=512,
                        help="Side of each rendered view in the figure.")
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
