"""Real-assets parity harness of the PyTorch/CUDA port.

The port's counterpart of run_parity.py. No licensed SMPL files, trained
checkpoint or 3DPW/SSP-3D datasets ship with the repository, so the
end-to-end accuracy check against the reference's published numbers runs
only where they exist:

    python run_parity_torch.py \
        [--pose_shape_weights model_files/poseMF_shapeGaussian_net_weights.tar] \
        [--reference_metrics parity/reference_metrics.json] \
        [--tolerance_mm 1.0] [--num_devices N] [--sample_parallel S] \
        [--device cuda|cpu]

  * prints a checklist of the assets (SMPL neutral/male/female files, the
    predictor checkpoint, each dataset); without the SMPL files, the
    checkpoint or any dataset it prints PARITY SKIPPED and exits 0;
  * evaluates each dataset present through the port's evaluation CLI
    (run_evaluate_torch.py's function, in this process) with
    svd_impl="lapack", the LAPACK-sign SVD that reference checkpoints were
    trained against, on --num_devices devices with --sample_parallel;
  * with --reference_metrics (JSON {dataset: {metric: value}}, the
    reference's printed numbers: millimetres for PVE/MPJPE metrics,
    fractions or pixels for the others) diffs every common metric and
    exits 1 when one differs by more than --tolerance_mm (millimetre
    metrics) or --tolerance_frac (the others).
"""

import argparse
import json
import os
import sys
import types


def _asset_checklist(args):
    from hierarchicalprobabilistic3dhuman_torch.configs import paths

    def smpl_file(gender):
        base = os.path.join(paths.SMPL, f"SMPL_{gender}")
        for ext in (".npz", ".pkl"):
            if os.path.exists(base + ext):
                return base + ext
        return None

    def directory(path):
        return path if os.path.isdir(path) else None

    checklist = {
        "smpl_neutral": smpl_file("NEUTRAL"),
        "smpl_male": smpl_file("MALE"),
        "smpl_female": smpl_file("FEMALE"),
        "pose_shape_weights": (args.pose_shape_weights
                               if args.pose_shape_weights
                               and os.path.exists(args.pose_shape_weights)
                               else None),
        "3dpw": directory(args.pw3d_path or paths.PW3D_PATH),
        "ssp3d": directory(args.ssp3d_path or paths.SSP3D_PATH),
    }
    print("Asset checklist:")
    for name, path in checklist.items():
        print(f"  [{'x' if path else ' '}] {name:20s} {path or 'MISSING'}")
    return checklist


def _run_dataset_eval(dataset, dataset_path, args):
    """The evaluation CLI's run in this process; returns the final metrics
    (the trackers' units: metres for PVE/MPJPE)."""
    from hierarchicalprobabilistic3dhuman_torch.cli.evaluate import run_evaluate

    ns = types.SimpleNamespace(
        dataset=dataset,
        dataset_path=dataset_path,
        pose_shape_weights=args.pose_shape_weights,
        pose_shape_cfg=args.pose_shape_cfg,
        svd_impl="lapack",
        save_path=os.path.join(args.save_dir, dataset),
        num_samples=args.num_samples,
        batch_size=args.batch_size,
        num_workers=args.num_workers,
        num_devices=args.num_devices,
        sample_parallel=args.sample_parallel,
        profile_dir=None,
        device=args.device,
    )
    return run_evaluate(ns)


_MM_METRICS = ("PVE", "MPJPE")  # reported in millimetres


def _is_mm(metric):
    return metric.split("_samples_min")[0].split("-")[0] in _MM_METRICS


def _in_reference_units(metric, value):
    """A tracker's value in the reference's printed units."""
    return value * 1000.0 if _is_mm(metric) else value


def build_parser():
    parser = argparse.ArgumentParser(
        prog="run_parity_torch.py",
        description="Real-assets accuracy parity of the PyTorch/CUDA port.")
    parser.add_argument("--pose_shape_weights", type=str,
                        default="model_files/poseMF_shapeGaussian_net_weights.tar")
    parser.add_argument("--pose_shape_cfg", type=str, default=None)
    parser.add_argument("--pw3d_path", type=str, default=None)
    parser.add_argument("--ssp3d_path", type=str, default=None)
    parser.add_argument("--reference_metrics", type=str, default=None,
                        help="JSON {dataset: {metric: value}} of the "
                             "reference's run_evaluate.py output")
    parser.add_argument("--tolerance_mm", type=float, default=1.0)
    parser.add_argument("--tolerance_frac", type=float, default=0.01,
                        help="tolerance for IOU / pixel-L2E metrics")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--num_workers", type=int, default=2)
    parser.add_argument("--num_samples", type=int, default=10)
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Devices of the evaluation (default: every "
                             "visible card, one with --device cpu).")
    parser.add_argument("--sample_parallel", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; fails without a card) or cpu.")
    parser.add_argument("--save_dir", type=str, default="./parity_evaluations")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    checklist = _asset_checklist(args)
    core = ("smpl_neutral", "smpl_male", "smpl_female", "pose_shape_weights")
    missing_core = [k for k in core if checklist[k] is None]
    datasets = [d for d in ("3dpw", "ssp3d") if checklist[d]]

    if missing_core or not datasets:
        reasons = missing_core + ([] if datasets else ["any eval dataset"])
        print(f"\nPARITY SKIPPED — missing assets: {', '.join(reasons)}")
        print("Obtain the licensed SMPL files, the trained checkpoint and the "
              "datasets (the reference's README) and run again.")
        return 0

    ref = None
    if args.reference_metrics:
        with open(args.reference_metrics) as f:
            ref = json.load(f)

    failures = []
    for dataset in datasets:
        print(f"\n=== {dataset} (svd_impl=lapack) ===")
        ours = _run_dataset_eval(dataset, checklist[dataset], args)
        if ref is None or dataset not in ref:
            print(f"(no reference metrics for {dataset}: printed only)")
            continue
        print(f"\n{'metric':24s} {'ours':>10} {'reference':>10} {'diff':>8}")
        for metric, ref_val in sorted(ref[dataset].items()):
            if metric not in ours:
                print(f"{metric:24s} {'-':>10} {ref_val:10.3f}   (not computed)")
                continue
            val = _in_reference_units(metric, float(ours[metric]))
            tol = args.tolerance_mm if _is_mm(metric) else args.tolerance_frac
            diff = abs(val - float(ref_val))
            flag = "" if diff <= tol else "  FAIL"
            print(f"{metric:24s} {val:10.3f} {float(ref_val):10.3f} "
                  f"{diff:8.3f}{flag}")
            if diff > tol:
                failures.append((dataset, metric, val, float(ref_val)))

    if failures:
        print(f"\nPARITY FAILED: {len(failures)} metric(s) out of tolerance")
        return 1
    print("\nPARITY OK" + ("" if ref else " (no reference diff requested)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
