"""Evaluate with the PyTorch/CUDA port (the flags of run_evaluate.py).

python run_evaluate_torch.py --dataset ssp3d --batch_size 8
python run_evaluate_torch.py --dataset 3dpw --pose_shape_weights model.tar
python run_evaluate_torch.py ... --device cpu      # plain versions, no card
"""

from hierarchicalprobabilistic3dhuman_torch.cli.evaluate import main

if __name__ == "__main__":
    main()
