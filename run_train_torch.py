"""Train with the PyTorch/CUDA port (the flags of run_train.py).

python run_train_torch.py -E experiments/exp_001 [-O TRAIN.BATCH_SIZE 8 ...] [-R 20]
python run_train_torch.py -E <dir> --device cpu -O DATA.PROXY_REP_SIZE 32 TRAIN.BATCH_SIZE 2
"""

from hierarchicalprobabilistic3dhuman_torch.cli.train import main

if __name__ == "__main__":
    main()
