"""The port's sharded train step on the CPU: 2- and 4-rank gloo groups
(processes of chip_smoke.py) against the 1-rank step on the same global
batch.

One step each at B = 4, 48^2, EMBED_DIM 64, 4 matrix-Fisher samples in
stage 2, weights from seed 0, a fresh Adam, draws from seed 3, synthetic
SMPL and the synthetic fallback dataset's batch: stage 1 and stage 2 at
data 2, stage 2 at data 1 x sample 2 (2 ranks), and stage 2 at data 2 x
sample 2 (4 ranks). Every rank draws the global batch's synthetic scene
and sampler proposals and keeps its rows and samples; its predictor runs
in DDP with BatchNorms synced over "data".

Compared (chip_smoke.compare_train): the loss, its terms and the metric
sums within 1e-5 relative; every gradient after DDP's all-reduce, every
BatchNorm running statistic and every weight after Adam within max(1e-5,
10 x its float32 floor) of the tensor's largest entry. The floor is the
1-rank step against the same step with the predictor computed in float64
(chip_smoke.par_train_step(floors=True)), per tensor. Adam's first step
moves each weight by the learning rate times its gradient's sign, so a
weight whose gradient lies within the gradients' tolerance of zero may
differ by up to twice the learning rate more (chip_smoke.adam_ratio: at
32^2 one such sign flipped between 1 and 2 ranks). The sharded steps'
differences came to at most 0.28 of their tolerance on the CPU, the
heads' gradients the nearest (their Jacobi SVD's backward amplifies
rounding).
"""

import pytest
import torch

import chip_smoke

torch.set_num_threads(2)

D, B, N, SEED = 48, 4, 4, 3
CFG = ["MODEL.EMBED_DIM", 64]


def _cfg():
    cfg = chip_smoke.train_cfg(D, N)
    cfg.merge_from_list(CFG)
    return cfg


@pytest.fixture(scope="module")
def batch():
    return chip_smoke.train_batch(B, D, 1)


@pytest.fixture(scope="module")
def one_rank(batch):
    return {stage: chip_smoke.par_train_step(torch.device("cpu"), _cfg(), stage,
                                             batch, None, SEED, floors=True)
            for stage in (1, 2)}


def _run(world, runs, batch, workdir):
    inputs = {"img_wh": D, "num_samples": N, "cfg": CFG, "seed": SEED,
              "batch": batch, "runs": runs}
    # The ranks keep this process's 2 threads: at another count the CPU's
    # kernels round the synthetic scene differently, and a Canny edge
    # pixel that flips moves the encoder's first gradients by percents.
    return chip_smoke.run_ranks("train", world, inputs, str(workdir),
                                threads=2, timeout=600)


RUNS_2 = [(1, 1), (2, 1), (2, 2)]


@pytest.fixture(scope="module")
def two_ranks(batch, tmp_path_factory):
    return _run(2, RUNS_2, batch, tmp_path_factory.mktemp("train2"))


@pytest.mark.parametrize("run", range(len(RUNS_2)),
                         ids=[f"stage{s}-data{2 // p}-sample{p}" for s, p in RUNS_2])
def test_two_ranks_match_one(one_rank, two_ranks, run):
    stage, sample = RUNS_2[run]
    for rank, outs in enumerate(two_ranks):
        worst = chip_smoke.compare_train(
            f"stage {stage}, data {2 // sample} x sample {sample}, rank {rank}",
            one_rank[stage], outs[run])
        assert worst <= 1.0


def test_four_ranks_match_one(one_rank, batch, tmp_path):
    """Stage 2 at data 2 x sample 2: rows and samples both split."""
    for rank, outs in enumerate(_run(4, [(2, 2)], batch, tmp_path)):
        worst = chip_smoke.compare_train(f"stage 2, data 2 x sample 2, rank {rank}",
                                         one_rank[2], outs[0])
        assert worst <= 1.0


def test_ranks_hold_equal_weights(two_ranks):
    """Adam leaves every rank with the same weights and statistics."""
    for run in range(len(RUNS_2)):
        a, b = two_ranks[0][run], two_ranks[1][run]
        for kind in ("params", "buffers"):
            for n, v in a[kind].items():
                assert torch.equal(v, b[kind][n]), (kind, n)
