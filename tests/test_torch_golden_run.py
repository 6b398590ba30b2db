"""The port's training trajectory against the JAX package's: N stage-1
then N stage-2 Adam steps with one optimizer state through both stages,
as tests/test_golden_run.py trains JAX's, from the same weights, batches
and draws (N = chip_smoke.GOLDEN_STEPS = 4; chip_smoke.py's phase 11 runs
the same trajectory on the card).

Set-up (the step tests' size and parts, tests/_torch_train_fixtures.py):
ResNet-18 at B=2 on a 48^2 proxy, EMBED_DIM 64, 2 matrix-Fisher samples in
stage 2, SMPL.synthetic(), the perspective textured render with RGB (JAX's
through its Pallas kernel in interpret mode), Canny with threshold 0 and
Adam at 1e-4. JAX initialises the predictor; models/weights.py carries its
weights and BatchNorm statistics into the port. JAX trains with
optax.adam(1e-4) in one TrainState, its step jitted once per stage; the
port with the torch.optim.Adam of cli/train.py::build_model_and_optimizer,
handed to a new TrainStep per stage as the port's loop does. The batches
are float32 poses, backgrounds and textures from np.random.RandomState(123)
(chip_smoke.golden_batches), as in JAX's test; every step's key is split
from PRNGKey(42) as there, and the port is handed JAX's draws from it
(tests/jax_draws.py).

The rule (chip_smoke.golden_ratios). The port's float32 noise floor is the
gap between two of its own runs: its float32 trajectory, and the same
trajectory with the predictor in float64 (Float64Predictor, outputs
rounded to float32 for the loss) and Adam on float64 master weights.
  - After every step the loss, each loss term and each metric sum must
    satisfy |port - JAX| / |JAX| <= max(1e-4, 10 x floor_k), floor_k being
    the largest relative gap of step k's scalars between the two runs; and
    every BatchNorm running mean and variance must be within max(1e-3, 10 x
    its floor) of its largest entry, its floor being its own largest gap
    between the two runs at that step.
  - After the last step every parameter, BatchNorm statistic, and Adam's
    first and second moment (JAX's mu / nu read through the port's
    optax-to-Adam mapping, to_reference_layout) must be within max(1e-3,
    10 x floor) of the tensor's largest entry, the floor being that
    tensor's largest gap between the two runs; Adam's step count must
    equal optax's count.
The trajectory is chaotic at this size: Adam's first steps move every
weight by lr times the sign of its gradient, so an entry whose gradient
lies in the noise band moves 2 lr one way or the other, and train-mode
BatchNorm over 8 values a channel in layer4 and the Jacobi SVD's backward
at delta-I amplify that. The two runs of the floor go through the same
flips, so the floor absorbs them and no constant is loosened for them.
One scalar's own gap is a single draw of that chaos (a per-scalar floor
put the port 8.6 x over the rule on MPJPE at step 3), so the scalars take
their step's largest gap; a tensor's largest entry over many entries is
stable, so tensors keep their own. Measured on the CPU: the step floors
grow from 1.5e-6 (step 0) to 1.4e-2 - 4.7e-2 (stage 2); port vs JAX, the
largest ratio to the rule is 0.241 on the scalars (step 0's shape_nll
term, 2.4e-5 against the 1e-4 minimum; the loss 1.0e-5 at step 0, 7.0e-3
at step 7 against a floor of 4.7e-2), 0.113 on the per-step BatchNorm
statistics and 0.221 on the final state (Adam's nu of fc_pose.6.0.bias).

The negative controls rerun the port alone against the cached JAX
trajectory and floors, each with one fault injected by the test, and the
rule must fail: (a) a fresh Adam at the stage switch, (b) torch's unbiased
BatchNorm running variance (the fault that tests/test_torch_train_repairs.py
holds), (c) stage 2 run with stage 1's loss weights. (a) and (c) start
from the float32 run's state at the stage switch. Measured, the largest
ratio to the rule: (a) 2.19 on stage 2's scalars, 4.4 on the final Adam
moments, and the step count; (b) 33.4 on step 0's running variances;
(c) 5.46 on stage 2's scalars, 8.68 on the final state.

Budget (~115 s alone on one worker): the port's two runs go in a thread
while JAX's two steps are traced and compiled (each compile in a thread of
its own); the port's synthetic stage, which depends on the batch and the
draws alone, is computed once and memoised for the other runs.
"""

import contextlib
import copy
import functools
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import chip_smoke
from chip_smoke import (
    GOLDEN_STEPS as N, bn_statistics, golden_batches, golden_ratios,
    report_ratios, scalar_rel, step_scalars, train_state)
from hierarchicalprobabilistic3dhuman_tpu.configs import (
    get_pose_shape_cfg_defaults as j_cfg)
from hierarchicalprobabilistic3dhuman_tpu.train.train_pose_mf_shape_gaussian_net import (
    TrainState)

from hierarchicalprobabilistic3dhuman_torch.cli.train import (
    build_model_and_optimizer)
from hierarchicalprobabilistic3dhuman_torch.configs import (
    get_pose_shape_cfg_defaults as t_cfg)
from hierarchicalprobabilistic3dhuman_torch.models import resnet
from hierarchicalprobabilistic3dhuman_torch.models.weights import (
    flax_to_torch_predictor, to_reference_layout)
from hierarchicalprobabilistic3dhuman_torch.runtime.checkpointing import (
    EmptyState, ScaleByAdamState)
from _torch_train_fixtures import (
    Float64Predictor, init_jax_predictor, jax_train_step, pallas_interpret,
    port_train_step, small_cfg)
from jax_draws import JaxDraws

torch.set_num_threads(2)

B, D = chip_smoke.GOLDEN_BATCH, chip_smoke.GOLDEN_SMALL["img_wh"]
LAYERS, LR = 18, 1e-4
METRICS = ["PVE", "PVE-SC", "MPJPE"]
FAULTS = ["fresh_adam", "unbiased_var", "stage1_weights"]


def stage_metrics(stage):
    return METRICS + (["joints2Dsamples-L2E"] if stage == 2 else [])


def inputs():
    """2N (key, (pose, background, texture)) of JAX's test."""
    key, keys = jax.random.PRNGKey(42), []
    for _ in range(2 * N):
        key, sub = jax.random.split(key)
        keys.append(sub)
    return list(zip(keys, golden_batches(2 * N, B, D)))


def port_model():
    """The port's model and Adam as run_train_torch.py builds them, at this
    test's configuration, and the configuration."""
    cfg = small_cfg(t_cfg, D, LAYERS)
    cfg.TRAIN.LR = LR
    return (*build_model_and_optimizer(cfg, "cpu")[:2], cfg)


def memo_synth(step, k, memo):
    """The step's synthetic stage, memoised in `memo` by step index."""
    synth = step.synth

    def run(*args):
        if k not in memo:
            memo[k] = synth(*args)
        return memo[k]

    step.synth = run
    return step


@contextlib.contextmanager
def unbiased_running_var():
    """The port's BatchNorm2d with torch's own train mode, whose running
    variance takes the unbiased batch variance."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resnet.BatchNorm2d, "forward", torch.nn.BatchNorm2d.forward)
        yield


def port_trajectory(variables, memo, float64=False, fault=None, resume=None):
    """The port's run from JAX's initial `variables`, its synthetic stage
    memoised in `memo`. `float64` runs the predictor and Adam in float64;
    `fault` names a negative control; `resume`, a float32 run at the stage
    switch, is taken up at stage 2.

    :return: the trajectory (chip_smoke.golden_ratios), the run at the stage
        switch (trajectory so far, model and Adam state dicts)
    """
    model, optimizer, cfg = port_model()
    model.load_state_dict(flax_to_torch_predictor(variables, model))
    predictor = model
    if float64:
        model.double()          # in place: Adam keeps the same parameters
        predictor = Float64Predictor(model)
    run, switch, data = {"steps": [], "stats": []}, None, inputs()
    if resume is not None:
        run = copy.deepcopy(resume[0])
        model.load_state_dict(resume[1])
        optimizer.load_state_dict(resume[2])
    with (unbiased_running_var() if fault == "unbiased_var"
          else contextlib.nullcontext()):
        for stage in (1, 2)[len(run["steps"]) // N:]:
            loss_cfg = getattr(cfg.LOSS, f"STAGE{stage}")
            if stage == 2:
                switch = (copy.deepcopy(run), copy.deepcopy(model.state_dict()),
                          copy.deepcopy(optimizer.state_dict()))
                if fault == "fresh_adam":
                    optimizer = torch.optim.Adam(model.parameters(), lr=LR,
                                                 betas=(0.9, 0.999), eps=1e-8)
                if fault == "stage1_weights":
                    loss_cfg = copy.deepcopy(loss_cfg)
                    loss_cfg.WEIGHTS = cfg.LOSS.STAGE1.WEIGHTS
            for k in range(len(run["steps"]), stage * N):
                step = memo_synth(port_train_step(
                    predictor, cfg, loss_cfg, optimizer, stage_metrics(stage)),
                    k, memo)
                key, batch = data[k]
                run["steps"].append(step_scalars(*step(
                    JaxDraws(key), *(torch.from_numpy(a) for a in batch))))
                run["stats"].append(bn_statistics(model.state_dict()))
    run["state"] = chip_smoke.model_train_state(model, optimizer)
    return run, switch


def jax_trajectory(steps, state, variables):
    """JAX's run through its two compiled steps from `state`, in the port's
    names: each step's scalars and BatchNorm statistics, and the final
    parameters, statistics and Adam state."""
    numpy = functools.partial(jax.tree_util.tree_map, np.asarray)
    model, optimizer, _ = port_model()

    def variables_of(state):
        return {"params": numpy(state.params),
                "batch_stats": numpy(state.batch_stats)}

    run = {"steps": [], "stats": []}
    for k, (key, batch) in enumerate(inputs()):
        state, loss, sums, terms = steps[k // N](
            state, key, *(jnp.asarray(a) for a in batch))
        run["steps"].append(step_scalars(loss, sums, terms))
        run["stats"].append(bn_statistics(
            flax_to_torch_predictor(variables_of(state), model)))
    adam, _ = state.opt_state
    ckpt = to_reference_layout(
        {"epoch": 0, "best_epoch": 0, "best_epoch_val_metrics": {},
         "model_state_dict": variables_of(state),
         "best_model_state_dict": variables, "optimiser_state_dict": (
             ScaleByAdamState(count=np.asarray(adam.count), mu=numpy(adam.mu),
                              nu=numpy(adam.nu)), EmptyState())},
        model, optimizer)
    run["state"] = train_state([n for n, _ in model.named_parameters()],
                               ckpt["model_state_dict"],
                               ckpt["optimiser_state_dict"]["state"])
    return run


@functools.lru_cache(maxsize=None)
def runs():
    """Computed once per test process: JAX's initial variables, the port's
    memoised synthetic batches, its float32 run at the stage switch, and
    the JAX, port float32 and port float64 trajectories."""
    cfg = small_cfg(j_cfg, D, LAYERS)
    jmodel, variables = init_jax_predictor(LAYERS, D, seed=0)
    optimizer = optax.adam(LR)
    state = TrainState(variables["params"], variables["batch_stats"],
                       optimizer.init(variables["params"]))
    key, batch = inputs()[0]
    memo, t0 = {}, time.perf_counter()

    def port_runs():
        t = time.perf_counter()
        run32 = port_trajectory(variables, memo)
        t32 = time.perf_counter() - t
        return run32, port_trajectory(variables, memo, float64=True)[0], t32

    with ThreadPoolExecutor(3) as pool:
        port = pool.submit(port_runs)
        compiling = []
        with pallas_interpret():
            for stage in (1, 2):
                compiling.append(pool.submit(jax.jit(jax_train_step(
                    jmodel, cfg, getattr(cfg.LOSS, f"STAGE{stage}"), optimizer,
                    stage_metrics(stage))).lower(
                        state, key, *(jnp.asarray(a) for a in batch)).compile))
        t1 = time.perf_counter()
        steps = [c.result() for c in compiling]
        t2 = time.perf_counter()
        (port32, switch), port64, t32 = port.result()
    t3 = time.perf_counter()
    jax_run = jax_trajectory(steps, state, variables)
    print(f"JAX's steps traced by {t1 - t0:.1f} s, compiled by {t2 - t0:.1f} s, "
          f"run in {time.perf_counter() - t3:.1f} s; beside them the port's "
          f"float32 run {t32:.1f} s, both its runs done by {t3 - t0:.1f} s (CPU)")
    return variables, memo, switch, jax_run, port32, port64


def test_training_trajectory_matches_jax():
    _, _, _, jax_run, port32, port64 = runs()
    assert len(jax_run["steps"]) == 2 * N and jax_run["state"][1] == {2 * N}
    for k, (s, j, f) in enumerate(zip(port32["steps"], jax_run["steps"],
                                      port64["steps"])):
        print(f"step {k}: loss port {s['loss']:.7g} jax {j['loss']:.7g} "
              f"({scalar_rel(s['loss'], j['loss']):.1e} rel; floor "
              f"{max(scalar_rel(s[q], f[q]) for q in f):.1e})")
    assert all(np.isfinite(list(s.values())).all() for s in port32["steps"])
    ratios = golden_ratios(port32, jax_run, port32, port64)
    report_ratios("golden run", "port vs JAX", ratios)
    over = {k: v for k, v in ratios.items() if v > 1.0}
    assert not over, over


@pytest.mark.parametrize("fault", FAULTS)
def test_negative_control_fails_the_rule(fault):
    variables, memo, switch, jax_run, port32, port64 = runs()
    run, _ = port_trajectory(variables, memo, fault=fault,
                             resume=None if fault == "unbiased_var" else switch)
    worst = report_ratios("golden run", f"control {fault}",
                          golden_ratios(run, jax_run, port32, port64))
    assert worst > 1.0
