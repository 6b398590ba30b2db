"""Whole runs of each path on the CPU at a tiny size (the device check
skipped): the port agrees with the reference and `correct` comes out true;
with the timed path broken underneath, `correct` comes out false."""

import time

import pytest
import torch
from conftest import tiny

from hp3d_bench import harness

TRAIN = "r18.train.s2.b72"
PREDICT = "r18.predict.novis.b8"
EVAL = "r18.eval.ssp3d.b8"
SEED = 2 ** 31 + 977


def run(cell, trace=0, wrap=None):
    torch.set_num_threads(2)
    ctx = harness.run_cell(cell, SEED, 1.0, trace, "cpu", time.monotonic(),
                           wrap=wrap, files=tiny(cell))
    line, lines = harness.result_line(ctx, harness.benchmark(), {"platform": "cpu"})
    return ctx, line


@pytest.mark.parametrize("cell", [TRAIN, PREDICT, EVAL])
def test_port_matches_reference(cell):
    ctx, line = run(cell, trace=1)
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0
    assert list(line)[-1] == "compared"
    assert harness.forbidden_modules() == []


def test_untraced_line_holds_the_cells_end_to_end_metrics():
    ctx, line = run(PREDICT)
    assert set(line["metrics"]) == {"predict_img_per_s", "predict_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())


def frozen_state(step):
    """A step whose optimizer leaves the parameters as they were."""
    step.optimizer.step = lambda *a, **k: None
    return step


def half_batch(step):
    """A step that leaves out half the batch (the mean over the rest)."""
    def call(draws, pose, background, texture):
        h = pose.shape[0] // 2
        return step(draws, pose[:h], background[:h], texture[:h])
    return call


def altered_answer(core):
    """A core whose per-vertex uncertainty is altered where it is made."""
    def call(*args, **kwargs):
        out = dict(core(*args, **kwargs))
        out["per_vertex_3Dvar"] = out["per_vertex_3Dvar"] * 1.01
        return out
    return call


def altered_frame_metric(step):
    """An eval step whose per-frame silhouette IOU is altered where it is
    made."""
    def call(*args):
        out = dict(step(*args))
        metrics = dict(out["frame_metrics"])
        metrics["silhouette-IOU"] = metrics["silhouette-IOU"] * 0.99
        out["frame_metrics"] = metrics
        return out
    return call


def altered_batches(batches):
    """A loader whose every batch has one background pixel altered where
    the batch is made."""
    for batch in batches:
        batch = {k: v.copy() for k, v in batch.items()}
        batch["background"][0, 0, 0, 0] ^= 1
        yield batch


def test_altered_batch_shows_in_loader_gap():
    ctx, line = run(TRAIN, wrap={"train_batches": altered_batches})
    assert line["correct"] is False
    assert ctx.result.numbers["loader_gap"] == 1.0


@pytest.mark.parametrize("cell, what, broken", [
    (TRAIN, "train_step", frozen_state),
    (TRAIN, "train_step", half_batch),
    (PREDICT, "predict_core", altered_answer),
    (EVAL, "eval_step", altered_frame_metric),
])
def test_broken_path_is_not_correct(cell, what, broken):
    ctx, line = run(cell, wrap={what: broken})
    assert line["correct"] is False, line["compared"]
