"""On the card: the control (the reference in the port's place, in TF32)
comes out as not correct under each cell's limits, at the cell's own size.

    python -m pytest -m cuda hp3d_bench/tests/test_hp3d_bench_control.py
"""

import pytest
import torch

from hp3d_bench import compare, control, harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the control runs at the cell's size "
                    "in TF32, which only the card has)")
    from hierarchicalprobabilistic3dhuman_torch.utils.device import set_full_f32
    set_full_f32("cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cuda_device, cell):
    limits = harness.cell_files(cell)[0]["limits"]
    numbers = control.readings(cell, 4242, variants=("tf32",))["tf32"]
    numbers.pop("_info", None)
    # The control has no loader: its numbers are judged, each by its limit.
    correct, lines = compare.judge(
        numbers, {k: v for k, v in limits.items() if k in numbers})
    assert not correct, lines
