"""The window's rate and tail, the trace's idle share, and counts.py,
against hand-made spans and hand counts."""

import pytest
import torch

from hp3d_bench import compare, counts, readers, tracing, window


class FakeClock:
    """A clock that dispatch and complete advance by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def drive(dispatch_s, complete_s, seconds):
    """lag_one over calls whose dispatch and completion take the given
    seconds (lists indexed by call)."""
    clock = FakeClock()

    def dispatch(k):
        clock.t += dispatch_s[k]
        return k

    def complete(k):
        clock.t += complete_s[k]

    return window.lag_one(dispatch, complete, seconds, clock)


def test_rate_and_tail_of_a_steady_window():
    out = drive([0.1] * 100, [0.4] * 100, 10.0)
    # A call waits for its dispatch (0.1 s), the previous call's completion
    # (0.4), the next one's dispatch (0.1) and its own completion (0.4): two
    # periods under lag one. The loop stops dispatching after 10 s.
    assert out["calls"] == 21
    assert out["window_s"] == pytest.approx(0.1 + 20 * 0.5 + 0.4)
    assert out["latencies_s"][0] == pytest.approx(0.6)
    assert out["latencies_s"][1:-1] == pytest.approx([1.0] * 19)
    assert out["latencies_s"][-1] == pytest.approx(0.9)
    assert window.percentile(out["latencies_s"], 95) == pytest.approx(1.0)


def test_a_stall_shows_in_rate_and_tail():
    steady = drive([0.1] * 100, [0.4] * 100, 10.0)
    stall = [0.4] * 100
    stall[5] = 3.0
    stalled = drive([0.1] * 100, stall, 10.0)
    rate = lambda o: o["calls"] / o["window_s"]   # noqa: E731
    assert rate(stalled) < 0.8 * rate(steady)
    assert max(stalled["latencies_s"]) == pytest.approx(3.6)
    lat = stalled["latencies_s"]
    assert window.percentile(lat, 95) > window.percentile(steady["latencies_s"], 95)


def test_percentile_is_numpys_linear():
    import numpy as np
    values = [5.0, 1.0, 4.0, 2.0, 3.0, 10.0, 7.0]
    for q in (0, 50, 90, 95, 100):
        assert window.percentile(values, q) == pytest.approx(np.percentile(values, q))


def test_idle_share_of_hand_made_device_ops():
    # Two overlapping ops (0-10, 5-15), a gap, then 30-40: busy 25 of 50.
    ops = [("a", 0, 10), ("b", 5, 10), ("c", 30, 10)]
    layer = {"profile": {"ops": ops, "span_ns": 50, "host_start_ns": 0,
                         "host_end_ns": 50, "marks": [("host work", 14, 31)]},
             "profile_calls": 2}
    assert tracing.busy_ns(ops) == 25
    assert readers.idle_percent(layer) == pytest.approx(50.0)
    assert readers.launches_per_call(layer) == pytest.approx(1.5)
    gaps = tracing.idle_gaps(layer["profile"])
    assert gaps[0] == ["host: host work", pytest.approx(15e-9)]
    assert tracing.top_ops(ops)[0][0] in ("a", "b", "c")


def test_mfu_and_span_readers():
    layer = {"spans_ms": {"s": [10.0, 30.0]}, "flops_per_call": 0.67e12}
    assert readers.span_mean_ms(layer, "s") == 20.0
    assert readers.mfu_percent(layer, "s") == pytest.approx(
        100 * 0.67e12 / (0.02 * counts.PEAK_F32_FLOPS))
    assert readers.span_mean_ms(layer, "absent") is None


def test_k1_reader():
    layer = {"profile": {"ops": [
        ("(anonymous namespace)::raster_faces(float const*, int)", 0, 300_000),
        ("void (anonymous namespace)::resolve<4>(unsigned long const*)", 0, 100_000),
        ("void (anonymous namespace)::pack_faces<4>(float const*)", 0, 7_000),
        ("void at::native::resolve<2>(float)", 0, 9_000),
        ("void at::native::other", 0, 5_000)],
                         "span_ns": 1},
             "k1": {"s": 0.0001}, "profile_calls": 2, "k1_calls_per_step": 1}
    # 0.4 ms of K1 over 2 calls: 0.2 ms a call against a 0.1 ms bound.
    assert readers.k1_roofline_percent(layer) == pytest.approx(50.0)
    assert readers.k1_roofline_percent({"profile": layer["profile"]}) is None


def test_conv_and_linear_counts_by_hand():
    conv = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1)
    # Output 8 x 4 x 4; each value 3 x 3 x 3 products: 2 x 8 x 16 x 27.
    assert counts.conv_linear_flops(conv, (2, 3, 8, 8)) == 2 * 2 * 8 * 16 * 27
    assert counts.conv2d_flops(2, 3, 8, (3, 3), (4, 4)) == 2 * 2 * 8 * 16 * 27
    lin = torch.nn.Linear(5, 7)
    assert counts.conv_linear_flops(lin, (4, 5)) == 2 * 4 * 5 * 7
    grouped = torch.nn.Conv2d(4, 8, 1, groups=2)
    assert counts.conv_linear_flops(grouped, (1, 4, 2, 2)) == 2 * 8 * 4 * 2


def test_k1_bound_by_hand():
    # One square of two triangles covering pixels [0, 2) x [0, 2) of 4 x 4.
    screen = torch.tensor([[[0.0, 0.0, 1.0], [2.0, 0.0, 1.0], [2.0, 2.0, 1.0],
                            [0.0, 2.0, 1.0]]])
    faces = torch.tensor([[0, 1, 2], [0, 2, 3], [0, 0, 0]])
    # Each face's box holds the 2 x 2 pixel centres; the degenerate face none.
    tests = counts.pixel_face_tests(screen, faces, (4, 4))
    assert tests == 8
    b = counts.raster_bound_s(1, 2, 3, (4, 4), tests, covered=4)
    assert b["bytes"] == 4 * 9 * 2 + 4 * 2 * 9 + 16 * (12 + 4 + 1)
    assert b["ops"] == 8 * counts.OPS_PER_TEST + 4 * 5 * 3
    assert b["s"] == pytest.approx(max(b["bytes"] / counts.PEAK_BYTES_PER_S,
                                       b["ops"] / counts.PEAK_F32_FLOPS))
    assert b["by"] == "bytes"


def test_pack_bound_by_hand():
    # 2 meshes of 200 faces (2 chunks of 128), 50 used vertices, A = 3.
    b = counts.pack_bound_s(2, 200, 50, 3)
    assert b["bytes"] == (2 * 200 * (4 * 16 + 12 * 3 + 16) + 2 * 2 * 16
                          + 8 * 3 * 200 + 2 * 50 * 4 * 6)
    assert b["ops"] == 2 * 200 * counts.OPS_PER_FACE_PACK
    assert b["s"] == pytest.approx(max(b["bytes"] / counts.PEAK_BYTES_PER_S,
                                       b["ops"] / counts.PEAK_F32_FLOPS))


def test_smpl_and_step_counts():
    V = 6890
    assert counts.smpl_flops(10) == (2 * V * 30 + 2 * V * 3 * 207 + 2 * 24 * V * 3
                                     + 2 * V * 24 * 16 + 2 * V * 12
                                     + 2 * (24 + 45) * V * 3)
    s = counts.smpl_flops(10)
    assert counts.train_step_flops(100, 2, 8) == 3 * 2 * 100 + 3 * 2 * 9 * s + 3 * 2 * s
    assert counts.predict_batch_flops(10, 20, 2, 50) == 2 * 30 + 2 * 51 * s
    assert counts.eval_batch_flops(10, 2, 10) == 2 * 10 + 2 * 24 * s


def test_gaps_of_the_comparison():
    assert compare.loss_gap([1.0, 2.0], [1.0, 2.2]) == pytest.approx(0.2 / 2.2)
    gap, leaf = compare.leaf_gap({"a": 1.0, "b": 0.0}, {"a": 1.0, "b": 1e-9})
    # b's reference norm is tiny: its gap is measured against the median.
    assert leaf == "b" and gap == pytest.approx(1e-9 / 0.5000000005)
    assert compare.moving_leaves({"a": 1.0, "b": 1.0, "c": 1e-4}) == ["a", "b"]
    ok, lines = compare.judge({"x": 1.0, "y": float("nan")}, {"x": 2.0, "y": 1.0})
    assert not ok and "FAIL" in lines[1]
    g, name = compare.output_gap({"o": torch.tensor([1.0, 2.0])},
                                 {"o": torch.tensor([1.0, 2.5])})
    assert g == pytest.approx(0.2) and name == "o"


def test_thirds_show_a_stall_inside_the_window():
    # Calls of 0.5 s with a 4 s stall in the middle third.
    complete = [0.4] * 100
    complete[10] = 4.0
    out = drive([0.1] * 100, complete, 12.0)
    first, middle, last = out["thirds"]
    assert sum(out["thirds"]) == out["calls"]
    assert middle < first and middle < last
    steady = drive([0.1] * 100, [0.4] * 100, 12.0)["thirds"]
    assert max(steady) - min(steady) <= 1
