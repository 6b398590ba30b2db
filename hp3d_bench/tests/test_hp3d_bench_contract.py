"""BENCHMARK.json against the benchmark's contract, and the harness finding
every piece by its name.

    python -m pytest hp3d_bench/tests -q
"""

import json
import os
import re
import shutil
import statistics

import pytest

from hp3d_bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_text():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end":
                    assert one_line(entry[key]), (entry["name"], key)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [n for g, n in names if g == group]
        assert len(group_names) == len(set(group_names)), group
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metric_names) == len(set(metric_names))


def test_configs_found_by_name():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"hp3d_bench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        doc = harness.load_json(harness.ROOT, c["file"])
        assert doc["reduced"] == c["reduced"] == []
        assert doc["source"] == c["source"]
        assert c["source"].startswith("https://")


def test_cells_found_by_name():
    pairs = set()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        workload, config, traffic = harness.cell_files(w["name"])
        assert workload["config"] == w["config"]
        assert workload["traffic"] == w["traffic"]
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "paths",
                                           f"{traffic['path']}.py"))
        assert config["name"] == w["config"]
        assert workload["limits"]
        reported = [m for m in BENCH["end_to_end"] if harness.applies(m, w["name"], BENCH)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        layer = [m for m in BENCH["per_layer"] if harness.applies(m, w["name"], BENCH)]
        assert layer, w["name"]
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert set(e2e) >= {"setup_s"}


def test_bounds_and_run_seconds():
    for m in BENCH["end_to_end"]:
        assert set(m) <= E2E_KEYS and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells fits the time a check allows.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_each_moves_names_an_end_to_end_metric_every_cell_reports():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= LAYER_KEYS
        assert m["moves"] in e2e
        moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for w in BENCH["workloads"]:
            if harness.applies(m, w["name"], BENCH):
                assert harness.applies(moves, w["name"], BENCH), (m["name"], w["name"])


def test_metric_files_match_the_benchmark():
    layers = {}
    for m in BENCH["per_layer"]:
        module = harness.metric_module(m["name"])
        assert (module.UNIT, module.LAYER, module.MOVES, module.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"])
        layers.setdefault(m["layer"], set()).add(m["name"])
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_new_workload_and_metric_files_are_picked_up(tmp_path, monkeypatch):
    """A cell and a per-layer metric are added as files alone: the harness
    finds them with no edit to any file it has."""
    bench_dir = tmp_path / "hp3d_bench"
    shutil.copytree(harness.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    (bench_dir / "workloads" / "r18.train.s2.b36.json").write_text(json.dumps(
        {"config": "hp3d-r18", "traffic": "train.s2.b36",
         "limits": {"loss_gap": 1.0}}))
    traffic = harness.load_json(harness.BENCH_DIR, "traffic", "train.s2.b72.json")
    traffic["params"]["batch"] = 36
    (bench_dir / "traffic" / "train.s2.b36.json").write_text(json.dumps(traffic))
    (bench_dir / "metrics" / "train.loss_reads.py").write_text(
        'NAME = "train.loss_reads"\nUNIT = "count"\nLAYER = "train"\n'
        'MOVES = "train_img_per_s"\nSOURCE = "program_counter"\n\n\n'
        'def read(layer):\n    return 7\n')
    bench["workloads"].append({"name": "r18.train.s2.b36", "config": "hp3d-r18",
                               "traffic": "train.s2.b36", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "train.loss_reads", "unit": "count",
                               "better": "lower", "source": "program_counter",
                               "layer": "train", "moves": "train_img_per_s"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_per_s":
            m["workloads"].append("r18.train.s2.b36")
    monkeypatch.setattr(harness, "BENCH_DIR", str(bench_dir))
    workload, config, traffic = harness.cell_files("r18.train.s2.b36")
    assert traffic["params"]["batch"] == 36 and config["name"] == "hp3d-r18"
    assert harness.metric_module("train.loss_reads").read({}) == 7
    assert harness.applies(bench["per_layer"][-1], "r18.train.s2.b36", bench)
    assert not harness.applies(bench["per_layer"][-1], "r18.predict.novis.b8", bench)


def test_config_files_hold_the_port_defaults():
    """Each configuration file holds the reference's config tree as it is
    run: the port's defaults, with the encoder depth of its name."""
    from hierarchicalprobabilistic3dhuman_torch.configs import (
        get_pose2d_hrnet_cfg_defaults, get_pose_shape_cfg_defaults)
    defaults = json.loads(json.dumps(get_pose_shape_cfg_defaults()))
    for c in BENCH["configs"]:
        doc = harness.load_json(harness.ROOT, c["file"])
        layers = doc["pose_shape_cfg"]["MODEL"]["NUM_RESNET_LAYERS"]
        assert c["name"].endswith(str(layers))
        want = json.loads(json.dumps(defaults))
        want["MODEL"]["NUM_RESNET_LAYERS"] = layers
        assert doc["pose_shape_cfg"] == want
        assert doc["hrnet_cfg"] == json.loads(json.dumps(get_pose2d_hrnet_cfg_defaults()))


def test_spread_arithmetic_matches_the_contract():
    """The bound rule reads quartiles as statistics.quantiles gives them."""
    values = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert (q3 - q1) / statistics.median(values) == pytest.approx(0.025, abs=1e-3)
