"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level name), and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

from hp3d_bench import harness

PORT = "hierarchicalprobabilistic3dhuman_torch"


def imported_top_levels(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def bench_sources(sub=""):
    top = os.path.join(harness.BENCH_DIR, sub)
    for d, _, files in os.walk(top):
        if "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in bench_sources():
        found = imported_top_levels(path) & set(harness.FORBIDDEN_MODULES)
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_port():
    for path in bench_sources("reference"):
        assert PORT not in imported_top_levels(path), path
        assert PORT + "." not in open(path).read().replace(
            "the port's " + PORT, ""), path


def test_forbidden_names_compare_whole_top_levels():
    mods = {"hierarchicalprobabilistic3dhuman_torch.models": 1, "jaxtyping": 1,
            "jax.numpy": 1, "hierarchicalprobabilistic3dhuman_tpu": 1}
    assert harness.forbidden_modules(mods) == ["hierarchicalprobabilistic3dhuman_tpu",
                                               "jax.numpy"]


def test_modules_after_a_dry_run_of_the_set_up():
    """A fresh process loads every module a run's set-up, window and
    reference load (each path on the CPU at a tiny size), then lists what
    sys.modules holds."""
    script = (
        "import sys, time, torch; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "torch.set_num_threads(2)\n"
        "from conftest import tiny\n"
        "from hp3d_bench import harness\n"
        "for cell in ('r18.train.s2.b72', 'r18.predict.novis.b8', 'r18.eval.ssp3d.b8'):\n"
        "    harness.run_cell(cell, 5, 0.2, 1, 'cpu', time.monotonic(), files=tiny(cell))\n"
        "print(' '.join(sorted(sys.modules)))\n"
    ) % (ROOT, os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    modules = out.stdout.strip().splitlines()[-1].split()
    assert PORT in {m.split(".")[0] for m in modules}
    assert harness.forbidden_modules(dict.fromkeys(modules)) == []
