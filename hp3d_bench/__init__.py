"""The benchmark of the PyTorch and CUDA port
(hierarchicalprobabilistic3dhuman_torch) on an NVIDIA H100.

`python3 hp3d_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
result line last. Each piece is found by its name: a configuration in
configs/<name>.json, a cell in workloads/<name>.json, the path its traffic
drives in paths/<path>.py, a per-layer metric in metrics/<name>.py. The
yardstick stays here: counts.py (operations, bytes, peaks), reference/
(the plain PyTorch reference, which imports nothing of the port) and
compare.py (the numbers that decide `correct`).
"""
