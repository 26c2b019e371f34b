"""vobench: the benchmark of sosvo_torch, the PyTorch/CUDA port of sosvo.

`python3 -m vobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once. See `harness.py` for how a cell is
found and run, `drivers.py` for the traffic, `correct.py` for the check
against the plain reference in `reference/`, and `metrics/` for the readers.
"""
