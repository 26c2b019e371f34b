"""Run one cell of the benchmark once and print its result line.

    python3 -m vobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json. The run needs as
many CUDA cards as the cell asks for and exits with code 2, printing no
result, where there are fewer. It makes its inputs from the seed, sets the
program up and warms it up, measures for `--seconds`, checks what the timed
path produced against the plain reference, and prints one JSON line last
on standard output: with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, the device's busy and window seconds and
a breakdown of the device trace.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    from vobench.harness import run_cell
    return run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
