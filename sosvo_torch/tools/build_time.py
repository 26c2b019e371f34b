"""Time the kernels' build: one nvcc per source, all started together, then
one link (`kernels/build.py`), against one nvcc call that compiles and
links every source.

    python -m sosvo_torch.tools.build_time [--rounds N]

Each build goes to a fresh directory under the repository's `build/`, in
turns parallel, single, single, parallel per pair of rounds, and prints
the wall seconds of each.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from sosvo_torch.kernels import build


def parallel_s(root: Path) -> float:
    build.BUILD_ROOT = root
    t0 = time.perf_counter()
    build.build()
    return time.perf_counter() - t0


def single_s(root: Path) -> float:
    srcs = [str(s) for s in build._sources() if s.suffix == ".cu"]
    t0 = time.perf_counter()
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(root / "lib.so"),
                    *srcs], check=True, capture_output=True)
    return time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    home = build.BUILD_ROOT
    home.mkdir(parents=True, exist_ok=True)
    ways = {"parallel": parallel_s, "single": single_s}
    for r in range(args.rounds):
        for name in (("parallel", "single") if r % 2 == 0 else ("single", "parallel")):
            root = Path(tempfile.mkdtemp(prefix="build_time_", dir=home))
            try:
                print(f"build {name}: {ways[name](root)} s", flush=True)
            finally:
                shutil.rmtree(root)
    build.BUILD_ROOT = home


if __name__ == "__main__":
    main()
