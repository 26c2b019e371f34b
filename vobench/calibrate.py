"""The readings that a cell's limits are set from, on the card.

    python3 -m vobench.calibrate --workloads <cell> [<cell> ...] --seeds <n> ...

From the root of a checkout that holds BENCHMARK.json. The cells must share
one configuration. For each seed the run makes the cell's inputs as a
benchmark run does, runs one whole pass (or live session) of each cell's
traffic through the program, then, for each cell, the reference (as the
configuration states: float32, TF32 off) and the control: the same
reference computed one precision below, with TF32 products. It prints one
JSON line per seed and cell: the compared numbers of the program against
the reference (the lower readings) and of the control against the
reference (the upper readings), and the ATEs. The benchmark's own runs do
not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from vobench import correct, drivers, inputs as inputs_mod
from vobench.harness import load_json
from vobench.program import Program


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    args = ap.parse_args(argv)
    root = Path.cwd()
    if not torch.cuda.is_available():
        print("no CUDA card: the control's TF32 exists only there", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cells = {w["name"]: w for w in load_json(root / "BENCHMARK.json")["workloads"]}
    chosen = [cells[w] for w in args.workloads]
    if len({c["config"] for c in chosen}) != 1:
        print("the cells must share one configuration", file=sys.stderr)
        return 2
    config_path = root / "vobench" / "configs" / f"{chosen[0]['config']}.json"
    config = load_json(config_path)
    for seed in args.seeds:
        inp = inputs_mod.make_inputs(config, seed, device)
        program = Program(config_path, config["assumed"], device)
        program.build_luts()
        runs = {}
        for c in chosen:
            traffic = load_json(root / "vobench" / "traffic" / f"{c['traffic']}.json")
            cls = drivers.DRIVERS[traffic["driver"]]
            d = cls(program, inp, config)
            d.warm(traffic["warm_frames"])
            t = time.perf_counter()
            out = d.one_pass()
            torch.cuda.synchronize(device)
            runs[c["name"]] = (cls, out, time.perf_counter() - t)
        del program
        for c in chosen:
            cls, out, pass_s = runs[c["name"]]
            kw = {"draws": cls.reference_draws(inp, config, device), "leg": cls.LEG}
            t = time.perf_counter()
            ref = correct.reference_run(config_path, config, inp, device, **kw)
            ref_s = time.perf_counter() - t
            ctl = correct.reference_run(config_path, config, inp, device, control=True, **kw)
            print(json.dumps({
                "cell": c["name"], "seed": seed,
                "program": correct.readings([out], ref),
                "control": correct.readings([drivers.PassOut(*ctl)], ref),
                "ate_m": {"program": correct.ate_m(out.T_world, inp.poses),
                          "reference": correct.ate_m(ref.T_world, inp.poses),
                          "control": correct.ate_m(ctl.T_world, inp.poses)},
                "n_loops": {"reference": None if ref.n_loops is None else int(ref.n_loops),
                            "control": None if ctl.n_loops is None else int(ctl.n_loops)},
                "pass_s": pass_s, "reference_s": ref_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
