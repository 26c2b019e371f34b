"""One run of one cell: set-up, warm-up, the measured window, the trace,
the check against the reference, and the result line.

Everything a cell is made of is found by name under the checkout's root:
the cell in `BENCHMARK.json`, its configuration in
`vobench/configs/<config>.json`, its traffic in `vobench/traffic/<traffic>.json`,
its limits in `vobench/limits/<cell>.json` and each metric's reader in
`vobench/metrics/<metric>.py`. A new cell or metric is new files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import torch

from vobench import correct, drivers, inputs as inputs_mod, trace as trace_mod
from vobench.program import Program
from vobench.spans import Recorder

FORBIDDEN = ("jax", "jaxlib", "flax", "sosvo", "vo_single_camera_sos_tpu")
VOBENCH_DIR = str(Path(__file__).resolve().parent)


@dataclass
class RunRecord:
    """What the metric readers read."""

    setup_s: float
    frames: int
    measured_s: float
    frames_processed: int
    recorder: Recorder
    latencies_s: list = field(default_factory=list)
    syncs: int | None = None
    trace: trace_mod.DeviceTrace | None = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(root: Path, name: str):
    path = root / "vobench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vobench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules(names=None) -> list[str]:
    """Top-level names among `names` (sys.modules where None) that a run must
    not hold, compared whole: `sosvo_torch` is not `sosvo`."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def _count_syncs(caught) -> int:
    return sum(1 for w in caught if "called a synchronizing" in str(w.message)
               and not str(w.filename).startswith(VOBENCH_DIR))


def _steal_s() -> float:
    """The host's stolen CPU seconds so far, summed over its CPUs (/proc/stat)."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return float("nan")


def device_info(device, count: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool, device,
             t_process: float, out=sys.stdout, err=sys.stderr) -> int:
    """Run `workload` once and print its result line; returns the exit code."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        print(f"no workload {workload!r} in BENCHMARK.json", file=err)
        return 2
    cell = cells[workload]
    config_path = root / "vobench" / "configs" / f"{cell['config']}.json"
    config = load_json(config_path)
    traffic = load_json(root / "vobench" / "traffic" / f"{cell['traffic']}.json")
    limits_path = root / "vobench" / "limits" / f"{workload}.json"
    limits = load_json(limits_path)["numbers"] if limits_path.exists() else {}
    kind = "per_layer" if traced else "end_to_end"
    metrics = cell_metrics(bench, workload, kind)
    readers = {m["name"]: load_reader(root, m["name"]) for m in metrics}

    # Set-up: the inputs from the seed, the program's objects, the warm-up.
    marks = {"imported": time.perf_counter()}
    driver_cls = drivers.DRIVERS[traffic["driver"]]
    inp = inputs_mod.make_inputs(config, seed, device)
    marks["inputs"] = time.perf_counter()
    program = Program(config_path, config["assumed"], device)
    program.build_luts()
    driver = driver_cls(program, inp, config)
    inp = driver.inp  # the frames where the traffic keeps them; a card copy it let go is freed
    marks["program"] = time.perf_counter()
    driver.warm(traffic["warm_frames"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    marks["warm"] = time.perf_counter()
    print("set-up s: " + ", ".join(
        f"{k} {marks[k] - t:.2f}" for k, t in zip(("imported", "inputs", "program", "warm"),
                                                 (t_process, marks["imported"], marks["inputs"],
                                                  marks["program"]))), file=err)

    recorder = Recorder()
    want_trace = traced and device.type == "cuda" and \
        any(getattr(r, "TRACE", False) for r in readers.values())
    want_syncs = traced and device.type == "cuda" and \
        any(getattr(r, "SYNCS", False) for r in readers.values())
    if traced:
        recorder.install(readers.values())
    prof = trace_mod.start() if want_trace else None

    def on_start():
        marks["start_ns"] = time.time_ns()
        recorder.active = True

    cpu0, steal0 = time.process_time(), _steal_s()
    with warnings.catch_warnings(record=True) as caught:
        if want_syncs:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        try:
            win = driver.window(seconds, on_start)
        finally:
            if want_syncs:
                torch.cuda.set_sync_debug_mode("default")
            recorder.active = False
    end_ns = time.time_ns()
    print(f"window: {(end_ns - marks['start_ns']) / 1e9:.3f} s, this process's CPU "
          f"{time.process_time() - cpu0:.3f} s, the host's steal {_steal_s() - steal0:.2f} s, "
          f"passes {[round(x, 3) for x in win.pass_s]}", file=err)
    dev_trace = None
    if prof is not None:
        t_read = time.perf_counter()
        dev_trace = trace_mod.stop(prof, marks["start_ns"], end_ns)
        first = (dev_trace.events[0][1] - dev_trace.start_ns) / 1e6 if dev_trace.events else None
        print(f"trace: {len(dev_trace.events)} device events, the first {first} ms into the "
              f"window, read in {time.perf_counter() - t_read:.1f} s", file=err)
    recorder.remove()

    record = RunRecord(setup_s=win.start - t_process, frames=win.frames,
                       measured_s=win.measured_s, frames_processed=win.frames_processed,
                       recorder=recorder, latencies_s=win.latencies_s,
                       syncs=_count_syncs(caught) if want_syncs else None, trace=dev_trace)
    values = {}
    for name, reader in readers.items():
        v = reader.read(record)
        if v is None:
            print(f"{name}: nothing to read in this run", file=err)
            continue
        values[name] = v if isinstance(v, dict) else {"value": float(v)}
    units = {m["name"]: m["unit"] for m in metrics}
    result_metrics = {n: {"value": v["value"], "unit": units[n],
                          **{k: x for k, x in v.items() if k != "value"}}
                      for n, v in values.items()}
    dev = device_info(device, cell["chips"])
    if dev_trace is not None:
        dev["busy_s"] = dev_trace.busy_s
        dev["window_s"] = dev_trace.window_s

    # The check: the program's state is let go, then the reference runs.
    outputs = win.outputs
    attempted = sum(o.T_world.shape[0] for o in outputs)
    failed = sum(int((~o.pose_ok[1:]).sum()) for o in outputs)  # frame 0 is the first pose
    del driver, program
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = correct.reference_run(config_path, config, inp, device,
                                draws=driver_cls.reference_draws(inp, config, device),
                                leg=driver_cls.LEG)
    found = correct.readings(outputs, ref)
    ok, checks = correct.judge(found, limits)
    if not limits:
        print(f"no limits for {workload} ({limits_path}): not correct", file=err)
        ok = False
    if not outputs:
        print("the window produced no output to check: not correct", file=err)
        ok = False
    ates = {"reference": correct.ate_m(ref.T_world, inp.poses)}
    if outputs:
        ates["program"] = correct.ate_m(outputs[0].T_world, inp.poses)
    print(f"ate_m (not compared): {json.dumps(ates)}", file=err)
    for name, v in found.items():
        if name not in limits:
            print(f"{name} {v} (not compared)", file=err)

    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: no result", file=err)
        return 3
    line = {"correct": ok, "attempted": attempted, "failed": failed, "metrics": result_metrics,
            "device": dev}
    if dev_trace is not None:
        line["breakdown"] = {"device_ops": trace_mod.top_device_ops(dev_trace),
                             "idle_gaps": trace_mod.idle_gaps_by_span(dev_trace, recorder.spans)}
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0
