"""Start D rank processes on this host and collect what they return.

    python -m sosvo_torch.dist.launch --nproc 8 [--timeout S] -m MODULE ARGS...

Two forms share one mechanism:
  * `launch("package.module:function", D, kwargs)` runs
    `function(ranks, **kwargs)` in each rank (`ranks` from
    `mesh.init_process_group`) and returns the ranks' results in rank order,
    their tensors moved to the CPU;
  * `launch_module(module, argv, D)` (and the command line above) runs
    `python -m module argv` in each rank, as `torchrun` would, and returns
    each rank's exit code and output.
Each rank is a fresh interpreter (`python -m sosvo_torch.dist.launch
--rank-of DIR R`), started with RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE and SOSVO_DIST_INIT, a `file://` rendezvous in a temporary
directory of its own: no TCP port, so launches can run side by side. The
launch has a timeout and so has every collective. A rank that fails, or a
launch that outlives its timeout, kills every other rank and makes the
launch raise `LaunchError` with the failing ranks' error output.
"""

from __future__ import annotations

import argparse
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, NamedTuple

import torch

ROOT = Path(__file__).resolve().parents[2]


class LaunchError(RuntimeError):
    pass


class RankExit(NamedTuple):
    rank: int
    returncode: int
    stdout: str
    stderr: str


def _to_cpu(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def _env(tmp: Path, rank: int, world: int, extra: dict | None) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), SOSVO_DIST_INIT=f"file://{tmp / 'rendezvous'}")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    env.update(extra or {})
    return env


def _run(cmds: list[list[str]], tmp: Path, timeout_s: float, env: dict | None,
         ok_codes=(0,), grace_s: float = 10.0) -> list[RankExit]:
    """Start one process per command (rank = position), wait for all. A rank
    that exits with a code outside `ok_codes` ends the launch: the others
    get `grace_s` to exit, then are killed."""
    world = len(cmds)
    procs, files = [], []
    for r, cmd in enumerate(cmds):
        out = open(tmp / f"rank{r}.out", "w")
        err = open(tmp / f"rank{r}.err", "w")
        files += [out, err]
        procs.append(subprocess.Popen(cmd, stdout=out, stderr=err, cwd=ROOT,
                                      env=_env(tmp, r, world, env)))
    deadline = time.monotonic() + timeout_s
    failed_at, first_bad = None, []
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            now = time.monotonic()
            bad_now = [r for r, c in enumerate(codes) if c is not None and c not in ok_codes]
            if failed_at is None and bad_now:
                failed_at, first_bad = now, bad_now
            if now > deadline or (failed_at is not None and now > failed_at + grace_s):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for f in files:
            f.close()
    exits = [RankExit(r, p.returncode, (tmp / f"rank{r}.out").read_text(),
                      (tmp / f"rank{r}.err").read_text()) for r, p in enumerate(procs)]
    bad = [e for e in exits if e.returncode not in ok_codes]
    if bad:
        why = "timed out" if time.monotonic() > deadline else "failed"
        # Every failing rank's errors, those seen failing first first: when one
        # rank raises, its peers fail in the collective they were waiting in,
        # and which exit the poll sees first is a race.
        order = first_bad + [e.rank for e in bad if e.rank not in first_bad]
        errors = "".join(f"\n--- rank {r} ---\n{exits[r].stderr[-2000:]}" for r in order)
        raise LaunchError(f"launch of {world} ranks {why}: exit codes "
                          f"{[e.returncode for e in exits]}; errors:{errors}")
    return exits


def launch(target: str, world: int, kwargs: dict | None = None, timeout_s: float = 300.0,
           device: str | None = None, env: dict | None = None) -> list:
    """Run `target` ("package.module:function") as `function(ranks, **kwargs)`
    in `world` ranks on `device` (None: each rank's card); returns the
    results in rank order (tensors on the CPU)."""
    tmp = Path(tempfile.mkdtemp(prefix="sosvo_launch_"))
    try:
        torch.save({"target": target, "kwargs": kwargs or {}, "device": device,
                    "timeout_s": timeout_s}, tmp / "job.pt")
        cmd = [sys.executable, "-m", "sosvo_torch.dist.launch", "--rank-of", str(tmp)]
        _run([cmd] * world, tmp, timeout_s, env)
        return [torch.load(tmp / f"result{r}.pt", weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def launch_module(module: str, argv: list[str], world: int, timeout_s: float = 600.0,
                  ok_codes=(0,), env: dict | None = None) -> list[RankExit]:
    """Run `python -m module argv` in `world` ranks (as `torchrun` does, with
    a file rendezvous); returns each rank's exit code and output, or raises
    if a rank exits with a code outside `ok_codes` or the launch times out."""
    tmp = Path(tempfile.mkdtemp(prefix="sosvo_launch_"))
    try:
        return _run([[sys.executable, "-m", module, *argv]] * world, tmp, timeout_s, env,
                    ok_codes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(tmp: Path) -> int:
    """One rank of `launch`: start the group, run the target, save its result."""
    from sosvo_torch.dist import mesh

    job = torch.load(tmp / "job.pt", weights_only=False)
    rank = int(os.environ["RANK"])
    try:
        if job["device"] == "cpu":
            torch.set_num_threads(1)
        ranks = mesh.init_process_group(job["device"], timeout_s=job["timeout_s"])
        module, fn = job["target"].split(":")
        result = getattr(importlib.import_module(module), fn)(ranks, **job["kwargs"])
        torch.save(_to_cpu(result), tmp / f"result{rank}.pt")
        mesh.shutdown()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)  # no teardown: the other ranks may be blocked in a collective
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank-of", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=1800.0)
    cut = argv.index("-m") if "-m" in argv else len(argv)
    args = ap.parse_args(argv[:cut])
    if args.rank_of is not None:
        return _rank_main(Path(args.rank_of))
    if cut + 1 >= len(argv):
        ap.error("-m MODULE is required")
    exits = launch_module(argv[cut + 1], argv[cut + 2:], args.nproc, args.timeout)
    sys.stdout.write(exits[0].stdout)  # rank 0 speaks for the launch
    sys.stderr.write(exits[0].stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
