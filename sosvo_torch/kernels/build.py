"""Build the package's CUDA sources into one shared library and load it.

The sources under `sosvo_torch/csrc/` are compiled at first use with `nvcc`
for Hopper (`sm_90a`) into `build/` at the repository root, in a directory
keyed by a hash of the sources and flags, so a fresh checkout builds once and
an edited source rebuilds. Each `.cu` file is compiled by its own `nvcc`,
all started together, and the objects are linked into one library. The
library has a plain C interface and is loaded with `ctypes`; nothing here
includes PyTorch's headers, so a build takes seconds. A failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
LIB_NAME = "sosvo_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / f"{LIB_NAME}-{h.hexdigest()[:16]}" / f"lib{LIB_NAME}.so"


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path.

    The compilers' output (register and shared-memory use per kernel, from
    -Xptxas=-v) is kept beside the library as build.log.
    """
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = []
    log, failed = "", []
    try:
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = so.parent / f".{src.stem}.{tag}.o"
            jobs.append((obj, subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                                str(src)], stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        for obj, proc in jobs:
            log += proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(proc.returncode)
    finally:
        # Every nvcc started is waited for, also when starting or reading
        # one raised: none outlives the build.
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    tmp = so.with_name(f".{so.name}.{tag}")
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(o) for o, _ in jobs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        failed += [link.returncode] if link.returncode != 0 else []
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {failed[0]}):\n{log}")
    (so.parent / "build.log").write_text(log)
    os.replace(tmp, so)  # atomic: a concurrent builder never sees half a file
    return so


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every C entry point's types."""
    global _loaded
    if _loaded is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.sosvo_match_hamming.argtypes = [p, p, p, p, p, p, i, i, f, p, p, p, p, p, p, p, p]
        lib.sosvo_match_hamming.restype = i
        lib.sosvo_match_grid.argtypes = [i, i, ctypes.POINTER(i)]
        lib.sosvo_match_grid.restype = i
        for name in ("sosvo_schur_cluster_size", "sosvo_schur_resident_clusters"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.sosvo_schur_reduce.argtypes = [p, ll, ll, p, p, p, p, p, f, i, i, i, i, i, i, i,
                                           p, p, p, p, p, p, p, p]
        lib.sosvo_schur_reduce.restype = i
        lib.sosvo_empty_kernel.argtypes = [p]
        lib.sosvo_empty_kernel.restype = i
        lib.sosvo_mma_rate.argtypes = [i, i, i, p, p]
        lib.sosvo_mma_rate.restype = i
        lib.sosvo_mma_rate_ops.argtypes = [i, i, i]
        lib.sosvo_mma_rate_ops.restype = ctypes.c_double
        lib.sosvo_ticket_kernel.argtypes = [i, i, p, p]
        lib.sosvo_ticket_kernel.restype = i
        lib.sosvo_cluster_kernel.argtypes = [i, i, p]
        lib.sosvo_cluster_kernel.restype = i
        _loaded = lib
    return _loaded


def build_log() -> str:
    log = library_path().parent / "build.log"
    return log.read_text() if log.exists() else ""


# The raw handle of a device's current stream and the current device index,
# by PyTorch's own C entry points (what its generated kernels use), which
# cost a fraction of torch.cuda.current_stream(...).cuda_stream and
# torch.cuda.current_device() on the host.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
_current_device = getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device


def stream_of(device: torch.device) -> int:
    """The raw handle of `device`'s current stream, for the C launchers."""
    return _raw_stream(device.index)


def launch(device: torch.device, fn, *args) -> int:
    """`fn(*args)`, a C launcher, with `device` current: the runtime launches
    on the current device, so another device is made current for the call."""
    if device.index == _current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)
