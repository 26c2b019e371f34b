"""Build the package's CUDA sources into one shared library and load it.

The sources under `sosvo_torch/csrc/` are compiled at first use with `nvcc`
for Hopper (`sm_90a`) into `build/` at the repository root, in a directory
keyed by a hash of the sources and flags, so a fresh checkout builds once and
an edited source rebuilds. The library has a plain C interface and is loaded
with `ctypes`; nothing here includes PyTorch's headers, so a build takes
seconds. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
LIB_NAME = "sosvo_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

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

    The compiler's output (register and shared-memory use per kernel, from
    -Xptxas=-v) is kept beside the library as build.log.
    """
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    (so.parent / "build.log").write_text(log)
    os.replace(tmp, so)  # atomic: a concurrent builder never sees half a file
    return so


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every C entry point's types."""
    global _loaded
    if _loaded is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sosvo_match_hamming.argtypes = [p, p, p, p, p, p, i, i, f, p, p, p, p, p]
        lib.sosvo_match_hamming.restype = i
        _loaded = lib
    return _loaded


def build_log() -> str:
    log = library_path().parent / "build.log"
    return log.read_text() if log.exists() else ""
