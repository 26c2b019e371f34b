"""The `.sosq` frame streamer: its writer and a ctypes reader over the C++
prefetcher (counterpart of `sosvo/data/native_loader.py`).

`sosvo_torch/csrc/seqloader.cpp` is host code: worker threads read and
zlib-decompress frames ahead of the consumer, so a live VO loop pays one
memcpy per frame. It is built at first use with `g++ -O2 -shared -fPIC ...
-lz -lpthread` into `build/` at the repository root, in a directory keyed
by a hash of the source and the flags; the library is written under a
temporary name and moved in place with `os.replace`, so processes that
build at once each load a whole library. A failed build raises with the
compiler's output; there is no Python reader to fall back to.

Format .sosq v1 (little-endian), the JAX package's:
  header:  u32 magic 'SOSQ' | u32 version=1 | u32 frames | u32 H | u32 W
           | u32 compressed
  table:   u64 offsets[frames + 1]   (byte offsets of each frame's stream)
  frames:  raw f32 or zlib streams (level 6), back to back
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

_MAGIC = 0x51534F53
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "seqloader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
LINK_FLAGS = ("-lz", "-lpthread")

_lib_handle: ctypes.CDLL | None = None


def library_path(root: Path = BUILD_ROOT) -> Path:
    """Where the library for the current source and flags lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(root) / f"seqloader-{h.hexdigest()[:16]}" / "libseqloader.so"


def build(root: Path = BUILD_ROOT) -> Path:
    """Compile the streamer if this hash has no library under `root` yet;
    return its path. Raises RuntimeError with g++'s output on failure."""
    so = library_path(root)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    r = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK_FLAGS],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)  # atomic: another process building at once never sees half a file
    return so


def load(root: Path = BUILD_ROOT) -> ctypes.CDLL:
    """Build if needed, open the library and declare its entry points' types."""
    lib = ctypes.CDLL(str(build(root)))
    lib.sosq_open.restype = ctypes.c_void_p
    lib.sosq_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for fn in (lib.sosq_frames, lib.sosq_height, lib.sosq_width):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.sosq_next.restype = ctypes.c_int
    lib.sosq_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.sosq_get.restype = ctypes.c_int
    lib.sosq_get.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    lib.sosq_close.restype = None
    lib.sosq_close.argtypes = [ctypes.c_void_p]
    return lib


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        _lib_handle = load()
    return _lib_handle


def write_sosq(path: str | Path, frames: np.ndarray, compressed: bool = True) -> None:
    """Write (F, H, W) float32 frames as a .sosq bundle (the JAX writer's bytes)."""
    frames = np.ascontiguousarray(frames, np.float32)
    f_count, h, w = frames.shape
    payloads = [zlib.compress(fr.tobytes(), 6) if compressed else fr.tobytes() for fr in frames]
    header = struct.pack("<6I", _MAGIC, 1, f_count, h, w, int(compressed))
    offsets = [len(header) + 8 * (f_count + 1)]
    for p in payloads:
        offsets.append(offsets[-1] + len(p))
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{f_count + 1}Q", *offsets))
        for p in payloads:
            f.write(p)


class SosqReader:
    """Streaming reader over the C++ prefetcher; each call returns a new
    (H, W) float32 array. `next` reads in order, `get` any frame (a jump
    restarts the prefetch window there); IOError on a file that does not
    open or a frame that does not decode."""

    def __init__(self, path: str | Path, readahead: int = 4):
        self._lib = _lib()
        self._h = self._lib.sosq_open(str(path).encode(), readahead)
        if not self._h:
            raise IOError(f"failed to open sosq file: {path}")
        self.frames = self._lib.sosq_frames(self._h)
        self.height = self._lib.sosq_height(self._h)
        self.width = self._lib.sosq_width(self._h)
        self._buf = np.empty((self.height, self.width), np.float32)
        self._ptr = self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def __len__(self) -> int:
        return self.frames

    def next(self) -> np.ndarray:
        rc = self._lib.sosq_next(self._h, self._ptr)
        if rc != 0:
            raise IOError(f"sosq_next failed: {rc}")
        return self._buf.copy()

    def get(self, idx: int) -> np.ndarray:
        rc = self._lib.sosq_get(self._h, idx, self._ptr)
        if rc != 0:
            raise IOError(f"sosq_get({idx}) failed: {rc}")
        return self._buf.copy()

    def close(self) -> None:
        if self._h:
            self._lib.sosq_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
