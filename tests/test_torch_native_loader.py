"""The port's .sosq streamer (`sosvo_torch.data.native_loader` over
`sosvo_torch/csrc/seqloader.cpp`) against the JAX package's format.

Held: the port's writer gives the JAX writer's bytes, compressed and raw
(the JAX writer is pure Python: nothing of its native library is built or
loaded here); the port's reader reads a JAX-written file in order with
readahead 1 to 4, by random access and seeking backwards, and raises
IOError on a missing or truncated file; two processes that build the
library into one empty directory at once both load a whole library.
The port's library lives under the repository's `build/` (or the
directory a test names); nothing here touches `native/`.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sosvo.data.native_loader import write_sosq as jax_write_sosq
from sosvo_torch.data import native_loader
from sosvo_torch.data.native_loader import SosqReader, write_sosq

ROOT = Path(__file__).resolve().parents[1]


def _frames(f=12, h=32, w=48, seed=0):
    return np.random.default_rng(seed).random((f, h, w)).astype(np.float32)


@pytest.mark.parametrize("compressed", [True, False], ids=["zlib", "raw"])
def test_writer_bytes_equal_reference(tmp_path, compressed):
    frames = _frames()
    jax_write_sosq(tmp_path / "jax.sosq", frames, compressed=compressed)
    write_sosq(tmp_path / "torch.sosq", frames, compressed=compressed)
    assert (tmp_path / "jax.sosq").read_bytes() == (tmp_path / "torch.sosq").read_bytes()


@pytest.mark.parametrize("readahead", [1, 2, 3, 4])
def test_reader_reads_reference_file_in_order(tmp_path, readahead):
    frames = _frames(seed=readahead)
    p = tmp_path / "seq.sosq"
    jax_write_sosq(p, frames, compressed=readahead % 2 == 1)
    with SosqReader(p, readahead=readahead) as r:
        assert (len(r), r.height, r.width) == (12, 32, 48)
        for i in range(len(r)):
            np.testing.assert_array_equal(r.next(), frames[i])
        with pytest.raises(IOError):
            r.next()  # past the end


@pytest.mark.parametrize("compressed", [True, False], ids=["zlib", "raw"])
def test_reader_random_access_and_seek_back(tmp_path, compressed):
    frames = _frames(f=9)
    p = tmp_path / "seq.sosq"
    jax_write_sosq(p, frames, compressed=compressed)
    with SosqReader(p, readahead=2) as r:
        np.testing.assert_array_equal(r.get(5), frames[5])
        np.testing.assert_array_equal(r.get(1), frames[1])  # backwards
        np.testing.assert_array_equal(r.next(), frames[2])  # resumes after 1
        np.testing.assert_array_equal(r.get(8), frames[8])  # past the window
        np.testing.assert_array_equal(r.get(0), frames[0])
        with pytest.raises(IOError):
            r.get(9)


@pytest.mark.parametrize("cut", ["frames", "table", "header"])
def test_reader_raises_on_truncated_file(tmp_path, cut):
    frames = _frames(f=4)
    p = tmp_path / "seq.sosq"
    jax_write_sosq(p, frames)
    data = p.read_bytes()
    keep = {"frames": len(data) - 100, "table": 24 + 8, "header": 10}[cut]
    p.write_bytes(data[:keep])
    if cut != "frames":
        with pytest.raises(IOError):
            SosqReader(p)
        return
    with SosqReader(p) as r:
        for i in range(3):
            np.testing.assert_array_equal(r.next(), frames[i])
        with pytest.raises(IOError):
            r.next()  # the last frame's stream is cut


def test_reader_raises_on_missing_file(tmp_path):
    with pytest.raises(IOError):
        SosqReader(tmp_path / "absent.sosq")


BUILD_AND_READ = """
import sys
import numpy as np
from pathlib import Path
from sosvo_torch.data import native_loader
lib = native_loader.load(Path(sys.argv[1]))
h = lib.sosq_open(sys.argv[2].encode(), 2)
assert h, "open failed"
buf = np.empty((32, 48), np.float32)
import ctypes
assert lib.sosq_next(h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) == 0
lib.sosq_close(h)
print(float(buf.sum()))
"""


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    frames = _frames()
    write_sosq(tmp_path / "seq.sosq", frames)
    root = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_READ, str(root),
                               str(tmp_path / "seq.sosq")], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert float(out) == pytest.approx(float(frames[0].sum()), rel=1e-6)
    so = native_loader.library_path(root)
    assert so.exists() and [x.name for x in so.parent.iterdir()] == [so.name]  # no temp left


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native_loader.build(tmp_path / "build")
    assert not native_loader.library_path(tmp_path / "build").exists()
