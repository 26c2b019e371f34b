"""The port's capture stager (`sosvo_torch.tools.stage_sequence`) against
the JAX package's `scripts/stage_sequence.py` on the same captures.

Captures: PNG frames (grey and one RGB, 140x120, so cropped) with a TUM
ground truth of one row per frame; PGM frames (binary P5 and ASCII P2 at
maxval 255, one 16-bit P5 that Pillow reads for both tools) with a longer
TUM file (nearest-time association) and `--stride 2`. Held: with and
without a resize, both tools write equal `.npz` arrays (frames, poses,
timestamps) and equal `.sosq` bytes. Without Pillow, the port stages 8-bit
PGM frames at their own size to the same output and exits 1 naming Pillow
where a frame or a resize needs it.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from sosvo.data.sequence import save_tum_trajectory
from sosvo.synth.scene import make_trajectory
from sosvo_torch.tools import stage_sequence

ROOT = Path(__file__).resolve().parents[1]
F = 5


def _jax_stager():
    spec = importlib.util.spec_from_file_location("jax_stage_sequence",
                                                  ROOT / "scripts" / "stage_sequence.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pgm(path: Path, im: np.ndarray, ascii_: bool = False, maxval: int = 255) -> None:
    h, w = im.shape
    if ascii_:
        rows = "\n".join(" ".join(str(int(v)) for v in r) for r in im)
        path.write_text(f"P2\n# an ASCII frame\n{w} {h}\n{maxval}\n{rows}\n")
    else:
        dt = ">u2" if maxval > 255 else np.uint8
        path.write_bytes(f"P5\n{w} {h}\n{maxval}\n".encode() + im.astype(dt).tobytes())


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    from PIL import Image

    rng = np.random.default_rng(0)
    png = tmp_path_factory.mktemp("png_capture")
    for i in range(F):
        im = rng.integers(0, 256, (120, 140), dtype=np.uint8)
        if i == 2:
            Image.fromarray(np.stack([im, im[::-1], 255 - im], -1)).save(png / f"f_{i:03d}.png")
        else:
            Image.fromarray(im).save(png / f"f_{i:03d}.png")
    save_tum_trajectory(png / "gt.txt", np.asarray(make_trajectory(F, radius=0.4)))

    pgm = tmp_path_factory.mktemp("pgm_capture")
    for i in range(2 * F):
        im = rng.integers(0, 256, (100, 100))
        if i == 3:
            _pgm(pgm / f"f_{i:03d}.pgm", im, ascii_=True)
        elif i == 6:
            _pgm(pgm / f"f_{i:03d}.pgm", rng.integers(0, 65536, (100, 100)), maxval=65535)
        else:
            _pgm(pgm / f"f_{i:03d}.pgm", im)
    poses = np.asarray(make_trajectory(3 * F, radius=0.4))
    save_tum_trajectory(pgm / "gt.txt", poses, timestamps=np.arange(3 * F) * 0.7)

    p8 = tmp_path_factory.mktemp("pgm8_capture")  # 8-bit PGM only
    for i in range(F):
        _pgm(p8 / f"f_{i:03d}.pgm", rng.integers(0, 256, (96, 96)), ascii_=i == 1)
    return {"png": png, "pgm": pgm, "pgm8": p8}


def _stage(main, capture: Path, out: Path, extra) -> int:
    return main([str(capture), str(out / "seq.npz"), "--sosq", str(out / "seq.sosq"), *extra])


CASES = {"png_crop": ("png", ["--size", "120", "--gt"]),
         "png_resize": ("png", ["--size", "96", "--gt"]),
         "pgm_as_is": ("pgm", ["--size", "0", "--stride", "2", "--gt"]),
         "pgm_resize": ("pgm", ["--size", "64", "--stride", "2", "--gt"])}


@pytest.mark.parametrize("case", list(CASES))
def test_stager_output_equals_reference(tmp_path, captures, case):
    name, extra = CASES[case]
    if extra[-1] == "--gt":
        extra = [*extra, str(captures[name] / "gt.txt")]
    outs = {}
    for tool, main in (("jax", _jax_stager().main), ("torch", stage_sequence.main)):
        outs[tool] = tmp_path / tool
        outs[tool].mkdir()
        assert _stage(main, captures[name], outs[tool], extra) == 0
    with np.load(outs["jax"] / "seq.npz") as a, np.load(outs["torch"] / "seq.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["images", "poses", "timestamps"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        assert b["images"].shape[0] == F
    assert (outs["jax"] / "seq.sosq").read_bytes() == (outs["torch"] / "seq.sosq").read_bytes()


def test_without_pillow(tmp_path, captures, monkeypatch, capsys):
    ref = tmp_path / "jax"
    ref.mkdir()
    assert _stage(_jax_stager().main, captures["pgm8"], ref, ["--size", "0"]) == 0
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    got = tmp_path / "torch"
    got.mkdir()
    assert _stage(stage_sequence.main, captures["pgm8"], got, ["--size", "0"]) == 0
    with np.load(ref / "seq.npz") as a, np.load(got / "seq.npz") as b:
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    assert (ref / "seq.sosq").read_bytes() == (got / "seq.sosq").read_bytes()
    capsys.readouterr()
    for capture, extra in (("pgm8", ["--size", "64"]), ("png", ["--size", "120"]),
                           ("pgm", ["--size", "0"])):
        assert _stage(stage_sequence.main, captures[capture], tmp_path, extra) == 1
        assert "Pillow" in capsys.readouterr().err
    assert not (tmp_path / "seq.npz").exists()
