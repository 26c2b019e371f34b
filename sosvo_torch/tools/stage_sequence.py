"""Stage a capture (a folder of image files) into a replayable bundle
(counterpart of `scripts/stage_sequence.py`, with its flags and output).

    python -m sosvo_torch.tools.stage_sequence CAPTURE_DIR out.npz \
        [--gt groundtruth.txt] [--sosq out.sosq] [--size 768] [--stride 1]

  - CAPTURE_DIR: .png/.jpg/.jpeg/.bmp/.pgm frames, sorted by file name
    (zero-padded frame numbers recommended), every `--stride`-th taken.
  - --gt: a TUM trajectory (`t tx ty tz qx qy qz qw`), strided as the
    frames; row i goes to frame i when the counts agree, else each frame
    takes the row nearest its index in time.
  - --size: centre-crop to a square and scale to SIZE x SIZE (0 = keep
    as is, which needs square frames). Frames become float32 grey in [0, 1].
  - --sosq: also write the frames as a .sosq stream (`data/native_loader.py`).

8-bit PGM files (binary P5 or ASCII P2, maxval 255) are read by this
module's own parser. Other files, other PGM depths and any resize go
through Pillow, as the JAX script reads them; where Pillow is not
installed the tool exits 1 naming it, and skips no frame. On the same
capture both tools write the same `.npz` arrays and `.sosq` bytes.

Replay the result on the card (or add `--device cpu`):
    python -m sosvo_torch.cli --config configs/c2_chip_ba.json \
        --sequence out.npz [--rig calib.json]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".pgm"}
_SPACE = b" \t\n\r\v\f"


class MissingPackage(RuntimeError):
    pass


def _pil():
    """PIL.Image, or MissingPackage naming Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise MissingPackage("this capture needs the Pillow package (PIL), which is not "
                             "installed: only 8-bit PGM frames (P5/P2, maxval 255) are read "
                             "without it, and only at their own size") from e
    return Image


def _tokens(data: bytes, pos: int, n: int) -> tuple[list[bytes], int]:
    """`n` whitespace-separated tokens from `pos` ('#' comments run to the
    end of their line); returns them and the position just after the last."""
    out = []
    while len(out) < n:
        while pos < len(data) and data[pos] in _SPACE:
            pos += 1
        if pos < len(data) and data[pos] == ord("#"):
            while pos < len(data) and data[pos] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos] not in _SPACE and data[pos] != ord("#"):
            pos += 1
        if start == pos:
            raise ValueError("truncated PGM header")
        out.append(data[start:pos])
    return out, pos


def read_pgm(path: Path) -> np.ndarray | None:
    """An 8-bit PGM (P5 or P2, maxval 255) as (H, W) uint8; None for
    another maxval (Pillow's to read)."""
    data = path.read_bytes()
    (magic, w, h, maxval), pos = _tokens(data, 0, 4)
    if magic not in (b"P5", b"P2"):
        raise ValueError(f"{path.name}: not a PGM file (magic {magic!r})")
    w, h, maxval = int(w), int(h), int(maxval)
    if maxval != 255:
        return None
    if magic == b"P5":
        raster = np.frombuffer(data, np.uint8, count=w * h, offset=pos + 1)  # one whitespace byte
    else:
        values, _ = _tokens(data, pos, w * h)
        raster = np.array([int(v) for v in values], np.int64)
        if raster.min() < 0 or raster.max() > maxval:
            raise ValueError(f"{path.name}: a value outside 0..{maxval}")
    return raster.astype(np.uint8).reshape(h, w)


def load_frame(path: Path, size: int) -> np.ndarray:
    """One image file -> (size, size) float32 grey in [0, 1] (`size` 0: as is)."""
    grey = read_pgm(path) if path.suffix.lower() == ".pgm" else None
    if grey is None:
        grey = np.asarray(_pil().open(path).convert("L"))
    h, w = grey.shape
    if size:
        side = min(w, h)
        grey = grey[(h - side) // 2:(h + side) // 2, (w - side) // 2:(w + side) // 2]
        if side != size:
            Image = _pil()
            grey = np.asarray(Image.fromarray(np.ascontiguousarray(grey)).resize(
                (size, size), Image.BILINEAR))
    elif w != h:
        raise ValueError(f"{path.name}: non-square {w}x{h}; pass --size to crop")
    return np.asarray(grey, np.float32) / 255.0


def main(argv=None) -> int:
    from sosvo_torch.data.native_loader import write_sosq
    from sosvo_torch.data.sequence import load_tum_trajectory, save_sequence

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("capture_dir")
    ap.add_argument("out", help="output .npz bundle")
    ap.add_argument("--gt", default=None, help="TUM-format ground-truth file")
    ap.add_argument("--sosq", default=None, help="also write a .sosq stream")
    ap.add_argument("--size", type=int, default=768,
                    help="square output side (0 = keep original)")
    ap.add_argument("--stride", type=int, default=1, help="take every Nth frame")
    args = ap.parse_args(argv)

    files = sorted(p for p in Path(args.capture_dir).iterdir()
                   if p.suffix.lower() in EXTS)[::args.stride]
    if not files:
        print(f"no image files in {args.capture_dir}", file=sys.stderr)
        return 1
    try:
        frames = np.stack([load_frame(p, args.size) for p in files])
    except MissingPackage as e:
        print(f"stage_sequence: {e}", file=sys.stderr)
        return 1
    ts = np.arange(len(files), dtype=np.float64)

    poses = None
    if args.gt:
        gt_ts, gt_poses = load_tum_trajectory(args.gt)
        gt_poses, gt_ts = gt_poses[::args.stride], gt_ts[::args.stride]
        if len(gt_poses) == len(frames):
            poses, ts = gt_poses, gt_ts
        else:  # nearest-neighbour timestamp association
            poses = gt_poses[np.abs(gt_ts[None, :] - ts[:, None]).argmin(axis=1)]

    save_sequence(args.out, images=frames, poses=poses, timestamps=ts)
    if args.sosq:
        write_sosq(args.sosq, frames)
    print(f"staged {len(frames)} frames {frames.shape[1]}x{frames.shape[2]} "
          f"-> {args.out}" + (f" + {args.sosq}" if args.sosq else "")
          + (" (with ground truth)" if poses is not None else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
