"""Live VO over a stream of frames (counterpart of `sosvo/vo/live.py`).

Replay (`run_replay_images*`) takes a staged sequence; live mode takes
frames one at a time from any iterable of (H, W) float32 host arrays, such
as `data/native_loader.py:SosqReader`, whose C++ threads decode ahead of
the loop. Each frame is copied into one of two pinned host buffers (taken
in turns, each refilled only once its last copy has finished) and uploaded
with `non_blocking=True`, then goes through the same per-frame step as the
replays: `image_step` (frame to frame) or `image_step_ba` (keyframe map and
window BA, with the host's frame and keyframe counters). Both functions yield
`(idx, output)` one frame late, as the reference does: frame t's output is
waited for (a CUDA event recorded after its step) once frame t+1's step has
been issued, so the host's decode and upload of the next frame overlap the
device's work. The step's own host reads (the lazy gate, relocalisation's
predicate) still synchronise inside it, as in the replays.

Random draws: a `torch.Generator` (the replays' and the command line's
stream; seeded 0 where neither it nor a key is given), or `key`, a JAX key
pair (`tools/reference_draws.py:prng_key`), for the JAX package's own draws
frame after frame, so a live run compares with the JAX package's.

Spans (`utils/spans.py`): the request span `live.frame` (`frame=idx`)
from when a frame is taken off the stream to when its output is yielded;
`frame` (`frame=idx`) around its upload (`live.upload`, whose wait for a
buffer's last copy counts as `sync.live_upload`), its draws (`live.draws`,
with a key) and its step; `live.wait` (`sync.live_wait`) around the wait
for its event.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from sosvo_torch.frontend.image_frontend import FrontendLUTs, build_frontend_luts
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.tools.reference_draws import Key, frame_draws
from sosvo_torch.utils import spans
from sosvo_torch.utils.config import PipelineConfig
from sosvo_torch.utils.device import resolve
from sosvo_torch.vo.ba_pipeline import BAStepOutput, init_ba_state
from sosvo_torch.vo.image_pipeline import image_step, image_step_ba
from sosvo_torch.vo.state import StepOutput, init_track_state


class _Uploader:
    """Host frames -> f32 tensors on `device`. On a card: two pinned host
    buffers in turns, each copy non-blocking; a buffer is refilled only
    after the event recorded behind its last copy. Elsewhere: a copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self.bufs: list[torch.Tensor | None] = [None, None]
        self.copied: list[torch.cuda.Event | None] = [None, None]
        self.turn = 0

    def __call__(self, frame) -> torch.Tensor:
        arr = np.asarray(frame, np.float32)
        if self.device.type != "cuda":
            return torch.tensor(arr, device=self.device)
        i, self.turn = self.turn, self.turn ^ 1
        if self.bufs[i] is None or tuple(self.bufs[i].shape) != arr.shape:
            self.bufs[i] = torch.empty(arr.shape, dtype=torch.float32, pin_memory=True)
        elif self.copied[i] is not None:
            spans.count("sync.live_upload")
            self.copied[i].synchronize()
        self.bufs[i].numpy()[...] = arr
        img = self.bufs[i].to(self.device, non_blocking=True)
        self.copied[i] = torch.cuda.Event()
        self.copied[i].record()
        return img


def _draw_source(cfg: PipelineConfig, key: Key | None, device, reloc: bool):
    """A function giving each frame's `StepDraws`: None (the state's
    generator draws) without a key, else the JAX package's draws."""
    if key is None:
        return lambda: None
    state = [key]

    def draws():
        state[0], d = frame_draws(state[0], cfg.ransac.n_hyps, cfg.frontend.max_features, device,
                                  cfg.ba.max_landmarks if reloc else None)
        return d
    return draws


def _generator(generator: torch.Generator | None, key: Key | None, device) -> torch.Generator:
    if generator is not None and key is not None:
        raise ValueError("pass a generator or a key, not both")
    return generator if generator is not None else torch.Generator(device=device).manual_seed(0)


def _live(step, frames: Iterable, device: torch.device, on_frame) -> Iterator[tuple[int, object]]:
    """Issue `step(idx, image)` frame after frame; yield each output one
    frame late, after waiting for the event recorded behind its step."""
    upload = _Uploader(device)
    pending = None

    def finish(p):
        idx, out, done = p
        if done is not None:
            with spans.span("live.wait", frame=idx):
                spans.count("sync.live_wait")
                done.synchronize()
        if on_frame is not None:
            on_frame(idx, out)
        spans.end("live.frame", idx)
        return idx, out

    for idx, frame in enumerate(frames):
        spans.begin("live.frame", idx)
        with spans.span("frame", frame=idx):
            with spans.span("live.upload"):
                img = upload(frame)
            out = step(idx, img)
            done = None
            if device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        if pending is not None:
            yield finish(pending)
        pending = (idx, out, done)
    if pending is not None:
        yield finish(pending)


def live_vo(rig: OmnistereoRig, cfg: PipelineConfig, frames: Iterable[np.ndarray],
            generator: torch.Generator | None = None, key: Key | None = None,
            luts: FrontendLUTs | None = None,
            on_frame: Callable[[int, StepOutput], None] | None = None,
            device: torch.device | str | None = None) -> Iterator[tuple[int, StepOutput]]:
    """Frame-to-frame VO over a stream of raw omni frames on `device` (the
    card where None; the rig and LUTs must be there), from the identity
    pose; yields (idx, StepOutput) one frame late."""
    device = torch.device(resolve(device))
    luts = build_frontend_luts(rig, cfg.frontend) if luts is None else luts
    draws = _draw_source(cfg, key, device, reloc=False)
    state = init_track_state(cfg.frontend.max_features, _generator(generator, key, device),
                             device=device, descriptor=cfg.frontend.descriptor)

    def step(idx, img):
        nonlocal state
        with spans.span("live.draws"):
            d = draws()
        state, out = image_step(rig, luts, cfg, state, img, d)
        return out
    yield from _live(step, frames, device, on_frame)


def live_vo_ba(rig: OmnistereoRig, cfg: PipelineConfig, frames: Iterable[np.ndarray],
               generator: torch.Generator | None = None, key: Key | None = None,
               luts: FrontendLUTs | None = None, T0=None,
               on_frame: Callable[[int, BAStepOutput], None] | None = None,
               device: torch.device | str | None = None) -> Iterator[tuple[int, BAStepOutput]]:
    """Live VO with the keyframe map and window BA (`image_step_ba`), as
    `live_vo` but from `T0` (identity where None); the frame and keyframe
    counters stay on the host. On the same frames, draws and first pose it
    gives `run_replay_images_ba`'s outputs."""
    device = torch.device(resolve(device))
    luts = build_frontend_luts(rig, cfg.frontend) if luts is None else luts
    draws = _draw_source(cfg, key, device, reloc=True)
    state = init_ba_state(cfg, _generator(generator, key, device),
                          T0=None if T0 is None else torch.as_tensor(T0, dtype=torch.float32),
                          device=device)
    n_kf = 0

    def step(idx, img):
        nonlocal state, n_kf
        with spans.span("live.draws"):
            d = draws()
        state, out, n_kf = image_step_ba(rig, luts, cfg, state, img, idx, n_kf, d)
        return out
    yield from _live(step, frames, device, on_frame)
