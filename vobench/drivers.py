"""The general traffic generator: one driver per kind of traffic.

A traffic file (`vobench/traffic/<name>.json`) names its driver and its
parameters; a driver warms the program up on the cell's own shapes, then
runs the measured window and returns what happened in it. Every frame of a
window comes from the run's inputs (`inputs.py`), so two runs with one seed
do the same work.

`replay`: each pass is the command line's composition of an image-mode
window-BA replay, `run_replay_images_ba`'s two calls (extract every frame,
then the keyframed BA replay, whole) followed, where the configuration has
a pose graph, by the loop leg over the replay's own keyframes. Each pass
starts from fresh generators seeded from the run's seed, and the step draws
from them when it needs a matrix, as the command line runs. A pass is not
started when the last pass's time says it cannot end inside the window; one
that still ends after it is waited for and not counted.

`live`: sessions of `live_vo_ba` from frame 0 over host float32 frames, back
to back; the harness stops taking outputs when the window ends, and counts
the frames whose output arrived inside it. The card's copy of the frames is
let go before the window.

A driver is built as `Driver(program, inputs, config)`. Its `inp` is the
inputs as it holds them, its `reference_draws(inputs, config, device)` the
draws the reference replays with in its place (None: the reference draws
from `inputs.generators`, as the program did), `LEG` whether its passes run
the loop leg where the configuration has one, `warm(n_frames)` its warm-up
on the cell's own shapes, `window(seconds, on_start)` the measured window
(a `Window`), and `one_pass()` one whole pass or session (a `PassOut`).

`replay` and `live` are `DRIVERS` here. Traffic that needs another driver
brings it as a new file, `vobench/traffic/<driver>.py`, whose `Driver`
class keeps this contract (`harness.load_driver`).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from vobench import inputs as inputs_mod


class PassOut(NamedTuple):
    """What one pass or session produced: per-frame poses and pose_ok (a
    prefix of the sequence where a session was cut), and the loop leg's."""

    T_world: torch.Tensor
    pose_ok: torch.Tensor
    T_corrected: torch.Tensor | None = None
    n_loops: torch.Tensor | None = None


class Window(NamedTuple):
    start: float              # perf_counter at the first timed frame
    pass_s: list              # seconds of each pass or session run in the window
    frames: int               # frames counted by the end-to-end metric
    measured_s: float         # the time those frames are counted over
    frames_processed: int     # frames the program took in the window, counted or not
    outputs: list             # PassOut of every pass or session run in the window
    latencies_s: list         # per delivered frame (live)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


WARM_PAIRS = 2  # loop pairs of the warm-up's leg: every code path of a pair, and PGO


class Replay:
    """Whole passes of the recorded sequence, images on the card."""

    LEG = True

    def __init__(self, program, inputs, config: dict):
        self.p, self.inp = program, inputs
        self.leg = config.get("loop_leg") if config["pipeline"].get("pose_graph") else None

    @staticmethod
    def reference_draws(inputs, config: dict, device):
        return None

    def one_pass(self, n_frames: int | None = None) -> PassOut:
        p, inp = self.p, self.inp
        n = inp.images.shape[0] if n_frames is None else n_frames
        state_gen, loop_gen = inputs_mod.generators(inp.seed, p.device)
        state = p.init_state(inp.poses[0], state_gen)
        obs = p.extract_sequence(inp.images[:n])
        _, out = p.run_replay_ba(state, obs)
        T, ok = out.vo.T_world, out.vo.pose_ok
        if self.leg is None:
            return PassOut(T, ok)
        kf_idx = torch.nonzero(out.is_keyframe).flatten().cpu().numpy()
        lc = p.close_loops(obs, T, kf_idx, self.leg, loop_gen,
                           max_candidates=None if n_frames is None else WARM_PAIRS)
        return PassOut(T, ok, lc.T_corrected, lc.n_loops)

    def warm(self, n_frames: int) -> None:
        """A short pass over the first frames: every per-frame shape, window
        solves and, with a leg, a leg over WARM_PAIRS candidate pairs."""
        self.one_pass(min(n_frames, self.inp.images.shape[0]))
        _sync(self.p.device)

    def window(self, seconds: float, on_start) -> Window:
        device = self.p.device
        n = self.inp.images.shape[0]
        start = time.perf_counter()
        on_start()
        end_at = start + seconds
        outputs, lengths, counted, last_end = [], [], 0, start
        t = start
        while t < end_at and (not lengths or t + lengths[-1] <= end_at):
            outputs.append(self.one_pass())
            _sync(device)
            t_end = time.perf_counter()
            lengths.append(t_end - t)
            if t_end <= end_at:
                counted += 1
                last_end = t_end
            t = t_end
        return Window(start, lengths, counted * n, last_end - start, len(outputs) * n, outputs,
                      [])


class Live:
    """Sessions of `live_vo_ba` over frames in host memory, which
    makes each frame's draws from the run's key itself."""

    LEG = False

    def __init__(self, program, inputs, config: dict):
        self.p = program
        self.inp = inputs._replace(images=inputs.images.cpu())
        self.frames = list(self.inp.images.numpy())

    @staticmethod
    def reference_draws(inputs, config: dict, device):
        return inputs_mod.key_draws(inputs, config, device)

    def _session(self, frames, handed: list):
        def feed():
            for f in frames:
                handed.append(time.perf_counter())
                yield f
        return self.p.live_vo_ba(feed(), inputs_mod.seed_key(self.inp.seed), self.inp.poses[0])

    def one_pass(self, n_frames: int | None = None) -> PassOut:
        """One whole session (the first `n_frames` frames where given)."""
        frames = self.frames if n_frames is None else self.frames[:n_frames]
        outs = [out for _, out in self._session(frames, [])]
        return PassOut(torch.stack([o.vo.T_world for o in outs]),
                       torch.stack([o.vo.pose_ok for o in outs]))

    def warm(self, n_frames: int) -> None:
        self.one_pass(n_frames)
        _sync(self.p.device)

    def window(self, seconds: float, on_start) -> Window:
        device = self.p.device
        start = time.perf_counter()
        on_start()
        end_at = start + seconds
        outputs, lengths, latencies, delivered, handed_total = [], [], [], 0, 0
        while (t0 := time.perf_counter()) < end_at:
            handed: list[float] = []
            Ts, oks = [], []
            session = self._session(self.frames, handed)
            for idx, out in session:
                t = time.perf_counter()
                if t > end_at:
                    break
                latencies.append(t - handed[idx])
                Ts.append(out.vo.T_world)
                oks.append(out.vo.pose_ok)
            session.close()
            lengths.append(time.perf_counter() - t0)
            handed_total += len(handed)
            delivered += len(Ts)
            if Ts:
                outputs.append(PassOut(torch.stack(Ts), torch.stack(oks)))
        _sync(device)
        return Window(start, lengths, delivered, end_at - start, handed_total, outputs, latencies)


DRIVERS = {"replay": Replay, "live": Live}
