"""Image-mode VO: raw omni images -> frontend -> the observation-mode core
(counterpart of `sosvo/vo/image_pipeline.py`; configs c2 and c3 in
`"mode": "images"`).

The reference's `jax.lax.optimization_barrier` between the frontend and the
step is an XLA scheduling hint with no eager counterpart, and is dropped.
`run_replay_images_ba` is the keyframed window-BA replay of raw images that
`sosvo/cli.py` composes from `extract_observations` and `run_replay_ba`.
"""

from __future__ import annotations

import torch

from sosvo_torch.frontend.image_frontend import (FrontendLUTs, build_frontend_luts,
                                                 extract_observations, extract_sequence)
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.utils.config import PipelineConfig
from sosvo_torch.vo.ba_pipeline import BAState, BAStepOutput, run_replay_ba, step_ba
from sosvo_torch.vo.pipeline import StepDraws, run_replay, step
from sosvo_torch.vo.state import StepOutput, TrackState


def image_step(rig: OmnistereoRig, luts: FrontendLUTs, cfg: PipelineConfig, state: TrackState,
               image: torch.Tensor, draws: StepDraws | None = None
               ) -> tuple[TrackState, StepOutput]:
    """One frame-to-frame VO frame from a raw omni image."""
    return step(rig, cfg, state, extract_observations(rig, luts, cfg.frontend, image), draws)


def image_step_ba(rig: OmnistereoRig, luts: FrontendLUTs, cfg: PipelineConfig, state: BAState,
                  image: torch.Tensor, frame: int, n_kf: int, draws: StepDraws | None = None
                  ) -> tuple[BAState, BAStepOutput, int]:
    """One keyframed window-BA frame from a raw omni image; `frame` and
    `n_kf` are the host's counters, as for `step_ba`."""
    return step_ba(rig, cfg, state, extract_observations(rig, luts, cfg.frontend, image),
                   frame, n_kf, draws)


def run_replay_images(rig: OmnistereoRig, cfg: PipelineConfig, state: TrackState,
                      images: torch.Tensor, luts: FrontendLUTs | None = None,
                      split: bool = True, draws: StepDraws | None = None
                      ) -> tuple[TrackState, StepOutput]:
    """Replay (F, H, W) raw images frame to frame; outputs stacked per frame.

    `split=True`: extract every frame first, then replay the observations.
    `split=False`: extract and step frame by frame (no stacked observations).
    Both give the same result."""
    if luts is None:
        luts = build_frontend_luts(rig, cfg.frontend)
    if split:
        return run_replay(rig, cfg, state, extract_sequence(rig, luts, cfg.frontend, images),
                          draws)
    outs = []
    for f in range(images.shape[0]):
        state, out = image_step(rig, luts, cfg, state, images[f],
                                None if draws is None else draws.frame(f))
        outs.append(out)
    return state, StepOutput(*(torch.stack(x) for x in zip(*outs)))


def run_replay_images_ba(rig: OmnistereoRig, cfg: PipelineConfig, state: BAState,
                         images: torch.Tensor, luts: FrontendLUTs | None = None,
                         draws: StepDraws | None = None) -> tuple[BAState, BAStepOutput]:
    """Replay (F, H, W) raw images with keyframed window BA: extract every
    frame, then `run_replay_ba`."""
    if luts is None:
        luts = build_frontend_luts(rig, cfg.frontend)
    return run_replay_ba(rig, cfg, state, extract_sequence(rig, luts, cfg.frontend, images),
                         draws)
