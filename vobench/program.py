"""Every name the benchmark takes from the program under test, in one place.

The program is the PyTorch/CUDA package `sosvo_torch`. The harness reaches
its entry points only through `Program`, which imports them when a run
starts, never when this module is imported, so that the reference and the
tests can import the benchmark without the program. Function attributes are
looked up on their modules at call time, so the spans that `spans.py` sets
on them see every call.
"""

from __future__ import annotations

import importlib
from pathlib import Path


class Program:
    """The program's modules and the objects a run builds from its inputs."""

    def __init__(self, config_path: Path, assumed: dict, device):
        self.device = device
        self.config = importlib.import_module("sosvo_torch.utils.config")
        self.rig_mod = importlib.import_module("sosvo_torch.sensor.rig")
        self.frontend = importlib.import_module("sosvo_torch.frontend.image_frontend")
        self.ba_pipeline = importlib.import_module("sosvo_torch.vo.ba_pipeline")
        self.loop_closure = importlib.import_module("sosvo_torch.vo.loop_closure")
        self.live = importlib.import_module("sosvo_torch.vo.live")
        self.cfg = self.config.load_pipeline_config(config_path)
        rig = assumed["rig"]
        self.rig = self.rig_mod.default_rig(image_size=rig["image_size"], baseline=rig["baseline"],
                                            device=device)
        self.luts = None

    def build_luts(self):
        """The frontend's lookup tables, built once in set-up as the command
        line builds them."""
        self.luts = self.frontend.build_frontend_luts(self.rig, self.cfg.frontend)
        return self.luts

    def init_state(self, T0, generator):
        return self.ba_pipeline.init_ba_state(self.cfg, generator, T0=T0, device=self.device)

    def extract_sequence(self, images):
        return self.frontend.extract_sequence(self.rig, self.luts, self.cfg.frontend, images)

    def run_replay_ba(self, state, obs):
        return self.ba_pipeline.run_replay_ba(self.rig, self.cfg, state, obs)

    def close_loops(self, obs, T_world, kf_idx, leg: dict, generator, max_candidates=None):
        cfg = self.cfg
        return self.loop_closure.close_loops(
            self.rig, cfg, obs, T_world, min_gap=leg["min_gap"], min_inliers=cfg.loop_min_inliers,
            iters=leg["iters"], max_candidates=max_candidates or cfg.loop_candidates or None,
            robust=cfg.pgo_robust, robust_delta=cfg.pgo_robust_delta, kf_idx=kf_idx,
            generator=generator)

    def live_vo_ba(self, frames, key, T0):
        return self.live.live_vo_ba(self.rig, self.cfg, frames, key=key, luts=self.luts, T0=T0,
                                    device=self.device)
