"""Landmark-sharded replay: config c5 (counterpart of `sosvo/dist/replay_dist.py`).

The keyframed BA replay (`sosvo_torch/vo/ba_pipeline.py`) with every
keyframe's window solve sharded over the mesh's "model" axis. Every rank
tracks every frame, as XLA runs the replicated scan on every device: the
ranks start from the same state with generators seeded alike, so every
decision the host takes (the gate, relocalisation, keyframes) comes out the
same on every rank and the ranks meet at the same collectives. Only the
window solve is split: each rank reduces its landmark shard, the partial
camera systems are all-reduced (`backend/ba.py`, `kernels/schur_cuda.py`),
and the refined landmarks are gathered back into the replicated map.

The invariant (tests/test_torch_dist_replay.py, chip_smoke.py phase 12):
every rank's trajectory is bit-equal, and it equals the single-device
replay's within f32 reduction order.
"""

from __future__ import annotations

from sosvo_torch.dist.mesh import MODEL_AXIS, Mesh
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.synth.scene import FrameObservations
from sosvo_torch.utils.config import PipelineConfig
from sosvo_torch.vo.ba_pipeline import BAState, BAStepOutput, run_replay_ba
from sosvo_torch.vo.keyframes import MapState, run_window_ba
from sosvo_torch.vo.pipeline import StepDraws


def make_sharded_ba_fn(mesh: Mesh, rig: OmnistereoRig, cfg: PipelineConfig):
    """A MapState -> (MapState, cost) window solve sharded over `mesh`'s
    model axis: `run_replay_ba`'s `ba_fn`. The map's landmark capacity
    (`cfg.ba.max_landmarks`) must divide by the axis size."""
    axis = mesh.axis(MODEL_AXIS)
    if cfg.ba.max_landmarks % axis.size:
        raise ValueError(f"max_landmarks={cfg.ba.max_landmarks} not divisible by the model "
                         f"axis ({axis.size})")

    def ba_fn(m: MapState):
        return run_window_ba(rig, m, iters=cfg.ba.iters, huber_delta=cfg.ba.huber_delta,
                             axis=axis)

    return ba_fn


def run_replay_ba_sharded(mesh: Mesh, rig: OmnistereoRig, cfg: PipelineConfig, state: BAState,
                          obs_seq: FrameObservations, draws: StepDraws | None = None
                          ) -> tuple[BAState, BAStepOutput]:
    """`run_replay_ba` with every keyframe's window solve landmark-sharded."""
    return run_replay_ba(rig, cfg, state, obs_seq, draws, ba_fn=make_sharded_ba_fn(mesh, rig, cfg))
