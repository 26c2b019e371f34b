"""Batched multi-sequence replay, config c4 (counterpart of `sosvo/vo/batched.py`).

S sequences replay in lockstep. A batched state carries a leading lane axis
on every tensor and one `torch.Generator` per lane (a tuple); observations
and draws are (S, F, ...), outputs (S, F, ...). Each frame is a lane loop:
S frame-to-frame steps with the essential gate held back
(`step_full(..., defer_gate=True)`), one batch gate
(`pipeline.apply_deferred_gate`), and in BA mode one relocalisation
decision (`ba_pipeline.relocalize_lanes`) and the keyframe stage for all
lanes at once. Host decisions are per frame, never per lane: one read of
every lane's gate predicate, and in BA mode one read of every lane's
`pose_ok` once the maps hold a keyframe; the stride keyframe test and the
window warm-up (two keyframes) follow from host counters. Adaptive
keyframing is per lane by nature and is not supported: the BA replay uses
the stride schedule whatever `cfg.keyframe_mode` says, as the reference
does. Over ranks, `shard_batched_inputs` gives each rank of a mesh's data
axis its contiguous block of lanes (their states, generators included, and
observations) and `gather_lanes` puts the blocks back together.

A lane draws from its own generator exactly what its sequential replay
draws, in the same order (rigid, essential when its gate runs,
relocalisation when it is lost), so each lane equals that replay.
"""

from __future__ import annotations

import torch

from sosvo_torch.dist.mesh import DATA_AXIS, Mesh
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.synth.scene import FrameObservations
from sosvo_torch.utils.config import PipelineConfig
from sosvo_torch.utils.device import resolve
from sosvo_torch.vo.ba_pipeline import (BAState, BAStepOutput, init_ba_state, keyframe_stage,
                                        relocalize_lanes)
from sosvo_torch.vo.pipeline import StepDraws, apply_deferred_gate, step_full
from sosvo_torch.vo.state import StepOutput, TrackState, init_track_state, lane, stack_lanes


def lane_generators(seed: int, n_lanes: int, device) -> tuple[torch.Generator, ...]:
    """The lanes' generators on `device`, seeded by `n_lanes` draws of a CPU
    generator seeded `seed` (the port's counterpart of `jax.random.split`)."""
    seeds = torch.randint(0, 2**62, (n_lanes,), generator=torch.Generator().manual_seed(seed))
    return tuple(torch.Generator(device=device).manual_seed(s) for s in seeds.tolist())


def _T0s(n_seq: int, T0: torch.Tensor | None, device) -> torch.Tensor:
    if T0 is None:
        return torch.eye(4, dtype=torch.float32, device=device).expand(n_seq, 4, 4)
    return T0


def init_batched_states(n_seq: int, max_features: int, seed: int, T0: torch.Tensor | None = None,
                        device: torch.device | str | None = None,
                        descriptor: str = "brief") -> TrackState:
    """Stacked TrackStates, leading axis = sequence, with `descriptor`'s
    buffers (`state.desc_zeros`); lane s draws from
    `lane_generators(seed, n_seq)[s]`."""
    device = resolve(device)
    gens = lane_generators(seed, n_seq, device)
    T0s = _T0s(n_seq, T0, device)
    return stack_lanes([init_track_state(max_features, g, T0=T0s[s], device=device,
                                         descriptor=descriptor)
                        for s, g in enumerate(gens)])


def init_batched_ba_states(n_seq: int, cfg: PipelineConfig, seed: int,
                           T0: torch.Tensor | None = None,
                           device: torch.device | str | None = None) -> BAState:
    """Stacked BAStates (track and keyframe map, with the configured
    descriptor family's buffers), leading axis = sequence."""
    device = resolve(device)
    gens = lane_generators(seed, n_seq, device)
    T0s = _T0s(n_seq, T0, device)
    return stack_lanes([init_ba_state(cfg, g, T0=T0s[s], device=device)
                        for s, g in enumerate(gens)])


def lane_block(tree, lo: int, hi: int):
    """Lanes [lo, hi) of a batched tree (views; generators as a tuple)."""
    if isinstance(tree, torch.Tensor):
        return tree[lo:hi]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(lane_block(x, lo, hi) for x in tree))
    if isinstance(tree, tuple):
        return tree[lo:hi]
    return tree


def shard_batched_inputs(mesh: Mesh, states, obs_seqs: FrameObservations):
    """This rank's contiguous block of lanes of `states` and `obs_seqs` (the
    JAX package's sequence axis on the "data" mesh axis): S lanes over a
    data axis of size D, S divisible by D. Each lane keeps its own
    generator, so it replays as in the one-process batched replay."""
    axis = mesh.axis(DATA_AXIS)
    S = obs_seqs.desc_top.shape[0]
    if S % axis.size:
        raise ValueError(f"{S} sequences do not divide over {axis.size} ranks")
    n = S // axis.size
    lo = axis.index * n
    return lane_block(states, lo, lo + n), lane_block(obs_seqs, lo, lo + n)


def gather_lanes(mesh: Mesh, tree):
    """The inverse of `shard_batched_inputs` on every rank: every lane of a
    batched tree, each generator rebuilt from its rank's state (the lanes'
    own generators on this rank)."""
    axis = mesh.axis(DATA_AXIS)
    if axis.size == 1:
        return tree
    if isinstance(tree, torch.Tensor):
        return axis.all_gather(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather_lanes(mesh, x) for x in tree))
    if isinstance(tree, tuple):  # the lanes' generators
        dev = mesh.device
        mine = torch.stack([g.get_state() for g in tree]).to(dev, torch.int32)
        states = axis.all_gather(mine).to("cpu", torch.uint8)
        n = len(tree)
        gens = []
        for s, st in enumerate(states):
            if s // n == axis.index:
                gens.append(tree[s % n])
            else:
                gens.append(torch.Generator(device=tree[0].device))
                gens[-1].set_state(st.clone())  # set_state reads the storage from its start
        return tuple(gens)
    return tree


def _frame_draws(draws: StepDraws | None, s: int, f: int) -> StepDraws | None:
    return None if draws is None else StepDraws(*(None if x is None else x[s, f] for x in draws))


def _deferred_frame(rig, cfg, track: TrackState, obs_seqs: FrameObservations, f: int,
                    draws: StepDraws | None):
    """Frame `f` of every lane with the gate held back, then the batch gate.
    Returns (track, out, per-lane features)."""
    n_lanes = len(track.generator)
    steps = [step_full(rig, cfg, lane(track, s), FrameObservations(*(x[s, f] for x in obs_seqs)),
                       _frame_draws(draws, s, f), defer_gate=True) for s in range(n_lanes)]
    new, out, feats, ctx = zip(*steps)
    track2, out = apply_deferred_gate(cfg, track.T_world, stack_lanes(list(new)),
                                      stack_lanes(list(out)), stack_lanes(list(ctx)),
                                      None if draws is None else draws.gumbel_ess[:, f])
    return track2, out, list(feats)


def run_replay_batched(rig: OmnistereoRig, cfg: PipelineConfig, states: TrackState,
                       obs_seqs: FrameObservations, draws: StepDraws | None = None
                       ) -> tuple[TrackState, StepOutput]:
    """Replay S sequences frame to frame in lockstep: observation fields and
    `draws` (optional, each lane's per-frame Gumbel matrices) are (S, F, ...);
    outputs are stacked (S, F, ...)."""
    outs = []
    for f in range(obs_seqs.desc_top.shape[1]):
        states, out, _ = _deferred_frame(rig, cfg, states, obs_seqs, f, draws)
        outs.append(out)
    return states, StepOutput(*(torch.stack(x, dim=1) for x in zip(*outs)))


def run_replay_ba_batched(rig: OmnistereoRig, cfg: PipelineConfig, states: BAState,
                          obs_seqs: FrameObservations, draws: StepDraws | None = None,
                          ba_fn=None, insert_fn=None) -> tuple[BAState, BAStepOutput]:
    """Replay S sequences in lockstep with windowed BA; outputs (S, F, ...).

    Keyframes follow the lockstep stride schedule (`cfg.keyframe_every`) on
    the host's frame counter, and the whole keyframe stage (insertion, the
    window solve once two keyframes exist, the pose read back from the
    window) runs for every lane under that one decision. That stage is the
    sequential replay's own (`ba_pipeline.keyframe_stage`), run per lane;
    `ba_fn` (MapState -> (MapState, cost)) and `insert_fn`
    (`insert_keyframe`'s signature) replace the window solve and the
    insertion in every lane.
    """
    n_lanes = len(states.track.generator)
    device = states.track.T_world.device
    # Lanes are in lockstep: lane 0's counters are the batch's. One read.
    frame0, n_kf = torch.stack([states.track.frame_idx[0], states.map.n_kf[0]]).tolist()
    outs = []
    for f in range(obs_seqs.desc_top.shape[1]):
        frame = frame0 + f
        track, out, feats = _deferred_frame(rig, cfg, states.track, obs_seqs, f, draws)
        tried = torch.zeros((n_lanes,), dtype=torch.bool, device=device)
        if cfg.relocalize and n_kf >= 1:
            tried = ~out.pose_ok
            track, out = relocalize_lanes(
                cfg, states.map, track, out, feats,
                None if draws is None or draws.gumbel_reloc is None else draws.gumbel_reloc[:, f])

        maps, T_w = states.map, track.T_world
        cost = torch.zeros((n_lanes,), dtype=torch.float32, device=device)
        is_kf = frame % cfg.keyframe_every == 0
        if is_kf:
            # Lockstep: every lane inserts on the same frames, so `n_kf` is each lane's.
            maps, T_w, cost = (stack_lanes(list(x)) for x in zip(*(
                keyframe_stage(rig, cfg, lane(states.map, s), lane(track, s), feats[s], True,
                               n_kf, insert_fn, ba_fn) for s in range(n_lanes))))
            n_kf += 1
        track = track._replace(T_world=T_w)
        outs.append(BAStepOutput(
            vo=out._replace(T_world=T_w),
            is_keyframe=torch.full((n_lanes,), is_kf, dtype=torch.bool, device=device),
            ba_cost=cost,
            n_landmarks=torch.sum(maps.lm_valid, dim=-1, dtype=torch.int32),
            reloc_tried=tried,
        ))
        states = BAState(track=track, map=maps)
    vo = StepOutput(*(torch.stack(x, dim=1) for x in zip(*(o.vo for o in outs))))
    rest = (torch.stack(x, dim=1) for x in list(zip(*outs))[1:])
    return states, BAStepOutput(vo, *rest)
