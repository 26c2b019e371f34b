"""The image-mode BA replay on the card against the same replay on the CPU.

    python -m sosvo_torch.tools.replay_parity [--preset c2_chip_ba] [--descriptor brief sift akaze]
                                             [--frames N]

For each descriptor family, the preset (image mode as written, with
`frontend.descriptor` replaced) is rendered once on the CPU and its LUTs
built once on the CPU; the card gets copies of the same images and LUT
values, so the two devices start from equal inputs. The JAX package's
RANSAC draws of the command line (`tools/reference_draws.py`, PRNGKey(2))
are made on the CPU and copied to the card. Then:
  * extraction on each device: keypoint slots apart (rays more than 1e-5
    apart), validity and descriptors of equal slots (words apart, or the
    largest float difference);
  * the BA replay three ways: the CPU's observations on the CPU, the CPU's
    observations on the card, the card's observations on the card; each
    one's ATE, and against the CPU replay the first frame whose discrete
    outputs (pose_ok, stereo, temporal and inlier counts, keyframes)
    differ and the largest position difference.
The second replay separates the replay's arithmetic on the card (cuBLAS
products, the kernels, the device's transcendental functions) from the
extraction's. Two more replays take chip_smoke.py's own inputs: images
rendered and LUTs built on the card, with the CPU's draws and with the
draws made on the card. Prints one line per comparison; nothing is
asserted.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from sosvo_torch.eval.ate import ate_rmse
from sosvo_torch.frontend.image_frontend import FrontendLUTs, build_frontend_luts, extract_sequence
from sosvo_torch.sensor.rig import default_rig
from sosvo_torch.synth.render import render_sequence
from sosvo_torch.synth.scene import FrameObservations, make_trajectory
from sosvo_torch.tools.reference_draws import replay_draws
from sosvo_torch.tools.workload import (ROOM, TRAJECTORY_RADIUS, card_info, load_image_preset)
from sosvo_torch.utils.device import default_device
from sosvo_torch.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo_torch.vo.pipeline import StepDraws

CPU = torch.device("cpu")


def _to(tree, device):
    """A NamedTuple of tensors (None kept) on `device`."""
    return type(tree)(*(None if x is None else x.to(device) for x in tree))


def _luts_to(luts: FrontendLUTs, device) -> FrontendLUTs:
    return FrontendLUTs(*(g._replace(**{f: getattr(g, f).to(device)
                                        for f in ("lut_uv", "valid", "u0", "v0", "fu", "fv")})
                          for g in luts))


def compare_observations(a: FrameObservations, b: FrameObservations) -> str:
    """Slots apart, validity and descriptors of equal slots, over all frames."""
    parts = []
    for view in ("top", "bottom"):
        ray_a, ray_b = getattr(a, f"ray_{view}"), getattr(b, f"ray_{view}").to(CPU)
        same = (ray_a - ray_b).abs().amax(dim=-1) <= 1e-5
        da, db = getattr(a, f"desc_{view}")[same], getattr(b, f"desc_{view}").to(CPU)[same]
        if da.is_floating_point():
            desc = f"desc_max_abs_err={float((da - db).abs().max()):.3e}"
        else:
            desc = f"descriptors_with_a_word_apart={int((da != db).any(dim=-1).sum())}"
        valid = int((getattr(a, f"valid_{view}")[same]
                     != getattr(b, f"valid_{view}").to(CPU)[same]).sum())
        parts.append(f"{view}: slots_apart={int((~same).sum())}/{same.numel()} "
                     f"valid_differs={valid} {desc}")
    return " ".join(parts)


def replay(cfg, rig, obs, poses, draws: StepDraws):
    device = obs.desc_top.device
    state = init_ba_state(cfg, torch.Generator(device=device), T0=poses[0].to(device),
                          device=device)
    _, outs = run_replay_ba(rig, cfg, state, obs, draws)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return _to(outs.vo, CPU), outs.is_keyframe.to(CPU)


def compare_replays(label, ref, got, poses) -> str:
    (vo_r, kf_r), (vo_g, kf_g) = ref, got
    differ = (vo_r.pose_ok != vo_g.pose_ok) | (vo_r.n_stereo != vo_g.n_stereo) \
        | (vo_r.n_temporal != vo_g.n_temporal) | (vo_r.n_inliers != vo_g.n_inliers) \
        | (kf_r != kf_g)
    first = int(torch.nonzero(differ)[0]) if bool(differ.any()) else None
    pos = float((vo_r.T_world[:, :3, 3] - vo_g.T_world[:, :3, 3]).abs().max())
    ate = float(ate_rmse(vo_g.T_world[1:, :3, 3], poses[1:, :3, 3])[0])
    return (f"{label}: ATE_m={ate} pose_ok={int(vo_g.pose_ok[1:].sum())}/{len(vo_g.pose_ok) - 1} "
            f"frames_with_discrete_outputs_apart={int(differ.sum())} first_at={first} "
            f"max_position_diff_m={pos:.3e}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="c2_chip_ba")
    ap.add_argument("--descriptor", nargs="+", default=["brief", "sift", "akaze"],
                    choices=["brief", "sift", "akaze"])
    ap.add_argument("--frames", type=int, default=None, help="default: the preset's")
    args = ap.parse_args()
    card = default_device()
    print(f"card: {card_info()}", flush=True)
    base, run = load_image_preset(args.preset)
    n = args.frames or run["n_frames"]
    rig_cpu, rig_card = default_rig(device=CPU), default_rig(device=card)
    poses = make_trajectory(n, radius=TRAJECTORY_RADIUS, device=CPU)
    images = render_sequence(rig_cpu, poses, ROOM)
    images_card = render_sequence(rig_card, poses.to(card), ROOM)
    print(f"images rendered on the card vs the CPU: max_abs_diff="
          f"{float((images_card.to(CPU) - images).abs().max()):.3e}", flush=True)
    for descriptor in args.descriptor:
        cfg = dataclasses.replace(base, frontend=dataclasses.replace(base.frontend,
                                                                     descriptor=descriptor))
        luts = build_frontend_luts(rig_cpu, cfg.frontend)
        obs_cpu = extract_sequence(rig_cpu, luts, cfg.frontend, images)
        obs_card = extract_sequence(rig_card, _luts_to(luts, card), cfg.frontend, images.to(card))
        draws = replay_draws(n, cfg.ransac.n_hyps, cfg.frontend.max_features, CPU,
                             reloc_slots=cfg.ba.max_landmarks)
        tag = f"{args.preset} descriptor={descriptor} frames={n}"
        print(f"{tag} extraction, card vs CPU from equal images and LUT values: "
              f"{compare_observations(obs_cpu, obs_card)}", flush=True)
        ref = replay(cfg, rig_cpu, obs_cpu, poses, draws)
        print(compare_replays(f"{tag} replay, CPU observations on the CPU", ref, ref, poses),
              flush=True)
        obs_own = extract_sequence(rig_card, build_frontend_luts(rig_card, cfg.frontend),
                                   cfg.frontend, images_card)
        draws_card = replay_draws(n, cfg.ransac.n_hyps, cfg.frontend.max_features, card,
                                  reloc_slots=cfg.ba.max_landmarks)
        for label, obs, d in (("CPU observations on the card", _to(obs_cpu, card), None),
                              ("card observations on the card", obs_card, None),
                              ("card images and LUTs, CPU draws", obs_own, None),
                              ("card images and LUTs, card draws", obs_own, draws_card)):
            got = replay(cfg, rig_card, obs, poses, _to(draws, card) if d is None else d)
            print(compare_replays(f"{tag} replay, {label}, against the CPU's", ref, got, poses),
                  flush=True)


if __name__ == "__main__":
    main()
