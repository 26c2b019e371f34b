"""The command line: run a benchmark preset end to end (counterpart of `sosvo/cli.py`).

Usage:
    python -m sosvo_torch.cli --config configs/c1_cpu_smoke.json --out RUN_DIR
    python -m sosvo_torch.cli --config ... --ckpt-every 8 --fault-inject 17
    python -m sosvo_torch.cli --config ... --resume         # continue after a kill
    python -m sosvo_torch.cli --config ... --device cpu     # without a card

Builds the preset's synthetic world on the device, replays it in chunks of
`--ckpt-every` frames and checkpoints the whole replay state (random
streams included) and the estimated trajectory after every chunk, logs one
JSON line per frame (`frames.jsonl`), and writes `report.json` with the
JAX package's keys. `--fault-inject N` kills the process (exit code 42)
after the chunk holding frame N; `--resume` continues from the last
checkpoint and writes the same log as an uninterrupted run.

* observation mode (`--source obs`): the scene and observations of
  `tools/workload.py:make_workload` with the preset's `run` noise; image
  mode (`--source images`, or a preset with `"mode": "images"`): the
  JAX command line's room and trajectory rendered and extracted on the
  device (`tools/workload.py:make_image_workload`);
* `--mode f2f` or `ba` (keyframed window BA), and `--pgo` (or a preset's
  `pose_graph`): loop closure and PGO over the estimated trajectory and,
  in BA mode, the replay's own keyframes;
* `frontend.descriptor`: "brief" (the default), "akaze" (nonlinear scale
  space and M-LDB words, Hamming-matched like BRIEF) or "sift" (128-d float
  descriptors, L2-matched in every stage: stereo, temporal, map
  association, relocalisation, the loop leg); SIFT needs image mode, since
  observation mode's synthetic descriptors are 256-bit words;
* `dist.data_parallel > 1` (config c4): that many sequences (or the run
  block's `n_sequences`), each its own scene, replayed in lockstep by
  `vo/batched.py`; observation mode only, no PGO, and the stride keyframe
  schedule whatever `keyframe_mode` says;
* ranks (`torchrun --nproc-per-node D -m sosvo_torch.cli ...`, or
  `python -m sosvo_torch.dist.launch --nproc D -m sosvo_torch.cli ...`),
  as the JAX command line's mesh over its devices, each axis clamped to the
  world size D as the JAX package clamps to its devices:
  - `dist.data_parallel`: min(data_parallel, D), lowered until it divides
    the sequences; each rank replays its block of lanes with their own
    generators (`vo/batched.py:shard_batched_inputs`);
  - `dist.model_parallel > 1` (config c5, BA mode): min(model_parallel,
    D), lowered until it divides `ba.max_landmarks`; every rank replays
    every frame and each window solve is landmark-sharded
    (`dist/replay_dist.py`); `--verify-sharded` replays once more on one
    device and reports the largest pose difference;
  - `dist.pgo_shards > 1` (the c3_long presets): rank 0 replays, then
    broadcasts the keyframes' observations and the trajectory, and
    min(pgo_shards, D) ranks close the loops (`dist/c3_dist.py`).
  Rank 0 writes the report, the log and the checkpoints, and every rank
  resumes from them; `--fault-inject` ends every rank.
* `--sequence BUNDLE` (a `.npz` from `tools/stage_sequence.py` or the JAX
  package's `scripts/stage_sequence.py`): the bundle's square frames
  instead of the synthetic world, through the frontend (image mode), with
  the rig of `--rig FILE` (`sensor/calib_io.py`) or `default_rig` at the
  frames' size; the bundle's ground-truth poses give the first pose and
  the ATE, and without them the replay starts at identity and the report's
  ATE and RPE are null.
* `--viz`: after the report, the JAX command line's artifacts:
  `trajectory.png` and `viewer.html` (`eval/plots.py`, `eval/html_viewer.py`;
  lane 0 of a batched run), in BA mode `map.ply` and `map_3d.png` of the
  final landmark map (`eval/viz.py`), in image mode `keypoints.png` and
  `matches.png` on frame 0. They are drawn with matplotlib: where it does
  not import, `--viz` raises ImportError before anything runs.
The random streams are the port's own seeded generators, so its ATE is
compared with the JAX package's by limits, not digit for digit.
`--pgo` or the image source (`--sequence` too) with the batched replay
raise ValueError, and so does `--rig` without `--sequence`. None is
ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

def _refuse_unported(args, cfg) -> None:
    """Raise, before anything runs, for an option this run cannot take:
    ImportError for --viz without matplotlib, ValueError for what the
    batched replay does not run (in the JAX package neither)."""
    if args.viz:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise ImportError(f"--viz draws its artifacts with matplotlib, which does not import "
                              f"here ({e}); run without --viz") from e
    if args.rig and not args.sequence:
        raise ValueError("--rig is the rig of a staged capture: pass it with --sequence")
    if cfg.frontend.descriptor == "sift" and _source(args, cfg) != "images":
        raise ValueError("frontend.descriptor 'sift' describes images: run it in image mode "
                         "(--source images or pipeline.mode 'images'); observation mode's "
                         "descriptors are 256-bit words")
    if args.verify_sharded and (args.mode != "ba" or cfg.dist.model_parallel <= 1
                                or cfg.dist.data_parallel > 1):
        raise ValueError("--verify-sharded checks the model-sharded BA replay: it needs "
                         "--mode ba and dist.model_parallel > 1")
    if cfg.dist.data_parallel > 1:
        if _source(args, cfg) != "obs":
            raise ValueError("the batched replay (dist.data_parallel > 1) is observation-mode (c4)")
        if args.pgo or cfg.pose_graph:
            raise ValueError("pose-graph loop closing (--pgo, pipeline.pose_graph) is "
                             "non-batched only; the batched replay (dist.data_parallel > 1) "
                             "does not run it")


def _source(args, cfg) -> str:
    if args.sequence:
        return "images"
    return args.source or ("images" if cfg.mode == "images" else "obs")


def _round(x: float | None) -> float | None:
    return None if x is None else round(x, 6)


def _clamp(want: int, world: int, total: int) -> int:
    """min(want, world), lowered until it divides `total`."""
    n = max(1, min(want, world))
    while total % n:
        n -= 1
    return n


def _load_sequence(path: str, rig_path: str | None, cfg, device, chunk: int):
    """(rig, ground-truth poses or None, observations) of a staged capture:
    its square frames extracted on `device`, `chunk` frames at a time, with
    the rig of `rig_path` or the default rig at the frames' size."""
    import torch

    from sosvo_torch.data.sequence import load_sequence
    from sosvo_torch.frontend.image_frontend import build_frontend_luts, extract_sequence
    from sosvo_torch.sensor.calib_io import load_rig
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.synth.scene import FrameObservations

    seq = load_sequence(path)
    if seq.images is None:
        raise ValueError(f"{path} has no image frames")
    n, h, w = seq.images.shape
    if h != w:
        raise ValueError(f"{path}: omni frames must be square, not {h}x{w}")
    rig = load_rig(rig_path, device=device) if rig_path else default_rig(image_size=h,
                                                                          device=device)
    if (rig.image_height, rig.image_width) != (h, w):
        raise ValueError(f"the rig is for {rig.image_height}x{rig.image_width} images, "
                         f"{path} holds {h}x{w}")
    luts = build_frontend_luts(rig, cfg.frontend)
    parts = [extract_sequence(rig, luts, cfg.frontend,
                              torch.from_numpy(seq.images[f0:f0 + chunk]).to(device))
             for f0 in range(0, n, chunk)]
    obs = FrameObservations(*(torch.cat(x) for x in zip(*parts)))
    gt = None if seq.poses is None else torch.from_numpy(seq.poses).to(device)
    return rig, gt, obs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", default=str(Path(tempfile.gettempdir()) / "sosvo_torch_run"))
    ap.add_argument("--ckpt-every", type=int, default=16, help="frames per chunk/checkpoint")
    ap.add_argument("--fault-inject", type=int, default=-1,
                    help="kill the process after this frame (tests resume)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mode", choices=["f2f", "ba"], default="ba",
                    help="frame-to-frame only, or keyframed windowed-BA VO")
    ap.add_argument("--source", choices=["obs", "images"], default=None,
                    help="feature observations or rendered raw omni images through the "
                         "frontend; defaults to the config's pipeline.mode")
    ap.add_argument("--pgo", action="store_true",
                    help="pose-graph loop closing at the end (or set pipeline.pose_graph)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the replay runs; cuda fails without a card")
    ap.add_argument("--sequence", default=None,
                    help="replay a staged capture (.npz from tools/stage_sequence.py: image "
                         "files and optional TUM ground truth) instead of the synthetic world; "
                         "implies --source images")
    ap.add_argument("--rig", default=None,
                    help="rig calibration JSON (sensor/calib_io.py) for --sequence; default: "
                         "the built-in rig at the sequence's image size")
    ap.add_argument("--verify-sharded", action="store_true",
                    help="with dist.model_parallel > 1: replay once more on one device and "
                         "report the largest pose difference")
    ap.add_argument("--viz", action="store_true",
                    help="write trajectory/map plots, map.ply and viewer.html (needs matplotlib)")
    args = ap.parse_args(argv)

    import torch

    from sosvo_torch.dist import mesh as dmesh
    from sosvo_torch.dist.c3_dist import refine_keyframes_sharded
    from sosvo_torch.dist.replay_dist import run_replay_ba_sharded
    from sosvo_torch.eval.ate import ate_rmse, rpe
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.synth.scene import FrameObservations
    from sosvo_torch.tools.workload import (SEED, make_batched_workload, make_image_workload,
                                            make_workload)
    from sosvo_torch.utils.checkpoint import latest_step, restore_state, save_state
    from sosvo_torch.utils.config import load_pipeline_config
    from sosvo_torch.utils.device import default_device
    from sosvo_torch.utils.framelog import stepoutput_rows, write_jsonl
    from sosvo_torch.vo.ba_pipeline import init_ba_state, run_replay_ba
    from sosvo_torch.vo.batched import (gather_lanes, init_batched_ba_states,
                                        init_batched_states, run_replay_ba_batched,
                                        run_replay_batched, shard_batched_inputs)
    from sosvo_torch.vo.loop_closure import keyframe_indices, pgo_refine_trajectory
    from sosvo_torch.vo.pipeline import run_replay
    from sosvo_torch.vo.state import init_track_state, lane

    cfg = load_pipeline_config(args.config)
    _refuse_unported(args, cfg)
    if args.device == "cuda":
        default_device()  # raises where no card is
    ranks = dmesh.init_process_group("cpu" if args.device == "cpu" else None, timeout_s=3600)
    device, lead = ranks.device, ranks.rank == 0
    run = json.loads(Path(args.config).read_text()).get("run", {})
    n_frames = int(run.get("n_frames", 10))
    n_landmarks = int(run.get("n_landmarks", 4096))
    pixel_noise = float(run.get("pixel_noise", 0.3))
    desc_flip = float(run.get("desc_flip_prob", 0.02))
    K = cfg.frontend.max_features

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ckpt_dir = out / "ckpt"
    log_path = out / "frames.jsonl"

    extract_wall = None
    source = _source(args, cfg)
    batched = cfg.dist.data_parallel > 1
    S = int(run.get("n_sequences", cfg.dist.data_parallel)) if batched else 1
    pgo = bool(args.pgo or cfg.pose_graph)
    sharded_replay = not batched and args.mode == "ba" and cfg.dist.model_parallel > 1
    # The mesh, every axis clamped to the world as the JAX command line
    # clamps to its devices (one process: the one-device mesh).
    dp = _clamp(cfg.dist.data_parallel, ranks.world, S) if batched else 1
    mp = _clamp(cfg.dist.model_parallel, ranks.world, cfg.ba.max_landmarks) \
        if sharded_replay else 1
    shards = min(cfg.dist.pgo_shards, ranks.world) if pgo else 1
    replay_mesh = dmesh.make_mesh(ranks, dp, mp)
    pgo_mesh = dmesh.make_mesh(ranks, shards, 1)
    replays = replay_mesh.member if (batched or sharded_replay) else lead
    in_pgo = pgo and cfg.dist.pgo_shards > 1 and pgo_mesh.member
    if not (replays or in_pgo):  # a rank no axis uses
        dmesh.shutdown()
        return 0
    rank_axis = replay_mesh.axis(dmesh.DATA_AXIS if batched else dmesh.MODEL_AXIS)
    state_gen = torch.Generator(device=device).manual_seed(SEED + 2)
    rig = default_rig(device=device)
    gt = obs = None
    gt_available = True

    if not replays:
        pass  # this rank joins the loop-closing leg only
    elif batched:
        # c4: S sequences in lockstep, each its own scene; each rank of the
        # data axis replays its block of lanes.
        rig, gt, obs = make_batched_workload(cfg, S, n_frames, n_landmarks, device,
                                             pixel_noise, desc_flip)
        if args.mode == "ba":
            if cfg.keyframe_mode == "adaptive" and lead:
                print("WARNING: the batched BA replay keeps the lanes in lockstep on the stride "
                      "keyframe schedule; keyframe_mode='adaptive' is ignored in this mode.",
                      file=sys.stderr)
            state0 = init_batched_ba_states(S, cfg, SEED + 2, T0=gt[:, 0], device=device)
            replay_chunk = lambda s, o: run_replay_ba_batched(rig, cfg, s, o)  # noqa: E731
            get_T, get_vo = (lambda o: o.vo.T_world), (lambda o: lane(o.vo, 0))
        else:
            state0 = init_batched_states(S, K, SEED + 2, T0=gt[:, 0], device=device,
                                         descriptor=cfg.frontend.descriptor)
            replay_chunk = lambda s, o: run_replay_batched(rig, cfg, s, o)  # noqa: E731
            get_T, get_vo = (lambda o: o.T_world), (lambda o: lane(o, 0))  # log sequence 0
        get_kf = None  # PGO, the keyframe flags' consumer, is non-batched only
        obs_all, obs = obs, shard_batched_inputs(replay_mesh, None, obs)[1]
        slice_obs = lambda f, hi: FrameObservations(*(x[:, f:hi] for x in obs))  # noqa: E731
    else:
        if args.sequence:
            rig, gt, obs = _load_sequence(args.sequence, args.rig, cfg, device,
                                          int(run.get("render_chunk", 64)))
            n_frames, gt_available = obs.desc_top.shape[0], gt is not None
            if not gt_available:  # identity poses: the first pose, and no ATE
                gt = torch.eye(4, dtype=torch.float32, device=device).repeat(n_frames, 1, 1)
        elif source == "images":
            t_extract0 = time.perf_counter()
            rig, gt, _, _, obs = make_image_workload(cfg, n_frames, device,
                                                     chunk=int(run.get("render_chunk", 64)),
                                                     keep_images=False)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            extract_wall = time.perf_counter() - t_extract0
        else:
            rig, scene, obs = make_workload(cfg, n_frames, n_landmarks, device, pixel_noise,
                                            desc_flip)
            gt = scene.poses
        slice_obs = lambda f, hi: FrameObservations(*(x[f:hi] for x in obs))  # noqa: E731
        if args.mode == "ba":
            state0 = init_ba_state(cfg, state_gen, T0=gt[0], device=device)
            if sharded_replay:
                replay_chunk = lambda s, o: run_replay_ba_sharded(  # noqa: E731
                    replay_mesh, rig, cfg, s, o)
            else:
                replay_chunk = lambda s, o: run_replay_ba(rig, cfg, s, o)  # noqa: E731
            get_T, get_vo, get_kf = (lambda o: o.vo.T_world), (lambda o: o.vo), \
                (lambda o: o.is_keyframe)
        else:
            state0 = init_track_state(K, state_gen, T0=gt[0], device=device,
                                      descriptor=cfg.frontend.descriptor)
            replay_chunk = lambda s, o: run_replay(rig, cfg, s, o)  # noqa: E731
            get_T, get_vo, get_kf = (lambda o: o.T_world), (lambda o: o), None

    fax = 1 if batched else 0  # the frame axis of stacked trajectories
    start_frame = 0
    all_T = [np.zeros((S, 0, 4, 4) if batched else (0, 4, 4), np.float32)]
    all_kf = [np.zeros((0,), bool)]
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    wall = 0.0
    if replays:
        state = state0
        if args.resume:
            step = latest_step(ckpt_dir)
            if step is not None:
                # Every rank resumes from rank 0's checkpoint (all lanes).
                state = restore_state(ckpt_dir, step, state0)
                start_frame = step
                # The ESTIMATED trajectory up to the checkpoint, never ground
                # truth: PGO below consumes the whole estimated trajectory.
                all_T = [np.load(ckpt_dir / f"traj_{step:08d}.npy")]
                kf_path = ckpt_dir / f"kf_{step:08d}.npy"
                if kf_path.exists():  # the BA replay's actual keyframes, for PGO
                    all_kf = [np.load(kf_path)]
                if lead:
                    print(f"[sosvo_torch] resumed from checkpoint at frame {step}")
        if batched:
            state = shard_batched_inputs(replay_mesh, state, obs_all)[0]

        chunk = max(1, args.ckpt_every)
        t0 = time.perf_counter()
        f = start_frame
        append = args.resume and start_frame > 0
        while f < n_frames:
            hi = min(f + chunk, n_frames)
            state, outs = replay_chunk(state, slice_obs(f, hi))
            sync()
            T_chunk = gather_lanes(replay_mesh, get_T(outs)) if batched else get_T(outs)
            full = gather_lanes(replay_mesh, state) if batched else state
            if lead:  # rank 0 keeps the trajectory and writes the log and checkpoints
                all_T.append(T_chunk.cpu().numpy())
                if get_kf is not None:
                    all_kf.append(get_kf(outs).cpu().numpy())
                write_jsonl(log_path, stepoutput_rows(get_vo(outs), t_offset=f), append=append)
                save_state(ckpt_dir, hi, full)
                np.save(ckpt_dir / f"traj_{hi:08d}.npy", np.concatenate(all_T, axis=fax))
                if get_kf is not None:
                    np.save(ckpt_dir / f"kf_{hi:08d}.npy", np.concatenate(all_kf))
            append = True
            if 0 <= args.fault_inject < hi:
                rank_axis.psum(torch.zeros(1, device=device))  # rank 0 has written
                if lead:
                    print(f"[sosvo_torch] fault injection: dying after frame {hi}")
                sys.stdout.flush()
                os._exit(42)
            f = hi
        wall = time.perf_counter() - t0

    # The whole estimated trajectory (checkpointed prefix + this run's
    # frames), equal to the uninterrupted run's.
    T_est = torch.from_numpy(np.concatenate(all_T, axis=fax)).to(device) if lead else None
    T_vo = T_est
    n_loops, pgo_wall = 0, None
    if pgo and not batched and (lead or in_pgo):
        t_pgo0 = time.perf_counter()
        kw = dict(min_inliers=cfg.loop_min_inliers, max_candidates=cfg.loop_candidates or None,
                  robust=cfg.pgo_robust, robust_delta=cfg.pgo_robust_delta)
        kf_idx = None
        if lead:
            kf_idx = keyframe_indices(n_frames, cfg.keyframe_every)
            if args.mode == "ba":
                # The replay's actual keyframe set, when the flags cover every frame.
                kf_flags = np.concatenate(all_kf)
                if len(kf_flags) == n_frames and kf_flags.sum() >= 2:
                    kf_idx = np.nonzero(kf_flags)[0]
        if cfg.dist.pgo_shards > 1:
            # Rank 0 replayed; the keyframes' observations and the trajectory
            # go to every rank of the leg, which then runs sharded.
            ax = pgo_mesh.axis(dmesh.DATA_AXIS)
            sent = None
            if lead:
                kf = torch.as_tensor(kf_idx, dtype=torch.int64).to(device)
                sent = [T_est, kf, *(x[kf] for x in obs)]
            T_in, kf, *obs_kf = ax.broadcast_list(sent, device)
            T_est, n_loops = refine_keyframes_sharded(pgo_mesh, rig, cfg,
                                                      FrameObservations(*obs_kf), T_in,
                                                      kf.cpu().numpy(), **kw)
        else:
            T_est, n_loops = pgo_refine_trajectory(rig, cfg, obs, T_est, kf_idx=kf_idx, **kw)
        n_loops = int(n_loops)
        sync()
        pgo_wall = time.perf_counter() - t_pgo0
    if not lead:
        dmesh.shutdown()
        return 0

    def ate(est, ref):
        return float(ate_rmse(est[1:, :3, 3], ref[1:, :3, 3])[0])

    def rpes(est, ref):
        if est.shape[0] <= 2:  # a 2-frame run is one pose pair; RPE needs two
            return 0.0, 0.0
        return tuple(float(x) for x in rpe(est[1:], ref[1:]))

    if batched:
        ates = [ate(T_est[s], gt[s]) for s in range(S)]
        rmse = float(np.sqrt(np.mean(np.square(ates))))
        t_rpe, r_rpe = rpes(T_est[0], gt[0])
    elif gt_available:
        rmse = ate(T_est, gt)
        t_rpe, r_rpe = rpes(T_est, gt)
    else:  # a staged capture without ground truth: no ATE or RPE
        rmse = t_rpe = r_rpe = None
    done = n_frames - start_frame

    report = {
        "config": args.config,
        "frames": done,
        "ate_rmse_m": _round(rmse),
        "rpe_t_m": _round(t_rpe),
        "rpe_r_rad": _round(r_rpe),
        "frames_per_s": round(done * S / wall, 2) if wall else 0.0,
        "wall_s": round(wall, 2),
        "mode": f"batched-{args.mode}" if batched else args.mode,
        "pgo_loops": n_loops,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "world": ranks.world,
    }
    if n_loops and gt_available:
        report["ate_rmse_vo_m"] = round(ate(T_vo, gt), 6)
        report["pgo_wall_s"] = round(pgo_wall, 2)
        if cfg.dist.pgo_shards > 1:
            report["pgo_shards"] = shards
    if extract_wall is not None:
        report["extract_wall_s"] = round(extract_wall, 2)
    if batched:
        report["n_sequences"] = S
        report["mesh"] = {"data": dp}
        report["ate_per_sequence"] = [round(a, 6) for a in ates]
    if sharded_replay:
        report["mesh"] = {"model": mp}
        if args.verify_sharded:
            # The same inputs and draws replayed on one device: the sharded
            # (all-reduced) solves must reproduce it to f32 tolerance.
            s1 = init_ba_state(cfg, torch.Generator(device=device).manual_seed(SEED + 2),
                               T0=gt[0], device=device)
            _, outs_1 = run_replay_ba(rig, cfg, s1, obs)
            sync()
            report["sharded_vs_single_max_pose_diff"] = float(
                torch.max(torch.abs(T_vo - outs_1.vo.T_world)))
            report["ate_rmse_single_device"] = _round(ate(outs_1.vo.T_world, gt)
                                                      if gt_available else None)
    (out / "report.json").write_text(json.dumps(report, indent=2))
    if args.viz:
        T_plot = T_est[0] if batched else T_est
        gt_plot = (gt[0] if batched else gt) if gt_available else None
        lm_map = state.map if args.mode == "ba" and not batched else None
        img0 = None
        if source == "images":  # frame 0, for the overlays
            if args.sequence:
                from sosvo_torch.data.sequence import load_sequence
                img0 = load_sequence(args.sequence).images[0]
            else:
                from sosvo_torch.tools.workload import render_frames
                img0 = render_frames(rig, n_frames, [0], device)[0].cpu().numpy()
        artifacts = _write_viz(out, Path(args.config).stem, cfg, T_plot, gt_plot, rmse, lm_map,
                               FrameObservations(*(x[0] for x in obs)) if img0 is not None
                               else None, img0)
        print(f"[sosvo_torch] viz artifacts: {', '.join(artifacts)}")
    print(json.dumps(report))
    dmesh.shutdown()
    return 0


def _write_viz(out: Path, name: str, cfg, T_est, gt, ate: float | None, lm_map, obs0,
               img0) -> list[str]:
    """The JAX command line's --viz artifacts in `out`; returns their names.
    `lm_map` is the BA replay's final map (or None), `obs0` and `img0`
    frame 0's observations and image in image mode (or None)."""
    from sosvo_torch.eval.html_viewer import export_html_viewer
    from sosvo_torch.eval.plots import plot_trajectories
    from sosvo_torch.eval.viz import keypoint_overlay, match_overlay, plot_map_3d, save_ply
    from sosvo_torch.vo.pipeline import _match, azimuth_of

    def host(x):
        return None if x is None else x.detach().cpu().numpy()

    T, G = host(T_est), host(gt)
    ate_txt = "no ground truth" if ate is None else f"ATE {ate:.4f} m"
    plot_trajectories(T, G, out / "trajectory.png", title=f"{name}: {ate_txt}")
    lm, lv = (None, None) if lm_map is None else (host(lm_map.lm_pos), host(lm_map.lm_valid))
    export_html_viewer(out / "viewer.html", T, traj_gt=G, landmarks=lm, lm_valid=lv, ate=ate,
                       title=name)
    artifacts = ["trajectory.png", "viewer.html"]
    if lm_map is not None:
        n_pts = save_ply(out / "map.ply", lm, valid=lv)
        plot_map_3d(out / "map_3d.png", T, lm, lv, traj_gt=G,
                    title=f"landmark map ({n_pts} points)")
        artifacts += ["map.ply", "map_3d.png"]
    if obs0 is not None:
        keypoint_overlay(out / "keypoints.png", img0, host(obs0.uv_top), host(obs0.valid_top),
                         host(obs0.uv_bottom), host(obs0.valid_bottom))
        m = _match(cfg, obs0.desc_top, obs0.desc_bottom, obs0.valid_top, obs0.valid_bottom,
                   az_a=azimuth_of(obs0.ray_top), az_b=azimuth_of(obs0.ray_bottom),
                   band=cfg.frontend.stereo_band_rad)
        match_overlay(out / "matches.png", img0, host(obs0.uv_top),
                      host(obs0.uv_bottom[m.idx_b]), host(m.valid))
        artifacts += ["keypoints.png", "matches.png"]
    return artifacts


if __name__ == "__main__":
    sys.exit(main())
