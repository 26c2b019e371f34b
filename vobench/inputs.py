"""A run's inputs, made from its seed with the benchmark's frozen copies.

The frames are the room of the configuration's `assumed` block rendered
along its trajectory through its rig by the frozen renderer
(`reference/synth/render.py`, `reference/synth/scene.py:make_trajectory`,
`reference/sensor/rig.py:default_rig`), its elementwise steps run over
chunks of frames. The scene does not depend on the
seed: the configuration names one room and one trajectory, and every seed
replays the same sequence, so every run does the same work. The seed sets
every random stream handed to the program, and the same go to the
reference: `generators(seed)` seeds the tracker's generator, from which the
step draws each frame's Gumbel matrices when it needs them (as the command
line draws them), and the loop leg's; `seed_key(seed)` is the live driver's
key, from which it makes each frame's matrices in the JAX package's stream
(`reference/draws.py`; `key_draws` makes the same for the reference).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference import draws as ref_draws
from vobench.reference.geom.lie import rotate_dirs
from vobench.reference.sensor.model import annulus_mask, lift, viewpoint
from vobench.reference.sensor.rig import default_rig
from vobench.reference.synth.render import RoomScene, _ray_room, texture
from vobench.reference.synth.scene import make_trajectory

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
LOOP_SEED_OFFSET = 0x9E3779B97F4A7C15  # parts the loop leg's stream from the tracker's
RENDER_CHUNK = 16   # frames rendered by one launch of each elementwise step


class Inputs(NamedTuple):
    poses: torch.Tensor    # (F, 4, 4) ground-truth world-from-rig
    images: torch.Tensor   # (F, H, W) f32 raw omni frames (on the device, or the host's for live)
    seed: int              # the run's seed, which sets every random stream


def seed_key(seed: int) -> tuple[int, int]:
    """The run's key: the seed's two 32-bit halves (any integer, taken
    modulo 2^64)."""
    seed &= MASK64
    return (seed >> 32) & MASK32, seed & MASK32


def generators(seed: int, device) -> tuple[torch.Generator, torch.Generator]:
    """Fresh generators of a pass: the tracker's (each frame's rigid draw, the
    lazy gate's essential draw and relocalisation's, made in the step when it
    runs) and the loop leg's (one matrix per candidate pair)."""
    s = seed & MASK64
    return (torch.Generator(device=device).manual_seed(s),
            torch.Generator(device=device).manual_seed((s + LOOP_SEED_OFFSET) & MASK64))


def _hits(rig, poses: torch.Tensor, view, rays: torch.Tensor, scene: RoomScene):
    """`reference/synth/render.py:hit_points` for a chunk of poses: the
    pose-independent lift once, each pose's rotation and viewpoint as the
    frame-by-frame renderer makes them, the ray-room test over the chunk."""
    h, w = rig.image_height, rig.image_width
    origins, dirs = [], []
    for T in poses:
        R = T[:3, :3]
        origins.append(T[:3, 3] + R @ viewpoint(view))
        dirs.append(rotate_dirs(R, rays.reshape(-1, 3)).reshape(h, w, 3))
    origin = torch.stack(origins)[:, None, None, :]
    d = torch.stack(dirs)
    tt = _ray_room(origin.expand(d.shape), d, scene)
    return origin + tt[..., None] * d, tt


def render_frames(assumed: dict, n_frames: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(ground-truth poses, rendered frames) of the configuration's scene:
    `reference/synth/render.py:render_sequence`, its elementwise steps over
    RENDER_CHUNK frames at a time, so the frames equal it bit for bit."""
    rig = default_rig(image_size=assumed["rig"]["image_size"],
                      baseline=assumed["rig"]["baseline"], device=device)
    room = assumed["room"]
    scene = RoomScene(radius=room["radius"], floor_z=room["floor_z"],
                      ceiling_z=room["ceiling_z"], texture_scale=room["texture_scale"],
                      seed=room["seed"])
    poses = make_trajectory(n_frames, radius=assumed["trajectory"]["radius"], device=device)
    h, w = rig.image_height, rig.image_width
    vv = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    uu = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    views = []
    for view in (rig.top, rig.bottom):
        rays, ok = lift(view, torch.stack([uu, vv], dim=-1))
        views.append((view, rays, annulus_mask(view, h, w) & ok))
    frames = []
    for f0 in range(0, n_frames, RENDER_CHUNK):
        chunk = poses[f0:f0 + RENDER_CHUNK]
        (p_top, t_top), (p_bot, t_bot) = (_hits(rig, chunk, v, r, scene) for v, r, _ in views)
        m_top, m_bot = views[0][2], views[1][2]
        hit = torch.where(m_top, t_top < 1e8, m_bot & (t_bot < 1e8))
        val = texture(torch.where(m_top[..., None], p_top, p_bot), scene)
        frames.append(torch.where(hit, val, 0.0))
    return poses, torch.cat(frames)


def gumbels(keys: list[tuple[int, int]], shape: tuple[int, ...], device,
            chunk_elems: int = 1 << 25) -> torch.Tensor:
    """`reference/draws.py:gumbel(key, shape)` for every key at once,
    stacked (len(keys), *shape): the same Threefry-2x32 words with the keys
    as tensors, so a few large launches make what one launch per key made.
    Integer steps are exact and the float steps elementwise, so each matrix
    equals its one-key draw bit for bit."""
    m = 1
    for s in shape:
        m *= s
    per = max(1, chunk_elems // m)
    out = []
    for i in range(0, len(keys), per):
        kk = torch.tensor(keys[i:i + per], dtype=torch.int64, device=device)
        k1, k2 = kk[:, :1], kk[:, 1:]
        ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
        x0 = ks[0].expand(-1, m)
        x1 = (torch.arange(m, dtype=torch.int64, device=device)[None] + ks[1]) & MASK32
        for r4 in range(5):
            for r in ref_draws._ROTATIONS[r4 % 2]:
                x0 = (x0 + x1) & MASK32
                x1 = x0 ^ (((x1 << r) | (x1 >> (32 - r))) & MASK32)
            x0 = (x0 + ks[(r4 + 1) % 3]) & MASK32
            x1 = (x1 + ks[(r4 + 2) % 3] + r4 + 1) & MASK32
        bits = ((x0 ^ x1) >> 9) | 0x3F800000
        floats = bits.to(torch.int32).view(torch.float32) - 1.0
        u = torch.clamp_min(floats + ref_draws._TINY_F32, ref_draws._TINY_F32)
        out.append(-torch.log(-torch.log(u)).reshape(-1, *shape))
    return torch.cat(out)


def replay_draws(key: tuple[int, int], n_frames: int, n_hyps: int, k: int, n_slots: int,
                 device) -> ref_draws.StepDraws:
    """`reference/draws.py:replay_draws_from_key(key, ...)` with relocalisation's
    matrices: each frame's keys follow the same chain, the matrices are made
    all frames at once."""
    rigid, ess, reloc = [], [], []
    for _ in range(n_frames):
        key, k_rigid, k_ess = ref_draws.split(key, 3)
        rigid.append(k_rigid)
        ess.append(k_ess)
        reloc.append(ref_draws.fold_in(key, ref_draws.RELOC_FOLD))
    return ref_draws.StepDraws(gumbels(rigid, (n_hyps, k), device),
                               gumbels(ess, (n_hyps, k), device),
                               gumbels(reloc, (n_hyps, n_slots), device))


def key_draws(inp: Inputs, config: dict, device) -> ref_draws.StepDraws:
    """Each frame's draws from the run's key, stacked: what the live driver
    makes frame by frame, for the reference."""
    pipe = config["pipeline"]
    return replay_draws(seed_key(inp.seed), inp.images.shape[0], pipe["ransac"]["n_hyps"],
                        pipe["frontend"]["max_features"], pipe["ba"]["max_landmarks"], device)


def make_inputs(config: dict, seed: int, device) -> Inputs:
    """The frames and ground truth of a run of `config`, on `device`."""
    poses, images = render_frames(config["assumed"], config["run"]["n_frames"], device)
    return Inputs(poses, images, seed)
