"""The benchmark's frozen copies against today's program, at small sizes.

The renderer, trajectory and rig that make the inputs, the JAX-compatible
draws, the preset settings and the kernels' work counts are copies frozen
into `vobench/`; these tests tie each copy to the version the program has
now, so a copy that drifted from the program it was taken from shows.
"""

import json
from pathlib import Path

import pytest
import torch

from sosvo_torch.synth import render as p_render
from sosvo_torch.synth import scene as p_scene
from sosvo_torch.sensor import rig as p_rig
from sosvo_torch.tools import bounds as p_bounds
from sosvo_torch.tools import reference_draws as p_draws
from sosvo_torch.tools import workload as p_workload
from vobench import inputs, roofline
from vobench.reference import draws as r_draws

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["c2_chip_ba", "c3_host_pgo"])
def test_preset_settings_are_the_presets(name):
    mine = json.loads((ROOT / "vobench" / "configs" / f"{name}.json").read_text())
    preset = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    assert mine["pipeline"] == preset["pipeline"]
    assert mine["run"] == preset["run"]
    assert mine["reduced"] == []
    room = mine["assumed"]["room"]
    assert (room["radius"], room["floor_z"], room["ceiling_z"], room["texture_scale"]) == \
        tuple(p_workload.ROOM[:4])
    assert room["seed"] == p_workload.ROOM.seed
    assert mine["assumed"]["trajectory"]["radius"] == p_workload.TRAJECTORY_RADIUS


def test_render_and_trajectory_equal_the_programs():
    config = json.loads((ROOT / "vobench" / "configs" / "c2_chip_ba.json").read_text())
    assumed = json.loads(json.dumps(config["assumed"]))
    assumed["rig"]["image_size"] = 160
    poses, images = inputs.render_frames(assumed, 3, CPU)
    p_poses = p_scene.make_trajectory(3, radius=p_workload.TRAJECTORY_RADIUS, device=CPU)
    rig = p_rig.default_rig(image_size=160, device=CPU)
    assert torch.equal(poses, p_poses)
    assert torch.equal(images, p_render.render_sequence(rig, p_poses, p_workload.ROOM))


def test_rig_equals_the_programs():
    from vobench.reference.sensor.rig import default_rig
    mine, theirs = default_rig(device=CPU), p_rig.default_rig(device=CPU)
    for a, b in zip((*mine.top, *mine.bottom, mine.baseline),
                    (*theirs.top, *theirs.bottom, theirs.baseline)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 3])
def test_draws_equal_the_programs_key_stream(seed):
    key = inputs.seed_key(seed)
    mine = r_draws.replay_draws_from_key(key, 3, 8, 16, CPU, reloc_slots=12)
    theirs = p_draws.replay_draws_from_key(key, 3, 8, 16, CPU, reloc_slots=12)
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b)
    for a, b in zip(inputs.replay_draws(key, 3, 8, 16, 12, CPU), theirs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(512, 512, True), (512, 512, False), (2048, 2048, True),
                                   (1024, 2048, False), (2048, 2048, False)])
def test_matcher_work_equals_the_programs(shape):
    assert roofline.matcher_work(*shape) == p_bounds.matcher_work(*shape)
    assert roofline.matcher_bound_ms(*shape) == p_bounds.matcher_bound_ms(*shape)


@pytest.mark.parametrize("shape", [(5, 512), (5, 1024), (2, 2048), (8, 4096)])
def test_schur_work_equals_the_programs(shape):
    assert roofline.schur_work(*shape) == p_bounds.schur_work(*shape)
    assert roofline.schur_bound_ms(*shape) == p_bounds.schur_bound_ms(*shape)


def test_peaks_equal_the_programs():
    for name in ("HBM_BYTES_PER_S", "F32_FLOP_PER_S", "INT8_OP_PER_S", "B1_OP_PER_S",
                 "MATCHER_OP_PER_S"):
        assert getattr(roofline, name) == getattr(p_bounds, name)
