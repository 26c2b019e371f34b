"""The port's entry points run on the card unless the caller asks for the CPU.

With `torch.cuda.is_available` patched to False, every entry point that
makes tensors raises instead of dropping to the CPU; with `device="cpu"`
it runs here.
"""

import numpy as np
import pytest
import torch

from sosvo_torch import convert
from sosvo_torch.sensor.model import ViewParams
from sosvo_torch.sensor.rig import default_rig
from sosvo_torch.synth import scene
from sosvo_torch.utils.config import PipelineConfig
from sosvo_torch.utils.device import default_device
from sosvo_torch.vo.ba_pipeline import init_ba_state
from sosvo_torch.vo.keyframes import init_map_state
from sosvo_torch.vo.state import init_track_state

ENTRY_POINTS = {
    "default_rig": lambda **d: default_rig(**d),
    "ViewParams.create": lambda **d: ViewParams.create(0.9, 1, 1, 0, 0, -0.5, 0.2, **d),
    "make_landmarks": lambda **d: scene.make_landmarks(torch.Generator(), 4, **d),
    "make_trajectory": lambda **d: scene.make_trajectory(3, **d),
    "landmark_descriptors": lambda **d: scene.landmark_descriptors(torch.Generator(), 4, **d),
    "descriptor_flips": lambda **d: scene.descriptor_flips(torch.Generator(), (4, 8), 0.1, **d),
    "make_scene": lambda **d: scene.make_scene(torch.Generator(), 2, 16, **d),
    "draw_observation": lambda **d: scene.draw_observation(torch.Generator(), 8, 0.02, **d),
    "init_track_state": lambda **d: init_track_state(8, torch.Generator(), **d),
    "init_map_state": lambda **d: init_map_state(3, 16, **d),
    "init_ba_state": lambda **d: init_ba_state(PipelineConfig(), torch.Generator(), **d),
    "desc_to_torch": lambda **d: convert.desc_to_torch(np.zeros((2, 8), np.uint32), **d),
    "ba_window_from_numpy": lambda **d: convert.ba_window_from_numpy(
        type("Win", (), dict(X=np.eye(4)[None], landmarks=np.zeros((1, 3)),
                             rays=np.zeros((1, 1, 2, 3)), weights=np.zeros((1, 1, 2)),
                             viewpoints=np.zeros((2, 3))))(), **d),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(name):
    out = ENTRY_POINTS[name](device="cpu")
    leaves = [x for x in torch.utils._pytree.tree_leaves(out) if isinstance(x, torch.Tensor)]
    assert leaves and all(x.device.type == "cpu" for x in leaves)


def test_default_device_is_cuda_when_a_card_is_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
