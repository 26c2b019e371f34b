"""Keyframe modes, one module each, looked up by
`PipelineConfig.keyframe_mode`: `stride.py` is the mode "stride".

A mode's module gives

  is_keyframe(cfg, m, track, frame) -> bool
      whether frame `frame` (its index) is a keyframe, from the
      configuration, the map before the frame's keyframe stage (`MapState`,
      `m.n_kf` the keyframes inserted so far) and the tracked state after
      the frame's step and any relocalisation (`TrackState`, its pose
      `track.T_world`). The replay reads the answer on the host.
"""

from __future__ import annotations

from vobench.reference.lookup import part


def mode(name: str):
    """The module of keyframe mode `name`."""
    return part(__name__, name, "keyframe mode")
