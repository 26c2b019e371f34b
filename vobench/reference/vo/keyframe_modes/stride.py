"""Stride keyframes: every `keyframe_every`-th frame, from frame 0."""

from __future__ import annotations


def is_keyframe(cfg, m, track, frame: int) -> bool:
    return frame % cfg.keyframe_every == 0
