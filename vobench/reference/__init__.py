"""The benchmark's plain reference: a frozen copy of the VO path in torch.

It holds the image frontend (panorama LUTs, Harris, NMS, top-K, BRIEF),
the per-frame step (stereo and temporal matching, triangulation, rigid and
essential RANSAC, the bearing refine), the keyframe map with window BA,
relocalisation, loop closure and pose-graph optimisation, the renderer and
trajectory that make the benchmark's inputs, and the JAX-compatible random
draws (`draws.py`), as plain torch operations. The two hand-written kernels
of the program are replaced by their plain definitions (`kernels.py`). It
holds what the benchmark's cells run and no more: BRIEF words, stride
keyframes, one unsharded window solve, the dense pose-graph solve over the
prescreened loop pairs; another option raises.

The copy was taken from the program when the benchmark was written and is
not edited with it, so a later change to the program is judged against the
same arithmetic. It imports neither jax nor the program's package.
"""
