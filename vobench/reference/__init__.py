"""The benchmark's plain reference: a frozen copy of the VO path in torch.

It holds the image frontend (panorama LUTs, Harris, NMS, top-K, BRIEF),
the per-frame step (stereo and temporal matching, triangulation, rigid and
essential RANSAC, the bearing refine), the keyframe map with window BA,
relocalisation, loop closure and pose-graph optimisation, the renderer and
trajectory that make the benchmark's inputs, and the JAX-compatible random
draws (`draws.py`), as plain torch operations. The two hand-written kernels
of the program are replaced by their plain definitions (`kernels.py`). It
holds what the benchmark's cells run and no more: one unsharded window
solve, the dense pose-graph solve over the prescreened loop pairs, and the
options the cells' configurations pick by name, each a module of its own
(`lookup.py`): the descriptor family "brief" (`frontend/families/brief.py`,
Harris corners and BRIEF words) and the keyframe mode "stride"
(`vo/keyframe_modes/stride.py`). A cell whose configuration picks another
family or mode brings its module as a new file beside these (a family
whose words are not Hamming words brings its plain matcher in it); an
option with no module raises a ValueError that names the file to add.

Each part is copied from the program at the commit that adds it and is then
frozen: not edited with the program, so a later change to the program is
judged against the same arithmetic. It imports neither jax nor the
program's package.
"""
