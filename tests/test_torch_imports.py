"""The port imports without jax and without the JAX package.

A fresh interpreter with `sys.modules["jax"] = None` (any `import jax` then
raises) imports every module of `sosvo_torch`; none may pull in `sosvo`,
and none imports matplotlib until it draws (the card's machine has none).
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import sosvo_torch
names = [m.name for m in pkgutil.walk_packages(sosvo_torch.__path__, "sosvo_torch.")]
assert {"sosvo_torch.backend.pose_graph", "sosvo_torch.vo.loop_closure",
        "sosvo_torch.synth.render", "sosvo_torch.frontend.panorama", "sosvo_torch.frontend.detect",
        "sosvo_torch.frontend.descriptor", "sosvo_torch.frontend.akaze",
        "sosvo_torch.frontend.image_frontend",
        "sosvo_torch.vo.image_pipeline", "sosvo_torch.tools.frontend_parity",
        "sosvo_torch.vo.batched", "sosvo_torch.utils.framelog", "sosvo_torch.utils.checkpoint",
        "sosvo_torch.cli", "sosvo_torch.dist.mesh", "sosvo_torch.dist.launch",
        "sosvo_torch.dist.ba_dist", "sosvo_torch.dist.replay_dist", "sosvo_torch.dist.pgo_time",
        "sosvo_torch.dist.loops_dist", "sosvo_torch.dist.c3_dist", "sosvo_torch.dist.scaling",
        "sosvo_torch.dist.dryrun", "sosvo_torch.data.sequence", "sosvo_torch.data.native_loader",
        "sosvo_torch.sensor.calib_io", "sosvo_torch.tools.stage_sequence",
        "sosvo_torch.vo.live", "sosvo_torch.sensor.rig", "sosvo_torch.synth.board",
        "sosvo_torch.calib.fit", "sosvo_torch.calib.boards", "sosvo_torch.calib.corners",
        "sosvo_torch.eval.plots", "sosvo_torch.eval.viz", "sosvo_torch.eval.html_viewer",
        "sosvo_torch.utils.debug", "sosvo_torch.utils.phases",
        "sosvo_torch.utils.profiling"} <= set(names), names
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "sosvo" or m.startswith("sosvo.")
             or (m.startswith("jax") and sys.modules[m] is not None))
assert not bad, bad
# the plots and viewers import matplotlib where they draw, not at import
assert "matplotlib" not in sys.modules
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # every module was walked, the loop-closure, image, batched, dist, descriptor,
    # staged-capture and calibration, viewer and utils slices' too
    assert int(out.stdout.strip()) >= 85
