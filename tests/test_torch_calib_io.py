"""The port's rig files (`sosvo_torch.sensor.calib_io`) against the JAX
package's (`sosvo.sensor.calib_io`).

Held: for `default_rig` (two image sizes) and for a rig with non-zero
full-GUM terms (k1 k2 p1 p2 mis_rx mis_ry) and z offsets, each package's
`save_rig` writes the other's JSON text; a file written by either loads in
the port to the values `convert.rig_from_numpy` gives for the JAX
package's load of it, bit for bit; a file without the GUM keys loads
them as zeros in both.
"""

import json

import numpy as np
import pytest
import torch

from sosvo.sensor import calib_io as jcalib
from sosvo.sensor.model import ViewParams as JaxViewParams
from sosvo.sensor.rig import OmnistereoRig as JaxRig
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo_torch.convert import rig_from_numpy
from sosvo_torch.sensor import calib_io as tcalib


def _gum_rig():
    base = jax_default_rig(image_size=512)
    top = JaxViewParams.create(xi=0.94, fx=101.5, fy=100.25, cx=255.75, cy=256.1,
                               min_elevation=-0.61, max_elevation=0.27, z_offset=0.003,
                               k1=-0.041, k2=0.0062, p1=1.3e-4, p2=-7.5e-5, mis_rx=0.0021,
                               mis_ry=-0.0013)
    bottom = base.bottom._replace(k1=np.float32(0.02), mis_ry=np.float32(4e-3))
    return JaxRig(top=top, bottom=bottom, baseline=np.float32(0.1234), image_height=512,
                  image_width=512)


RIGS = {"default_768": lambda: jax_default_rig(), "default_384": lambda: jax_default_rig(384),
        "gum": _gum_rig}


def _equal(a, b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip(a.top, b.top))
            and all(torch.equal(x, y) for x, y in zip(a.bottom, b.bottom))
            and torch.equal(a.baseline, b.baseline)
            and (a.image_height, a.image_width) == (b.image_height, b.image_width))


@pytest.mark.parametrize("name", list(RIGS))
def test_json_text_equal_both_ways(tmp_path, name):
    jrig = RIGS[name]()
    jcalib.save_rig(tmp_path / "jax.json", jrig)
    tcalib.save_rig(tmp_path / "torch.json", rig_from_numpy(jrig, "cpu"))
    assert (tmp_path / "jax.json").read_text() == (tmp_path / "torch.json").read_text()
    # and back: the port's load of the JAX file, written again by the port,
    # is the JAX package's load written by it
    jcalib.save_rig(tmp_path / "jax2.json", jcalib.load_rig(tmp_path / "jax.json"))
    tcalib.save_rig(tmp_path / "torch2.json", tcalib.load_rig(tmp_path / "jax.json", "cpu"))
    assert (tmp_path / "jax2.json").read_text() == (tmp_path / "torch2.json").read_text()


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("name", list(RIGS))
def test_loaded_values_equal_reference_load(tmp_path, name, writer):
    jrig = RIGS[name]()
    p = tmp_path / "rig.json"
    if writer == "jax":
        jcalib.save_rig(p, jrig)
    else:
        tcalib.save_rig(p, rig_from_numpy(jrig, "cpu"))
    got = tcalib.load_rig(p, device="cpu")
    assert got.baseline.dtype == torch.float32 and got.top.k1.device.type == "cpu"
    assert _equal(got, rig_from_numpy(jcalib.load_rig(p), "cpu"))


def test_missing_gum_terms_default_to_zero(tmp_path):
    p = tmp_path / "rig.json"
    jcalib.save_rig(p, jax_default_rig(256))
    d = json.loads(p.read_text())
    for view in ("top", "bottom"):
        for k in ("z_offset", "k1", "k2", "p1", "p2", "mis_rx", "mis_ry"):
            del d[view][k]
    p.write_text(json.dumps(d))
    got = tcalib.load_rig(p, device="cpu")
    assert _equal(got, rig_from_numpy(jcalib.load_rig(p), "cpu"))
    assert float(got.bottom.z_offset) == 0.0 and float(got.top.mis_ry) == 0.0
