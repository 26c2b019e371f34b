"""Descriptor families, one module each, looked up by
`FrontendConfig.descriptor`: `brief.py` is the family "brief".

A family's module gives

  view_features(cfg, pano, view, geom) -> (uv, rays, desc, valid)
      one view's K feature slots from its warped panorama: detection,
      description, and the lift to rays and raw pixels
      (`image_frontend._lift`, shared);
  metric_params(fe) -> (metric, max_distance)
      what every descriptor match takes: "hamming" for 256-bit words in
      8 int32s, which the shared plain Hamming matcher
      (`frontend.match.match_stats`) takes, or the family's own name for
      words that it matches itself, with
  match(desc_a, desc_b, valid_a, valid_b, max_distance, ratio, az_a, az_b, band)
      -> MatchResult, its plain matcher (`kernels.match_metric`'s contract),
      which only a family whose words are not Hamming words gives.
"""

from __future__ import annotations

from vobench.reference.lookup import part


def family(name: str):
    """The module of descriptor family `name`."""
    return part(__name__, name, "descriptor family")
