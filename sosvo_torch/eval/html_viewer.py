"""Interactive 3D trajectory + map viewer: one self-contained HTML file
(counterpart of `sosvo/eval/html_viewer.py`, numpy only).

A headless machine has no display, so the interactive artifact is one HTML
file with an embedded canvas renderer (orbit, zoom, pan, hover readout,
ground-truth toggle) that needs no library and no network. The command
line's `--viz` writes it beside the static PNG and PLY artifacts.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>sosvo 3D viewer</title>
<style>
 body {{ margin:0; background:#111; color:#ddd; font:13px monospace; overflow:hidden }}
 #hud {{ position:fixed; top:8px; left:10px; user-select:none }}
 #hud b {{ color:#fff }}
 canvas {{ display:block }}
 .sw {{ display:inline-block; width:10px; height:10px; margin:0 4px -1px 10px }}
</style></head><body>
<div id="hud"><b>sosvo</b> {title} &mdash; drag: orbit &middot; wheel: zoom &middot; shift-drag: pan &middot; g: toggle GT
 <span class="sw" style="background:#4ec9ff"></span>estimate
 <span class="sw" style="background:#ffb64e"></span>ground truth
 <span class="sw" style="background:#7a7a7a"></span>landmarks
 <span id="ro"></span></div>
<canvas id="c"></canvas>
<script>
const DATA = {data_json};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; const resize = () => {{ W = cv.width = innerWidth; H = cv.height = innerHeight; }};
addEventListener('resize', () => {{ resize(); draw(); }}); resize();
// center/scale from the estimate trajectory
const all = DATA.traj.concat(DATA.gt.length ? DATA.gt : []);
const ctr = [0,1,2].map(i => all.reduce((s,p)=>s+p[i],0)/all.length);
let rad = Math.max(0.5, ...all.map(p => Math.hypot(p[0]-ctr[0],p[1]-ctr[1],p[2]-ctr[2])));
let yaw = 0.8, pitch = 0.5, dist = rad*3.2, panX = 0, panY = 0, showGT = true;
function proj(p) {{
  const x = p[0]-ctr[0], y = p[1]-ctr[1], z = p[2]-ctr[2];
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const x1 =  cy*x + sy*y, y1 = -sy*x + cy*y;          // yaw about +z
  const y2 =  cp*y1 - sp*z, z2 = sp*y1 + cp*z;         // pitch
  const zc = dist + y2;                                 // camera depth
  if (zc <= 0.05) return null;
  const f = 0.9*Math.min(W,H)/ (2*Math.tan(0.4));
  return [W/2 + panX + f*x1/zc, H/2 + panY - f*z2/zc, zc];
}}
function polyline(pts, color, lw) {{
  ctx.strokeStyle = color; ctx.lineWidth = lw; ctx.beginPath();
  let pen = false;
  for (const p of pts) {{
    const s = proj(p);
    if (!s) {{ pen = false; continue; }}
    if (pen) ctx.lineTo(s[0], s[1]); else ctx.moveTo(s[0], s[1]);
    pen = true;
  }}
  ctx.stroke();
}}
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0,0,W,H);
  // landmarks: depth-shaded points
  for (const p of DATA.lm) {{
    const s = proj(p); if (!s) continue;
    const shade = Math.max(60, 190 - 28*(s[2]/rad));
    ctx.fillStyle = `rgb(${{shade}},${{shade}},${{shade}})`;
    ctx.fillRect(s[0]-1, s[1]-1, 2, 2);
  }}
  if (showGT && DATA.gt.length) polyline(DATA.gt, '#ffb64e', 1.4);
  polyline(DATA.traj, '#4ec9ff', 2.0);
  const s0 = proj(DATA.traj[0]);
  if (s0) {{ ctx.fillStyle = '#4eff88'; ctx.beginPath();
             ctx.arc(s0[0], s0[1], 4, 0, 6.3); ctx.fill(); }}
}}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {{
  if (!drag) return;
  const dx = e.clientX-drag[0], dy = e.clientY-drag[1];
  if (drag[2]) {{ panX += dx; panY += dy; }}
  else {{ yaw += dx*0.008; pitch = Math.max(-1.5, Math.min(1.5, pitch + dy*0.008)); }}
  drag = [e.clientX, e.clientY, drag[2]]; draw();
}});
cv.onwheel = e => {{ dist *= Math.exp(e.deltaY*0.001); e.preventDefault(); draw(); }};
addEventListener('keydown', e => {{ if (e.key === 'g') {{ showGT = !showGT; draw(); }} }});
document.getElementById('ro').textContent =
  `  ${{DATA.traj.length}} poses, ${{DATA.lm.length}} landmarks` +
  (DATA.ate != null ? `, ATE ${{DATA.ate.toFixed(4)}} m` : '');
draw();
</script></body></html>
"""


def export_html_viewer(
    path: str | Path,
    traj: np.ndarray,
    traj_gt: np.ndarray | None = None,
    landmarks: np.ndarray | None = None,
    lm_valid: np.ndarray | None = None,
    ate: float | None = None,
    title: str = "trajectory + map",
    max_landmarks: int = 20000,
) -> Path:
    """Write the self-contained interactive viewer.

    Args:
      traj: (F, 4, 4) world-from-rig poses or (F, 3) positions.
      traj_gt: optional ground-truth trajectory, same formats.
      landmarks: optional (L, 3) world points (map cloud).
      lm_valid: optional (L,) mask for `landmarks`.
      ate: optional ATE RMSE to show in the HUD.
    """
    def positions(T):
        T = np.asarray(T, np.float32)
        return T[:, :3, 3] if T.ndim == 3 else T

    pts = positions(traj)
    gt = positions(traj_gt) if traj_gt is not None else np.zeros((0, 3), np.float32)
    if landmarks is not None:
        lm = np.asarray(landmarks, np.float32)
        if lm_valid is not None:
            lm = lm[np.asarray(lm_valid, bool)]
        if lm.shape[0] > max_landmarks:
            lm = lm[:: lm.shape[0] // max_landmarks + 1]
    else:
        lm = np.zeros((0, 3), np.float32)

    data = {
        "traj": np.round(pts, 5).tolist(),
        "gt": np.round(gt, 5).tolist(),
        "lm": np.round(lm, 4).tolist(),
        "ate": None if ate is None else float(ate),
    }
    path = Path(path)
    path.write_text(_TEMPLATE.format(title=title, data_json=json.dumps(data)))
    return path
