"""Headless visualization (port of tpu3dm/viz/export.py): colored-PLY
snapshots, a self-contained HTML viewer, the iteration-trace JSON lines and
the RANSAC replay.

The reference's Open3D windows become files on disk:

  - ``export_registration_ply``: the static before/after view
    (draw_registration_result.py:20-49) as a written PLY — source painted
    yellow [1, 0.706, 0], target cyan [0, 0.651, 0.929] (the reference's
    exact colors, :36-37), source transformed by T.
  - ``export_registration_html``: the same scene as a single-file HTML
    point-cloud viewer (canvas + orbit controls, no external dependency).
  - camera defaults mirror the reference's hard-coded view (zoom/front/lookat
    /up, draw_registration_result.py:43-49).

Clouds are the port's PointClouds on any device; each file is the JAX
package's, byte for byte, from the same points, transform and trace.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tpu3dm_torch.core.cloud import PointCloud, to_numpy
from tpu3dm_torch.io.ply import write_ply

SOURCE_COLOR = (1.0, 0.706, 0.0)  # draw_registration_result.py:36
TARGET_COLOR = (0.0, 0.651, 0.929)  # draw_registration_result.py:37


def _paint(points: np.ndarray, color) -> np.ndarray:
    return np.tile(np.asarray(color, np.float64)[None, :], (points.shape[0], 1))


def export_registration_ply(
    path: str | Path,
    source: PointCloud,
    target: PointCloud,
    transformation: np.ndarray,
) -> None:
    """Write one PLY with the transformed source (yellow) + target (cyan)."""
    T = np.asarray(transformation, np.float64)
    src = to_numpy(source)["points"] @ T[:3, :3].T + T[:3, 3]
    tgt = to_numpy(target)["points"]
    pts = np.vstack([src, tgt])
    colors = np.vstack([_paint(src, SOURCE_COLOR), _paint(tgt, TARGET_COLOR)])
    write_ply(path, pts, colors=colors)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tpu3dm registration</title>
<style>body{margin:0;background:#111;color:#eee;font:12px monospace}
#info{position:fixed;top:8px;left:8px;white-space:pre}</style></head>
<body><canvas id="c"></canvas><div id="info">__INFO__
drag: rotate | wheel: zoom | shift-drag: pan</div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; const resize = () => { W = cv.width = innerWidth; H = cv.height = innerHeight; };
addEventListener('resize', resize); resize();
let rx = -1.1, rz = 0.6, zoom = __ZOOM__, panX = 0, panY = 0;
const pts = DATA.points, cols = DATA.colors, n = pts.length / 3;
// center
let cx=0, cy=0, cz=0;
for (let i=0;i<n;i++){cx+=pts[3*i];cy+=pts[3*i+1];cz+=pts[3*i+2];}
cx/=n; cy/=n; cz/=n;
let scale0 = 0;
for (let i=0;i<n;i++){const d=Math.hypot(pts[3*i]-cx,pts[3*i+1]-cy,pts[3*i+2]-cz); if(d>scale0)scale0=d;}
function draw(){
  ctx.fillStyle='#111'; ctx.fillRect(0,0,W,H);
  const s = zoom * Math.min(W,H)/(2.2*scale0);
  const cosx=Math.cos(rx),sinx=Math.sin(rx),cosz=Math.cos(rz),sinz=Math.sin(rz);
  for(let i=0;i<n;i++){
    let x=pts[3*i]-cx, y=pts[3*i+1]-cy, z=pts[3*i+2]-cz;
    let x1=x*cosz-y*sinz, y1=x*sinz+y*cosz;
    let y2=y1*cosx-z*sinx, z2=y1*sinx+z*cosx;
    const px=W/2+x1*s+panX, py=H/2-z2*s+panY;
    if(px<0||px>=W||py<0||py>=H) continue;
    ctx.fillStyle=cols[i]; ctx.fillRect(px,py,2,2);
  }
}
let drag=false, panning=false, lx=0, ly=0;
cv.onmousedown=e=>{drag=true;panning=e.shiftKey;lx=e.clientX;ly=e.clientY};
addEventListener('mouseup',()=>drag=false);
addEventListener('mousemove',e=>{if(!drag)return;
  const dx=e.clientX-lx,dy=e.clientY-ly;lx=e.clientX;ly=e.clientY;
  if(panning){panX+=dx;panY+=dy}else{rz+=dx*0.01;rx+=dy*0.01}
  requestAnimationFrame(draw);});
cv.onwheel=e=>{zoom*=e.deltaY<0?1.1:0.9;requestAnimationFrame(draw);e.preventDefault()};
draw();
</script></body></html>
"""


def export_registration_html(
    path: str | Path,
    source: PointCloud,
    target: PointCloud,
    transformation: np.ndarray,
    *,
    info: str = "",
    zoom: float = 0.7,  # reference camera zoom (draw_registration_result.py:44)
    max_points: int = 60_000,
) -> None:
    """Write a dependency-free interactive HTML viewer of the registration."""
    T = np.asarray(transformation, np.float64)
    src = to_numpy(source)["points"] @ T[:3, :3].T + T[:3, 3]
    tgt = to_numpy(target)["points"]

    def sub(a):
        if a.shape[0] > max_points // 2:
            idx = np.linspace(0, a.shape[0] - 1, max_points // 2).astype(int)
            return a[idx]
        return a

    src, tgt = sub(src), sub(tgt)
    pts = np.vstack([src, tgt]).astype(np.float32)
    col_src = "#ffb400"
    col_tgt = "#00a6ed"
    colors = [col_src] * len(src) + [col_tgt] * len(tgt)
    data = {
        "points": [round(float(v), 4) for v in pts.ravel()],
        "colors": colors,
    }
    html = (
        _HTML_TEMPLATE.replace("__DATA__", json.dumps(data))
        .replace("__INFO__", info or "tpu3dm registration")
        .replace("__ZOOM__", str(zoom))
    )
    Path(path).write_text(html)


def export_iteration_trace(
    path: str | Path,
    trace: list[dict],
) -> None:
    """Persist a RANSAC/ICP iteration trace as JSONL — the headless analog of
    the reference GUI's live CurFit/BestFit labels and step log
    (_visualize_matcher.py:452-466,489-490)."""
    with open(path, "w") as f:
        for row in trace:
            f.write(json.dumps(row) + "\n")


_ANIM_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tpu3dm RANSAC replay</title>
<style>body{margin:0;background:#111;color:#eee;font:12px monospace}
#info{position:fixed;top:8px;left:8px;white-space:pre}
#bar{position:fixed;bottom:8px;left:8px;right:8px;display:flex;gap:8px;align-items:center}
#scrub{flex:1}button{font:12px monospace}</style></head>
<body><canvas id="c"></canvas><div id="info"></div>
<div id="bar"><button id="play">pause</button>
<input id="scrub" type="range" min="0" value="0" step="1"></div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const info = document.getElementById('info');
const scrub = document.getElementById('scrub');
const playBtn = document.getElementById('play');
let W, H; const resize = () => { W = cv.width = innerWidth; H = cv.height = innerHeight; };
addEventListener('resize', resize); resize();
let rx = -1.1, rz = 0.6, zoom = __ZOOM__, panX = 0, panY = 0;
const src = DATA.src, tgt = DATA.tgt, frames = DATA.frames;
scrub.max = frames.length - 1;
const ns = src.length / 3, nt = tgt.length / 3;
let cx=0, cy=0, cz=0;
for (let i=0;i<nt;i++){cx+=tgt[3*i];cy+=tgt[3*i+1];cz+=tgt[3*i+2];}
cx/=nt; cy/=nt; cz/=nt;
let scale0 = 0;
for (let i=0;i<nt;i++){const d=Math.hypot(tgt[3*i]-cx,tgt[3*i+1]-cy,tgt[3*i+2]-cz); if(d>scale0)scale0=d;}
let fi = 0, playing = true;
function project(x, y, z, s, cosx, sinx, cosz, sinz){
  x-=cx; y-=cy; z-=cz;
  const x1=x*cosz-y*sinz, y1=x*sinz+y*cosz;
  const z2=y1*sinx+z*cosx;
  return [W/2+x1*s+panX, H/2-z2*s+panY];
}
function draw(){
  ctx.fillStyle='#111'; ctx.fillRect(0,0,W,H);
  const s = zoom * Math.min(W,H)/(2.2*scale0);
  const cosx=Math.cos(rx),sinx=Math.sin(rx),cosz=Math.cos(rz),sinz=Math.sin(rz);
  ctx.fillStyle='#00a6ed';
  for(let i=0;i<nt;i++){
    const p=project(tgt[3*i],tgt[3*i+1],tgt[3*i+2],s,cosx,sinx,cosz,sinz);
    if(p[0]>=0&&p[0]<W&&p[1]>=0&&p[1]<H) ctx.fillRect(p[0],p[1],2,2);
  }
  const f = frames[fi], T = f.T;
  ctx.fillStyle='#ffb400';
  for(let i=0;i<ns;i++){
    const x=src[3*i], y=src[3*i+1], z=src[3*i+2];
    const tx=T[0][0]*x+T[0][1]*y+T[0][2]*z+T[0][3];
    const ty=T[1][0]*x+T[1][1]*y+T[1][2]*z+T[1][3];
    const tz=T[2][0]*x+T[2][1]*y+T[2][2]*z+T[2][3];
    const p=project(tx,ty,tz,s,cosx,sinx,cosz,sinz);
    if(p[0]>=0&&p[0]<W&&p[1]>=0&&p[1]<H) ctx.fillRect(p[0],p[1],2,2);
  }
  info.textContent = `__INFO__
iteration ${f.it}  CurFit ${f.cur.toFixed(4)}  BestFit ${f.best.toFixed(4)}` +
    (f.stop ? '  [early stop]' : '') + `
drag: rotate | wheel: zoom | shift-drag: pan | space: play/pause`;
  scrub.value = fi;
}
function tick(){
  if (playing){ fi = (fi + 1) % frames.length; draw(); }
  setTimeout(tick, __DELAY_MS__);
}
scrub.oninput = () => { fi = +scrub.value; playing = false; playBtn.textContent='play'; draw(); };
playBtn.onclick = () => { playing = !playing; playBtn.textContent = playing ? 'pause':'play'; };
addEventListener('keydown', e => { if (e.code==='Space'){ playBtn.onclick(); e.preventDefault(); }});
let drag=false, panning=false, lx=0, ly=0;
cv.onmousedown=e=>{drag=true;panning=e.shiftKey;lx=e.clientX;ly=e.clientY};
addEventListener('mouseup',()=>drag=false);
addEventListener('mousemove',e=>{if(!drag)return;
  const dx=e.clientX-lx,dy=e.clientY-ly;lx=e.clientX;ly=e.clientY;
  if(panning){panX+=dx;panY+=dy}else{rz+=dx*0.01;rx+=dy*0.01}
  requestAnimationFrame(draw);});
cv.onwheel=e=>{zoom*=e.deltaY<0?1.1:0.9;requestAnimationFrame(draw);e.preventDefault()};
draw(); tick();
</script></body></html>
"""


def export_ransac_animation_html(
    path: str | Path,
    source: PointCloud,
    target: PointCloud,
    trace: list[dict],
    *,
    info: str = "tpu3dm RANSAC replay",
    zoom: float = 0.7,
    max_points: int = 40_000,
    frame_delay_ms: int = 60,
) -> None:
    """Replay the RANSAC search as an animated HTML scene.

    The headless analog of the reference GUI's live animation
    (_visualize_matcher.py:452-466: the displayed source cloud is re-posed to
    the current best transform every update_interval iterations, with
    CurFit/BestFit labels).  Each trace row from ``traced_ransac`` becomes one
    frame: the yellow source cloud is re-posed client-side by that chunk's
    best transform over the static cyan target, with play/pause/scrub.
    ``frame_delay_ms`` mirrors MatcherSettings.visualization_delay (:162).

    Requires trace rows with a ``best_T`` entry (traced_ransac records it).
    """
    rows = [r for r in trace if "best_T" in r]
    if not rows:
        raise ValueError("trace has no best_T entries (need traced_ransac output)")
    src = to_numpy(source)["points"]
    tgt = to_numpy(target)["points"]

    def sub(a):
        if a.shape[0] > max_points // 2:
            idx = np.linspace(0, a.shape[0] - 1, max_points // 2).astype(int)
            return a[idx]
        return a

    src, tgt = sub(src), sub(tgt)
    frames = [
        {
            "it": r["iteration"],
            "cur": r["current_fitness"],
            "best": r["best_fitness"],
            "stop": bool(r.get("early_stop", False)),
            "T": r["best_T"],
        }
        for r in rows
    ]
    data = {
        "src": [round(float(v), 4) for v in src.astype(np.float32).ravel()],
        "tgt": [round(float(v), 4) for v in tgt.astype(np.float32).ravel()],
        "frames": frames,
    }
    html = (
        _ANIM_TEMPLATE.replace("__DATA__", json.dumps(data))
        .replace("__INFO__", info)
        .replace("__ZOOM__", str(zoom))
        .replace("__DELAY_MS__", str(frame_delay_ms))
    )
    Path(path).write_text(html)
