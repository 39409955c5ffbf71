"""Debug visualization: BEV and 3D renders of point clouds + boxes.

The port's copy of `ssd3d/utils/viz.py`, numpy only. `dump_scene_html` and
the corner helpers are the original's (tests/test_torch_data.py holds the
HTML byte for byte). `draw_bev` and `draw_scene_3d` keep the original's
signatures and colours but rasterize with numpy and write the PNG with
zlib, where the original draws with matplotlib: the port's trainer writes
these images at every checkpoint, also where matplotlib is not installed.
The rasterized images carry no axes, text or score labels.

Counterpart of the reference's mayavi viewer (mayavi/viz_util.py:39
draw_lidar, :111 draw_gt_boxes3d) and 2D corner projector (demo_utils.py),
but headless; `dump_scene_html` writes a self-contained interactive 3D
viewer (inline canvas renderer, drag to orbit — no network, no external
scripts)."""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

# 12 wireframe edges over the corner order of geometry.boxes_to_corners
# (bottom face 0-3, top face 4-7) — same loop structure as the reference's
# draw_gt_boxes3d (mayavi/viz_util.py:123-136)
_BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
              (4, 5), (5, 6), (6, 7), (7, 4),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def _corners_3d(boxes: np.ndarray) -> np.ndarray:
    """numpy twin of geometry.boxes_to_corners: box_3d [m,7] (bottom-center
    y, camera coords) -> [m, 8, 3]."""
    boxes = np.asarray(boxes, np.float64)
    x, y, z = boxes[:, 0], boxes[:, 1], boxes[:, 2]
    l, h, w, ry = boxes[:, 3], boxes[:, 4], boxes[:, 5], boxes[:, 6]
    hl, hw = l / 2.0, w / 2.0
    zero = np.zeros_like(l)
    xs = np.stack([hl, hl, -hl, -hl] * 2, 1)
    ys = np.stack([zero] * 4 + [-h] * 4, 1)
    zs = np.stack([hw, -hw, -hw, hw] * 2, 1)
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    rx = c * xs + s * zs
    rz = -s * xs + c * zs
    return np.stack([rx + x[:, None], ys + y[:, None], rz + z[:, None]], -1)


def _bev_corners(boxes: np.ndarray) -> np.ndarray:
    x, z = boxes[:, 0], boxes[:, 2]
    half_l, half_w = boxes[:, 3] / 2.0, boxes[:, 5] / 2.0
    ry = boxes[:, 6]
    lx = np.stack([half_l, -half_l, -half_l, half_l], 1)
    lz = np.stack([half_w, half_w, -half_w, -half_w], 1)
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    return np.stack(
        [c * lx + s * lz + x[:, None], -s * lx + c * lz + z[:, None]], -1
    )


_GT_RGB = (0x2A, 0x9D, 0x3F)
_PRED_RGB = (0xE7, 0x6F, 0x2A)


def write_rgb_png(path: str, img: np.ndarray) -> str:
    """img: uint8 [h, w, 3] -> an 8-bit RGB PNG at `path`."""
    h, w, _ = img.shape

    def chunk(typ, data):
        c = typ + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
    return path


class _Canvas:
    """A white RGB image with data coordinates (u right, v up) mapped onto
    it by `extent` ((u_lo, u_hi), (v_lo, v_hi))."""

    def __init__(self, width: int, height: int, extent):
        self.img = np.full((height, width, 3), 255, np.uint8)
        (self.u0, u1), (self.v0, v1) = extent
        self.su = (width - 1) / max(u1 - self.u0, 1e-9)
        self.sv = (height - 1) / max(v1 - self.v0, 1e-9)

    def _px(self, u, v):
        col = np.round((np.asarray(u, np.float64) - self.u0) * self.su).astype(np.int64)
        row = np.round((np.asarray(v, np.float64) - self.v0) * self.sv).astype(np.int64)
        return self.img.shape[0] - 1 - row, col

    def dots(self, u, v, rgb):
        """rgb: one colour (3,) or one per dot [n, 3]."""
        row, col = self._px(u, v)
        ok = (row >= 0) & (row < self.img.shape[0]) & (col >= 0) & (col < self.img.shape[1])
        rgb = np.asarray(rgb, np.uint8)
        self.img[row[ok], col[ok]] = rgb[ok] if rgb.ndim == 2 else rgb

    def line(self, a, b, rgb):
        """A segment from a = (u, v) to b, a dot at every pixel it crosses."""
        (ra, ca), (rb, cb) = self._px(*a), self._px(*b)
        n = int(max(abs(rb - ra), abs(cb - ca), 1)) + 1
        if n > 4 * sum(self.img.shape[:2]):  # far outside the view
            return
        t = np.linspace(0.0, 1.0, n)
        self.dots(a[0] + t * (b[0] - a[0]), a[1] + t * (b[1] - a[1]), rgb)


def draw_bev(points: np.ndarray, path: str, gt_boxes=None, pred_boxes=None,
             pred_scores=None, extent=((-40, 40), (0, 70)), title=""):
    """Save a BEV (x-z) image of the points (grey) with optional GT (green)
    and predicted (orange) box footprints. points: [n, >=3]; boxes: [m, 7]
    box_3d. `pred_scores` and `title` are accepted for the original's
    signature and not drawn."""
    span_u = extent[0][1] - extent[0][0]
    span_v = extent[1][1] - extent[1][0]
    width = 800
    canvas = _Canvas(width, max(int(round(width * span_v / span_u)), 1), extent)
    pts = np.asarray(points)
    canvas.dots(pts[:, 0], pts[:, 2], (0x55, 0x55, 0x55))
    for boxes, rgb in ((gt_boxes, _GT_RGB), (pred_boxes, _PRED_RGB)):
        if boxes is None or not len(boxes):
            continue
        for quad in _bev_corners(np.asarray(boxes, np.float64)):
            for k in range(4):
                canvas.line(quad[k], quad[(k + 1) % 4], rgb)
    return write_rgb_png(path, canvas.img)


def draw_scene_3d(points: np.ndarray, path: str, gt_boxes=None,
                  pred_boxes=None, pred_scores=None, max_points=30000,
                  elev=18.0, azim=-100.0, title=""):
    """Save a 3D render: lidar points (height-coloured, blue low to yellow
    high) + GT (green) and predicted (orange) wireframe boxes, in an
    orthographic view `elev` degrees above the horizon, turned `azim`
    degrees about the vertical. Headless stand-in for the reference's
    mayavi draw_lidar + draw_gt_boxes3d (viz_util.py:39,111).

    points: [n, >=3] in KITTI camera coords (x right, y down, z forward);
    rendered with z forward / x right / -y up. boxes: [m, 7] box_3d.
    `pred_scores` and `title` are accepted for the original's signature and
    not drawn."""
    pts = np.asarray(points)[:, :3].astype(np.float64)
    if len(pts) > max_points:
        pts = pts[np.random.default_rng(0).choice(
            len(pts), max_points, replace=False)]
    a, e = np.deg2rad(azim), np.deg2rad(elev)

    def view(xyz):
        # world (x, z, up) -> screen (u, v): turn by azim about up, tilt by elev
        x, z, up = xyz[..., 0], xyz[..., 2], -xyz[..., 1]
        depth = -np.sin(a) * x + np.cos(a) * z
        u = np.cos(a) * x + np.sin(a) * z
        return u, np.cos(e) * up + np.sin(e) * depth

    u, v = view(pts)
    if len(pts):
        lo, hi = np.array([u.min(), v.min()]), np.array([u.max(), v.max()])
    else:
        lo, hi = np.zeros(2), np.ones(2)
    pad = 0.03 * np.maximum(hi - lo, 1.0)
    extent = ((lo[0] - pad[0], hi[0] + pad[0]), (lo[1] - pad[1], hi[1] + pad[1]))
    width = 1000
    aspect = (extent[1][1] - extent[1][0]) / (extent[0][1] - extent[0][0])
    canvas = _Canvas(width, int(np.clip(round(width * aspect), 200, 1000)), extent)
    height = -pts[:, 1]
    t = (height - height.min()) / max(np.ptp(height), 1e-6) if len(pts) else height
    rgb = np.stack([68 + 185 * t, 1 + 230 * t, 84 - 47 * t], 1)
    canvas.dots(u, v, np.clip(rgb, 0, 255).astype(np.uint8))
    for boxes, color in ((gt_boxes, _GT_RGB), (pred_boxes, _PRED_RGB)):
        if boxes is None or not len(boxes):
            continue
        for corner in _corners_3d(boxes):
            cu, cv = view(corner)
            for i, j in _BOX_EDGES:
                canvas.line((cu[i], cv[i]), (cu[j], cv[j]), color)
    return write_rgb_png(path, canvas.img)


_HTML_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ssd3d scene</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace}
canvas{display:block}#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud">drag: orbit &middot; wheel: zoom &middot; %(n_pts)d pts
&middot; <span style="color:#2a9d3f">gt</span>
<span style="color:#e76f2a">pred</span></div>
<canvas id="c"></canvas><script>
const PTS=%(pts)s, GT=%(gt)s, PRED=%(pred)s, EDGES=%(edges)s;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let yaw=-1.9,pitch=0.35,dist=65,cx=0,cz=25;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw()}
function proj(p){ // camera coords: x right, y down, z fwd -> orbit cam
  const X=p[0]-cx,Y=-p[1],Z=p[2]-cz;
  const cy_=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  const x1=cy_*X+sy*Z, z1=-sy*X+cy_*Z;
  const y2=cp*Y-sp*z1, z2=sp*Y+cp*z1+dist;
  if(z2<0.5)return null;
  const f=0.9*Math.min(cv.width,cv.height);
  return [cv.width/2+f*x1/z2, cv.height/2-f*y2/z2, z2];}
function draw(){ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
  for(const p of PTS){const s=proj(p);if(!s)continue;
    const t=Math.max(0,Math.min(1,(-p[1]+2)/4));
    ctx.fillStyle=`rgb(${40+160*t},${80+120*t},${255-130*t})`;
    ctx.fillRect(s[0],s[1],1.4,1.4);}
  function box(corners,color){ctx.strokeStyle=color;ctx.beginPath();
    for(const e of EDGES){const a=proj(corners[e[0]]),b=proj(corners[e[1]]);
      if(!a||!b)continue;ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);}
    ctx.stroke();}
  for(const c of GT)box(c,'#2a9d3f');
  for(const c of PRED)box(c,'#e76f2a');}
let dragging=false,lx=0,ly=0;
cv.onmousedown=e=>{dragging=true;lx=e.clientX;ly=e.clientY};
onmouseup=()=>dragging=false;
onmousemove=e=>{if(!dragging)return;yaw+=(e.clientX-lx)*0.005;
  pitch=Math.max(-1.4,Math.min(1.4,pitch+(e.clientY-ly)*0.005));
  lx=e.clientX;ly=e.clientY;draw()};
cv.onwheel=e=>{dist=Math.max(5,dist*(e.deltaY>0?1.1:0.9));draw();
  e.preventDefault()};
onresize=resize;resize();
</script></body></html>
"""


def dump_scene_html(points: np.ndarray, path: str, gt_boxes=None,
                    pred_boxes=None, max_points=20000):
    """Write a self-contained interactive 3D scene viewer (single HTML
    file, inline canvas renderer, no external resources). The 3D analog of
    the reference's mayavi interactive window for headless environments."""
    pts = np.asarray(points)[:, :3]
    if len(pts) > max_points:
        pts = pts[np.random.default_rng(0).choice(
            len(pts), max_points, replace=False)]

    def corners_list(boxes):
        if boxes is None or len(boxes) == 0:
            return []
        return np.round(_corners_3d(boxes), 3).tolist()

    html = _HTML_TEMPLATE % {
        "n_pts": len(pts),
        "pts": json.dumps(np.round(pts, 3).tolist()),
        "gt": json.dumps(corners_list(gt_boxes)),
        "pred": json.dumps(corners_list(pred_boxes)),
        "edges": json.dumps(_BOX_EDGES),
    }
    with open(path, "w") as f:
        f.write(html)
    return path
