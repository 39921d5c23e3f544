"""Offline map/trajectory visualization (the reference's Viewer, L9).

The reference renders a live Pangolin/OpenGL UI (`/root/reference/src/
Viewer.cc`, ``MapDrawer::DrawMapPoints/DrawKeyFrames``); an accelerator host has no
display, so observability is offline/streamed instead (SURVEY §5):

- :func:`save_map_png` — matplotlib top-down + side orthographic views of
  map points, keyframe frusta and the trajectory.
- :func:`export_map_html` — a single self-contained HTML file with an
  embedded JSON snapshot and a dependency-free canvas orbit viewer
  (rotate/zoom with the mouse); works anywhere a browser exists, no
  network access required.

Both read the same snapshot dict from :func:`map_snapshot`.
"""

from __future__ import annotations

import json

import numpy as np


def map_snapshot(slam) -> dict:
    """Extract a plain-numpy snapshot of the map + trajectory."""
    m = slam.m
    mp_valid = np.asarray(m.mp_valid)
    pts = np.asarray(m.mp_pos)[mp_valid]
    kf_valid = np.asarray(m.kf_valid)
    Rcw = np.asarray(m.kf_Rcw)[kf_valid]
    tcw = np.asarray(m.kf_tcw)[kf_valid]
    centers = -np.einsum("kji,kj->ki", Rcw, tcw)
    traj = slam.positions() if slam.trajectory else np.zeros((0, 3))
    # covisibility edges (downsampled)
    obs = np.asarray(m.obs_mat).astype(np.float32)
    covis = obs @ obs.T
    ii, jj = np.nonzero(np.triu(covis, 1) >= 30)
    keep = kf_valid[ii] & kf_valid[jj]
    kf_index = np.cumsum(kf_valid) - 1
    edges = np.stack([kf_index[ii[keep]], kf_index[jj[keep]]], -1) if keep.any() else np.zeros((0, 2), int)
    return {
        "points": pts.tolist(),
        "kf_centers": centers.tolist(),
        "kf_Rcw": Rcw.tolist(),
        "trajectory": np.asarray(traj).tolist(),
        "covis_edges": edges.tolist(),
        "n_kf": int(kf_valid.sum()),
        "n_mp": int(mp_valid.sum()),
    }


def save_map_png(slam, path: str, dpi: int = 120):
    """Two orthographic views (x-z top-down, x-y front) of the map."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    s = map_snapshot(slam)
    pts = np.asarray(s["points"]).reshape(-1, 3)
    kfs = np.asarray(s["kf_centers"]).reshape(-1, 3)
    trj = np.asarray(s["trajectory"]).reshape(-1, 3)

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    for ax, (a, b), name in zip(axes, [(0, 2), (0, 1)], ["top (x-z)", "front (x-y)"]):
        if len(pts):
            ax.scatter(pts[:, a], pts[:, b], s=1, c="#777777", alpha=0.4,
                       label=f"{s['n_mp']} points")
        if len(trj):
            ax.plot(trj[:, a], trj[:, b], "-", c="#1565c0", lw=1.2,
                    label="trajectory")
        if len(kfs):
            ax.scatter(kfs[:, a], kfs[:, b], s=14, c="#2e7d32", marker="s",
                       label=f"{s['n_kf']} keyframes")
        ax.set_title(name)
        ax.set_aspect("equal")
        ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>orb-slam3-noted map</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;top:8px;left:8px}</style></head>
<body><canvas id="c"></canvas><div id="hud"></div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw=0.6, pitch=0.35, dist=null, cx=0, cy=0, cz=0, drag=null;
function fit(){const P=DATA.points.concat(DATA.trajectory);
 if(!P.length){dist=10;return} let lo=[1e9,1e9,1e9],hi=[-1e9,-1e9,-1e9];
 for(const p of P){for(let k=0;k<3;k++){lo[k]=Math.min(lo[k],p[k]);hi[k]=Math.max(hi[k],p[k]);}}
 cx=(lo[0]+hi[0])/2;cy=(lo[1]+hi[1])/2;cz=(lo[2]+hi[2])/2;
 dist=2.2*Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-3);}
function proj(p){const sy=Math.sin(yaw),cyw=Math.cos(yaw),sp=Math.sin(pitch),cp=Math.cos(pitch);
 let x=p[0]-cx,y=p[1]-cy,z=p[2]-cz;
 let x1=cyw*x+sy*z, z1=-sy*x+cyw*z;
 let y2=cp*y-sp*z1, z2=sp*y+cp*z1+dist;
 if(z2<1e-3)return null; const f=0.9*Math.min(cv.width,cv.height);
 return [cv.width/2+f*x1/z2, cv.height/2+f*y2/z2];}
function draw(){cv.width=innerWidth;cv.height=innerHeight;
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 ctx.fillStyle='#9e9e9e';
 for(const p of DATA.points){const q=proj(p);if(q)ctx.fillRect(q[0],q[1],1.4,1.4);}
 ctx.strokeStyle='#1e88e5';ctx.beginPath();let first=true;
 for(const p of DATA.trajectory){const q=proj(p);if(!q)continue;
  first?ctx.moveTo(q[0],q[1]):ctx.lineTo(q[0],q[1]);first=false;}
 ctx.stroke();
 ctx.strokeStyle='#2e7d3255';ctx.beginPath();
 for(const [i,j] of DATA.covis_edges){const a=proj(DATA.kf_centers[i]),b=proj(DATA.kf_centers[j]);
  if(a&&b){ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);}}
 ctx.stroke();
 ctx.fillStyle='#66bb6a';
 for(const p of DATA.kf_centers){const q=proj(p);if(q)ctx.fillRect(q[0]-2,q[1]-2,4,4);}
 document.getElementById('hud').textContent=
  `${DATA.n_kf} keyframes · ${DATA.n_mp} map points · drag to orbit, wheel to zoom`;}
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-drag[0])*0.008;
 pitch+=(e.clientY-drag[1])*0.008;drag=[e.clientX,e.clientY];draw();};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();};
window.onresize=draw; fit(); draw();
</script></body></html>
"""


def export_map_html(slam, path: str):
    """Write a self-contained interactive 3D map viewer."""
    snap = map_snapshot(slam)
    html = _HTML_TEMPLATE.replace("__DATA__", json.dumps(snap))
    with open(path, "w") as f:
        f.write(html)
    return path


# ---------------------------------------------------------------------------
# live viewer: the reference's Pangolin UI thread (`src/Viewer.cc:130-170`)
# becomes a daemon HTTP server streaming map snapshots to a browser canvas —
# an accelerator host has no display, but every dev box has a browser
# ---------------------------------------------------------------------------

_LIVE_SHIM = """let DATA={points:[],trajectory:[],kf_centers:[],covis_edges:[],n_kf:0,n_mp:0};
async function poll(){try{const r=await fetch('state.json');DATA=await r.json();
 if(dist===null)fit(); draw();}catch(e){} setTimeout(poll,1000);}
poll();"""


class LiveViewer:
    """Background HTTP server with a live-updating orbit map view.

    Equivalent of the reference's Viewer thread (`src/Viewer.cc`): start it
    next to a running system and open http://host:port/ — the page polls
    ``state.json`` (a fresh :func:`map_snapshot`) once a second.  Snapshots
    are computed in the server thread; the functional map arrays make the
    read race-free by construction (immutable snapshots — no
    ``mMutexMapUpdate`` needed).
    """

    def __init__(self, slam, port: int = 8765):
        import http.server
        import threading

        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def do_GET(self):
                try:
                    if self.path.endswith("state.json"):
                        body = json.dumps(map_snapshot(viewer.slam)).encode()
                        ctype = "application/json"
                    elif self.path.endswith("frame.png"):
                        # FrameDrawer stream (reference FrameDrawer::
                        # DrawFrame): current image + keypoint overlay,
                        # available when slam.keep_frame_overlay is on
                        s = viewer.slam
                        img = getattr(s, "last_image", None)
                        ov = getattr(s, "last_overlay", None)
                        if img is None or ov is None:
                            self.send_response(404)
                            self.end_headers()
                            return
                        import cv2

                        frame = draw_frame(img, ov)
                        okc, buf = cv2.imencode(".png", frame)
                        body = buf.tobytes() if okc else b""
                        ctype = "image/png"
                    else:
                        html = _HTML_TEMPLATE.replace(
                            "const DATA = __DATA__;", _LIVE_SHIM
                        )
                        body = html.encode()
                        ctype = "text/html"
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except BrokenPipeError:
                    pass

        self.slam = slam
        self.httpd = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def draw_frame(img, overlay, path: str | None = None):
    """Keypoint overlay on the current frame — the reference's
    ``FrameDrawer::DrawFrame`` (`/root/reference/src/FrameDrawer.cc`):
    map-matched keypoints in green boxes, unmatched detections as small
    blue dots, plus the status bar (state, keyframe/point/match counts).

    ``overlay`` is the dict a SLAM system records when
    ``slam.keep_frame_overlay = True`` (one host pull per frame — off by
    default on the throughput path).  Returns an (H, W, 3) uint8 BGR image;
    writes a PNG when ``path`` is given.
    """
    import cv2

    im = np.asarray(img)
    if im.ndim == 2:
        im = cv2.cvtColor(im.astype(np.uint8), cv2.COLOR_GRAY2BGR)
    else:
        im = im.astype(np.uint8).copy()
    xy = np.asarray(overlay["xy"])
    valid = np.asarray(overlay["valid"])
    matched = np.asarray(overlay["matched"])
    r = 3
    for (x, y), v, mt in zip(xy, valid, matched):
        if not v:
            continue
        p = (int(round(x)), int(round(y)))
        if mt:
            cv2.rectangle(im, (p[0] - r, p[1] - r), (p[0] + r, p[1] + r),
                          (0, 255, 0), 1)
            cv2.circle(im, p, 1, (0, 255, 0), -1)
        else:
            cv2.circle(im, p, 1, (255, 80, 0), -1)
    n_match = int((valid & matched).sum())
    bar = np.zeros((22, im.shape[1], 3), np.uint8)
    txt = (
        f"{overlay.get('state', '?')}  KFs: {overlay.get('n_kf', 0)}  "
        f"MPs: {overlay.get('n_mp', 0)}  matches: {n_match}"
    )
    cv2.putText(bar, txt, (6, 15), cv2.FONT_HERSHEY_PLAIN, 1.0,
                (255, 255, 255), 1)
    out = np.concatenate([im, bar], axis=0)
    if path is not None:
        cv2.imwrite(path, out)
    return out
