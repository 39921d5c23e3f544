"""End-to-end demo: monocular SLAM on a synthetic rendered sequence.

Usage: ``python -m orb_slam3_noted_tpu.demo [n_frames] [--small]``

Renders a camera sweep through a textured room, runs the full pipeline on
the default JAX backend (the GPU where one is present), prints per-frame tracking state
and the final Sim3-aligned ATE.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from orb_slam3_noted_tpu.io.config import SlamConfig
from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu.pipeline.system import MonoSLAM
from orb_slam3_noted_tpu.utils.evaluation import ate_rmse
from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, orbit_trajectory


def run(n_frames: int = 60, small: bool = False, verbose: bool = True):
    if small:
        W, H, nfeat = 320, 240, 600
        cam = Camera(PINHOLE, (260.0, 260.0, W / 2 - 0.5, H / 2 - 0.5))
    else:
        W, H, nfeat = 752, 480, 1200
        cam = Camera(PINHOLE, (458.654, 457.296, 367.215, 248.375))
    cfg = SlamConfig(
        camera=cam, width=W, height=H, n_features=nfeat,
        max_keyframes=64, max_map_points=8192,
        local_window=5, kf_max_interval=10,
    )
    room = BoxRoom(seed=0)
    poses = orbit_trajectory(n_frames, forward=0.025)
    frames = [room.render(R, t, cam.params, W, H) for R, t in poses]

    slam = MonoSLAM(cfg)
    t0 = time.time()
    for i, img in enumerate(frames):
        rec = slam.process(img, i)
        if verbose:
            print(
                f"frame {i:3d} state={slam.state:15s} inliers={rec.n_inliers:4d} "
                f"kf={slam.n_kf} mp={slam.n_mp}",
                flush=True,
            )
    wall = time.time() - t0

    est = slam.positions()
    gt = np.stack([p[1] for p in poses])
    ok = np.array([r.state == "OK" for r in slam.trajectory])
    rmse, _, (_, _, s) = ate_rmse(est[ok], gt[ok], with_scale=True)
    span = float(np.linalg.norm(gt[ok].max(0) - gt[ok].min(0)))
    fps = n_frames / wall
    print(
        f"tracked {int(ok.sum())}/{n_frames} frames | {slam.n_kf} KFs, "
        f"{slam.n_mp} map points | ATE {rmse*100:.2f} cm over {span:.2f} m "
        f"({100*rmse/max(span,1e-9):.1f}%) | {fps:.1f} fps incl. compile"
    )
    return dict(rmse=rmse, span=span, fps=fps, tracked=int(ok.sum()), slam=slam)


if __name__ == "__main__":
    from orb_slam3_noted_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    n = 60
    small = "--small" in sys.argv
    for a in sys.argv[1:]:
        if a.isdigit():
            n = int(a)
    run(n, small)
