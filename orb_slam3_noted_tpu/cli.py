"""Dataset drivers (the reference's ``Examples/`` mains, as one CLI).

Replaces the per-dataset example binaries
(`/root/reference/Examples/Stereo-Inertial/stereo_inertial_euroc.cc`,
`Examples/Monocular/mono_euroc.cc`, ...): load a sequence, optionally
rectify, feed the SLAM system frame by frame (batching IMU measurements
between frames as the reference drivers do, `stereo_inertial_euroc.cc:
216-225`), save the trajectory in TUM/EuRoC/KITTI format, optionally
evaluate ATE against ground truth and print per-stage timing stats.

Usage::

    python -m orb_slam3_noted_tpu.cli \
        --dataset euroc --seq /data/MH_01_easy --settings EuRoC.yaml \
        --mode stereo-inertial --out traj_tum.txt --eval \
        --checkpoint-out map.npz
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def resolve_mode(cfg, mode):
    """Route stereo modes to the fisheye systems when the settings file
    carries a second camera (the reference switches on Camera.type +
    Camera2 presence, `/root/reference/src/Tracking.cc:724-815`)."""
    if cfg.camera2 is not None:
        if mode == "stereo":
            return "fisheye-stereo"
        if mode == "stereo-inertial":
            return "fisheye-stereo-inertial"
    return mode


def build_system(cfg, mode, atlas=False):
    from orb_slam3_noted_tpu.pipeline.inertial_system import (
        FisheyeStereoInertialSLAM,
        MonoInertialSLAM,
        StereoInertialSLAM,
    )
    from orb_slam3_noted_tpu.pipeline.system import (
        FisheyeStereoSLAM,
        MonoSLAM,
        RGBDSLAM,
        StereoSLAM,
    )

    cls = {
        "mono": MonoSLAM,
        "stereo": StereoSLAM,
        "rgbd": RGBDSLAM,
        "fisheye-stereo": FisheyeStereoSLAM,
        "mono-inertial": MonoInertialSLAM,
        "stereo-inertial": StereoInertialSLAM,
        "fisheye-stereo-inertial": FisheyeStereoInertialSLAM,
    }[mode]
    if atlas:
        # multi-session / multi-map driver (reference
        # `Examples/euroc_examples.sh:15`: MH01->MH05 into one Atlas)
        if mode.endswith("inertial"):
            from orb_slam3_noted_tpu.pipeline.inertial_atlas import (
                InertialAtlasSLAM,
            )

            return InertialAtlasSLAM(cfg, base_cls=cls)
        from orb_slam3_noted_tpu.pipeline.atlas import AtlasSLAM

        return AtlasSLAM(cfg, base_cls=cls, fix_scale=cfg.bf > 0)
    return cls(cfg)


def main(argv=None):
    from orb_slam3_noted_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset",
                   choices=["euroc", "tumvi", "kitti", "tum-rgbd"],
                   default="euroc")
    p.add_argument("--seq", required=True, action="append",
                   help="sequence directory (repeat for multi-session)")
    p.add_argument("--settings", required=True, help="reference-format YAML")
    p.add_argument("--mode", default="stereo",
                   choices=["mono", "stereo", "rgbd", "fisheye-stereo",
                            "mono-inertial", "stereo-inertial",
                            "fisheye-stereo-inertial"])
    p.add_argument("--atlas", action="store_true",
                   help="multi-map Atlas driver (auto on with >1 --seq)")
    p.add_argument("--out", default="trajectory.txt")
    p.add_argument("--format", default="tum", choices=["tum", "euroc", "kitti"])
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--batch", type=int, default=1,
                   help="frames per device dispatch (throughput mode; "
                        "mono/stereo/stereo-inertial)")
    p.add_argument("--eval", action="store_true",
                   help="evaluate ATE against the sequence ground truth")
    p.add_argument("--checkpoint-out", default=None)
    p.add_argument("--checkpoint-in", default=None)
    p.add_argument("--times", action="store_true",
                   help="print per-stage timing stats (REGISTER_TIMES)")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="append a structured JSONL metric record per "
                        "dispatch (stage deltas, saturation, map gauges)")
    args = p.parse_args(argv)

    from orb_slam3_noted_tpu.io import datasets as D
    from orb_slam3_noted_tpu.io import trajectory as TRJ
    from orb_slam3_noted_tpu.io.yaml_compat import (
        load_settings,
        load_stereo_rectification,
    )
    from orb_slam3_noted_tpu.utils.timing import GLOBAL_TIMER, StageTimer

    if args.times:
        StageTimer.enabled = True
    metrics = None
    if args.metrics:
        from orb_slam3_noted_tpu.utils.timing import MetricsStream

        StageTimer.enabled = True  # stage deltas ride on the timer
        metrics = MetricsStream(args.metrics)

    cfg, imu_params = load_settings(args.settings)
    mode = resolve_mode(cfg, args.mode)
    stereo = mode in ("stereo", "stereo-inertial",
                      "fisheye-stereo", "fisheye-stereo-inertial")
    rgbd = mode == "rgbd"
    inertial = mode.endswith("inertial")

    def load_seq(seq_dir):
        if args.dataset == "euroc":
            return D.load_euroc(seq_dir, stereo=stereo, with_imu=inertial)
        if args.dataset == "tumvi":
            return D.load_tum_vi(seq_dir, stereo=stereo, with_imu=inertial)
        if args.dataset == "tum-rgbd":
            return D.load_tum_rgbd(seq_dir)
        return D.load_kitti(seq_dir, stereo=stereo)

    seqs = [load_seq(sd) for sd in args.seq]
    use_atlas = args.atlas or len(seqs) > 1

    rect = None
    if mode in ("stereo", "stereo-inertial"):
        # LEFT./RIGHT. rectification blocks apply only to the rectified
        # stereo modes (the reference's example drivers); fisheye runs raw
        try:
            r = load_stereo_rectification(args.settings)
            if r:
                rect = (D.make_rectify_maps(r), )
        except Exception:
            rect = None

    slam = build_system(cfg, mode, atlas=use_atlas)
    if args.checkpoint_in:
        from orb_slam3_noted_tpu.io.checkpoint import load_map

        load_map(args.checkpoint_in, slam)

    batch = max(args.batch, 1)
    if batch > 1 and (mode == "mono-inertial" or rgbd or use_atlas):
        batch = 1  # per-frame modes

    t_start = time.time()
    stamps = []          # global per-frame timestamps across sequences
    n_total = 0
    budget = args.max_frames if args.max_frames > 0 else 10**9
    for si, seq in enumerate(seqs):
        n = min(len(seq), budget - n_total)
        if n <= 0:
            break
        off = n_total       # global frame-id offset for this sequence
        seq_stamps = [float(t) for t in seq.timestamps[:n]]
        stamps.extend(seq_stamps)

        def read_frame(i):
            imgs = seq.read(i)
            if rect is not None and stereo:
                maps_l, maps_r = rect[0]
                imgs = (D.rectify(imgs[0], maps_l),
                        D.rectify(imgs[1], maps_r))
            return imgs

        t_prev = None
        i = 0
        while i < n:
            j = min(i + batch, n)
            if batch == 1:
                ts = seq_stamps[i]
                imgs = read_frame(i)
                kw = {}
                if inertial and seq.imu is not None:
                    lo = t_prev if t_prev is not None else ts - 1.0
                    chunk = seq.imu.between(lo, ts)
                    kw = dict(t=ts, acc=chunk.acc, gyr=chunk.gyr,
                              imu_t=chunk.t)
                with GLOBAL_TIMER.stage("frame_total"):
                    if stereo or rgbd:
                        slam.process(imgs[0], imgs[1], off + i, **kw)
                    elif inertial:
                        slam.process(imgs, off + i, **kw)
                    else:
                        slam.process(imgs, off + i)
                t_prev = ts
            else:
                frames = [read_frame(k) for k in range(i, j)]
                kw = {}
                if inertial and seq.imu is not None:
                    lo = t_prev if t_prev is not None else seq_stamps[i] - 1.0
                    chunk = seq.imu.between(lo, seq_stamps[j - 1])
                    kw = dict(ts=seq_stamps[i:j], acc=chunk.acc,
                              gyr=chunk.gyr, imu_t=chunk.t)
                with GLOBAL_TIMER.stage("frame_total"):
                    slam.process_batch(
                        frames, list(range(off + i, off + j)), **kw
                    )
                t_prev = seq_stamps[j - 1]
            if metrics is not None:
                metrics.emit("dispatch", seq_idx=si, frame=off + i,
                             **metrics.gauges_for(slam))
            if (i // max(batch, 1)) % max(50 // max(batch, 1), 1) == 0:
                ok = slam.trajectory[-1].state if slam.trajectory else "-"
                print(
                    f"[seq{si} {i}/{n}] state={ok} kf={slam.n_kf} "
                    f"mp={slam.n_mp}", file=sys.stderr,
                )
            i = j
        n_total += n
        if si + 1 < len(seqs) and hasattr(slam, "on_sequence_end"):
            # multi-session boundary: stash the active map so the next
            # sequence starts fresh and merges on revisit (reference
            # multi-session Atlas protocol)
            slam.on_sequence_end()
    if hasattr(slam, "flush"):
        slam.flush()
    wall = time.time() - t_start
    n = n_total

    class _Rec:
        __slots__ = ("timestamp", "Rcw", "tcw")

        def __init__(self, timestamp, Rcw, tcw):
            self.timestamp, self.Rcw, self.tcw = timestamp, Rcw, tcw

    records = [
        _Rec(stamps[min(r.frame_id, len(stamps) - 1)], R, t)
        for r, (R, t) in zip(slam.trajectory, slam.final_poses())
    ]
    saver = {"tum": TRJ.save_tum, "euroc": TRJ.save_euroc,
             "kitti": TRJ.save_kitti}[args.format]
    saver(args.out, records)

    result = {
        "frames": n, "wall_s": round(wall, 2),
        "fps": round(n / max(wall, 1e-9), 2),
        "keyframes": slam.n_kf, "map_points": slam.n_mp,
        "tracked": sum(1 for r in slam.trajectory if r.state == "OK"),
    }
    if args.eval and seq.gt_pos is not None:
        from orb_slam3_noted_tpu.utils.evaluation import ate_rmse

        # timestamp association (reference evaluation/associate.py): nearest
        # GT sample within 20 ms of each tracked frame
        tracked = [r for r in slam.trajectory if r.state == "OK"]
        est_t = np.asarray(
            [stamps[min(r.frame_id, len(stamps) - 1)] for r in tracked]
        )
        pos_all = slam.positions()  # rel-pose records follow BA refinements
        idx_ok = [k for k, r in enumerate(slam.trajectory) if r.state == "OK"]
        est_p = pos_all[idx_ok]
        gt_t = np.asarray(seq.gt_t)
        gi = np.clip(np.searchsorted(gt_t, est_t), 1, len(gt_t) - 1)
        prev = gi - 1
        gi = np.where(
            np.abs(gt_t[prev] - est_t) < np.abs(gt_t[gi] - est_t), prev, gi
        )
        ok_assoc = np.abs(gt_t[gi] - est_t) < 0.02
        if int(ok_assoc.sum()) >= 3:
            rmse, _, (_, _, s) = ate_rmse(
                est_p[ok_assoc], np.asarray(seq.gt_pos)[gi[ok_assoc]],
                with_scale=mode.startswith("mono"),
            )
            result["ate_rmse_m"] = round(float(rmse), 4)
            result["align_scale"] = round(float(s), 4)
            result["eval_frames"] = int(ok_assoc.sum())

    if args.checkpoint_out:
        from orb_slam3_noted_tpu.io.checkpoint import save_map

        save_map(args.checkpoint_out, slam)

    if args.times:
        GLOBAL_TIMER.print_stats(file=sys.stderr)
        from orb_slam3_noted_tpu.utils.timing import print_saturation

        print_saturation(file=sys.stderr)
    if metrics is not None:
        metrics.emit("final", **metrics.gauges_for(slam), **{
            k: v for k, v in result.items() if not isinstance(v, dict)
        })
        metrics.close()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
