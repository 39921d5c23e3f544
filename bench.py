"""Round benchmark: tracked frames/s of the full SLAM pipeline.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

Baseline: the reference runs real-time at camera rate — EuRoC 20 fps at
752x480 with 1200 ORB features on a desktop i7 (BASELINE.md).  value =
end-to-end tracked frames/s of this engine on the default JAX device at the
same resolution/feature budget, including initialization, keyframe mapping
and loop-closing detection; vs_baseline = value / 20.

Input staging: each lap's frames are uploaded to the device once, before
the timed lap, so the lap times the engine's compute (extraction,
tracking, mapping, loop closing) and not the host-to-device copy.
"""

import json
import sys
import time

import numpy as np


def main():
    from orb_slam3_noted_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu.pipeline.system import MonoSLAM
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, orbit_trajectory

    W, H, nfeat = 752, 480, 1200
    cam = Camera(PINHOLE, (458.654, 457.296, 367.215, 248.375))
    cfg = SlamConfig(
        camera=cam, width=W, height=H, n_features=nfeat,
        max_keyframes=64, max_map_points=8192,
        local_window=5, kf_max_interval=10,
        enable_loop_closing=True,  # place recognition + detection in the loop
    )
    room = BoxRoom(seed=0)
    n_frames = 120
    # corner view (yaw0): several planes share the frame — a single
    # dominant plane is a known-degenerate mono-init case (Faugeras
    # ambiguity) that stalls ANY H/F bootstrap, the reference's included
    poses = orbit_trajectory(n_frames, forward=0.03, yaw0=0.45)
    frames_np = np.stack(
        [room.render(R, t, cam.params, W, H) for R, t in poses]
    ).astype(np.uint8)
    import jax

    frames_dev = jax.device_put(frames_np)   # one-time staging (see docstring)
    frames = [frames_dev[i] for i in range(n_frames)]

    B = 16  # frames per device dispatch (throughput mode)

    batch_walls = []  # per-dispatch wall times of the timed lap

    def run_lap(record=False):
        # batched from frame 0: process_batch handles initialization with
        # batched two-view attempts (round-4 `_init_consume` — the per-frame
        # init retries were 31% of the round-3 bench wall)
        slam = MonoSLAM(cfg)
        i = 0
        while i < n_frames:
            j = min(i + B, n_frames)
            t0 = time.time()
            slam.process_batch(frames[i:j], list(range(i, j)))
            if record:
                batch_walls.append(time.time() - t0)
            i = j
        return slam

    # warm-up lap: triggers every compile (extract, track, triangulate, BA)
    run_lap()

    # timed lap (same shapes -> fully cached executables), with the
    # REGISTER_TIMES-style stage breakdown on stderr (the reference's
    # ExecTimeMean.txt analogue; one JSON line stays on stdout)
    from orb_slam3_noted_tpu.utils.timing import GLOBAL_TIMER, StageTimer

    StageTimer.enabled = True
    GLOBAL_TIMER.spans.clear()
    t0 = time.time()
    slam = run_lap(record=True)
    wall = time.time() - t0
    GLOBAL_TIMER.print_stats(file=sys.stderr)
    print(f"n_kf={slam.n_kf} n_mp={slam.n_mp}", file=sys.stderr)
    if batch_walls:
        bw = np.asarray(batch_walls[1:]) * 1000  # skip the init batch
        if len(bw):
            print(
                "batch latency ms: p50=%.1f max=%.1f (max/p50=%.2f; loop "
                "correction + time-sliced GBA ride inside these)"
                % (np.median(bw), bw.max(), bw.max() / max(np.median(bw), 1e-9)),
                file=sys.stderr,
            )

    ok = sum(1 for r in slam.trajectory if r.state == "OK")
    fps = n_frames / wall

    # --- stereo lap (secondary metric; primary mono line printed LAST) ---
    from orb_slam3_noted_tpu.pipeline.system import StereoSLAM
    from orb_slam3_noted_tpu.utils.synthetic import stereo_pair

    bf = 0.11 * 458.654
    cfg_s = SlamConfig(
        camera=cam, width=W, height=H, n_features=nfeat,
        bf=bf, th_depth=45.0,
        max_keyframes=64, max_map_points=16384,
        local_window=5, kf_max_interval=10,
        enable_loop_closing=True,
    )
    n_s = 96
    poses_s = orbit_trajectory(n_s, forward=0.03, yaw0=0.45)
    pairs_np = [
        stereo_pair(room, R, t, cam.params, W, H, 0.11)[:2] for R, t in poses_s
    ]
    L_dev = jax.device_put(np.stack([p[0] for p in pairs_np]).astype(np.uint8))
    R_dev = jax.device_put(np.stack([p[1] for p in pairs_np]).astype(np.uint8))
    pairs = [(L_dev[i], R_dev[i]) for i in range(n_s)]

    def run_stereo():
        s = StereoSLAM(cfg_s)
        i = 0
        while i < n_s and s.state == "NOT_INITIALIZED":
            s.process(pairs[i][0], pairs[i][1], i)
            i += 1
        while i < n_s:
            j = min(i + B, n_s)
            s.process_batch(pairs[i:j], list(range(i, j)))
            i = j
        return s

    run_stereo()  # warm-up/compile
    GLOBAL_TIMER.spans.clear()
    t0 = time.time()
    s = run_stereo()
    wall_s = time.time() - t0
    GLOBAL_TIMER.print_stats(file=sys.stderr)
    print(f"stereo n_kf={s.n_kf} n_mp={s.n_mp}", file=sys.stderr)
    ok_s = sum(1 for r in s.trajectory if r.state == "OK")
    fps_s = n_s / wall_s

    # --- stereo-inertial lap (the BASELINE gate configuration) ---
    from orb_slam3_noted_tpu.pipeline.inertial_system import StereoInertialSLAM
    from orb_slam3_noted_tpu.utils.synthetic import smooth_pose, synth_imu

    fps_cam = 20.0
    imu_hz = 200.0
    cfg_vi = SlamConfig(
        camera=cam, width=W, height=H, n_features=nfeat, fps=fps_cam,
        bf=bf, th_depth=45.0,
        max_keyframes=64, max_map_points=16384,
        local_window=5, kf_max_interval=10, min_tracked_points=15,
        imu_init_time=0.9, imu_viba1_time=2.5, imu_viba2_time=1e9,
        imu_init_min_kfs=3, inertial_window=8,
        imu_noise_gyro=1.7e-4, imu_noise_acc=2e-3,
        imu_walk_gyro=1.9e-5, imu_walk_acc=3e-3, imu_freq=imu_hz,
        # round-5: the gate config runs WITH loop closing, like the
        # reference always does (VERDICT r4 weak #3) — detection enqueues
        # per keyframe and drains at batch boundaries
        enable_loop_closing=True,
    )
    # 240 frames (12 s of camera): the 96-frame round-4 lap spent a third
    # of its wall on one-time IMU-init/bootstrap work — too short to show
    # the steady state the reference's "real-time" claim is about
    n_vi = 240
    times_vi = [i / fps_cam for i in range(n_vi)]
    pairs_vi_np = []
    for t in times_vi:
        Rwc, twc = smooth_pose(t)
        pairs_vi_np.append(
            stereo_pair(room, Rwc, twc, cam.params, W, H, 0.11)[:2]
        )
    Lv = jax.device_put(
        np.stack([p[0] for p in pairs_vi_np]).astype(np.uint8))
    Rv = jax.device_put(
        np.stack([p[1] for p in pairs_vi_np]).astype(np.uint8))
    pairs_vi = [(Lv[i], Rv[i]) for i in range(n_vi)]
    imu_chunks = []
    t_prev = -1.0 / fps_cam
    for s0 in range(0, n_vi, B):
        s1 = min(s0 + B, n_vi)
        a, g, ts_i = synth_imu(t_prev, times_vi[s1 - 1], hz=imu_hz)
        imu_chunks.append((a, g, ts_i))
        t_prev = times_vi[s1 - 1]

    def run_vi():
        sv = StereoInertialSLAM(cfg_vi)
        for ci, s0 in enumerate(range(0, n_vi, B)):
            s1 = min(s0 + B, n_vi)
            a, g, ts_i = imu_chunks[ci]
            sv.process_batch(
                pairs_vi[s0:s1], list(range(s0, s1)), ts=times_vi[s0:s1],
                acc=a, gyr=g, imu_t=ts_i,
            )
        return sv

    run_vi()  # warm-up/compile
    GLOBAL_TIMER.spans.clear()
    t0 = time.time()
    sv = run_vi()
    wall_vi = time.time() - t0
    GLOBAL_TIMER.print_stats(file=sys.stderr)
    print(
        f"stereo-inertial n_kf={sv.n_kf} n_mp={sv.n_mp} "
        f"imu_stage={sv.imu_stage}", file=sys.stderr,
    )
    ok_vi = sum(1 for r in sv.trajectory if r.state == "OK")
    fps_vi = n_vi / wall_vi

    # --- long-sequence accuracy gate (round-5, VERDICT r4 weak #4): a
    # 400-frame pendulum lap returning to its start twice; ATE measured on
    # the IDENTICAL frames with loop closing disabled vs enabled, so every
    # round reports drift correction next to throughput (the reference's
    # evaluate_ate_scale protocol, `evaluation/evaluate_ate_scale.py`) ---
    from orb_slam3_noted_tpu.geometry import so3
    from orb_slam3_noted_tpu.utils.evaluation import ate_rmse
    import jax.numpy as jnp

    n_a = 400

    def pend_pose(i):
        s = i / n_a
        ph = 2 * np.pi * 2 * s          # two excursions -> two revisits
        twc = np.array([
            0.7 * np.sin(ph),
            0.10 * np.sin(2 * np.pi * 3.1 * s),
            0.18 * np.sin(ph + 1.2),
        ])
        # wide yaw sweep: the camera looks AWAY during each excursion and
        # re-sees the start region on return — without leaving the start's
        # field of view no drift/loop mechanism exists
        yaw = 0.45 + 0.70 * np.sin(ph + 0.4)
        pitch = 0.05 * np.sin(2 * np.pi * 1.3 * s)
        Rwc = np.asarray(so3.exp(jnp.asarray([pitch, yaw, 0.0])))
        return Rwc, twc

    acc_poses = [pend_pose(i) for i in range(n_a)]
    acc_np = np.stack(
        [room.render(R, t, cam.params, W, H) for R, t in acc_poses]
    ).astype(np.uint8)
    acc_dev = jax.device_put(acc_np)
    acc_frames = [acc_dev[i] for i in range(n_a)]
    acc_gt = np.stack([t for _, t in acc_poses])

    def run_acc(loop_on):
        s = MonoSLAM(cfg)
        if not loop_on:
            # identical config (keeps every compiled executable) — only the
            # detection enqueue is stubbed out
            s._maybe_close_loop = lambda slot, feats: s._register_reloc_kf(
                slot
            )
        # denser keyframes than the ratio policy alone would give (a
        # keyframe at least every 8 frames while tracking) so revisits
        # fall OUTSIDE the loop closer's recency exclusion; instance-level
        # override keeps the config hash — no recompiles
        base_need = s._need_new_kf

        def need_kf(n_inl, **kw):
            if base_need(n_inl, **kw):
                return True
            return (
                s.frames_since_kf >= 8 and n_inl > 15 and s._can_insert_kf()
            )

        s._need_new_kf = need_kf
        i = 0
        while i < n_a:
            j = min(i + B, n_a)
            s.process_batch(acc_frames[i:j], list(range(i, j)))
            i = j
        s.flush()
        return s

    def acc_ate(s):
        idx = [k for k, r in enumerate(s.trajectory) if r.state == "OK"]
        if len(idx) < n_a // 2:
            return float("nan"), len(idx)
        est = s.positions()[idx]
        fid = [s.trajectory[k].frame_id for k in idx]
        rmse, _, _ = ate_rmse(est, acc_gt[fid], with_scale=True)
        return rmse, len(idx)

    s_off = run_acc(False)
    ate_off, n_off = acc_ate(s_off)
    s_on = run_acc(True)
    ate_on, n_on = acc_ate(s_on)
    loops = s_on.loop_closer.loops_closed if s_on.loop_closer else 0
    print(
        f"accuracy lap: ate_off={ate_off:.4f} m ({n_off} fr) "
        f"ate_on={ate_on:.4f} m ({n_on} fr) loops_closed={loops}",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "mono_400f_loop_ate",
                "value": round(ate_on, 4),
                "unit": "m",
                "vs_baseline": round(ate_off / max(ate_on, 1e-9), 3),
                "ate_loop_off_m": round(ate_off, 4),
                "loops_closed": int(loops),
            }
        )
    )
    print(
        json.dumps(
            {
                "metric": "stereo_inertial_tracked_fps_752x480_1200feat",
                "value": round(fps_vi, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps_vi / 20.0, 3),
                "tracked_frames": ok_vi,
                "n_frames": n_vi,
                "imu_stage": sv.imu_stage,
            }
        )
    )
    print(
        json.dumps(
            {
                "metric": "stereo_tracked_fps_752x480_1200feat",
                "value": round(fps_s, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps_s / 20.0, 3),
                "tracked_frames": ok_s,
                "n_frames": n_s,
            }
        )
    )
    print(
        json.dumps(
            {
                "metric": "mono_tracked_fps_752x480_1200feat",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / 20.0, 3),
                "tracked_frames": ok,
                "n_frames": n_frames,
            }
        )
    )


if __name__ == "__main__":
    main()
