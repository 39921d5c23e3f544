"""Smoke run of the SLAM main path on one GPU.

Usage::

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # sharded GBA + pose graph, 4 cards vs 1

Phases (one JSON object per line each):

1. device: JAX must report a GPU; prints the card's name and power limit
   (``nvidia-smi``), JAX/jaxlib versions, ``XLA_FLAGS``, the compile-cache
   directory and the matmul precision.  Without ``--four-cards`` the process
   sees exactly one card (``CUDA_VISIBLE_DEVICES`` is pinned before JAX
   starts), so no other card is touched or has memory reserved.
2. frontend: ``extract_orb_batch`` and the rectified stereo match on 16
   rendered 752x480 pairs, on the GPU and on the host CPU in the same
   process, compared within :data:`FRONTEND_TOL`.
3. stereo_inertial: ``StereoInertialSLAM.process_batch`` over a 240-frame
   20 Hz lap with a 200 Hz IMU and loop closing, twice (compile + run, then
   steady state), checked against :data:`CPU_REF`.
4. mono: ``MonoSLAM.process_batch`` from frame 0 over a 120-frame orbit,
   twice, checked the same way.

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase, or no
GPU at all, exits non-zero without that line; nothing falls back to the CPU.

``cpu_reference()`` runs the two laps once on the CPU backend
(``JAX_PLATFORMS=cpu python -c "import chip_smoke; chip_smoke.cpu_reference()"``);
its tracked counts and ATEs are the :data:`CPU_REF` bounds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# GPU vs CPU frontend tolerances, on the 0-255 intensity scale.
FRONTEND_TOL = {
    "fast_l0_max_abs": 0.0,       # integer-valued arithmetic: bit-exact
    "map_max_abs": 1e-3,          # the 7x7 blur of every level
    # a FAST score is a difference of two resampled pixels (ring - centre),
    # so its error bound on levels >= 1 is twice a pixel's
    "score_max_abs": 2e-3,
    "kp_identical_min": 0.99,     # share of identical keypoint positions
    "desc_hamming_mean_max": 0.5,  # bits of 256, over identical keypoints
    "uR_median_abs_max": 0.01,    # px, right-image coordinate
    "stereo_flags_agree_min": 0.99,
}

# CPU-backend reference of the two laps (``cpu_reference()``); the GPU must
# track at least ``tracked - 2`` frames and reach an ATE of at most
# ``max(1.5 * ate_m, ate_m + 0.01)``.
CPU_REF = {
    "stereo_inertial": {"tracked": 240, "ate_m": 0.0543581061065197},
    "mono": {"tracked": 117, "ate_m": 0.011143364012241364},
}

W, H, NFEAT, NLEVELS = 752, 480, 1200, 8
FX, FY, CX, CY = 458.654, 457.296, 367.215, 248.375
BASELINE_M = 0.11
B = 16


# ---------------------------------------------------------------------------
# comparison helpers (numpy only)
# ---------------------------------------------------------------------------


def max_abs_diff(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def _kp_keys(xy, level, valid):
    keys = {}
    for k in np.flatnonzero(valid):
        key = (int(level[k]), round(float(xy[k, 0]), 3),
               round(float(xy[k, 1]), 3))
        keys[key] = k
    return keys


def keypoint_agreement(xy_a, lvl_a, val_a, xy_b, lvl_b, val_b):
    """Share of identical keypoints (level and position) over a batch.

    Arrays are (B, N, ...).  Returns (share, pairs) where ``pairs`` lists
    (frame, index_a, index_b) for every keypoint present in both."""
    n_common, n_max, pairs = 0, 0, []
    for f in range(np.asarray(xy_a).shape[0]):
        ka = _kp_keys(np.asarray(xy_a[f]), np.asarray(lvl_a[f]),
                      np.asarray(val_a[f]))
        kb = _kp_keys(np.asarray(xy_b[f]), np.asarray(lvl_b[f]),
                      np.asarray(val_b[f]))
        common = ka.keys() & kb.keys()
        n_common += len(common)
        n_max += max(len(ka), len(kb))
        pairs += [(f, ka[k], kb[k]) for k in common]
    return (n_common / n_max if n_max else 1.0), pairs


def mean_hamming(desc_a, desc_b) -> float:
    """Mean Hamming distance between two (N, 8) uint32 descriptor sets."""
    a = np.ascontiguousarray(desc_a, np.uint32)
    b = np.ascontiguousarray(desc_b, np.uint32)
    if not a.size:
        return 0.0
    bits = np.unpackbits((a ^ b).view(np.uint8), axis=-1)
    return float(bits.reshape(a.shape[0], -1).sum(axis=1).mean())


def stereo_agreement(u_a, valid_a, u_b, valid_b, mask):
    """(median |du| where both are valid, share of equal valid flags)."""
    mask = np.asarray(mask, bool)
    va = np.asarray(valid_a, bool)
    vb = np.asarray(valid_b, bool)
    both = va & vb & mask
    du = np.abs(np.asarray(u_a, np.float64) - np.asarray(u_b, np.float64))
    med = float(np.median(du[both])) if both.any() else 0.0
    agree = float(np.mean(va[mask] == vb[mask])) if mask.any() else 1.0
    return med, agree


def frontend_violations(stats: dict, tol: dict = FRONTEND_TOL) -> list:
    """Names of the frontend statistics outside their tolerance."""
    bad = []
    if not stats["fast_l0_max_abs"] <= tol["fast_l0_max_abs"]:
        bad.append("fast_l0_max_abs")
    if not stats["score_max_abs"] <= tol["score_max_abs"]:
        bad.append("score_max_abs")
    if not stats["blur_max_abs"] <= tol["map_max_abs"]:
        bad.append("blur_max_abs")
    if not stats["kp_identical"] >= tol["kp_identical_min"]:
        bad.append("kp_identical")
    if not stats["desc_hamming_mean"] <= tol["desc_hamming_mean_max"]:
        bad.append("desc_hamming_mean")
    if not stats["uR_median_abs"] <= tol["uR_median_abs_max"]:
        bad.append("uR_median_abs")
    if not stats["stereo_flags_agree"] >= tol["stereo_flags_agree_min"]:
        bad.append("stereo_flags_agree")
    return bad


def lap_bounds(ref: dict) -> dict:
    """GPU bounds derived from one CPU-backend lap."""
    return {
        "min_tracked": ref["tracked"] - 2,
        "max_ate_m": max(1.5 * ref["ate_m"], ref["ate_m"] + 0.01),
    }


def lap_violations(tracked: int, ate_m: float, ref: dict) -> list:
    b = lap_bounds(ref)
    bad = []
    if not tracked >= b["min_tracked"]:
        bad.append("tracked")
    if not ate_m <= b["max_ate_m"]:  # NaN fails too
        bad.append("ate_m")
    return bad


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _nvidia_smi(index: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", index, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def device_phase(n_cards: int, gpu_index: str) -> dict:
    import jax
    import jaxlib

    from orb_slam3_noted_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX reports {devs[0].platform}")
    if len(devs) != n_cards:
        raise RuntimeError(f"{len(devs)} GPUs visible, {n_cards} expected")
    smi = _nvidia_smi(gpu_index)
    print(smi, flush=True)
    return {
        "nvidia_smi": smi,
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_cache_dir": cache,
        "matmul_precision": jax.config.jax_default_matmul_precision,
    }


def _cam(width=W, height=H):
    """EuRoC intrinsics, scaled when a rehearsal runs below 752x480."""
    from orb_slam3_noted_tpu.models.cameras import PINHOLE, Camera

    sx, sy = width / W, height / H
    return Camera(PINHOLE, (FX * sx, FY * sy, CX * sx, CY * sy))


def _on_host():
    """Context placing set-up arrays (scene synthesis) on the host CPU."""
    import jax

    return jax.default_device(jax.devices("cpu")[0])


def frontend_phase(n_frames=16, width=W, height=H, nfeat=NFEAT,
                   n_levels=NLEVELS) -> dict:
    import jax

    from orb_slam3_noted_tpu.ops import fast as fast_ops
    from orb_slam3_noted_tpu.ops import image as image_ops
    from orb_slam3_noted_tpu.ops import orb as O
    from orb_slam3_noted_tpu.ops.stereo import match_stereo
    from orb_slam3_noted_tpu.utils.synthetic import (
        BoxRoom, orbit_trajectory, stereo_pair,
    )

    cam = _cam(width, height)
    bf = BASELINE_M * cam.fx
    with _on_host():
        room = BoxRoom(seed=0)
        poses = orbit_trajectory(n_frames, forward=0.03, yaw0=0.45)
        pairs = [stereo_pair(room, R, t, cam.params, width, height,
                             BASELINE_M)[:2] for R, t in poses]
    # uint8 frames as the pipeline receives them, as float32
    L = np.stack([p[0] for p in pairs]).astype(np.uint8).astype(np.float32)
    R = np.stack([p[1] for p in pairs]).astype(np.uint8).astype(np.float32)

    @jax.jit
    def level_maps(imgs):
        pyr = jax.vmap(
            lambda im: tuple(image_ops.build_pyramid(im, n_levels, 1.2))
        )(imgs)
        score = tuple(jax.vmap(fast_ops.fast_score)(p) for p in pyr)
        blur = tuple(image_ops.gaussian_blur(p, 7, 2.0) for p in pyr)
        return pyr, score, blur

    @jax.jit
    def stereo(fl, fr, pl, pr):
        return jax.vmap(
            lambda a, b, c, d: match_stereo(
                a, b, c, d, bf=bf, baseline=BASELINE_M, n_levels=n_levels,
            )
        )(fl, fr, pl, pr)

    def run(dev, stereo_inputs=None):
        l, r = jax.device_put(L, dev), jax.device_put(R, dev)
        t0 = time.perf_counter()
        pyrL, scoreL, blurL = level_maps(l)
        pyrR, scoreR, blurR = level_maps(r)
        fl = O.extract_orb_batch(l, n_features=nfeat, n_levels=n_levels)
        fr = O.extract_orb_batch(r, n_features=nfeat, n_levels=n_levels)
        ins = (fl, fr, pyrL, pyrR) if stereo_inputs is None else (
            jax.device_put(stereo_inputs, dev))
        sm = stereo(*ins)
        out = jax.device_get((scoreL + scoreR, blurL + blurR, fl, sm,
                              pyrL + pyrR))
        return out, ins, time.perf_counter() - t0

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    (g_score, g_blur, g_f, g_sm, g_pyr), g_ins, g_s = run(gpu)
    # the CPU stereo match gets the GPU's features and pyramids, so the
    # comparison isolates the matcher itself
    (c_score, c_blur, c_f, c_sm, c_pyr), _, c_s = run(
        cpu, jax.device_get(g_ins))

    nl = n_levels
    share, pairs = keypoint_agreement(g_f.xy, g_f.level, g_f.valid,
                                      c_f.xy, c_f.level, c_f.valid)
    fi = np.array([p[0] for p in pairs], int)
    ia = np.array([p[1] for p in pairs], int)
    ib = np.array([p[2] for p in pairs], int)
    stats = {
        "fast_l0_max_abs": max(max_abs_diff(g_score[0], c_score[0]),
                               max_abs_diff(g_score[nl], c_score[nl])),
        "score_max_abs": max(max_abs_diff(a, b) for i, (a, b) in
                             enumerate(zip(g_score, c_score)) if i % nl),
        "blur_max_abs": max(max_abs_diff(a, b)
                            for a, b in zip(g_blur, c_blur)),
        # resampled levels, reported beside the scores computed from them
        "pyramid_max_abs": max(max_abs_diff(a, b)
                               for a, b in zip(g_pyr, c_pyr)),
        "kp_identical": share,
        "n_keypoints_gpu": int(np.asarray(g_f.valid).sum()),
        "n_keypoints_cpu": int(np.asarray(c_f.valid).sum()),
        "desc_hamming_mean": mean_hamming(
            np.asarray(g_f.desc)[fi, ia] if len(pairs) else np.zeros((0, 8)),
            np.asarray(c_f.desc)[fi, ib] if len(pairs) else np.zeros((0, 8)),
        ),
    }
    med, agree = stereo_agreement(g_sm.u_right, g_sm.valid, c_sm.u_right,
                                  c_sm.valid, np.asarray(g_f.valid))
    stats.update({
        "uR_median_abs": med,
        "stereo_flags_agree": agree,
        "n_stereo_gpu": int(np.asarray(g_sm.valid).sum()),
        "n_stereo_cpu": int(np.asarray(c_sm.valid).sum()),
        "gpu_first_call_s": g_s,
        "cpu_first_call_s": c_s,
    })
    stats["tolerances"] = FRONTEND_TOL
    stats["violations"] = frontend_violations(stats)
    return stats


def _timed_runs(lap, n_frames, n_runs, extra):
    """Run ``lap`` ``n_runs`` times; one record per run."""
    from orb_slam3_noted_tpu.utils.timing import GLOBAL_TIMER, StageTimer

    StageTimer.enabled = True
    runs = []
    for k in range(n_runs):
        GLOBAL_TIMER.spans.clear()
        t0 = time.perf_counter()
        slam = lap()
        wall = time.perf_counter() - t0
        rec = {
            "run": "compile+run" if k == 0 else "steady",
            "wall_s": wall,
            "frames_per_s": n_frames / wall,
            "n_frames": n_frames,
            "n_kf": int(slam.n_kf),
            "n_mp": int(slam.n_mp),
        }
        rec.update(extra(slam))
        rec["stages"] = GLOBAL_TIMER.summary()
        runs.append(rec)
    return runs


def _ate(slam, gt, with_scale):
    from orb_slam3_noted_tpu.utils.evaluation import ate_rmse

    idx = [k for k, r in enumerate(slam.trajectory) if r.state == "OK"]
    if len(idx) < 3:
        return float("nan"), len(idx)
    fid = [slam.trajectory[k].frame_id for k in idx]
    est = slam.positions()[idx]
    rmse, _, _ = ate_rmse(est, gt[fid], with_scale=with_scale)
    return float(rmse), len(idx)


def vi_lap(n_frames=240, width=W, height=H, nfeat=NFEAT, n_runs=2) -> list:
    """Stereo-inertial lap of ``bench.py`` at the default map caps."""
    import jax

    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.pipeline.inertial_system import StereoInertialSLAM
    from orb_slam3_noted_tpu.utils.synthetic import (
        BoxRoom, smooth_pose, stereo_pair, synth_imu,
    )

    cam = _cam(width, height)
    fps_cam, imu_hz = 20.0, 200.0
    cfg = SlamConfig(
        camera=cam, width=width, height=height, n_features=nfeat,
        fps=fps_cam, bf=BASELINE_M * cam.fx, th_depth=45.0,
        local_window=5, kf_max_interval=10, min_tracked_points=15,
        imu_init_time=0.9, imu_viba1_time=2.5, imu_viba2_time=1e9,
        imu_init_min_kfs=3, inertial_window=8,
        imu_noise_gyro=1.7e-4, imu_noise_acc=2e-3,
        imu_walk_gyro=1.9e-5, imu_walk_acc=3e-3, imu_freq=imu_hz,
        enable_loop_closing=True,
    )
    times = [i / fps_cam for i in range(n_frames)]
    with _on_host():
        room = BoxRoom(seed=0)
        poses = [smooth_pose(t) for t in times]
        pairs = [stereo_pair(room, Rwc, twc, cam.params, width, height,
                             BASELINE_M)[:2] for Rwc, twc in poses]
        chunks, t_prev = [], -1.0 / fps_cam
        for s0 in range(0, n_frames, B):
            s1 = min(s0 + B, n_frames)
            chunks.append(synth_imu(t_prev, times[s1 - 1], hz=imu_hz))
            t_prev = times[s1 - 1]
    gt = np.stack([t for _, t in poses])
    Lv = jax.device_put(np.stack([p[0] for p in pairs]).astype(np.uint8))
    Rv = jax.device_put(np.stack([p[1] for p in pairs]).astype(np.uint8))
    frames = [(Lv[i], Rv[i]) for i in range(n_frames)]

    def lap():
        s = StereoInertialSLAM(cfg)
        for ci, s0 in enumerate(range(0, n_frames, B)):
            s1 = min(s0 + B, n_frames)
            a, g, ts_i = chunks[ci]
            s.process_batch(frames[s0:s1], list(range(s0, s1)),
                            ts=times[s0:s1], acc=a, gyr=g, imu_t=ts_i)
        return s

    def extra(s):
        ate, tracked = _ate(s, gt, with_scale=False)
        return {"tracked": tracked, "ate_m": ate,
                "imu_stage": int(s.imu_stage)}

    return _timed_runs(lap, n_frames, n_runs, extra)


def mono_lap(n_frames=120, width=W, height=H, nfeat=NFEAT, n_runs=2) -> list:
    """Monocular lap of ``bench.py`` (batched from frame 0)."""
    import jax

    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.pipeline.system import MonoSLAM
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, orbit_trajectory

    cam = _cam(width, height)
    cfg = SlamConfig(
        camera=cam, width=width, height=height, n_features=nfeat,
        max_keyframes=64, max_map_points=8192,
        local_window=5, kf_max_interval=10, enable_loop_closing=True,
    )
    with _on_host():
        room = BoxRoom(seed=0)
        poses = orbit_trajectory(n_frames, forward=0.03, yaw0=0.45)
        imgs = [room.render(R, t, cam.params, width, height) for R, t in poses]
    gt = np.stack([t for _, t in poses])
    dev = jax.device_put(np.stack(imgs).astype(np.uint8))
    frames = [dev[i] for i in range(n_frames)]

    def lap():
        s = MonoSLAM(cfg)
        for i in range(0, n_frames, B):
            j = min(i + B, n_frames)
            s.process_batch(frames[i:j], list(range(i, j)))
        return s

    def extra(s):
        ate, tracked = _ate(s, gt, with_scale=True)
        return {"tracked": tracked, "ate_m": ate}

    return _timed_runs(lap, n_frames, n_runs, extra)


def _lap_phase(name, runs):
    ref = CPU_REF[name]
    return {
        "runs": runs, "cpu_ref": ref, "bounds": lap_bounds(ref),
        "violations": [f"run {k}: {v}" for k, r in enumerate(runs)
                       for v in lap_violations(r["tracked"], r["ate_m"], ref)],
    }


def cpu_reference():
    """Both laps once on the current backend; prints one JSON line each."""
    for name, lap in (("stereo_inertial", vi_lap), ("mono", mono_lap)):
        (run,) = lap(n_runs=1)
        run.pop("stages")
        print(json.dumps({"cpu_reference": name, **run}), flush=True)


# ---------------------------------------------------------------------------
# four cards: sharded GBA and pose graph against one card
# ---------------------------------------------------------------------------


def _gba_problem(n_kf, n_mp, obs_per_kf, seed=0):
    import jax.numpy as jnp

    from orb_slam3_noted_tpu.models.cameras import project
    from orb_slam3_noted_tpu.optim import factors
    from orb_slam3_noted_tpu.optim.ba import BAProblem

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(n_mp, 3)) + np.array([0, 0, 10.0])
    ang = 0.01 * np.arange(n_kf)
    c, s = np.cos(ang), np.sin(ang)
    Rs = np.zeros((n_kf, 3, 3))
    Rs[:, 0, 0], Rs[:, 0, 2], Rs[:, 1, 1] = c, s, 1.0
    Rs[:, 2, 0], Rs[:, 2, 2] = -s, c
    ts = np.zeros((n_kf, 3))
    ts[:, 0] = 0.1 * np.arange(n_kf)
    sel = np.stack([rng.choice(n_mp, size=obs_per_kf, replace=False)
                    for _ in range(n_kf)])
    xc = np.einsum("kij,knj->kni", Rs, pts[sel]) + ts[:, None]
    uv = np.asarray(project(_cam(), jnp.asarray(xc.reshape(-1, 3),
                                                jnp.float32)))
    uv = uv + rng.normal(0.0, 1.0, uv.shape)  # pixel noise: cost > 0 at optimum
    n_obs = n_kf * obs_per_kf
    obs = factors.ReprojObs(
        pose_idx=jnp.asarray(np.repeat(np.arange(n_kf), obs_per_kf), jnp.int32),
        point_idx=jnp.asarray(sel.reshape(-1), jnp.int32),
        uv=jnp.asarray(uv, jnp.float32),
        uv_r=jnp.full(n_obs, -1.0, jnp.float32),
        inv_sigma2=jnp.ones(n_obs, jnp.float32),
        is_stereo=jnp.zeros(n_obs, bool),
        valid=jnp.ones(n_obs, bool),
    )
    prob = BAProblem(
        Rcw=jnp.asarray(Rs, jnp.float32), tcw=jnp.asarray(ts, jnp.float32),
        points=jnp.asarray(pts + 0.01, jnp.float32), obs=obs,
        pose_fixed=jnp.zeros(n_kf, bool).at[0].set(True).at[1].set(True),
        point_fixed=jnp.zeros(n_mp, bool),
    )
    return prob, n_obs


def _pose_graph(n_kf, n_extra, seed=1):
    import jax
    import jax.numpy as jnp

    from orb_slam3_noted_tpu.geometry import sim3 as sim3_mod
    from orb_slam3_noted_tpu.geometry import so3
    from orb_slam3_noted_tpu.optim.pose_graph import Sim3Edges

    rng = np.random.default_rng(seed)
    Rk = so3.exp(jnp.asarray(
        np.stack([np.zeros(n_kf), 0.01 * np.arange(n_kf), np.zeros(n_kf)], 1),
        jnp.float32))
    tk = np.zeros((n_kf, 3))
    tk[:, 0] = 0.1 * np.arange(n_kf)
    ei = list(range(n_kf - 1)) + list(range(n_kf - 5))
    ej = list(range(1, n_kf)) + list(range(5, n_kf))
    extra = rng.integers(0, n_kf, size=(n_extra, 2))
    ei += list(extra[:, 0])
    ej += list(extra[:, 1])
    keep = [a != b for a, b in zip(ei, ej)]
    i_arr = jnp.asarray([a for a, k in zip(ei, keep) if k], jnp.int32)
    j_arr = jnp.asarray([b for b, k in zip(ej, keep) if k], jnp.int32)
    n_e = int(i_arr.shape[0])
    tkj = jnp.asarray(tk, jnp.float32)
    sk = jnp.ones(n_kf, jnp.float32)
    eR, et, es = jax.vmap(lambda a, b: sim3_mod.compose(b, sim3_mod.inverse(a)))(
        (Rk[i_arr], tkj[i_arr], sk[i_arr]), (Rk[j_arr], tkj[j_arr], sk[j_arr]))
    # measurement noise (cost > 0 at the optimum) and a perturbed start
    et = et + jnp.asarray(rng.normal(0.0, 0.01, (n_e, 3)), jnp.float32)
    edges = Sim3Edges(i=i_arr, j=j_arr, R=eR, t=et, s=es,
                      weight=jnp.ones(n_e, jnp.float32),
                      valid=jnp.ones(n_e, bool))
    t0 = tkj + jnp.asarray(rng.normal(0.0, 0.05, (n_kf, 3)), jnp.float32)
    fixed = jnp.zeros(n_kf, bool).at[0].set(True)
    return (Rk, t0, sk, edges, fixed), n_e


def _time_call(fn):
    """(result, first-call seconds, second-call seconds).

    Both sharded solvers build their ``shard_map`` per call, so the second
    call re-traces too; with a persistent compile cache it skips XLA."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, t1 - t0, time.perf_counter() - t1


def four_cards_phase(n_kf=256, n_mp=16384, obs_per_kf=1200, n_extra=1200,
                     n_cards=4) -> dict:
    from orb_slam3_noted_tpu.optim.gba import distributed_global_ba
    from orb_slam3_noted_tpu.optim.pose_graph import distributed_pose_graph_sim3
    from orb_slam3_noted_tpu.parallel.dist_ba import make_mesh

    cam = _cam()
    prob, n_obs = _gba_problem(n_kf, n_mp, obs_per_kf)
    pg_args, n_edges = _pose_graph(n_kf, n_extra)
    out = {"gba": {"n_kf": n_kf, "n_mp": n_mp, "n_obs": n_obs},
           "pose_graph": {"n_kf": n_kf, "n_edges": n_edges}}
    res = {}
    for n in (1, n_cards):
        mesh = make_mesh(n)
        g, g_first, g_s = _time_call(lambda: distributed_global_ba(
            cam, mesh, prob, n_iters=2, n_iters_final=1, cg_iters=12))
        p, p_first, p_s = _time_call(lambda: distributed_pose_graph_sim3(
            mesh, *pg_args, n_iters=8))
        res[n] = (g, p)
        out["gba"][f"{n}_cards"] = {"cost": float(g[3]), "first_s": g_first,
                                    "second_s": g_s}
        out["pose_graph"][f"{n}_cards"] = {"cost": float(p[3]),
                                           "first_s": p_first, "second_s": p_s}
    (g1, p1), (gn, pn) = res[1], res[n_cards]
    checks = {
        "gba_cost_rel": abs(float(gn[3]) - float(g1[3])) / abs(float(g1[3])),
        "gba_t_max_abs_m": max_abs_diff(gn[1], g1[1]),
        "pg_cost_rel": abs(float(pn[3]) - float(p1[3])) / abs(float(p1[3])),
        "pg_t_max_abs_m": max_abs_diff(pn[1], p1[1]),
    }
    out["checks"] = checks
    # costs to a relative 1e-3, pose translations to 1e-3 m
    bad = [k for k, v in checks.items() if not v <= 1e-3]
    out["violations"] = bad
    return out


# ---------------------------------------------------------------------------


def _pin_cards(four: bool) -> str:
    """Restrict CUDA to the cards this run uses; returns the first's index.

    Must run before JAX starts its GPU backend."""
    visible = [v for v in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if v.strip()]
    if not four:
        first = visible[0] if visible else "0"
        os.environ["CUDA_VISIBLE_DEVICES"] = first
        return first
    return visible[0] if visible else "0"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    unknown = [a for a in argv if a != "--four-cards"]
    if unknown:
        print(f"unknown arguments: {unknown}", file=sys.stderr)
        return 2
    first = _pin_cards(four)
    # the host CPU backend is needed beside the GPU for phase 2
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    n_cards = 4 if four else 1
    dev = device_phase(n_cards, first)
    print(json.dumps({"phase": "device", **dev}), flush=True)

    if four:
        phases = [("four_cards", four_cards_phase)]
    else:
        phases = [
            ("frontend", frontend_phase),
            ("stereo_inertial", lambda: _lap_phase("stereo_inertial", vi_lap())),
            ("mono", lambda: _lap_phase("mono", mono_lap())),
        ]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            out = fn()
            rec = {"phase": name, "ok": not out["violations"], **out}
        except Exception as e:  # reported, and fails the run below
            traceback.print_exc()
            rec = {"phase": name, "ok": False, "error": repr(e)[:2000]}
        if not rec["ok"]:
            failed.append(name)
        rec["phase_s"] = time.perf_counter() - t0
        print(json.dumps(rec, default=float), flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
