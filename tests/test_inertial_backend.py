"""Round-5 inertial back-end restoration tests.

The reference pushes EVERY keyframe to LoopClosing regardless of sensor
(`/root/reference/src/LocalMapping.cc:262`), culls redundant keyframes on the
inertial path with the 0.5 stereo-inertial redundancy
(`src/LocalMapping.cc:982-1010`), and corrects inertial loops with the 4-DoF
yaw+translation essential graph so gravity stays untouched
(`src/LoopClosing.cc:1072-1081`).  These tests pin that behaviour in the JAX
engine:

- a drifted gravity-aligned inertial map must be corrected by the 4-DoF
  graph (drift removed, pitch/roll of every keyframe PRESERVED, keyframe
  velocities yaw-rotated);
- a stereo-inertial run must keep inserting keyframes past the static
  capacity via chain-aware culling + slot recycling (the round-4 engine
  stalled at ``max_keyframes``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orb_slam3_noted_tpu.geometry import so3
from orb_slam3_noted_tpu.io.config import SlamConfig
from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu.pipeline import map_state as MS
from orb_slam3_noted_tpu.pipeline.inertial_mapping import KFInertial
from orb_slam3_noted_tpu.pipeline.loop_closing import LoopCloser
from orb_slam3_noted_tpu.place import train_vocabulary

CAM = Camera(PINHOLE, (260.0, 260.0, 159.5, 119.5))


class FakeInertialSlam:
    """Minimal host object for LoopCloser with an initialized IMU."""

    def __init__(self, m, n_kf, vel):
        self.m = m
        self.n_kf = n_kf
        self.last_Rcw = m.kf_Rcw[n_kf - 1]
        self.last_tcw = m.kf_tcw[n_kf - 1]
        self.vel = None
        self.imu_stage = 2          # VIBA1 done: loop detection allowed
        KF = m.kf_valid.shape[0]
        self.ki = KFInertial(
            vel=jnp.broadcast_to(jnp.asarray(vel, jnp.float32), (KF, 3)),
            bg=jnp.zeros((KF, 3), jnp.float32),
            ba=jnp.zeros((KF, 3), jnp.float32),
        )
        self.cur_vel = self.ki.vel[n_kf - 1]


def _rz(psi):
    c, s = np.cos(psi), np.sin(psi)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def build_yaw_drifted_map(rng, n_kf=12, n_pts=150, yaw=0.18):
    """Gravity-aligned map whose tail drifted by a yaw+translation SE3 —
    the drift signature of a gravity-observable (inertial) system."""
    cfg = SlamConfig(
        camera=CAM, width=320, height=240, n_features=n_pts,
        max_keyframes=32, max_map_points=4096,
    )
    m = MS.empty_map(cfg)
    pts = (rng.uniform(-2, 2, size=(n_pts, 3))
           + np.array([0, 0, 5.0])).astype(np.float32)
    desc = rng.integers(0, 2**32, size=(n_pts, 8), dtype=np.uint32)
    Rd = _rz(yaw)
    td = np.array([0.35, -0.2, 0.25], np.float32)

    def project(pts_w, Rcw, tcw):
        xc = pts_w @ np.asarray(Rcw).T + np.asarray(tcw)
        return np.stack(
            [260.0 * xc[:, 0] / xc[:, 2] + 159.5,
             260.0 * xc[:, 1] / xc[:, 2] + 119.5], axis=-1
        )

    kf_poses = []
    for k in range(n_kf):
        # gravity-aligned keyframes: pure yaw orientations + translation
        Rcw = _rz(0.04 * k)
        tcw = np.array([0.1 * k, 0.0, 0.05 * k], np.float32)
        kf_poses.append((Rcw, tcw))

    uv0 = project(pts, *kf_poses[0])
    m = MS.add_keyframe(
        m, jnp.int32(0), jnp.asarray(kf_poses[0][0]),
        jnp.asarray(kf_poses[0][1]), jnp.int32(0),
        jnp.asarray(uv0, jnp.float32),
        jnp.zeros(n_pts, jnp.int32), jnp.zeros(n_pts, jnp.float32),
        jnp.asarray(desc), jnp.ones(n_pts, bool),
        jnp.arange(n_pts, dtype=jnp.int32),
        jnp.full(n_pts, -1.0, jnp.float32),
    )
    m = MS.add_map_points(
        m, jnp.int32(0), jnp.asarray(pts), jnp.asarray(desc),
        jnp.zeros((n_pts, 3), jnp.float32),
        jnp.zeros(n_pts, jnp.float32), jnp.full(n_pts, 100.0, jnp.float32),
        jnp.int32(0), jnp.ones(n_pts, bool),
        jnp.int32(0), jnp.arange(n_pts, dtype=jnp.int32),
        jnp.int32(0), jnp.arange(n_pts, dtype=jnp.int32),
    )
    for k in range(1, n_kf - 1):
        dmid = rng.integers(0, 2**32, size=(n_pts, 8), dtype=np.uint32)
        m = MS.add_keyframe(
            m, jnp.int32(k), jnp.asarray(kf_poses[k][0]),
            jnp.asarray(kf_poses[k][1]), jnp.int32(k),
            jnp.zeros((n_pts, 2), jnp.float32),
            jnp.zeros(n_pts, jnp.int32), jnp.zeros(n_pts, jnp.float32),
            jnp.asarray(dmid), jnp.ones(n_pts, bool),
            jnp.full(n_pts, -1, jnp.int32), jnp.full(n_pts, -1.0, jnp.float32),
        )
    # tail: revisit of KF0's viewpoint, expressed in the yaw-drifted world
    # x' = Rd x + td:  Rcw_tail = R0 Rd^T, tcw_tail = t0 - R0 Rd^T td
    pts_drift = (pts @ Rd.T + td).astype(np.float32)
    R0, t0 = kf_poses[0]
    Rcw_tail = (R0 @ Rd.T).astype(np.float32)
    tcw_tail = (t0 - R0 @ Rd.T @ td).astype(np.float32)
    tail = n_kf - 1
    uv_t = project(pts_drift, Rcw_tail, tcw_tail)
    m = MS.add_keyframe(
        m, jnp.int32(tail), jnp.asarray(Rcw_tail), jnp.asarray(tcw_tail),
        jnp.int32(tail), jnp.asarray(uv_t, jnp.float32),
        jnp.zeros(n_pts, jnp.int32), jnp.zeros(n_pts, jnp.float32),
        jnp.asarray(desc), jnp.ones(n_pts, bool),
        jnp.arange(n_pts, 2 * n_pts, dtype=jnp.int32),
        jnp.full(n_pts, -1.0, jnp.float32),
    )
    m = MS.add_map_points(
        m, jnp.int32(n_pts), jnp.asarray(pts_drift), jnp.asarray(desc),
        jnp.zeros((n_pts, 3), jnp.float32),
        jnp.zeros(n_pts, jnp.float32), jnp.full(n_pts, 100.0, jnp.float32),
        jnp.int32(tail), jnp.ones(n_pts, bool),
        jnp.int32(tail), jnp.arange(n_pts, dtype=jnp.int32),
        jnp.int32(tail), jnp.arange(n_pts, dtype=jnp.int32),
    )
    return m, n_kf, pts, (Rd, td), desc


def test_loop_4dof_preserves_gravity(rng):
    m, n_kf, pts, (Rd, td), desc = build_yaw_drifted_map(rng)
    tail = n_kf - 1
    train = np.concatenate(
        [desc, rng.integers(0, 2**32, size=(2000, 8), dtype=np.uint32)]
    )
    vocab = train_vocabulary(train, n_words=256, n_iters=4)
    lc = LoopCloser(vocab, max_keyframes=32, min_inliers=20,
                    exclude_recent=3, consistency_th=0)
    vel0 = np.array([0.3, 0.1, 0.25], np.float32)
    slam = FakeInertialSlam(m, n_kf, vel0)
    zc_before = np.einsum(
        "kij,j->ki", np.asarray(m.kf_Rcw[:n_kf]), np.array([0, 0, 1.0])
    )
    for k in range(tail):
        _, bow = lc.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])
        lc.db.add(k, bow)

    closed = lc.on_keyframe(slam, tail)
    assert closed, "inertial loop was not detected/verified"

    # drift removed: the tail's duplicated landmarks coincide with the
    # originals again
    mp = np.asarray(slam.m.mp_pos)
    n_pts = len(pts)
    err = np.linalg.norm(mp[n_pts: 2 * n_pts] - pts, axis=1)
    before = np.linalg.norm((pts @ Rd.T + td) - pts, axis=1)
    assert np.median(err) < 0.2 * np.median(before), (
        np.median(err), np.median(before)
    )

    # 4-DoF property: every keyframe's pitch/roll w.r.t. gravity unchanged
    # (the world z axis maps to the SAME camera-frame vector)
    zc_after = np.einsum(
        "kij,j->ki", np.asarray(slam.m.kf_Rcw[:n_kf]), np.array([0, 0, 1.0])
    )
    assert np.max(np.linalg.norm(zc_after - zc_before, axis=1)) < 1e-3, (
        "loop correction tilted gravity"
    )

    # velocities: yaw-rotated in the world — z component and norm preserved
    vel = np.asarray(slam.ki.vel[:n_kf])
    assert np.allclose(vel[:, 2], vel0[2], atol=1e-4)
    assert np.allclose(np.linalg.norm(vel, axis=1),
                       np.linalg.norm(vel0), atol=1e-4)


@pytest.mark.slow
def test_inertial_capacity_recycling():
    """Keyframe insertion must NOT stall at ``max_keyframes`` on the
    inertial path: chain-aware KeyFrameCulling + slot recycling keeps the
    chain bounded while total insertions exceed the static capacity."""
    from orb_slam3_noted_tpu.imu.preintegration import GRAVITY
    from orb_slam3_noted_tpu.pipeline.inertial_system import StereoInertialSLAM
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, stereo_pair

    W, H, FX = 320, 240, 260.0
    BL = 0.12
    cam = Camera(PINHOLE, (FX, FX, W / 2 - 0.5, H / 2 - 0.5))
    FPS, IMU_HZ = 10.0, 200.0

    def cam_pose(t):
        twc = np.array([
            0.22 * np.sin(3.8 * t),
            0.15 * np.cos(4.6 * t) - 0.15,
            0.18 * np.sin(1.9 * t) + 0.08 * t,
        ])
        Rwc = np.asarray(so3.exp(jnp.asarray([
            0.06 * np.sin(1.1 * t), 0.08 * np.sin(0.7 * t),
            0.04 * np.cos(1.3 * t),
        ])))
        return Rwc, twc

    def imu_between(t0, t1):
        g = np.array([0.0, 0.0, -GRAVITY])
        eps = 1e-4
        ts = np.arange(np.ceil(t0 * IMU_HZ), np.floor(t1 * IMU_HZ) + 1) / IMU_HZ
        ts = ts[(ts > t0 + 1e-12) & (ts <= t1 + 1e-12)]
        acc, gyr = [], []
        for t in ts:
            Rwb, p = cam_pose(t)
            _, pp = cam_pose(t + eps)
            _, pm = cam_pose(t - eps)
            a_w = (pp - 2 * p + pm) / (eps * eps)
            Rwb_p, _ = cam_pose(t + eps)
            w_b = np.asarray(so3.log(jnp.asarray(Rwb.T @ Rwb_p))) / eps
            acc.append(Rwb.T @ (a_w - g))
            gyr.append(w_b)
        return np.asarray(acc), np.asarray(gyr), ts

    max_kf = 12
    cfg = SlamConfig(
        camera=cam, width=W, height=H, fps=FPS,
        n_features=500, bf=FX * BL, th_depth=35.0,
        max_keyframes=max_kf, max_map_points=4096,
        local_window=4, kf_max_interval=2, kf_min_interval=0,
        # kf_tracked_ratio > 1 forces c2 whenever tracking holds: a
        # keyframe nearly every frame, saturating capacity quickly
        kf_tracked_ratio=2.0,
        min_tracked_points=12,
        imu_init_time=0.8, imu_viba1_time=1e9, imu_viba2_time=1e9,
        imu_init_min_kfs=4, inertial_window=5,
        imu_noise_gyro=1e-4, imu_noise_acc=1e-3,
        imu_walk_gyro=1e-6, imu_walk_acc=1e-5, imu_freq=IMU_HZ,
    )
    room = BoxRoom(seed=0, depth=2.5, h=1.2, w=1.8)
    slam = StereoInertialSLAM(cfg)
    n_frames = 40
    t_prev = -1.0 / FPS
    for i in range(n_frames):
        t = i / FPS
        Rwc, twc = cam_pose(t)
        left, right, _ = stereo_pair(room, Rwc, twc, cam.params, W, H, BL)
        acc, gyr, ts = imu_between(t_prev, t)
        slam.process(left, right, i, t=t, acc=acc, gyr=gyr, imu_t=ts)
        t_prev = t

    assert slam.imu_stage >= 1, "IMU init never ran"
    assert slam.kf_inserted > max_kf, (
        f"insertion stalled: {slam.kf_inserted} <= capacity {max_kf}"
    )
    # chain consistency: every chain slot live, segments parallel the chain
    kf_valid = np.asarray(jax.device_get(slam.m.kf_valid))
    assert all(kf_valid[s] for s in slam.kf_order)
    assert len(slam.kf_segments) == len(slam.kf_order) - 1
    assert len(slam.seg_ok) == len(slam.kf_segments)
    assert len(slam.kf_order) <= max_kf
    # still tracking at the end
    assert slam.trajectory[-1].state == "OK"
