"""Loop-closing integration test on a synthetically drifted map.

Builds a keyframe chain whose tail has accumulated a known Sim3 drift, with
the tail keyframe observing drifted duplicates of the first keyframe's map
points (same descriptors, shifted positions) — exactly the situation after a
long monocular loop.  The LoopCloser must retrieve the first keyframe from
the BoW database, verify the Sim3, and pull the tail back.
"""

import numpy as np
import jax
import pytest
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import sim3, so3
from orb_slam3_noted_tpu.io.config import SlamConfig
from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu.pipeline import map_state as MS
from orb_slam3_noted_tpu.pipeline.loop_closing import LoopCloser
from orb_slam3_noted_tpu.place import train_vocabulary

CAM = Camera(PINHOLE, (260.0, 260.0, 159.5, 119.5))


class FakeSlam:
    """Minimal host object exposing what LoopCloser needs."""

    def __init__(self, m, n_kf):
        self.m = m
        self.n_kf = n_kf
        self.last_Rcw = m.kf_Rcw[n_kf - 1]
        self.last_tcw = m.kf_tcw[n_kf - 1]
        self.vel = None


def build_drifted_map(rng, n_kf=12, n_pts=150, drift_scale=1.12):
    cfg = SlamConfig(
        camera=CAM, width=320, height=240, n_features=n_pts,
        max_keyframes=32, max_map_points=4096,
    )
    m = MS.empty_map(cfg)

    # physical scene: cloud ahead of the origin
    pts = (rng.uniform(-2, 2, size=(n_pts, 3)) + np.array([0, 0, 5.0])).astype(np.float32)
    desc = rng.integers(0, 2**32, size=(n_pts, 8), dtype=np.uint32)

    # drift: tail of the trajectory is off by a known Sim3 (in world frame)
    S_drift = (
        np.asarray(so3.exp(jnp.asarray([0.02, 0.08, -0.03], jnp.float32))),
        np.array([0.4, -0.2, 0.3], np.float32),
        np.float32(drift_scale),
    )

    def project_bind(pts_w, Rcw, tcw, mp_bind):
        xc = pts_w @ np.asarray(Rcw).T + np.asarray(tcw)
        uv = np.asarray(
            jnp.stack(
                [
                    260.0 * xc[:, 0] / xc[:, 2] + 159.5,
                    260.0 * xc[:, 1] / xc[:, 2] + 119.5,
                ],
                axis=-1,
            )
        )
        return uv

    kf_poses = []
    # KF0 at origin observing the true points
    for k in range(n_kf):
        ang = 0.03 * k
        Rcw = np.asarray(so3.exp(jnp.asarray([0.0, ang, 0.0], jnp.float32)))
        tcw = np.array([0.1 * k, 0.0, 0.05 * k], np.float32)
        kf_poses.append((Rcw, tcw))

    # true map points observed by KF0 (slots 0..n_pts-1)
    uv0 = project_bind(pts, *kf_poses[0], None)
    m = MS.add_keyframe(
        m, jnp.int32(0), jnp.asarray(kf_poses[0][0]), jnp.asarray(kf_poses[0][1]),
        jnp.int32(0), jnp.asarray(uv0, jnp.float32),
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

    # middle keyframes: unrelated descriptors, no shared points with KF0/tail
    for k in range(1, n_kf - 1):
        dmid = rng.integers(0, 2**32, size=(n_pts, 8), dtype=np.uint32)
        m = MS.add_keyframe(
            m, jnp.int32(k), jnp.asarray(kf_poses[k][0]), jnp.asarray(kf_poses[k][1]),
            jnp.int32(k), jnp.zeros((n_pts, 2), jnp.float32),
            jnp.zeros(n_pts, jnp.int32), jnp.zeros(n_pts, jnp.float32),
            jnp.asarray(dmid), jnp.ones(n_pts, bool),
            jnp.full(n_pts, -1, jnp.int32), jnp.full(n_pts, -1.0, jnp.float32),
        )

    # Tail keyframe: physically back at KF0's viewpoint, but its map/pose
    # live in the drifted world x' = sd * Rd x + td.  The locally-consistent
    # SE3 pose satisfies x_c_drift = sd * x_c_true (camera-frame coordinates
    # scaled by the drift, as mono scale drift produces):
    #   Rcw_tail = R0 Rd^T,  tcw_tail = sd t0 - R0 Rd^T td
    Rd, td, sd = S_drift
    pts_drift = (sd * (pts @ Rd.T) + td).astype(np.float32)
    R0, t0 = kf_poses[0]
    Rcw_tail = (R0 @ Rd.T).astype(np.float32)
    tcw_tail = (sd * t0 - R0 @ Rd.T @ td).astype(np.float32)
    tail = n_kf - 1
    desc_tail = desc.copy()  # same appearance as KF0 (revisit)
    uv_t = project_bind(pts_drift, Rcw_tail, tcw_tail, None)
    m = MS.add_keyframe(
        m, jnp.int32(tail), jnp.asarray(Rcw_tail), jnp.asarray(tcw_tail),
        jnp.int32(tail), jnp.asarray(uv_t, jnp.float32),
        jnp.zeros(n_pts, jnp.int32), jnp.zeros(n_pts, jnp.float32),
        jnp.asarray(desc_tail), jnp.ones(n_pts, bool),
        jnp.arange(n_pts, 2 * n_pts, dtype=jnp.int32),
        jnp.full(n_pts, -1.0, jnp.float32),
    )
    m = MS.add_map_points(
        m, jnp.int32(n_pts), jnp.asarray(pts_drift), jnp.asarray(desc_tail),
        jnp.zeros((n_pts, 3), jnp.float32),
        jnp.zeros(n_pts, jnp.float32), jnp.full(n_pts, 100.0, jnp.float32),
        jnp.int32(tail), jnp.ones(n_pts, bool),
        jnp.int32(tail), jnp.arange(n_pts, dtype=jnp.int32),
        jnp.int32(tail), jnp.arange(n_pts, dtype=jnp.int32),
    )
    return m, n_kf, pts, S_drift, desc


def test_loop_detect_and_correct(rng):
    m, n_kf, pts, S_drift, desc = build_drifted_map(rng)
    tail = n_kf - 1

    # vocabulary trained on scene-like descriptors
    train = np.concatenate([desc, rng.integers(0, 2**32, size=(2000, 8), dtype=np.uint32)])
    vocab = train_vocabulary(train, n_words=256, n_iters=4)
    # consistency_th=0: accept on first sight (the chain counter starts at 0
    # on first detection, matching the reference's nCurrentConsistency)
    lc = LoopCloser(vocab, max_keyframes=32, min_inliers=20, exclude_recent=3,
                    consistency_th=0)

    slam = FakeSlam(m, n_kf)
    # register all earlier keyframes in the database
    for k in range(tail):
        _, bow = lc.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])
        lc.db.add(k, bow)

    closed = lc.on_keyframe(slam, tail)
    assert closed, "loop was not detected/verified"

    # after correction the tail's duplicated points must coincide with the
    # original points (drift removed)
    mp = np.asarray(slam.m.mp_pos)
    n_pts = len(pts)
    err = np.linalg.norm(mp[n_pts : 2 * n_pts] - pts, axis=1)
    before = np.linalg.norm(
        (S_drift[2] * (pts @ S_drift[0].T) + S_drift[1]) - pts, axis=1
    )
    assert np.median(err) < 0.15 * np.median(before), (
        np.median(err), np.median(before)
    )


def test_temporal_consistency_gates_single_hit(rng):
    """With the reference's 3-hit policy a single detection must NOT correct."""
    m, n_kf, pts, S_drift, desc = build_drifted_map(rng)
    tail = n_kf - 1
    train = np.concatenate(
        [desc, rng.integers(0, 2**32, size=(2000, 8), dtype=np.uint32)]
    )
    vocab = train_vocabulary(train, n_words=256, n_iters=4)
    lc = LoopCloser(vocab, max_keyframes=32, min_inliers=20, exclude_recent=3,
                    consistency_th=3)
    slam = FakeSlam(m, n_kf)
    for k in range(tail):
        _, bow = lc.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])
        lc.db.add(k, bow)

    assert not lc.on_keyframe(slam, tail), "one hit must not close with th=3"
    assert len(lc.consistent_groups) > 0  # candidate recorded for next KF
    # feeding the SAME keyframe again simulates consecutive re-detections of
    # the same place: the counter must ripen and eventually allow the close.
    # Reference accumulation: chain length is 0 on first sight and accepts
    # once it REACHES th — i.e. the (th+1)-th consecutive detection
    # (`src/LoopClosing.cc:400-430` nCurrentConsistency >= th).
    lc.db.erase(tail)
    assert not lc.on_keyframe(slam, tail)
    lc.db.erase(tail)
    assert not lc.on_keyframe(slam, tail), "3rd hit: chain=2 < th"
    lc.db.erase(tail)
    assert lc.on_keyframe(slam, tail), "4th consistent hit should close"


class FakeSlamFull(FakeSlam):
    """FakeSlam + camera context: enables the Sim3 verification ladder."""

    def __init__(self, m, n_kf, cfg):
        super().__init__(m, n_kf)
        self.cam = cfg.camera
        self.cfg = cfg


def _ladder_cfg(n_pts):
    return SlamConfig(
        camera=CAM, width=320, height=240, n_features=n_pts,
        max_keyframes=32, max_map_points=4096,
    )


def test_sim3_ladder_accepts_consistent(rng):
    """With camera context the ladder (SearchBySim3 + OptimizeSim3) must
    still verify and close a geometrically consistent loop."""
    m, n_kf, pts, S_drift, desc = build_drifted_map(rng)
    tail = n_kf - 1
    train = np.concatenate(
        [desc, rng.integers(0, 2**32, size=(2000, 8), dtype=np.uint32)]
    )
    vocab = train_vocabulary(train, n_words=256, n_iters=4)
    lc = LoopCloser(vocab, max_keyframes=32, min_inliers=20, exclude_recent=3,
                    consistency_th=0)
    slam = FakeSlamFull(m, n_kf, _ladder_cfg(len(pts)))
    for k in range(tail):
        _, bow = lc.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])
        lc.db.add(k, bow)
    assert lc.on_keyframe(slam, tail), "consistent loop must pass the ladder"


def test_sim3_ladder_rejects_inconsistent_observations(rng):
    """3D-3D RANSAC alone would accept this loop (the point sets really do
    correspond up to a Sim3), but the candidate keyframe's stored pixel
    observations are garbage — the reprojection OptimizeSim3 stage must
    reject it (reference's >= 20 post-optimization inlier gate)."""
    m, n_kf, pts, S_drift, desc = build_drifted_map(rng)
    tail = n_kf - 1
    NF = m.kf_xy.shape[1]
    bad_xy = rng.uniform(0.0, 200.0, size=(NF, 2)).astype(np.float32)
    m = m._replace(kf_xy=m.kf_xy.at[0].set(jnp.asarray(bad_xy)))
    train = np.concatenate(
        [desc, rng.integers(0, 2**32, size=(2000, 8), dtype=np.uint32)]
    )
    vocab = train_vocabulary(train, n_words=256, n_iters=4)
    lc = LoopCloser(vocab, max_keyframes=32, min_inliers=20, exclude_recent=3,
                    consistency_th=0)
    slam = FakeSlamFull(m, n_kf, _ladder_cfg(len(pts)))
    for k in range(tail):
        _, bow = lc.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])
        lc.db.add(k, bow)
    assert not lc.on_keyframe(slam, tail), (
        "reprojection-inconsistent loop must be rejected by the ladder"
    )
    assert lc.loops_closed == 0


@pytest.mark.parametrize("mesh_devices", [1, 8])
def test_loop_correction_device_choice(rng, monkeypatch, mesh_devices):
    """The conftest exposes 8 devices, yet correction stays on one device
    (single-device pose graph, time-sliced GBA) unless
    ``SlamConfig.loop_mesh_devices`` asks for the sharded paths."""
    import dataclasses

    from orb_slam3_noted_tpu.optim import gba as gba_mod
    from orb_slam3_noted_tpu.optim import pose_graph as pg_mod
    from orb_slam3_noted_tpu.pipeline import loop_closing as lc_mod

    assert jax.device_count() == 8
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(lc_mod, "optimize_pose_graph_sim3", spy(
        "pose_graph", lc_mod.optimize_pose_graph_sim3))
    monkeypatch.setattr(pg_mod, "distributed_pose_graph_sim3", spy(
        "pose_graph_sharded", pg_mod.distributed_pose_graph_sim3))
    monkeypatch.setattr(gba_mod, "SlicedGBA", spy(
        "sliced_gba", gba_mod.SlicedGBA))
    # the sharded GBA itself is covered by test_dist_ba; record the choice
    monkeypatch.setattr(gba_mod, "run_global_ba_mesh", lambda m, *a, **k: (
        calls.append(("gba_mesh", a[2].size)) or (m, None)))

    m, n_kf, pts, S_drift, desc = build_drifted_map(rng)
    tail = n_kf - 1
    train = np.concatenate(
        [desc, rng.integers(0, 2**32, size=(2000, 8), dtype=np.uint32)]
    )
    vocab = train_vocabulary(train, n_words=256, n_iters=4)
    lc = LoopCloser(vocab, max_keyframes=32, min_inliers=20, exclude_recent=3,
                    consistency_th=0)
    cfg = dataclasses.replace(_ladder_cfg(len(pts)),
                              loop_mesh_devices=mesh_devices)
    slam = FakeSlamFull(m, n_kf, cfg)
    for k in range(tail):
        _, bow = lc.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])
        lc.db.add(k, bow)
    assert lc.on_keyframe(slam, tail)
    if mesh_devices == 1:
        assert calls == ["pose_graph", "sliced_gba"]
        assert lc.active_gba is not None
    else:
        assert calls == ["pose_graph_sharded", ("gba_mesh", 8)]
        assert lc.active_gba is None
    # either path pulls the drifted duplicates back onto the originals
    mp = np.asarray(slam.m.mp_pos)
    n_pts = len(pts)
    err = np.linalg.norm(mp[n_pts: 2 * n_pts] - pts, axis=1)
    before = np.linalg.norm(
        (S_drift[2] * (pts @ S_drift[0].T) + S_drift[1]) - pts, axis=1
    )
    assert np.median(err) < 0.15 * np.median(before)
