"""Stereo matching tests: depth recovery on a rendered rectified pair."""

import numpy as np
import jax.numpy as jnp

from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu.ops import image as I
from orb_slam3_noted_tpu.ops import orb as O
from orb_slam3_noted_tpu.ops.stereo import match_stereo, stereo_from_depth
from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, stereo_pair


def setup_pair():
    W, H = 320, 240
    fx = 260.0
    baseline = 0.12
    bf = fx * baseline
    cam = Camera(PINHOLE, (fx, fx, W / 2 - 0.5, H / 2 - 0.5))
    room = BoxRoom(seed=3)
    Rwc = np.eye(3)
    twc = np.zeros(3)
    left, right, depth = stereo_pair(room, Rwc, twc, cam.params, W, H, baseline)
    return left, right, depth, bf, baseline


class TestStereoMatching:
    def test_depth_recovery(self):
        left, right, depth_gt, bf, baseline = setup_pair()
        n_levels = 4
        fl = O.extract_orb(jnp.asarray(left), n_features=500, n_levels=n_levels)
        fr = O.extract_orb(jnp.asarray(right), n_features=500, n_levels=n_levels)
        pyr_l = tuple(I.build_pyramid(jnp.asarray(left), n_levels))
        pyr_r = tuple(I.build_pyramid(jnp.asarray(right), n_levels))
        sm = match_stereo(fl, fr, pyr_l, pyr_r, bf=bf, baseline=baseline,
                          n_levels=n_levels)
        v = np.asarray(sm.valid)
        assert v.sum() > 100, f"only {v.sum()} stereo matches"
        xy = np.asarray(fl.xy)[v]
        est = np.asarray(sm.depth)[v]
        gt = depth_gt[
            np.clip(xy[:, 1].astype(int), 0, 239), np.clip(xy[:, 0].astype(int), 0, 319)
        ]
        rel = np.abs(est - gt) / gt
        # sub-5% median depth error, few gross outliers
        assert np.median(rel) < 0.05, np.median(rel)
        assert (rel < 0.15).mean() > 0.85

    def test_rgbd_virtual_right(self):
        left, right, depth_gt, bf, baseline = setup_pair()
        fl = O.extract_orb(jnp.asarray(left), n_features=300, n_levels=4)
        sm = stereo_from_depth(fl, jnp.asarray(depth_gt), bf)
        v = np.asarray(sm.valid)
        assert v.sum() > 200
        xy = np.asarray(fl.xy)[v]
        np.testing.assert_allclose(
            np.asarray(sm.u_right)[v],
            xy[:, 0] - bf / np.asarray(sm.depth)[v],
            atol=1e-4,
        )


def test_full_width_batch_depth():
    """EuRoC width (752x480, 1200 features, 8 levels): batched extraction
    and the gather SAD refinement recover the rendered depth."""
    import jax

    W, H, baseline = 752, 480, 0.11
    cam = Camera(PINHOLE, (458.654, 457.296, 367.215, 248.375))
    bf = cam.fx * baseline
    room = BoxRoom(seed=0)
    yaws = (0.45, 0.6)
    pairs = [
        stereo_pair(room, np.asarray(so3_exp(y)), np.array([0.0, 0.0, 0.5 * k]),
                    cam.params, W, H, baseline)
        for k, y in enumerate(yaws)
    ]
    L = jnp.asarray(np.stack([p[0] for p in pairs]).astype(np.uint8),
                    jnp.float32)
    R = jnp.asarray(np.stack([p[1] for p in pairs]).astype(np.uint8),
                    jnp.float32)
    fl = O.extract_orb_batch(L, n_features=1200, n_levels=8)
    fr = O.extract_orb_batch(R, n_features=1200, n_levels=8)
    assert fl.xy.shape == (2, 1200, 2) and fl.desc.shape == (2, 1200, 8)
    pyr = jax.vmap(lambda im: tuple(I.build_pyramid(im, 8)))
    sm = jax.vmap(
        lambda a, b, c, d: match_stereo(a, b, c, d, bf=bf, baseline=baseline)
    )(fl, fr, pyr(L), pyr(R))
    for f, (_, _, depth_gt) in enumerate(pairs):
        v = np.asarray(sm.valid[f])
        assert v.sum() > 400, f"frame {f}: only {v.sum()} stereo matches"
        xy = np.asarray(fl.xy[f])[v]
        gt = depth_gt[np.clip(np.round(xy[:, 1]).astype(int), 0, H - 1),
                      np.clip(np.round(xy[:, 0]).astype(int), 0, W - 1)]
        rel = np.abs(np.asarray(sm.depth[f])[v] - gt) / gt
        assert np.median(rel) < 0.05, np.median(rel)
        assert (rel < 0.15).mean() > 0.85


def so3_exp(yaw):
    from orb_slam3_noted_tpu.geometry import so3

    return so3.exp(jnp.asarray([0.0, yaw, 0.0]))
