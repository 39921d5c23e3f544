"""IO tests: YAML settings compatibility, trajectory savers, EuRoC loader."""

import os

import numpy as np
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import so3
from orb_slam3_noted_tpu.io.trajectory import load_tum, save_kitti, save_tum
from orb_slam3_noted_tpu.io.yaml_compat import load_settings
from orb_slam3_noted_tpu.models.cameras import KANNALA_BRANDT8, PINHOLE
from orb_slam3_noted_tpu.pipeline.system import FrameRecord

# minimal settings files in the reference's schema (Examples/Stereo-Inertial)
_FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
EUROC_YAML = os.path.join(_FIXTURES, "EuRoC.yaml")
TUMVI_YAML = os.path.join(_FIXTURES, "TUM_512.yaml")


class TestYamlCompat:
    def test_euroc_settings(self):
        cfg, imu = load_settings(EUROC_YAML)
        assert cfg.camera.kind == PINHOLE
        # stereo-inertial EuRoC yaml carries RECTIFIED intrinsics (fx~435.2)
        np.testing.assert_allclose(cfg.camera.fx, 435.2046959714599, rtol=1e-6)
        assert cfg.n_features == 1200
        assert cfg.n_levels == 8
        assert abs(cfg.scale_factor - 1.2) < 1e-9
        assert cfg.width == 752 and cfg.height == 480
        assert cfg.bf > 0
        assert imu is not None
        assert imu["Tbc"].shape == (4, 4)
        assert imu["freq"] == 200.0
        # noise scaled by sqrt(freq) as the reference does
        assert imu["noise_gyro"] > 1e-4

    def test_tumvi_fisheye_settings(self):
        cfg, imu = load_settings(TUMVI_YAML)
        assert cfg.camera.kind == KANNALA_BRANDT8
        assert len(cfg.camera.params) == 8
        assert cfg.width == 512
        assert imu is not None


class TestTrajectoryIO:
    def _records(self, rng, n=10):
        recs = []
        for i in range(n):
            R = np.asarray(so3.exp(jnp.asarray(rng.normal(0, 0.2, 3))))
            t = rng.normal(size=3)
            recs.append(FrameRecord(i, R, t, "OK", 100))
        return recs

    def test_tum_roundtrip(self, rng, tmp_path):
        recs = self._records(rng)
        path = os.path.join(tmp_path, "traj.txt")
        save_tum(path, recs)
        t, pos, q = load_tum(path)
        assert len(t) == 10
        for i, rec in enumerate(recs):
            twc = -rec.Rcw.T @ rec.tcw
            np.testing.assert_allclose(pos[i], twc, atol=1e-6)
            Rwc = np.asarray(so3.from_quat(jnp.asarray(q[i])))
            np.testing.assert_allclose(Rwc, rec.Rcw.T, atol=1e-5)

    def test_kitti_format(self, rng, tmp_path):
        recs = self._records(rng, 5)
        path = os.path.join(tmp_path, "kitti.txt")
        save_kitti(path, recs)
        raw = np.loadtxt(path)
        assert raw.shape == (5, 12)
        M = raw[0].reshape(3, 4)
        np.testing.assert_allclose(M[:, :3], recs[0].Rcw.T, atol=1e-6)


class TestLiveViewer:
    def test_live_viewer_serves_state(self):
        """The live viewer (reference Viewer-thread equivalent) must serve
        the HTML page and a fresh map snapshot over HTTP."""
        import json as _json
        import urllib.request

        from orb_slam3_noted_tpu.io.config import SlamConfig
        from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
        from orb_slam3_noted_tpu.pipeline.system import MonoSLAM
        from orb_slam3_noted_tpu.utils.viewer import LiveViewer

        cam = Camera(PINHOLE, (260.0, 260.0, 159.5, 119.5))
        cfg = SlamConfig(camera=cam, width=320, height=240, n_features=64,
                         max_keyframes=8, max_map_points=256)
        slam = MonoSLAM(cfg)
        v = LiveViewer(slam, port=0)  # ephemeral port
        try:
            page = urllib.request.urlopen(
                f"http://127.0.0.1:{v.port}/", timeout=10).read().decode()
            assert "state.json" in page and "<canvas" in page
            state = _json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{v.port}/state.json", timeout=10).read())
            for key in ("points", "trajectory", "kf_centers", "n_kf", "n_mp"):
                assert key in state
        finally:
            v.close()
