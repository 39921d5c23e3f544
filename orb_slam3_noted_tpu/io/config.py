"""Typed SLAM configuration.

One typed config object replacing the reference's per-sequence OpenCV YAML
parsing spread over ``Tracking::Parse{Cam,ORB,IMU}ParamFile``
(`/root/reference/src/Tracking.cc:490,1022,1106`).  A YAML loader for the
reference's exact file schema lives in :mod:`orb_slam3_noted_tpu.io.yaml_compat`
so existing dataset configs keep working.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE


@dataclass(frozen=True)
class SlamConfig:
    # --- camera ---
    camera: Camera = Camera(PINHOLE, (458.654, 457.296, 367.215, 248.375))
    width: int = 752
    height: int = 480
    fps: float = 20.0
    bf: float = 0.0                  # baseline x fx (stereo), reference "Camera.bf"
    th_depth: float = 35.0           # close/far stereo point threshold ("ThDepth")
    dist_coeffs: tuple = ()          # rad-tan (k1,k2,p1,p2[,k3]); empty = none

    # --- second camera (non-rectified fisheye stereo; reference
    #     "Camera2.*" + "Tlr" + lapping areas, `src/Tracking.cc:724-815`) ---
    camera2: Camera | None = None    # right camera model (KB8 for TUM-VI)
    tlr_r: tuple = ()                # 9 floats row-major Rlr (right in left)
    tlr_t: tuple = (0.0, 0.0, 0.0)   # tlr (right cam origin in left frame)
    lapping_l: tuple = (0.0, 1e9)    # (Camera.lappingBegin, Camera.lappingEnd)
    lapping_r: tuple = (0.0, 1e9)    # (Camera2.lappingBegin, Camera2.lappingEnd)

    # --- ORB extractor (reference YAML ORBextractor.*) ---
    n_features: int = 1200
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0

    # --- map capacities (static shapes) ---
    max_keyframes: int = 256
    max_map_points: int = 16384

    # --- tracking policy ---
    min_tracked_points: int = 15     # lost below this
    kf_min_interval: int = 0         # min frames between KFs
    kf_max_interval: int = 30        # force KF after this many frames
    kf_tracked_ratio: float = 0.9    # new KF when tracked < ratio * ref visible
    local_window: int = 10           # covisible KFs for local map / local BA
    triangulate_neighbors: int = 10  # covisible KFs matched for new points
    # (reference CreateNewMapPoints covers 10 for mono / 20 visual-only
    # neighbours, `src/LocalMapping.cc:402-422`)
    # re-track the rest of a batch after a mid-batch keyframe (tighter than
    # the reference, whose tracking keeps using the pre-KF map until the
    # async mapper lands; costs a second dispatch per keyframe)
    retrack_after_kf: bool = False
    ba_iters: int = 4                # robust LM iterations in local BA
    ba_iters_final: int = 3          # post-outlier-reclassify iterations

    # --- matching ---
    nn_ratio_track: float = 0.9
    search_radius_px: float = 15.0

    # --- loop closing ---
    enable_loop_closing: bool = False
    vocab_words: int = 1024
    loop_min_inliers: int = 25
    # devices the loop correction's pose graph and global BA are sharded
    # over; 1 keeps both on the first device, the sharded paths are taken
    # only when this asks for more
    loop_mesh_devices: int = 1

    # --- IMU (reference YAML IMU.* via Tracking::ParseIMUParamFile,
    #     `/root/reference/src/Tracking.cc:1106`) ---
    imu_rbc: tuple = ()              # 9 floats row-major Rbc; empty = identity
    imu_tbc: tuple = (0.0, 0.0, 0.0)
    imu_noise_gyro: float = 1.7e-4   # continuous noise densities
    imu_noise_acc: float = 2.0e-3
    imu_walk_gyro: float = 1.9e-5
    imu_walk_acc: float = 3.0e-3
    imu_freq: float = 200.0
    # staged initialization schedule (reference `src/LocalMapping.cc:187-236`)
    imu_init_time: float = 2.0       # seconds of KFs before first init
    imu_viba1_time: float = 5.0      # VIBA1 refinement
    imu_viba2_time: float = 15.0     # VIBA2 refinement
    imu_init_min_kfs: int = 6
    inertial_window: int = 10        # temporal KFs in LocalInertialBA (Nd)

    @property
    def level_sigma2(self):
        return tuple(
            (self.scale_factor ** (2 * i)) for i in range(self.n_levels)
        )

    def imu_calib(self, dtype=None):
        """Build the device Calib (discrete per-sample variances).

        The reference multiplies continuous densities by sqrt(freq) when
        constructing ``IMU::Calib`` (`src/Tracking.cc:1186-1192`), i.e. the
        per-sample variance is density^2 * freq.
        """
        import jax.numpy as jnp

        from orb_slam3_noted_tpu.imu.preintegration import Calib

        dt = dtype or jnp.float32
        Rbc = (
            jnp.asarray(self.imu_rbc, dt).reshape(3, 3)
            if self.imu_rbc else jnp.eye(3, dtype=dt)
        )
        f = self.imu_freq
        return Calib(
            Rbc=Rbc,
            tbc=jnp.asarray(self.imu_tbc, dt),
            cov_ng=jnp.asarray(self.imu_noise_gyro**2 * f, dt),
            cov_na=jnp.asarray(self.imu_noise_acc**2 * f, dt),
            cov_walk_g=jnp.asarray(self.imu_walk_gyro**2 / f, dt),
            cov_walk_a=jnp.asarray(self.imu_walk_acc**2 / f, dt),
        )
