"""Visual-inertial SLAM systems (monocular-inertial, stereo-inertial).

Host orchestration equivalent of the reference's IMU_MONOCULAR / IMU_STEREO
sensor modes: ``Tracking::PreintegrateIMU`` frame-boundary resampling
(`/root/reference/src/Tracking.cc:1380-1493`), ``PredictStateIMU`` pose
prediction (`:1498`), visual-inertial motion-only optimization
(``PoseInertialOptimizationLastKeyFrame``, `src/Optimizer.cc:6630`), the
staged IMU initialization of ``LocalMapping::InitializeIMU``
(`src/LocalMapping.cc:1274-1435`: init at ~2 s, VIBA1 at 5 s, VIBA2 at 15 s,
with bias priors 1e2/1e10 -> 1/1e5 -> 0/0) and ``LocalInertialBA``
(`src/Optimizer.cc:3900`) at keyframe insertion.

Scalar control flow (stage machine, keyframe policy) runs on host; every
numeric step is a jitted device computation with static shapes (IMU windows
padded, BA windows padded).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.imu.preintegration import (
    Bias,
    Preintegrated,
    init_preintegrated,
    integrate_measurements,
    predict_state,
)
from orb_slam3_noted_tpu.io.config import SlamConfig
from orb_slam3_noted_tpu.geometry import so3
from orb_slam3_noted_tpu.optim.inertial import inertial_init
from orb_slam3_noted_tpu.optim.inertial_ba import vi_pose_optimization
from orb_slam3_noted_tpu.optim.vi_factors import (
    VIState,
    body_from_cam,
    cam_from_body,
)
from orb_slam3_noted_tpu.ops import orb as O
from orb_slam3_noted_tpu.pipeline import inertial_mapping as IMAP
from orb_slam3_noted_tpu.pipeline import map_state as MS
from orb_slam3_noted_tpu.pipeline import tracking as T
from orb_slam3_noted_tpu.utils.timing import GLOBAL_TIMER as TIMER
from orb_slam3_noted_tpu.pipeline.system import (
    NOT_INITIALIZED,
    OK,
    RECENTLY_LOST,
    MonoSLAM,
    StereoSLAM,
)

# padded IMU sample counts (static shapes for the preintegration scan)
_FRAME_PAD = 128      # samples per frame interval (200 Hz / 20 fps = ~10)
_KF_PAD = 1024        # samples per keyframe interval


def resample_interval(acc, gyr, ts, t0, t1):
    """Midpoint-resample raw samples onto [t0, t1] (host, numpy).

    The frame-boundary handling of ``Tracking::PreintegrateIMU``
    (`src/Tracking.cc:1440-1485`): virtual samples at t0/t1 by linear
    interpolation, then midpoint measurements over consecutive intervals.
    Returns (acc_mid (M, 3), gyr_mid (M, 3), dt (M,)).
    """
    acc = np.asarray(acc, np.float64).reshape(-1, 3)
    gyr = np.asarray(gyr, np.float64).reshape(-1, 3)
    ts = np.asarray(ts, np.float64).reshape(-1)
    if t1 <= t0 or len(ts) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,))
    # interpolate measurement streams at the boundary times, then take the
    # samples strictly inside plus the two virtual endpoints
    tt = np.concatenate([[t0], ts[(ts > t0) & (ts < t1)], [t1]])
    a = np.stack([np.interp(tt, ts, acc[:, k]) for k in range(3)], -1)
    w = np.stack([np.interp(tt, ts, gyr[:, k]) for k in range(3)], -1)
    dt = np.diff(tt)
    acc_mid = 0.5 * (a[:-1] + a[1:])
    gyr_mid = 0.5 * (w[:-1] + w[1:])
    keep = dt > 1e-9
    return acc_mid[keep], gyr_mid[keep], dt[keep]


def _pad(a, w, d, n):
    m = len(d)
    if m > n:  # drop oldest extras (shouldn't happen with sane pads)
        a, w, d = a[-n:], w[-n:], d[-n:]
        m = n
    acc = np.zeros((n, 3), np.float32)
    gyr = np.zeros((n, 3), np.float32)
    dts = np.zeros((n,), np.float32)
    acc[:m], gyr[:m], dts[:m] = a, w, d
    return jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(dts)


class _ImuStream:
    """Host-side raw IMU sample buffer with interval extraction."""

    def __init__(self):
        self.acc = np.zeros((0, 3))
        self.gyr = np.zeros((0, 3))
        self.t = np.zeros((0,))

    def push(self, acc, gyr, ts):
        if len(np.atleast_1d(ts)) == 0:
            return
        self.acc = np.concatenate([self.acc, np.asarray(acc).reshape(-1, 3)])
        self.gyr = np.concatenate([self.gyr, np.asarray(gyr).reshape(-1, 3)])
        self.t = np.concatenate([self.t, np.asarray(ts).reshape(-1)])
        # keep a bounded history (enough for any keyframe interval)
        if len(self.t) > 8192:
            self.acc = self.acc[-8192:]
            self.gyr = self.gyr[-8192:]
            self.t = self.t[-8192:]

    def interval(self, t0, t1):
        return resample_interval(self.acc, self.gyr, self.t, t0, t1)


class InertialMixin:
    """Shared visual-inertial machinery layered over a visual SLAM base."""

    def _init_inertial(self, cfg: SlamConfig):
        self.calib = cfg.imu_calib()
        self.imu = _ImuStream()
        self.ki = IMAP.empty_inertial(cfg)
        self.bias = Bias.zero()
        self.imu_stage = 0          # 0: vision-only, 1: init, 2: VIBA1, 3: VIBA2
        self.kf_order: list[int] = []       # KF slots in temporal order
        self.kf_times: list[float] = []
        self.kf_segments: list[tuple] = []  # raw (acc, gyr, dt) per chain segment
        self.seg_preints: list[Preintegrated] = []
        # per-segment validity: False marks a chain break (e.g. the junction
        # between two merged maps, where no IMU data spans the gap)
        self.seg_ok: list[bool] = []
        self.since_kf = (np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,)))
        self.last_t = None
        self.cur_vel = jnp.zeros(3, jnp.float32)
        self.frames_total = 0
        # bad-IMU watchdog (reference `src/LocalMapping.cc:142-149`):
        # accumulated "moving" init time; resets the map when the camera
        # has not moved enough for inertial init to be observable
        self._tinit_moving = 0.0

    # -- robustness plumbing -------------------------------------------
    def _check_timestamps(self, t):
        """Timestamp-sanity handling (reference `src/Tracking.cc:1674-1712`).

        Returns True when the frame stream broke and the map was reset —
        the caller should fall through to (re)initialization with the
        current frame.
        """
        if self.last_t is None or self.state == NOT_INITIALIZED:
            return False
        if t < self.last_t - 1e-9:
            # clock went backwards: queued IMU is garbage; fresh map
            # (reference clears mlQueueImuData + CreateMapInAtlas)
            self._reset_inertial_map(save=False)
            return True
        if t > self.last_t + 1.0:
            # >1 s gap at camera rate means lost data; the map survives
            # only if VIBA2 already refined it (reference keeps the map and
            # creates a new one iff GetIniertialBA2())
            self._reset_inertial_map(save=self.imu_stage >= 3)
            return True
        return False

    def _reset_inertial_map(self, save: bool):
        """Reset the active map + inertial chain (reference ResetActiveMap /
        CreateMapInAtlas).  ``save`` is an Atlas hook: the inertial Atlas
        wrapper stores the map before resetting; plain systems drop it."""
        if save and hasattr(self, "_store_active_map"):
            self._store_active_map()
        self.reset()
        self._init_inertial(self.cfg)

    def _check_bad_imu(self):
        """Not-enough-motion watchdog (reference `src/LocalMapping.cc:
        142-149`): after IMU init but before VIBA2, if the last three
        keyframes moved < 2 cm in total, inertial init was unobservable —
        reset the map.  Returns True when a reset happened."""
        if not (1 <= self.imu_stage < 3) or len(self.kf_order) < 3:
            return False
        # the 2-cm test is only meaningful over a real time baseline: the
        # visual KF policy can insert keyframes a frame apart (bunched
        # <0.2 s), where even healthy motion covers <2 cm — firing there
        # resets perfectly good maps (found on the bench's slow-phase
        # trajectory).  The reference's KF cadence makes ~0.5 s implicit.
        if self.kf_times[-1] - self.kf_times[-3] < 0.45:
            return False
        sl = self.kf_order[-3:]
        R = np.asarray(self.m.kf_Rcw[jnp.asarray(sl)])
        tt = np.asarray(self.m.kf_tcw[jnp.asarray(sl)])
        centers = np.einsum("kji,kj->ki", R, -tt)
        dist = (np.linalg.norm(centers[2] - centers[1])
                + np.linalg.norm(centers[1] - centers[0]))
        if dist > 0.05:
            self._tinit_moving += self.kf_times[-1] - self.kf_times[-2]
        if self._tinit_moving < 10.0 and dist < 0.02:
            self._reset_inertial_map(save=False)
            return True
        return False

    # -- raw sample ingestion ------------------------------------------
    def feed_imu(self, acc, gyr, ts):
        self.imu.push(acc, gyr, ts)

    def _accumulate_interval(self, t):
        """Collect resampled measurements from the last frame to t."""
        if self.last_t is None:
            self.last_t = t
            return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,))
        a, w, d = self.imu.interval(self.last_t, t)
        self.last_t = t
        sa, sw, sd = self.since_kf
        self.since_kf = (
            np.concatenate([sa, a]), np.concatenate([sw, w]),
            np.concatenate([sd, d]),
        )
        return a, w, d

    def _preint_since_kf(self, bias=None) -> Preintegrated:
        a, w, d = self.since_kf
        acc, gyr, dts = _pad(a, w, d, _KF_PAD)
        return integrate_measurements(bias or self.bias, acc, gyr, dts, self.calib)

    # -- batch-walk hooks ----------------------------------------------
    def _on_batch_frame(self, frame_id):
        """Inside the visual batch walk (stage 0): advance the IMU
        accumulators and the current time for this committed frame."""
        t = getattr(self, "_frame_times", {}).get(frame_id)
        if t is not None:
            self._accumulate_interval(t)
            self._cur_time = t
            self.frames_total += 1

    # -- keyframe bookkeeping ------------------------------------------
    def _on_inertial_keyframe(self, slot, t):
        """Record the temporal chain segment ending at this new keyframe."""
        if self.kf_order:
            a, w, d = self.since_kf
            self.kf_segments.append((a.copy(), w.copy(), d.copy()))
            acc, gyr, dts = _pad(a, w, d, _KF_PAD)
            self.seg_preints.append(
                integrate_measurements(self.bias, acc, gyr, dts, self.calib)
            )
            self.seg_ok.append(True)
        self.kf_order.append(slot)
        self.kf_times.append(t)
        self.since_kf = (np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,)))
        self.ki = IMAP.KFInertial(
            vel=self.ki.vel.at[slot].set(self.cur_vel),
            bg=self.ki.bg.at[slot].set(self.bias.bg),
            ba=self.ki.ba.at[slot].set(self.bias.ba),
        )

    def _reintegrate_segments(self):
        """Re-scan every chain segment with the current bias
        (reference ``Preintegrated::Reintegrate``)."""
        self.seg_preints = [
            integrate_measurements(
                self.bias, *_pad(a, w, d, _KF_PAD), self.calib
            )
            for (a, w, d) in self.kf_segments
        ]

    # -- inertial keyframe culling + slot recycling --------------------
    def _splice_chain(self, kf_valid):
        """Drop culled keyframes from the temporal chain, merging their raw
        IMU segments (reference ``Preintegrated::MergePrevious``).  Called
        from every ``_refill_free_slots`` so ANY cull — the chain-aware one
        below or the visual device-side cull of the stage-0 path — keeps
        the chain consistent before a slot can be recycled."""
        kf_valid = np.asarray(kf_valid)
        changed = False
        k = len(self.kf_order) - 1
        while k >= 0:
            if kf_valid[self.kf_order[k]]:
                k -= 1
                continue
            changed = True
            n = len(self.kf_order)
            if k == 0:
                del self.kf_order[0], self.kf_times[0]
                if self.kf_segments:
                    del self.kf_segments[0]
                    del self.seg_preints[0], self.seg_ok[0]
            elif k == n - 1:
                del self.kf_order[-1], self.kf_times[-1]
                del self.kf_segments[-1]
                del self.seg_preints[-1], self.seg_ok[-1]
            else:
                a0, w0, d0 = self.kf_segments[k - 1]
                a1, w1, d1 = self.kf_segments[k]
                merged = (
                    np.concatenate([a0, a1]), np.concatenate([w0, w1]),
                    np.concatenate([d0, d1]),
                )
                self.kf_segments[k - 1] = merged
                self.seg_preints[k - 1] = integrate_measurements(
                    self.bias, *_pad(*merged, _KF_PAD), self.calib
                )
                self.seg_ok[k - 1] = self.seg_ok[k - 1] and self.seg_ok[k]
                del self.kf_segments[k], self.seg_preints[k], self.seg_ok[k]
                del self.kf_order[k], self.kf_times[k]
            k -= 1
        return changed

    def _refill_free_slots(self, kf_valid):
        MonoSLAM._refill_free_slots(self, kf_valid)
        self._splice_chain(kf_valid)

    def _cull_inertial_kfs(self):
        """KeyFrameCulling on the temporal chain (reference
        `src/LocalMapping.cc:982-1010`): redundancy ratio 0.5 for
        stereo-inertial / 0.9 mono-inertial, with the temporal guard that a
        culled keyframe's neighbours must stay < 3 s apart (the merged
        preintegration segment must remain short enough to be useful —
        ``Preintegrated::MergePrevious``).

        Runs one device cull dispatch + one kf_valid pull, then splices the
        host chain and returns the slots to the recycle list.
        """
        n = len(self.kf_order)
        if n < 8:
            return
        KF = self.cfg.max_keyframes
        cand = np.zeros(KF, bool)
        # chain candidates: never the origin or the last two (tracking
        # anchors); temporal guard on the would-be merged segment
        for k in range(1, n - 2):
            if self.kf_times[k + 1] - self.kf_times[k - 1] < 3.0:
                cand[self.kf_order[k]] = True
        if not cand.any():
            return
        ratio = 0.5 if (self.FIX_SCALE and self.cfg.bf > 0) else 0.9
        protect = jnp.asarray(~cand)
        self.m = MS.cull_keyframes(
            self.m, jnp.asarray(cand), protect, ratio=ratio
        )
        kf_valid = np.asarray(jax.device_get(self.m.kf_valid))
        self._refill_free_slots(kf_valid)  # splices the chain too
        db = self._reloc_database()
        if db is not None:
            for s in np.flatnonzero(db.present & ~kf_valid):
                db.erase(int(s))

    def _can_insert_kf(self) -> bool:
        """Capacity logic: at capacity with no recyclable slot, run the
        chain-aware cull (NOT the visual one — a visual cull would drop
        keyframes without merging their IMU segments)."""
        if self.n_kf < self.cfg.max_keyframes or self.free_kf_slots:
            return True
        if not self.kf_order:
            return MonoSLAM._can_insert_kf(self)
        if self._refill_cooldown <= 0:
            self._refill_cooldown = 4
            self._cull_inertial_kfs()
            return bool(self.free_kf_slots)
        self._refill_cooldown -= 1
        return False

    # -- IMU initialization stages -------------------------------------
    def _try_imu_init(self, t):
        from orb_slam3_noted_tpu.utils.timing import GLOBAL_TIMER

        with GLOBAL_TIMER.stage("imu_init_check"):
            return self._try_imu_init_timed(t)

    def _try_imu_init_timed(self, t):
        cfg = self.cfg
        stage_times = [
            cfg.imu_init_time, cfg.imu_viba1_time, cfg.imu_viba2_time
        ]
        if self.imu_stage >= 3 or len(self.kf_order) < cfg.imu_init_min_kfs:
            return
        elapsed = t - self.kf_times[0]
        if elapsed < stage_times[self.imu_stage]:
            return
        # the stage-0 visual mapper culls keyframes on device; drop any
        # culled slot from the chain (merging its IMU segments) before the
        # FIRST init solve consumes stale poses.  Later stages run on the
        # inertial path whose culls splice explicitly — skip the ~30 ms
        # kf_valid round trip there (round-5 bench: 8 attempts x 30 ms)
        if self.imu_stage == 0:
            self._splice_chain(jax.device_get(self.m.kf_valid))
            if len(self.kf_order) < cfg.imu_init_min_kfs:
                return
        priors = [(1e2, 1e10 if self.FIX_SCALE is False else 1e5),
                  (1.0, 1e5), (0.0, 0.0)]
        prior_g, prior_a = priors[self.imu_stage]
        slots = np.asarray(self.kf_order, np.int32)
        K = len(slots)
        # pad the chain to the next power of two (masked-off segments):
        # every distinct KF count would otherwise be a fresh compile of the
        # init solver — several seconds per attempt on the remote compiler
        Kpad = 4
        while Kpad < K:
            Kpad *= 2
        slots_p = np.concatenate([slots, np.full(Kpad - K, slots[-1],
                                                 np.int32)])
        Rcw = self.m.kf_Rcw[jnp.asarray(slots_p)]
        tcw = self.m.kf_tcw[jnp.asarray(slots_p)]
        Rwb, twb = body_from_cam(Rcw, tcw, self.calib)
        dummy = init_preintegrated(self.bias)
        pre_list = list(self.seg_preints) + [dummy] * (Kpad - K)
        pre = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *pre_list)
        seg_ok = np.zeros(Kpad - 1, bool)
        seg_ok[: K - 1] = self.seg_ok
        from orb_slam3_noted_tpu.utils.timing import GLOBAL_TIMER as _T

        with _T.stage("ii_solve"):
            res = inertial_init(
                Rwb, twb, pre, jnp.asarray(seg_ok),
                prior_g=prior_g, prior_a=max(prior_a, 1e-6),
                n_iters=30, fix_scale=self.FIX_SCALE,
            )
            s = float(res.scale)
        if not np.isfinite(s) or s < 1e-2 or s > 1e3:
            return
        if self.imu_stage == 0 and not self.FIX_SCALE:
            # observability gate: with a smooth (weakly excited) window the
            # scale is absorbed by a constant velocity offset and the
            # estimate is meaningless — postpone until the marginal
            # uncertainty of log-scale tightens rather than warping the map
            sig = float(res.scale_sigma)
            if not np.isfinite(sig) or sig > 0.2:
                return
        if self.imu_stage == 0:
            # gravity-align + rescale the whole map (Map::ApplyScaledRotation)
            Rwg = so3.exp(jnp.concatenate([res.gdir, jnp.zeros(1)]))
            Ryw = Rwg.T.astype(jnp.float32)
            sj = jnp.asarray(s, jnp.float32)
            self.m = MS.apply_scaled_rotation_map(self.m, Ryw, sj)
            vel_new = s * jnp.einsum("ij,kj->ki", Ryw, res.velocities[:K])
            self.last_Rcw = self.last_Rcw @ Ryw.T
            self.last_tcw = self.last_tcw * sj
            self.vel = None
        else:
            vel_new = res.velocities[:K]  # already metric; scale ~ 1
        sl = jnp.asarray(slots)
        self.ki = IMAP.KFInertial(
            vel=self.ki.vel.at[sl].set(vel_new.astype(jnp.float32)),
            bg=self.ki.bg.at[sl].set(
                jnp.broadcast_to(res.bg, (len(slots), 3)).astype(jnp.float32)),
            ba=self.ki.ba.at[sl].set(
                jnp.broadcast_to(res.ba, (len(slots), 3)).astype(jnp.float32)),
        )
        self.bias = Bias(res.bg.astype(jnp.float32), res.ba.astype(jnp.float32))
        with _T.stage("ii_reintegrate"):
            self._reintegrate_segments()
            self.cur_vel = self.ki.vel[int(slots[-1])]
        # FullInertialBA over the whole chain with the stage's bias priors
        # (the reference runs it to convergence, its=100-200:
        # `src/Optimizer.cc:391`); the long schedule is only needed when a
        # big scale correction just warped the map (mono) — stereo enters
        # with metric scale and converges in half the iterations
        self._chain_ba(window=None, bias_prior_g=float(prior_g),
                       bias_prior_a=float(min(prior_a, 1e5)),
                       n_iters=8 if self.FIX_SCALE else 16)
        self.imu_stage += 1

    # -- inertial local mapping ----------------------------------------
    def _chain_ba(self, window=None, bias_prior_g=0.0, bias_prior_a=0.0,
                  n_iters=4):
        from orb_slam3_noted_tpu.utils.timing import GLOBAL_TIMER

        with GLOBAL_TIMER.stage("chain_ba"):
            return self._chain_ba_timed(window, bias_prior_g, bias_prior_a,
                                        n_iters)

    def _chain_ba_timed(self, window=None, bias_prior_g=0.0,
                        bias_prior_a=0.0, n_iters=4):
        cfg = self.cfg
        n = len(self.kf_order)
        if n < 2:
            return
        if window is None:
            # full chain (FullInertialBA), capped to bound the Schur size;
            # pad to the next power of two to bound recompiles
            W = min(n - 1, 63)
            Wpad = 1
            while Wpad < W:
                Wpad *= 2
        else:
            W = min(window, n - 1)
            Wpad = cfg.inertial_window
        Wpad = max(Wpad, W)
        slots = self.kf_order[-(W + 1):]
        pres = self.seg_preints[-W:]
        K = Wpad + 1
        kf_slots = np.full(K, slots[0], np.int32)
        kf_mask = np.zeros(K, bool)
        kf_slots[:len(slots)] = slots
        kf_mask[:len(slots)] = True
        dummy = init_preintegrated(self.bias)
        pre_list = pres + [dummy] * (K - 1 - len(pres))
        preints = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *pre_list)
        seg_valid = np.zeros(K - 1, bool)
        seg_valid[:len(pres)] = self.seg_ok[-W:]
        self.m, self.ki = IMAP.chain_inertial_ba(
            self.m, self.ki,
            jnp.asarray(kf_slots), jnp.asarray(kf_mask),
            preints, jnp.asarray(seg_valid),
            self.cam, self.calib, cfg, bf=cfg.bf, n_iters=n_iters,
            bias_prior_g=bias_prior_g, bias_prior_a=bias_prior_a,
        )

    # -- per-frame inertial tracking (after IMU init) -------------------
    def _track_inertial(self, feats, frame_id, feat_uvr=None, feat_uv2=None):
        cfg = self.cfg
        anchor_slot = self.kf_order[-1]
        anchor_Rcw = self.m.kf_Rcw[anchor_slot]
        anchor_tcw = self.m.kf_tcw[anchor_slot]
        aRwb, atwb = body_from_cam(anchor_Rcw, anchor_tcw, self.calib)
        anchor = VIState(
            Rwb=aRwb, twb=atwb, vel=self.ki.vel[anchor_slot],
            bg=self.ki.bg[anchor_slot], ba=self.ki.ba[anchor_slot],
        )
        pre = self._preint_since_kf()
        bias = Bias(anchor.bg, anchor.ba)
        Rp, tp, vp = predict_state(anchor.Rwb, anchor.twb, anchor.vel, pre, bias)
        frame0 = VIState(Rwb=Rp, twb=tp, vel=vp, bg=anchor.bg, ba=anchor.ba)
        Rcw_p, tcw_p = cam_from_body(
            jax.tree_util.tree_map(lambda x: x[None], frame0), self.calib
        )
        Rcw_p, tcw_p = Rcw_p[0], tcw_p[0]
        mp_mask, _ = MS.local_map_mask(
            self.m, jnp.int32(anchor_slot), n_neighbors=cfg.local_window
        )
        obs, f_idx, vis = T.match_local_map(
            self.m, feats, Rcw_p, tcw_p, mp_mask, self.cam, cfg,
            feat_uvr=feat_uvr, feat_uv2=feat_uv2,
        )
        # compact to the matched set (<= NF rows) — the optimizer's cost is
        # linear in observation rows; see vi_track_batch
        NF = feats.xy.shape[0]
        MP = self.m.mp_pos.shape[0]
        sel = jnp.argsort(~obs.valid)[:NF]
        obs_c = jax.tree_util.tree_map(lambda x: x[sel], obs)
        cam2, Rrl, trl = T._second_camera(cfg)
        res = vi_pose_optimization(
            self.cam, self.calib, anchor, frame0, pre,
            self.m.mp_pos[sel], obs_c, bf=cfg.bf,
            cam2=cam2, Rrl=Rrl, trl=trl,
        )
        st1 = VIState(Rwb=res.Rwb[None], twb=res.twb[None],
                      vel=res.vel[None], bg=res.bg[None], ba=res.ba[None])
        Rcw, tcw = cam_from_body(st1, self.calib)
        Rcw, tcw = Rcw[0], tcw[0]
        self.cur_vel = res.vel
        n_inl = int(res.n_inliers)
        # invert matching for keyframe binding
        keep_c = obs_c.valid & res.inliers
        tgt = jnp.where(keep_c, f_idx[sel], NF)
        mp_of_feat = jnp.full((NF + 1,), -1, jnp.int32).at[tgt].set(sel)[:NF]
        keep = jnp.zeros(MP, bool).at[sel].max(keep_c)
        self._mp_remap = None  # fresh bindings vs current map
        self.m = self.m._replace(
            mp_visible=self.m.mp_visible + vis.astype(jnp.int32),
            mp_found=self.m.mp_found + keep.astype(jnp.int32),
        )
        return Rcw, tcw, n_inl, mp_of_feat, (Rcw_p, tcw_p)


from functools import partial as _partial

# padded IMU sample count per anchor->frame interval in batch mode: at
# 200 Hz this covers ~2.5 s since the last keyframe — inertial keyframes
# come every <=0.5 s, plus up to a full batch of frames mid-walk
_BATCH_PAD = 512


@_partial(jax.jit, static_argnames=("cam", "cfg", "bf"))
def vi_track_batch(
    m,
    feats_all,              # FrameFeatures with leading (B,) dim
    uvr_all,                # (B, NF) right-x per feature (-1 invalid)
    anchor_slot,            # int32 — last keyframe slot (shared anchor)
    anchor_vel,             # (3,) anchor body velocity
    anchor_bg, anchor_ba,   # (3,) anchor biases
    acc, gyr, dts,          # (B, PAD, 3)/(B, PAD) resampled anchor->frame_j
    calib,
    cam, cfg, bf,
    count_mask,             # (B,) frames allowed to bump visible/found
    uv2_all=None,           # (B, NF, 2) right-camera pixels (fisheye) or None
):
    """Visual-inertial tracking of a whole frame batch in ONE dispatch.

    The inertial analogue of :func:`tracking.stereo_track_batch` (round-4:
    the BASELINE gate config is stereo-inertial and had no throughput mode).
    Unlike visual batch tracking there is NO sequential dependency between
    frames: each frame's pose prediction comes from the shared anchor
    keyframe via its own preintegrated IMU span (reference
    ``Tracking::PredictStateIMU``, `src/Tracking.cc:1498`), so the whole
    batch is vmapped — preintegration scan, projection matching, and
    ``PoseInertialOptimizationLastKeyFrame`` all run B-wide.

    Returns (m, Rcw (B,3,3), tcw (B,3), n_inls (B,), mp_feats (B,NF),
    vels (B,3) body velocities).
    """
    anchor_Rcw = m.kf_Rcw[anchor_slot]
    anchor_tcw = m.kf_tcw[anchor_slot]
    aRwb, atwb = body_from_cam(anchor_Rcw, anchor_tcw, calib)
    anchor = VIState(Rwb=aRwb, twb=atwb, vel=anchor_vel,
                     bg=anchor_bg, ba=anchor_ba)
    bias = Bias(anchor_bg, anchor_ba)
    mp_mask, _ = MS.local_map_mask(
        m, anchor_slot, n_neighbors=cfg.local_window
    )
    NF = feats_all.xy.shape[1]
    MP = m.mp_pos.shape[0]

    # compact the local map to a bounded row set BEFORE matching: the
    # (MP x NF) projection-search masks are memory-bound at full 16k-point
    # capacity (pure temporary traffic);
    # the local window holds ~2-3k live points, so a 4096-row view does
    # the same association at 1/4 the bandwidth
    MPC = min(4096, MP)
    from orb_slam3_noted_tpu.utils.timing import report_saturation

    report_saturation(
        "vi_local_map_rows",
        jnp.maximum(jnp.sum(mp_mask.astype(jnp.int32)) - MPC, 0),
    )
    sel_mp = jnp.argsort(~mp_mask)[:MPC]
    mask_c = mp_mask[sel_mp]
    m_sub = m._replace(
        mp_pos=m.mp_pos[sel_mp], mp_desc=m.mp_desc[sel_mp],
        mp_normal=m.mp_normal[sel_mp], mp_dmin=m.mp_dmin[sel_mp],
        mp_dmax=m.mp_dmax[sel_mp], mp_valid=m.mp_valid[sel_mp],
        mp_ref_kf=m.mp_ref_kf[sel_mp], mp_nobs=m.mp_nobs[sel_mp],
        mp_visible=m.mp_visible[sel_mp], mp_found=m.mp_found[sel_mp],
    )

    cam2, Rrl, trl = T._second_camera(cfg)

    def one(feats, uvr, uv2, a, w, d):
        pre = integrate_measurements(bias, a, w, d, calib)
        Rp, tp, vp = predict_state(anchor.Rwb, anchor.twb, anchor.vel,
                                   pre, bias)
        frame0 = VIState(Rwb=Rp, twb=tp, vel=vp, bg=anchor.bg, ba=anchor.ba)
        Rcw_p, tcw_p = cam_from_body(
            jax.tree_util.tree_map(lambda x: x[None], frame0), calib
        )
        obs, f_idx, vis = T.match_local_map(
            m_sub, feats, Rcw_p[0], tcw_p[0], mask_c, cam, cfg, feat_uvr=uvr,
            feat_uv2=uv2,
        )
        # compact the (MPC,)-indexed observation table to the matched set
        # (bounded by NF distinct features): the VI pose optimizer's cost
        # is linear in its observation rows, and running it over the full
        # 16k-point table was 8x wasted work (round-4 profile: 43 ms/frame)
        sel = jnp.argsort(~obs.valid)[:NF]
        obs_c = jax.tree_util.tree_map(
            lambda x: x[sel] if x is not None else None, obs
        )
        res = vi_pose_optimization(
            cam, calib, anchor, frame0, pre, m_sub.mp_pos[sel], obs_c, bf=bf,
            cam2=cam2, Rrl=Rrl, trl=trl,
        )
        st1 = VIState(Rwb=res.Rwb[None], twb=res.twb[None],
                      vel=res.vel[None], bg=res.bg[None], ba=res.ba[None])
        Rcw, tcw = cam_from_body(st1, calib)
        keep_c = obs_c.valid & res.inliers               # (NF,) on sel rows
        tgt = jnp.where(keep_c, f_idx[sel], NF)
        # feature bindings carry GLOBAL point ids (sel indexes the view)
        mp_of_feat = jnp.full((NF + 1,), -1, jnp.int32).at[tgt].set(
            sel_mp[sel].astype(jnp.int32)
        )[:NF]
        keep = jnp.zeros(MPC, bool).at[sel].max(keep_c)
        return (Rcw[0], tcw[0], res.n_inliers, mp_of_feat, res.vel,
                vis, keep)

    if uv2_all is None:
        one_fn = lambda f, u, a, w, d: one(f, u, None, a, w, d)
        Rs, ts, n_inls, mp_feats, vels, vis_all, keep_all = jax.vmap(one_fn)(
            feats_all, uvr_all, acc, gyr, dts
        )
    else:
        Rs, ts, n_inls, mp_feats, vels, vis_all, keep_all = jax.vmap(one)(
            feats_all, uvr_all, uv2_all, acc, gyr, dts
        )
    cmf = count_mask[:, None]
    # vis/found counters come back on the compacted rows: scatter the
    # per-batch sums to the global tables through sel_mp
    m = m._replace(
        mp_visible=m.mp_visible.at[sel_mp].add(
            jnp.sum(vis_all & cmf, axis=0).astype(jnp.int32)
        ),
        mp_found=m.mp_found.at[sel_mp].add(
            jnp.sum(keep_all & cmf, axis=0).astype(jnp.int32)
        ),
    )
    return m, Rs, ts, n_inls, mp_feats, vels


class MonoInertialSLAM(InertialMixin, MonoSLAM):
    """Monocular-inertial SLAM (reference ``System::IMU_MONOCULAR``)."""

    FIX_SCALE = False  # mono: scale is estimated by IMU init

    def __init__(self, cfg: SlamConfig):
        MonoSLAM.__init__(self, cfg)
        self._init_inertial(cfg)

    # process(img, t, acc, gyr, imu_t): batched IMU samples since last frame
    def process(self, img, frame_id, t=None, acc=None, gyr=None, imu_t=None):
        if self._pending_loops:
            self.flush()
        self._service_background()
        t = float(frame_id) / self.cfg.fps if t is None else float(t)
        self._check_timestamps(t)  # on a broken stream: reset, re-init below
        if acc is not None:
            self.feed_imu(acc, gyr, imu_t)
        self._accumulate_interval(t)
        self._cur_time = t
        self.frames_total += 1

        if self.state == NOT_INITIALIZED:
            feats = O.extract_orb(
                jnp.asarray(img, jnp.float32),
                n_features=self.cfg.n_features, n_levels=self.cfg.n_levels,
                scale_factor=self.cfg.scale_factor,
                th_high=self.cfg.ini_th_fast, th_low=self.cfg.min_th_fast,
            )
            n_kf_before = self.n_kf
            prev_ref = self.ref_frame_id
            self._try_initialize(feats, frame_id)
            if self.n_kf > n_kf_before:  # visual init created KF 0 and 1
                self._register_init_keyframes(t)
            elif self.ref_frame_id != prev_ref:
                # initializer reset its reference frame: the chain segment
                # must span exactly [ref, next] — restart accumulation
                self.since_kf = (
                    np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,))
                )
            return self.trajectory[-1] if self.trajectory else None

        feats = O.extract_orb(
            jnp.asarray(img, jnp.float32),
            n_features=self.cfg.n_features, n_levels=self.cfg.n_levels,
            scale_factor=self.cfg.scale_factor,
            th_high=self.cfg.ini_th_fast, th_low=self.cfg.min_th_fast,
        )
        if self.imu_stage == 0:
            # vision-only tracking while accumulating the chain
            self._track(feats, frame_id)
        else:
            Rcw, tcw, n_inl, mp_of_feat, pred = self._track_inertial(
                feats, frame_id
            )
            if n_inl < self.cfg.min_tracked_points:
                # fall back to visual motion-model tracking (+reloc inside)
                # before declaring loss — right after IMU init the scale can
                # still be off enough that the IMU-predicted pose misses the
                # matching windows while visual tracking is fine
                self._track(feats, frame_id)
            else:
                self.state = OK
                self.frames_since_kf += 1
                self._record(frame_id, Rcw, tcw, n_inl)
                if self.keep_frame_overlay:
                    self._record_overlay(feats, mp_of_feat, frame_id)
                # full NeedNewKeyFrame policy (unified round-5: the override
                # below layers the inertial 0.5 s rule on the c1/c2 ladder)
                if self._need_new_kf(n_inl):
                    self._insert_keyframe(
                        feats, frame_id, Rcw, tcw, mp_of_feat, n_inl
                    )
        # keyframe hooks run inside _insert_keyframe (overridden below)
        self._try_imu_init(t)
        self._cur_time = t
        return self.trajectory[-1]

    def _register_init_keyframes(self, t):
        """After two-view init, register KF slots 0 and 1 on the chain."""
        # the accumulated since_kf samples span ref_frame -> current frame
        self.kf_order = [0]
        self.kf_times = [t - max(self.since_kf[2].sum(), 1e-3)]
        self.kf_segments = []
        self.seg_preints = []
        self._on_inertial_keyframe(1, t)

    def _need_new_kf(self, n_inl, tracked_close=None, nontracked_close=None):
        """Inertial sensors force a keyframe every 0.5 s regardless of the
        visual conditions (reference `src/Tracking.cc:2948` — the
        preintegration chain must stay short for the IMU factors)."""
        if MonoSLAM._need_new_kf(
            self, n_inl, tracked_close=tracked_close,
            nontracked_close=nontracked_close,
        ):
            return True
        t = getattr(self, "_cur_time", None)
        if (
            t is not None and self.kf_times
            and not self.localization_only
            and n_inl > 15
            and self._can_insert_kf()
            and t - self.kf_times[-1] >= 0.5
        ):
            return True
        return False

    def _insert_keyframe(self, feats, frame_id, Rcw, tcw, mp_of_feat, n_inl,
                         uvr=None, depth=None, xy_r=None):
        t = getattr(self, "_cur_time", None)
        if t is None:
            t = self.last_t if self.last_t is not None else 0.0
        if self.imu_stage == 0:
            # visual local mapping path
            MonoSLAM._insert_keyframe(
                self, feats, frame_id, Rcw, tcw, mp_of_feat, n_inl,
                uvr=uvr, depth=depth,
            )
            self._on_inertial_keyframe(self.last_kf_slot, t)
            return
        # inertial path: ONE fused mapper dispatch (insert -> depth points
        # -> triangulation over the top covisible neighbours, which include
        # the temporal prev-KF for any normal inertial cadence -> fuse ->
        # cull -> stats), then LocalInertialBA over the chain.  The old
        # host-sequenced form (covisibility pull + per-neighbour
        # triangulate dispatches) cost ~350 ms of round trips per keyframe.
        cfg = self.cfg
        slot = self._alloc_kf_slot()
        if slot is None:
            return  # at capacity with nothing recyclable
        self.kf_inserted += 1
        NF = cfg.n_features
        uvr_arr = uvr if uvr is not None else jnp.full((NF,), -1.0,
                                                       jnp.float32)
        depth_arr = depth if depth is not None else jnp.full(
            (NF,), -1.0, jnp.float32
        )
        if self._mp_remap is not None:
            mp_of_feat = MS.remap_point_bindings(mp_of_feat, self._mp_remap)
        if self._n_mp > 0.85 * cfg.max_map_points:
            # map-point free-list compaction (same protocol as the visual
            # path: drain in-flight GBA first, remap in-flight bindings)
            if self.loop_closer is not None:
                self.loop_closer.finish_gba(self)
            self.m, n_mp_dev, inv = MS.compact_map_points(self.m)
            self._n_mp_pending = n_mp_dev
            mp_of_feat = MS.remap_point_bindings(mp_of_feat, inv)
            self._mp_remap = inv if self._mp_remap is None else (
                MS.compose_point_remaps(self._mp_remap, inv)
            )
        with TIMER.stage("insert_keyframe"):
            self.m, n_mp = T.insert_keyframe_step(
                self.m, jnp.int32(slot), Rcw, tcw, jnp.int32(frame_id),
                feats, mp_of_feat, uvr_arr, depth_arr,
                self._n_mp_for_device(), self.cam, cfg,
                n_neighbors=cfg.triangulate_neighbors, bf=cfg.bf,
                has_depth=depth is not None, xy_r=xy_r, visual_ba=False,
            )
            self._n_mp_pending = n_mp
        self.kf_frame_ids[slot] = int(frame_id)
        self.last_kf_slot = slot
        self.frames_since_kf = 0
        self.tracked_at_kf = max(n_inl, 1)
        self._on_inertial_keyframe(slot, t)
        self._chain_ba(window=self.cfg.inertial_window)
        self.bias = Bias(self.ki.bg[slot], self.ki.ba[slot])
        self.cur_vel = self.ki.vel[slot]
        # full back end on the inertial path (round-5; reference pushes
        # EVERY keyframe to LoopClosing regardless of sensor,
        # `src/LocalMapping.cc:262`, and culls every mapper pass):
        # KeyFrameCulling + slot recycling every few inserts (amortizes the
        # kf_valid pull), loop detection once VIBA1 has refined the map
        # (reference guard in ``NewDetectCommonRegions``), reloc-DB
        # registration always.
        if self.kf_inserted % 4 == 0:
            self._cull_inertial_kfs()
        if cfg.enable_loop_closing:
            # stage >= 2 == VIBA1 done (the reference's detection guard)
            if self.imu_stage >= 2:
                self._maybe_close_loop(slot, feats)
            else:
                self._register_loop_db_kf(slot, feats)
        else:
            self._register_reloc_kf(slot)
        self._check_bad_imu()

    def _register_loop_db_kf(self, slot, feats):
        """Add the keyframe to the loop closer's BoW database WITHOUT
        querying for loops — the reference's pre-VIBA1 guard skips
        detection but keyframes still enter the database
        (`src/LoopClosing.cc:316-355`)."""
        self._maybe_build_loop_closer(feats)
        if self.loop_closer is None:
            return
        m = self.m
        _, bow = self.loop_closer.db.compute_bow(
            m.kf_desc[slot], m.kf_feat_valid[slot]
        )
        self.loop_closer.db.add(slot, bow)


class StereoInertialSLAM(MonoInertialSLAM):
    """Stereo-inertial SLAM (reference ``System::IMU_STEREO``).

    Metric scale comes from stereo; IMU init runs with scale fixed
    (`src/LocalMapping.cc:1369` ``bFixedVel=false, priorA`` stereo path).
    """

    FIX_SCALE = True
    MIN_INIT_POINTS = 300

    def process(self, img_left, img_right, frame_id,
                t=None, acc=None, gyr=None, imu_t=None):
        from orb_slam3_noted_tpu.utils.timing import GLOBAL_TIMER

        with GLOBAL_TIMER.stage("vi_frame"):
            return self._process_timed(img_left, img_right, frame_id,
                                       t, acc, gyr, imu_t)

    def _process_timed(self, img_left, img_right, frame_id,
                       t=None, acc=None, gyr=None, imu_t=None):
        from orb_slam3_noted_tpu.ops import image as I
        from orb_slam3_noted_tpu.ops.stereo import match_stereo

        if self._pending_loops:
            self.flush()
        self._service_background()
        t = float(frame_id) / self.cfg.fps if t is None else float(t)
        self._check_timestamps(t)  # on a broken stream: reset, re-init below
        if acc is not None:
            self.feed_imu(acc, gyr, imu_t)
        self._accumulate_interval(t)
        self._cur_time = t
        self.frames_total += 1
        cfg = self.cfg

        iml = jnp.asarray(img_left, jnp.float32)
        imr = jnp.asarray(img_right, jnp.float32)
        kw = dict(
            n_features=cfg.n_features, n_levels=cfg.n_levels,
            scale_factor=cfg.scale_factor,
            th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast,
        )
        feats = O.extract_orb(iml, **kw)
        feats_r = O.extract_orb(imr, **kw)
        pyr_l = tuple(I.build_pyramid(iml, cfg.n_levels, cfg.scale_factor))
        pyr_r = tuple(I.build_pyramid(imr, cfg.n_levels, cfg.scale_factor))
        baseline = cfg.bf / self.cam.fx
        sm = match_stereo(
            feats, feats_r, pyr_l, pyr_r, bf=cfg.bf, baseline=baseline,
            n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
        )
        uvr = jnp.where(sm.valid, sm.u_right, -1.0)
        depth = jnp.where(sm.valid, sm.depth, -1.0)

        if self.state == NOT_INITIALIZED:
            StereoSLAM._stereo_initialize(self, feats, frame_id, uvr, depth)
            if self.state == OK:
                self.kf_order = [0]
                self.kf_times = [t]
                self.kf_segments = []
                self.seg_preints = []
                self.since_kf = (
                    np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,))
                )
            self._cur_time = t
            return self.trajectory[-1] if self.trajectory else None

        if self.imu_stage == 0:
            self._track(feats, frame_id, uvr=uvr, depth=depth)
        else:
            Rcw, tcw, n_inl, mp_of_feat, pred = self._track_inertial(
                feats, frame_id, feat_uvr=uvr
            )
            if n_inl < cfg.min_tracked_points:
                # visual motion-model fallback (see MonoInertialSLAM.process)
                self._track(feats, frame_id, uvr=uvr, depth=depth)
            else:
                self.state = OK
                self.frames_since_kf += 1
                self._record(frame_id, Rcw, tcw, n_inl)
                if self.keep_frame_overlay:
                    self._record_overlay(feats, mp_of_feat, frame_id)
                # full NeedNewKeyFrame with the stereo close-point trigger
                # (unified round-5; reference `src/Tracking.cc:2962-2992`)
                close_th = (cfg.bf / self.cam.fx) * cfg.th_depth
                close = (depth > 0) & (depth < close_th)
                tc, ntc = jax.device_get((
                    jnp.sum((mp_of_feat >= 0) & close),
                    jnp.sum((mp_of_feat < 0) & close),
                ))
                if self._need_new_kf(n_inl, tracked_close=int(tc),
                                     nontracked_close=int(ntc)):
                    self._insert_keyframe(
                        feats, frame_id, Rcw, tcw, mp_of_feat, n_inl,
                        uvr=uvr, depth=depth,
                    )
        self._try_imu_init(t)
        self._cur_time = t
        return self.trajectory[-1]

    def _process_one(self, frame, frame_id):
        """Init/fallback per-frame path inside the visual batch machinery:
        route through the inertial process so timestamps and IMU
        accumulation stay correct."""
        t = getattr(self, "_frame_times", {}).get(frame_id)
        self.process(frame[0], frame[1], frame_id, t=t)

    def _init_consume(self, imgs, frame_ids):
        # stereo init is single-frame (depth-backed); StereoInertialSLAM
        # does not inherit StereoSLAM, so mirror its override here (the
        # mono batched two-view init would otherwise be picked up)
        self._process_one(imgs[0], frame_ids[0])
        return 1

    def _batch_track(self, prep, vel, cm):
        return StereoSLAM._batch_track(self, prep, vel, cm)

    def _batch_retrack(self, rolled, aux_rolled, vel, cm):
        return StereoSLAM._batch_retrack(self, rolled, aux_rolled, vel, cm)

    def _prep_batch(self, frames, n_pad):
        return StereoSLAM._prep_batch(self, frames, n_pad)

    # ------------------------------------------------------------------
    # throughput mode (round-4: the BASELINE gate config is stereo-inertial
    # and previously had no batched path at all)
    def process_batch(self, imgs, frame_ids, ts=None,
                      acc=None, gyr=None, imu_t=None):
        """Track a batch of (left, right) frame pairs per device dispatch.

        Per-frame until the IMU is initialized (the visual accumulation
        phase is short and bounded — reference ``InitializeIMU`` fires at
        ~2 s); afterwards the whole batch runs through ONE batched stereo
        frontend dispatch + ONE vmapped visual-inertial tracking dispatch
        (:func:`vi_track_batch`), with the host walking per-frame outcomes
        and re-dispatching the remainder after a mid-batch keyframe.
        """
        from orb_slam3_noted_tpu.utils.timing import GLOBAL_TIMER as TIMER

        cfg = self.cfg
        if acc is not None:
            self.feed_imu(acc, gyr, imu_t)
        if ts is None:
            ts = [float(f) / cfg.fps for f in frame_ids]
        i = 0
        n = len(imgs)
        if self.state == NOT_INITIALIZED or self.imu_stage == 0:
            # visual accumulation phase: run the BATCHED visual stereo walk
            # (one frontend dispatch + scan tracking); per-frame time/IMU
            # bookkeeping rides the `_on_batch_frame` hook, keyframes land
            # on the inertial chain via the stage-0 `_insert_keyframe`
            # override, and the staged IMU init is checked at the batch
            # boundary (the <=0.8 s check delay is immaterial against the
            # reference's ~2 s init schedule)
            self._frame_times = dict(zip(frame_ids, ts))
            StereoSLAM.process_batch(self, imgs, frame_ids)
            self._cur_time = ts[-1]
            self._try_imu_init(ts[-1])
            return self.trajectory[-1] if self.trajectory else None
        if i >= n:
            return self.trajectory[-1] if self.trajectory else None

        B = n - i
        ids = list(frame_ids[i:])
        tss = list(ts[i:])
        prepL, prepR = StereoSLAM._prep_batch(self, imgs[i:], 0)
        with TIMER.stage("vi_frontend_batch"):
            feats_all, uvr_all, depth_all = T.stereo_frontend_batch(
                prepL, prepR, self.cam, cfg, bf=cfg.bf
            )
        # drain queued loop detections AFTER dispatching the frontend: the
        # drain's device pull only waits for the PREVIOUS batch's tail
        # (in-order queue), so the host walks loop decisions while this
        # batch's extraction computes — the ~130 ms/batch drain cost of
        # the round-5 stage table rides under the frontend.  Extraction
        # does not read the map, so a rare loop correction applied here is
        # still fully visible to the tracking dispatch below.
        if self._pending_loops:
            self.flush()
        self._service_background()
        tree = jax.tree_util.tree_map
        pos = 0
        while pos < B:
            if self.state == NOT_INITIALIZED or self.imu_stage == 0:
                # a mid-walk reset (bad IMU / timestamp jump) dropped the
                # inertial chain: finish the batch per-frame
                for j in range(pos, B):
                    self.process(imgs[i + j][0], imgs[i + j][1], ids[j],
                                 t=tss[j])
                pos = B
                break
            anchor_slot = self.kf_order[-1]
            t_kf = self.kf_times[-1]
            # per-frame resampled IMU spans anchor -> frame_j, rolled so the
            # next uncommitted frame leads (static shapes across dispatches)
            accs = np.zeros((B, _BATCH_PAD, 3), np.float32)
            gyrs = np.zeros((B, _BATCH_PAD, 3), np.float32)
            dtss = np.zeros((B, _BATCH_PAD), np.float32)
            for k in range(B - pos):
                a, w, d = self.imu.interval(t_kf, tss[pos + k])
                mlen = min(len(d), _BATCH_PAD)
                accs[k, :mlen] = a[:mlen]
                gyrs[k, :mlen] = w[:mlen]
                dtss[k, :mlen] = d[:mlen]
            if pos:
                feats_cur = tree(lambda x: jnp.roll(x, -pos, axis=0), feats_all)
                uvr_cur = jnp.roll(uvr_all, -pos, axis=0)
                depth_cur = jnp.roll(depth_all, -pos, axis=0)
            else:
                feats_cur, uvr_cur, depth_cur = feats_all, uvr_all, depth_all
            cm = jnp.arange(B) < (B - pos)
            with TIMER.stage("vi_track_batch"):
                self.m, Rs, ts_d, n_inls, mp_feats, vels = vi_track_batch(
                    self.m, feats_cur, uvr_cur, jnp.int32(anchor_slot),
                    self.ki.vel[anchor_slot], self.ki.bg[anchor_slot],
                    self.ki.ba[anchor_slot],
                    jnp.asarray(accs), jnp.asarray(gyrs), jnp.asarray(dtss),
                    self.calib, self.cam, cfg, bf=cfg.bf, count_mask=cm,
                )
                self._mp_remap = None  # fresh bindings vs current map
                close_th = (cfg.bf / self.cam.fx) * cfg.th_depth
                close = (depth_cur > 0) & (depth_cur < close_th)
                tc_d = jnp.sum((mp_feats >= 0) & close, axis=1)
                ntc_d = jnp.sum((mp_feats < 0) & close, axis=1)
                n_np, Rs_np, ts_np, tc_np, ntc_np = jax.device_get(
                    (n_inls, Rs, ts_d, tc_d, ntc_d)
                )

            k_kf = None
            inserted_this_dispatch = False
            for k in range(B - pos):
                j = pos + k
                t_j = tss[j]
                self._cur_time = t_j
                nk = int(n_np[k])
                ok = nk >= cfg.min_tracked_points
                self._update_lost_state(ok)
                self.frames_since_kf += 1
                self._record(ids[j], Rs_np[k], ts_np[k], nk)
                if ok:
                    self.state = OK
                    self.cur_vel = vels[k]
                need = ok and self._need_new_kf(
                    nk, tracked_close=int(tc_np[k]),
                    nontracked_close=int(ntc_np[k]),
                )
                # after a mid-dispatch keyframe the remaining inlier counts
                # still reflect the PRE-keyframe anchor: the visual
                # low-inlier trigger would re-fire every frame and flood
                # the chain — only the inertial 0.5 s rule stays valid
                if (
                    need and inserted_this_dispatch
                    and self.kf_times and t_j - self.kf_times[-1] < 0.45
                ):
                    need = False
                if need:
                    # the chain segment must span anchor -> this frame
                    self.since_kf = self.imu.interval(t_kf, t_j)
                    self.last_t = t_j
                    feats_k = tree(lambda x: x[k], feats_cur)
                    self._insert_keyframe(
                        feats_k, ids[j], Rs[k], ts_d[k], mp_feats[k], nk,
                        uvr=uvr_cur[k], depth=depth_cur[k],
                    )
                    inserted_this_dispatch = True
                    self._try_imu_init(t_j)
                    # the remaining frames' results (computed against the
                    # pre-KF anchor) stay valid — IMU prediction spans just
                    # grow by <1 batch; re-dispatching halved throughput.
                    # cfg.retrack_after_kf opts back into the re-dispatch.
                    if cfg.retrack_after_kf and j + 1 < B:
                        k_kf = j
                        break
            if k_kf is None:
                pos = B
            else:
                pos = k_kf + 1
        # leave the incremental accumulators consistent for any subsequent
        # per-frame processing
        if self.kf_times:
            self.since_kf = self.imu.interval(self.kf_times[-1], tss[-1])
        self.last_t = tss[-1]
        self._cur_time = tss[-1]
        return self.trajectory[-1]


class FisheyeStereoInertialSLAM(StereoInertialSLAM):
    """Non-rectified Kannala-Brandt stereo + IMU — the TUM-VI gate config.

    The reference's ``IMU_STEREO`` sensor with two ``KannalaBrandt8``
    cameras (`/root/reference/src/Tracking.cc:724-815` Camera2/Tlr parsing;
    `src/Frame.cc:1041-1140` fisheye stereo frame): descriptors match
    inside the lapping areas and triangulate directly with the known
    extrinsic Tlr (``KannalaBrandt8::TriangulateMatches``,
    `src/CameraModels/KannalaBrandt8.cpp:236`).  Matched right-camera
    pixels become full two-camera KB8 reprojection residuals carrying Tlr
    through VI pose optimization and the inertial chain BA (reference
    two-camera EdgeMono, `include/G2oTypes.h:339-489`); metric depth from
    the triangulation seeds map points, and — as in the rectified case —
    lets IMU init run with the scale fixed.

    Requires cfg.camera/camera2 (KB8), cfg.tlr_r/tlr_t, cfg.lapping_l/r;
    cfg.bf (baseline*fx) only scales the close-point threshold.
    """

    MIN_INIT_POINTS = 100  # the lapping overlap covers part of the frame

    def __init__(self, cfg: SlamConfig):
        super().__init__(cfg)
        assert cfg.camera2 is not None, "camera2 required for fisheye stereo"
        self.cam2 = cfg.camera2
        self.Rlr = jnp.asarray(
            np.asarray(cfg.tlr_r, np.float32).reshape(3, 3)
            if cfg.tlr_r else np.eye(3, dtype=np.float32)
        )
        self.tlr = jnp.asarray(cfg.tlr_t, jnp.float32)

    # ------------------------------------------------------------------
    def _fisheye_frontend(self, img_left, img_right):
        """Extract both cameras + lapping-area triangulating match.

        Returns (feats, depth (NF,), uv2 (NF, 2)) — depth in the LEFT
        camera frame, uv2 the matched right-camera pixel or -1.
        """
        from orb_slam3_noted_tpu.ops.fisheye_stereo import match_fisheye_stereo

        cfg = self.cfg
        iml = jnp.asarray(img_left, jnp.float32)
        imr = jnp.asarray(img_right, jnp.float32)
        kw = dict(
            n_features=cfg.n_features, n_levels=cfg.n_levels,
            scale_factor=cfg.scale_factor,
            th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast,
        )
        feats = O.extract_orb(iml, **kw)
        feats_r = O.extract_orb(imr, **kw)
        sm = match_fisheye_stereo(
            feats, feats_r, self.cam, self.cam2, self.Rlr, self.tlr,
            lap_l=tuple(cfg.lapping_l), lap_r=tuple(cfg.lapping_r),
            level_sigma2=jnp.asarray(cfg.level_sigma2, jnp.float32),
        )
        depth = jnp.where(sm.valid, sm.depth, -1.0)
        ok2 = sm.valid & (sm.idx_r >= 0)
        uv2 = jnp.where(
            ok2[:, None], feats_r.xy[jnp.clip(sm.idx_r, 0)], -1.0
        )
        return feats, depth, uv2

    # ------------------------------------------------------------------
    def _process_timed(self, img_left, img_right, frame_id,
                       t=None, acc=None, gyr=None, imu_t=None):
        from orb_slam3_noted_tpu.pipeline.system import StereoSLAM

        if self._pending_loops:
            self.flush()
        self._service_background()
        t = float(frame_id) / self.cfg.fps if t is None else float(t)
        self._check_timestamps(t)
        if acc is not None:
            self.feed_imu(acc, gyr, imu_t)
        self._accumulate_interval(t)
        self._cur_time = t
        self.frames_total += 1
        cfg = self.cfg

        feats, depth, uv2 = self._fisheye_frontend(img_left, img_right)
        uvr = jnp.full((cfg.n_features,), -1.0, jnp.float32)

        if self.state == NOT_INITIALIZED:
            StereoSLAM._stereo_initialize(
                self, feats, frame_id, uvr, depth, xy_r=uv2
            )
            if self.state == OK:
                self.kf_order = [0]
                self.kf_times = [t]
                self.kf_segments = []
                self.seg_preints = []
                self.since_kf = (
                    np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,))
                )
            self._cur_time = t
            return self.trajectory[-1] if self.trajectory else None

        if self.imu_stage == 0:
            self._track(feats, frame_id, uvr=None, depth=depth, xy_r=uv2)
        else:
            Rcw, tcw, n_inl, mp_of_feat, pred = self._track_inertial(
                feats, frame_id, feat_uvr=None, feat_uv2=uv2
            )
            if n_inl < cfg.min_tracked_points:
                self._track(feats, frame_id, uvr=None, depth=depth, xy_r=uv2)
            else:
                self.state = OK
                self.frames_since_kf += 1
                self._record(frame_id, Rcw, tcw, n_inl)
                if self.keep_frame_overlay:
                    self._record_overlay(feats, mp_of_feat, frame_id)
                close_th = (cfg.bf / self.cam.fx) * cfg.th_depth
                close = (depth > 0) & (depth < close_th)
                tc, ntc = jax.device_get((
                    jnp.sum((mp_of_feat >= 0) & close),
                    jnp.sum((mp_of_feat < 0) & close),
                ))
                if self._need_new_kf(n_inl, tracked_close=int(tc),
                                     nontracked_close=int(ntc)):
                    self._insert_keyframe(
                        feats, frame_id, Rcw, tcw, mp_of_feat, n_inl,
                        uvr=None, depth=depth, xy_r=uv2,
                    )
        self._try_imu_init(t)
        self._cur_time = t
        return self.trajectory[-1]

    # ------------------------------------------------------------------
    def process_batch(self, imgs, frame_ids, ts=None,
                      acc=None, gyr=None, imu_t=None):
        """Per-frame fallback: the fisheye VI frontend has no fused batch
        dispatch yet — drive each (left, right) pair through ``process``."""
        if acc is not None:
            self.feed_imu(acc, gyr, imu_t)
        if ts is None:
            ts = [float(f) / self.cfg.fps for f in frame_ids]
        for (l, r), fid, t in zip(imgs, frame_ids, ts):
            self.process(l, r, fid, t=t)
        return self.trajectory[-1] if self.trajectory else None
