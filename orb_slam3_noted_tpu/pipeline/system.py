"""Monocular SLAM system: host orchestration over jitted stages.

Equivalent of the reference's ``System`` facade + Tracking state machine
(`/root/reference/src/System.cc`, `src/Tracking.cc:1655` ``Track``): a thin
host loop that sequences jitted device steps, keeps the scalar counters
(keyframe/point allocation, tracking state) on the host, and records the
trajectory.  Local mapping runs synchronously after keyframe insertion
(SURVEY §7 phase E); the pipelined version is a later phase.

States mirror the reference (`include/Tracking.h:106-114`):
NOT_INITIALIZED -> OK -> (RECENTLY_LOST on tracking failure; dead-reckons on
the motion model, re-anchoring when matching recovers).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import se3
from orb_slam3_noted_tpu.geometry.twoview import reconstruct_two_views
from orb_slam3_noted_tpu.io.config import SlamConfig
from orb_slam3_noted_tpu.models import cameras as cam_mod
from orb_slam3_noted_tpu.ops import matching as M
from orb_slam3_noted_tpu.ops import orb as O
from orb_slam3_noted_tpu.pipeline import map_state as MS
from orb_slam3_noted_tpu.pipeline import tracking as T
from orb_slam3_noted_tpu.utils.timing import GLOBAL_TIMER as TIMER

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
RECENTLY_LOST = "RECENTLY_LOST"
LOST = "LOST"


@dataclass
class FrameRecord:
    frame_id: int
    Rcw: np.ndarray
    tcw: np.ndarray
    state: str
    n_inliers: int
    # relative-pose bookkeeping (reference ``mlRelativeFramePoses``,
    # `src/Tracking.cc:2144-2163`): the exported trajectory composes the
    # track-time pose RELATIVE to its reference keyframe with that
    # keyframe's FINAL pose, so later BA / loop corrections retro-apply
    ref_slot: int = -1
    rel_R: np.ndarray | None = None
    rel_t: np.ndarray | None = None


class MonoSLAM:
    """Monocular SLAM on one device. See module docstring."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.cam = cfg.camera
        self.m = MS.empty_map(cfg)
        self.n_kf = 0
        self._n_mp = 0
        self._n_mp_pending = None   # device scalar awaiting lazy sync
        # composed old->new point-index map of every compaction since the
        # last track dispatch; in-flight feature->point bindings from that
        # dispatch must pass through it before touching the map
        self._mp_remap = None
        self._pending_loops = []    # enqueued loop detections (device futures)
        # host mirror of keyframe frame-ids (avoids device pulls on the loop
        # closer's recency exclusion; -1 = empty slot)
        self.kf_frame_ids = np.full(cfg.max_keyframes, -1, np.int64)
        # recycled keyframe slots (reference SetBadFlag/EraseKeyFrame
        # lifecycle): refilled from the kf_valid pulls at loop-detect
        # boundaries, or on demand when the monotone allocator is exhausted
        self.free_kf_slots: list[int] = []
        self._dead_slots: set[int] = set()  # culled slots already fixed up
        self._refill_cooldown = 0
        self.kf_inserted = 0        # total keyframe insertions (incl. recycled)
        self.state = NOT_INITIALIZED
        self.ref_feats = None       # first frame features (for init)
        self.ref_frame_id = None
        self.vel = None             # relative motion (R, t): Tcw_k = vel o Tcw_{k-1}
        self.last_Rcw = jnp.eye(3, dtype=jnp.float32)
        self.last_tcw = jnp.zeros(3, dtype=jnp.float32)
        self.last_kf_slot = 0
        self.frames_since_kf = 0
        self.tracked_at_kf = 0
        self.trajectory: list[FrameRecord] = []
        self.loop_closer = None  # attached lazily when loop closing enabled
        # standalone relocalization database (reference: the KFDB always
        # exists, `src/System.cc:104`, independent of loop closing)
        self.reloc_db = None
        # reference Tracking.h:311-312 grace timers: RECENTLY_LOST holds for
        # ~2 s (visual) before the state degrades to LOST
        self.lost_frames = 0
        self.lost_patience = max(int(2.0 * cfg.fps), 4)
        # reference System::ActivateLocalizationMode: track against the
        # frozen map, never insert keyframes / run the mapper
        self.localization_only = False
        # FrameDrawer hook (reference ``FrameDrawer::Update``): when on,
        # per-frame tracking records a keypoint/match snapshot for
        # ``utils.viewer.draw_frame`` (one small host pull per frame)
        self.keep_frame_overlay = False
        self.last_overlay = None
        self.last_image = None  # kept only when keep_frame_overlay is on

    # ------------------------------------------------------------------
    # deferred-sync allocation pointer: keyframe insertion leaves ``n_mp`` as
    # a device scalar so the host never blocks on the mapper dispatch (the
    # single-chip analogue of the reference's async LocalMapping thread);
    # reading ``n_mp`` syncs lazily.
    @property
    def n_mp(self) -> int:
        if self._n_mp_pending is not None:
            self._n_mp = int(self._n_mp_pending)
            self._n_mp_pending = None
        return self._n_mp

    @n_mp.setter
    def n_mp(self, v):
        self._n_mp_pending = None
        self._n_mp = int(v)

    def _n_mp_for_device(self):
        """Current allocation pointer WITHOUT forcing a host sync."""
        if self._n_mp_pending is not None:
            return self._n_mp_pending
        return jnp.int32(self._n_mp)

    # ------------------------------------------------------------------
    def flush(self):
        """Drain deferred loop-closing work (one bulk pull)."""
        if self._pending_loops:
            with TIMER.stage("loop_drain"):
                pendings, self._pending_loops = self._pending_loops, []
                if self.loop_closer.finish_detect_many(self, pendings):
                    self.state = OK
        if self.loop_closer is not None:
            self.loop_closer.finish_gba(self)
        return self

    def _service_background(self):
        """One time-slice of deferred heavy work (in-flight GBA) per frame
        boundary — the single-chip stand-in for the reference's background
        GBA thread (`src/LoopClosing.cc:1090-1097`)."""
        if self.loop_closer is not None:
            with TIMER.stage("background_slice"):
                self.loop_closer.service_gba(self, n_steps=1)

    # ------------------------------------------------------------------
    def _refill_free_slots(self, kf_valid: np.ndarray):
        """Recompute the recycled-slot list from a fresh kf_valid pull.

        Before a slot may be recycled, every trajectory record anchored to
        it is RE-ANCHORED to the culled keyframe's spanning-tree parent
        (the reference's ``SaveTrajectoryTUM`` walk, `src/System.cc:
        461-467`): rel' = rel ∘ T_dead ∘ T_parent^-1 keeps the record
        relative to a LIVE keyframe, so it still follows every later
        BA/loop refinement.  (Round-5: baking to an absolute pose here
        froze pre-loop records at their drifted values — the corrected map
        reached 3 mm while the trajectory stayed at 8 cm.)  Records whose
        culled reference has no live ancestor fall back to absolute."""
        kf_valid = np.asarray(kf_valid)
        dead = np.flatnonzero(~kf_valid[: self.n_kf])
        newly_dead = [
            int(s) for s in dead
            if s != self.last_kf_slot and int(s) not in self._dead_slots
        ]
        if newly_dead:
            refs = {r.ref_slot for r in self.trajectory if r.ref_slot >= 0}
            fixup = [s for s in newly_dead if s in refs]
            if fixup:
                sl = jnp.asarray(np.asarray(fixup, np.int32))
                Rk, tk, par = jax.device_get((
                    self.m.kf_Rcw[sl], self.m.kf_tcw[sl],
                    self.m.kf_parent[sl],
                ))
                psl = jnp.asarray(np.clip(par, 0, None).astype(np.int32))
                Rp, tp = jax.device_get(
                    (self.m.kf_Rcw[psl], self.m.kf_tcw[psl])
                )
                info = {
                    s: (Rk[k], tk[k], int(par[k]), Rp[k], tp[k])
                    for k, s in enumerate(fixup)
                }
                for r in self.trajectory:
                    if r.ref_slot in info:
                        Rr, tr, p, Rpp, tpp = info[r.ref_slot]
                        if p >= 0 and kf_valid[p]:
                            # T_dead o T_parent^-1
                            A_R = Rr @ Rpp.T
                            A_t = tr - A_R @ tpp
                            r.rel_t = r.rel_R @ A_t + r.rel_t
                            r.rel_R = r.rel_R @ A_R
                            r.ref_slot = p
                        else:
                            r.Rcw = r.rel_R @ Rr
                            r.tcw = r.rel_R @ tr + r.rel_t
                            r.ref_slot = -1
                            r.rel_R = r.rel_t = None
            self._dead_slots.update(newly_dead)
        self.free_kf_slots = [
            int(s) for s in dead if s != self.last_kf_slot
        ]

    def _alloc_kf_slot(self):
        """Next keyframe slot: fresh while capacity lasts, else recycled."""
        if self.n_kf < self.cfg.max_keyframes:
            slot = self.n_kf
            self.n_kf += 1
            return slot
        if self.free_kf_slots:
            slot = self.free_kf_slots.pop(0)
            self._dead_slots.discard(slot)  # slot gets a new occupant
            return slot
        return None

    def _can_insert_kf(self) -> bool:
        if self.n_kf < self.cfg.max_keyframes or self.free_kf_slots:
            return True
        # At capacity with no known-free slot: run a standalone redundancy
        # cull (the reference culls every mapper pass, but our mapper pass
        # IS the insertion — at capacity it cannot run, so cull explicitly)
        # and refresh liveness, at most every ~8 frames.
        if self._refill_cooldown <= 0:
            self._refill_cooldown = 8
            slot = jnp.int32(self.last_kf_slot)
            _, kf_mask = MS.local_map_mask(
                self.m, slot, n_neighbors=self.cfg.local_window
            )
            protect = (
                jnp.zeros(self.cfg.max_keyframes, bool)
                .at[slot].set(True).at[0].set(True)
            )
            self.m = MS.cull_keyframes(self.m, kf_mask, protect)
            self._refill_free_slots(jax.device_get(self.m.kf_valid))
            return bool(self.free_kf_slots)
        self._refill_cooldown -= 1
        return False

    # ------------------------------------------------------------------
    def _need_new_kf(self, n_inl: int, tracked_close=None,
                     nontracked_close=None) -> bool:
        """Full ``Tracking::NeedNewKeyFrame`` policy
        (`/root/reference/src/Tracking.cc:2922-3058`).

        c1a: MaxFrames elapsed since the last keyframe;
        c1b: MinFrames elapsed and the mapper can accept work (our mapper is
             an enqueued device dispatch — always accepting);
        c1c: non-mono sensors: tracking weak (<25% of reference) OR the
             close-point trigger fires;
        c2 : tracking below thRefRatio of the reference keyframe OR the
             close-point trigger, with a >15-inlier floor.
        Close-point trigger (stereo/RGB-D): fewer than 100 close points
        tracked while >70 close points are left untracked — the condition
        that keeps the map dense ahead of fast forward motion.
        """
        cfg = self.cfg
        if self.localization_only or not self._can_insert_kf():
            return False
        ref = max(self.tracked_at_kf, 1)
        close_trigger = (
            tracked_close is not None
            and tracked_close < 100
            and nontracked_close is not None
            and nontracked_close > 70
        )
        c1a = self.frames_since_kf >= cfg.kf_max_interval
        c1b = self.frames_since_kf >= cfg.kf_min_interval
        c1c = tracked_close is not None and (
            n_inl < 0.25 * ref or close_trigger
        )
        c2 = (
            n_inl < cfg.kf_tracked_ratio * ref or close_trigger
        ) and n_inl > 15
        return (c1a or c1b or c1c) and c2

    # ------------------------------------------------------------------
    def set_localization_mode(self, on: bool):
        """Reference ``System::ActivateLocalizationMode`` (`src/System.cc:173`)."""
        self.localization_only = bool(on)

    # ------------------------------------------------------------------
    def reset(self):
        """Full reset (reference ``System::Reset``): drop map and state."""
        cfg = self.cfg
        self.m = MS.empty_map(cfg)
        self.n_kf = 0
        self.n_mp = 0
        self._pending_loops = []
        self.kf_frame_ids = np.full(cfg.max_keyframes, -1, np.int64)
        self.free_kf_slots = []
        self._dead_slots = set()
        self._refill_cooldown = 0
        self.state = NOT_INITIALIZED
        self.ref_feats = None
        self.ref_frame_id = None
        self.vel = None
        self.last_Rcw = jnp.eye(3, dtype=jnp.float32)
        self.last_tcw = jnp.zeros(3, jnp.float32)
        self.last_kf_slot = 0
        self.frames_since_kf = 0
        self.tracked_at_kf = 0
        self.lost_frames = 0
        self.loop_closer = None
        self.reloc_db = None

    # ------------------------------------------------------------------
    def _update_lost_state(self, ok: bool):
        """OK / RECENTLY_LOST / LOST transition (reference state machine)."""
        if ok:
            self.state = OK
            self.lost_frames = 0
        else:
            self.lost_frames += 1
            self.state = (
                LOST if self.lost_frames > self.lost_patience else RECENTLY_LOST
            )

    # ------------------------------------------------------------------
    def process(self, img, frame_id: int):
        """Feed one grayscale image (H, W), values in [0, 255]."""
        if self._pending_loops:
            self.flush()
        self._service_background()
        if self.keep_frame_overlay:
            self.last_image = np.asarray(img)
        if self.state == NOT_INITIALIZED:
            with TIMER.stage("initialize"):
                feats = O.extract_orb(
                    jnp.asarray(img, jnp.float32),
                    n_features=self.cfg.n_features,
                    n_levels=self.cfg.n_levels,
                    scale_factor=self.cfg.scale_factor,
                    th_high=self.cfg.ini_th_fast,
                    th_low=self.cfg.min_th_fast,
                )
                self._try_initialize(feats, frame_id)
        else:
            # fused hot path: uint8 upload (no-op for device-resident
            # frames) + one device dispatch
            if isinstance(img, jnp.ndarray):
                img_u8 = img.astype(jnp.uint8)
            else:
                img_u8 = jnp.asarray(np.asarray(img).astype(np.uint8))
            self._track_fused(img_u8, frame_id)
        return self.trajectory[-1] if self.trajectory else None

    # ------------------------------------------------------------------
    # batch-mode hooks (overridden by StereoSLAM)
    def _process_one(self, frame, frame_id):
        self.process(frame, frame_id)

    def _on_batch_frame(self, frame_id):
        """Per-committed-frame hook inside the batch walk (the inertial
        mixin uses it for time/IMU bookkeeping); no-op for visual."""

    def _prep_batch(self, frames, n_pad):
        if isinstance(frames[0], jnp.ndarray):
            # device-resident frames (pre-staged input pipeline): stack on
            # device — no host->device transfer on the hot path
            return jnp.stack(
                list(frames) + [frames[-1]] * n_pad
            ).astype(jnp.uint8)
        batch_np = [np.asarray(f).astype(np.uint8) for f in frames]
        pad = batch_np + [batch_np[-1]] * n_pad
        return jnp.asarray(np.stack(pad))

    def _batch_track(self, prep, vel, cm):
        self.m, Rs, ts, n_inls, feats_all, mp_feats = T.track_batch(
            self.m, prep, jnp.int32(self.last_kf_slot),
            self.last_Rcw, self.last_tcw, vel, self.cam, self.cfg,
            bf=0.0, count_mask=cm,
        )
        return Rs, ts, n_inls, feats_all, mp_feats, None

    def _batch_retrack(self, rolled, aux_rolled, vel, cm):
        self.m, Rs, ts, n_inls, _, mp_feats = T.track_batch_feats(
            self.m, rolled, jnp.int32(self.last_kf_slot),
            self.last_Rcw, self.last_tcw, vel, self.cam, self.cfg,
            bf=0.0, count_mask=cm,
        )
        return Rs, ts, n_inls, mp_feats

    @staticmethod
    def _roll_aux(aux, pos):
        if aux is None:
            return None
        return jax.tree_util.tree_map(
            lambda x: jnp.roll(x, -pos, axis=0), aux
        )

    @staticmethod
    def _kf_extras(aux, d):
        """(uvr, depth) rows for the keyframe frame at dispatch index d."""
        if aux is None:
            return None, None
        uvr_all, depth_all = aux
        return uvr_all[d], depth_all[d]

    def _close_counts(self, mp_feats, aux):
        """Device (tracked_close, nontracked_close) per frame, or None.

        Stereo/RGB-D only (reference NeedNewKeyFrame close-point trigger,
        `src/Tracking.cc:2962-2992`); mono has no depth.
        """
        if aux is None:
            return None
        _, depth_all = aux
        close_th = (self.cfg.bf / self.cam.fx) * self.cfg.th_depth
        close = (depth_all > 0) & (depth_all < close_th)
        tc = jnp.sum((mp_feats >= 0) & close, axis=1)
        ntc = jnp.sum((mp_feats < 0) & close, axis=1)
        return tc, ntc

    # ------------------------------------------------------------------
    def process_batch(self, imgs, frame_ids):
        """Throughput mode: track a batch of frames per device dispatch.

        One scanned dispatch tracks the whole batch; the host then walks the
        per-frame inlier counts, promotes the FIRST frame that needs a
        keyframe (reference ``NeedNewKeyFrame`` policy, evaluated per frame,
        not at the batch tail), inserts it in one fused dispatch, and
        re-tracks the remaining frames of the batch against the updated map
        WITHOUT re-extracting (``track_batch_feats``).  This keeps points
        created mid-batch visible to the frames after the keyframe.
        """
        if self._pending_loops:
            self.flush()
        self._service_background()
        cfg = self.cfg
        i = 0
        while self.state == NOT_INITIALIZED and i < len(imgs):
            i += self._init_consume(imgs[i:], frame_ids[i:])
        if i >= len(imgs):
            return self.trajectory[-1] if self.trajectory else None

        B = len(imgs)
        ids = list(frame_ids[i:])
        n_real = len(ids)
        prep = self._prep_batch(imgs[i:], B - n_real)

        pos = 0           # frames committed so far
        feats_all = None  # device-resident features of the full batch
        aux = None        # per-frame stereo rows (uvr, depth) or None
        attempts = 0
        while pos < n_real:
            vel = self.vel if self.vel is not None else (
                jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)
            )
            if feats_all is None:
                with TIMER.stage("track_batch"):
                    cm = jnp.arange(B) < n_real  # padding never counts
                    Rs, ts, n_inls, feats_all, mp_feats, aux = (
                        self._batch_track(prep, vel, cm)
                    )
                    self._mp_remap = None  # fresh bindings vs current map
                    # ONE bulk pull for everything the host needs this
                    # dispatch — each separate np.asarray costs a full
                    # device round trip
                    cc = self._close_counts(mp_feats, aux)
                    extra = () if cc is None else cc
                    if self._n_mp_pending is not None:
                        extra = extra + (self._n_mp_pending,)
                    pulled = jax.device_get((
                        n_inls, Rs, ts,
                        self.m.kf_Rcw[self.last_kf_slot],
                        self.m.kf_tcw[self.last_kf_slot],
                    ) + extra)
                    n_np, Rs_np, ts_np, refR, reft = pulled[:5]
                    rest = list(pulled[5:])
                    cc_np = (rest.pop(0), rest.pop(0)) if cc is not None else None
                    if rest:
                        self.n_mp = int(rest.pop(0))  # piggybacked sync
                    ref_now = (self.last_kf_slot, refR, reft)
                offset = 0
                cur_feats, cur_aux = feats_all, aux
            else:
                # roll so the next uncommitted frame leads; wrapped tail
                # frames are tracked but ignored
                with TIMER.stage("track_batch_feats"):
                    rolled = jax.tree_util.tree_map(
                        lambda x: jnp.roll(x, -pos, axis=0), feats_all
                    )
                    aux_rolled = self._roll_aux(aux, pos)
                    # only the still-uncommitted head of the rolled batch may
                    # bump visible/found (committed/wrapped frames already did)
                    cm = jnp.arange(B) < (n_real - pos)
                    Rs, ts, n_inls, mp_feats = self._batch_retrack(
                        rolled, aux_rolled, vel, cm
                    )
                    self._mp_remap = None  # fresh bindings vs current map
                    cc = self._close_counts(mp_feats, aux_rolled)
                    extra = () if cc is None else cc
                    if self._n_mp_pending is not None:
                        extra = extra + (self._n_mp_pending,)
                    pulled = jax.device_get((
                        n_inls, Rs, ts,
                        self.m.kf_Rcw[self.last_kf_slot],
                        self.m.kf_tcw[self.last_kf_slot],
                    ) + extra)
                    n_np, Rs_np, ts_np, refR, reft = pulled[:5]
                    rest = list(pulled[5:])
                    cc_np = (rest.pop(0), rest.pop(0)) if cc is not None else None
                    if rest:
                        self.n_mp = int(rest.pop(0))
                    ref_now = (self.last_kf_slot, refR, reft)
                offset = pos
                cur_feats, cur_aux = rolled, aux_rolled

            # walk frames; insert keyframes where the policy fires.  With
            # retrack_after_kf the walk stops at the first keyframe and the
            # rest of the batch re-tracks against the updated map; without
            # it (default — the reference's tracking also continues on the
            # pre-KF map until the async mapper lands) the walk covers the
            # whole batch in one pass.
            k_kf = None
            for k in range(n_real - pos):
                j = pos + k          # batch index of this frame
                d = j - offset       # index into this dispatch's outputs
                self._on_batch_frame(ids[j])
                n = int(n_np[d])
                ok = n >= cfg.min_tracked_points
                self._update_lost_state(ok)
                self.frames_since_kf += 1
                # numpy rows: one bulk device->host pull per dispatch; a
                # per-frame np.asarray(Rs[k]) costs a device round trip each
                self._record(ids[j], Rs_np[d], ts_np[d], n, ref_pose=ref_now)
                if ok and d >= 1:
                    Rv = Rs_np[d] @ Rs_np[d - 1].T
                    self.vel = (Rv, ts_np[d] - Rv @ ts_np[d - 1])
                need = ok and self._need_new_kf(
                    n,
                    tracked_close=int(cc_np[0][d]) if cc_np is not None else None,
                    nontracked_close=int(cc_np[1][d]) if cc_np is not None else None,
                )
                if need:
                    feats_k = jax.tree_util.tree_map(
                        lambda x: x[d], cur_feats
                    )
                    uvr_k, depth_k = self._kf_extras(cur_aux, d)
                    self._insert_keyframe(
                        feats_k, ids[j], Rs_np[d], ts_np[d], mp_feats[d], n,
                        uvr=uvr_k, depth=depth_k,
                    )
                    if cfg.retrack_after_kf and attempts < 3 and j + 1 < n_real:
                        k_kf = j
                        break
            if k_kf is None:
                pos = n_real
            else:
                pos = k_kf + 1
                attempts += 1
        return self.trajectory[-1]

    # ------------------------------------------------------------------
    def _track_fused(self, img_u8, frame_id):
        cfg = self.cfg
        if self.vel is not None:
            Rp, tp = se3.compose(self.vel, (self.last_Rcw, self.last_tcw))
        else:
            Rp, tp = self.last_Rcw, self.last_tcw
        self.m, feats, Rcw, tcw, n_inl, mp_of_feat = T.track_step(
            self.m, img_u8, jnp.int32(self.last_kf_slot), Rp, tp,
            self.cam, cfg, bf=0.0,
        )
        self._mp_remap = None  # fresh bindings vs current map
        # single bulk pull per frame (a per-array pull costs a device round
        # trip each)
        Rn, tn, n = jax.device_get((Rcw, tcw, n_inl))
        self._after_track(feats, frame_id, Rp, tp, Rn, tn, int(n),
                          mp_of_feat, uvr=None, depth=None)

    # ------------------------------------------------------------------
    def _after_track(self, feats, frame_id, Rp, tp, Rcw, tcw, n_inl,
                     mp_of_feat, uvr=None, depth=None, xy_r=None):
        cfg = self.cfg
        if n_inl < cfg.min_tracked_points:
            # relocalization attempt (reference Tracking::Relocalization)
            reloc = self._try_relocalize(feats, frame_id)
            if reloc is not None:
                Rcw, tcw, n_inl, mp_of_feat = reloc
            else:
                self._update_lost_state(False)
                self.vel = None
                self._record(frame_id, Rp, tp, n_inl)
                self.frames_since_kf += 1
                return
        self._update_lost_state(True)
        if self.keep_frame_overlay:
            self.last_overlay = dict(
                xy=np.asarray(feats.xy), valid=np.asarray(feats.valid),
                matched=np.asarray(mp_of_feat) >= 0, frame_id=int(frame_id),
                state=self.state, n_kf=self.n_kf, n_mp=self.n_mp,
            )
        self.vel = se3.compose((Rcw, tcw), se3.inverse((self.last_Rcw, self.last_tcw)))
        self.frames_since_kf += 1
        ref_now = (self.last_kf_slot,) + tuple(jax.device_get((
            self.m.kf_Rcw[self.last_kf_slot],
            self.m.kf_tcw[self.last_kf_slot],
        )))
        self._record(frame_id, Rcw, tcw, n_inl, ref_pose=ref_now)
        tc = ntc = None
        if depth is not None:
            close_th = (cfg.bf / self.cam.fx) * cfg.th_depth
            close = (depth > 0) & (depth < close_th)
            tc, ntc = jax.device_get((
                jnp.sum((mp_of_feat >= 0) & close),
                jnp.sum((mp_of_feat < 0) & close),
            ))
            tc, ntc = int(tc), int(ntc)
        if self._need_new_kf(n_inl, tracked_close=tc, nontracked_close=ntc):
            self._insert_keyframe(feats, frame_id, Rcw, tcw, mp_of_feat, n_inl,
                                  uvr=uvr, depth=depth, xy_r=xy_r)

    # ------------------------------------------------------------------
    def _record_overlay(self, feats, mp_of_feat, frame_id):
        """FrameDrawer snapshot (see ``keep_frame_overlay``)."""
        self.last_overlay = dict(
            xy=np.asarray(feats.xy), valid=np.asarray(feats.valid),
            matched=np.asarray(mp_of_feat) >= 0, frame_id=int(frame_id),
            state=self.state, n_kf=self.n_kf, n_mp=self.n_mp,
        )

    # ------------------------------------------------------------------
    def _record(self, frame_id, Rcw, tcw, n_inl, ref_pose=None):
        """Append a trajectory record.

        ``ref_pose``: optional (ref_slot, Rr, tr) — the reference keyframe's
        pose at TRACK time; stores the frame pose relative to it so the
        exported trajectory follows later keyframe refinements.
        """
        Rn, tn = np.asarray(Rcw), np.asarray(tcw)
        if ref_pose is not None:
            ref_slot, Rr, tr = ref_pose
            rel_R = Rn @ Rr.T
            rel_t = tn - rel_R @ tr
            rec = FrameRecord(frame_id, Rn, tn, self.state, n_inl,
                              ref_slot=int(ref_slot), rel_R=rel_R, rel_t=rel_t)
        else:
            rec = FrameRecord(frame_id, Rn, tn, self.state, n_inl)
        self.trajectory.append(rec)
        self.last_Rcw = Rcw
        self.last_tcw = tcw

    # ------------------------------------------------------------------
    def _try_initialize(self, feats, frame_id):
        cfg = self.cfg
        if self.ref_feats is None:
            self.ref_feats = feats
            self.ref_frame_id = frame_id
            self._record(frame_id, jnp.eye(3, dtype=jnp.float32),
                         jnp.zeros(3, jnp.float32), 0)
            return

        ref = self.ref_feats
        d = M.hamming_matrix(ref.desc, feats.desc)
        mm = M.match_nn(
            d, ref.valid, feats.valid, max_dist=M.TH_LOW, ratio=0.9,
            mutual=True, ang_a=ref.angle, ang_b=feats.angle,
        )
        idx = mm.idx
        matched = idx >= 0
        rays1 = cam_mod.unproject(self.cam, ref.xy)
        rays2 = cam_mod.unproject(self.cam, feats.xy[jnp.clip(idx, 0)])
        fx = self.cam.fx
        # reconstruction runs unconditionally (device compute is cheap; a
        # host round-trip to gate on the match count is not) and everything
        # the host branches on comes back in ONE bulk pull
        res = reconstruct_two_views(
            rays1, rays2, matched, jax.random.PRNGKey(frame_id),
            err_thresh=3.84 / (fx * fx),
        )
        n_matches, success, good, pts1_np, R21_np, t21_np = jax.device_get((
            jnp.sum(matched), res.success, res.is_inlier,
            res.points1, res.R21, res.t21,
        ))
        if int(n_matches) < 100:
            # reference resets the initializer if matching is too weak
            self.ref_feats = feats
            self.ref_frame_id = frame_id
            self._record(frame_id, self.last_Rcw, self.last_tcw, 0)
            return
        if not bool(success):
            self._record(frame_id, self.last_Rcw, self.last_tcw, 0)
            return
        self._finish_initialize(
            feats, frame_id, idx, good, res.points1, res.R21, res.t21,
            pts1_np, R21_np, t21_np,
        )

    def _finish_initialize(self, feats, frame_id, idx, good, pts1_dev,
                           R21_dev, t21_dev, pts1_np, R21_np, t21_np):
        """Build the two-keyframe initial map from a successful two-view
        reconstruction (reference ``CreateInitialMapMonocular``)."""
        cfg = self.cfg
        ref = self.ref_feats
        # normalize scale: median depth of accepted points -> 1 (reference
        # CreateInitialMapMonocular).  Guard the degenerate-success case
        # (too few accepted points -> nan median -> nan-scaled map)
        if int(np.sum(good)) < 30:
            self._record(frame_id, self.last_Rcw, self.last_tcw, 0)
            return
        z = pts1_np[:, 2]
        med = float(np.median(z[good]))
        if not np.isfinite(med) or med <= 1e-6:
            self._record(frame_id, self.last_Rcw, self.last_tcw, 0)
            return
        scale = 1.0 / max(med, 1e-6)
        pts_w = pts1_dev * scale        # KF0 frame == world
        t21 = t21_dev * scale

        m = self.m
        NF = cfg.n_features
        nobind = jnp.full((NF,), -1, jnp.int32)
        m = MS.add_keyframe(
            m, jnp.int32(0), jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
            jnp.int32(self.ref_frame_id),
            ref.xy, ref.level, ref.angle, ref.desc, ref.valid, nobind,
            jnp.full((NF,), -1.0, jnp.float32),
        )
        m = MS.add_keyframe(
            m, jnp.int32(1), R21_dev, t21, jnp.int32(frame_id),
            feats.xy, feats.level, feats.angle, feats.desc, feats.valid, nobind,
            jnp.full((NF,), -1.0, jnp.float32),
        )
        # map points: normal/scale range from KF0 geometry
        dist = jnp.linalg.norm(pts_w, axis=-1)
        normal = pts_w / jnp.maximum(dist, 1e-9)[:, None]
        sf = jnp.asarray(O.scale_factors(cfg.n_levels, cfg.scale_factor), jnp.float32)
        dmax = dist * sf[ref.level]
        dmin = dmax / sf[cfg.n_levels - 1]
        accept = jnp.asarray(good)
        m = MS.add_map_points(
            m, jnp.int32(0), pts_w, ref.desc, normal, dmin, dmax,
            jnp.int32(0), accept,
            jnp.int32(0), jnp.arange(NF, dtype=jnp.int32),
            jnp.int32(1), jnp.clip(idx, 0),
        )
        self.n_mp = int(np.sum(good))
        self.n_kf = 2
        self.kf_frame_ids[0] = int(self.ref_frame_id)
        self.kf_frame_ids[1] = int(frame_id)
        # KF1's bindings were created after insertion: fix its tree parent
        m = MS.refresh_parent(m, jnp.int32(1))
        # full BA over the initial map (reference GlobalBundleAdjustemnt(20))
        m = T.local_ba(m, jnp.int32(1), self.cam, cfg, window=1)
        self.m = m
        self.state = OK
        self.last_kf_slot = 1
        self.frames_since_kf = 0
        self.tracked_at_kf = self.n_mp
        self.vel = None
        self._record(frame_id, R21_np, t21_np * scale, self.n_mp)

    # ------------------------------------------------------------------
    def _init_consume(self, imgs, frame_ids):
        """Batched initialization attempts for throughput mode.

        ONE extraction dispatch + ONE vmapped two-view attempt dispatch for
        the whole remaining batch (vs ~300 ms per per-frame attempt — 31%
        of the round-3 bench wall was mono init retries).  Returns the
        number of frames consumed (>= 1); the per-frame reset/success
        policy of ``_try_initialize`` is preserved by walking the pulled
        outcomes in frame order.
        """
        with TIMER.stage("initialize"):
            return self._init_consume_timed(imgs, frame_ids)

    def _init_consume_timed(self, imgs, frame_ids):
        cfg = self.cfg
        tree = jax.tree_util.tree_map
        batch = self._prep_batch(imgs, 0).astype(jnp.float32)
        feats_all = O.extract_orb_batch(
            batch, n_features=cfg.n_features, n_levels=cfg.n_levels,
            scale_factor=cfg.scale_factor, th_high=cfg.ini_th_fast,
            th_low=cfg.min_th_fast,
        )
        start = 0
        if self.ref_feats is None:
            self.ref_feats = tree(lambda x: x[0], feats_all)
            self.ref_frame_id = frame_ids[0]
            self._record(frame_ids[0], jnp.eye(3, dtype=jnp.float32),
                         jnp.zeros(3, jnp.float32), 0)
            if len(imgs) == 1:
                return 1
            start = 1
        cand = tree(lambda x: x[start:], feats_all)
        n_m, succ, good, pts1, R21, t21, idx = T.init_attempt_batch(
            self.ref_feats, cand, self.cam,
            jax.random.PRNGKey(int(frame_ids[start])),
        )
        n_m_np, succ_np, good_np, pts1_np, R21_np, t21_np = jax.device_get(
            (n_m, succ, good, pts1, R21, t21)
        )
        for j in range(len(frame_ids) - start):
            fid = frame_ids[start + j]
            if int(n_m_np[j]) < 100:
                # reference resets the initializer when matching is weak
                self.ref_feats = tree(lambda x: x[j], cand)
                self.ref_frame_id = fid
                self._record(fid, self.last_Rcw, self.last_tcw, 0)
                return start + j + 1
            if bool(succ_np[j]):
                feats_j = tree(lambda x: x[j], cand)
                self._finish_initialize(
                    feats_j, fid, idx[j], good_np[j], pts1[j], R21[j],
                    t21[j], pts1_np[j], R21_np[j], t21_np[j],
                )
                return start + j + 1
            self._record(fid, self.last_Rcw, self.last_tcw, 0)
        return len(frame_ids)

    # ------------------------------------------------------------------
    def _track(self, feats, frame_id, uvr=None, depth=None, xy_r=None):
        cfg = self.cfg
        # pose prediction: constant-velocity motion model (src/Tracking.cc
        # mVelocity), else last pose
        if self.vel is not None:
            Rp, tp = se3.compose(self.vel, (self.last_Rcw, self.last_tcw))
        else:
            Rp, tp = self.last_Rcw, self.last_tcw

        mp_mask, _ = MS.local_map_mask(
            self.m, jnp.int32(self.last_kf_slot), n_neighbors=cfg.local_window
        )
        Rcw, tcw, n_inl, mp_of_feat, vis, found = T.track_frame(
            self.m, feats, Rp, tp, mp_mask, self.cam, cfg,
            feat_uvr=uvr, bf=cfg.bf, feat_uv2=xy_r,
        )
        self._mp_remap = None  # fresh bindings vs current map
        self.m = self.m._replace(
            mp_visible=self.m.mp_visible + vis.astype(jnp.int32),
            mp_found=self.m.mp_found + found.astype(jnp.int32),
        )
        self._after_track(feats, frame_id, Rp, tp, Rcw, tcw, int(n_inl),
                          mp_of_feat, uvr=uvr, depth=depth, xy_r=xy_r)

    # ------------------------------------------------------------------
    def _try_relocalize(self, feats, frame_id):
        """BoW candidates -> PnP RANSAC -> projection re-track.

        Returns (Rcw, tcw, n_inl, mp_of_feat) on success, else None.
        Available once the loop-closing database exists.
        """
        db = self._reloc_database()
        if db is None:
            return None
        import jax

        from orb_slam3_noted_tpu.optim.pnp import pnp_ransac

        _, bow = db.compute_bow(feats.desc, feats.valid)
        exclude = np.zeros(self.cfg.max_keyframes, bool)
        # full DetectRelocalizationCandidates policy: covisibility-group
        # accumulation (`/root/reference/src/KeyFrameDatabase.cc`), not the
        # simple best-score path
        slots, _ = db.detect_candidates(
            bow, exclude, n_best=3, min_rel_score=0.75,
            covis=MS.covisibility_matrix(self.m),
        )
        for cand in slots:
            Xw, rays, ok = T.reloc_matches(self.m, jnp.int32(cand), feats, self.cam)
            if int(jnp.sum(ok)) < 15:
                continue
            res = pnp_ransac(Xw, rays, ok, jax.random.PRNGKey(frame_id))
            if not bool(res.success):
                continue
            # re-track the local map from the PnP pose
            mp_mask, _ = MS.local_map_mask(
                self.m, jnp.int32(cand), n_neighbors=self.cfg.local_window
            )
            Rcw, tcw, n_inl, mp_of_feat, vis, found = T.track_frame(
                self.m, feats, res.Rcw, res.tcw, mp_mask, self.cam, self.cfg,
                feat_uvr=None, bf=0.0,
            )
            self._mp_remap = None  # fresh bindings vs current map
            n = int(n_inl)
            if n >= 2 * self.cfg.min_tracked_points:
                self.last_kf_slot = cand
                self.vel = None
                return Rcw, tcw, n, mp_of_feat
        return None

    # ------------------------------------------------------------------
    def _insert_keyframe(self, feats, frame_id, Rcw, tcw, mp_of_feat, n_inl,
                         uvr=None, depth=None, xy_r=None):
        """One fused device dispatch for the whole mapper pass.

        ``T.insert_keyframe_step`` runs add-KF -> depth points ->
        triangulation -> fuse -> cull -> local BA -> KF cull on device; the
        host syncs only the new allocation pointer.
        """
        cfg = self.cfg
        slot = self._alloc_kf_slot()
        if slot is None:
            return  # truly at capacity with no culled slot to recycle
        self.kf_inserted += 1
        NF = cfg.n_features
        uvr_arr = uvr if uvr is not None else jnp.full((NF,), -1.0, jnp.float32)
        depth_arr = depth if depth is not None else jnp.full(
            (NF,), -1.0, jnp.float32
        )
        # bindings computed by a track dispatch BEFORE an earlier
        # compaction this walk still carry old point indices — remap them
        # or the keyframe binds features to recycled slots
        if self._mp_remap is not None:
            mp_of_feat = MS.remap_point_bindings(mp_of_feat, self._mp_remap)
        # free-list half of the map-point lifecycle: compact culled slots
        # away before the allocator runs out (last-known fill level; the
        # pointer refreshes with each batch's bulk pull)
        if self._n_mp > 0.85 * cfg.max_map_points:
            # compaction permutes point slots: any in-flight sliced GBA
            # holds snapshot indices — drain it first
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
                self._n_mp_for_device(),
                self.cam, cfg, n_neighbors=cfg.triangulate_neighbors,
                bf=cfg.bf, has_depth=depth is not None, xy_r=xy_r,
            )
            # deferred sync: the host does NOT wait for the mapper dispatch
            self._n_mp_pending = n_mp
        self.kf_frame_ids[slot] = int(frame_id)
        self.last_kf_slot = slot
        self.frames_since_kf = 0
        self.tracked_at_kf = max(n_inl, 1)

        if cfg.enable_loop_closing:
            self._maybe_close_loop(slot, feats)
        else:
            self._register_reloc_kf(slot)

    # ------------------------------------------------------------------
    def _reloc_database(self):
        """The database relocalization queries — loop closer's, or the
        standalone one maintained when loop closing is disabled."""
        if self.loop_closer is not None:
            return self.loop_closer.db
        return self.reloc_db

    def _register_reloc_kf(self, slot):
        """Keep a standalone KFDB when loop closing is off (the reference's
        database exists unconditionally and serves ``Relocalization``)."""
        from orb_slam3_noted_tpu.place.database import KeyFrameDatabase
        from orb_slam3_noted_tpu.place.pretrained import load_default_vocabulary

        if self.reloc_db is None:
            vocab, idf = load_default_vocabulary()
            if vocab is None:
                return  # no vocabulary asset; reloc unavailable
            self.reloc_db = KeyFrameDatabase(
                vocab, self.cfg.max_keyframes, idf=idf
            )
        m = self.m
        _, bow = self.reloc_db.compute_bow(
            m.kf_desc[slot], m.kf_feat_valid[slot]
        )
        self.reloc_db.add(slot, bow)

    # ------------------------------------------------------------------
    def _maybe_build_loop_closer(self, feats):
        """Lazy loop-closer construction.

        Uses the shipped pretrained 32k-word vocabulary
        (:mod:`orb_slam3_noted_tpu.place.pretrained`, the analogue of the
        reference's ORBvoc load at `src/System.cc:85-101`); falls back to
        training a small vocabulary from the first keyframe only when the
        asset is absent.
        """
        from orb_slam3_noted_tpu.pipeline.loop_closing import LoopCloser
        from orb_slam3_noted_tpu.place import train_vocabulary
        from orb_slam3_noted_tpu.place.pretrained import load_default_vocabulary

        if self.loop_closer is None:
            vocab, idf = load_default_vocabulary()
            if vocab is None:
                desc = np.asarray(feats.desc)[np.asarray(feats.valid)]
                vocab = train_vocabulary(
                    desc,
                    n_words=min(self.cfg.vocab_words, max(len(desc) // 2, 16)),
                    n_iters=6,
                )
                idf = None
            self.loop_closer = LoopCloser(
                vocab, self.cfg.max_keyframes,
                min_inliers=self.cfg.loop_min_inliers,
                idf=idf,
            )

    def _maybe_close_loop(self, slot, feats):
        self._maybe_build_loop_closer(feats)
        # detection is ENQUEUED here (device-only) and finished at the next
        # frame boundary — the host never blocks on the mapper dispatch, and
        # several queued detections drain with one bulk pull
        self._pending_loops.append(self.loop_closer.start_detect(self, slot))

    # ------------------------------------------------------------------
    def _add_candidates(self, m, slot, out, kf_b=None):
        """Insert accepted new-map-point candidates, advancing the allocator."""
        pos_w, desc, normal, dmin, dmax, feat_a, feat_b, accept = out
        n_new = int(jnp.sum(accept))
        if n_new == 0:
            return m, 0
        m = MS.add_map_points(
            m, jnp.int32(self.n_mp), pos_w, desc, normal, dmin, dmax,
            jnp.int32(slot), accept,
            jnp.int32(slot), feat_a,
            jnp.int32(slot if kf_b is None else kf_b), feat_b,
        )
        self.n_mp += n_new
        return m, n_new

    def _add_candidates_init(self, m, out, accept):
        """Insert the initial map's candidate points (all bound to KF 0).

        Lives on the base class because every stereo-backed variant
        (StereoSLAM, RGBDSLAM, StereoInertialSLAM — which does NOT inherit
        StereoSLAM) initializes through ``_stereo_initialize``."""
        pos_w, desc, normal, dmin, dmax, feat_a, feat_b, _ = out
        n_new = int(jnp.sum(accept))
        m = MS.add_map_points(
            m, jnp.int32(self.n_mp), pos_w, desc, normal, dmin, dmax,
            jnp.int32(0), accept, jnp.int32(0), feat_a, jnp.int32(0), feat_b,
        )
        self.n_mp += n_new
        return m, n_new

    # ------------------------------------------------------------------
    def positions(self):
        """(N, 3) camera-center trajectory (world frame).

        Relative-pose records are composed with their reference keyframe's
        CURRENT pose (reference ``SaveTrajectoryTUM``, `src/System.cc:421`),
        so every BA/loop refinement since track time is reflected.
        """
        kfR = np.asarray(self.m.kf_Rcw)
        kft = np.asarray(self.m.kf_tcw)
        out = []
        for rec in self.trajectory:
            if rec.ref_slot >= 0 and rec.rel_R is not None:
                Rr, tr = kfR[rec.ref_slot], kft[rec.ref_slot]
                R = rec.rel_R @ Rr
                t = rec.rel_R @ tr + rec.rel_t
            else:
                R, t = rec.Rcw, rec.tcw
            out.append(-R.T @ t)
        return np.stack(out)

    def final_poses(self):
        """[(Rcw, tcw)] per trajectory record with every BA/loop refinement
        retro-applied through the relative-pose mechanism (the full-pose
        sibling of :meth:`positions`; reference ``SaveTrajectoryTUM``)."""
        kfR = np.asarray(self.m.kf_Rcw)
        kft = np.asarray(self.m.kf_tcw)
        out = []
        for rec in self.trajectory:
            if rec.ref_slot >= 0 and rec.rel_R is not None:
                Rr, tr = kfR[rec.ref_slot], kft[rec.ref_slot]
                out.append((rec.rel_R @ Rr, rec.rel_R @ tr + rec.rel_t))
            else:
                out.append((np.asarray(rec.Rcw), np.asarray(rec.tcw)))
        return out


class StereoSLAM(MonoSLAM):
    """Stereo SLAM: rectified pair in, metric-scale map out.

    Differences from monocular (mirroring the reference's stereo branches):
    initialization from a single frame's stereo depth
    (``Tracking::StereoInitialization``, `src/Tracking.cc:2167`), stereo
    3-row observations in pose optimization and local BA, and new map points
    created directly from depth at keyframe insertion.
    """

    MIN_INIT_POINTS = 300  # reference requires 500 stereo points at init

    # ------------------------------------------------------------------
    # batch-mode hooks: ``process_batch`` receives a list of (left, right)
    # pairs; extraction runs as one (2B,)-wide dispatch and the stereo
    # matcher is vmapped (round-3 batched stereo path)
    def _process_one(self, frame, frame_id):
        self.process(frame[0], frame[1], frame_id)

    def _init_consume(self, imgs, frame_ids):
        # stereo init is single-frame (depth-backed); no batching needed
        self._process_one(imgs[0], frame_ids[0])
        return 1

    def _prep_batch(self, frames, n_pad):
        if isinstance(frames[0][0], jnp.ndarray):
            ls = jnp.stack(
                [f[0] for f in frames] + [frames[-1][0]] * n_pad
            ).astype(jnp.uint8)
            rs = jnp.stack(
                [f[1] for f in frames] + [frames[-1][1]] * n_pad
            ).astype(jnp.uint8)
            return ls, rs
        ls = [np.asarray(f[0]).astype(np.uint8) for f in frames]
        rs = [np.asarray(f[1]).astype(np.uint8) for f in frames]
        ls = ls + [ls[-1]] * n_pad
        rs = rs + [rs[-1]] * n_pad
        return jnp.asarray(np.stack(ls)), jnp.asarray(np.stack(rs))

    def _batch_track(self, prep, vel, cm):
        batchL, batchR = prep
        self.m, Rs, ts, n_inls, feats_all, mp_feats, uvr, depth = (
            T.stereo_track_batch(
                self.m, batchL, batchR, jnp.int32(self.last_kf_slot),
                self.last_Rcw, self.last_tcw, vel, self.cam, self.cfg,
                bf=self.cfg.bf, count_mask=cm,
            )
        )
        return Rs, ts, n_inls, feats_all, mp_feats, (uvr, depth)

    def _batch_retrack(self, rolled, aux_rolled, vel, cm):
        uvr, _ = aux_rolled
        self.m, Rs, ts, n_inls, _, mp_feats = T.stereo_track_batch_feats(
            self.m, rolled, uvr, jnp.int32(self.last_kf_slot),
            self.last_Rcw, self.last_tcw, vel, self.cam, self.cfg,
            bf=self.cfg.bf, count_mask=cm,
        )
        return Rs, ts, n_inls, mp_feats

    def process(self, img_left, img_right, frame_id: int):
        from orb_slam3_noted_tpu.ops import image as I
        from orb_slam3_noted_tpu.ops.stereo import match_stereo

        cfg = self.cfg
        if self.keep_frame_overlay:
            self.last_image = np.asarray(img_left)
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
            self._stereo_initialize(feats, frame_id, uvr, depth)
        else:
            self._track(feats, frame_id, uvr=uvr, depth=depth)
        return self.trajectory[-1] if self.trajectory else None

    def _stereo_initialize(self, feats, frame_id, uvr, depth, xy_r=None):
        cfg = self.cfg
        n_depth = int(jnp.sum((depth > 0) & feats.valid))
        if n_depth < self.MIN_INIT_POINTS:
            self._record(frame_id, jnp.eye(3, dtype=jnp.float32),
                         jnp.zeros(3, jnp.float32), 0)
            return
        m = MS.add_keyframe(
            self.m, jnp.int32(0), jnp.eye(3, dtype=jnp.float32),
            jnp.zeros(3, jnp.float32), jnp.int32(frame_id),
            feats.xy, feats.level, feats.angle, feats.desc, feats.valid,
            jnp.full((cfg.n_features,), -1, jnp.int32), uvr, xy_r=xy_r,
        )
        self.n_kf = 1
        self.kf_frame_ids[0] = int(frame_id)
        # all valid-depth features become points: override the candidate
        # accept mask (no close/far limit at init, as in the reference)
        out = T.stereo_points_from_depth(
            m, jnp.int32(0), depth, self.cam, cfg, bf=cfg.bf
        )
        accept = feats.valid & (depth > 0)
        m, _ = self._add_candidates_init(m, out, accept)
        self.m = m
        self.state = OK
        self.last_kf_slot = 0
        self.frames_since_kf = 0
        self.tracked_at_kf = self.n_mp
        self.vel = None
        self._record(frame_id, jnp.eye(3, dtype=jnp.float32),
                     jnp.zeros(3, jnp.float32), self.n_mp)


class FisheyeStereoSLAM(StereoSLAM):
    """Non-rectified (Kannala-Brandt) stereo SLAM — the TUM-VI configuration.

    The reference handles fisheye stereo without rectification: descriptors
    are matched inside the two cameras' lapping areas and triangulated
    directly with the known extrinsic ``Tlr``
    (``Frame::ComputeStereoFishEyeMatches`` `/root/reference/src/Frame.cc:1116`,
    ``KannalaBrandt8::TriangulateMatches``
    `src/CameraModels/KannalaBrandt8.cpp:236`).  Map points inherit metric
    scale from the triangulated left-frame depth; observations stay mono
    (u, v) residuals under the KB8 model (no rectified u_right exists), which
    matches the reference's two-mono-edge formulation for fisheye stereo.

    Requires cfg.camera/camera2 (KB8), cfg.tlr_r/tlr_t, cfg.lapping_l/r.
    cfg.bf must be baseline * fx (the reference's ``Camera.bf``, set for
    TUM-VI fisheye configs too) — it scales the close-point threshold.
    """

    MIN_INIT_POINTS = 100  # lapping area covers only part of the frame

    def __init__(self, cfg):
        super().__init__(cfg)
        assert cfg.camera2 is not None, "camera2 required for fisheye stereo"
        self.cam2 = cfg.camera2
        import numpy as _np

        self.Rlr = jnp.asarray(
            _np.asarray(cfg.tlr_r, _np.float32).reshape(3, 3)
            if cfg.tlr_r else _np.eye(3, dtype=_np.float32)
        )
        self.tlr = jnp.asarray(cfg.tlr_t, jnp.float32)

    def process(self, img_left, img_right, frame_id: int):
        from orb_slam3_noted_tpu.ops.fisheye_stereo import match_fisheye_stereo

        cfg = self.cfg
        if self.keep_frame_overlay:
            self.last_image = np.asarray(img_left)
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
        # True second-camera observations (round-3): the matched RIGHT
        # feature's pixel becomes a KB8 reprojection residual carrying Tlr
        # through pose optimization and BA (reference two-camera EdgeMono,
        # `include/G2oTypes.h:339-489`, `src/Frame.cc:1116`) — replacing the
        # round-2 virtual-disparity row, which mismodels wide-FoV geometry.
        ok2 = sm.valid & (sm.idx_r >= 0)
        uv2 = jnp.where(
            ok2[:, None], feats_r.xy[jnp.clip(sm.idx_r, 0)], -1.0
        )
        uvr = jnp.full((cfg.n_features,), -1.0, jnp.float32)

        if self.state == NOT_INITIALIZED:
            self._stereo_initialize(feats, frame_id, uvr, depth, xy_r=uv2)
        else:
            self._track(feats, frame_id, uvr=uvr, depth=depth, xy_r=uv2)
        return self.trajectory[-1] if self.trajectory else None


class RGBDSLAM(StereoSLAM):
    """RGB-D SLAM: gray image + registered depth map in, metric map out.

    The reference reduces RGB-D to the stereo machinery by synthesizing a
    virtual right-image coordinate per feature,
    ``u_r = u - bf / depth`` (``Frame::ComputeStereoFromRGBD``,
    `/root/reference/include/Frame.h:117`); everything downstream (stereo
    observations in pose opt / BA, depth-seeded map points) is shared.
    """

    def process(self, img, depth_img, frame_id: int):
        cfg = self.cfg
        if self.keep_frame_overlay:
            self.last_image = np.asarray(img)
        im = jnp.asarray(img, jnp.float32)
        feats = O.extract_orb(
            im, n_features=cfg.n_features, n_levels=cfg.n_levels,
            scale_factor=cfg.scale_factor,
            th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast,
        )
        dmap = jnp.asarray(depth_img, jnp.float32)
        H, W = dmap.shape
        # bilinear depth at sub-pixel keypoint locations, falling back to
        # nearest when any neighbour is invalid (depth edges)
        x = jnp.clip(feats.xy[:, 0], 0.0, W - 1.001)
        y = jnp.clip(feats.xy[:, 1], 0.0, H - 1.001)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx_ = x - x0
        fy_ = y - y0
        d00 = dmap[y0, x0]
        d01 = dmap[y0, x0 + 1]
        d10 = dmap[y0 + 1, x0]
        d11 = dmap[y0 + 1, x0 + 1]
        all_ok = (d00 > 0) & (d01 > 0) & (d10 > 0) & (d11 > 0)
        d_bil = (
            d00 * (1 - fx_) * (1 - fy_) + d01 * fx_ * (1 - fy_)
            + d10 * (1 - fx_) * fy_ + d11 * fx_ * fy_
        )
        d_near = dmap[jnp.round(y).astype(jnp.int32), jnp.round(x).astype(jnp.int32)]
        d = jnp.where(all_ok, d_bil, d_near)
        valid_d = feats.valid & (d > 0)
        depth = jnp.where(valid_d, d, -1.0)
        uvr = jnp.where(valid_d, feats.xy[:, 0] - cfg.bf / jnp.maximum(d, 1e-6), -1.0)

        if self.state == NOT_INITIALIZED:
            self._stereo_initialize(feats, frame_id, uvr, depth)
        else:
            self._track(feats, frame_id, uvr=uvr, depth=depth)
        return self.trajectory[-1] if self.trajectory else None
