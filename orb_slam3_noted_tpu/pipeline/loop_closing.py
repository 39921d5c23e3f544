"""Loop detection and correction.

Functional equivalent of the reference's LoopClosing thread
(`/root/reference/src/LoopClosing.cc`): BoW candidate retrieval
(``NewDetectCommonRegions``/``DetectNBestCandidates``), Sim3 geometric
verification (``DetectCommonRegionsFromBoW`` + Sim3Solver), and loop
correction (``CorrectLoop``): propagate the corrected Sim3 through the
keyframe graph with a pose-graph optimization and re-anchor map points via
their reference keyframes.  Runs synchronously after keyframe insertion
(the async pipelined version is a later phase); GBA after correction is
optional.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import sim3
from orb_slam3_noted_tpu.geometry.sim3_solver import Sim3Result, sim3_ransac
from orb_slam3_noted_tpu.ops import matching as M
from orb_slam3_noted_tpu.optim.pose_graph import Sim3Edges, optimize_pose_graph_sim3
from orb_slam3_noted_tpu.place.database import KeyFrameDatabase

_HP = jax.lax.Precision.HIGHEST


@jax.jit
def _matched_point_pairs(m, slot_cur, slot_cand):
    """3D-3D pairs from descriptor matches between two keyframes' map points.

    Points are expressed in each keyframe's own camera frame (as the
    reference's Sim3Solver does). Returns (x_cand, x_cur, valid) of length NF.
    """
    d = M.hamming_matrix(m.kf_desc[slot_cur], m.kf_desc[slot_cand])
    has_mp_cur = m.kf_mp[slot_cur] >= 0
    has_mp_cand = m.kf_mp[slot_cand] >= 0
    gate = (
        has_mp_cur[:, None]
        & has_mp_cand[None, :]
        & m.kf_feat_valid[slot_cur][:, None]
        & m.kf_feat_valid[slot_cand][None, :]
    )
    masked = jnp.where(gate, d, M.BIG)
    best = jnp.min(masked, axis=1)
    idx = jnp.argmin(masked, axis=1)
    # mutual + absolute threshold
    best_back = jnp.argmin(masked, axis=0)
    ok = (best <= M.TH_LOW) & (best_back[idx] == jnp.arange(d.shape[0]))

    mp_cur = jnp.clip(m.kf_mp[slot_cur], 0)
    mp_cand = jnp.clip(m.kf_mp[slot_cand][idx], 0)
    Xw_cur = m.mp_pos[mp_cur]
    Xw_cand = m.mp_pos[mp_cand]
    x_cur = jnp.einsum("ij,nj->ni", m.kf_Rcw[slot_cur], Xw_cur, precision=_HP) + m.kf_tcw[slot_cur]
    x_cand = (
        jnp.einsum("ij,nj->ni", m.kf_Rcw[slot_cand], Xw_cand, precision=_HP)
        + m.kf_tcw[slot_cand]
    )
    ok = ok & m.mp_valid[mp_cur] & m.mp_valid[mp_cand]
    return x_cand, x_cur, ok, idx.astype(jnp.int32)


@jax.jit
def _apply_correction(m, R_new, t_new, s_new):
    """Write corrected Sim3 keyframe poses and re-anchor map points.

    KF pose: Tcw = [R | t/s] (the reference's convention after essential
    graph optimization).  Map points: x_new = S_new_ref^{-1}(S_old_ref(x)),
    via each point's reference keyframe (reference ``CorrectLoop``
    `src/LoopClosing.cc:941-1014`).
    """
    ref = m.mp_ref_kf
    R_old = m.kf_Rcw[ref]
    t_old = m.kf_tcw[ref]
    # old poses are SE3 (s=1)
    x_ref = jnp.einsum("nij,nj->ni", R_old, m.mp_pos, precision=_HP) + t_old
    # invert new Sim3: x_w = (1/s) R^T (x_ref - t)
    Rn = R_new[ref]
    tn = t_new[ref]
    sn = s_new[ref]
    x_new = jnp.einsum("nji,nj->ni", Rn, x_ref - tn, precision=_HP) / sn[:, None]
    mp_pos = jnp.where(m.mp_valid[:, None], x_new, m.mp_pos)
    kf_tcw_new = t_new / s_new[:, None]
    return m._replace(
        kf_Rcw=jnp.where(m.kf_valid[:, None, None], R_new, m.kf_Rcw),
        kf_tcw=jnp.where(m.kf_valid[:, None], kf_tcw_new, m.kf_tcw),
        mp_pos=mp_pos,
    )


def _scale_fixed(slam) -> bool:
    """Reference ``mbFixScale``: scale is directly observable for
    stereo/RGB-D (metric depth) and for inertial systems once the IMU is
    initialized — their loop Sim3 and essential graph run at 6/4 DoF
    (`src/LoopClosing.cc` ctor, ``OptimizeEssentialGraph6DoF``)."""
    cfg = getattr(slam, "cfg", None)
    if cfg is not None and getattr(cfg, "bf", 0.0) > 0:
        return True
    return getattr(slam, "imu_stage", 0) >= 1


def _loop_mesh(slam):
    """Device mesh for the sharded correction, or None for one device.

    Sharding is opt-in through ``SlamConfig.loop_mesh_devices``: however
    many devices the process sees, correction stays on one unless the
    config asks for more."""
    cfg = getattr(slam, "cfg", None)
    n = getattr(cfg, "loop_mesh_devices", 1)
    if n <= 1:
        return None
    from orb_slam3_noted_tpu.parallel.dist_ba import make_mesh

    return make_mesh(n)


class LoopCloser:
    """Host-side loop-closing stage over the shared map snapshot."""

    def __init__(
        self,
        vocab: np.ndarray,
        max_keyframes: int,
        min_inliers: int = 25,
        covis_edge_weight: int = 30,
        exclude_recent: int = 10,
        enable_gba: bool = True,
        consistency_th: int = 3,
        idf: np.ndarray | None = None,
    ):
        self.db = KeyFrameDatabase(vocab, max_keyframes, idf=idf)
        self.min_inliers = min_inliers
        # post-OptimizeSim3 acceptance gate (reference nInliers >= 20,
        # `src/LoopClosing.cc:776`)
        self.sim3_min_inliers = 20
        self.covis_edge_weight = covis_edge_weight
        self.exclude_recent = exclude_recent
        self.enable_gba = enable_gba
        # required consecutive covisibility-consistent detections before a
        # candidate may correct the map (reference
        # ``mnCovisibilityConsistencyTh = 3``, 3-hit temporal consistency of
        # `src/LoopClosing.cc:356-439`)
        self.consistency_th = consistency_th
        self.consistent_groups: list[tuple[set, int]] = []
        self.loops_closed = 0
        self.last_loop_kf = -1
        # persistent loop edges: once a loop (slot, cand) is accepted it
        # stays a pose-graph constraint in every later correction
        # (reference ``KeyFrame::AddLoopEdge``)
        self.loop_edges: list[tuple[int, int]] = []
        # in-flight time-sliced GBA (single-chip analogue of the
        # reference's GBA thread); advanced by ``service_gba``
        self.active_gba = None
        # deferred SearchAndFuse targets after a correction (one fuse
        # dispatch per frame boundary)
        self._post_fuse: list[int] = []
        # temporal Sim3 path state (`DetectAndReffineSim3FromLastKF`,
        # `src/LoopClosing.cc:497`): a geometrically verified but not yet
        # accepted loop hypothesis; the next keyframe refines it by
        # PROJECTION from the propagated guess, skipping BoW entirely
        self.pending = None  # dict(cand, slot, R, t, s, hits)

    # ------------------------------------------------------------------
    def service_gba(self, slam, n_steps: int = 1):
        """Advance deferred post-correction work by one slice: first the
        queued SearchAndFuse dispatches, then the in-flight GBA.  Called by
        the system at frame boundaries — the single-chip replacement for
        the reference's background GBA thread + abort protocol."""
        if self._post_fuse:
            from orb_slam3_noted_tpu.pipeline import map_state as MS
            from orb_slam3_noted_tpu.pipeline import tracking as T

            target = self._post_fuse.pop(0)
            mask, _ = MS.local_map_mask(
                slam.m, jnp.int32(target), n_neighbors=5
            )
            slam.m = T.fuse_map_points(
                slam.m, jnp.int32(target), slam.m.mp_valid & ~mask,
                slam.cam, slam.cfg,
            )
            return False
        g = self.active_gba
        if g is None:
            return False
        for _ in range(n_steps):
            if g.done:
                break
            g.step()
        if g.done:
            slam.m = g.finish(slam.m)
            self.active_gba = None
            return True
        return False

    def finish_gba(self, slam):
        """Drain deferred fuses + the in-flight GBA completely (flush)."""
        while self._post_fuse:
            self.service_gba(slam)
        if self.active_gba is not None:
            slam.m = self.active_gba.finish(slam.m)
            self.active_gba = None
            return True
        return False

    # ------------------------------------------------------------------
    def on_keyframe(self, slam, slot: int):
        """Detect + correct a loop for the newly inserted keyframe `slot`.

        slam: the SLAM system (provides .m map arrays, .n_kf). Returns True
        if a loop was closed (slam.m replaced with the corrected snapshot).
        Synchronous wrapper over the two-phase API below.
        """
        return self.finish_detect(slam, self.start_detect(slam, slot))

    # ------------------------------------------------------------------
    def start_detect(self, slam, slot: int):
        """Enqueue the detection math on device — NO host pulls.

        The async-pipeline analogue of the reference's LoopClosing queue
        (`src/LoopClosing.cc:293` InsertKeyFrame): everything here is device
        dispatch (BoW transform, covisibility matmul, DetectNBestCandidates),
        so the caller returns immediately; ``finish_detect`` pulls the tiny
        winner arrays later, after the device has drained the mapper work.
        """
        from orb_slam3_noted_tpu.pipeline import map_state as MS
        from orb_slam3_noted_tpu.place.database import _detect_nbest

        m = slam.m
        word, bow = self.db.compute_bow(
            m.kf_desc[slot], m.kf_feat_valid[slot]
        )
        # exclusion: covisible KFs + recent window (reference excludes
        # covisibles and requires a temporal gap; src/KeyFrameDatabase.cc:611).
        covis_dev = MS.covisibility_matrix(m)
        # recency by FRAME id from the host-side mirror when the system keeps
        # one (robust to slot recycling); fallback: slot order
        fid_mirror = getattr(slam, "kf_frame_ids", None)
        KF = self.db.bow_mat.shape[0]
        recent = np.zeros(KF, bool)
        if fid_mirror is not None:
            fids = np.asarray(fid_mirror)
            live = fids >= 0
            order = np.sort(fids[live])
            if len(order):
                min_recent = order[max(0, len(order) - self.exclude_recent - 1)]
                recent = live & (fids >= min_recent)
        else:
            lo = max(0, slot - self.exclude_recent)
            recent[lo: slot + 1] = True
        recent[slot] = True
        exclude_dev = (covis_dev[slot] > 0) | jnp.asarray(recent)
        slots_dev, scores_dev = _detect_nbest(
            self.db.bow_mat, self.db.present_dev, bow, exclude_dev,
            covis_dev, 0.75, 3,
        )
        self.db.add(slot, bow)
        return {
            "slot": slot, "covis": covis_dev,
            "slots": slots_dev, "scores": scores_dev,
        }

    # ------------------------------------------------------------------
    def finish_detect(self, slam, pending) -> bool:
        """Pull detection winners, run consistency + Sim3 verify + correct."""
        return self.finish_detect_many(slam, [pending])

    def finish_detect_many(self, slam, pendings) -> bool:
        """Finish several queued detections with ONE bulk device pull.

        Detections are enqueued per keyframe but corrections are rare, so
        draining the queue at a frame boundary with a single transfer costs
        one device round trip regardless of how many keyframes landed since.
        Returns True if any loop was closed.
        """
        pulled = jax.device_get(
            [(p["slots"], p["covis"]) for p in pendings] + [slam.m.kf_valid]
        )
        kf_valid = pulled[-1]
        # keep the database in sync with keyframe culling (reference
        # ``KeyFrameDatabase::erase`` on SetBadFlag)
        for s in np.flatnonzero(self.db.present & ~kf_valid):
            self.db.erase(int(s))
        # refresh the system's recycled-slot list from the same pull
        if hasattr(slam, "_refill_free_slots"):
            slam._refill_free_slots(kf_valid)
        closed = False
        for p, (slots_np, covis_np) in zip(pendings, pulled[:-1]):
            closed |= self._finish_one(
                slam, p["slot"], slots_np, covis_np, kf_valid
            )
        return closed

    def _finish_one(self, slam, slot, slots_np, covis_np, kf_valid) -> bool:
        m = slam.m

        # --- temporal path (`DetectAndReffineSim3FromLastKF`,
        # `src/LoopClosing.cc:497-553`): a pending geometrically verified
        # hypothesis is refined by projection from the propagated Sim3
        # guess — no BoW query, no RANSAC ---
        if self.pending is not None and kf_valid[self.pending["cand"]]:
            hit = self._refine_pending(slam, slot)
            if hit is not None:
                return hit
        self.pending = None

        slots = [int(s) for s in slots_np[slots_np >= 0] if kf_valid[s]]
        if not slots:
            self.consistent_groups = []
            return False
        covis_rows = covis_np[np.asarray(slots)]

        # --- temporal consistency: a candidate place must be re-detected in
        # consecutive keyframes (groups linked by covisibility) before it
        # may correct the map.  With camera context the LAST consistency
        # hit is replaced by the geometric temporal path: the ladder runs
        # one sighting earlier and the final confirmation is a projection
        # refine from the propagated Sim3 (reference ORB-SLAM3 counts
        # Sim3-verified coincidences, `src/LoopClosing.cc:356-439`). ---
        have_cam = (
            getattr(slam, "cam", None) is not None
            and getattr(slam, "cfg", None) is not None
        )
        geo_gate = (
            self.consistency_th - 1 if have_cam else self.consistency_th
        )
        new_groups: list[tuple[set, int]] = []
        verified_cands: list[int] = []
        for ci, cand in enumerate(slots):
            grp = set(np.flatnonzero(covis_rows[ci] > 0).tolist()) | {cand}
            count = 0
            for prev_grp, prev_count in self.consistent_groups:
                if grp & prev_grp:
                    count = max(count, prev_count + 1)
            new_groups.append((grp, count))
            # count = prev_chain + 1 on a re-detection, 0 on first sight;
            # accept once the chain length reaches the threshold — matches
            # the reference accumulation exactly (nCurrentConsistency starts
            # at 0 on first sight; `src/LoopClosing.cc:400-430`)
            if count >= geo_gate:
                verified_cands.append(cand)
        self.consistent_groups = new_groups
        if not verified_cands:
            return False

        fix_scale = _scale_fixed(slam)
        for cand in verified_cands:
            x_cand, x_cur, ok, idx_cand = _matched_point_pairs(
                m, jnp.int32(slot), jnp.int32(cand)
            )
            res = sim3_ransac(
                x_cand, x_cur, ok, jax.random.PRNGKey(slot),
                fix_scale=fix_scale,
            )
            # verification ladder (reference DetectCommonRegionsFromBoW):
            # Sim3-guided projection matching grows the pair set, then the
            # 7-dof REPROJECTION optimization refines and re-gates — a
            # 3D-3D RANSAC fit alone can pass on geometry whose image
            # observations disagree (wrong loop).  Skipped for harnesses
            # without camera context (test scaffolds).
            if have_cam:
                from orb_slam3_noted_tpu.optim.sim3_opt import sim3_refine

                ref = sim3_refine(
                    m, jnp.int32(slot), jnp.int32(cand),
                    res.R, res.t, res.s, slam.cam, slam.cfg,
                    seed_idx=idx_cand, seed_ok=ok & res.inliers,
                )
                n_ok, success, n_inl, rn_inl, rR, rt, rs = jax.device_get((
                    jnp.sum(ok), res.success, res.n_inliers,
                    ref.n_inliers, ref.R, ref.t, ref.s,
                ))
                if (
                    int(n_ok) < self.min_inliers
                    or not bool(success)
                    or int(n_inl) < self.min_inliers
                    or int(rn_inl) < self.sim3_min_inliers
                ):
                    continue
                res = Sim3Result(
                    success=jnp.asarray(True), R=jnp.asarray(rR),
                    t=jnp.asarray(rt), s=jnp.asarray(rs),
                    inliers=res.inliers, n_inliers=jnp.asarray(int(rn_inl)),
                )
                if 1 < max(self.consistency_th - 1, 1):
                    # verified but not yet ripe: hand over to the temporal
                    # path — the next keyframe confirms by projection
                    self.pending = dict(
                        cand=cand, slot=slot, R=res.R, t=res.t, s=res.s,
                        hits=1,
                    )
                    return False
            else:
                n_ok, success, n_inl = jax.device_get(
                    (jnp.sum(ok), res.success, res.n_inliers)
                )
                if (
                    int(n_ok) < self.min_inliers
                    or not bool(success)
                    or int(n_inl) < self.min_inliers
                ):
                    continue
            self._accept(slam, slot, cand, res, covis_np)
            return True
        return False

    # ------------------------------------------------------------------
    def _accept(self, slam, slot, cand, res, covis=None):
        """Run the correction and record the accepted loop."""
        from orb_slam3_noted_tpu.utils.timing import GLOBAL_TIMER

        with GLOBAL_TIMER.stage("loop_correct"):
            self._correct(slam, slot, cand, res, covis=covis)
        self.loop_edges.append((slot, cand))
        self.loops_closed += 1
        self.last_loop_kf = slot
        self.consistent_groups = []
        self.pending = None

    # ------------------------------------------------------------------
    def _refine_pending(self, slam, slot) -> bool | None:
        """`DetectAndReffineSim3FromLastKF` (`src/LoopClosing.cc:497-553`):
        refine the pending loop hypothesis against the current keyframe by
        projecting with the propagated Sim3 guess — no BoW, no RANSAC.

        Returns True (loop accepted+corrected), False (hypothesis advanced,
        BoW skipped this keyframe), or None (refine failed — hypothesis
        dropped, caller falls back to the BoW path).
        """
        cam = getattr(slam, "cam", None)
        cfg = getattr(slam, "cfg", None)
        if cam is None or cfg is None:
            return None
        from orb_slam3_noted_tpu.geometry import sim3 as sim3_mod
        from orb_slam3_noted_tpu.optim.sim3_opt import sim3_refine

        m = slam.m
        p = self.pending
        # propagate through the relative motion since the hypothesis' KF:
        # S_new = (T_new o T_prev^-1) o S_prev
        Rn, tn = m.kf_Rcw[slot], m.kf_tcw[slot]
        Rp, tp = m.kf_Rcw[p["slot"]], m.kf_tcw[p["slot"]]
        R_rel = jnp.einsum("ij,kj->ik", Rn, Rp, precision=_HP)
        t_rel = tn - R_rel @ tp
        one = jnp.asarray(1.0, tn.dtype)
        Rg, tg, sg = sim3_mod.compose(
            (R_rel, t_rel, one), (p["R"], p["t"], p["s"])
        )
        ref = sim3_refine(
            m, jnp.int32(slot), jnp.int32(p["cand"]), Rg, tg, sg, cam, cfg
        )
        n_inl, rR, rt, rs = jax.device_get(
            (ref.n_inliers, ref.R, ref.t, ref.s)
        )
        if int(n_inl) < self.sim3_min_inliers:
            return None
        hits = p["hits"] + 1
        res = Sim3Result(
            success=jnp.asarray(True), R=jnp.asarray(rR),
            t=jnp.asarray(rt), s=jnp.asarray(rs),
            inliers=jnp.zeros(m.kf_xy.shape[1], bool),
            n_inliers=jnp.asarray(int(n_inl)),
        )
        if hits >= max(self.consistency_th - 1, 1):
            self._accept(slam, slot, p["cand"], res)
            return True
        self.pending = dict(
            cand=p["cand"], slot=slot, R=res.R, t=res.t, s=res.s, hits=hits,
        )
        return False

    # ------------------------------------------------------------------
    def _correct(self, slam, slot: int, cand: int, res, covis=None):
        m = slam.m
        KF = m.kf_Rcw.shape[0]
        kf_valid = np.asarray(m.kf_valid)

        # --- build edge list (vectorized numpy; covis computed on device) ---
        if covis is None:
            from orb_slam3_noted_tpu.pipeline import map_state as MS

            covis = np.asarray(MS.covisibility_matrix(m))
        # spanning-tree edges (reference essential graph: tree + strong
        # covisibility + loop edges, `src/Optimizer.cc:2083`); the tree is
        # maintained at insertion/culling so it stays correct when recycled
        # slots break temporal slot order
        parent = np.asarray(m.kf_parent)
        child = np.flatnonzero(
            (parent >= 0) & kf_valid & kf_valid[np.maximum(parent, 0)]
        )
        ei = list(child.astype(int))
        ej = list(parent[child].astype(int))
        # strong covisibility edges
        cv = np.asarray(covis)
        ii, jj = np.nonzero(np.triu(cv) >= self.covis_edge_weight)
        keep = kf_valid[ii] & kf_valid[jj]
        ei += list(ii[keep].astype(int))
        ej += list(jj[keep].astype(int))
        # previous loop edges persist across corrections (reference
        # ``KeyFrame::AddLoopEdge``, `include/KeyFrame.h:108-113`)
        for a, b in self.loop_edges:
            if kf_valid[a] and kf_valid[b]:
                ei.append(a); ej.append(b)
        n_real = len(ei)

        # measurements from CURRENT (drifted) estimates: S_ji = T_j * T_i^-1
        R_all = m.kf_Rcw
        t_all = m.kf_tcw
        s_all = jnp.ones(KF, m.kf_tcw.dtype)
        i_arr = jnp.asarray(ei + [cand], jnp.int32)
        j_arr = jnp.asarray(ej + [slot], jnp.int32)
        weight = jnp.ones(n_real + 1, jnp.float32).at[-1].set(float(n_real) / 4 + 1.0)
        fixed = jnp.zeros(KF, bool).at[cand].set(True)
        # freeze invalid slots too (no edges touch them, but keep H regular)
        fixed = fixed | ~jnp.asarray(kf_valid)

        # gravity-aligned inertial map: yaw+translation essential graph
        # (reference selects ``OptimizeEssentialGraph4DoF`` for inertial
        # maps, `src/LoopClosing.cc:1072-1081` — a Sim3/SE3 graph would let
        # the loop correction tilt the observable gravity direction)
        inertial_4dof = getattr(slam, "imu_stage", 0) >= 1
        if inertial_4dof:
            from orb_slam3_noted_tpu.geometry import se3
            from orb_slam3_noted_tpu.optim.pose_graph import (
                SE3Edges, optimize_pose_graph_4dof,
            )

            Ti = (R_all[i_arr[:-1]], t_all[i_arr[:-1]])
            Tj = (R_all[j_arr[:-1]], t_all[j_arr[:-1]])
            Rr, tr = jax.vmap(
                lambda a, b: se3.compose(b, se3.inverse(a))
            )(Ti, Tj)
            # loop Sim3 ran with fix_scale (IMU gives metric scale): s == 1
            eR = jnp.concatenate([Rr, res.R[None]])
            et = jnp.concatenate([tr, (res.t / res.s)[None]])
            edges4 = SE3Edges(
                i=i_arr, j=j_arr, R=eR, t=et, weight=weight,
                valid=jnp.ones(n_real + 1, bool),
            )
            R_new, t_new, cost = optimize_pose_graph_4dof(
                R_all, t_all, edges4, fixed
            )
            s_new = s_all
        else:
            Si = (R_all[i_arr[:-1]], t_all[i_arr[:-1]], s_all[i_arr[:-1]])
            Sj = (R_all[j_arr[:-1]], t_all[j_arr[:-1]], s_all[j_arr[:-1]])
            Rr, tr, sr = jax.vmap(
                lambda a, b: sim3.compose(b, sim3.inverse(a))
            )(Si, Sj)

            # loop edge: S_cur_cand from the Sim3 solver (maps candidate-frame
            # points into the current frame): S_cur_w_corrected = S_loop o T_cand_w
            eR = jnp.concatenate([Rr, res.R[None]])
            et = jnp.concatenate([tr, res.t[None]])
            es = jnp.concatenate([sr, res.s[None]])
            edges = Sim3Edges(
                i=i_arr, j=j_arr, R=eR, t=et, s=es,
                weight=weight,
                valid=jnp.ones(n_real + 1, bool),
            )

            mesh = _loop_mesh(slam)
            if mesh is not None:
                # edge table sharded over the mesh (distributed essential
                # graph, SURVEY §2.3)
                from orb_slam3_noted_tpu.optim.pose_graph import (
                    distributed_pose_graph_sim3,
                )

                R_new, t_new, s_new, cost = distributed_pose_graph_sim3(
                    mesh, R_all, t_all, s_all, edges, fixed,
                    fix_scale=_scale_fixed(slam),
                )
            else:
                R_new, t_new, s_new, cost = optimize_pose_graph_sim3(
                    R_all, t_all, s_all, edges, fixed,
                    fix_scale=_scale_fixed(slam),
                )
        slam.m = _apply_correction(m, R_new, t_new, s_new)

        # rotate per-keyframe body velocities by the world-side correction
        # (reference ``CorrectLoop`` updates KF velocities through the
        # corrected Sim3): R_wc_new = Rdelta @ R_wc_old with
        # Rdelta = R_new^T R_old, so world vectors transform by Rdelta.
        if inertial_4dof and getattr(slam, "ki", None) is not None:
            from orb_slam3_noted_tpu.pipeline.inertial_mapping import (
                KFInertial,
            )

            Rdelta = jnp.einsum("kji,kjl->kil", R_new, R_all, precision=_HP)
            vel_rot = jnp.einsum(
                "kij,kj->ki", Rdelta, slam.ki.vel, precision=_HP
            )
            slam.ki = KFInertial(
                vel=jnp.where(
                    jnp.asarray(kf_valid)[:, None], vel_rot, slam.ki.vel
                ),
                bg=slam.ki.bg, ba=slam.ki.ba,
            )
            slam.cur_vel = slam.ki.vel[slot]

        # SearchAndFuse (`src/LoopClosing.cc:1872`): with poses corrected,
        # project the map into the loop-side keyframes and merge the
        # duplicate landmarks the drift created.  DEFERRED: one fuse
        # dispatch per frame boundary (service_gba) so the correction
        # batch's device queue stays short — the reference also runs this
        # on its LoopClosing thread, off the tracking path
        if getattr(slam, "cfg", None) is not None:
            self._post_fuse.extend([cand, slot])

        # global BA after the pose-graph correction (reference spawns a GBA
        # thread from CorrectLoop, `src/LoopClosing.cc:1090-1097`); the
        # matrix-free Schur/PCG engine runs at full-map scale, so no
        # "<200 KFs" escape hatch is needed.  Inertial maps run
        # FullInertialBA over the temporal chain instead (reference
        # ``RunGlobalBundleAdjustment`` selects FullInertialBA,
        # `src/LoopClosing.cc:2018-2045`) — a visual-only GBA would drag
        # poses away from the gravity-consistent inertial solution.
        if inertial_4dof and hasattr(slam, "_chain_ba"):
            slam._chain_ba(window=None, n_iters=8)
        elif self.enable_gba and getattr(slam, "cfg", None) is not None:
            from orb_slam3_noted_tpu.optim.gba import (
                SlicedGBA, run_global_ba_mesh,
            )

            mesh = _loop_mesh(slam)
            if mesh is not None:
                # mesh-sharded GBA when the config asks for several
                # devices; one device uses the time-sliced engine below
                slam.m, _ = run_global_ba_mesh(
                    slam.m, slam.cam, slam.cfg, mesh,
                    bf=slam.cfg.bf, n_iters=6, n_iters_final=4,
                )
            else:
                # time-sliced GBA (round-4): the reference's GBA thread
                # becomes one LM slice per frame boundary — tracking
                # resumes immediately after the pose graph; deltas merge
                # at convergence (``service_gba``/``finish``)
                self.active_gba = SlicedGBA(
                    slam.m, slam.cam, slam.cfg, bf=slam.cfg.bf,
                    n_iters=6, n_iters_final=4,
                )  # slices run at frame boundaries via service_gba
        # tracking continues from the corrected pose of the LAST TRACKED
        # FRAME — re-anchored through the loop keyframe's correction (its
        # own pose can be many frames stale; round-5 found that resetting
        # to it dropped tracking for ~60 frames after an otherwise good
        # correction).  T_last_new = (T_last_old ∘ T_kf_old^-1) ∘ T_kf_new.
        R_rel = jnp.einsum(
            "ij,kj->ik", slam.last_Rcw, R_all[slot], precision=_HP
        )
        t_rel = slam.last_tcw - R_rel @ t_all[slot]
        Rk_new = slam.m.kf_Rcw[slot]
        tk_new = slam.m.kf_tcw[slot]
        slam.last_Rcw = R_rel @ Rk_new
        slam.last_tcw = R_rel @ tk_new + t_rel
        # the frame-to-frame motion model is a RELATIVE transform — it
        # survives the (rigid-ish) correction; keep it
