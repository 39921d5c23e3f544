"""Monocular tracking + synchronous local mapping.

Functional re-design of the reference's Tracking thread
(`/root/reference/src/Tracking.cc` ``Track`` `:1655`) and the parts of
LocalMapping it needs (`src/LocalMapping.cc`: ``CreateNewMapPoints`` `:402`,
``LocalBundleAdjustment``): a host-side state machine around fully jitted
steps.  As in SURVEY §7 phase E, local mapping runs synchronously interleaved
at first; the pipelined/async version comes with the multi-stage scheduler.

Per-frame hot path (all one jit each):
- :func:`project_map_points` — frustum + scale-range visibility for every
  map point at once (``Frame::isInFrustum``, `src/Frame.cc`).
- :func:`track_frame` — projection-gated matching + motion-only pose
  optimization (``TrackWithMotionModel``+``TrackLocalMap``).
- :func:`triangulate_between` — epipolar-gated descriptor matching and
  two-view triangulation of still-unbound features between two keyframes.
- :func:`local_ba` — windowed BA over the top covisible keyframes, landmarks
  marginalized (Schur) against the full fixed-capacity point table.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import se3, so3
from orb_slam3_noted_tpu.geometry.triangulation import triangulate_dlt
from orb_slam3_noted_tpu.geometry.twoview import reconstruct_two_views
from orb_slam3_noted_tpu.io.config import SlamConfig
from orb_slam3_noted_tpu.models import cameras as cam_mod
from orb_slam3_noted_tpu.ops import matching as M
from orb_slam3_noted_tpu.ops import orb as O
from orb_slam3_noted_tpu.optim import factors
from orb_slam3_noted_tpu.optim.ba import BAProblem, bundle_adjust
from orb_slam3_noted_tpu.optim.pose_opt import PoseObs, pose_optimization
from orb_slam3_noted_tpu.pipeline import map_state as MS

_HP = jax.lax.Precision.HIGHEST


def _second_camera(cfg: SlamConfig):
    """(cam2, Rrl, trl) for two-camera residuals, or (None, None, None).

    Converts the config's Tlr (right camera IN the left frame) to the
    left->right transform the factor needs: x_r = Rlr^T (x_l - tlr).
    """
    if cfg.camera2 is None:
        return None, None, None
    import numpy as _np

    Rlr = (
        _np.asarray(cfg.tlr_r, _np.float32).reshape(3, 3)
        if cfg.tlr_r else _np.eye(3, dtype=_np.float32)
    )
    tlr = _np.asarray(cfg.tlr_t, _np.float32)
    Rrl = Rlr.T
    trl = -Rlr.T @ tlr
    return cfg.camera2, jnp.asarray(Rrl), jnp.asarray(trl)


# ---------------------------------------------------------------------------
# visibility + tracking
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cam", "width", "height", "n_levels", "scale_factor"))
def project_map_points(
    m: MS.MapArrays,
    Rcw: jnp.ndarray,
    tcw: jnp.ndarray,
    cam: cam_mod.Camera,
    width: int,
    height: int,
    n_levels: int = 8,
    scale_factor: float = 1.2,
):
    """uv, predicted level, visibility for ALL map points (batched isInFrustum)."""
    xc = jnp.einsum("ij,mj->mi", Rcw, m.mp_pos, precision=_HP) + tcw
    uv = cam_mod.project(cam, xc)
    z_ok = xc[:, 2] > 0.05
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    )
    # distance within scale-invariance range (reference isInFrustum)
    cam_center = -jnp.einsum("ji,j->i", Rcw, tcw, precision=_HP)
    d = jnp.linalg.norm(m.mp_pos - cam_center, axis=-1)
    dist_ok = (d >= 0.8 * m.mp_dmin) & (d <= 1.2 * m.mp_dmax)
    # viewing angle < 60 deg of the mean normal
    view = (m.mp_pos - cam_center) / jnp.maximum(d, 1e-9)[:, None]
    cos_view = jnp.sum(view * m.mp_normal, axis=-1)
    angle_ok = cos_view > 0.5
    # predicted octave from distance (reference MapPoint::PredictScale)
    ratio = jnp.maximum(m.mp_dmax / jnp.maximum(d, 1e-9), 1.0)
    level = jnp.clip(
        jnp.ceil(jnp.log(ratio) / np.log(scale_factor)).astype(jnp.int32),
        0,
        n_levels - 1,
    )
    visible = m.mp_valid & z_ok & in_img & dist_ok & angle_ok
    return uv, level, visible


def match_local_map(
    m: MS.MapArrays,
    feats: O.FrameFeatures,
    Rcw_pred: jnp.ndarray,
    tcw_pred: jnp.ndarray,
    local_mp_mask: jnp.ndarray,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    feat_uvr: jnp.ndarray | None = None,
    radius_scale: float | jnp.ndarray = 1.0,
    max_dist: int = M.TH_HIGH,
    feat_uv2: jnp.ndarray | None = None,
):
    """Project local map points into the frame and associate features.

    The matching half of ``Tracking::TrackLocalMap`` (reference
    ``SearchLocalPoints`` + ``ORBmatcher::SearchByProjection``
    `/root/reference/src/ORBmatcher.cc:44`).  Returns (obs: PoseObs indexed
    per map point, f_idx (MP,) matched feature per map point, vis (MP,)).

    ``feat_uv2``: optional (NF, 2) right-camera pixel per feature (fisheye
    stereo) — matched features with one become two-camera observations.
    """
    uv_pred, level_pred, visible = project_map_points(
        m, Rcw_pred, tcw_pred, cam, cfg.width, cfg.height,
        cfg.n_levels, cfg.scale_factor,
    )
    vis = visible & local_mp_mask
    sf = jnp.asarray(O.scale_factors(cfg.n_levels, cfg.scale_factor), uv_pred.dtype)
    radius = cfg.search_radius_px * radius_scale * sf[level_pred]
    mm = M.search_by_projection(
        uv_pred, radius, level_pred,
        m.mp_desc, vis,
        feats.xy, feats.level, feats.desc, feats.valid,
        max_dist=max_dist, ratio=cfg.nn_ratio_track,
    )
    mm = M.resolve_duplicates(mm, feats.xy.shape[0])

    # per-map-point observation of the matched feature
    matched = mm.idx >= 0
    f_idx = jnp.clip(mm.idx, 0)
    sigma2 = jnp.asarray(cfg.level_sigma2, uv_pred.dtype)
    if feat_uvr is not None:
        uvr = feat_uvr[f_idx]
        is_st = matched & (uvr >= 0)
    else:
        uvr = jnp.full_like(uv_pred[:, 0], -1.0)
        is_st = jnp.zeros_like(matched)
    if feat_uv2 is not None:
        uv2 = feat_uv2[f_idx]
        is_right = matched & (uv2[:, 0] >= 0)
    else:
        uv2 = None
        is_right = None
    obs = PoseObs(
        uv=feats.xy[f_idx],
        uv_r=uvr,
        inv_sigma2=1.0 / sigma2[feats.level[f_idx]],
        is_stereo=is_st,
        valid=matched,
        uv2=uv2,
        is_right=is_right,
    )
    return obs, f_idx, vis


@partial(jax.jit, static_argnames=("cam", "cfg", "bf"))
def track_frame(
    m: MS.MapArrays,
    feats: O.FrameFeatures,
    Rcw_pred: jnp.ndarray,
    tcw_pred: jnp.ndarray,
    local_mp_mask: jnp.ndarray,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    feat_uvr: jnp.ndarray | None = None,
    bf: float = 0.0,
    feat_uv2: jnp.ndarray | None = None,
):
    """Match local map points into the frame and optimize the pose.

    For stereo frames pass ``feat_uvr`` (right-u per feature, -1 for mono
    features) and ``bf``; matched features with a valid right coordinate
    become 3-row stereo observations (reference ``EdgeStereoOnlyPose``).
    Returns (Rcw, tcw, n_inliers, mp_of_feature (NF,) int32).
    """
    MP = m.mp_pos.shape[0]
    # matched rows never exceed NF (one feature binds one point); round up
    # to a power of two for kernel-shape reuse across configs
    NF_cap = feats.xy.shape[0]
    NC = min(MP, max(2048, 1 << (NF_cap - 1).bit_length()))

    cam2, Rrl, trl = _second_camera(cfg)

    def _optimize_compact(obs, R0, t0):
        """Pose opt on a compacted observation table.

        The per-map-point obs table is MP rows but only the matched few
        hundred matter; 20 sequential GN kernels over MP rows would read
        every row each time, so gather the matched rows into a
        fixed NC-row table first and scatter inliers back.
        """
        _, sel = jax.lax.top_k(obs.valid.astype(jnp.int32), NC)
        obs_c = PoseObs(
            uv=obs.uv[sel], uv_r=obs.uv_r[sel],
            inv_sigma2=obs.inv_sigma2[sel], is_stereo=obs.is_stereo[sel],
            valid=obs.valid[sel],
            uv2=None if obs.uv2 is None else obs.uv2[sel],
            is_right=None if obs.is_right is None else obs.is_right[sel],
        )
        res = pose_optimization(cam, R0, t0, m.mp_pos[sel], obs_c, bf=bf,
                                cam2=cam2, Rrl=Rrl, trl=trl)
        inl_full = jnp.zeros(MP, bool).at[sel].max(res.inliers & obs_c.valid)
        return res._replace(inliers=inl_full)

    obs, f_idx, vis = match_local_map(
        m, feats, Rcw_pred, tcw_pred, local_mp_mask, cam, cfg,
        feat_uvr=feat_uvr, feat_uv2=feat_uv2,
    )
    res = _optimize_compact(obs, Rcw_pred, tcw_pred)

    # Fallback when the narrow search fails: re-match with a 3x radius and
    # relaxed level window, then re-optimize — the batched analogue of the
    # reference's wider-window retry / TrackReferenceKeyFrame rescue
    # (`/root/reference/src/Tracking.cc:1795-1888`, `ORBmatcher` th*2 paths).
    # lax.cond keeps the extra matmul off the hot path when tracking is good.
    def _retry(args):
        res0 = args
        good_seed = res0.n_inliers >= 10
        Rs = jnp.where(good_seed, res0.Rcw, Rcw_pred)
        ts = jnp.where(good_seed, res0.tcw, tcw_pred)
        obs2, f_idx2, vis2 = match_local_map(
            m, feats, Rs, ts, local_mp_mask, cam, cfg,
            feat_uvr=feat_uvr, radius_scale=3.0, feat_uv2=feat_uv2,
        )
        res2 = _optimize_compact(obs2, Rs, ts)
        use2 = res2.n_inliers > res0.n_inliers
        sel = lambda a, b: jax.tree_util.tree_map(
            lambda x, y: jnp.where(use2, x, y), a, b
        )
        return sel(res2, res0), sel(obs2, obs), sel(f_idx2, f_idx), sel(vis2, vis)

    res, obs, f_idx, vis = jax.lax.cond(
        res.n_inliers < 25, _retry,
        lambda args: (args, obs, f_idx, vis), res,
    )
    matched = obs.valid

    # mp id per frame feature (for keyframe binding): invert the matching.
    # Non-kept entries scatter into a scratch slot (NF) that is sliced away.
    NF = feats.xy.shape[0]
    src_mp = jnp.arange(m.mp_pos.shape[0], dtype=jnp.int32)
    keep = matched & res.inliers
    tgt = jnp.where(keep, f_idx, NF)
    mp_of_feat = jnp.full((NF + 1,), -1, jnp.int32).at[tgt].set(src_mp)[:NF]
    # visibility bookkeeping (reference MapPoint::IncreaseVisible/Found,
    # consumed by MapPointCulling's found/visible ratio)
    return res.Rcw, res.tcw, res.n_inliers, mp_of_feat, vis, keep


# ---------------------------------------------------------------------------
# new map points between two keyframes
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cam", "cfg"))
def triangulate_between(
    m: MS.MapArrays,
    slot_a: jnp.ndarray,
    slot_b: jnp.ndarray,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
):
    """Match unbound features of KF a against KF b and triangulate.

    Equivalent of ``LocalMapping::CreateNewMapPoints`` +
    ``ORBmatcher::SearchForTriangulation`` (epipolar-gated descriptor match)
    + the cheirality/parallax/reprojection acceptance gates.

    Returns (pos_w, desc, normal, dmin, dmax, feat_a, feat_b, accept) with
    static length NF (one candidate per unbound feature of KF a).
    """
    NF = m.kf_xy.shape[1]
    Ra, ta = m.kf_Rcw[slot_a], m.kf_tcw[slot_a]
    Rb, tb = m.kf_Rcw[slot_b], m.kf_tcw[slot_b]
    # relative pose b<-a : x_b = Rba x_a + tba
    Rba = Rb @ Ra.T
    tba = tb - jnp.einsum("ij,j->i", Rba, ta, precision=_HP)

    free_a = m.kf_feat_valid[slot_a] & (m.kf_mp[slot_a] < 0)
    free_b = m.kf_feat_valid[slot_b] & (m.kf_mp[slot_b] < 0)
    rays_a = cam_mod.unproject(cam, m.kf_xy[slot_a])
    rays_b = cam_mod.unproject(cam, m.kf_xy[slot_b])

    # descriptor distances with epipolar gating (Sampson in normalized coords)
    d = M.hamming_matrix(m.kf_desc[slot_a], m.kf_desc[slot_b])
    E = so3.hat(tba) @ Rba
    Ex1 = jnp.einsum("ij,nj->ni", E, rays_a, precision=_HP)      # (NF, 3)
    Etx2 = jnp.einsum("ji,nj->ni", E, rays_b, precision=_HP)
    # r_b^T E r_a for all pairs, laid out (a, b)
    x2Ex1 = jnp.einsum("bi,ai->ab", rays_b, Ex1, precision=_HP)
    denom = (
        (Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2)[:, None]
        + (Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2)[None, :]
    )
    sampson = x2Ex1 ** 2 / jnp.maximum(denom, 1e-12)
    fx = cam.fx
    epi_ok = sampson < (3.84 / (fx * fx))

    gate = free_a[:, None] & free_b[None, :] & epi_ok
    masked = jnp.where(gate, d, M.BIG)
    best = jnp.min(masked, axis=1)
    idx_b = jnp.argmin(masked, axis=1).astype(jnp.int32)
    ok = (best <= M.TH_LOW) & free_a
    # mutual best
    best_for_b = jnp.argmin(masked, axis=0)
    ok = ok & (best_for_b[idx_b] == jnp.arange(NF))

    ra = rays_a
    rb = rays_b[idx_b]
    pts_a = triangulate_dlt(ra, rb, Rba, tba)
    za = pts_a[:, 2]
    pb = pts_a @ Rba.T + tba
    zb = pb[:, 2]
    # acceptance: cheirality, parallax, reprojection in both views
    za_s = jnp.where(jnp.abs(za) < 1e-9, 1e-9, za)
    zb_s = jnp.where(jnp.abs(zb) < 1e-9, 1e-9, zb)
    e_a = jnp.sum((pts_a[:, :2] / za_s[:, None] - ra[:, :2]) ** 2, axis=-1)
    e_b = jnp.sum((pb[:, :2] / zb_s[:, None] - rb[:, :2]) ** 2, axis=-1)
    reproj_ok = (e_a < 2 * 3.84 / (fx * fx)) & (e_b < 2 * 3.84 / (fx * fx))
    cam_b_in_a = -jnp.einsum("ji,j->i", Rba, tba, precision=_HP)
    v1 = pts_a
    v2 = pts_a - cam_b_in_a
    cosp = jnp.sum(v1 * v2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(v1, axis=-1) * jnp.linalg.norm(v2, axis=-1), 1e-12
    )
    accept = ok & (za > 0.05) & (zb > 0.05) & (cosp < 0.9998) & reproj_ok

    # to world: x_w = Ra^T (x_a - ta)
    pos_w = jnp.einsum("ji,nj->ni", Ra, pts_a - ta, precision=_HP)
    # normal/scale range from KF a viewing geometry (reference
    # MapPoint::UpdateNormalAndDepth)
    cam_a_center = -jnp.einsum("ji,j->i", Ra, ta, precision=_HP)
    vecs = pos_w - cam_a_center
    dist = jnp.linalg.norm(vecs, axis=-1)
    normal = vecs / jnp.maximum(dist, 1e-9)[:, None]
    sf = jnp.asarray(O.scale_factors(cfg.n_levels, cfg.scale_factor), pos_w.dtype)
    lvl = m.kf_level[slot_a]
    dmax = dist * sf[lvl]
    dmin = dmax / sf[cfg.n_levels - 1]
    desc = m.kf_desc[slot_a]
    return pos_w, desc, normal, dmin, dmax, jnp.arange(NF, dtype=jnp.int32), idx_b, accept


@partial(jax.jit, static_argnames=("cam",))
def init_attempt_batch(ref, feats_all, cam, key):
    """Two-view initialization attempts of one reference frame against a
    whole batch of candidate frames — ONE device dispatch.

    The per-frame path (``MonoSLAM._try_initialize``) costs ~300 ms per
    attempt (matching + dual H/E RANSAC + a host sync each); during bench
    startup 4 attempts burned 31% of the wall clock.  Batch the attempts:
    vmapped Hamming matching + ``reconstruct_two_views`` over all B
    candidates, one bulk pull, and the host walks the per-frame outcomes in
    order (reference ``Tracking::MonocularInitialization``,
    `/root/reference/src/Tracking.cc:2167`).

    Returns (n_matches (B,), success (B,), good (B, N), points1 (B, N, 3),
    R21 (B, 3, 3), t21 (B, 3), idx (B, N)).
    """
    B = feats_all.xy.shape[0]
    rays1 = cam_mod.unproject(cam, ref.xy)
    fx = cam.fx

    def one(feats, k):
        d = M.hamming_matrix(ref.desc, feats.desc)
        mm = M.match_nn(
            d, ref.valid, feats.valid, max_dist=M.TH_LOW, ratio=0.9,
            mutual=True, ang_a=ref.angle, ang_b=feats.angle,
        )
        idx = mm.idx
        matched = idx >= 0
        rays2 = cam_mod.unproject(cam, feats.xy[jnp.clip(idx, 0)])
        res = reconstruct_two_views(
            rays1, rays2, matched, k, err_thresh=3.84 / (fx * fx),
        )
        return (jnp.sum(matched), res.success, res.is_inlier,
                res.points1, res.R21, res.t21, idx)

    keys = jax.random.split(key, B)
    return jax.vmap(one)(feats_all, keys)


@partial(jax.jit, static_argnames=("cam", "cfg", "bf"))
def track_step(
    m: MS.MapArrays,
    img_u8: jnp.ndarray,
    last_kf_slot: jnp.ndarray,
    Rcw_pred: jnp.ndarray,
    tcw_pred: jnp.ndarray,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    bf: float = 0.0,
):
    """Fused per-frame step: ONE device dispatch for the tracking hot path.

    uint8 image in (cheap host->device transfer over thin links), then
    extract + local-map visibility + projection matching + pose optimization
    without host round-trips.  Returns (feats, Rcw, tcw, n_inliers,
    mp_of_feat); only n_inliers needs a host sync for the state machine.
    """
    img = img_u8.astype(jnp.float32)
    feats = O.extract_orb(
        img,
        n_features=cfg.n_features,
        n_levels=cfg.n_levels,
        scale_factor=cfg.scale_factor,
        th_high=cfg.ini_th_fast,
        th_low=cfg.min_th_fast,
    )
    mp_mask, _ = MS.local_map_mask(m, last_kf_slot, n_neighbors=cfg.local_window)
    Rcw, tcw, n_inl, mp_of_feat, vis, found = track_frame(
        m, feats, Rcw_pred, tcw_pred, mp_mask, cam, cfg, feat_uvr=None, bf=bf
    )
    m = m._replace(
        mp_visible=m.mp_visible + vis.astype(jnp.int32),
        mp_found=m.mp_found + found.astype(jnp.int32),
    )
    return m, feats, Rcw, tcw, n_inl, mp_of_feat


@partial(jax.jit, static_argnames=("cam", "cfg", "bf"))
def track_batch(
    m: MS.MapArrays,
    imgs_u8: jnp.ndarray,       # (B, H, W) uint8
    last_kf_slot: jnp.ndarray,  # () int32
    Rcw0: jnp.ndarray,
    tcw0: jnp.ndarray,
    vel0: tuple,                # (R (3,3), t (3,)) relative motion or identity
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    bf: float = 0.0,
    count_mask: jnp.ndarray | None = None,
):
    """Track a whole batch of frames in ONE device dispatch (lax.scan).

    The throughput mode: per-frame host round-trips would dominate wall
    time, so B frames scan on-device with the constant-velocity
    model threaded through the carry; the host syncs once per batch.
    Keyframe insertion happens between dispatches, at the FRAME that needs
    it: per-frame features/bindings are returned for the whole batch so the
    host can promote any frame to a keyframe (a bounded-delay version of the
    reference's asynchronous keyframe insertion).

    ``count_mask`` (B,) gates the per-frame visible/found counter updates —
    padding and already-committed frames must not bias MapPointCulling's
    found/visible ratio.

    Returns (m, Rcw (B,3,3), tcw (B,3), n_inl (B,), feats of ALL frames
    (leading B axis), mp_of_feat (B, NF)).
    """
    # batched extraction FIRST (one wide dispatch per dense kernel — ~3x the
    # per-frame in-scan extraction), then the sequential tracking scan
    feats_all = O.extract_orb_batch(
        imgs_u8.astype(jnp.float32),
        n_features=cfg.n_features, n_levels=cfg.n_levels,
        scale_factor=cfg.scale_factor,
        th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast,
    )
    return _track_scan(
        m, feats_all, lambda f: f, last_kf_slot, Rcw0, tcw0, vel0, cam, cfg,
        bf, count_mask,
    )


@partial(jax.jit, static_argnames=("cam", "cfg", "bf"))
def track_batch_feats(
    m: MS.MapArrays,
    feats_all: O.FrameFeatures,  # (B, ...) stacked features (already extracted)
    last_kf_slot: jnp.ndarray,
    Rcw0: jnp.ndarray,
    tcw0: jnp.ndarray,
    vel0: tuple,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    bf: float = 0.0,
    count_mask: jnp.ndarray | None = None,
):
    """Re-track already-extracted frames against an updated map.

    Used after a mid-batch keyframe insertion: extraction is ~3/4 of the
    per-frame cost and the features do not change, so the remaining frames
    of a batch re-run matching + pose optimization only.
    """
    return _track_scan(
        m, feats_all, lambda f: f, last_kf_slot, Rcw0, tcw0, vel0, cam, cfg,
        bf, count_mask,
    )


def _track_scan(m, xs, to_feats, last_kf_slot, Rcw0, tcw0, vel0, cam, cfg,
                bf, count_mask=None, uvr_all=None):
    mp_mask, _ = MS.local_map_mask(m, last_kf_slot, n_neighbors=cfg.local_window)
    MP = m.mp_pos.shape[0]
    B = jax.tree_util.tree_leaves(xs)[0].shape[0]
    if count_mask is None:
        count_mask = jnp.ones(B, bool)
    has_uvr = uvr_all is not None
    if not has_uvr:
        uvr_all = jnp.zeros((B, 1), jnp.float32)  # placeholder for the scan

    def step(carry, xc):
        x, uvr, cm = xc
        Rprev, tprev, Rv, tv, vis_c, found_c = carry
        Rp, tp = se3.compose((Rv, tv), (Rprev, tprev))
        feats = to_feats(x)
        Rcw, tcw, n_inl, mp_of_feat, vis, found = track_frame(
            m, feats, Rp, tp, mp_mask, cam, cfg,
            feat_uvr=uvr if has_uvr else None, bf=bf,
        )
        ok = n_inl >= cfg.min_tracked_points
        # velocity update only when tracking succeeded; else keep prediction
        Rv_new, tv_new = se3.compose((Rcw, tcw), se3.inverse((Rprev, tprev)))
        Rv = jnp.where(ok, Rv_new, Rv)
        tv = jnp.where(ok, tv_new, tv)
        Rout = jnp.where(ok, Rcw, Rp)
        tout = jnp.where(ok, tcw, tp)
        vis_c = vis_c + (vis & cm).astype(jnp.int32)
        found_c = found_c + (found & cm).astype(jnp.int32)
        return (Rout, tout, Rv, tv, vis_c, found_c), (
            Rout, tout, n_inl, feats, mp_of_feat
        )

    z = jnp.zeros(MP, jnp.int32)
    carry0 = (Rcw0, tcw0, vel0[0], vel0[1], z, z)
    (_, _, _, _, vis_c, found_c), (Rs, ts, n_inls, feats_all, mp_feats) = (
        jax.lax.scan(step, carry0, (xs, uvr_all, count_mask))
    )
    m = m._replace(mp_visible=m.mp_visible + vis_c, mp_found=m.mp_found + found_c)
    return m, Rs, ts, n_inls, feats_all, mp_feats


def _stereo_frontend(imgsL_u8, imgsR_u8, cam, cfg, bf):
    """Batched left+right extraction + rectified SAD stereo matching.

    Shared by the visual and visual-inertial batched trackers (the batched
    form of the reference's dual extraction threads, `src/Frame.cc:119-122`,
    plus ``Frame::ComputeStereoMatches`` `src/Frame.cc:794`).
    Returns (featsL (B-leading), uvr (B, NF), depth (B, NF)).
    """
    from orb_slam3_noted_tpu.ops import image as image_ops
    from orb_slam3_noted_tpu.ops.stereo import match_stereo

    B = imgsL_u8.shape[0]
    both = jnp.concatenate([imgsL_u8, imgsR_u8], 0).astype(jnp.float32)
    with jax.named_scope("pyramid"):
        pyr = jax.vmap(
            lambda im: tuple(
                image_ops.build_pyramid(im, cfg.n_levels, cfg.scale_factor)
            )
        )(both)
    feats2 = jax.vmap(
        partial(
            O.extract_from_pyramid,
            n_features=cfg.n_features, n_levels=cfg.n_levels,
            scale_factor=cfg.scale_factor,
            th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast,
        )
    )(tuple(pyr))
    featsL = jax.tree_util.tree_map(lambda x: x[:B], feats2)
    featsR = jax.tree_util.tree_map(lambda x: x[B:], feats2)
    pyrL = tuple(p[:B] for p in pyr)
    pyrR = tuple(p[B:] for p in pyr)
    baseline = bf / cam.fx
    sm = jax.vmap(
        lambda fl, fr, pl, pr: match_stereo(
            fl, fr, pl, pr, bf=bf, baseline=baseline,
            n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
        )
    )(featsL, featsR, pyrL, pyrR)
    uvr = jnp.where(sm.valid, sm.u_right, -1.0)
    depth = jnp.where(sm.valid, sm.depth, -1.0)
    return featsL, uvr, depth


@partial(jax.jit, static_argnames=("cam", "cfg", "bf"))
def stereo_frontend_batch(
    imgsL_u8: jnp.ndarray,
    imgsR_u8: jnp.ndarray,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    bf: float,
):
    """Standalone jitted batched stereo frontend (see :func:`_stereo_frontend`)."""
    return _stereo_frontend(imgsL_u8, imgsR_u8, cam, cfg, bf)


@partial(jax.jit, static_argnames=("cam", "cfg", "bf"))
def stereo_track_batch(
    m: MS.MapArrays,
    imgsL_u8: jnp.ndarray,      # (B, H, W) uint8 left
    imgsR_u8: jnp.ndarray,      # (B, H, W) uint8 right
    last_kf_slot: jnp.ndarray,
    Rcw0: jnp.ndarray,
    tcw0: jnp.ndarray,
    vel0: tuple,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    bf: float,
    count_mask: jnp.ndarray | None = None,
):
    """Stereo throughput mode: B rectified pairs in ONE device dispatch.

    The stereo analogue of :func:`track_batch` (round-2 verdict item #2):
    left+right extraction runs as one (2B,)-wide batch — the batched form
    of the reference's dual extraction threads (`src/Frame.cc:119-122`) —
    the row-band SAD stereo matcher is vmapped over the batch, and tracking
    scans with 3-row stereo observations.

    Returns (m, Rs, ts, n_inls, featsL (B-leading), mp_feats (B, NF),
    uvr (B, NF), depth (B, NF)).
    """
    featsL, uvr, depth = _stereo_frontend(imgsL_u8, imgsR_u8, cam, cfg, bf)
    m, Rs, ts, n_inls, feats_out, mp_feats = _track_scan(
        m, featsL, lambda f: f, last_kf_slot, Rcw0, tcw0, vel0, cam, cfg,
        bf, count_mask, uvr_all=uvr,
    )
    return m, Rs, ts, n_inls, feats_out, mp_feats, uvr, depth


@partial(jax.jit, static_argnames=("cam", "cfg", "bf"))
def stereo_track_batch_feats(
    m: MS.MapArrays,
    feats_all: O.FrameFeatures,
    uvr_all: jnp.ndarray,
    last_kf_slot: jnp.ndarray,
    Rcw0: jnp.ndarray,
    tcw0: jnp.ndarray,
    vel0: tuple,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    bf: float,
    count_mask: jnp.ndarray | None = None,
):
    """Stereo re-track of already-extracted/matched frames (post mid-batch KF)."""
    return _track_scan(
        m, feats_all, lambda f: f, last_kf_slot, Rcw0, tcw0, vel0, cam, cfg,
        bf, count_mask, uvr_all=uvr_all,
    )


@partial(jax.jit, static_argnames=("cam", "cfg", "bf"))
def stereo_points_from_depth(
    m: MS.MapArrays,
    slot: jnp.ndarray,
    depth: jnp.ndarray,      # (NF,) per-feature stereo depth (-1 invalid)
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    bf: float,
):
    """Candidate map points from stereo depth for unbound features of a KF.

    Equivalent of the stereo branch of ``Tracking::CreateNewKeyFrame``
    (`src/Tracking.cc:3061+`): unproject close (depth < baseline x ThDepth)
    unbound features directly.  Returns the same candidate tuple layout as
    :func:`triangulate_between` (with feat_b == feat_a).
    """
    NF = m.kf_xy.shape[1]
    R, t = m.kf_Rcw[slot], m.kf_tcw[slot]
    close_th = (bf / cam.fx) * cfg.th_depth
    free = m.kf_feat_valid[slot] & (m.kf_mp[slot] < 0)
    accept = free & (depth > 0) & (depth < close_th)
    rays = cam_mod.unproject(cam, m.kf_xy[slot])
    xc = rays * depth[:, None]
    pos_w = jnp.einsum("ji,nj->ni", R, xc - t, precision=_HP)
    cam_center = -jnp.einsum("ji,j->i", R, t, precision=_HP)
    vecs = pos_w - cam_center
    dist = jnp.linalg.norm(vecs, axis=-1)
    normal = vecs / jnp.maximum(dist, 1e-9)[:, None]
    sf = jnp.asarray(O.scale_factors(cfg.n_levels, cfg.scale_factor), pos_w.dtype)
    lvl = m.kf_level[slot]
    dmax = dist * sf[lvl]
    dmin = dmax / sf[cfg.n_levels - 1]
    feat = jnp.arange(NF, dtype=jnp.int32)
    return pos_w, m.kf_desc[slot], normal, dmin, dmax, feat, feat, accept


@partial(jax.jit, static_argnames=("cam",))
def reloc_matches(
    m: MS.MapArrays,
    cand_slot: jnp.ndarray,
    feats: O.FrameFeatures,
    cam: cam_mod.Camera,
):
    """3D-2D matches for relocalization against a candidate keyframe.

    Equivalent of the ``SearchByBoW(KF, F)`` step of
    ``Tracking::Relocalization`` (`src/Tracking.cc:3455-3623`): frame
    features matched to the candidate's map-point descriptors.
    Returns (Xw (NF, 3), rays (NF, 3), valid (NF,)).
    """
    d = M.hamming_matrix(feats.desc, m.kf_desc[cand_slot])
    has_mp = m.kf_mp[cand_slot] >= 0
    gate = feats.valid[:, None] & (has_mp & m.kf_feat_valid[cand_slot])[None, :]
    masked = jnp.where(gate, d, M.BIG)
    best = jnp.min(masked, axis=1)
    idx = jnp.argmin(masked, axis=1)
    back = jnp.argmin(masked, axis=0)
    ok = (best <= M.TH_LOW) & (back[idx] == jnp.arange(d.shape[0]))
    mp = jnp.clip(m.kf_mp[cand_slot][idx], 0)
    ok = ok & m.mp_valid[mp]
    Xw = m.mp_pos[mp]
    rays = cam_mod.unproject(cam, feats.xy)
    return Xw, rays, ok


@partial(jax.jit, static_argnames=("cam", "cfg"))
def fuse_map_points(
    m: MS.MapArrays,
    target_slot: jnp.ndarray,
    source_mask: jnp.ndarray,   # (MP,) candidate source points
    cam: cam_mod.Camera,
    cfg: SlamConfig,
):
    """Project source map points into a keyframe; bind or merge duplicates.

    Equivalent of ``ORBmatcher::Fuse`` driven by
    ``LocalMapping::SearchInNeighbors`` (`src/ORBmatcher.cc:1629`,
    `src/LocalMapping.cc:758`): a source point matching an unbound feature
    gets bound; one matching a feature bound to a DIFFERENT point triggers a
    merge that keeps the better-observed point.  Merges are applied globally
    (all bindings of the losing point rewritten) in one vectorized pass;
    merge chains are skipped (their members fuse on a later call).
    """
    MP = m.mp_pos.shape[0]
    NF = m.kf_xy.shape[1]
    R, t = m.kf_Rcw[target_slot], m.kf_tcw[target_slot]
    uv, level, visible = project_map_points(
        m, R, t, cam, cfg.width, cfg.height, cfg.n_levels, cfg.scale_factor
    )
    src = source_mask & visible & m.mp_valid
    sf = jnp.asarray(O.scale_factors(cfg.n_levels, cfg.scale_factor), uv.dtype)
    mm = M.search_by_projection(
        uv, 3.0 * sf[level], level,
        m.mp_desc, src,
        m.kf_xy[target_slot], m.kf_level[target_slot], m.kf_desc[target_slot],
        m.kf_feat_valid[target_slot],
        max_dist=M.TH_LOW,
    )
    mm = M.resolve_duplicates(mm, NF)
    matched = mm.idx >= 0
    f_idx = jnp.clip(mm.idx, 0)
    existing = m.kf_mp[target_slot, f_idx]          # (MP,) bound mp or -1
    mp_ids = jnp.arange(MP, dtype=jnp.int32)

    # --- case A: bind to unbound feature ---
    bind = matched & (existing < 0)
    tgt_feat = jnp.where(bind, f_idx, NF)
    new_row = m.kf_mp[target_slot]
    new_row = jnp.concatenate([new_row, jnp.full((1,), -1, jnp.int32)])
    new_row = new_row.at[tgt_feat].set(jnp.where(bind, mp_ids, -1))[:NF]
    # keep original bindings where not overwritten
    row = jnp.where(new_row >= 0, new_row, m.kf_mp[target_slot])
    m = m._replace(
        kf_mp=m.kf_mp.at[target_slot].set(row),
        obs_mat=m.obs_mat.at[target_slot].max(
            jnp.zeros(MP, bool).at[jnp.where(bind, mp_ids, 0)].max(bind)
        ),
        mp_nobs=m.mp_nobs + bind.astype(jnp.int32),
    )

    # --- case B: merge with an already-bound different point ---
    other = jnp.clip(existing, 0)
    mergeable = matched & (existing >= 0) & (existing != mp_ids) & m.mp_valid[other]
    keep_self = m.mp_nobs >= m.mp_nobs[other]
    winner = jnp.where(keep_self, mp_ids, other)
    loser = jnp.where(keep_self, other, mp_ids)
    # build replace map (identity except losers); skip chain merges
    replace = mp_ids
    replace = replace.at[jnp.where(mergeable, loser, MP - 1)].set(
        jnp.where(mergeable, winner, replace[MP - 1])
    )
    is_loser = replace != mp_ids
    chain = is_loser[replace]  # winner itself is a loser -> skip
    replace = jnp.where(chain, mp_ids, replace)
    is_loser = replace != mp_ids

    kf_mp = jnp.where(m.kf_mp >= 0, replace[jnp.clip(m.kf_mp, 0)], -1)
    # fold loser observation columns into the winner's, then drop losers
    obs_new = jnp.zeros_like(m.obs_mat).at[:, replace].max(m.obs_mat)
    obs_new = obs_new & (~is_loser)[None, :]
    nobs_new = jax.ops.segment_sum(
        jnp.where(m.mp_valid, m.mp_nobs, 0), replace, num_segments=MP
    )
    return m._replace(
        kf_mp=kf_mp,
        obs_mat=obs_new,
        mp_valid=m.mp_valid & ~is_loser,
        mp_nobs=nobs_new,
    )


def _add_candidates_dev(m, slot, out, n_mp, kf_b_override=None):
    """Device-side map-point allocation: insert accepted candidates at
    consecutive slots starting at n_mp; returns (m, new n_mp).

    The jit-graph version of the host `_add_candidates` (no sync): overflow
    past capacity lands in the scratch slot and is invalidated by
    ``add_map_points`` itself.
    """
    pos_w, desc, normal, dmin, dmax, feat_a, feat_b, accept = out
    MP = m.mp_pos.shape[0]
    offs = jnp.cumsum(accept.astype(jnp.int32)) - 1
    stored = accept & (n_mp + offs < MP - 1)
    kf_b = slot if kf_b_override is None else kf_b_override
    m = MS.add_map_points(
        m, n_mp, pos_w, desc, normal, dmin, dmax,
        slot, accept, slot, feat_a, kf_b, feat_b,
    )
    return m, n_mp + jnp.sum(stored.astype(jnp.int32))


@partial(
    jax.jit,
    static_argnames=("cam", "cfg", "n_neighbors", "bf", "has_depth",
                     "visual_ba"),
)
def insert_keyframe_step(
    m: MS.MapArrays,
    slot: jnp.ndarray,          # () int32 keyframe slot
    Rcw: jnp.ndarray,
    tcw: jnp.ndarray,
    frame_id: jnp.ndarray,
    feats: O.FrameFeatures,
    mp_of_feat: jnp.ndarray,    # (NF,) map-point binding per feature
    uvr: jnp.ndarray,           # (NF,) stereo right-u or -1
    depth: jnp.ndarray,         # (NF,) stereo depth or -1 (ignored unless has_depth)
    n_mp: jnp.ndarray,          # () int32 allocation pointer
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    n_neighbors: int = 2,
    bf: float = 0.0,
    has_depth: bool = False,
    xy_r: jnp.ndarray | None = None,   # (NF, 2) right-camera obs (fisheye)
    visual_ba: bool = True,
):
    """ONE device dispatch for the whole synchronous mapper pass.

    Sequence mirrors ``LocalMapping::Run`` (`/root/reference/src/
    LocalMapping.cc:64-294`): insert KF -> (stereo) depth-seeded points ->
    triangulate against the top covisible neighbours -> SearchInNeighbors
    fuse -> MapPointCulling -> local BA -> KeyFrameCulling.  The host only
    syncs the new allocation pointer; everything else stays on device,
    so keyframe frames no longer cost a chain of dispatch round-trips.
    """
    m = MS.add_keyframe(
        m, slot, Rcw, tcw, frame_id,
        feats.xy, feats.level, feats.angle, feats.desc, feats.valid,
        mp_of_feat, uvr, xy_r=xy_r,
    )
    if has_depth:
        out = stereo_points_from_depth(m, slot, depth, cam, cfg, bf=bf)
        m, n_mp = _add_candidates_dev(m, slot, out, n_mp)

    # triangulate against ALL top covisible neighbours in ONE vmapped batch
    # (reference covers 10-20 covisible KFs, `src/LocalMapping.cc:402-470`;
    # round 2 looped 4 sequential dispatches).  A feature triangulated by
    # several neighbours keeps only its first (best-covisibility) hit — the
    # sequential reference binds it on the first success too.
    NF = m.kf_xy.shape[1]
    w = MS.covisibility_weights(m, slot)
    _, top_i = jax.lax.top_k(w, n_neighbors)
    nbs = top_i.astype(jnp.int32)                       # (N,)
    pos_w, desc, normal, dmin, dmax, feat_a, feat_b, acc = jax.vmap(
        lambda nb: triangulate_between(m, slot, nb, cam, cfg)
    )(nbs)                                              # each (N, NF, ...)
    acc = acc & (w[nbs] > 0)[:, None]
    k_first = jnp.argmax(acc, axis=0)                   # (NF,) first accepting nb
    keep = acc & (
        jnp.arange(n_neighbors, dtype=jnp.int32)[:, None] == k_first[None, :]
    )
    kf_b_flat = jnp.repeat(nbs, NF)
    out = (
        pos_w.reshape(-1, 3), desc.reshape(-1, 8), normal.reshape(-1, 3),
        dmin.reshape(-1), dmax.reshape(-1),
        feat_a.reshape(-1), feat_b.reshape(-1), keep.reshape(-1),
    )
    m, n_mp = _add_candidates_dev(m, slot, out, n_mp, kf_b_override=kf_b_flat)

    mp_mask, kf_mask = MS.local_map_mask(m, slot, n_neighbors=cfg.local_window)
    m = fuse_map_points(m, slot, mp_mask, cam, cfg)
    m = MS.cull_map_points(m, slot)
    # refresh distinctive descriptors / normals / depth ranges of the points
    # whose observations just changed (reference MapPoint::
    # ComputeDistinctiveDescriptors + UpdateNormalAndDepth after fuse)
    m = MS.update_point_stats(
        m, mp_mask, n_levels=cfg.n_levels, scale_factor=cfg.scale_factor
    )
    if visual_ba:
        m = local_ba(m, slot, cam, cfg, window=cfg.local_window, bf=bf)
        protect = (
            jnp.zeros(m.kf_valid.shape[0], bool)
            .at[slot].set(True).at[0].set(True)
        )
        m = MS.cull_keyframes(m, kf_mask, protect)
    # visual_ba=False: the inertial caller runs LocalInertialBA over the
    # temporal chain instead (and owns keyframe-culling policy) — this
    # fused dispatch still covers insert -> depth points -> triangulation
    # -> fuse -> point cull -> stats refresh in one device program
    return m, n_mp


# ---------------------------------------------------------------------------
# local bundle adjustment over the covisibility window
# ---------------------------------------------------------------------------

_ANCHOR_OBS_CAP = 4096  # out-of-window anchor observations kept (compacted)


@partial(jax.jit, static_argnames=("cam", "cfg", "window", "bf"))
def local_ba(
    m: MS.MapArrays,
    center_slot: jnp.ndarray,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    window: int = 8,
    bf: float = 0.0,
):
    """Windowed BA with the reference's full fixed-anchor set.

    Free: the top-`window` covisible KFs of `center_slot` + center, and the
    points they see.  Fixed anchors: ALL other keyframes observing those
    points contribute their observations with frozen poses
    (``LocalBundleAdjustment``'s lFixedCameras, `src/Optimizer.cc:1611+`) —
    without them the window's boundary is unconstrained and the map slowly
    deforms.  Anchor observations are compacted to a static cap; the solve
    uses the dense-Schur window engine (:mod:`optim.window_ba`) — the
    reduced camera system is only (K*6)^2, so it is assembled exactly and
    solved directly instead of iterating PCG.
    """
    from orb_slam3_noted_tpu.optim.window_ba import WindowObs, window_bundle_adjust

    KF, NF = m.kf_xy.shape[0], m.kf_xy.shape[1]
    MP = m.mp_pos.shape[0]
    K = window + 1

    w = MS.covisibility_weights(m, center_slot)
    top_w, top_i = jax.lax.top_k(w, window)
    kf_slots = jnp.concatenate(
        [center_slot[None].astype(jnp.int32), top_i.astype(jnp.int32)]
    )
    kf_mask = jnp.concatenate([jnp.ones(1, bool), top_w > 0])
    in_window = jnp.zeros(KF, bool).at[kf_slots].max(kf_mask)
    # gauge: earliest frame id in the window stays fixed
    fids = jnp.where(kf_mask, m.kf_frame_id[kf_slots], jnp.int32(1 << 30))
    anchor_w = jnp.argmin(fids)
    pose_fixed_w = (~kf_mask).at[anchor_w].set(True)
    # padded slots write into the scratch row KF of the padded pose table
    kf_slots_w = jnp.where(kf_mask, kf_slots, KF)

    # --- window observation rows: every feature of the window KFs ---
    k_local = jnp.repeat(jnp.arange(K, dtype=jnp.int32), NF)
    f_idx = jnp.tile(jnp.arange(NF, dtype=jnp.int32), K)
    kf_g = kf_slots[k_local]
    mp_id = m.kf_mp[kf_g, f_idx]
    valid = kf_mask[k_local] & (mp_id >= 0) & m.kf_feat_valid[kf_g, f_idx]
    mp_idx = jnp.clip(mp_id, 0)
    valid = valid & m.mp_valid[mp_idx]
    seen = jnp.zeros(MP, bool).at[mp_idx].max(valid)

    # --- anchor rows: out-of-window observations of window points ---
    all_k = jnp.repeat(jnp.arange(KF, dtype=jnp.int32), NF)
    all_f = jnp.tile(jnp.arange(NF, dtype=jnp.int32), KF)
    all_mp = m.kf_mp.reshape(-1)
    cand = (
        m.kf_valid[all_k]
        & ~in_window[all_k]
        & (all_mp >= 0)
        & m.kf_feat_valid.reshape(-1)
        & seen[jnp.clip(all_mp, 0)]
    )
    _, sel = jax.lax.top_k(cand.astype(jnp.int32), _ANCHOR_OBS_CAP)
    # "no silent caps": report dropped anchor observations (at 256 KF x
    # 1200 features the cap IS exceeded mid-sequence — the overflow count
    # surfaces via --times instead of vanishing)
    from orb_slam3_noted_tpu.utils.timing import report_saturation

    report_saturation(
        "local_ba_anchor_obs",
        jnp.maximum(jnp.sum(cand.astype(jnp.int32)) - _ANCHOR_OBS_CAP, 0),
    )
    a_k = all_k[sel]
    a_f = all_f[sel]
    a_valid = cand[sel]
    a_mp = jnp.clip(all_mp[sel], 0)

    sigma2 = jnp.asarray(cfg.level_sigma2, m.mp_pos.dtype)
    pose_idx = jnp.concatenate([kf_g, a_k])
    feat_idx = jnp.concatenate([f_idx, a_f])
    uvr = m.kf_uvr[pose_idx, feat_idx]
    cam2, Rrl, trl = _second_camera(cfg)
    if cam2 is not None:
        uv2 = m.kf_xy_r[pose_idx, feat_idx]
        is_right = uv2[:, 0] >= 0
    else:
        uv2 = None
        is_right = None
    obs = WindowObs(
        pose_idx=pose_idx,
        wpose_idx=jnp.concatenate([k_local, jnp.full(a_k.shape, K, jnp.int32)]),
        point_idx=jnp.concatenate([mp_idx, a_mp]),
        uv=m.kf_xy[pose_idx, feat_idx],
        uv_r=uvr,
        inv_sigma2=1.0 / sigma2[m.kf_level[pose_idx, feat_idx]],
        is_stereo=uvr >= 0,
        valid=jnp.concatenate([valid, a_valid]),
        uv2=uv2,
        is_right=is_right,
    )
    Rcw_pad = jnp.concatenate([m.kf_Rcw, jnp.eye(3, dtype=m.kf_Rcw.dtype)[None]])
    tcw_pad = jnp.concatenate([m.kf_tcw, jnp.zeros((1, 3), m.kf_tcw.dtype)])
    res = window_bundle_adjust(
        cam, Rcw_pad, tcw_pad, m.mp_pos, obs, kf_slots_w, pose_fixed_w,
        ~seen, bf=bf, n_iters=cfg.ba_iters, n_iters_final=cfg.ba_iters_final,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    m = m._replace(
        kf_Rcw=res.Rcw[:KF], kf_tcw=res.tcw[:KF], mp_pos=res.points
    )
    # drop window observations classified as outliers (unbind feature -> mp)
    out = valid & ~res.inlier[: K * NF]
    new_kf_mp = m.kf_mp.at[kf_g, f_idx].set(
        jnp.where(out, -1, m.kf_mp[kf_g, f_idx])
    )
    # obs_mat rows for window KFs are rebuilt from the surviving bindings
    rows = jnp.zeros((K, MP), bool).at[k_local, mp_idx].max(
        (new_kf_mp[kf_g, f_idx] >= 0) & valid
    )
    obs_mat = m.obs_mat.at[kf_slots].set(
        jnp.where(kf_mask[:, None], rows, m.obs_mat[kf_slots])
    )
    return m._replace(kf_mp=new_kf_mp, obs_mat=obs_mat)
