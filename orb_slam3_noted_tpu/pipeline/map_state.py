"""Fixed-capacity device-resident map state (keyframes + map points).

Device-resident replacement for the reference's pointer-graph map
(`/root/reference/src/{Map,KeyFrame,MapPoint}.cc` + per-object mutexes):
everything is a preallocated SoA array with validity masks, updated
functionally with ``.at[]`` — snapshots are free (immutable arrays), which
removes the reference's lock protocol (`include/Map.h:111`
``mMutexMapUpdate``) entirely.

The covisibility graph (`include/KeyFrame.h:87-96`) is not stored as
adjacency lists: a dense (KF_CAP, MP_CAP) observation matrix is maintained
incrementally, and covisibility weights are one int8 matmul
(``obs @ obs[k]``) — the batched analogue of ``UpdateConnections``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.io.config import SlamConfig


class MapArrays(NamedTuple):
    """All device-resident map storage. Shapes fixed by SlamConfig."""

    # keyframes: pose Tcw, features, bindings
    kf_Rcw: jnp.ndarray        # (KF, 3, 3)
    kf_tcw: jnp.ndarray        # (KF, 3)
    kf_valid: jnp.ndarray      # (KF,) bool
    kf_frame_id: jnp.ndarray   # (KF,) int32 source frame index
    kf_xy: jnp.ndarray         # (KF, NF, 2) level-0 pixel coords
    kf_level: jnp.ndarray      # (KF, NF) int32
    kf_angle: jnp.ndarray      # (KF, NF) float32
    kf_desc: jnp.ndarray       # (KF, NF, 8) uint32
    kf_feat_valid: jnp.ndarray  # (KF, NF) bool
    kf_mp: jnp.ndarray         # (KF, NF) int32 map-point slot or -1
    kf_uvr: jnp.ndarray        # (KF, NF) float32 stereo right-u (<0 if mono)
    # non-rectified second-camera observation (fisheye stereo): matched
    # right-camera pixel per left feature, (-1,-1) = none
    kf_xy_r: jnp.ndarray       # (KF, NF, 2) float32
    # spanning tree (reference `include/KeyFrame.h:99-105`): parent = the
    # strongest-covisibility keyframe at insertion; -1 = root.  Pose-graph
    # edges and culled-reference trajectory recovery use this instead of
    # slot order (slot order != time order once slots recycle)
    kf_parent: jnp.ndarray     # (KF,) int32

    # map points
    mp_pos: jnp.ndarray        # (MP, 3)
    mp_valid: jnp.ndarray      # (MP,) bool
    mp_desc: jnp.ndarray       # (MP, 8) uint32 representative descriptor
    mp_normal: jnp.ndarray     # (MP, 3) mean viewing direction (world)
    mp_dmin: jnp.ndarray       # (MP,) scale-invariance range (min distance)
    mp_dmax: jnp.ndarray       # (MP,)
    mp_ref_kf: jnp.ndarray     # (MP,) int32
    mp_nobs: jnp.ndarray       # (MP,) int32 observation count
    mp_visible: jnp.ndarray    # (MP,) int32 "visible" counter (reference mnVisible)
    mp_found: jnp.ndarray      # (MP,) int32 "found" counter (mnFound)

    # dense observation incidence (covisibility by matmul)
    obs_mat: jnp.ndarray       # (KF, MP) bool


def empty_map(cfg: SlamConfig, dtype=jnp.float32) -> MapArrays:
    KF, NF, MP = cfg.max_keyframes, cfg.n_features, cfg.max_map_points
    return MapArrays(
        kf_Rcw=jnp.tile(jnp.eye(3, dtype=dtype), (KF, 1, 1)),
        kf_tcw=jnp.zeros((KF, 3), dtype),
        kf_valid=jnp.zeros(KF, bool),
        kf_frame_id=jnp.zeros(KF, jnp.int32),
        kf_xy=jnp.zeros((KF, NF, 2), dtype),
        kf_level=jnp.zeros((KF, NF), jnp.int32),
        kf_angle=jnp.zeros((KF, NF), dtype),
        kf_desc=jnp.zeros((KF, NF, 8), jnp.uint32),
        kf_feat_valid=jnp.zeros((KF, NF), bool),
        kf_mp=jnp.full((KF, NF), -1, jnp.int32),
        kf_uvr=jnp.full((KF, NF), -1.0, dtype),
        kf_xy_r=jnp.full((KF, NF, 2), -1.0, dtype),
        kf_parent=jnp.full(KF, -1, jnp.int32),
        mp_pos=jnp.zeros((MP, 3), dtype),
        mp_valid=jnp.zeros(MP, bool),
        mp_desc=jnp.zeros((MP, 8), jnp.uint32),
        mp_normal=jnp.zeros((MP, 3), dtype),
        mp_dmin=jnp.zeros(MP, dtype),
        mp_dmax=jnp.full(MP, 1e9, dtype),
        mp_ref_kf=jnp.zeros(MP, jnp.int32),
        mp_nobs=jnp.zeros(MP, jnp.int32),
        mp_visible=jnp.ones(MP, jnp.int32),
        mp_found=jnp.ones(MP, jnp.int32),
        obs_mat=jnp.zeros((KF, MP), bool),
    )


@jax.jit
def add_keyframe(
    m: MapArrays,
    slot: jnp.ndarray,        # () int32 target slot
    Rcw: jnp.ndarray,
    tcw: jnp.ndarray,
    frame_id: jnp.ndarray,
    xy: jnp.ndarray,          # (NF, 2)
    level: jnp.ndarray,
    angle: jnp.ndarray,
    desc: jnp.ndarray,
    feat_valid: jnp.ndarray,
    mp_bind: jnp.ndarray,     # (NF,) int32 map-point slot per feature or -1
    uvr: jnp.ndarray,
    xy_r: jnp.ndarray | None = None,   # (NF, 2) right-camera obs or None
) -> MapArrays:
    """Insert/overwrite a keyframe and bind its features to map points."""
    MP = m.mp_pos.shape[0]
    if xy_r is None:
        xy_r = jnp.full_like(xy, -1.0)
    m = m._replace(
        kf_xy_r=m.kf_xy_r.at[slot].set(xy_r),
        kf_Rcw=m.kf_Rcw.at[slot].set(Rcw),
        kf_tcw=m.kf_tcw.at[slot].set(tcw),
        kf_valid=m.kf_valid.at[slot].set(True),
        kf_frame_id=m.kf_frame_id.at[slot].set(frame_id),
        kf_xy=m.kf_xy.at[slot].set(xy),
        kf_level=m.kf_level.at[slot].set(level),
        kf_angle=m.kf_angle.at[slot].set(angle),
        kf_desc=m.kf_desc.at[slot].set(desc),
        kf_feat_valid=m.kf_feat_valid.at[slot].set(feat_valid),
        kf_mp=m.kf_mp.at[slot].set(mp_bind),
        kf_uvr=m.kf_uvr.at[slot].set(uvr),
    )
    bound = mp_bind >= 0
    mp_idx = jnp.clip(mp_bind, 0)
    row = jnp.zeros(MP, bool).at[mp_idx].max(bound)
    m = m._replace(
        obs_mat=m.obs_mat.at[slot].set(row),
        mp_nobs=m.mp_nobs.at[mp_idx].add(bound.astype(jnp.int32)),
    )
    # spanning-tree parent = strongest covisible existing keyframe
    # (reference ``KeyFrame::UpdateConnections`` -> ChangeParent); computed
    # from the freshly written observation row, -1 when nothing is shared
    # (e.g. the first keyframe, or bindings added later — see
    # :func:`refresh_parent`)
    w = covisibility_weights(m, slot)
    parent = jnp.where(jnp.max(w) > 0, jnp.argmax(w).astype(jnp.int32), -1)
    return m._replace(kf_parent=m.kf_parent.at[slot].set(parent))


@jax.jit
def refresh_parent(m: MapArrays, slot: jnp.ndarray) -> MapArrays:
    """Recompute `slot`'s spanning-tree parent from current covisibility.

    For keyframes whose bindings were created AFTER insertion (the
    two-view initializer binds via ``add_map_points``)."""
    w = covisibility_weights(m, slot)
    parent = jnp.where(jnp.max(w) > 0, jnp.argmax(w).astype(jnp.int32), -1)
    return m._replace(kf_parent=m.kf_parent.at[slot].set(parent))


@jax.jit
def covisibility_weights(m: MapArrays, slot: jnp.ndarray) -> jnp.ndarray:
    """(KF,) number of map points shared with keyframe `slot` (one matmul).

    Batched equivalent of ``KeyFrame::UpdateConnections``
    (`src/KeyFrame.cc`): weight(i) = |obs_i ∩ obs_slot|.
    """
    q = m.obs_mat[slot].astype(jnp.bfloat16)          # (MP,)
    w = jnp.einsum(
        "km,m->k", m.obs_mat.astype(jnp.bfloat16), q,
        preferred_element_type=jnp.float32,
    )
    w = w * m.kf_valid
    return w.at[slot].set(0.0)


@jax.jit
def covisibility_matrix(m: MapArrays) -> jnp.ndarray:
    """(KF, KF) shared-map-point counts — ONE bf16 matmul, exact f32 accum.

    The full-graph analogue of :func:`covisibility_weights`; used by the
    loop closer (candidate exclusion, consistency groups, pose-graph edges)
    so the (KF, MP) observation matrix never leaves the device.
    """
    a = m.obs_mat.astype(jnp.bfloat16)
    cv = jax.lax.dot_general(
        a, a, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    cv = cv * (m.kf_valid[:, None] & m.kf_valid[None, :])
    return cv * (1.0 - jnp.eye(cv.shape[0], dtype=cv.dtype))


@partial(jax.jit, static_argnames=("n_neighbors",))
def local_map_mask(
    m: MapArrays, slot: jnp.ndarray, n_neighbors: int = 10
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Map-point mask + KF mask of the covisibility-local map around `slot`.

    Equivalent of ``Tracking::UpdateLocalKeyFrames/UpdateLocalPoints``
    (`src/Tracking.cc:3262-3454`): the top covisible keyframes and the union
    of their observed points.
    """
    w = covisibility_weights(m, slot)
    top_w, top_i = jax.lax.top_k(w, n_neighbors)
    kf_mask = jnp.zeros(m.kf_valid.shape[0], bool).at[top_i].max(top_w > 0)
    kf_mask = kf_mask.at[slot].set(True)
    sel = m.obs_mat & kf_mask[:, None]
    mp_mask = jnp.any(sel, axis=0) & m.mp_valid
    return mp_mask, kf_mask


@jax.jit
def add_map_points(
    m: MapArrays,
    start_slot: jnp.ndarray,   # () int32 first free mp slot
    pos: jnp.ndarray,          # (n_new, 3) world positions
    desc: jnp.ndarray,         # (n_new, 8)
    normal: jnp.ndarray,       # (n_new, 3)
    dmin: jnp.ndarray,
    dmax: jnp.ndarray,
    ref_kf: jnp.ndarray,       # () int32
    accept: jnp.ndarray,       # (n_new,) bool
    kf_a: jnp.ndarray,         # () int32 first observing keyframe
    feat_a: jnp.ndarray,       # (n_new,) feature index in kf_a
    kf_b: jnp.ndarray,         # () int32 second observing keyframe
    feat_b: jnp.ndarray,       # (n_new,) feature index in kf_b
) -> MapArrays:
    """Allocate `accept`-masked new map points at consecutive slots.

    Slot for entry i = start_slot + cumsum(accept)[i] (dense packing);
    rejected entries write to a scratch slot (capacity-1) that is immediately
    invalidated. Also binds the two observing features.
    """
    MP = m.mp_pos.shape[0]
    offs = jnp.cumsum(accept.astype(jnp.int32)) - 1
    slot = jnp.where(accept, start_slot + offs, MP - 1)
    slot = jnp.clip(slot, 0, MP - 1)
    ok = accept & (slot < MP - 1)
    # "no silent caps": accepted candidates that no longer fit in the point
    # table are dropped here — surface the count (reference Map::AddMapPoint
    # has no capacity; our static table does)
    from orb_slam3_noted_tpu.utils.timing import report_saturation

    report_saturation(
        "map_point_capacity",
        jnp.sum(accept.astype(jnp.int32)) - jnp.sum(ok.astype(jnp.int32)),
    )

    m = m._replace(
        mp_pos=m.mp_pos.at[slot].set(jnp.where(ok[:, None], pos, m.mp_pos[slot])),
        mp_valid=m.mp_valid.at[slot].max(ok),
        mp_desc=m.mp_desc.at[slot].set(jnp.where(ok[:, None], desc, m.mp_desc[slot])),
        mp_normal=m.mp_normal.at[slot].set(
            jnp.where(ok[:, None], normal, m.mp_normal[slot])
        ),
        mp_dmin=m.mp_dmin.at[slot].set(jnp.where(ok, dmin, m.mp_dmin[slot])),
        mp_dmax=m.mp_dmax.at[slot].set(jnp.where(ok, dmax, m.mp_dmax[slot])),
        mp_ref_kf=m.mp_ref_kf.at[slot].set(
            jnp.where(ok, ref_kf, m.mp_ref_kf[slot])
        ),
        mp_nobs=m.mp_nobs.at[slot].set(jnp.where(ok, 2, m.mp_nobs[slot])),
        mp_visible=m.mp_visible.at[slot].set(jnp.where(ok, 1, m.mp_visible[slot])),
        mp_found=m.mp_found.at[slot].set(jnp.where(ok, 1, m.mp_found[slot])),
    )
    # bind observations in both keyframes
    m = m._replace(
        kf_mp=m.kf_mp.at[kf_a, feat_a].set(
            jnp.where(ok, slot, m.kf_mp[kf_a, feat_a])
        ),
    )
    m = m._replace(
        kf_mp=m.kf_mp.at[kf_b, feat_b].set(
            jnp.where(ok, slot, m.kf_mp[kf_b, feat_b])
        ),
        obs_mat=m.obs_mat.at[kf_a, slot].max(ok).at[kf_b, slot].max(ok),
    )
    return m


@jax.jit
def cull_map_points(m: MapArrays, current_kf: jnp.ndarray) -> MapArrays:
    """Remove unreliable recent map points.

    Equivalent of ``LocalMapping::MapPointCulling`` (`src/LocalMapping.cc:358`):
    a point is culled if its found/visible ratio is below 0.25, or if it is
    2+ keyframes old but still observed by fewer than 3 keyframes.
    """
    ratio_bad = m.mp_found.astype(jnp.float32) < 0.25 * m.mp_visible.astype(
        jnp.float32
    )
    age = current_kf - m.mp_ref_kf
    # the reference only audits RECENTLY added points (mlpRecentAddedMapPoints,
    # dropped from the audit list after 3 keyframes); older points are settled
    recent = age <= 3
    weak = (age >= 2) & (m.mp_nobs < 3)
    cull = m.mp_valid & recent & (ratio_bad | weak)
    keep = m.mp_valid & ~cull
    # unbind culled points everywhere
    kf_mp = jnp.where(keep[jnp.clip(m.kf_mp, 0)] & (m.kf_mp >= 0), m.kf_mp, -1)
    obs = m.obs_mat & keep[None, :]
    return m._replace(mp_valid=keep, kf_mp=kf_mp, obs_mat=obs)


@partial(jax.jit, static_argnames=("n_levels", "scale_factor"))
def update_point_stats(
    m: MapArrays, mp_sel: jnp.ndarray,
    n_levels: int = 8, scale_factor: float = 1.2,
) -> MapArrays:
    """Re-elect distinctive descriptors and refresh normals/scale ranges.

    Batched equivalent of ``MapPoint::ComputeDistinctiveDescriptors``
    (`/root/reference/src/MapPoint.cc:349`) and ``UpdateNormalAndDepth``:

    - descriptor: among a point's observations, pick the one minimizing the
      summed Hamming distance to the others.  Exact mean-distance argmin via
      per-point bit counts: sum_o' ham(a, b_o') = sum_bits a_j (n - c_j) +
      (1 - a_j) c_j with c_j the per-point count of set bit j — one
      segment-sum over the flat observation table, no pairwise matrix.
      (The reference minimizes the *median*; for the <= dozens of
      observations per point the mean/median argmins coincide in practice
      and the mean is a single dense reduction.)
    - normal: mean unit vector from each observing keyframe centre.
    - dmin/dmax: distance to the reference KF scaled by the observed octave
      (``PredictScale`` range).

    ``mp_sel`` (MP,) limits the update to points whose observations changed
    (the reference updates points touched by the current keyframe only).
    """
    KF, NF = m.kf_xy.shape[0], m.kf_xy.shape[1]
    MP = m.mp_pos.shape[0]
    k_idx = jnp.repeat(jnp.arange(KF, dtype=jnp.int32), NF)
    f_idx = jnp.tile(jnp.arange(NF, dtype=jnp.int32), KF)
    mp = m.kf_mp.reshape(-1)
    row_ok = (mp >= 0) & m.kf_valid[k_idx] & m.kf_feat_valid.reshape(-1)
    mp_c = jnp.clip(mp, 0)
    row_ok = row_ok & mp_sel[mp_c] & m.mp_valid[mp_c]
    seg = jnp.where(row_ok, mp_c, MP)  # invalid rows -> scratch segment

    # --- distinctive descriptor ---
    # Processed one 32-bit word at a time: unpacking ALL 256 bits at once
    # costs (KF*NF, 256) f32 — ~315 MB at the configured 256 KF x 1200
    # feature capacity, inside the fused mapper dispatch (round-4 fix).
    # Chunked, the peak transient is (KF*NF, 32) ~ 39 MB.
    desc = m.kf_desc.reshape(KF * NF, 8)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    n_obs = jax.ops.segment_sum(
        row_ok.astype(jnp.float32), seg, num_segments=MP + 1
    )[:MP]

    def word_bits(w):
        return (
            (desc[:, w, None] >> shifts[None, :]) & jnp.uint32(1)
        ).astype(jnp.float32)  # (KF*NF, 32)

    c_words = []
    for w in range(8):
        c_words.append(jax.ops.segment_sum(
            word_bits(w) * row_ok[:, None], seg, num_segments=MP + 1
        )[:MP])  # (MP, 32) per-bit set counts
    # score_o = sum_j a_j (n - c_j) + (1 - a_j) c_j = sum(c) + sum_j a_j (n - 2 c_j)
    base = sum(jnp.sum(cw, axis=1) for cw in c_words)
    sc = base[mp_c]
    for w in range(8):
        sc = sc + jnp.einsum(
            "ob,ob->o", word_bits(w),
            (n_obs[mp_c, None] - 2.0 * c_words[w][mp_c]),
        )
    sc = jnp.where(row_ok, sc, jnp.inf)
    best = jnp.full((MP + 1,), jnp.inf).at[seg].min(sc)[:MP]
    is_best = row_ok & (sc == best[mp_c])
    # tie-break: lowest row index
    rows = jnp.arange(KF * NF, dtype=jnp.int32)
    first = jnp.full((MP + 1,), jnp.int32(1 << 30)).at[seg].min(
        jnp.where(is_best, rows, jnp.int32(1 << 30))
    )[:MP]
    # >= 3 observations: with exactly two, both descriptors have the SAME
    # summed distance (ham(a,b) == ham(b,a)) — the argmin is an arbitrary
    # tie and flip-flops the descriptor, measurably hurting association on
    # depth-seeded (RGB-D) maps.  The reference's median argmin has the
    # same degeneracy at 2 observations.
    has = (first < (1 << 30)) & (n_obs >= 3)
    new_desc = desc[jnp.clip(first, 0, KF * NF - 1)]
    mp_desc = jnp.where(has[:, None], new_desc, m.mp_desc)

    # --- normal + scale range ---
    centers = -jnp.einsum("kji,kj->ki", m.kf_Rcw, m.kf_tcw)  # (KF, 3)
    vec = m.mp_pos[mp_c] - centers[k_idx]
    vn = vec / jnp.maximum(jnp.linalg.norm(vec, axis=-1, keepdims=True), 1e-9)
    nsum = jax.ops.segment_sum(
        vn * row_ok[:, None], seg, num_segments=MP + 1
    )[:MP]
    nrm = jnp.linalg.norm(nsum, axis=-1, keepdims=True)
    new_normal = nsum / jnp.maximum(nrm, 1e-9)
    mp_normal = jnp.where(has[:, None] & (nrm > 1e-9), new_normal, m.mp_normal)

    # reference-KF distance + octave -> scale-invariance range
    ref = m.mp_ref_kf
    d_ref = jnp.linalg.norm(m.mp_pos - centers[ref], axis=-1)
    is_ref_row = row_ok & (k_idx == ref[mp_c])
    lvl = jax.ops.segment_max(
        jnp.where(is_ref_row, m.kf_level.reshape(-1), 0), seg,
        num_segments=MP + 1,
    )[:MP]
    # only update the range when the reference KF still observes the point
    # (an unbound ref row would default lvl to 0 and collapse dmax, gating
    # the point out of the visibility check)
    ref_seen = jax.ops.segment_max(
        is_ref_row.astype(jnp.int32), seg, num_segments=MP + 1
    )[:MP] > 0
    sf = scale_factor ** jnp.arange(n_levels, dtype=m.mp_pos.dtype)
    dmax = d_ref * sf[jnp.clip(lvl, 0, n_levels - 1)]
    dmin = dmax / sf[n_levels - 1]
    upd = has & m.mp_valid & (d_ref > 1e-6) & ref_seen
    return m._replace(
        mp_desc=mp_desc,
        mp_normal=mp_normal,
        mp_dmin=jnp.where(upd, dmin, m.mp_dmin),
        mp_dmax=jnp.where(upd, dmax, m.mp_dmax),
    )


@partial(jax.jit, static_argnames=("ratio",))
def cull_keyframes(m: MapArrays, window_mask: jnp.ndarray, protect: jnp.ndarray,
                   ratio: float = 0.9):
    """Mark redundant keyframes invalid (reference ``KeyFrameCulling``,
    `src/LocalMapping.cc:982`: >=90% of a KF's points seen by >=3 other KFs;
    ``ratio`` drops to 0.5 for stereo-inertial maps, `:1007`).

    window_mask: (KF,) candidates to consider; protect: (KF,) never cull
    (current KF, origin).  Returns the updated map.
    """
    MP = m.mp_pos.shape[0]
    bound = (m.kf_mp >= 0) & m.kf_feat_valid
    mp_idx = jnp.clip(m.kf_mp, 0)

    def redundancy(nobs):
        well_observed = nobs[mp_idx] >= 4  # point survives without this KF
        n_bound = jnp.sum(bound, axis=1)
        n_red = jnp.sum(bound & well_observed, axis=1)
        red_ratio = n_red / jnp.maximum(n_bound, 1)
        return (
            m.kf_valid
            & window_mask
            & ~protect
            & (n_bound > 20)
            & (n_red >= ratio * n_bound)
        ), red_ratio

    # Two-pass joint accounting: first find all individually redundant KFs,
    # then re-check against the JOINT observation loss (two culled KFs may
    # share points; the reference's sequential loop can never over-cull, and
    # neither can this recheck).
    cand, red = redundancy(m.mp_nobs)
    dec = jax.ops.segment_sum(
        (bound & cand[:, None]).reshape(-1).astype(jnp.int32),
        jnp.where(bound, mp_idx, MP - 1).reshape(-1), num_segments=MP,
    )
    cull_joint, _ = redundancy(m.mp_nobs - dec)
    cull = cand & cull_joint
    # Sequential fallback: when MANY keyframes are redundant over the SAME
    # points, the joint subtraction can reject every candidate at once
    # (each loses >1 observer) — a deadlock the reference's one-at-a-time
    # loop never hits.  Cull the single most redundant candidate then; the
    # next mapper pass re-evaluates with updated counts.
    best = jnp.argmax(jnp.where(cand, red, -1.0))
    fallback = jnp.zeros_like(cand).at[best].set(True) & cand
    cull = jnp.where(jnp.any(cull), cull, fallback)
    dec_final = jax.ops.segment_sum(
        (bound & cull[:, None]).reshape(-1).astype(jnp.int32),
        jnp.where(bound, mp_idx, MP - 1).reshape(-1), num_segments=MP,
    )
    keep = ~cull
    kf_valid = m.kf_valid & keep
    obs_mat = m.obs_mat & keep[:, None]
    # re-home points whose reference keyframe was culled to their first
    # surviving observer (reference ``MapPoint::EraseObservation`` updates
    # mpRefKF) — required for slot recycling: a recycled slot must not be
    # mistaken for a live reference
    ref_dead = ~kf_valid[m.mp_ref_kf]
    new_ref = jnp.argmax(obs_mat, axis=0).astype(jnp.int32)  # first observer
    has_obs = jnp.any(obs_mat, axis=0)
    mp_ref_kf = jnp.where(ref_dead & has_obs, new_ref, m.mp_ref_kf)
    # spanning tree: children of a culled keyframe re-parent to the culled
    # node's own parent (reference ``KeyFrame::SetBadFlag`` reassigns
    # children into the surviving tree).  Pointer-jump a few rounds so a
    # chain of culled ancestors collapses in one dispatch; a fully culled
    # ancestry becomes a root (-1).
    kf_parent = m.kf_parent
    for _ in range(4):
        p_idx = jnp.clip(kf_parent, 0)
        parent_dead = (kf_parent >= 0) & ~kf_valid[p_idx]
        kf_parent = jnp.where(parent_dead, kf_parent[p_idx], kf_parent)
    p_idx = jnp.clip(kf_parent, 0)
    kf_parent = jnp.where(
        (kf_parent >= 0) & ~kf_valid[p_idx], -1, kf_parent
    )
    return m._replace(
        kf_valid=kf_valid,
        mp_nobs=m.mp_nobs - dec_final,
        obs_mat=obs_mat,
        kf_mp=jnp.where(cull[:, None], -1, m.kf_mp),
        mp_ref_kf=mp_ref_kf,
        kf_parent=kf_parent,
    )


@jax.jit
def compact_map_points(m: MapArrays):
    """Compact valid map points to the front; free the culled slots.

    The device-side half of the free-list lifecycle (SURVEY §7 "maps of
    capped KF/MP capacity with free-lists"; reference
    ``Map::EraseMapPoint``): a long run continually culls points, and
    without recycling the monotone allocator hits capacity and silently
    stops creating landmarks.  One dispatch: stable-partition the point
    table by validity, remap every binding.

    Returns ``(m, n_valid, inv)`` where ``inv`` maps OLD point index ->
    NEW point index for points that survived, and -1 for culled slots.
    Callers holding point bindings computed before the compaction (e.g.
    an in-flight ``mp_of_feat`` from the last track dispatch) MUST remap
    them through ``inv`` before using them against the compacted map —
    otherwise a recycled slot silently rebinds features to the wrong
    landmark.
    """
    MP = m.mp_pos.shape[0]
    iota = jnp.arange(MP, dtype=jnp.int32)
    order_key = jnp.where(m.mp_valid, iota, iota + MP)  # stable, valid first
    perm = jnp.argsort(order_key).astype(jnp.int32)     # new pos -> old idx
    inv = jnp.zeros(MP, jnp.int32).at[perm].set(iota)   # old idx -> new pos
    inv_safe = jnp.where(m.mp_valid, inv, -1)

    gather = lambda a: a[perm]
    bound_valid = (m.kf_mp >= 0) & m.mp_valid[jnp.clip(m.kf_mp, 0)]
    kf_mp = jnp.where(bound_valid, inv[jnp.clip(m.kf_mp, 0)], -1)
    m = m._replace(
        mp_pos=gather(m.mp_pos),
        mp_valid=gather(m.mp_valid),
        mp_desc=gather(m.mp_desc),
        mp_normal=gather(m.mp_normal),
        mp_dmin=gather(m.mp_dmin),
        mp_dmax=gather(m.mp_dmax),
        mp_ref_kf=gather(m.mp_ref_kf),
        mp_nobs=gather(m.mp_nobs),
        mp_visible=gather(m.mp_visible),
        mp_found=gather(m.mp_found),
        obs_mat=m.obs_mat[:, perm],
        kf_mp=kf_mp,
    )
    return m, jnp.sum(m.mp_valid.astype(jnp.int32)), inv_safe


@jax.jit
def remap_point_bindings(mp_of_feat: jnp.ndarray,
                         inv: jnp.ndarray) -> jnp.ndarray:
    """Translate stale point bindings through a compaction remap.

    ``inv`` is the old->new index map from :func:`compact_map_points`
    (-1 for culled slots); unbound entries (-1) stay unbound.
    """
    return jnp.where(
        mp_of_feat >= 0, inv[jnp.clip(mp_of_feat, 0)], jnp.int32(-1)
    )


@jax.jit
def compose_point_remaps(first: jnp.ndarray,
                         second: jnp.ndarray) -> jnp.ndarray:
    """Compose two compaction remaps: oldest index -> newest index."""
    return jnp.where(
        first >= 0, second[jnp.clip(first, 0)], jnp.int32(-1)
    )


@jax.jit
def apply_ba_result(
    m: MapArrays,
    kf_slots: jnp.ndarray,   # (K,) int32 slots that were optimized
    kf_mask: jnp.ndarray,    # (K,) bool which entries are real
    Rcw: jnp.ndarray,        # (K, 3, 3)
    tcw: jnp.ndarray,
    mp_slots: jnp.ndarray,   # (M,) int32
    mp_mask: jnp.ndarray,    # (M,) bool
    pos: jnp.ndarray,        # (M, 3)
) -> MapArrays:
    """Write optimized poses/points back into the map.

    Scatter of the *masked delta* (add), not the value (set): padded window
    entries contribute exactly zero, so duplicate/colliding padded slot
    indices can never clobber a real update.
    """
    dR = jnp.where(kf_mask[:, None, None], Rcw - m.kf_Rcw[kf_slots], 0.0)
    dt = jnp.where(kf_mask[:, None], tcw - m.kf_tcw[kf_slots], 0.0)
    dp = jnp.where(mp_mask[:, None], pos - m.mp_pos[mp_slots], 0.0)
    return m._replace(
        kf_Rcw=m.kf_Rcw.at[kf_slots].add(dR),
        kf_tcw=m.kf_tcw.at[kf_slots].add(dt),
        mp_pos=m.mp_pos.at[mp_slots].add(dp),
    )


@jax.jit
def apply_scaled_rotation_map(
    m: MapArrays, Ryw: jnp.ndarray, scale: jnp.ndarray
) -> MapArrays:
    """Gravity-align + rescale the whole map in place.

    Map-level version of ``Map::ApplyScaledRotation``
    (`/root/reference/include/Map.h:93`, called from
    ``LocalMapping::InitializeIMU`` `src/LocalMapping.cc:1385`):
    world points x' = s * Ryw x; camera poses Tcw' = Tcw * Tw'w with
    Rcw' = Rcw Ryw^T and tcw' = s * tcw (rotation absorbed, translation
    rescaled); scale-invariance distances rescale; normals rotate.
    """
    R_new = jnp.einsum("kij,lj->kil", m.kf_Rcw, Ryw)
    return m._replace(
        kf_Rcw=R_new,
        kf_tcw=m.kf_tcw * scale,
        mp_pos=scale * jnp.einsum("ij,nj->ni", Ryw, m.mp_pos),
        mp_normal=jnp.einsum("ij,nj->ni", Ryw, m.mp_normal),
        mp_dmin=m.mp_dmin * scale,
        mp_dmax=m.mp_dmax * scale,
    )
