"""Sim3 refinement for loop verification.

The reference's verification ladder after Sim3 RANSAC
(`/root/reference/src/LoopClosing.cc:555+` DetectCommonRegionsFromBoW):

1. ``ORBmatcher::SearchBySim3`` (`src/ORBmatcher.cc:1947`) — grow the match
   set by projecting each keyframe's map points into the other through the
   candidate Sim3, both directions, keeping agreements;
2. ``Optimizer::OptimizeSim3`` (`src/Optimizer.cc:3190`) — Gauss-Newton on
   the 7-dof Sim3 minimizing two-sided REPROJECTION error (not 3D-3D),
   Huber sqrt(10), outlier removal between rounds;
3. accept only with >= 20 post-optimization inliers.

Batched form: the two projection-matching directions are two masked
Hamming matrices + window gates; the GN loop runs over fixed-size pair
tables with invalid rows zero-weighted.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import so3
from orb_slam3_noted_tpu.models import cameras as cam_mod
from orb_slam3_noted_tpu.ops import matching as M
from orb_slam3_noted_tpu.ops import orb as O

_HP = jax.lax.Precision.HIGHEST
CHI2_SIM3 = 9.99  # reference OptimizeSim3 th2 = 10


class Sim3RefineResult(NamedTuple):
    R: jnp.ndarray         # (3, 3) refined S_cur_cand rotation
    t: jnp.ndarray         # (3,)
    s: jnp.ndarray         # ()
    n_inliers: jnp.ndarray  # () int32 post-optimization inliers
    n_matches: jnp.ndarray  # () int32 pairs entering the optimization


def _cam_points(m, slot):
    """(NF, 3) bound map points in the keyframe's camera frame + validity."""
    mp = m.kf_mp[slot]
    ok = (mp >= 0) & m.kf_feat_valid[slot] & m.mp_valid[jnp.clip(mp, 0)]
    X = m.mp_pos[jnp.clip(mp, 0)]
    Xc = jnp.einsum("ij,nj->ni", m.kf_Rcw[slot], X, precision=_HP) + m.kf_tcw[slot]
    return Xc, ok


def _project_match(cam, Xc_src, src_ok, desc_src, S, xy_tgt, lvl_tgt,
                   desc_tgt, tgt_ok, sf, width, height, radius_px=7.5):
    """Match source camera-frame points into target features through Sim3 S.

    One direction of ``SearchBySim3``: radius 7.5 * scale of the target
    feature's octave, TH_HIGH gate.  Returns (tgt_idx per source, matched).
    """
    R, t, s = S
    Xt = s * jnp.einsum("ij,nj->ni", R, Xc_src, precision=_HP) + t
    uv = cam_mod.project(cam, Xt)
    z_ok = Xt[:, 2] > 0.05
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    )
    d = M.hamming_matrix(desc_src, desc_tgt)
    du = uv[:, None, 0] - xy_tgt[None, :, 0]
    dv = uv[:, None, 1] - xy_tgt[None, :, 1]
    r = radius_px * sf[lvl_tgt]
    inside = (du * du + dv * dv) <= (r[None, :] ** 2)
    gate = (
        inside & (src_ok & z_ok & in_img)[:, None] & tgt_ok[None, :]
    )
    masked = jnp.where(gate, d, M.BIG)
    best = jnp.min(masked, axis=1)
    idx = jnp.argmin(masked, axis=1).astype(jnp.int32)
    matched = best <= M.TH_HIGH
    return idx, matched


@partial(jax.jit, static_argnames=("cam", "cfg"))
def search_by_sim3(m, slot_cur, slot_cand, R0, t0, s0, cam, cfg,
                   seed_idx=None, seed_ok=None):
    """Grow cur<->cand feature pairs through the candidate Sim3.

    Returns (cand_of_cur (NF,) int32, ok (NF,)): for each current-KF
    feature with a bound point, the agreeing candidate-KF feature.
    ``seed_*`` optionally carries the pre-existing (e.g. BoW/RANSAC)
    matches, which are kept (the reference only fills empty slots).
    """
    sf = jnp.asarray(O.scale_factors(cfg.n_levels, cfg.scale_factor),
                     m.kf_xy.dtype)
    Xc_cur, ok_cur = _cam_points(m, slot_cur)
    Xc_cand, ok_cand = _cam_points(m, slot_cand)
    S12 = (R0, t0, s0)                       # cand -> cur
    Rt = R0.T
    S21 = (Rt, -jnp.einsum("ij,j->i", Rt, t0) / s0, 1.0 / s0)

    # direction 1: candidate points -> current features
    idx1, ok1 = _project_match(
        cam, Xc_cand, ok_cand, m.kf_desc[slot_cand], S12,
        m.kf_xy[slot_cur], m.kf_level[slot_cur], m.kf_desc[slot_cur],
        ok_cur, sf, cfg.width, cfg.height,
    )
    # direction 2: current points -> candidate features
    idx2, ok2 = _project_match(
        cam, Xc_cur, ok_cur, m.kf_desc[slot_cur], S21,
        m.kf_xy[slot_cand], m.kf_level[slot_cand], m.kf_desc[slot_cand],
        ok_cand, sf, cfg.width, cfg.height,
    )
    # agreement (reference "CheckAgreement"): cand i -> cur j AND cur j -> cand i.
    # idx2[j] == i pins a unique cand feature per cur slot, so the scatter
    # below never collides; misses land in the sliced-away scratch slot.
    NF = m.kf_xy.shape[1]
    j = idx1                       # (NF,) cur feature per cand feature
    agree = ok1 & ok2[j] & (idx2[j] == jnp.arange(NF, dtype=jnp.int32))
    cand_of_cur = (
        jnp.full((NF + 1,), -1, jnp.int32)
        .at[jnp.where(agree, j, NF)]
        .set(jnp.where(agree, jnp.arange(NF, dtype=jnp.int32), -1))[:NF]
    )
    ok = cand_of_cur >= 0
    if seed_idx is not None:
        keep_seed = seed_ok & ~ok
        cand_of_cur = jnp.where(keep_seed, seed_idx, cand_of_cur)
        ok = ok | keep_seed
    return cand_of_cur, ok


def _sim3_residuals(cam, R, t, s, Xc_cand, Xc_cur, uv_cur, uv_cand,
                    inv_s2_cur, inv_s2_cand, ok):
    """Two-sided reprojection residuals + Jacobians wrt the 7-dof update.

    Update is left-multiplicative: S <- exp(rho, phi, sigma) S with
    exp acting as x -> (1+sigma)(x + rho + phi x x) to first order.
    """
    Rt = R.T
    # forward: x1_hat = S x2
    X1 = s * jnp.einsum("ij,nj->ni", R, Xc_cand, precision=_HP) + t
    # inverse: x2_hat = S^-1 x1
    X2 = jnp.einsum("ij,nj->ni", Rt, Xc_cur - t, precision=_HP) / s

    params = cam.params_array(X1.dtype)
    if cam.kind == cam_mod.PINHOLE:
        uv1 = cam_mod.pinhole_project(params, X1)
        J1p = cam_mod.pinhole_project_jac(params, X1)
        uv2 = cam_mod.pinhole_project(params, X2)
        J2p = cam_mod.pinhole_project_jac(params, X2)
    else:
        uv1 = cam_mod.kb8_project(params, X1)
        J1p = cam_mod.kb8_project_jac(params, X1)
        uv2 = cam_mod.kb8_project(params, X2)
        J2p = cam_mod.kb8_project_jac(params, X2)

    r1 = uv_cur - uv1                      # (N, 2)
    r2 = uv_cand - uv2
    # d X1 / d(rho, phi, sigma) = [I | -hat(X1) | X1]
    N = X1.shape[0]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=X1.dtype), (N, 3, 3))
    dX1 = jnp.concatenate([eye, -so3.hat(X1), X1[:, :, None]], axis=-1)
    # d X2 / d delta = -(1/s) R^T [I | -hat(x1) | x1] evaluated at x1 = S x2...
    # X2 = S^-1 x1 with x1 fixed: S_new^-1 = S^-1 exp(-delta),
    # X2_new = S^-1 (x1 - (rho + phi x x1 + sigma x1)) to first order
    x1 = Xc_cur
    dx1 = jnp.concatenate([eye, -so3.hat(x1), x1[:, :, None]], axis=-1)
    dX2 = -jnp.einsum("ij,njk->nik", Rt / s, dx1, precision=_HP)

    J1 = -jnp.einsum("nab,nbc->nac", J1p, dX1, precision=_HP)  # (N, 2, 7)
    J2 = -jnp.einsum("nab,nbc->nac", J2p, dX2, precision=_HP)
    ok1 = ok & (X1[:, 2] > 1e-4)
    ok2 = ok & (X2[:, 2] > 1e-4)
    chi1 = jnp.where(ok1, jnp.sum(r1 * r1, -1) * inv_s2_cur, 0.0)
    chi2_ = jnp.where(ok2, jnp.sum(r2 * r2, -1) * inv_s2_cand, 0.0)
    z = lambda a, m_: jnp.nan_to_num(a * m_[:, None, None] if a.ndim == 3
                                     else a * m_[:, None])
    return (z(r1, ok1), z(J1, ok1), chi1, ok1,
            z(r2, ok2), z(J2, ok2), chi2_, ok2)


@partial(jax.jit, static_argnames=("cam", "fix_scale", "n_iters"))
def optimize_sim3(
    cam, R0, t0, s0,
    Xc_cand, Xc_cur, uv_cur, uv_cand, inv_s2_cur, inv_s2_cand, ok,
    fix_scale: bool = False, n_iters: int = 10,
):
    """GN on the 7-dof Sim3 with Huber(sqrt(10)) and mid-way reclassification.

    Mirrors ``Optimizer::OptimizeSim3`` (`src/Optimizer.cc:3190`): 5
    iterations, drop chi2 > 10 edges, 5-10 more iterations; returns the
    refined Sim3 and the post-optimization inlier count (edges counted as
    the reference does: a PAIR is an inlier when both its edges survive).
    """
    dtype = t0.dtype

    def gn(state, active, n):
        def body(_, st):
            R, t, s = st
            r1, J1, c1, o1, r2, J2, c2, o2 = _sim3_residuals(
                cam, R, t, s, Xc_cand, Xc_cur, uv_cur, uv_cand,
                inv_s2_cur, inv_s2_cand, active,
            )
            w1 = jnp.where(o1, inv_s2_cur, 0.0) * jnp.minimum(
                1.0, jnp.sqrt(CHI2_SIM3 / jnp.maximum(c1, 1e-12))
            )
            w2 = jnp.where(o2, inv_s2_cand, 0.0) * jnp.minimum(
                1.0, jnp.sqrt(CHI2_SIM3 / jnp.maximum(c2, 1e-12))
            )
            H = (
                jnp.einsum("nai,na,naj->ij", J1,
                           jnp.broadcast_to(w1[:, None], r1.shape), J1,
                           precision=_HP)
                + jnp.einsum("nai,na,naj->ij", J2,
                             jnp.broadcast_to(w2[:, None], r2.shape), J2,
                             precision=_HP)
            )
            g = (
                jnp.einsum("nai,na->i", J1, w1[:, None] * r1, precision=_HP)
                + jnp.einsum("nai,na->i", J2, w2[:, None] * r2, precision=_HP)
            )
            H = H + 1e-3 * jnp.diag(jnp.diagonal(H)) + 1e-6 * jnp.eye(
                7, dtype=dtype
            )
            dx = jnp.linalg.solve(H, -g)
            dx = jnp.nan_to_num(dx)
            if fix_scale:
                dx = dx.at[6].set(0.0)
            rho, phi, sig = dx[:3], dx[3:6], dx[6]
            dR = so3.exp(phi)
            es = jnp.exp(sig)
            R_new = so3.normalize(dR @ R)
            t_new = es * jnp.einsum("ij,j->i", dR, t) + rho
            s_new = es * s
            return (R_new, t_new, s_new)

        return jax.lax.fori_loop(0, n, body, state)

    state = (R0, t0, s0)
    state = gn(state, ok, 5)
    _, _, c1, o1, _, _, c2, o2 = _sim3_residuals(
        cam, *state, Xc_cand, Xc_cur, uv_cur, uv_cand,
        inv_s2_cur, inv_s2_cand, ok,
    )
    pair_in = ok & o1 & o2 & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)
    state = gn(state, pair_in, n_iters)
    _, _, c1, o1, _, _, c2, o2 = _sim3_residuals(
        cam, *state, Xc_cand, Xc_cur, uv_cur, uv_cand,
        inv_s2_cur, inv_s2_cand, ok,
    )
    inlier = ok & o1 & o2 & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)
    R, t, s = state
    return Sim3RefineResult(
        R=R, t=t, s=s,
        n_inliers=jnp.sum(inlier.astype(jnp.int32)),
        n_matches=jnp.sum(ok.astype(jnp.int32)),
    )


@partial(jax.jit, static_argnames=("cam", "cfg"))
def sim3_refine(m, slot_cur, slot_cand, R0, t0, s0, cam, cfg,
                seed_idx=None, seed_ok=None):
    """Full ladder step: SearchBySim3 growth + reprojection OptimizeSim3.

    Returns :class:`Sim3RefineResult`; the caller gates on
    ``n_inliers >= 20`` (reference `src/LoopClosing.cc:776` nInliers gate).
    """
    cand_of_cur, ok = search_by_sim3(
        m, slot_cur, slot_cand, R0, t0, s0, cam, cfg,
        seed_idx=seed_idx, seed_ok=seed_ok,
    )
    Xc_cur, ok_cur = _cam_points(m, slot_cur)
    Xc_cand, ok_cand = _cam_points(m, slot_cand)
    ci = jnp.clip(cand_of_cur, 0)
    pair_ok = ok & ok_cur & ok_cand[ci]
    sigma2 = jnp.asarray(cfg.level_sigma2, m.kf_xy.dtype)
    return optimize_sim3(
        cam, R0, t0, s0,
        Xc_cand[ci], Xc_cur,
        m.kf_xy[slot_cur], m.kf_xy[slot_cand][ci],
        1.0 / sigma2[m.kf_level[slot_cur]],
        1.0 / sigma2[m.kf_level[slot_cand][ci]],
        pair_ok,
    )
