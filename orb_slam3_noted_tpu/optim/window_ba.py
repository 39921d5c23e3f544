"""Dense-Schur windowed bundle adjustment — the per-keyframe hot solver.

Equivalent of ``Optimizer::LocalBundleAdjustment``
(`/root/reference/src/Optimizer.cc:1611`): a handful of free window poses,
fixed anchor cameras, and the landmarks they see.  The round-2 engine solved
this with the matrix-free Schur/PCG machinery built for Atlas-scale GBA
(:mod:`orb_slam3_noted_tpu.optim.gba`); correct, but each CG iteration is a
chain of O(10) tiny kernels, and 24 iterations x ~10 LM steps make a long
sequential chain of small launches per solve.

This engine exploits the window structure instead: with KW <= ~10 free poses
the reduced camera system S is only (KW*6, KW*6), so it is assembled
EXACTLY with three batched einsum contractions (dense work, no iteration):

    U_m   = (KW, 6, 3) pose-point coupling per landmark (one segment-sum)
    S     = blkdiag(Hpp) - sum_m U_m Hll_m^-1 U_m^T
    rhs   = -gp + sum_m U_m Hll_m^-1 gl_m

followed by ONE dense solve and closed-form landmark back-substitution.
One LM step is ~15 fused kernels regardless of iteration counts inside CG —
measured ~8x faster than the PCG path at bench scale.

Anchor (fixed) observations carry ``wpose_idx == KW``: their pose Jacobians
are dropped (they only constrain the landmarks), reproducing the reference's
``lFixedCameras`` exactly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import se3, so3
from orb_slam3_noted_tpu.ops.segsum import segment_sum_mxu
from orb_slam3_noted_tpu.geometry.linalg3 import inv3
from orb_slam3_noted_tpu.models import cameras as cam_mod
from orb_slam3_noted_tpu.optim import factors
from orb_slam3_noted_tpu.optim.robust import (
    CHI2_MONO,
    CHI2_STEREO,
    chi2_threshold,
    huber_cost,
    huber_weight,
)

_HP = jax.lax.Precision.HIGHEST


class WindowObs(NamedTuple):
    """Observation table for the windowed solver.

    ``pose_idx`` indexes the FULL pose table (for residual evaluation —
    anchors keep their true poses); ``wpose_idx`` is the compact window
    index in [0, KW), or KW for anchor rows (pose treated as fixed).
    """

    pose_idx: jnp.ndarray    # (O,) int32 into full pose table
    wpose_idx: jnp.ndarray   # (O,) int32 into window table, KW = anchor
    point_idx: jnp.ndarray   # (O,) int32 into landmark table
    uv: jnp.ndarray          # (O, 2)
    uv_r: jnp.ndarray        # (O,)
    inv_sigma2: jnp.ndarray  # (O,)
    is_stereo: jnp.ndarray   # (O,) bool
    valid: jnp.ndarray       # (O,) bool
    uv2: jnp.ndarray | None = None       # (O, 2) right-camera obs (fisheye)
    is_right: jnp.ndarray | None = None  # (O,) bool


class WindowBAResult(NamedTuple):
    Rcw: jnp.ndarray     # (KF+1, 3, 3) updated FULL pose table (padded row last)
    tcw: jnp.ndarray     # (KF+1, 3)
    points: jnp.ndarray  # (M, 3)
    inlier: jnp.ndarray  # (O,) bool
    cost: jnp.ndarray


def _reproj_obs(obs: WindowObs, active) -> factors.ReprojObs:
    return factors.ReprojObs(
        pose_idx=obs.pose_idx,
        point_idx=obs.point_idx,
        uv=obs.uv,
        uv_r=obs.uv_r,
        inv_sigma2=obs.inv_sigma2,
        is_stereo=obs.is_stereo,
        valid=active,
        uv2=obs.uv2,
        is_right=obs.is_right,
    )


def _evaluate(cam, Rcw, tcw, points, obs, active, use_huber, bf,
              cam2=None, Rrl=None, trl=None):
    r, Jp, Jl, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw, tcw, points, _reproj_obs(obs, active), bf=bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    delta2 = chi2_threshold(obs)
    w_rob = jnp.where(use_huber, huber_weight(chi2, delta2), 1.0)
    w = jnp.where(ok, obs.inv_sigma2 * w_rob, 0.0)
    cost = jnp.sum(
        jnp.where(ok, jnp.where(use_huber, huber_cost(chi2, delta2), chi2), 0.0)
    )
    return r, Jp, Jl, chi2, w, ok, cost


def _lm_step(cam, Rcw, tcw, points, obs, kf_slots, pose_fixed_w, point_fixed,
             active, use_huber, lam, bf, KW, lin, cost_old,
             cam2=None, Rrl=None, trl=None):
    """One cost-checked LM step with the dense reduced camera system.

    ``lin`` = (r, Jp, Jl, w) is the linearization at the CURRENT state,
    carried across iterations: an accepted step's candidate evaluation
    becomes the next step's linearization, a rejected step reuses the old
    one — so each LM step costs exactly ONE residual/Jacobian evaluation
    (the two-evals-per-step of the round-2 engines doubled the hot cost).
    """
    M = points.shape[0]
    dtype = tcw.dtype
    r, Jp, Jl, w = lin
    # window-free mask: anchors (wpose==KW) and fixed window poses drop Jp
    wfree = jnp.concatenate(
        [(~pose_fixed_w).astype(dtype), jnp.zeros((1,), dtype)]
    )
    point_free = (~point_fixed).astype(dtype)
    Jp = Jp * wfree[obs.wpose_idx][:, None, None]
    Jl = Jl * point_free[obs.point_idx][:, None, None]

    wJp = w[:, None, None] * Jp
    W_o = jnp.einsum("oai,oaj->oij", wJp, Jl, precision=_HP)       # (O, 6, 3)
    Hpp = segment_sum_mxu(
        jnp.einsum("oai,oaj->oij", wJp, Jp, precision=_HP),
        obs.wpose_idx, num_segments=KW + 1,
    )[:KW]
    gp = segment_sum_mxu(
        jnp.einsum("oai,oa->oi", Jp, w[:, None] * r, precision=_HP),
        obs.wpose_idx, num_segments=KW + 1,
    )[:KW]
    Hll = segment_sum_mxu(
        jnp.einsum("oai,oaj->oij", w[:, None, None] * Jl, Jl, precision=_HP),
        obs.point_idx, num_segments=M,
    )
    gl = segment_sum_mxu(
        jnp.einsum("oai,oa->oi", Jl, w[:, None] * r, precision=_HP),
        obs.point_idx, num_segments=M,
    )

    eye6 = jnp.eye(6, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)
    Hpp_d = Hpp + lam * Hpp * eye6 + (
        1e-8 + pose_fixed_w.astype(dtype)
    )[:, None, None] * eye6
    Hll_d = Hll + lam * Hll * eye3 + (
        1e-8 + point_fixed.astype(dtype)
    )[:, None, None] * eye3
    Cinv = inv3(Hll_d)

    # per-landmark pose coupling U_m = sum_o 1[point_o=m] 1[wpose_o=p] W_o:
    # expand the (small) wpose one-hot elementwise, then ONE point-indexed
    # reduction.  Anchor rows have W_o == 0 (Jp masked), so the dropped
    # tail column costs nothing.
    ohp = (
        obs.wpose_idx[:, None] == jnp.arange(KW, dtype=obs.wpose_idx.dtype)
    ).astype(dtype)                                          # (O, KW)
    WP = W_o[:, None, :, :] * ohp[:, :, None, None]          # (O, KW, 6, 3)
    # bf16 operands: this is the big contraction (O x M x KW*18 MACs); the
    # 0.4% operand rounding only perturbs the Schur coupling — every LM
    # step is cost-checked against the EXACT robust cost, so a slightly
    # off step direction can never diverge the solve
    U = segment_sum_mxu(WP, obs.point_idx, num_segments=M,
                        precision=jax.lax.Precision.DEFAULT)  # (M, KW, 6, 3)

    T1 = jnp.einsum("mpab,mbc->mpac", U, Cinv, precision=_HP)
    S_sub = jnp.einsum("mpac,mqbc->paqb", T1, U, precision=_HP)  # (KW,6,KW,6)
    S = -S_sub
    S = S.at[jnp.arange(KW), :, jnp.arange(KW), :].add(Hpp_d)
    rhs = -gp + jnp.einsum("mpac,mc->pa", T1, gl, precision=_HP)

    n = KW * 6
    dp = jnp.linalg.solve(S.reshape(n, n), rhs.reshape(n)).reshape(KW, 6)
    dp = jnp.nan_to_num(dp) * (~pose_fixed_w)[:, None]
    # landmark back-substitution: dl = Hll^-1 (-gl - U^T dp)
    utdp = jnp.einsum("mpab,pa->mb", U, dp, precision=_HP)
    dl = jnp.einsum("mbc,mc->mb", Cinv, -gl - utdp, precision=_HP)
    dl = jnp.nan_to_num(dl) * point_free[:, None]

    # apply window pose updates into the full (padded) table
    Rw, tw = Rcw[kf_slots], tcw[kf_slots]
    Rw_new, tw_new = se3.compose(se3.exp(dp), (Rw, tw))
    Rw_new = so3.normalize(Rw_new)
    R_new = Rcw.at[kf_slots].set(Rw_new)
    t_new = tcw.at[kf_slots].set(tw_new)
    p_new = points + dl
    r2, Jp2, Jl2, _, w2, _, cost_new = _evaluate(
        cam, R_new, t_new, p_new, obs, active, use_huber, bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    better = cost_new < cost_old
    sel = lambda a, b: jnp.where(better, a, b)
    Rcw = sel(R_new, Rcw)
    tcw = sel(t_new, tcw)
    points = sel(p_new, points)
    lin = jax.tree_util.tree_map(sel, (r2, Jp2, Jl2, w2), (r, Jp, Jl, w))
    lam = jnp.where(better, lam * 0.5, lam * 5.0)
    return Rcw, tcw, points, lam, lin, jnp.minimum(cost_new, cost_old)


@partial(
    jax.jit,
    static_argnames=("cam", "bf", "n_iters", "n_iters_final", "cam2"),
)
def window_bundle_adjust(
    cam: cam_mod.Camera,
    Rcw_full: jnp.ndarray,      # (KF+1, 3, 3) full pose table + scratch row
    tcw_full: jnp.ndarray,      # (KF+1, 3)
    points: jnp.ndarray,        # (M, 3)
    obs: WindowObs,
    kf_slots: jnp.ndarray,      # (KW,) window slots into the full table
    pose_fixed_w: jnp.ndarray,  # (KW,) bool (gauge anchors / padding)
    point_fixed: jnp.ndarray,   # (M,) bool
    bf: float = 0.0,
    n_iters: int = 5,
    n_iters_final: int = 5,
    cam2: cam_mod.Camera | None = None,
    Rrl: jnp.ndarray | None = None,
    trl: jnp.ndarray | None = None,
) -> WindowBAResult:
    """Two-phase LM (Huber -> chi2 reclassify -> plain LS), dense Schur.

    Mirrors ``LocalBundleAdjustment``'s 5-then-10 schedule with kernel
    removal (`src/Optimizer.cc:1611+`); cost-checked adaptive damping.
    """
    KW = kf_slots.shape[0]
    Rcw, tcw, pts = Rcw_full, tcw_full, points

    def phase(Rcw, tcw, pts, active, use_huber, n):
        if n <= 0:
            return Rcw, tcw, pts
        r0, Jp0, Jl0, _, w0, _, cost0 = _evaluate(
            cam, Rcw, tcw, pts, obs, active, use_huber, bf,
            cam2=cam2, Rrl=Rrl, trl=trl,
        )

        def body(_, st):
            Rcw, tcw, pts, lam, lin, cost = st
            Rcw, tcw, pts, lam, lin, cost = _lm_step(
                cam, Rcw, tcw, pts, obs, kf_slots, pose_fixed_w, point_fixed,
                active, use_huber, lam, bf, KW, lin, cost,
                cam2=cam2, Rrl=Rrl, trl=trl,
            )
            return (Rcw, tcw, pts, lam, lin, cost)

        Rcw, tcw, pts, _, _, _ = jax.lax.fori_loop(
            0, n, body,
            (Rcw, tcw, pts, jnp.asarray(1e-4, tcw.dtype),
             (r0, Jp0, Jl0, w0), cost0),
        )
        return Rcw, tcw, pts

    Rcw, tcw, pts = phase(Rcw, tcw, pts, obs.valid, jnp.asarray(True), n_iters)
    _, _, _, chi2, _, ok, _ = _evaluate(
        cam, Rcw, tcw, pts, obs, obs.valid, jnp.asarray(True), bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    th = chi2_threshold(obs)
    active = obs.valid & ok & (chi2 <= th)
    Rcw, tcw, pts = phase(Rcw, tcw, pts, active, jnp.asarray(False), n_iters_final)

    _, _, _, chi2, _, ok, cost = _evaluate(
        cam, Rcw, tcw, pts, obs, obs.valid, jnp.asarray(False), bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    inlier = obs.valid & ok & (chi2 <= th)
    return WindowBAResult(Rcw=Rcw, tcw=tcw, points=pts, inlier=inlier, cost=cost)
