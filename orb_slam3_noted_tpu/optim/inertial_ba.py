"""Joint visual-inertial bundle adjustment (one engine, many entry points).

Batched replacement for the reference's inertial g2o optimizations
(`/root/reference/src/Optimizer.cc`):

- ``LocalInertialBA`` (`:3900`): temporal window of body states + local map
  points, inertial chain edges, bias random walks, reprojection factors.
- ``FullInertialBA`` (`:391`): same factor families over all keyframes, with
  optional gyro/acc bias priors (used right after IMU initialization).
- ``PoseInertialOptimizationLastKeyFrame/LastFrame`` (`:6630,7018`): the
  motion-only special case — K=2 states, anchor fixed (or held by a 15-dim
  prior), landmarks fixed.

Design (SURVEY §7 phase D): body states are a (K, 15) SoA table; landmarks
are Schur-marginalized exactly as in :mod:`orb_slam3_noted_tpu.optim.ba`;
inertial/bias/prior factors contribute dense 15x15 blocks assembled by
scatter-add (the temporal chain has O(K) edges — tiny next to the
reprojection table, which rides segment_sum + einsums).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry.linalg3 import inv3
from orb_slam3_noted_tpu.imu.preintegration import Calib
from orb_slam3_noted_tpu.models import cameras as cam_mod
from orb_slam3_noted_tpu.optim import factors
from orb_slam3_noted_tpu.optim.robust import (
    CHI2_MONO,
    CHI2_STEREO,
    huber_cost,
    huber_weight,
)
from orb_slam3_noted_tpu.optim.vi_factors import (
    InertialEdges,
    VIPrior,
    VIState,
    bias_rw_residuals,
    body_reproj_residuals,
    inertial_edge_residuals,
    prior_residuals,
    retract,
)

_HP = jax.lax.Precision.HIGHEST

# Huber delta^2 for inertial edges in LocalInertialBA
# (`src/Optimizer.cc` sets sqrt(16.92))
CHI2_INERTIAL = 16.92


class VIBAProblem(NamedTuple):
    state: VIState            # (K,) body states
    points: jnp.ndarray       # (M, 3)
    obs: factors.ReprojObs    # (O,) reprojection table
    edges: InertialEdges      # (E,) temporal chain
    pose_fixed: jnp.ndarray   # (K,) bool
    point_fixed: jnp.ndarray  # (M,) bool
    prior: VIPrior            # optional anchor prior (valid flag inside)


class VIBAResult(NamedTuple):
    state: VIState
    points: jnp.ndarray
    chi2: jnp.ndarray    # (O,) reprojection chi2 after optimization
    inlier: jnp.ndarray  # (O,)
    cost: jnp.ndarray    # () total (visual robust + inertial) cost


def no_prior(dtype=jnp.float32) -> VIPrior:
    return VIPrior(
        idx=jnp.zeros((), jnp.int32),
        Rwb=jnp.eye(3, dtype=dtype), twb=jnp.zeros(3, dtype),
        vel=jnp.zeros(3, dtype), bg=jnp.zeros(3, dtype), ba=jnp.zeros(3, dtype),
        sqrt_info=jnp.zeros((15, 15), dtype),
        valid=jnp.zeros((), bool),
    )


def _visual_eval(cam, st, calib, points, obs, active, use_huber, bf,
                 cam2=None, Rrl=None, trl=None):
    r, Jp, Jl, chi2, ok = body_reproj_residuals(
        cam, st, calib, points, obs._replace(valid=active), bf=bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    delta2 = jnp.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    w_rob = jnp.where(use_huber, huber_weight(chi2, delta2), 1.0)
    w = jnp.where(ok, obs.inv_sigma2 * w_rob, 0.0)
    cost = jnp.sum(
        jnp.where(ok, jnp.where(use_huber, huber_cost(chi2, delta2), chi2), 0.0)
    )
    return r, Jp, Jl, chi2, w, ok, cost


def _inertial_eval(st, edges, prior, use_huber_inertial, bias_prior_g,
                   bias_prior_a):
    """Residual/Jacobian bundle for the non-visual factors + their cost."""
    ri, Ji, Jj = inertial_edge_residuals(st, edges)
    chi2_i = jnp.sum(ri * ri, axis=-1)
    w_i = jnp.where(
        use_huber_inertial, huber_weight(chi2_i, CHI2_INERTIAL), 1.0
    )
    rb, wb = bias_rw_residuals(st, edges)
    rp, Jp = prior_residuals(st, prior)
    cost = (
        jnp.sum(jnp.where(use_huber_inertial,
                          huber_cost(chi2_i, CHI2_INERTIAL), chi2_i))
        + jnp.sum(rb * rb)
        + jnp.sum(rp * rp)
        + bias_prior_g * jnp.sum(st.bg * st.bg)
        + bias_prior_a * jnp.sum(st.ba * st.ba)
    )
    return (ri, Ji, Jj, w_i), (rb, wb), (rp, Jp), cost


def _vi_lm_step(cam, calib, st, points, prob, active, use_huber, lam, bf,
                use_huber_inertial, bpg, bpa, cam2=None, Rrl=None, trl=None):
    K = st.twb.shape[0]
    M = points.shape[0]
    E = prob.edges.i.shape[0]
    dtype = st.twb.dtype
    obs = prob.obs

    r, Jp6, Jl, chi2, w, ok, vcost = _visual_eval(
        cam, st, calib, points, obs, active, use_huber, bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    (ri, Ji, Jj, w_i), (rb, wb), (rp, Jpr), icost = _inertial_eval(
        st, prob.edges, prob.prior, use_huber_inertial, bpg, bpa
    )
    cost_old = vcost + icost

    pose_free = (~prob.pose_fixed).astype(dtype)
    point_free = (~prob.point_fixed).astype(dtype)
    Jp6 = Jp6 * pose_free[obs.pose_idx][:, None, None]
    Jl = Jl * point_free[obs.point_idx][:, None, None]
    Ji = Ji * pose_free[prob.edges.i][:, None, None]
    Jj = Jj * pose_free[prob.edges.j][:, None, None]
    Jpr = Jpr * pose_free[prob.prior.idx]

    # ---- visual blocks (pose part touches tangent rows 0:6 only) ----
    wJp = w[:, None, None] * Jp6
    Hpp6_o = jnp.einsum("oai,oaj->oij", wJp, Jp6, precision=_HP)   # (O, 6, 6)
    Hll_o = jnp.einsum("oai,oaj->oij", w[:, None, None] * Jl, Jl, precision=_HP)
    W_o = jnp.einsum("oai,oaj->oij", wJp, Jl, precision=_HP)        # (O, 6, 3)
    gp6_o = jnp.einsum("oai,oa->oi", Jp6, w[:, None] * r, precision=_HP)
    gl_o = jnp.einsum("oai,oa->oi", Jl, w[:, None] * r, precision=_HP)

    Hpp6 = jax.ops.segment_sum(Hpp6_o, obs.pose_idx, num_segments=K)
    gp6 = jax.ops.segment_sum(gp6_o, obs.pose_idx, num_segments=K)
    Hll = jax.ops.segment_sum(Hll_o, obs.point_idx, num_segments=M)
    gl = jax.ops.segment_sum(gl_o, obs.point_idx, num_segments=M)

    # ---- dense state system H (K, 15, K, 15), g (K, 15) ----
    H = jnp.zeros((K, 15, K, 15), dtype)
    g = jnp.zeros((K, 15), dtype)
    kk = jnp.arange(K)
    H = H.at[kk, 0:6, kk, 0:6].add(Hpp6)
    g = g.at[:, 0:6].add(gp6)

    # inertial edges
    wJi = w_i[:, None, None] * Ji
    ei, ej = prob.edges.i, prob.edges.j
    H = H.at[ei, :, ei, :].add(
        jnp.einsum("eai,eaj->eij", wJi, Ji, precision=_HP))
    H = H.at[ej, :, ej, :].add(
        jnp.einsum("eai,eaj->eij", w_i[:, None, None] * Jj, Jj, precision=_HP))
    Hij = jnp.einsum("eai,eaj->eij", wJi, Jj, precision=_HP)
    H = H.at[ei, :, ej, :].add(Hij)
    H = H.at[ej, :, ei, :].add(jnp.swapaxes(Hij, -1, -2))
    g = g.at[ei].add(jnp.einsum("eai,ea->ei", Ji, w_i[:, None] * ri,
                                precision=_HP))
    g = g.at[ej].add(jnp.einsum("eai,ea->ei", Jj, w_i[:, None] * ri,
                                precision=_HP))

    # bias random walks: residual rows whitened; J_i = -diag(wb) on rows 9:15
    # of state i, J_j = +diag(wb) on state j
    free_i = pose_free[ei]
    free_j = pose_free[ej]
    wb_i = wb * free_i[:, None]
    wb_j = wb * free_j[:, None]
    bb = jnp.arange(9, 15)
    H = H.at[ei[:, None], bb[None, :], ei[:, None], bb[None, :]].add(
        wb_i * wb_i)
    H = H.at[ej[:, None], bb[None, :], ej[:, None], bb[None, :]].add(
        wb_j * wb_j)
    H = H.at[ei[:, None], bb[None, :], ej[:, None], bb[None, :]].add(
        -wb_i * wb_j)
    H = H.at[ej[:, None], bb[None, :], ei[:, None], bb[None, :]].add(
        -wb_i * wb_j)
    g = g.at[ei[:, None], bb[None, :]].add(-wb_i * rb)
    g = g.at[ej[:, None], bb[None, :]].add(wb_j * rb)

    # prior
    pk = prob.prior.idx
    H = H.at[pk, :, pk, :].add(
        jnp.einsum("ai,aj->ij", Jpr, Jpr, precision=_HP))
    g = g.at[pk].add(Jpr.T @ rp)

    # direct bias priors (FullInertialBA's EdgePriorGyro/EdgePriorAcc)
    H = H.at[kk[:, None], bb[None, :], kk[:, None], bb[None, :]].add(
        jnp.concatenate([
            jnp.full((K, 3), bpg, dtype), jnp.full((K, 3), bpa, dtype)
        ], axis=-1) * pose_free[:, None])
    g = g.at[:, 9:12].add(bpg * st.bg * pose_free[:, None])
    g = g.at[:, 12:15].add(bpa * st.ba * pose_free[:, None])

    # damping + gauge fixing
    diagH = jnp.diagonal(H.reshape(K * 15, K * 15))
    H = H.reshape(K * 15, K * 15)
    H = H + jnp.diag(lam * diagH)
    fixed_diag = jnp.repeat(prob.pose_fixed.astype(dtype), 15)
    H = H + jnp.diag(1e-6 + fixed_diag)

    # landmark blocks
    eye3 = jnp.eye(3, dtype=dtype)
    Hll = (
        Hll + lam * Hll * eye3
        + (1e-8 + prob.point_fixed.astype(dtype))[:, None, None] * eye3
    )
    Cinv = inv3(Hll)

    # Schur: U (K, 6, M, 3) — visual coupling only touches rows 0:6
    U = jnp.zeros((K, 6, M, 3), dtype).at[obs.pose_idx, :, obs.point_idx, :].add(W_o)
    V = jnp.einsum("kamb,mbc->kamc", U, Cinv, precision=_HP)
    S6 = jnp.einsum("kamc,jdmc->kajd", V, U, precision=_HP)  # (K, 6, K, 6)
    Sfull = jnp.zeros((K, 15, K, 15), dtype)
    Sfull = Sfull.at[:, 0:6, :, 0:6].set(S6)
    Hs = H - Sfull.reshape(K * 15, K * 15)
    rhs = -g
    rhs = rhs.at[:, 0:6].add(jnp.einsum("kamc,mc->ka", V, gl, precision=_HP))

    dp = jnp.linalg.solve(Hs, rhs.reshape(K * 15)).reshape(K, 15)
    dl = jnp.einsum(
        "mbc,mc->mb", Cinv,
        -gl - jnp.einsum("kamb,ka->mb", U, dp[:, 0:6], precision=_HP),
        precision=_HP,
    )

    st_new = retract(st, dp)
    p_new = points + dl
    *_, vcost_new = _visual_eval(
        cam, st_new, calib, p_new, obs, active, use_huber, bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    *_, icost_new = _inertial_eval(
        st_new, prob.edges, prob.prior, use_huber_inertial, bpg, bpa
    )
    better = (vcost_new + icost_new) < cost_old
    st = jax.tree_util.tree_map(
        lambda a, b: jnp.where(better, a, b), st_new, st
    )
    points = jnp.where(better, p_new, points)
    lam = jnp.where(better, lam * 0.5, lam * 5.0)
    return st, points, lam


@partial(jax.jit, static_argnames=("cam", "bf", "n_iters", "n_iters_final",
                                   "huber_inertial", "cam2"))
def visual_inertial_ba(
    cam: cam_mod.Camera,
    calib: Calib,
    prob: VIBAProblem,
    bf: float = 0.0,
    n_iters: int = 5,
    n_iters_final: int = 5,
    huber_inertial: bool = True,
    bias_prior_g: float = 0.0,
    bias_prior_a: float = 0.0,
    cam2: cam_mod.Camera | None = None,
    Rrl: jnp.ndarray | None = None,
    trl: jnp.ndarray | None = None,
) -> VIBAResult:
    """LM over body states + landmarks with the reference's two-phase
    schedule (robust first phase, chi2 outlier cut, clean second phase)."""
    obs = prob.obs
    st, points = prob.state, prob.points
    bpg = jnp.asarray(bias_prior_g, st.twb.dtype)
    bpa = jnp.asarray(bias_prior_a, st.twb.dtype)
    hub_i = jnp.asarray(huber_inertial)

    def phase(st, points, active, use_huber, n):
        def body(_, s):
            st, points, lam = s
            st, points, lam = _vi_lm_step(
                cam, calib, st, points, prob, active, use_huber, lam, bf,
                hub_i, bpg, bpa, cam2=cam2, Rrl=Rrl, trl=trl,
            )
            return (st, points, lam)

        st, points, _ = jax.lax.fori_loop(
            0, n, body, (st, points, jnp.asarray(1e-2, st.twb.dtype))
        )
        return st, points

    st, points = phase(st, points, obs.valid, jnp.asarray(True), n_iters)
    _, _, _, chi2, _, ok, _ = _visual_eval(
        cam, st, calib, points, obs, obs.valid, jnp.asarray(True), bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    th = jnp.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    active = obs.valid & ok & (chi2 <= th)
    st, points = phase(st, points, active, jnp.asarray(False), n_iters_final)

    _, _, _, chi2, _, ok, vcost = _visual_eval(
        cam, st, calib, points, obs, obs.valid, jnp.asarray(False), bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    *_, icost = _inertial_eval(st, prob.edges, prob.prior, hub_i, bpg, bpa)
    inlier = obs.valid & ok & (chi2 <= th)
    return VIBAResult(
        state=st, points=points, chi2=chi2, inlier=inlier, cost=vcost + icost
    )


class VIPoseOptResult(NamedTuple):
    Rwb: jnp.ndarray
    twb: jnp.ndarray
    vel: jnp.ndarray
    bg: jnp.ndarray
    ba: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


@partial(jax.jit, static_argnames=("cam", "bf", "cam2"))
def vi_pose_optimization(
    cam: cam_mod.Camera,
    calib: Calib,
    anchor: VIState,        # single anchor body state (arrays without K dim)
    frame: VIState,         # initial current-frame state (no K dim)
    preint,                 # Preintegrated anchor -> frame
    points: jnp.ndarray,    # (N, 3) matched landmarks (fixed)
    obs,                    # PoseObs-like: uv/uv_r/inv_sigma2/is_stereo/valid
    anchor_prior: VIPrior | None = None,
    bf: float = 0.0,
    cam2: cam_mod.Camera | None = None,
    Rrl: jnp.ndarray | None = None,
    trl: jnp.ndarray | None = None,
) -> VIPoseOptResult:
    """Motion-only visual-inertial pose optimization.

    ``PoseInertialOptimizationLastKeyFrame`` (`src/Optimizer.cc:6630`): the
    anchor state is fixed (pass ``anchor_prior=None``);
    ``...LastFrame`` (`:7018`): the anchor is free but held by its 15-dim
    prior (pass the marginal prior from the previous optimization).

    Landmarks are fixed; the reference's 4-round chi2 re-classification runs
    inside :func:`visual_inertial_ba` (phase split + final classification).
    """
    dtype = frame.twb.dtype
    st = jax.tree_util.tree_map(
        lambda a, b: jnp.stack([a, b]), anchor, frame
    )
    N = points.shape[0]
    robs = factors.ReprojObs(
        pose_idx=jnp.ones(N, jnp.int32),
        point_idx=jnp.arange(N, dtype=jnp.int32),
        uv=obs.uv, uv_r=obs.uv_r, inv_sigma2=obs.inv_sigma2,
        is_stereo=obs.is_stereo, valid=obs.valid,
        uv2=getattr(obs, "uv2", None),
        is_right=getattr(obs, "is_right", None),
    )
    edges = InertialEdges(
        i=jnp.zeros(1, jnp.int32), j=jnp.ones(1, jnp.int32),
        preint=jax.tree_util.tree_map(lambda x: x[None], preint),
        valid=jnp.ones(1, bool),
    )
    if anchor_prior is None:
        pose_fixed = jnp.asarray([True, False])
        prior = no_prior(dtype)
    else:
        pose_fixed = jnp.asarray([False, False])
        prior = anchor_prior
    prob = VIBAProblem(
        state=st, points=points, obs=robs, edges=edges,
        pose_fixed=pose_fixed, point_fixed=jnp.ones(N, bool),
        prior=prior,
    )
    res = visual_inertial_ba(
        cam, calib, prob, bf=bf, n_iters=4, n_iters_final=4,
        huber_inertial=False, cam2=cam2, Rrl=Rrl, trl=trl,
    )
    st = res.state
    return VIPoseOptResult(
        Rwb=st.Rwb[1], twb=st.twb[1], vel=st.vel[1],
        bg=st.bg[1], ba=st.ba[1],
        inliers=res.inlier, n_inliers=jnp.sum(res.inlier.astype(jnp.int32)),
    )
