"""Bundle adjustment with Schur-complement landmark marginalization.

The single engine replacing the reference's g2o BA entry points
(`/root/reference/src/Optimizer.cc`): ``BundleAdjustment``/
``GlobalBundleAdjustemnt`` (`:57,67`), ``LocalBundleAdjustment`` (`:1611`,
covisible window + fixed anchors) and the merge variants — same math
(LM with Huber kernels sqrt(5.991)/sqrt(7.815), Schur complement of the
landmark blocks, outlier re-classification between optimization phases),
but batched:

- residuals/Jacobians for all observations at once (:mod:`factors`),
- Hpp/Hll/g assembled with ``segment_sum``,
- the pose-pose reduced system S = Hpp - U Hll^-1 U^T built with two dense
  einsum contractions over a scatter-assembled U — exact, not CG,
- dense Cholesky-style solve of S (6K x 6K; local windows keep K <= ~100 as
  the reference does, Nd<=25 opt + <=200 fixed per `src/Optimizer.cc:3904`).

Fixed vertices (anchor keyframes, the gauge) get their Jacobian columns
zeroed and identity diagonal blocks, so their updates are exactly zero.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import se3, so3
from orb_slam3_noted_tpu.geometry.linalg3 import inv3
from orb_slam3_noted_tpu.models import cameras as cam_mod
from orb_slam3_noted_tpu.optim import factors
from orb_slam3_noted_tpu.optim.robust import (
    CHI2_MONO,
    CHI2_STEREO,
    huber_cost,
    huber_weight,
)

_HP = jax.lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    Rcw: jnp.ndarray         # (K, 3, 3)
    tcw: jnp.ndarray         # (K, 3)
    points: jnp.ndarray      # (M, 3)
    obs: factors.ReprojObs   # (O,)
    pose_fixed: jnp.ndarray  # (K,) bool
    point_fixed: jnp.ndarray  # (M,) bool


class BAResult(NamedTuple):
    Rcw: jnp.ndarray
    tcw: jnp.ndarray
    points: jnp.ndarray
    chi2: jnp.ndarray        # (O,) final per-obs chi2 (information-weighted)
    inlier: jnp.ndarray      # (O,) bool after final classification
    cost: jnp.ndarray        # () final robust cost


def _evaluate(cam, Rcw, tcw, points, obs, active, use_huber, bf):
    r, Jp, Jl, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw, tcw, points, obs._replace(valid=active), bf=bf
    )
    delta2 = jnp.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    w_rob = jnp.where(use_huber, huber_weight(chi2, delta2), 1.0)
    w = jnp.where(ok, obs.inv_sigma2 * w_rob, 0.0)
    cost = jnp.sum(
        jnp.where(ok, jnp.where(use_huber, huber_cost(chi2, delta2), chi2), 0.0)
    )
    return r, Jp, Jl, chi2, w, ok, cost


def _lm_step(cam, Rcw, tcw, points, obs, prob, active, use_huber, lam, bf):
    K = Rcw.shape[0]
    M = points.shape[0]
    dtype = tcw.dtype

    r, Jp, Jl, chi2, w, ok, cost_old = _evaluate(
        cam, Rcw, tcw, points, obs, active, use_huber, bf
    )
    pose_free = (~prob.pose_fixed).astype(dtype)
    point_free = (~prob.point_fixed).astype(dtype)
    Jp = Jp * pose_free[obs.pose_idx][:, None, None]
    Jl = Jl * point_free[obs.point_idx][:, None, None]

    wJp = w[:, None, None] * Jp
    # block contributions
    Hpp_o = jnp.einsum("oai,oaj->oij", wJp, Jp, precision=_HP)     # (O, 6, 6)
    Hll_o = jnp.einsum("oai,oaj->oij", w[:, None, None] * Jl, Jl, precision=_HP)
    W_o = jnp.einsum("oai,oaj->oij", wJp, Jl, precision=_HP)       # (O, 6, 3)
    gp_o = jnp.einsum("oai,oa->oi", Jp, w[:, None] * r, precision=_HP)
    gl_o = jnp.einsum("oai,oa->oi", Jl, w[:, None] * r, precision=_HP)

    Hpp = jax.ops.segment_sum(Hpp_o, obs.pose_idx, num_segments=K)
    gp = jax.ops.segment_sum(gp_o, obs.pose_idx, num_segments=K)
    Hll = jax.ops.segment_sum(Hll_o, obs.point_idx, num_segments=M)
    gl = jax.ops.segment_sum(gl_o, obs.point_idx, num_segments=M)

    eye6 = jnp.eye(6, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)
    Hpp = (
        Hpp
        + lam * Hpp * eye6  # Marquardt: scale diagonal
        + (1e-8 + prob.pose_fixed.astype(dtype))[:, None, None] * eye6
    )
    Hll = (
        Hll
        + lam * Hll * eye3
        + (1e-8 + prob.point_fixed.astype(dtype))[:, None, None] * eye3
    )
    Cinv = inv3(Hll)  # (M, 3, 3) closed form, no batched LU

    # U[k, a, m, b] = sum of W_o for obs (k, m)
    U = jnp.zeros((K, 6, M, 3), dtype).at[obs.pose_idx, :, obs.point_idx, :].add(W_o)
    V = jnp.einsum("kamb,mbc->kamc", U, Cinv, precision=_HP)
    S = -jnp.einsum("kamc,jdmc->kajd", V, U, precision=_HP)
    S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(Hpp)
    rhs = -gp + jnp.einsum("kamc,mc->ka", V, gl, precision=_HP)

    dp = jnp.linalg.solve(S.reshape(K * 6, K * 6), rhs.reshape(K * 6)).reshape(K, 6)
    dl = jnp.einsum(
        "mbc,mc->mb", Cinv,
        -gl - jnp.einsum("kamb,ka->mb", U, dp, precision=_HP),
        precision=_HP,
    )

    R_new, t_new = se3.compose(se3.exp(dp), (Rcw, tcw))
    R_new = so3.normalize(R_new)
    p_new = points + dl
    _, _, _, _, _, _, cost_new = _evaluate(
        cam, R_new, t_new, p_new, obs, active, use_huber, bf
    )
    better = cost_new < cost_old
    Rcw = jnp.where(better, R_new, Rcw)
    tcw = jnp.where(better, t_new, tcw)
    points = jnp.where(better, p_new, points)
    lam = jnp.where(better, lam * 0.5, lam * 5.0)
    return Rcw, tcw, points, lam


@partial(jax.jit, static_argnames=("cam", "bf", "n_iters", "n_iters_final"))
def bundle_adjust(
    cam: cam_mod.Camera,
    prob: BAProblem,
    bf: float = 0.0,
    n_iters: int = 5,
    n_iters_final: int = 10,
) -> BAResult:
    """LM bundle adjustment with the reference's two-phase schedule.

    Phase 1: ``n_iters`` robust iterations on all observations; then
    re-classify outliers by chi2 (5.991 / 7.815); phase 2: ``n_iters_final``
    iterations without the outliers (mirrors ``LocalBundleAdjustment``'s
    5-then-10 schedule with kernel removal, `src/Optimizer.cc:1611+`).
    """
    obs = prob.obs
    Rcw, tcw, points = prob.Rcw, prob.tcw, prob.points

    def phase(Rcw, tcw, points, active, use_huber, n):
        def body(_, st):
            Rcw, tcw, points, lam = st
            Rcw, tcw, points, lam = _lm_step(
                cam, Rcw, tcw, points, obs, prob, active, use_huber, lam, bf
            )
            return (Rcw, tcw, points, lam)

        Rcw, tcw, points, _ = jax.lax.fori_loop(
            0, n, body, (Rcw, tcw, points, jnp.asarray(1e-4, tcw.dtype))
        )
        return Rcw, tcw, points

    Rcw, tcw, points = phase(
        Rcw, tcw, points, obs.valid, jnp.asarray(True), n_iters
    )
    # outlier classification on all valid obs
    _, _, _, chi2, _, ok, _ = _evaluate(
        cam, Rcw, tcw, points, obs, obs.valid, jnp.asarray(True), bf
    )
    th = jnp.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    active = obs.valid & ok & (chi2 <= th)
    Rcw, tcw, points = phase(Rcw, tcw, points, active, jnp.asarray(False), n_iters_final)

    _, _, _, chi2, _, ok, cost = _evaluate(
        cam, Rcw, tcw, points, obs, obs.valid, jnp.asarray(False), bf
    )
    inlier = obs.valid & ok & (chi2 <= th)
    return BAResult(Rcw=Rcw, tcw=tcw, points=points, chi2=chi2, inlier=inlier, cost=cost)
