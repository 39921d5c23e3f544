"""Global bundle adjustment: matrix-free Schur complement + block-Jacobi PCG.

Equivalent of ``Optimizer::GlobalBundleAdjustemnt``/``BundleAdjustment``
(`/root/reference/src/Optimizer.cc:57,67`) and the GBA the loop closer spawns
(`/root/reference/src/LoopClosing.cc:1096,2018-2183`) — but built to scale:
the windowed engine in :mod:`orb_slam3_noted_tpu.optim.ba` materializes the
dense pose-landmark coupling ``U (K, 6, M, 3)``, which is fine for local
windows and unusable at full-map size (256 KF x 16k MP ~ 1.2 GB/operand).
Here the reduced camera system

    S dp = -gp + U Hll^-1 gl,   S = Hpp - U Hll^-1 U^T

is solved by preconditioned conjugate gradients where every product with
``U``/``U^T`` is evaluated observation-wise (einsum over the (O, 6, 3)
per-observation blocks + ``segment_sum``), so memory stays O(O + K + M) and
the heavy math is batched matmuls.

The LM outer loop uses cost-checked adaptive damping (accept/reject, lambda
x0.5 / x5) — unlike g2o's fixed schedule this is divergence-safe on the
ill-conditioned post-loop problems GBA is spawned for.
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
from orb_slam3_noted_tpu.optim.ba import BAProblem, BAResult
from orb_slam3_noted_tpu.optim.robust import (
    chi2_threshold,
    huber_cost,
    huber_weight,
)

_HP = jax.lax.Precision.HIGHEST


def _eval_blocks(cam, Rcw, tcw, points, obs, prob, active, use_huber, bf,
                 cam2=None, Rrl=None, trl=None):
    """Residual blocks for one linearization point.

    Returns (W (O,6,3), Hpp (K,6,6), gp (K,6), Hll (M,3,3), gl (M,3), cost).
    Fixed poses/points get zeroed Jacobians so their updates are exactly 0.
    """
    K = Rcw.shape[0]
    M = points.shape[0]
    dtype = tcw.dtype
    r, Jp, Jl, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw, tcw, points, obs._replace(valid=active), bf=bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    delta2 = chi2_threshold(obs)
    w_rob = jnp.where(use_huber, huber_weight(chi2, delta2), 1.0)
    w = jnp.where(ok, obs.inv_sigma2 * w_rob, 0.0)
    cost = jnp.sum(
        jnp.where(ok, jnp.where(use_huber, huber_cost(chi2, delta2), chi2), 0.0)
    )
    pose_free = (~prob.pose_fixed).astype(dtype)
    point_free = (~prob.point_fixed).astype(dtype)
    Jp = Jp * pose_free[obs.pose_idx][:, None, None]
    Jl = Jl * point_free[obs.point_idx][:, None, None]

    wJp = w[:, None, None] * Jp
    W = jnp.einsum("oai,oaj->oij", wJp, Jl, precision=_HP)  # (O, 6, 3)
    Hpp = jax.ops.segment_sum(
        jnp.einsum("oai,oaj->oij", wJp, Jp, precision=_HP), obs.pose_idx, K
    )
    gp = jax.ops.segment_sum(
        jnp.einsum("oai,oa->oi", Jp, w[:, None] * r, precision=_HP),
        obs.pose_idx, K,
    )
    Hll = jax.ops.segment_sum(
        jnp.einsum("oai,oaj->oij", w[:, None, None] * Jl, Jl, precision=_HP),
        obs.point_idx, M,
    )
    gl = jax.ops.segment_sum(
        jnp.einsum("oai,oa->oi", Jl, w[:, None] * r, precision=_HP),
        obs.point_idx, M,
    )
    return W, Hpp, gp, Hll, gl, cost


def _schur_matvec(x, W, Hpp_d, Cinv, pose_idx, point_idx, K, M, psum=None,
                  psum_pt="same"):
    """S @ x without materializing S or U; O(O) per call.

    ``psum``: optional reducer for pose-indexed partial segment sums over
    a mesh axis.  ``psum_pt``: reducer for POINT-indexed sums — pass None
    when every observation of a point lives on one shard (point-local
    layout): the (M, 3) reduction then vanishes and each CG iteration
    communicates only the (K, 6) pose vector.
    """
    if psum_pt == "same":
        psum_pt = psum
    # U^T x: (M, 3) = sum over obs of W_o^T x[pose]
    utx_o = jnp.einsum("oij,oi->oj", W, x[pose_idx], precision=_HP)
    utx = jax.ops.segment_sum(utx_o, point_idx, M)
    if psum_pt is not None:
        utx = psum_pt(utx)
    y = jnp.einsum("mij,mj->mi", Cinv, utx, precision=_HP)      # Hll^-1 U^T x
    # U y: (K, 6)
    uy_o = jnp.einsum("oij,oj->oi", W, y[point_idx], precision=_HP)
    uy = jax.ops.segment_sum(uy_o, pose_idx, K)
    if psum is not None:
        uy = psum(uy)
    hx = jnp.einsum("kij,kj->ki", Hpp_d, x, precision=_HP)
    return hx - uy


def _pcg(matvec, Pinv, b, n_iters):
    """Block-Jacobi preconditioned CG on the (K, 6) pose system."""
    def precond(r):
        return jnp.einsum("kij,kj->ki", Pinv, r, precision=_HP)

    x = jnp.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = jnp.sum(r * z)

    def body(_, st):
        x, r, p, rz = st
        Ap = matvec(p)
        pAp = jnp.sum(p * Ap)
        alpha = jnp.where(jnp.abs(pAp) > 1e-20, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = jnp.where(jnp.abs(rz) > 1e-20, rz_new / rz, 0.0)
        p = z + beta * p
        return x, r, p, rz_new

    x, _, _, _ = jax.lax.fori_loop(0, n_iters, body, (x, r, p, rz))
    return x


def _gba_lm_step(cam, Rcw, tcw, points, obs, prob, active, use_huber,
                 lam, bf, cg_iters, psum=None, cam2=None, Rrl=None, trl=None,
                 point_local=False):
    """One LM step.  ``point_local=True``: the observation shard owns every
    row of its points (covisibility-style point partitioning) — point-
    indexed reductions are skipped and only the landmark UPDATE ``dl`` is
    reduced once at the end (each shard contributes its owned points; the
    rest are exactly zero)."""
    K = Rcw.shape[0]
    M = points.shape[0]
    dtype = tcw.dtype
    psum_pt = None if point_local else psum
    W, Hpp, gp, Hll, gl, cost_old = _eval_blocks(
        cam, Rcw, tcw, points, obs, prob, active, use_huber, bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    if psum is not None:
        Hpp, gp, cost_old = psum(Hpp), psum(gp), psum(cost_old)
    if psum_pt is not None:
        Hll, gl = psum_pt(Hll), psum_pt(gl)
    eye6 = jnp.eye(6, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)
    Hpp_d = (
        Hpp + lam * Hpp * eye6
        + (1e-8 + prob.pose_fixed.astype(dtype))[:, None, None] * eye6
    )
    Hll_d = (
        Hll + lam * Hll * eye3
        + (1e-8 + prob.point_fixed.astype(dtype))[:, None, None] * eye3
    )
    Cinv = inv3(Hll_d)

    # block-Jacobi preconditioner: P_k = Hpp_k - sum_o W_o Cinv_m W_o^T
    wc_o = jnp.einsum("oij,ojk->oik", W, Cinv[obs.point_idx], precision=_HP)
    wcw_o = jnp.einsum("oik,ojk->oij", wc_o, W, precision=_HP)
    Pk_sub = jax.ops.segment_sum(wcw_o, obs.pose_idx, K)
    if psum is not None:
        Pk_sub = psum(Pk_sub)
    Pk = Hpp_d - Pk_sub
    # symmetrize + regularize, then invert the 6x6 blocks
    Pk = 0.5 * (Pk + jnp.swapaxes(Pk, 1, 2)) + 1e-6 * eye6
    Pinv = jnp.linalg.solve(Pk, jnp.broadcast_to(eye6, Pk.shape))

    rhs = -gp + _schur_rhs_coupling(W, Cinv, gl, obs, K, psum)
    mv = lambda x: _schur_matvec(
        x, W, Hpp_d, Cinv, obs.pose_idx, obs.point_idx, K, M, psum,
        psum_pt=psum_pt,
    )
    dp = _pcg(mv, Pinv, rhs, cg_iters)

    # back-substitute landmarks: dl = Hll^-1 (-gl - U^T dp)
    utdp_o = jnp.einsum("oij,oi->oj", W, dp[obs.pose_idx], precision=_HP)
    utdp = jax.ops.segment_sum(utdp_o, obs.point_idx, M)
    if psum_pt is not None:
        utdp = psum_pt(utdp)
    dl = jnp.einsum("mij,mj->mi", Cinv, -gl - utdp, precision=_HP)
    if point_local and psum is not None:
        # non-owned rows are exactly zero on each shard: one reduction
        # replicates the full landmark update (the only M-sized collective
        # per LM step — everything in the CG loop was (K, 6))
        dl = psum(dl)

    R_new, t_new = se3.compose(se3.exp(dp), (Rcw, tcw))
    R_new = so3.normalize(R_new)
    p_new = points + dl
    _, _, _, _, _, cost_new = _eval_blocks(
        cam, R_new, t_new, p_new, obs, prob, active, use_huber, bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    if psum is not None:
        cost_new = psum(cost_new)
    better = cost_new < cost_old
    Rcw = jnp.where(better, R_new, Rcw)
    tcw = jnp.where(better, t_new, tcw)
    points = jnp.where(better, p_new, points)
    lam = jnp.where(better, lam * 0.5, lam * 5.0)
    return Rcw, tcw, points, lam, jnp.where(better, cost_new, cost_old)


def _schur_rhs_coupling(W, Cinv, gl, obs, K, psum=None):
    """U Hll^-1 gl evaluated observation-wise."""
    y = jnp.einsum("mij,mj->mi", Cinv, gl, precision=_HP)
    uy_o = jnp.einsum("oij,oj->oi", W, y[obs.point_idx], precision=_HP)
    out = jax.ops.segment_sum(uy_o, obs.pose_idx, K)
    if psum is not None:
        out = psum(out)
    return out


@partial(
    jax.jit,
    static_argnames=("cam", "bf", "n_iters", "n_iters_final", "cg_iters",
                     "cam2"),
)
def global_bundle_adjust(
    cam: cam_mod.Camera,
    prob: BAProblem,
    bf: float = 0.0,
    n_iters: int = 8,
    n_iters_final: int = 5,
    cg_iters: int = 64,
    cam2: cam_mod.Camera | None = None,
    Rrl: jnp.ndarray | None = None,
    trl: jnp.ndarray | None = None,
) -> BAResult:
    """Full-map LM with the two-phase robust schedule of the local engine.

    Same semantics as :func:`orb_slam3_noted_tpu.optim.ba.bundle_adjust`
    (phase 1 Huber, chi2 outlier re-classification, phase 2 plain LS) but
    with the matrix-free Schur/PCG inner solver, so it runs at Atlas scale.
    """
    obs = prob.obs
    Rcw, tcw, points = prob.Rcw, prob.tcw, prob.points

    def phase(Rcw, tcw, points, active, use_huber, n):
        def body(_, st):
            Rcw, tcw, points, lam = st
            Rcw, tcw, points, lam, _ = _gba_lm_step(
                cam, Rcw, tcw, points, obs, prob, active, use_huber,
                lam, bf, cg_iters, cam2=cam2, Rrl=Rrl, trl=trl,
            )
            return (Rcw, tcw, points, lam)

        Rcw, tcw, points, _ = jax.lax.fori_loop(
            0, n, body, (Rcw, tcw, points, jnp.asarray(1e-4, tcw.dtype))
        )
        return Rcw, tcw, points

    Rcw, tcw, points = phase(
        Rcw, tcw, points, obs.valid, jnp.asarray(True), n_iters
    )
    r, Jp, Jl, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw, tcw, points, obs, bf=bf, cam2=cam2, Rrl=Rrl, trl=trl,
    )
    th = chi2_threshold(obs)
    active = obs.valid & ok & (chi2 <= th)
    Rcw, tcw, points = phase(
        Rcw, tcw, points, active, jnp.asarray(False), n_iters_final
    )

    r, Jp, Jl, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw, tcw, points, obs, bf=bf, cam2=cam2, Rrl=Rrl, trl=trl,
    )
    inlier = obs.valid & ok & (chi2 <= th)
    cost = jnp.sum(jnp.where(inlier, chi2, 0.0))
    return BAResult(
        Rcw=Rcw, tcw=tcw, points=points, chi2=chi2, inlier=inlier, cost=cost
    )


def _gba_lm_step_ptblock(cam, Rcw, tcw, points, obs, prob, active,
                         use_huber, lam, bf, cg_iters, axis,
                         cam2=None, Rrl=None, trl=None):
    """LM step with the landmark table BLOCK-PARTITIONED over the mesh.

    The map-partitioning half of the BASELINE north star at landmark
    granularity: shard s owns the contiguous point block
    [s*Mb, (s+1)*Mb) and every observation of an owned point lives on the
    shard (layout from ``parallel.dist_ba.shard_obs_by_point_block``).
    Per shard, the point-indexed state (Hll, Cinv, gl, dl) exists ONLY for
    the owned (Mb,) block — nothing point-sized is replicated or psum'd:

    - the CG loop communicates one (K, 6) psum per iteration,
    - the landmark update is one tiled all_gather of (Mb, 3) per LM step,
    - pose-side reductions (Hpp, gp, preconditioner, cost) are unchanged.
    """
    import jax as _jax

    K = Rcw.shape[0]
    M = points.shape[0]
    dtype = tcw.dtype
    n_shards = _jax.lax.psum(1, axis)
    Mb = M // n_shards
    s_idx = _jax.lax.axis_index(axis)
    base = s_idx * Mb
    psum = lambda x: _jax.lax.psum(x, axis)

    # local landmark block + local observation point ids
    pts_loc = _jax.lax.dynamic_slice_in_dim(points, base, Mb)
    pfix_loc = _jax.lax.dynamic_slice_in_dim(
        prob.point_fixed.astype(dtype), base, Mb
    )
    pidx_loc = jnp.clip(obs.point_idx - base, 0, Mb - 1)

    r, Jp, Jl, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw, tcw, pts_loc,
        obs._replace(valid=active, point_idx=pidx_loc), bf=bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    delta2 = chi2_threshold(obs)
    w_rob = jnp.where(use_huber, huber_weight(chi2, delta2), 1.0)
    w = jnp.where(ok, obs.inv_sigma2 * w_rob, 0.0)
    cost_old = psum(jnp.sum(
        jnp.where(ok, jnp.where(use_huber, huber_cost(chi2, delta2), chi2),
                  0.0)
    ))
    pose_free = (~prob.pose_fixed).astype(dtype)
    point_free = 1.0 - pfix_loc
    Jp = Jp * pose_free[obs.pose_idx][:, None, None]
    Jl = Jl * point_free[pidx_loc][:, None, None]

    wJp = w[:, None, None] * Jp
    W = jnp.einsum("oai,oaj->oij", wJp, Jl, precision=_HP)
    Hpp = psum(jax.ops.segment_sum(
        jnp.einsum("oai,oaj->oij", wJp, Jp, precision=_HP), obs.pose_idx, K
    ))
    gp = psum(jax.ops.segment_sum(
        jnp.einsum("oai,oa->oi", Jp, w[:, None] * r, precision=_HP),
        obs.pose_idx, K,
    ))
    Hll = jax.ops.segment_sum(
        jnp.einsum("oai,oaj->oij", w[:, None, None] * Jl, Jl, precision=_HP),
        pidx_loc, Mb,
    )
    gl = jax.ops.segment_sum(
        jnp.einsum("oai,oa->oi", Jl, w[:, None] * r, precision=_HP),
        pidx_loc, Mb,
    )

    eye6 = jnp.eye(6, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)
    Hpp_d = (
        Hpp + lam * Hpp * eye6
        + (1e-8 + prob.pose_fixed.astype(dtype))[:, None, None] * eye6
    )
    Hll_d = (
        Hll + lam * Hll * eye3
        + (1e-8 + pfix_loc)[:, None, None] * eye3
    )
    Cinv = inv3(Hll_d)                      # (Mb, 3, 3) — owned block only

    wc_o = jnp.einsum("oij,ojk->oik", W, Cinv[pidx_loc], precision=_HP)
    wcw_o = jnp.einsum("oik,ojk->oij", wc_o, W, precision=_HP)
    Pk = Hpp_d - psum(jax.ops.segment_sum(wcw_o, obs.pose_idx, K))
    Pk = 0.5 * (Pk + jnp.swapaxes(Pk, 1, 2)) + 1e-6 * eye6
    Pinv = jnp.linalg.solve(Pk, jnp.broadcast_to(eye6, Pk.shape))

    y0 = jnp.einsum("mij,mj->mi", Cinv, gl, precision=_HP)
    rhs = -gp + psum(jax.ops.segment_sum(
        jnp.einsum("oij,oj->oi", W, y0[pidx_loc], precision=_HP),
        obs.pose_idx, K,
    ))

    def mv(x):
        utx = jax.ops.segment_sum(
            jnp.einsum("oij,oi->oj", W, x[obs.pose_idx], precision=_HP),
            pidx_loc, Mb,
        )
        y = jnp.einsum("mij,mj->mi", Cinv, utx, precision=_HP)
        uy = psum(jax.ops.segment_sum(
            jnp.einsum("oij,oj->oi", W, y[pidx_loc], precision=_HP),
            obs.pose_idx, K,
        ))
        return jnp.einsum("kij,kj->ki", Hpp_d, x, precision=_HP) - uy

    dp = _pcg(mv, Pinv, rhs, cg_iters)

    utdp = jax.ops.segment_sum(
        jnp.einsum("oij,oi->oj", W, dp[obs.pose_idx], precision=_HP),
        pidx_loc, Mb,
    )
    dl_loc = jnp.einsum("mij,mj->mi", Cinv, -gl - utdp, precision=_HP)
    dl = _jax.lax.all_gather(dl_loc, axis, axis=0, tiled=True)  # (M, 3)

    R_new, t_new = se3.compose(se3.exp(dp), (Rcw, tcw))
    R_new = so3.normalize(R_new)
    p_new = points + dl
    pl_new = pts_loc + dl_loc
    r2, _, _, chi2_2, ok2, _ = factors.reproj_residuals(
        cam, R_new, t_new, pl_new,
        obs._replace(valid=active, point_idx=pidx_loc), bf=bf,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    w_rob2 = jnp.where(use_huber, huber_weight(chi2_2, delta2), 1.0)
    cost_new = psum(jnp.sum(jnp.where(
        ok2, jnp.where(use_huber, huber_cost(chi2_2, delta2), chi2_2), 0.0
    )))
    better = cost_new < cost_old
    Rcw = jnp.where(better, R_new, Rcw)
    tcw = jnp.where(better, t_new, tcw)
    points = jnp.where(better, p_new, points)
    lam = jnp.where(better, lam * 0.5, lam * 5.0)
    return Rcw, tcw, points, lam, jnp.where(better, cost_new, cost_old)


def distributed_global_ba(
    cam: cam_mod.Camera,
    mesh,
    prob: BAProblem,
    bf: float = 0.0,
    n_iters: int = 8,
    n_iters_final: int = 4,
    cg_iters: int = 32,
    cam2: cam_mod.Camera | None = None,
    Rrl: jnp.ndarray | None = None,
    trl: jnp.ndarray | None = None,
):
    """Matrix-free GBA with the observation table sharded over a device mesh.

    The multi-host north star (SURVEY §2.3, BASELINE.json): every device
    evaluates residual blocks for its observation shard; the (K,6)/(M,3)
    segment sums inside the Schur matvec and the preconditioner are reduced
    with ``psum`` over the mesh, so each CG iteration communicates O(K*6 + M*3)
    floats — not the observation set.  The LM outer loop keeps the
    cost-checked adaptive damping (accept/reject) of the single-chip engine;
    all devices see identical psum'd costs, so control flow stays in
    lockstep.  Returns (Rcw, tcw, points, cost), replicated.
    """
    import jax
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from orb_slam3_noted_tpu.parallel.dist_ba import shard_obs_by_point_block

    axis = mesh.axis_names[0]
    n_dev = mesh.size
    # Landmark BLOCK partitioning (the map-partitioning north star at
    # point granularity): shard s owns points [s*Mb, (s+1)*Mb) and every
    # observation of an owned point lives on the shard.  Point-sized state
    # (Hll, Cinv, dl) exists only per-block, the CG loop communicates one
    # (K, 6) psum per iteration, and the landmark update is one tiled
    # (Mb, 3) all_gather per LM step.  The round-4 layout replicated the
    # whole point table AND psum'd (M, 3) arrays twice per CG iteration —
    # the dominant terms of its 0.809 fixed-size scaling ratio.
    M0 = prob.points.shape[0]
    Mb = -(-M0 // n_dev)
    Mpad = n_dev * Mb - M0
    points_p = jnp.concatenate(
        [prob.points, jnp.zeros((Mpad, 3), prob.points.dtype)]
    ) if Mpad else prob.points
    point_fixed_p = jnp.concatenate(
        [prob.point_fixed, jnp.ones(Mpad, bool)]
    ) if Mpad else prob.point_fixed
    prob = prob._replace(points=points_p, point_fixed=point_fixed_p)
    obs = shard_obs_by_point_block(prob.obs, n_dev, Mb)
    rep = P()
    shard = P(axis)
    # second-camera extrinsics ride along as replicated operands so fisheye
    # right-camera residual rows survive the shard (round-4 fix: dropping
    # cam2 silently degraded every observation to mono in multi-device GBA,
    # leaving scale unconstrained during loop-closure GBA)
    has_cam2 = cam2 is not None
    Rrl_in = Rrl if has_cam2 else jnp.eye(3, dtype=prob.tcw.dtype)
    trl_in = trl if has_cam2 else jnp.zeros(3, dtype=prob.tcw.dtype)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(rep, rep, rep,
                  jax.tree_util.tree_map(lambda _: shard, obs),
                  rep, rep, rep, rep),
        out_specs=(rep, rep, rep, rep),
        # the tiled all_gather of the landmark update is replicated by
        # construction but shard_map's varying-axes checker cannot prove
        # it; the cost psums keep every shard's control flow in lockstep
        check_vma=False,
    )
    def run(Rcw, tcw, points, obs_shard, p_fix, l_fix, Rrl_l, trl_l):
        psum = lambda x: jax.lax.psum(x, axis)
        cam2_l = cam2 if has_cam2 else None
        Rrl_a = Rrl_l if has_cam2 else None
        trl_a = trl_l if has_cam2 else None
        prob_l = BAProblem(
            Rcw=Rcw, tcw=tcw, points=points, obs=obs_shard,
            pose_fixed=p_fix, point_fixed=l_fix,
        )

        def phase(Rcw, tcw, points, active, use_huber, n):
            def body(_, st):
                Rcw, tcw, points, lam = st
                Rcw, tcw, points, lam, _ = _gba_lm_step_ptblock(
                    cam, Rcw, tcw, points, obs_shard, prob_l, active,
                    use_huber, lam, bf, cg_iters, axis,
                    cam2=cam2_l, Rrl=Rrl_a, trl=trl_a,
                )
                return (Rcw, tcw, points, lam)

            Rcw, tcw, points, _ = jax.lax.fori_loop(
                0, n, body, (Rcw, tcw, points, jnp.asarray(1e-4, tcw.dtype))
            )
            return Rcw, tcw, points

        Rcw, tcw, points = phase(
            Rcw, tcw, points, obs_shard.valid, jnp.asarray(True), n_iters
        )
        # outlier re-classification is row-local (no collective needed);
        # chi2_threshold handles the joint two-camera 4-dof rows too
        _, _, _, chi2, ok, _ = factors.reproj_residuals(
            cam, Rcw, tcw, points, obs_shard, bf=bf,
            cam2=cam2_l, Rrl=Rrl_a, trl=trl_a,
        )
        th = chi2_threshold(obs_shard)
        active = obs_shard.valid & ok & (chi2 <= th)
        Rcw, tcw, points = phase(
            Rcw, tcw, points, active, jnp.asarray(False), n_iters_final
        )
        _, _, _, chi2, ok, _ = factors.reproj_residuals(
            cam, Rcw, tcw, points, obs_shard, bf=bf,
            cam2=cam2_l, Rrl=Rrl_a, trl=trl_a,
        )
        inl = obs_shard.valid & ok & (chi2 <= th)
        cost = psum(jnp.sum(jnp.where(inl, chi2, 0.0)))
        return Rcw, tcw, points, cost

    Rf, tf, pf, cost = run(
        prob.Rcw, prob.tcw, prob.points, obs,
        prob.pose_fixed, prob.point_fixed, Rrl_in, trl_in,
    )
    return Rf, tf, pf[:M0], cost


def run_global_ba_mesh(m, cam, cfg, mesh, bf: float = 0.0,
                       n_iters: int = 6, n_iters_final: int = 4,
                       cg_iters: int = 32):
    """Distributed GBA over the whole map + write-back (multi-device).

    The mesh-sharded twin of :func:`run_global_ba`, called by the loop
    closer when more than one device is attached (BASELINE.json north star:
    distributed GBA over the full Atlas instead of the reference's
    "skip GBA when large" escape hatch).
    """
    from orb_slam3_noted_tpu.pipeline import map_state as MS
    from orb_slam3_noted_tpu.pipeline.tracking import _second_camera

    prob = full_map_problem(m, cfg)
    cam2, Rrl, trl = _second_camera(cfg)
    Rf, tf, pf, cost = distributed_global_ba(
        cam, mesh, prob, bf=bf, n_iters=n_iters,
        n_iters_final=n_iters_final, cg_iters=cg_iters,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    KF = m.kf_Rcw.shape[0]
    MP = m.mp_pos.shape[0]
    m = MS.apply_ba_result(
        m,
        jnp.arange(KF, dtype=jnp.int32), m.kf_valid,
        Rf, tf,
        jnp.arange(MP, dtype=jnp.int32), ~prob.point_fixed, pf,
    )
    return m, cost


def full_map_problem(m, cfg, sample_stride: int = 1):
    """Build a BAProblem over every valid keyframe/point binding in the map.

    Gauge: the earliest valid keyframe is fixed (the reference fixes
    ``mvpKeyFrameOrigins``; `src/Optimizer.cc:130` ``setFixed(pKF->mnId==0)``).
    """
    KF, NF = m.kf_xy.shape[0], m.kf_xy.shape[1]
    MP = m.mp_pos.shape[0]
    k_idx = jnp.repeat(jnp.arange(KF, dtype=jnp.int32), NF)
    f_idx = jnp.tile(jnp.arange(NF, dtype=jnp.int32), KF)
    if sample_stride > 1:
        k_idx = k_idx[::sample_stride]
        f_idx = f_idx[::sample_stride]
    mp_id = m.kf_mp[k_idx, f_idx]
    valid = (
        m.kf_valid[k_idx]
        & (mp_id >= 0)
        & m.kf_feat_valid[k_idx, f_idx]
    )
    mp_idx = jnp.clip(mp_id, 0)
    valid = valid & m.mp_valid[mp_idx]
    sigma2 = jnp.asarray(cfg.level_sigma2, m.mp_pos.dtype)
    uvr = m.kf_uvr[k_idx, f_idx]
    if cfg.camera2 is not None:
        uv2 = m.kf_xy_r[k_idx, f_idx]
        is_right = uv2[:, 0] >= 0
    else:
        uv2 = None
        is_right = None
    obs = factors.ReprojObs(
        pose_idx=k_idx,
        point_idx=mp_idx,
        uv=m.kf_xy[k_idx, f_idx],
        uv_r=uvr,
        inv_sigma2=1.0 / sigma2[m.kf_level[k_idx, f_idx]],
        is_stereo=uvr >= 0,
        valid=valid,
        uv2=uv2,
        is_right=is_right,
    )
    # gauge: earliest valid keyframe by frame id
    fids = jnp.where(m.kf_valid, m.kf_frame_id, jnp.int32(1 << 30))
    anchor = jnp.argmin(fids)
    pose_fixed = (~m.kf_valid).at[anchor].set(True)
    seen = jnp.zeros(MP, bool).at[mp_idx].max(valid)
    return BAProblem(
        Rcw=m.kf_Rcw,
        tcw=m.kf_tcw,
        points=m.mp_pos,
        obs=obs,
        pose_fixed=pose_fixed,
        point_fixed=~seen,
    )


# ---------------------------------------------------------------------------
# time-sliced GBA (round-4): the reference runs GBA in a transient thread so
# tracking never stalls (`src/LoopClosing.cc:1090-1097`); a single chip has
# one compute stream, so the equivalent here runs ONE LM step per
# frame/batch boundary against a problem snapshot and write-backs deltas
# when converged — bounding the per-frame latency hit to one LM step.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cam", "bf", "cg_iters", "cam2"))
def gba_step_jit(cam, Rcw, tcw, points, obs, prob, active, use_huber, lam,
                 bf: float = 0.0, cg_iters: int = 64,
                 cam2=None, Rrl=None, trl=None):
    """One LM step of the matrix-free GBA engine (jitted, dispatchable as a
    background slice between tracking dispatches)."""
    return _gba_lm_step(
        cam, Rcw, tcw, points, obs, prob, active, use_huber, lam, bf,
        cg_iters, cam2=cam2, Rrl=Rrl, trl=trl,
    )


@partial(jax.jit, static_argnames=("cam", "bf", "cam2"))
def gba_reclassify(cam, Rcw, tcw, points, obs, bf: float = 0.0,
                   cam2=None, Rrl=None, trl=None):
    """Outlier re-classification between the Huber and plain phases."""
    _, _, _, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw, tcw, points, obs, bf=bf, cam2=cam2, Rrl=Rrl, trl=trl,
    )
    return obs.valid & ok & (chi2 <= chi2_threshold(obs))


@jax.jit
def apply_gba_deltas(m, snapR, snapt, snapp, Rcw, tcw, points,
                     kf_live, mp_live):
    """Merge a finished GBA (run on a SNAPSHOT) into the live map.

    delta = GBA_result - snapshot, added onto the live values: keyframes
    and points refined by local BA SINCE the snapshot keep those
    refinements (first-order composition) — the single-chip analogue of the
    reference's spanning-tree correction propagation for keyframes created
    during GBA (`src/LoopClosing.cc:2080-2161`).  ``kf_live``/``mp_live``
    mask to entities that existed at snapshot time AND are still valid.
    """
    dR = jnp.where(kf_live[:, None, None], Rcw - snapR, 0.0)
    dt = jnp.where(kf_live[:, None], tcw - snapt, 0.0)
    dp = jnp.where(mp_live[:, None], points - snapp, 0.0)
    Rn = m.kf_Rcw + dR
    # re-orthonormalize the composed rotations (delta-add leaves the
    # manifold; Gram-Schmidt via normalize)
    from orb_slam3_noted_tpu.geometry import so3 as _so3

    Rn = jnp.where(
        kf_live[:, None, None], jax.vmap(_so3.normalize)(Rn), m.kf_Rcw
    )
    return m._replace(
        kf_Rcw=Rn,
        kf_tcw=m.kf_tcw + dt,
        mp_pos=m.mp_pos + dp,
    )


class SlicedGBA:
    """Host-side driver for time-sliced global BA over a map snapshot.

    Usage: ``g = SlicedGBA(m, cam, cfg, bf)``; call ``g.step()`` at frame
    boundaries (each is one dispatched LM slice, ~tens of ms); when
    ``g.done``, ``m = g.finish(m_live)`` merges the deltas.
    """

    def __init__(self, m, cam, cfg, bf=0.0, n_iters=6, n_iters_final=4,
                 cg_iters=48):
        self.cam, self.bf, self.cg_iters = cam, bf, cg_iters
        self.n_iters, self.n_iters_final = n_iters, n_iters_final
        from orb_slam3_noted_tpu.pipeline.tracking import _second_camera

        self.cam2, self.Rrl, self.trl = _second_camera(cfg)
        self.prob = full_map_problem(m, cfg)
        self.snapR = m.kf_Rcw
        self.snapt = m.kf_tcw
        self.snapp = m.mp_pos
        self.snap_kf_valid = m.kf_valid
        self.snap_mp_valid = m.mp_valid
        self.snap_kf_fid = m.kf_frame_id  # recycled-slot guard
        self.Rcw, self.tcw, self.points = m.kf_Rcw, m.kf_tcw, m.mp_pos
        self.active = self.prob.obs.valid
        self.lam = jnp.asarray(1e-4, m.kf_tcw.dtype)
        self.i = 0
        self.done = False

    def step(self):
        """Dispatch one LM slice (async; no host sync)."""
        if self.done:
            return
        total = self.n_iters + self.n_iters_final
        use_huber = jnp.asarray(self.i < self.n_iters)
        self.Rcw, self.tcw, self.points, self.lam, _ = gba_step_jit(
            self.cam, self.Rcw, self.tcw, self.points, self.prob.obs,
            self.prob, self.active, use_huber, self.lam,
            bf=self.bf, cg_iters=self.cg_iters,
            cam2=self.cam2, Rrl=self.Rrl, trl=self.trl,
        )
        self.i += 1
        if self.i == self.n_iters:
            self.active = gba_reclassify(
                self.cam, self.Rcw, self.tcw, self.points, self.prob.obs,
                bf=self.bf, cam2=self.cam2, Rrl=self.Rrl, trl=self.trl,
            )
            self.lam = jnp.asarray(1e-4, self.tcw.dtype)
        if self.i >= total:
            self.done = True

    def finish(self, m_live):
        """Run any remaining slices, then merge deltas into the live map."""
        while not self.done:
            self.step()
        # a slot recycled since the snapshot holds a DIFFERENT keyframe:
        # frame ids must match for the delta to apply
        kf_live = (
            self.snap_kf_valid & m_live.kf_valid
            & (m_live.kf_frame_id == self.snap_kf_fid)
        )
        mp_live = self.snap_mp_valid & m_live.mp_valid & (
            ~self.prob.point_fixed
        )
        return apply_gba_deltas(
            m_live, self.snapR, self.snapt, self.snapp,
            self.Rcw, self.tcw, self.points, kf_live, mp_live,
        )


@partial(jax.jit, static_argnames=("cam", "cfg", "bf", "n_iters",
                                   "n_iters_final", "cg_iters"))
def run_global_ba(m, cam, cfg, bf: float = 0.0, n_iters: int = 8,
                  n_iters_final: int = 5, cg_iters: int = 64):
    """GBA over the whole map; writes results back. ONE device dispatch.

    Equivalent of ``LoopClosing::RunGlobalBundleAdjustment``
    (`/root/reference/src/LoopClosing.cc:2018-2183`).  The synchronous
    pipeline has no keyframes created *during* GBA, so the reference's
    spanning-tree correction propagation (`:2080-2161`) reduces to a direct
    write-back; the async mapper applies the same delta-propagation via
    ``apply_ba_result``'s masked delta scatter.
    """
    from orb_slam3_noted_tpu.pipeline import map_state as MS
    from orb_slam3_noted_tpu.pipeline.tracking import _second_camera

    prob = full_map_problem(m, cfg)
    cam2, Rrl, trl = _second_camera(cfg)
    res = global_bundle_adjust(
        cam, prob, bf=bf, n_iters=n_iters,
        n_iters_final=n_iters_final, cg_iters=cg_iters,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    KF = m.kf_Rcw.shape[0]
    MP = m.mp_pos.shape[0]
    m = MS.apply_ba_result(
        m,
        jnp.arange(KF, dtype=jnp.int32), m.kf_valid,
        res.Rcw, res.tcw,
        jnp.arange(MP, dtype=jnp.int32), ~prob.point_fixed, res.points,
    )
    return m, res.cost
