"""Sim(3) pose-graph (essential graph) optimization.

Equivalent of ``Optimizer::OptimizeEssentialGraph``
(`/root/reference/src/Optimizer.cc:2083`): after a loop is detected, all
keyframe poses are re-optimized as Sim(3) vertices against relative-pose
edges (covisibility + spanning chain + loop edges), absorbing accumulated
drift — including monocular scale drift — into the graph.

Batched design: all edge residuals r_e = log(S_meas * S_i * S_j^{-1}) and
their 7x14 Jacobians evaluate in one vmapped autodiff batch; the dense
(7K x 7K) normal system is scatter-assembled and solved whole.  K <= a few
hundred keyframes keeps this comfortably on one chip (the distributed
variant shards edges like :mod:`orb_slam3_noted_tpu.parallel.dist_ba`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import se3, sim3

_HP = jax.lax.Precision.HIGHEST


class Sim3Edges(NamedTuple):
    """Static-shape edge table. Measurement: S_ji = S_j * S_i^{-1} at build time."""

    i: jnp.ndarray       # (E,) int32 "from" vertex
    j: jnp.ndarray       # (E,) int32 "to" vertex
    R: jnp.ndarray       # (E, 3, 3) measured relative rotation (j <- i)
    t: jnp.ndarray       # (E, 3)
    s: jnp.ndarray       # (E,)
    weight: jnp.ndarray  # (E,) information scale
    valid: jnp.ndarray   # (E,) bool


def _edge_residual(Sm, Si, Sj):
    """r = log(S_meas * S_i * S_j^{-1}) (7,)."""
    return sim3.log(sim3.compose(Sm, sim3.compose(Si, sim3.inverse(Sj))))


def _residual_tangent(Sm, Si, Sj, di, dj):
    Si2 = sim3.compose(sim3.exp(di), Si)
    Sj2 = sim3.compose(sim3.exp(dj), Sj)
    return _edge_residual(Sm, Si2, Sj2)


def _pose_graph_sim3_impl(R, t, s, edges, fixed, n_iters, lam, fix_scale,
                          psum=None):
    K = R.shape[0]
    dtype = t.dtype
    z7 = jnp.zeros(7, dtype)

    def eval_edges(R, t, s):
        Sm = (edges.R, edges.t, edges.s)
        Si = (R[edges.i], t[edges.i], s[edges.i])
        Sj = (R[edges.j], t[edges.j], s[edges.j])

        r = jax.vmap(_edge_residual)(Sm, Si, Sj)  # (E, 7)

        def jac(sm_r, sm_t, sm_s, si_r, si_t, si_s, sj_r, sj_t, sj_s):
            f = lambda di, dj: _residual_tangent(
                (sm_r, sm_t, sm_s), (si_r, si_t, si_s), (sj_r, sj_t, sj_s), di, dj
            )
            Ji = jax.jacfwd(f, argnums=0)(z7, z7)
            Jj = jax.jacfwd(f, argnums=1)(z7, z7)
            return Ji, Jj

        Ji, Jj = jax.vmap(jac)(
            edges.R, edges.t, edges.s,
            R[edges.i], t[edges.i], s[edges.i],
            R[edges.j], t[edges.j], s[edges.j],
        )  # (E, 7, 7) each
        w = jnp.where(edges.valid, edges.weight, 0.0)
        cost = jnp.sum(w * jnp.sum(r * r, axis=-1))
        if psum is not None:
            cost = psum(cost)
        return r, Ji, Jj, w, cost

    def gn_step(carry, _):
        R, t, s, lam_c = carry
        r, Ji, Jj, w, cost_old = eval_edges(R, t, s)
        wJi = w[:, None, None] * Ji
        wJj = w[:, None, None] * Jj
        Hii = jnp.einsum("eai,eaj->eij", wJi, Ji, precision=_HP)
        Hjj = jnp.einsum("eai,eaj->eij", wJj, Jj, precision=_HP)
        Hij = jnp.einsum("eai,eaj->eij", wJi, Jj, precision=_HP)
        gi = jnp.einsum("eai,ea->ei", Ji, w[:, None] * r, precision=_HP)
        gj = jnp.einsum("eai,ea->ei", Jj, w[:, None] * r, precision=_HP)

        H = jnp.zeros((K, 7, K, 7), dtype)
        H = H.at[edges.i, :, edges.i, :].add(Hii)
        H = H.at[edges.j, :, edges.j, :].add(Hjj)
        H = H.at[edges.i, :, edges.j, :].add(Hij)
        H = H.at[edges.j, :, edges.i, :].add(jnp.swapaxes(Hij, -1, -2))
        g = jnp.zeros((K, 7), dtype)
        g = g.at[edges.i].add(gi)
        g = g.at[edges.j].add(gj)
        if psum is not None:
            # edge table sharded over the mesh: reduce the assembled
            # normal equations, then every device solves identically
            H = psum(H)
            g = psum(g)

        # gauge + free-vertex damping on the block diagonal
        bump = jnp.where(fixed, 1e12, lam_c + 1e-8)
        H = H.at[jnp.arange(K), :, jnp.arange(K), :].add(
            bump[:, None, None] * jnp.eye(7, dtype=dtype)
        )
        g = jnp.where(fixed[:, None], 0.0, g)

        d = jnp.linalg.solve(H.reshape(K * 7, K * 7), -g.reshape(K * 7)).reshape(K, 7)
        d = jnp.where(fixed[:, None], 0.0, d)
        if fix_scale:
            d = d.at[:, 6].set(0.0)  # SE3 subgroup: 6-DoF essential graph
        Rn, tn, sn = jax.vmap(lambda dd, RR, tt, ss: sim3.compose(sim3.exp(dd), (RR, tt, ss)))(
            d, R, t, s
        )
        _, _, _, _, cost_new = eval_edges(Rn, tn, sn)
        better = cost_new < cost_old
        R = jnp.where(better, Rn, R)
        t = jnp.where(better, tn, t)
        s = jnp.where(better, sn, s)
        lam_c = jnp.where(better, lam_c * 0.5, lam_c * 10.0)
        return (R, t, s, lam_c), cost_new

    (R, t, s, _), costs = jax.lax.scan(
        gn_step, (R, t, s, jnp.asarray(lam, dtype)), None, length=n_iters
    )
    return R, t, s, costs[-1]


@partial(jax.jit, static_argnames=("n_iters", "fix_scale"))
def optimize_pose_graph_sim3(
    R: jnp.ndarray,       # (K, 3, 3) S_iw rotations (world -> kf)
    t: jnp.ndarray,       # (K, 3)
    s: jnp.ndarray,       # (K,)
    edges: Sim3Edges,
    fixed: jnp.ndarray,   # (K,) bool (e.g. the loop keyframe / map origin)
    n_iters: int = 12,
    lam: float = 1e-6,
    fix_scale: bool = False,
):
    """Damped Gauss-Newton over the Sim3 pose graph. Returns (R, t, s, cost).

    ``fix_scale=True`` zeroes the log-scale component of every update — the
    6-DoF essential-graph variant the reference uses when scale is directly
    observable (stereo/RGB-D: ``OptimizeEssentialGraph6DoF``,
    `/root/reference/src/Optimizer.cc:2373`)."""
    return _pose_graph_sim3_impl(R, t, s, edges, fixed, n_iters, lam,
                                 fix_scale)


def distributed_pose_graph_sim3(
    mesh,
    R: jnp.ndarray,
    t: jnp.ndarray,
    s: jnp.ndarray,
    edges: Sim3Edges,
    fixed: jnp.ndarray,
    n_iters: int = 12,
    lam: float = 1e-6,
    fix_scale: bool = False,
):
    """Mesh-sharded Sim3 pose graph: edge table split over devices.

    The distributed essential-graph half of the SURVEY §2.3 north star:
    every device evaluates residuals/Jacobians for its edge shard, the
    assembled (K,7,K,7) normal equations are ``psum``'d over the mesh, and the
    dense solve is replicated (K <= a few hundred keyframes — the solve is
    tiny next to the per-edge autodiff Jacobians, which dominate and shard
    perfectly).  Returns (R, t, s, cost), replicated.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    n = mesh.size
    E = edges.i.shape[0]
    pad = (-E) % n
    if pad:
        edges = Sim3Edges(
            i=jnp.concatenate([edges.i, jnp.zeros(pad, jnp.int32)]),
            j=jnp.concatenate([edges.j, jnp.zeros(pad, jnp.int32)]),
            R=jnp.concatenate(
                [edges.R, jnp.tile(jnp.eye(3, dtype=edges.R.dtype), (pad, 1, 1))]
            ),
            t=jnp.concatenate([edges.t, jnp.zeros((pad, 3), edges.t.dtype)]),
            s=jnp.concatenate([edges.s, jnp.ones(pad, edges.s.dtype)]),
            weight=jnp.concatenate(
                [edges.weight, jnp.zeros(pad, edges.weight.dtype)]
            ),
            valid=jnp.concatenate([edges.valid, jnp.zeros(pad, bool)]),
        )
    rep = P()
    shard = P(axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(rep, rep, rep,
                  jax.tree_util.tree_map(lambda _: shard, edges), rep),
        out_specs=(rep, rep, rep, rep),
    )
    def run(R, t, s, e_shard, fx):
        psum = lambda x: jax.lax.psum(x, axis)
        return _pose_graph_sim3_impl(
            R, t, s, e_shard, fx, n_iters, lam, fix_scale, psum=psum
        )

    return run(R, t, s, edges, fixed)


# ---------------------------------------------------------------------------
# 4-DoF pose graph (yaw + translation) for the gravity-aligned inertial case
# ---------------------------------------------------------------------------


class SE3Edges(NamedTuple):
    """Relative SE(3) edge table: measurement T_ji = T_j * T_i^{-1}."""

    i: jnp.ndarray       # (E,) int32
    j: jnp.ndarray       # (E,) int32
    R: jnp.ndarray       # (E, 3, 3)
    t: jnp.ndarray       # (E, 3)
    weight: jnp.ndarray  # (E,)
    valid: jnp.ndarray   # (E,) bool


def _rz(psi):
    c, s = jnp.cos(psi), jnp.sin(psi)
    z = jnp.zeros_like(psi)
    o = jnp.ones_like(psi)
    return jnp.stack([
        jnp.stack([c, -s, z]),
        jnp.stack([s, c, z]),
        jnp.stack([z, z, o]),
    ])


def _apply_4dof(Ti, d):
    """World-side 4-dof update of a world->kf pose.

    d = (yaw, dt): the keyframe moves in the world by a rotation about the
    gravity axis (world z) plus a translation — camera center
    c' = Rz(yaw) c + dt, orientation yawed.  This is the update manifold of
    the reference's ``VertexPose4DoF`` (`include/G2oTypes.h:200-230`): after
    IMU initialization pitch/roll are observable and must not be disturbed
    by loop correction (`Optimizer::OptimizeEssentialGraph4DoF`,
    `src/Optimizer.cc:7441`).
    """
    Rz = _rz(d[0])
    Ri, ti = Ti
    Rn = Ri @ Rz.T
    tn = ti - Rn @ d[1:]
    return Rn, tn


def _edge_residual_se3(Tm, Ti, Tj):
    return se3.log(se3.compose(Tm, se3.compose(Ti, se3.inverse(Tj))))


def _residual_tangent_4dof(Tm, Ti, Tj, di, dj):
    return _edge_residual_se3(Tm, _apply_4dof(Ti, di), _apply_4dof(Tj, dj))


@partial(jax.jit, static_argnames=("n_iters",))
def optimize_pose_graph_4dof(
    R: jnp.ndarray,       # (K, 3, 3) T_iw rotations (world -> kf)
    t: jnp.ndarray,       # (K, 3)
    edges: SE3Edges,
    fixed: jnp.ndarray,   # (K,) bool
    n_iters: int = 12,
    lam: float = 1e-6,
):
    """Damped GN over the yaw+translation pose graph. Returns (R, t, cost)."""
    K = R.shape[0]
    dtype = t.dtype
    z4 = jnp.zeros(4, dtype)

    def eval_edges(R, t):
        Tm = (edges.R, edges.t)
        Ti = (R[edges.i], t[edges.i])
        Tj = (R[edges.j], t[edges.j])
        r = jax.vmap(_edge_residual_se3)(Tm, Ti, Tj)  # (E, 6)

        def jac(m_r, m_t, i_r, i_t, j_r, j_t):
            f = lambda di, dj: _residual_tangent_4dof(
                (m_r, m_t), (i_r, i_t), (j_r, j_t), di, dj
            )
            return jax.jacfwd(f, argnums=0)(z4, z4), jax.jacfwd(f, argnums=1)(z4, z4)

        Ji, Jj = jax.vmap(jac)(
            edges.R, edges.t, R[edges.i], t[edges.i], R[edges.j], t[edges.j]
        )  # (E, 6, 4)
        w = jnp.where(edges.valid, edges.weight, 0.0)
        cost = jnp.sum(w * jnp.sum(r * r, axis=-1))
        return r, Ji, Jj, w, cost

    def gn_step(carry, _):
        R, t, lam_c = carry
        r, Ji, Jj, w, cost_old = eval_edges(R, t)
        wJi = w[:, None, None] * Ji
        wJj = w[:, None, None] * Jj
        Hii = jnp.einsum("eai,eaj->eij", wJi, Ji, precision=_HP)
        Hjj = jnp.einsum("eai,eaj->eij", wJj, Jj, precision=_HP)
        Hij = jnp.einsum("eai,eaj->eij", wJi, Jj, precision=_HP)
        gi = jnp.einsum("eai,ea->ei", Ji, w[:, None] * r, precision=_HP)
        gj = jnp.einsum("eai,ea->ei", Jj, w[:, None] * r, precision=_HP)

        H = jnp.zeros((K, 4, K, 4), dtype)
        H = H.at[edges.i, :, edges.i, :].add(Hii)
        H = H.at[edges.j, :, edges.j, :].add(Hjj)
        H = H.at[edges.i, :, edges.j, :].add(Hij)
        H = H.at[edges.j, :, edges.i, :].add(jnp.swapaxes(Hij, -1, -2))
        g = jnp.zeros((K, 4), dtype)
        g = g.at[edges.i].add(gi)
        g = g.at[edges.j].add(gj)

        bump = jnp.where(fixed, 1e12, lam_c + 1e-8)
        H = H.at[jnp.arange(K), :, jnp.arange(K), :].add(
            bump[:, None, None] * jnp.eye(4, dtype=dtype)
        )
        g = jnp.where(fixed[:, None], 0.0, g)
        d = jnp.linalg.solve(H.reshape(K * 4, K * 4), -g.reshape(K * 4)).reshape(K, 4)
        d = jnp.where(fixed[:, None], 0.0, d)
        Rn, tn = jax.vmap(lambda dd, RR, tt: _apply_4dof((RR, tt), dd))(d, R, t)
        _, _, _, _, cost_new = eval_edges(Rn, tn)
        better = cost_new < cost_old
        R = jnp.where(better, Rn, R)
        t = jnp.where(better, tn, t)
        lam_c = jnp.where(better, lam_c * 0.5, lam_c * 10.0)
        return (R, t, lam_c), cost_new

    (R, t, _), costs = jax.lax.scan(
        gn_step, (R, t, jnp.asarray(lam, dtype)), None, length=n_iters
    )
    return R, t, costs[-1]
