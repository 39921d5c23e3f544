"""Visual-inertial factor library (batched residuals + Jacobians).

Batched equivalent of the reference's inertial factor graph types
(`/root/reference/include/G2oTypes.h`):

- body-frame reprojection residuals = ``EdgeMono/EdgeStereo`` attached to a
  ``VertexPose`` (`include/G2oTypes.h:339-489`), with the update-in-body-frame
  parameterization of ``ImuCamPose::Update`` (`src/G2oTypes.cc`):
  ``twb += Rwb dt; Rwb = Rwb Exp(dphi)``.
- :func:`inertial_edge_residuals` = ``EdgeInertial`` (`include/G2oTypes.h:491`,
  residual at `src/G2oTypes.cc:514-535`), whitened by the preintegration
  information, Jacobians by forward-mode autodiff over the 30-dim tangent of
  the two body states (edge counts are tiny — the temporal chain).
- :func:`bias_rw_residuals` = ``EdgeGyroRW``/``EdgeAccRW``
  (`include/G2oTypes.h:634,670`), information from the walk block of the
  preintegration covariance.
- :func:`prior_residuals` = ``EdgePriorPoseImu``/``ConstraintPoseImu``
  (`include/G2oTypes.h:705+`): a 15-dim prior pinning one body state.

State tangent layout per keyframe/frame (15):
``[dt(3), dphi(3), dv(3), dbg(3), dba(3)]``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import so3
from orb_slam3_noted_tpu.imu.preintegration import (
    Bias,
    Calib,
    Preintegrated,
)
from orb_slam3_noted_tpu.models import cameras as cam_mod
from orb_slam3_noted_tpu.optim import factors
from orb_slam3_noted_tpu.optim.inertial import imu_residual, whitener

_HP = jax.lax.Precision.HIGHEST


class VIState(NamedTuple):
    """Body states of K keyframes/frames (SoA)."""

    Rwb: jnp.ndarray  # (K, 3, 3)
    twb: jnp.ndarray  # (K, 3)
    vel: jnp.ndarray  # (K, 3)
    bg: jnp.ndarray   # (K, 3)
    ba: jnp.ndarray   # (K, 3)


class InertialEdges(NamedTuple):
    """Temporal preintegration chain: edge e connects states i[e] -> j[e]."""

    i: jnp.ndarray        # (E,) int32
    j: jnp.ndarray        # (E,) int32
    preint: Preintegrated  # stacked over E
    valid: jnp.ndarray    # (E,) bool


def retract(st: VIState, d: jnp.ndarray) -> VIState:
    """Apply a (K, 15) tangent update (reference ``ImuCamPose::Update``)."""
    dt, dphi, dv, dbg, dba = (
        d[:, 0:3], d[:, 3:6], d[:, 6:9], d[:, 9:12], d[:, 12:15]
    )
    twb = st.twb + jnp.einsum("kij,kj->ki", st.Rwb, dt, precision=_HP)
    Rwb = so3.normalize(jnp.einsum("kij,kjl->kil", st.Rwb, so3.exp(dphi),
                                   precision=_HP))
    return VIState(Rwb=Rwb, twb=twb, vel=st.vel + dv,
                   bg=st.bg + dbg, ba=st.ba + dba)


def cam_from_body(st: VIState, calib: Calib):
    """(Rcw, tcw) per state: Tcw = Tcb Tbw with Tcb = Tbc^-1."""
    Rcb = calib.Rbc.T
    tcb = -Rcb @ calib.tbc
    Rbw = jnp.swapaxes(st.Rwb, -1, -2)
    Rcw = jnp.einsum("ij,kjl->kil", Rcb, Rbw, precision=_HP)
    tcw = -jnp.einsum("kij,kj->ki", Rcw, st.twb, precision=_HP) + tcb
    return Rcw, tcw


def body_from_cam(Rcw: jnp.ndarray, tcw: jnp.ndarray, calib: Calib):
    """Inverse of :func:`cam_from_body`: (Rwb, twb) from camera pose(s).

    Rwb = Rcw^T Rbc^T, twb = Rcw^T (-Rbc^T tbc - tcw) — the body pose the
    reference stores as ``KeyFrame::GetImuRotation/GetImuPosition``.
    """
    tcb = -calib.Rbc.T @ calib.tbc
    Rwc = jnp.swapaxes(Rcw, -1, -2)
    Rwb = jnp.einsum("...ij,kj->...ik", Rwc, calib.Rbc, precision=_HP)
    twb = jnp.einsum("...ij,...j->...i", Rwc, tcb - tcw, precision=_HP)
    return Rwb, twb


def body_reproj_residuals(
    cam: cam_mod.Camera,
    st: VIState,
    calib: Calib,
    points: jnp.ndarray,
    obs: factors.ReprojObs,
    bf: float = 0.0,
    cam2: cam_mod.Camera | None = None,
    Rrl: jnp.ndarray | None = None,
    trl: jnp.ndarray | None = None,
):
    """Reprojection residuals with Jacobians in the BODY tangent.

    Returns r (O, R), Jp (O, R, 6) w.r.t. [dt, dphi] of the observing body
    state, Jl (O, R, 3) w.r.t. the landmark, chi2 (O,), ok (O,).  R = 3
    residual rows, or 5 with a second camera (``cam2``/``Rrl``/``trl``:
    non-rectified fisheye stereo, reference two-camera EdgeMono with Tlr,
    `include/G2oTypes.h:339-489`).
    The remaining 9 tangent rows (v, bg, ba) have zero reprojection Jacobian.
    """
    Rcw, tcw = cam_from_body(st, calib)
    r, _, Jl, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw, tcw, points, obs, bf=bf, cam2=cam2, Rrl=Rrl, trl=trl
    )
    # body-frame chain rule: x_b = Rwb^T (x_w - twb), x_c = Rcb x_b + tcb
    # d x_b / d dt = -I;  d x_b / d dphi = hat(x_b);  dx_c = Rcb dx_b.
    # reuse Jl = -Jproj_full @ Rcw  =>  -Jproj_full @ Rcb = Jl @ Rwb
    JRcb = jnp.einsum(
        "oab,obc->oac", Jl, st.Rwb[obs.pose_idx], precision=_HP
    )  # (O, 3, 3) = -Jproj_full @ Rcb
    xw = points[obs.point_idx]
    Rbw = jnp.swapaxes(st.Rwb, -1, -2)[obs.pose_idx]
    xb = jnp.einsum("oij,oj->oi", Rbw, xw - st.twb[obs.pose_idx], precision=_HP)
    J_dt = -JRcb
    J_dphi = jnp.einsum("oab,obc->oac", JRcb, so3.hat(xb), precision=_HP)
    Jp = jnp.concatenate([J_dt, J_dphi], axis=-1)  # (O, 3, 6)
    return r, Jp, Jl, chi2, ok


def _edge_residual_fn(Ri, ti, vi, bgi, bai, Rj, tj, vj, p, W):
    g = jnp.asarray([0.0, 0.0, -9.81], Ri.dtype)
    r = imu_residual(Ri, ti, vi, Rj, tj, vj, bgi, bai, p, g)
    return W @ r


def inertial_edge_residuals(st: VIState, edges: InertialEdges):
    """Whitened inertial residuals + Jacobians.

    Returns r (E, 9), Ji (E, 9, 15) w.r.t. state i tangent, Jj (E, 9, 15)
    w.r.t. state j tangent (only the first 9 rows of j's tangent are touched:
    the edge does not involve j's bias — reference ``EdgeInertial`` connects
    bias vertices of KF i only).
    """
    W = whitener(edges.preint)  # (E, 9, 9)

    def one(i, j, p, Wk):
        Ri, ti, vi = st.Rwb[i], st.twb[i], st.vel[i]
        bgi, bai = st.bg[i], st.ba[i]
        Rj, tj, vj = st.Rwb[j], st.twb[j], st.vel[j]

        def res(d):
            di, dj = d[:15], d[15:]
            Ri_ = Ri @ so3.exp(di[3:6])
            ti_ = ti + Ri @ di[0:3]
            vi_ = vi + di[6:9]
            bgi_ = bgi + di[9:12]
            bai_ = bai + di[12:15]
            Rj_ = Rj @ so3.exp(dj[3:6])
            tj_ = tj + Rj @ dj[0:3]
            vj_ = vj + dj[6:9]
            return _edge_residual_fn(Ri_, ti_, vi_, bgi_, bai_, Rj_, tj_, vj_, p, Wk)

        d0 = jnp.zeros(30, st.twb.dtype)
        r = res(d0)
        J = jax.jacfwd(res)(d0)  # (9, 30)
        return r, J[:, :15], J[:, 15:]

    r, Ji, Jj = jax.vmap(one)(
        edges.i, edges.j,
        jax.tree_util.tree_map(lambda x: x, edges.preint),
        W,
    )
    v = edges.valid.astype(r.dtype)
    return r * v[:, None], Ji * v[:, None, None], Jj * v[:, None, None]


def bias_rw_residuals(st: VIState, edges: InertialEdges):
    """Whitened bias random-walk residuals between consecutive states.

    Reference ``EdgeGyroRW``/``EdgeAccRW``: r = b_j - b_i with information
    from the walk block C[9:15, 9:15] of the preintegration covariance
    (`src/Optimizer.cc` LocalInertialBA edge setup).
    Returns r (E, 6) whitened, and the per-edge whitening diag (E, 6) so the
    assembler can form Jacobians trivially (J = +-W on the bias rows).
    """
    C = edges.preint.C
    walk_var = jnp.maximum(
        jnp.diagonal(C[:, 9:15, 9:15], axis1=-2, axis2=-1), 1e-18
    )
    w = jax.lax.rsqrt(walk_var)  # (E, 6)
    db = jnp.concatenate(
        [st.bg[edges.j] - st.bg[edges.i], st.ba[edges.j] - st.ba[edges.i]],
        axis=-1,
    )
    v = edges.valid.astype(db.dtype)
    return db * w * v[:, None], w * v[:, None]


class VIPrior(NamedTuple):
    """15-dim prior on one body state (``ConstraintPoseImu``)."""

    idx: jnp.ndarray    # () int32
    Rwb: jnp.ndarray    # (3, 3)
    twb: jnp.ndarray    # (3,)
    vel: jnp.ndarray    # (3,)
    bg: jnp.ndarray     # (3,)
    ba: jnp.ndarray     # (3,)
    sqrt_info: jnp.ndarray  # (15, 15) upper-triangular whitening
    valid: jnp.ndarray  # () bool


def prior_residuals(st: VIState, pr: VIPrior):
    """Whitened prior residual (15,) + Jacobian (15, 15) w.r.t. state tangent.

    Residual convention (reference ``EdgePriorPoseImu::computeError``):
    er = Log(Rp^T R), et = Rp^T (t - tp), ev = v - vp, eb = b - bp.
    """
    k = pr.idx
    R, t = st.Rwb[k], st.twb[k]

    def res(d):
        R_ = R @ so3.exp(d[3:6])
        t_ = t + R @ d[0:3]
        er = so3.log(pr.Rwb.T @ R_)
        et = pr.Rwb.T @ (t_ - pr.twb)
        ev = st.vel[k] + d[6:9] - pr.vel
        ebg = st.bg[k] + d[9:12] - pr.bg
        eba = st.ba[k] + d[12:15] - pr.ba
        return pr.sqrt_info @ jnp.concatenate([et, er, ev, ebg, eba])

    d0 = jnp.zeros(15, t.dtype)
    r = res(d0)
    J = jax.jacfwd(res)(d0)
    v = pr.valid.astype(r.dtype)
    return r * v, J * v
