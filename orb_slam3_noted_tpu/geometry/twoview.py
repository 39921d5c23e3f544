"""Two-view relative pose (monocular bootstrap) as batched RANSAC.

Batched equivalent of the reference's `src/TwoViewReconstruction.cc`
(``Reconstruct``: 200 RANSAC iterations each for homography and fundamental,
model selection by score ratio, motion recovery, triangulation with
cheirality/parallax gating).

Design departures (intentional): since we always work with calibrated
bearing rays (the camera model already unprojects, including fisheye), the
fundamental path becomes an 8-point **essential** RANSAC, and the homography
path a 4-point calibrated homography RANSAC (both scored with symmetric
epipolar / transfer error in normalized coordinates).  All hypotheses are
built and scored in one batch: (n_hyp, 8) minimal sets -> batched SVD ->
(n_hyp, N) error matrix -> argmax inliers.  Cheirality disambiguation
triangulates all candidates at once.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import so3
from orb_slam3_noted_tpu.geometry.triangulation import triangulate_dlt

_HP = jax.lax.Precision.HIGHEST


class TwoViewResult(NamedTuple):
    success: jnp.ndarray    # () bool
    R21: jnp.ndarray        # (3, 3) rotation cam1 -> cam2
    t21: jnp.ndarray        # (3,) unit-norm translation
    points1: jnp.ndarray    # (N, 3) triangulated points in cam-1 frame
    is_inlier: jnp.ndarray  # (N,) bool (good triangulation + epipolar inlier)
    n_inliers: jnp.ndarray  # () int32
    # cheirality-vote diagnostics (why success came out the way it did)
    vote_best: jnp.ndarray = jnp.int32(0)    # () best candidate's good count
    vote_second: jnp.ndarray = jnp.int32(0)  # () runner-up count
    n_dis: jnp.ndarray = jnp.int32(0)        # () disagreement-set size
    used_h: jnp.ndarray = jnp.bool_(False)   # () homography model chosen


def _eight_point_essential(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """Batched 8-point essential matrix from z=1 rays.

    x1, x2: (H, 8, 3) minimal sets. Returns (H, 3, 3) E with rank-2 projection.
    Constraint: x2^T E x1 = 0.
    """
    a1, b1 = x1[..., 0], x1[..., 1]
    a2, b2 = x2[..., 0], x2[..., 1]
    one = jnp.ones_like(a1)
    A = jnp.stack(
        [a2 * a1, a2 * b1, a2, b2 * a1, b2 * b1, b2, a1, b1, one], axis=-1
    )  # (H, 8, 9)
    # nullspace via the batched 9x9 Gram eigenproblem (one small symmetric
    # solve instead of an SVD of each rectangular system)
    G = jnp.einsum("hki,hkj->hij", A, A)
    _, V = jnp.linalg.eigh(G)
    E = V[..., :, 0].reshape(-1, 3, 3)
    # project to essential manifold: singular values -> (1, 1, 0)
    U, S, Vt2 = jnp.linalg.svd(E)
    D = jnp.zeros_like(E).at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0)
    return U @ D @ Vt2


def _sampson_error(E: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """Sampson epipolar error; E (H,3,3), x1/x2 (N,3) -> (H, N)."""
    Ex1 = jnp.einsum("hij,nj->hni", E, x1, precision=_HP)
    Etx2 = jnp.einsum("hji,nj->hni", E, x2, precision=_HP)
    x2Ex1 = jnp.einsum("ni,hni->hn", x2, Ex1, precision=_HP)
    denom = (
        Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    )
    return x2Ex1 * x2Ex1 / jnp.maximum(denom, 1e-12)


def _epipolar_errors(E: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray):
    """Directional point-to-epipolar-line errors (d1: x2 to E x1; d2: x1 to
    E^T x2); E (H,3,3) -> two (H, N) arrays.

    The reference scores the fundamental model with BOTH directions, each
    with its own chi2 term (``CheckFundamental``,
    `/root/reference/src/TwoViewReconstruction.cc`); a single Sampson term
    halves SF's scale and biases the H/F selection toward the homography.
    """
    Ex1 = jnp.einsum("hij,nj->hni", E, x1, precision=_HP)
    Etx2 = jnp.einsum("hji,nj->hni", E, x2, precision=_HP)
    x2Ex1 = jnp.einsum("ni,hni->hn", x2, Ex1, precision=_HP)
    num = x2Ex1 * x2Ex1
    d1 = num / jnp.maximum(Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2, 1e-12)
    d2 = num / jnp.maximum(Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2, 1e-12)
    return d1, d2


def _four_point_homography(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """Batched 4-point DLT homography from z=1 rays.

    x1, x2: (H, 4, 3) minimal sets. Returns (H, 3, 3) with x2 ~ H x1.
    """
    u2, v2 = x2[..., 0], x2[..., 1]
    z = jnp.zeros_like(x1)
    r1 = jnp.concatenate([z, -x1, v2[..., None] * x1], axis=-1)  # (H, 4, 9)
    r2 = jnp.concatenate([x1, z, -u2[..., None] * x1], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)  # (H, 8, 9)
    G = jnp.einsum("hki,hkj->hij", A, A)
    _, V = jnp.linalg.eigh(G)
    return V[..., :, 0].reshape(-1, 3, 3)


def _transfer_errors(Hm: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray):
    """Symmetric transfer errors for homographies.

    Hm (B,3,3), x1/x2 (N,3) -> (e12, e21) each (B, N): squared distance of
    H x1 vs x2 and H^-1 x2 vs x1 in normalized image coords.
    """
    Hx1 = jnp.einsum("bij,nj->bni", Hm, x1, precision=_HP)
    Hinv = jnp.linalg.inv(Hm)
    Hx2 = jnp.einsum("bij,nj->bni", Hinv, x2, precision=_HP)
    z12 = jnp.where(jnp.abs(Hx1[..., 2:]) < 1e-12, 1e-12, Hx1[..., 2:])
    z21 = jnp.where(jnp.abs(Hx2[..., 2:]) < 1e-12, 1e-12, Hx2[..., 2:])
    e12 = jnp.sum((Hx1[..., :2] / z12 - x2[None, :, :2]) ** 2, axis=-1)
    e21 = jnp.sum((Hx2[..., :2] / z21 - x1[None, :, :2]) ** 2, axis=-1)
    return e12, e21


def _decompose_homography(Hm: jnp.ndarray):
    """Faugeras SVD decomposition of a calibrated homography -> 8 (R, t).

    Faugeras & Lustman 1988, as used by the reference's ``ReconstructH``
    (`/root/reference/src/TwoViewReconstruction.cc`): H = d R + t n^T has 8
    solutions; with SVD H = U diag(d1,d2,d3) V^T they are closed-form in the
    singular values. Returns (R (8,3,3), t (8,3) unit, degenerate () bool).
    """
    U, D, Vt = jnp.linalg.svd(Hm)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = D[0], D[1], D[2]
    # d1 ~ d2 ~ d3 means pure rotation / conic degeneracy
    degenerate = (d1 / d2 < 1.00001) | (d2 / d3 < 1.00001)
    eps = 1e-12
    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3 + eps), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3 + eps), 0.0))
    e1 = jnp.asarray([1.0, 1.0, -1.0, -1.0], Hm.dtype)
    e3 = jnp.asarray([1.0, -1.0, 1.0, -1.0], Hm.dtype)
    x1v = aux1 * e1
    x3v = aux3 * e3

    # case d' = +d2: rotation about y by theta
    st_mag = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / ((d1 + d3) * d2 + eps)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2 + eps)
    st = st_mag * e1 * e3  # sign(x1*x3)

    def make_pos(i):
        Rp = jnp.asarray(
            [[ct, 0.0, -st[i]], [0.0, 1.0, 0.0], [st[i], 0.0, ct]], Hm.dtype
        )
        R = s * U @ Rp @ Vt
        tp = jnp.stack([x1v[i], jnp.zeros((), Hm.dtype), -x3v[i]])
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    # case d' = -d2: rotation about y by phi composed with diag(1,-1,-1)
    sp_mag = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / ((d1 - d3) * d2 + eps)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2 + eps)
    sp = sp_mag * e1 * e3

    def make_neg(i):
        Rp = jnp.asarray(
            [[cp, 0.0, sp[i]], [0.0, -1.0, 0.0], [sp[i], 0.0, -cp]], Hm.dtype
        )
        R = s * U @ Rp @ Vt
        tp = jnp.stack([x1v[i], jnp.zeros((), Hm.dtype), x3v[i]])
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    Rs, ts = [], []
    for i in range(4):
        R, t = make_pos(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = make_neg(i)
        Rs.append(R)
        ts.append(t)
    return jnp.stack(Rs), jnp.stack(ts), degenerate


def _hat(v):
    return jnp.asarray([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ], v.dtype)


def _refine_rt_sampson(R0, t0, rays1, rays2, w, n_iters: int = 8):
    """Gold-standard (R, t) refinement: damped GN on Sampson error.

    Minimizes sum_i w_i * sampson(E(R,t); x1_i, x2_i)^2 over the 5-dof
    essential manifold (so3 x unit-translation tangent).  The algebraic
    8-point refit is noise-biased; this is the standard follow-up (Hartley &
    Zisserman §11.4), replacing the reference's reliance on later full BA to
    absorb init error.
    """
    dtype = rays1.dtype

    def t_basis(t):
        tmp = jnp.where(jnp.abs(t[0]) < 0.9,
                        jnp.asarray([1.0, 0.0, 0.0], dtype),
                        jnp.asarray([0.0, 1.0, 0.0], dtype))
        b1 = jnp.cross(t, tmp)
        b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-12)
        b2 = jnp.cross(t, b1)
        return jnp.stack([b1, b2], axis=1)  # (3, 2)

    def residuals(R, t):
        E = _hat(t) @ R
        Ex1 = rays1 @ E.T
        Etx2 = rays2 @ E
        x2Ex1 = jnp.sum(rays2 * Ex1, axis=-1)
        denom = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
        return w * x2Ex1 / jnp.sqrt(jnp.maximum(denom, 1e-18))

    def step(carry, _):
        R, t, lam = carry
        B = t_basis(t)

        def r_of(d):
            Rn = so3.exp(d[:3]) @ R
            tn = t + B @ d[3:]
            tn = tn / jnp.maximum(jnp.linalg.norm(tn), 1e-12)
            return residuals(Rn, tn)

        z5 = jnp.zeros(5, dtype)
        r = r_of(z5)
        J = jax.jacfwd(r_of)(z5)
        H = J.T @ J + lam * jnp.eye(5, dtype=dtype)
        d = jnp.linalg.solve(H, -J.T @ r)
        Rn = so3.exp(d[:3]) @ R
        tn = t + B @ d[3:]
        tn = tn / jnp.maximum(jnp.linalg.norm(tn), 1e-12)
        better = jnp.sum(r_of(z5) ** 2) > jnp.sum(residuals(Rn, tn) ** 2)
        R = jnp.where(better, Rn, R)
        t = jnp.where(better, tn, t)
        lam = jnp.where(better, lam * 0.5, lam * 10.0)
        return (R, t, lam), None

    (R, t, _), _ = jax.lax.scan(
        step, (R0, t0, jnp.asarray(1e-6, dtype)), None, length=n_iters
    )
    return R, t


def _decompose_essential(E: jnp.ndarray):
    """E -> 4 candidate (R, t) with det(R) = +1, |t| = 1."""
    U, _, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))[..., None, None]
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))[..., None, None]
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    return (R1, t), (R1, -t), (R2, t), (R2, -t)


@partial(jax.jit, static_argnames=("n_hyp",))
def reconstruct_two_views(
    rays1: jnp.ndarray,
    rays2: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
    err_thresh: float = 1e-5,
    min_parallax_cos: float = 0.99998,
    n_hyp: int = 256,
) -> TwoViewResult:
    """Relative pose + structure from matched bearing rays.

    rays1/rays2: (N, 3) z=1 rays of matched features (padded; see valid).
    err_thresh: Sampson threshold in normalized coords, ~ (3.84 px / fx)^2 as
    the reference's chi2 gating (`TwoViewReconstruction.cc` sigma-based score).
    min_parallax_cos: triangulated points need parallax below this cosine
    (reference requires ~1 deg for init).
    """
    n = rays1.shape[0]
    dtype = rays1.dtype
    # model-selection score offset: the reference scores both models with the
    # 2-dof chi2 (5.991) while gating F inliers at 3.841
    # (`TwoViewReconstruction.cc` CheckFundamental/CheckHomography)
    th_score = err_thresh * (5.991 / 3.841)

    # --- sample minimal sets (probability mass on valid entries) ---
    p = valid.astype(dtype)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    keys = jax.random.split(key, n_hyp)
    idx = jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(8,), replace=False, p=p)
    )(keys)  # (H, 8)

    # ===== essential hypotheses (general scene) =====
    # scored over BOTH epipolar directions like the reference's
    # CheckFundamental (each direction gated at 3.841, offset 5.991)
    E = _eight_point_essential(rays1[idx], rays2[idx])  # (H, 3, 3)
    d1, d2 = _epipolar_errors(E, rays1, rays2)          # (H, N) each
    vmE = valid[None, :]
    inl = (d1 < err_thresh) & (d2 < err_thresh) & vmE
    score = jnp.sum(
        jnp.where(vmE & (d1 < err_thresh), th_score - d1, 0.0)
        + jnp.where(vmE & (d2 < err_thresh), th_score - d2, 0.0),
        axis=-1,
    )
    best = jnp.argmax(score)

    # ===== homography hypotheses (planar / low-parallax scene) =====
    Hh = _four_point_homography(rays1[idx[:, :4]], rays2[idx[:, :4]])
    e12, e21 = _transfer_errors(Hh, rays1, rays2)
    inl_h = (e12 < th_score) & (e21 < th_score) & valid[None, :]
    vm = valid[None, :]
    score_h = jnp.sum(
        jnp.where(vm & (e12 < th_score), th_score - e12, 0.0)
        + jnp.where(vm & (e21 < th_score), th_score - e21, 0.0),
        axis=-1,
    )
    best_h = jnp.argmax(score_h)

    # ===== model selection: RH = SH / (SH + SF) (reference uses > 0.40) ====
    SF = score[best]
    SH = score_h[best_h]
    use_H = SH / jnp.maximum(SH + SF, 1e-12) > 0.40

    # --- refit E on the inliers (iterated LS: refit -> reclassify -> refit) ---
    inl_best_e = inl[best]
    a1, b1 = rays1[:, 0], rays1[:, 1]
    a2, b2 = rays2[:, 0], rays2[:, 1]
    A_full = jnp.stack(
        [a2 * a1, a2 * b1, a2, b2 * a1, b2 * b1, b2, a1, b1, jnp.ones_like(a1)],
        axis=-1,
    )
    D = jnp.diag(jnp.asarray([1.0, 1.0, 0.0], dtype))
    for _ in range(2):
        w = inl_best_e.astype(dtype)
        # nullspace via the 9x9 Gram eigenproblem (a full SVD of the
        # (N, 9) system materializes the N x N left factor — ~100x the work)
        Aw = A_full * w[:, None]
        G = Aw.T @ Aw
        _, V = jnp.linalg.eigh(G)
        E_ls = V[:, 0].reshape(3, 3)
        U, _, Vt2 = jnp.linalg.svd(E_ls)
        E_best = U @ D @ Vt2
        err_best = _sampson_error(E_best[None], rays1, rays2)[0]
        inl_best_e = (err_best < err_thresh) & valid

    # --- refit H on the inliers (iterated DLT LS) ---
    inl_best_h = inl_h[best_h]
    zr = jnp.zeros_like(rays1)
    u2, v2 = rays2[:, 0:1], rays2[:, 1:2]
    rows1_full = jnp.concatenate([zr, -rays1, v2 * rays1], axis=-1)
    rows2_full = jnp.concatenate([rays1, zr, -u2 * rays1], axis=-1)
    for _ in range(2):
        wh = inl_best_h.astype(dtype)[:, None]
        Ah = jnp.concatenate([rows1_full * wh, rows2_full * wh], axis=0)
        Gh = Ah.T @ Ah
        _, Vh = jnp.linalg.eigh(Gh)
        H_best = Vh[:, 0].reshape(3, 3)
        e12b, e21b = _transfer_errors(H_best[None], rays1, rays2)
        inl_best_h = (e12b[0] < th_score) & (e21b[0] < th_score) & valid

    inl_best = jnp.where(use_H, inl_best_h, inl_best_e)

    # --- candidate motions: 8 from H (Faugeras), 4 from E (padded to 8) ---
    Rs_h, ts_h, h_degenerate = _decompose_homography(H_best)
    (Re1, te1), (Re2, te2), (Re3, te3), (Re4, te4) = _decompose_essential(
        E_best[None]
    )
    Rs_e = jnp.concatenate(
        [Re1, Re2, Re3, Re4, Re1, Re2, Re3, Re4], axis=0
    )
    ts_e = jnp.concatenate(
        [te1, te2, te3, te4, te1, te2, te3, te4], axis=0
    )
    cand_R = jnp.where(use_H, Rs_h, Rs_e)
    cand_t = jnp.where(use_H, ts_h, ts_e)
    # duplicate E candidates (and H's none) masked out of the vote so the
    # clear-winner test below is meaningful
    cand_valid = jnp.where(
        use_H, jnp.ones(8, bool), jnp.arange(8) < 4
    )
    cands = [((cand_R[i][None], cand_t[i][None]), cand_valid[i]) for i in range(8)]

    def check(Rt):
        R21, t21 = Rt[0][0], Rt[1][0]
        pts1 = triangulate_dlt(rays1, rays2, R21, t21)
        z1 = pts1[:, 2]
        p2 = pts1 @ R21.T + t21
        z2 = p2[:, 2]
        # reprojection gate in normalized coords.  The reference CheckRT gate
        # is 4*sigma2 (~4 px^2 at sigma=1, `src/TwoViewReconstruction.cc`);
        # this gate is DELIBERATELY looser (4x the ~3.84 px^2 model
        # threshold, ~15.4 px^2 equivalent) so off-plane points survive the
        # vote — they are precisely what separates the two Faugeras
        # conjugate solutions of a dominant-plane scene (measured: the
        # tighter reference gate stalls mono init on planar synthetic
        # scenes, the looser one does not and end-to-end ATE is unchanged).
        z1s = jnp.where(jnp.abs(z1) < 1e-9, 1e-9, z1)
        z2s = jnp.where(jnp.abs(z2) < 1e-9, 1e-9, z2)
        e1 = jnp.sum((pts1[:, :2] / z1s[:, None] - rays1[:, :2]) ** 2, axis=-1)
        e2 = jnp.sum((p2[:, :2] / z2s[:, None] - rays2[:, :2]) ** 2, axis=-1)
        reproj_ok = (e1 < 4.0 * err_thresh) & (e2 < 4.0 * err_thresh)
        # parallax between the two rays to the point
        r1 = pts1
        r2 = pts1 - (-R21.T @ t21)  # vector from cam2 center (in cam1 frame)
        cosp = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(
            jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-12
        )
        # vote over ALL matches (not only the model's inliers): under a
        # dominant plane the H-inlier set contains only plane points, for
        # which the two Faugeras conjugate solutions are exactly equivalent
        # — off-plane matches are what disambiguates them (reference
        # CheckRT votes over vbMatchesInliers of the model, but its pixel
        # thresholds admit the off-plane points; ours are plane-tight)
        good = (
            valid
            & (z1 > 1e-6)
            & (z2 > 1e-6)
            & (cosp < min_parallax_cos)
            & reproj_ok
        )
        return good, pts1, R21, t21, cosp

    goods, ptss, Rs, ts, cosps = [], [], [], [], []
    for (rt, cv) in cands:
        g, p3, R21, t21, cosp = check(rt)
        goods.append(g & cv)
        ptss.append(p3)
        Rs.append(R21)
        ts.append(t21)
        cosps.append(cosp)
    goods = jnp.stack(goods)
    counts = jnp.sum(goods, axis=-1)
    kbest = jnp.argmax(counts)
    n_good = counts[kbest]
    n_second = jnp.sort(counts)[-2]
    ksec = jnp.argmax(jnp.where(jnp.arange(8) == kbest, -1, counts))
    # pairwise disambiguation on the DISAGREEMENT set: under a dominant
    # plane both Faugeras conjugates explain every plane point, so global
    # counts stay close; the off-plane points that only one solution
    # explains are the evidence that matters
    dis_a = goods[kbest] & ~goods[ksec]
    dis_b = goods[ksec] & ~goods[kbest]
    n_dis = jnp.sum(dis_a) + jnp.sum(dis_b)
    decisive = (jnp.sum(dis_a) >= 0.8 * n_dis) & (n_dis >= 20)

    # Success criteria mirroring the reference (`TwoViewReconstruction.cc`
    # minTriangulated=50, minParallax=1 deg checked at the 50th-best point):
    # enough well-triangulated points, a clear cheirality winner, and real
    # parallax (guards against near-pure-rotation bootstraps whose points
    # leak through the per-point gates via noise).
    cosp_best = jnp.where(goods[kbest], jnp.stack(cosps)[kbest], 1.0)
    cosp_sorted = jnp.sort(cosp_best)  # ascending = best parallax first
    parallax_50 = cosp_sorted[jnp.minimum(49, cosp_sorted.shape[0] - 1)]
    success = (
        (n_good >= 50)
        & ((n_second < 0.75 * n_good) | decisive)
        & (parallax_50 < jnp.cos(jnp.deg2rad(1.0)))
        & ~(use_H & h_degenerate)
    )

    # gold-standard polish of the winning motion on its inliers, then final
    # triangulation with the refined pose
    R_w = jnp.stack(Rs)[kbest]
    t_w = jnp.stack(ts)[kbest]
    R_w, t_w = _refine_rt_sampson(
        R_w, t_w, rays1, rays2, goods[kbest].astype(dtype)
    )
    good_f, pts_f, _, _, _ = check((R_w[None], t_w[None]))
    # the map is built from the POST-refine inlier set: success must gate
    # on it too — a diverged polish can collapse good_f to ~0 while the
    # pre-refine vote looked healthy (found: NaN-scale init on the
    # round-5 pendulum accuracy lap, which then poisoned every pose)
    success = success & (jnp.sum(good_f) >= 40)
    return TwoViewResult(
        success=success,
        R21=R_w,
        t21=t_w,
        points1=pts_f,
        is_inlier=good_f,
        n_inliers=jnp.sum(good_f).astype(jnp.int32),
        vote_best=n_good.astype(jnp.int32),
        vote_second=n_second.astype(jnp.int32),
        n_dis=n_dis.astype(jnp.int32),
        used_h=use_H,
    )
