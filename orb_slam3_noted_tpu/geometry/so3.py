"""SO(3): rotation group operations.

Functional equivalents of the reference's SO(3) helpers
(`/root/reference/src/ImuTypes.cc:96-189` — ``ExpSO3``, ``LogSO3``,
``RightJacobianSO3``, ``InverseRightJacobianSO3``, ``NormalizeRotation``),
re-derived from the standard Rodrigues / right-Jacobian formulas rather than
translated.  Everything is pure jnp with Taylor-series small-angle branches
chosen via ``jnp.where`` so the functions are jit/vmap/grad-safe.

Conventions: rotation matrices are (3, 3) arrays mapping body -> world when
used as a pose; tangent vectors are (3,) axis-angle vectors.
"""

from __future__ import annotations

import jax.numpy as jnp

# Below this angle (radians) the closed forms are replaced by their
# 2nd-order Taylor expansions to avoid 0/0.
_EPS = 1e-5


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of w = (x, y, z): hat(w) @ v == cross(w, v)."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`hat` (assumes W skew-symmetric)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def exp(w: jnp.ndarray) -> jnp.ndarray:
    """Exponential map R = exp(hat(w)) via the Rodrigues formula.

    R = I + sin(t)/t * W + (1-cos(t))/t^2 * W^2,  t = |w|.
    """
    t2 = jnp.sum(w * w, axis=-1)
    t = jnp.sqrt(t2)
    W = hat(w)
    W2 = W @ W
    a = jnp.where(t < _EPS, 1.0 - t2 / 6.0, jnp.sin(t) / jnp.where(t < _EPS, 1.0, t))
    b = jnp.where(
        t < _EPS, 0.5 - t2 / 24.0, (1.0 - jnp.cos(t)) / jnp.where(t < _EPS, 1.0, t2)
    )
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def log(R: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map w = vee(log(R)); handles angles up to pi (exclusive).

    Uses w = t / (2 sin t) * vee(R - R^T) with cos t = (tr(R) - 1) / 2, with a
    Taylor branch near t = 0.  Near t = pi the off-diagonal formula degrades;
    we add a quaternion-based fallback which is stable there.
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    v = vee(R - jnp.swapaxes(R, -1, -2))  # = 2 sin(t) * axis
    # safe sqrt: linalg.norm has a NaN derivative at exactly zero, which
    # poisons autodiff of zero-residual pose-graph edges (log at identity)
    sin_t = 0.5 * jnp.sqrt(jnp.sum(v * v, axis=-1) + 1e-30)
    t = jnp.arctan2(sin_t, cos_t)
    small = t < _EPS
    near_pi = t > jnp.pi - 1e-3

    # Generic branch: w = t / (2 sin t) * v, small-angle limit 0.5 * v.
    scale = jnp.where(
        small, 0.5 + t * t / 12.0, t / jnp.where(small, 1.0, 2.0 * sin_t + 1e-30)
    )
    w_generic = scale[..., None] * v

    # Near-pi branch: the symmetric part S = (R+R^T)/2 = cos_t I + (1-cos_t)aa^T
    # gives the rank-1 matrix B = (S - cos_t I)/(1-cos_t) = a a^T, from which
    # the axis is read off as the normalized column with the largest diagonal.
    S = 0.5 * (R + jnp.swapaxes(R, -1, -2))
    denom = jnp.where(near_pi, 1.0 - cos_t, 1.0)
    B = (S - cos_t[..., None, None] * jnp.eye(3, dtype=R.dtype)) / denom[..., None, None]
    diagB = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    k = jnp.argmax(diagB, axis=-1)
    col = jnp.take_along_axis(B, k[..., None, None].repeat(3, axis=-2), axis=-1)[..., 0]
    norm = jnp.linalg.norm(col, axis=-1, keepdims=True)
    axis_pi = col / jnp.where(norm < 1e-12, 1.0, norm)
    # Fix the sign from v = 2 sin(t) a (sin t >= 0 for t in [0, pi]).
    dv = jnp.sum(axis_pi * v, axis=-1, keepdims=True)
    axis_pi = axis_pi * jnp.where(dv < 0.0, -1.0, 1.0)
    w_pi = t[..., None] * axis_pi

    return jnp.where(near_pi[..., None], w_pi, w_generic)


def right_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian Jr(w) of SO(3).

    Jr = I - (1-cos t)/t^2 W + (t - sin t)/t^3 W^2.  Satisfies
    exp(w + dw) ~= exp(w) exp(Jr dw).
    """
    t2 = jnp.sum(w * w, axis=-1)
    t = jnp.sqrt(t2)
    W = hat(w)
    W2 = W @ W
    small = t < _EPS
    b = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(t)) / jnp.where(small, 1.0, t2))
    c = jnp.where(
        small, 1.0 / 6.0 - t2 / 120.0, (t - jnp.sin(t)) / jnp.where(small, 1.0, t2 * t)
    )
    eye = jnp.eye(3, dtype=w.dtype)
    return eye - b[..., None, None] * W + c[..., None, None] * W2


def inverse_right_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse right Jacobian Jr^{-1}(w).

    Jr^{-1} = I + 1/2 W + (1/t^2 - (1+cos t)/(2 t sin t)) W^2.
    """
    t2 = jnp.sum(w * w, axis=-1)
    t = jnp.sqrt(t2)
    W = hat(w)
    W2 = W @ W
    small = t < _EPS
    denom = jnp.where(small, 1.0, 2.0 * t * jnp.sin(t))
    c = jnp.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        1.0 / jnp.where(small, 1.0, t2) - (1.0 + jnp.cos(t)) / denom,
    )
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + 0.5 * W + c[..., None, None] * W2


def left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian Jl(w) = Jr(-w)."""
    return right_jacobian(-w)


def inverse_left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse left Jacobian Jl^{-1}(w) = Jr^{-1}(-w)."""
    return inverse_right_jacobian(-w)


def normalize(R: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize a drifting rotation matrix (quaternion round-trip).

    Same scheme as the reference (`src/ImuTypes.cc` NormalizeRotation) and
    branch-free, so it stays pure vectorized arithmetic instead of a
    batched iterative SVD.
    """
    return from_quat(to_quat(R))


def normalize_svd(R: jnp.ndarray) -> jnp.ndarray:
    """Polar-projection onto SO(3) via SVD (the optimal projection).

    Iterative (batched SVD); used only off the hot path.
    """
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.concatenate(
        [jnp.ones_like(det)[..., None], jnp.ones_like(det)[..., None], det[..., None]],
        axis=-1,
    )
    return (U * D[..., None, :]) @ Vt


def from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix from quaternion (w, x, y, z), not necessarily unit."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (w, x, y, z) from rotation matrix, branch-free (Shepperd).

    Computes all four candidate quaternions and selects the one with the
    largest pivot — jit/vmap-safe (no data-dependent control flow).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by its own pivot 4*q_i^2 = 1 + 2 m_ii - tr.
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4 candidates, 4)

    pivots = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    idx = jnp.argmax(pivots, axis=-1)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    q = q * jnp.sign(jnp.where(jnp.abs(q[..., :1]) < 1e-30, 1.0, q[..., :1]))
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)
