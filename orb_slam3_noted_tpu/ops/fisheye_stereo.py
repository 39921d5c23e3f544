"""Non-rectified fisheye stereo: lapping-area matching + direct triangulation.

Batched equivalent of the reference's fisheye stereo path:

- ``Frame::ComputeStereoFishEyeMatches`` (`/root/reference/src/Frame.cc:1116`)
  matches left/right ORB descriptors restricted to each camera's lapping
  area, then keeps matches whose direct two-view triangulation passes the
  geometric gates.
- ``KannalaBrandt8::TriangulateMatches``
  (`/root/reference/src/CameraModels/KannalaBrandt8.cpp:236`): unproject both
  rays, reject low parallax (cos > 0.9998), midpoint/DLT triangulation with
  the known extrinsic ``Tlr``, reject behind-camera and high reprojection
  error (5.991 * sigma^2 per view).

Here the candidate set is the full dense Hamming matrix gated by the lapping
masks (one matmul) and every gate is evaluated for all pairs at once.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry.triangulation import triangulate_dlt
from orb_slam3_noted_tpu.models import cameras as cam_mod
from orb_slam3_noted_tpu.ops import matching as M

_HP = jax.lax.Precision.HIGHEST


class FisheyeStereoMatches(NamedTuple):
    """Per-LEFT-feature stereo association (static NF length)."""

    idx_r: jnp.ndarray    # (NF,) matched right-feature index or -1
    depth: jnp.ndarray    # (NF,) z in the LEFT camera frame (-1 invalid)
    pos_l: jnp.ndarray    # (NF, 3) triangulated point, left camera frame
    valid: jnp.ndarray    # (NF,) bool


@partial(
    jax.jit,
    static_argnames=("cam_l", "cam_r", "lap_l", "lap_r", "max_dist"),
)
def match_fisheye_stereo(
    feats_l,                 # FrameFeatures of the left image
    feats_r,                 # FrameFeatures of the right image
    cam_l: cam_mod.Camera,
    cam_r: cam_mod.Camera,
    Rlr: jnp.ndarray,        # (3, 3) rotation of right cam in left frame
    tlr: jnp.ndarray,        # (3,) translation of right cam in left frame
    lap_l: tuple = (0.0, 1e9),   # (u_begin, u_end) left lapping area
    lap_r: tuple = (0.0, 1e9),
    level_sigma2: jnp.ndarray | None = None,
    max_dist: int = M.TH_LOW,
) -> FisheyeStereoMatches:
    """Associate + triangulate left/right fisheye features.

    Returns matches in the left camera frame; ``depth`` is the left-frame z,
    directly usable by the depth-seeded map-point path (the KB8 unproject is
    z=1 normalized, so ray * depth reproduces ``pos_l``).
    """
    NF = feats_l.xy.shape[0]
    in_lap_l = (
        feats_l.valid
        & (feats_l.xy[:, 0] >= lap_l[0])
        & (feats_l.xy[:, 0] <= lap_l[1])
    )
    in_lap_r = (
        feats_r.valid
        & (feats_r.xy[:, 0] >= lap_r[0])
        & (feats_r.xy[:, 0] <= lap_r[1])
    )
    d = M.hamming_matrix_mxu(
        M.unpack_bits(feats_l.desc), M.unpack_bits(feats_r.desc)
    )
    gate = in_lap_l[:, None] & in_lap_r[None, :]
    masked = jnp.where(gate, d, M.BIG)
    best = jnp.min(masked, axis=1)
    idx = jnp.argmin(masked, axis=1).astype(jnp.int32)
    back = jnp.argmin(masked, axis=0)
    ok = (best <= max_dist) & in_lap_l & (back[idx] == jnp.arange(NF))

    # --- TriangulateMatches ---
    rays_l = cam_mod.unproject(cam_l, feats_l.xy)           # (NF, 3) z=1
    rays_r_all = cam_mod.unproject(cam_r, feats_r.xy)
    rays_r = rays_r_all[idx]
    # normalize to unit bearings for the parallax check
    bl = rays_l / jnp.linalg.norm(rays_l, axis=-1, keepdims=True)
    br_l = jnp.einsum("ij,nj->ni", Rlr, rays_r, precision=_HP)
    br_l = br_l / jnp.linalg.norm(br_l, axis=-1, keepdims=True)
    cos_par = jnp.sum(bl * br_l, axis=-1)
    ok = ok & (cos_par < 0.9998)

    # triangulate in the left frame: x_r = Rrl x_l + trl
    Rrl = Rlr.T
    trl = -jnp.einsum("ij,j->i", Rrl, tlr, precision=_HP)
    pts_l = triangulate_dlt(rays_l, rays_r, Rrl, trl)
    zl = pts_l[:, 2]
    pts_r = jnp.einsum("ij,nj->ni", Rrl, pts_l, precision=_HP) + trl
    zr = pts_r[:, 2]
    ok = ok & (zl > 0.05) & (zr > 0.05)

    # reprojection gates in PIXELS via the actual camera models (the
    # reference compares against 5.991 * sigma2 of the octave)
    uv_l_hat = cam_mod.project(cam_l, pts_l)
    uv_r_hat = cam_mod.project(cam_r, pts_r)
    e_l = jnp.sum((uv_l_hat - feats_l.xy) ** 2, axis=-1)
    e_r = jnp.sum((uv_r_hat - feats_r.xy[idx]) ** 2, axis=-1)
    if level_sigma2 is None:
        s2_l = jnp.ones(NF, pts_l.dtype)
        s2_r = jnp.ones(NF, pts_l.dtype)
    else:
        s2 = jnp.asarray(level_sigma2, pts_l.dtype)
        s2_l = s2[feats_l.level]
        s2_r = s2[feats_r.level[idx]]
    ok = ok & (e_l <= 5.991 * s2_l) & (e_r <= 5.991 * s2_r)

    return FisheyeStereoMatches(
        idx_r=jnp.where(ok, idx, -1),
        depth=jnp.where(ok, zl, -1.0),
        pos_l=pts_l,
        valid=ok,
    )
