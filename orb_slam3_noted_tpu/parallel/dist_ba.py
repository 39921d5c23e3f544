"""Distributed bundle adjustment over a device mesh — thin delegation layer.

The multi-chip path of SURVEY §2.3/§7-F: the observation table (the large
axis — O >> K, M) is sharded across devices on an ``obs`` mesh axis; every
device evaluates residuals/Jacobians for its shard; ``psum`` over the mesh
reduces the normal-equation blocks; the Schur reduction and pose solve run
replicated — the "assemble-with-collectives, solve-replicated" recipe of
the reference's north star (BASELINE.json).

Round-3 consolidation: the round-1 engine here materialized a dense
(K, 6, M, 3) pose-landmark coupling and psum'd it (memory O(K*M), fixed
damping, unconditional step acceptance).  That engine is gone;
:func:`distributed_bundle_adjust` now DELEGATES to
:func:`orb_slam3_noted_tpu.optim.gba.distributed_global_ba` — matrix-free
Schur/PCG with cost-checked adaptive damping, communicating O(K*6 + M*3)
floats per CG iteration.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from orb_slam3_noted_tpu.models import cameras as cam_mod
from orb_slam3_noted_tpu.optim import factors


def make_mesh(n_devices: int | None = None, axis: str = "obs") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"mesh of {n_devices} devices asked for, {len(devs)} visible"
            )
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def pad_obs_for_mesh(obs: factors.ReprojObs, n_devices: int) -> factors.ReprojObs:
    """Pad the observation table to a multiple of the mesh size (invalid pad)."""
    O = obs.pose_idx.shape[0]
    pad = (-O) % n_devices
    if pad == 0:
        return obs
    f = lambda x: (
        None if x is None
        else jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
    )
    return factors.ReprojObs(
        pose_idx=f(obs.pose_idx),
        point_idx=f(obs.point_idx),
        uv=f(obs.uv),
        uv_r=f(obs.uv_r),
        inv_sigma2=f(obs.inv_sigma2),
        is_stereo=f(obs.is_stereo),
        valid=jnp.concatenate([obs.valid, jnp.zeros(pad, bool)]),
        uv2=f(obs.uv2),
        is_right=f(obs.is_right),
    )


def distributed_bundle_adjust(
    cam: cam_mod.Camera,
    mesh: Mesh,
    Rcw, tcw, points, obs, pose_fixed, point_fixed,
    n_iters: int = 10,
    bf: float = 0.0,
):
    """Distributed LM over the mesh. Returns (Rcw, tcw, points, cost).

    Delegates to the matrix-free ``distributed_global_ba`` engine
    (`optim/gba.py`): obs shard per device, psum'd segment sums inside the
    Schur matvec, cost-checked adaptive damping in lockstep on every device.
    """
    from orb_slam3_noted_tpu.optim.ba import BAProblem
    from orb_slam3_noted_tpu.optim.gba import distributed_global_ba

    prob = BAProblem(
        Rcw=Rcw, tcw=tcw, points=points, obs=obs,
        pose_fixed=pose_fixed, point_fixed=point_fixed,
    )
    n1 = max(n_iters // 2, 1)
    Rf, tf, pf, cost = distributed_global_ba(
        cam, mesh, prob, bf=bf, n_iters=n1, n_iters_final=n_iters - n1,
        cg_iters=32,
    )
    return Rf, tf, pf, cost


def shard_obs_by_point(obs: factors.ReprojObs, n_devices: int):
    """Lay out the observation table so shard s owns every row of the
    points with ``point_idx % n_devices == s`` (padded per shard).

    The covisibility-block idea applied at landmark granularity: with all
    of a point's observations on one shard, the (M, 3) segment reductions
    inside the Schur matvec become shard-local — each PCG iteration of the
    distributed GBA then communicates only the (K, 6) pose vector over the
    mesh (see ``optim.gba._schur_matvec``).  Returns a (n*cap,)-row table
    whose leading axis splits evenly into per-owner blocks.
    """
    import numpy as np

    pi = np.asarray(obs.point_idx)
    O = len(pi)
    owner = pi % n_devices
    counts = np.bincount(owner, minlength=n_devices)
    cap = max(int(counts.max()), 1)
    cap = -(-cap // 8) * 8  # pad each block to a multiple of 8 rows
    order = np.argsort(owner, kind="stable")
    off = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(O) - off[owner[order]]
    dest = owner[order] * cap + rank          # scatter target per sorted row

    def place(x):
        if x is None:
            return None
        x = np.asarray(x)
        out = np.zeros((n_devices * cap,) + x.shape[1:], x.dtype)
        out[dest] = x[order]
        return jnp.asarray(out)

    valid = np.zeros(n_devices * cap, bool)
    valid[dest] = np.asarray(obs.valid)[order]
    return factors.ReprojObs(
        pose_idx=place(obs.pose_idx),
        point_idx=place(obs.point_idx),
        uv=place(obs.uv),
        uv_r=place(obs.uv_r),
        inv_sigma2=place(obs.inv_sigma2),
        is_stereo=place(obs.is_stereo),
        valid=jnp.asarray(valid),
        uv2=place(obs.uv2),
        is_right=place(obs.is_right),
    )


def shard_obs_by_point_block(obs: factors.ReprojObs, n_devices: int,
                             block: int):
    """Lay out the observation table so shard s owns every row of the
    points in the contiguous block [s*block, (s+1)*block).

    The block layout lets each shard keep ONLY its own (block,)-sized
    landmark state (Hll/Cinv/dl) — see ``optim.gba._gba_lm_step_ptblock``.
    Returns a (n*cap,)-row table splitting evenly into per-owner chunks.
    """
    import numpy as np

    pi = np.asarray(obs.point_idx)
    O = len(pi)
    owner = np.clip(pi // block, 0, n_devices - 1)
    counts = np.bincount(owner, minlength=n_devices)
    cap = max(int(counts.max()), 1)
    cap = -(-cap // 8) * 8
    order = np.argsort(owner, kind="stable")
    off = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(O) - off[owner[order]]
    dest = owner[order] * cap + rank

    def place(x, fill=0):
        if x is None:
            return None
        x = np.asarray(x)
        out = np.full((n_devices * cap,) + x.shape[1:], fill, x.dtype)
        out[dest] = x[order]
        return jnp.asarray(out)

    valid = np.zeros(n_devices * cap, bool)
    valid[dest] = np.asarray(obs.valid)[order]
    # pad rows must carry an OWNED point id so the local index stays in
    # range: row r of owner s gets point id s*block (weights are zero)
    pid = np.repeat(np.arange(n_devices) * block, cap)
    pid[dest] = pi[order]
    return factors.ReprojObs(
        pose_idx=place(obs.pose_idx),
        point_idx=jnp.asarray(pid.astype(np.int32)),
        uv=place(obs.uv),
        uv_r=place(obs.uv_r),
        inv_sigma2=place(obs.inv_sigma2),
        is_stereo=place(obs.is_stereo),
        valid=jnp.asarray(valid),
        uv2=place(obs.uv2),
        is_right=place(obs.is_right),
    )
