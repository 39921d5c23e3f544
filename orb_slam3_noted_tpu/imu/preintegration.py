"""On-manifold IMU preintegration (Forster et al. 2016) as a ``lax.scan``.

Batched equivalent of the reference's `src/ImuTypes.cc` (``Preintegrated``,
``IntegrateNewMeasurement`` `:266-327`): same state {dT, dR, dV, dP}, same
bias Jacobians {JRg, JVg, JVa, JPg, JPa}, same 15x15 covariance propagation
with the A/B matrices of Forster's appendix (A.7-A.9), and the same
first-order bias-correction getters (`GetDeltaRotation/Velocity/Position`).

Design departures from the reference (intentional, device-first):

- A whole measurement batch integrates in one ``lax.scan`` instead of a
  per-sample virtual call; measurements are padded with dt=0 entries, which
  are exact no-ops of the recursion — so shapes stay static.
- "Reintegrate with new bias" = re-run the scan on the stored measurement
  array (the reference stores ``mvMeasurements`` for the same purpose).
- State is an immutable NamedTuple pytree (vmap-able over many keyframes at
  once — used by the inertial optimizer).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_noted_tpu.geometry import so3

GRAVITY = 9.81  # reference: include/ImuTypes.h:40 (GRAVITY_VALUE)


class Bias(NamedTuple):
    """Gyro + accelerometer bias (reference ``IMU::Bias``)."""

    bg: jnp.ndarray  # (3,) gyro bias
    ba: jnp.ndarray  # (3,) accel bias

    @staticmethod
    def zero(dtype=jnp.float32) -> "Bias":
        return Bias(jnp.zeros(3, dtype), jnp.zeros(3, dtype))


class Calib(NamedTuple):
    """IMU calibration (reference ``IMU::Calib``).

    Rbc/tbc: camera-to-body transform. cov_ng/cov_na: discrete-time noise
    variances (continuous densities x frequency, as the reference's YAML
    parser prepares them — `src/Tracking.cc:1106` ``ParseIMUParamFile``).
    cov_walk_g/cov_walk_a: discrete random-walk variances.
    """

    Rbc: jnp.ndarray
    tbc: jnp.ndarray
    cov_ng: jnp.ndarray      # scalar or (3,)
    cov_na: jnp.ndarray
    cov_walk_g: jnp.ndarray
    cov_walk_a: jnp.ndarray


class Preintegrated(NamedTuple):
    """Preintegration state between two frames/keyframes."""

    dT: jnp.ndarray   # () total time
    dR: jnp.ndarray   # (3, 3)
    dV: jnp.ndarray   # (3,)
    dP: jnp.ndarray   # (3,)
    JRg: jnp.ndarray  # (3, 3) d(dR)/d(bg)
    JVg: jnp.ndarray  # (3, 3)
    JVa: jnp.ndarray  # (3, 3)
    JPg: jnp.ndarray  # (3, 3)
    JPa: jnp.ndarray  # (3, 3)
    C: jnp.ndarray    # (15, 15) covariance [dR dV dP bg ba]
    bias: Bias        # bias used during integration


def init_preintegrated(bias: Bias, dtype=jnp.float32) -> Preintegrated:
    z33 = jnp.zeros((3, 3), dtype)
    return Preintegrated(
        dT=jnp.zeros((), dtype),
        dR=jnp.eye(3, dtype=dtype),
        dV=jnp.zeros(3, dtype),
        dP=jnp.zeros(3, dtype),
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        C=jnp.zeros((15, 15), dtype),
        bias=bias,
    )


def _step(
    state: Preintegrated, meas, cov_ng, cov_na, cov_wg, cov_wa
) -> Preintegrated:
    """One IntegrateNewMeasurement step. meas = (acc (3,), gyr (3,), dt ())."""
    acc_raw, gyr_raw, dt = meas
    dtype = state.dR.dtype
    acc = acc_raw - state.bias.ba
    gyr = gyr_raw - state.bias.bg

    dR, dV, dP = state.dR, state.dV, state.dP
    Wacc = so3.hat(acc)

    # Position/velocity first (use pre-update dR), as in the reference.
    dP_new = dP + dV * dt + 0.5 * (dR @ acc) * dt * dt
    dV_new = dV + (dR @ acc) * dt

    # Bias Jacobians (iterative form).
    JPa_new = state.JPa + state.JVa * dt - 0.5 * dR * dt * dt
    JPg_new = state.JPg + state.JVg * dt - 0.5 * dt * dt * (dR @ Wacc @ state.JRg)
    JVa_new = state.JVa - dR * dt
    JVg_new = state.JVg - dt * (dR @ Wacc @ state.JRg)

    # Rotation increment over [k, k+1].
    phi = gyr * dt
    dRi = so3.exp(phi)
    rightJ = so3.right_jacobian(phi)
    dR_new = so3.normalize(dR @ dRi)
    JRg_new = dRi.T @ state.JRg - rightJ * dt

    # Covariance propagation: x = [dR(3) dV(3) dP(3)], A (9x9), B (9x6).
    eye3 = jnp.eye(3, dtype=dtype)
    z33 = jnp.zeros((3, 3), dtype)
    A = jnp.block(
        [
            [dRi.T, z33, z33],
            [-(dR * dt) @ Wacc, eye3, z33],
            [-0.5 * dt * dt * (dR @ Wacc), eye3 * dt, eye3],
        ]
    )
    B = jnp.block(
        [
            [rightJ * dt, z33],
            [z33, dR * dt],
            [z33, 0.5 * dR * dt * dt],
        ]
    )
    Nga = jnp.zeros((6, 6), dtype)
    Nga = Nga.at[jnp.arange(3), jnp.arange(3)].set(jnp.broadcast_to(cov_ng, (3,)))
    Nga = Nga.at[jnp.arange(3, 6), jnp.arange(3, 6)].set(jnp.broadcast_to(cov_na, (3,)))
    C9 = A @ state.C[:9, :9] @ A.T + B @ Nga @ B.T
    walk = jnp.concatenate(
        [jnp.broadcast_to(cov_wg, (3,)), jnp.broadcast_to(cov_wa, (3,))]
    )
    C = state.C.at[:9, :9].set(C9)
    C = C.at[jnp.arange(9, 15), jnp.arange(9, 15)].add(walk * jnp.where(dt > 0, 1.0, 0.0))

    # dt == 0 padding must be an exact no-op; every update above already is
    # (A -> I, B -> 0, increments -> 0) except the walk term handled above.
    return Preintegrated(
        dT=state.dT + dt,
        dR=dR_new, dV=dV_new, dP=dP_new,
        JRg=JRg_new, JVg=JVg_new, JVa=JVa_new, JPg=JPg_new, JPa=JPa_new,
        C=C,
        bias=state.bias,
    )


@jax.jit
def integrate_measurements(
    bias: Bias,
    acc: jnp.ndarray,
    gyr: jnp.ndarray,
    dts: jnp.ndarray,
    calib: Calib,
) -> Preintegrated:
    """Integrate a (padded) batch of measurements with ``lax.scan``.

    Jitted at module level: host callers re-integrate chain segments after
    every bias update (reference ``Reintegrate``), and an UNJITTED 1024-step
    scan re-traces on every call — measured at seconds per reintegration
    sweep on the remote-compile harness (round-4 VI profile).

    acc/gyr: (N, 3); dts: (N,) with 0 for padding entries (exact no-ops).
    Equivalent to calling the reference's ``IntegrateNewMeasurement`` N times,
    including the frame-boundary midpoint samples the Tracking thread
    prepares (`src/Tracking.cc:1380-1493` does the resampling; see
    :mod:`orb_slam3_noted_tpu.pipeline` for that host-side step).
    """
    init = init_preintegrated(bias, dtype=acc.dtype)

    def f(state, m):
        return (
            _step(state, m, calib.cov_ng, calib.cov_na, calib.cov_walk_g, calib.cov_walk_a),
            None,
        )

    state, _ = jax.lax.scan(f, init, (acc, gyr, dts))
    return state


# --- first-order bias-corrected getters (reference GetDelta*) -------------

def delta_rotation(p: Preintegrated, b: Bias) -> jnp.ndarray:
    dbg = b.bg - p.bias.bg
    return so3.normalize(p.dR @ so3.exp(p.JRg @ dbg))


def delta_velocity(p: Preintegrated, b: Bias) -> jnp.ndarray:
    dbg = b.bg - p.bias.bg
    dba = b.ba - p.bias.ba
    return p.dV + p.JVg @ dbg + p.JVa @ dba


def delta_position(p: Preintegrated, b: Bias) -> jnp.ndarray:
    dbg = b.bg - p.bias.bg
    dba = b.ba - p.bias.ba
    return p.dP + p.JPg @ dbg + p.JPa @ dba


def predict_state(
    Rwb1: jnp.ndarray,
    twb1: jnp.ndarray,
    v1: jnp.ndarray,
    p: Preintegrated,
    b: Bias,
):
    """Dead-reckon body state across the preintegrated interval.

    Equivalent of ``Tracking::PredictStateIMU`` (`src/Tracking.cc:1498`):
    R2 = R1 dR, v2 = v1 + g t + R1 dV, t2 = t1 + v1 t + 0.5 g t^2 + R1 dP.
    """
    g = jnp.asarray([0.0, 0.0, -GRAVITY], dtype=twb1.dtype)
    t = p.dT
    R2 = so3.normalize(Rwb1 @ delta_rotation(p, b))
    v2 = v1 + g * t + Rwb1 @ delta_velocity(p, b)
    t2 = twb1 + v1 * t + 0.5 * g * t * t + Rwb1 @ delta_position(p, b)
    return R2, t2, v2
