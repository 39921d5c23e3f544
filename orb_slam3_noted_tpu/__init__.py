"""Visual-inertial SLAM engine in JAX.

A brand-new JAX/XLA implementation of the capabilities of ORB-SLAM3
(visual / visual-inertial / multi-map SLAM for monocular, stereo and RGB-D
cameras with pin-hole and Kannala-Brandt fisheye models), designed for an
accelerator from the start:

- Feature frontend (pyramid, FAST, rBRIEF, matching) as batched XLA
  kernels with static shapes (reference: ``src/ORBextractor.cc``,
  ``src/ORBmatcher.cc``).
- One batched Levenberg-Marquardt engine with Schur-complement landmark
  marginalization replacing the 25 g2o entry points of the reference
  (``src/Optimizer.cc``).
- IMU preintegration as a ``lax.scan`` (``src/ImuTypes.cc``).
- Place recognition as dense binary-descriptor scoring by matmul
  (reference: ``Thirdparty/DBoW2``).
- Map state as fixed-capacity device-resident SoA arrays instead of a
  mutex-protected pointer graph.

Subpackages
-----------
geometry   SO3/SE3/Sim3 Lie groups, triangulation, Horn alignment
models     camera models (Pinhole, KannalaBrandt8)
ops        feature-frontend kernels (pyramid, FAST, BRIEF, matching)
imu        preintegration and IMU types
optim      the LM/Schur optimization engine and factor definitions
place      bag-of-binary-words place recognition by matmul
pipeline   frame/tracking/local-mapping/loop-closing stages and System facade
parallel   device-mesh sharding for distributed BA / pose graph
io         dataset loaders, YAML config compatibility, trajectory savers
utils      timing, evaluation (ATE), misc
"""

import jax as _jax

# SLAM geometry (pose chains, normal equations, preintegration) needs full
# f32 matmuls: the GPU's default for f32 inputs is TF32, which keeps about
# 10 mantissa bits (~3 decimal digits) — too coarse for squared normal
# equations and for Hessians summed over thousands of observations.
# "highest" keeps f32 everywhere; throughput-critical kernels (Hamming
# bit-matmul) opt in to fast paths explicitly with narrow inputs or
# per-call precision.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
