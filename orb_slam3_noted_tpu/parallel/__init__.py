"""Multi-device sharding: distributed bundle adjustment over a mesh.

Replaces the reference's single-process shared-memory design (SURVEY §2.3 —
no distributed backend exists there) with a device-mesh scale-out path:
observations and landmark blocks shard across a ``jax.sharding.Mesh``; the
reduced-camera-system assembly is a ``psum`` over the mesh (device
collectives), and the small pose system is solved replicated.
"""

from orb_slam3_noted_tpu.parallel.dist_ba import (  # noqa: F401
    make_mesh,
    pad_obs_for_mesh,
    distributed_bundle_adjust,
)
from orb_slam3_noted_tpu.optim.gba import (  # noqa: F401
    distributed_global_ba,
)
