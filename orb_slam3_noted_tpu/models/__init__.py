"""Camera models.

Batched equivalent of the reference's ``GeometricCamera`` hierarchy
(`/root/reference/include/CameraModels/GeometricCamera.h` with ``Pinhole`` and
``KannalaBrandt8`` implementations).  Instead of virtual dispatch, each model
is a set of pure batched functions over a flat parameter vector, and
:class:`Camera` tags which function family to use (resolved statically at
trace time — no data-dependent dispatch inside jit).
"""

from orb_slam3_noted_tpu.models.cameras import (  # noqa: F401
    Camera,
    PINHOLE,
    KANNALA_BRANDT8,
    project,
    unproject,
    project_jac,
)
