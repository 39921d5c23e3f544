"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests never require an accelerator; multi-device sharding tests use
``xla_force_host_platform_device_count=8`` as the SURVEY §4 plan prescribes.
Must run before jax is imported anywhere.
"""

import os

# jax.config.update below wins as long as no backend has been initialized
# yet, and XLA_FLAGS is read lazily at first backend use.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache under the program's own rule
# (``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``):
# repeat suite runs skip XLA compiles, and the in-process compile count stays
# low — the LLVM CPU JIT has crashed this process before after several
# hundred back-to-back compilations.
from orb_slam3_noted_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

# Golden math tests compare against float64; library code stays dtype-generic
# (f32 on the device) so enabling x64 here only affects test inputs.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled-executable references after each test module.

    Bounds the live LLVM JIT state; hundreds of accumulated executables in
    one process have segfaulted the XLA CPU backend mid-compile.
    """
    yield
    jax.clear_caches()
