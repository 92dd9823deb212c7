"""Test configuration: run everything on CPU with 8 virtual devices.

Multi-device sharding logic (halo exchange, mesh layouts) is tested
without accelerators by forcing the host platform and asking XLA for 8
virtual CPU devices.  Must run before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.2")

# Persistent compilation cache by the package's one rule; exported so
# that the example scripts the tests start share it.
from custereomatching_tpu.utils.cache import enable_compile_cache  # noqa: E402

os.environ["JAX_COMPILATION_CACHE_DIR"] = enable_compile_cache()
