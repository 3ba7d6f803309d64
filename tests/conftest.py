"""Test config: run on a virtual 8-device CPU mesh.

Sharding logic is tested without accelerators, the moral equivalent of
the reference's MockKinect replay rig applied to the device mesh
(SURVEY.md §4).

The environment may import jax at interpreter start before this file
runs, so setting JAX_PLATFORMS in os.environ is not enough — use
jax.config, which takes effect as long as no backend has been
initialized yet.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

# Persistent cache for the expensive test compiles, keyed by a
# fingerprint of this host's CPU features: XLA:CPU cache entries don't
# key on machine features, so a foreign host's entries could SIGILL.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import hashlib
    import platform

    _fp = platform.machine()
    try:
        with open("/proc/cpuinfo") as _f:
            for _line in _f:
                if _line.startswith(("flags", "Features")):
                    _fp += _line
                    break
    except OSError:
        pass
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".jax_cache_cpu_" + hashlib.md5(_fp.encode()).hexdigest()[:8],
        ),
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
