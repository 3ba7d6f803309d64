"""The compile-cache helper: the environment decides when it says
anything, otherwise the cache sits at <checkout>/.jax_cache."""

import os

from tsdf_tpu.utils.compile_cache import CHECKOUT, compile_cache_dir


def test_environment_variable_is_honoured():
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) is None


def test_default_is_checkout_jax_cache():
    path = compile_cache_dir({})
    assert path == os.path.join(CHECKOUT, ".jax_cache")
    assert os.path.exists(os.path.join(CHECKOUT, "tsdf_tpu", "__init__.py"))
