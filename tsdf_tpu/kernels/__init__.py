"""Hand-written GPU kernels for the hot ops that XLA cannot express well.

Each kernel names its Pallas route (``backend="triton"``) and keeps a
plain-JAX semantics reference in ``ops/``, against which it is tested in
interpret mode.
"""

from .raymarch import march_image_tiled, march_rays_tiled

__all__ = ["march_image_tiled", "march_rays_tiled"]
