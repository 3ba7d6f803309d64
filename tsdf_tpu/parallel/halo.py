"""Halo exchange for brick-sharded volumes.

The reference's "long axis" mechanisms are serial loops and z-slab
streaming (SURVEY.md §5); on a device mesh the equivalent is brick
sharding with a 1-voxel halo so the trilinear 8-tap stencil
(ops/trilinear.py) and marching-cubes' z+1 corner reads stay local.
Exchange rides ``lax.ppermute`` over the "b" axis — neighbour traffic,
no all-gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.4.35
    from jax import shard_map  # type: ignore[attr-defined]
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def halo_exchange_z(x: jnp.ndarray, mesh: Mesh, halo: int = 1):
    """Exchange z-boundary slabs between neighbouring bricks.

    Args:
      x: (Z, Y, X) array sharded over "b" along z.
      halo: slab thickness to exchange each way.

    Returns:
      (Z + 2*halo*nb, Y, X) array sharded over "b": each brick's local
      block is [halo from prev | own slabs | halo from next]; the first/
      last bricks' outer halos replicate their edge slab (matching the
      clamp-to-border semantics of ops/trilinear.py).
    """
    nb = mesh.shape["b"]

    def local(xl):
        bi = jax.lax.axis_index("b")
        top = xl[:halo]  # lowest z slabs (to send to prev)
        bot = xl[-halo:]  # highest z slabs (to send to next)
        # receive from next brick: its lowest slabs
        from_next = jax.lax.ppermute(
            top, "b", [(i, (i - 1) % nb) for i in range(nb)]
        )
        # receive from prev brick: its highest slabs
        from_prev = jax.lax.ppermute(
            bot, "b", [(i, (i + 1) % nb) for i in range(nb)]
        )
        # clamp at the global edges: replicate own edge slab
        from_prev = jnp.where(bi == 0, xl[:halo], from_prev)
        from_next = jnp.where(bi == nb - 1, xl[-halo:], from_next)
        return jnp.concatenate([from_prev, xl, from_next], axis=0)

    return shard_map(
        local, mesh=mesh, in_specs=P("b"), out_specs=P("b")
    )(x)
