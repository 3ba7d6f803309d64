"""Lambertian shading and normal-map visualization.

Port of the reference render utilities
(ref: src/Utilities/RenderUtilities.cpp:39-112) — trivially dense
element-wise math, pure XLA.
"""

from __future__ import annotations

import jax.numpy as jnp

from .raycast import compute_normals_from_vertices

compute_normals = compute_normals_from_vertices


def scene_image(vertices, normals, light_source) -> jnp.ndarray:
    """(H, W) u8 greyscale Lambertian render.

    shade = 0.2 + 0.8 * max(0, n . normalize(light - vertex)), u8 floor
    (ref: scene_as_png RenderUtilities.cpp:39-78). Missed rays (NaN
    vertices) render black.
    """
    vertices = jnp.asarray(vertices, jnp.float32)
    normals = jnp.asarray(normals, jnp.float32)
    light_source = jnp.asarray(light_source, jnp.float32)
    r = light_source - vertices
    r = r / jnp.linalg.norm(r, axis=-1, keepdims=True)
    shade = jnp.maximum(0.0, jnp.sum(normals * r, axis=-1))
    shade = 0.2 + 0.8 * shade
    valid = jnp.isfinite(vertices).all(axis=-1)
    shade = jnp.where(valid, shade, 0.0)
    return jnp.floor(shade * 255.0).astype(jnp.uint8)


def normals_image(normals) -> jnp.ndarray:
    """(H, W, 3) u8 RGB normal map: n/2 + 0.5, z folded positive.

    ref: normals_as_png RenderUtilities.cpp:80-112.
    """
    n = jnp.asarray(normals, jnp.float32)
    n = n.at[..., 2].set(jnp.abs(n[..., 2]))
    img = jnp.floor(((n / 2.0) + 0.5) * 255.0)
    return jnp.clip(img, 0, 255).astype(jnp.uint8)


def color_image(vol, vertices) -> jnp.ndarray:
    """(H, W, 3) u8 render of fused per-voxel colour at raycast hits.

    Completes the colour story the reference left unfinished: it
    allocates/serializes ``m_colours`` but no kernel ever writes or
    reads them (ref: src/include/TSDFVolume.hpp:23-26, SURVEY §2.1).
    This framework fuses colour in the integrate rgb path
    (ops/integrate.py) and renders it here by trilinear sampling of the
    three channels at the hit vertex. Missed rays render black.
    """
    from .trilinear import trilinear_sample

    if vol.color is None:
        raise ValueError("volume has no colour field (use with_color())")
    vertices = jnp.asarray(vertices, jnp.float32)
    valid = jnp.isfinite(vertices).all(axis=-1)
    pts = jnp.where(valid[..., None], vertices, 0.0) - vol.space_min
    chans = [
        trilinear_sample(
            vol.color[..., c].astype(jnp.float32), pts, vol.voxel_size
        )
        for c in range(3)
    ]
    rgb = jnp.stack(chans, axis=-1)
    rgb = jnp.where(valid[..., None], rgb, 0.0)
    return jnp.clip(jnp.round(rgb), 0.0, 255.0).astype(jnp.uint8)
