"""Bilateral depth filtering as a dense stencil.

Re-design of the reference's CPU ``BilateralFilter``
(ref: src/BilateralFilter.cpp:15-121): a (2r+1)^2 window of shifted
adds that XLA fuses — no LUTs needed.

Spatial weight exp(-(dx^2+dy^2)/sigma_space^2) and radius
ceil(1.5*sigma_space) follow the reference (ref: :17, :38-41). The
similarity weight is the standard Gaussian exp(-dv^2 / (2 sigma_c^2)),
NOT the reference's exp(-|dv|/sigma_c^2): that formula was written for
8-bit intensities (256-entry LUT, |dv| <= 255) and on mm-scale depth
its decay constant is sigma_c^2 = 400 mm (at the default sigma_c=20) —
no edge preservation at all. Measured consequence: with the reference formula a
depth silhouette smears ~±7 px into the background, producing
view-dependent fake surfaces that bias projective ICP — a clean 6.6 mm
lateral step was estimated as 1.3 mm (5x under), destroying the
500-frame tracked trajectory (ATE 44 mm). With the Gaussian weight the
same step tracks to 0.35 mm. The reference's other 8-bit artifacts
(kernel-index skew at clipped borders, byte-granular 16bpp writes,
SURVEY.md §2.8) are likewise not replicated.

Zero depth means "no data": such pixels contribute nothing and are left
zero, which the reference's raw intensity filtering does not handle —
the KinectFusion pre-smoother must not bleed values across holes.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("sigma_colour", "sigma_space"))
def bilateral_filter(
    depth: jnp.ndarray,
    sigma_colour: float = 20.0,
    sigma_space: float = 3.0,
) -> jnp.ndarray:
    """Filter a (H, W) depth image; returns the same dtype.

    Args:
      depth: (H, W) u16/f32 depth in mm; zero = no data.
    """
    orig_dtype = depth.dtype
    d = jnp.asarray(depth, jnp.float32)
    h, w = d.shape
    radius = math.ceil(sigma_space * 1.5)
    inv_sc2 = 1.0 / (sigma_colour * sigma_colour)
    inv_ss2 = 1.0 / (sigma_space * sigma_space)

    valid = d > 0
    num = jnp.zeros_like(d)
    den = jnp.zeros_like(d)
    padded = jnp.pad(d, radius)
    pvalid = jnp.pad(valid, radius)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            w_s = math.exp(-(dx * dx + dy * dy) * inv_ss2)
            tap = padded[
                radius + dy : radius + dy + h, radius + dx : radius + dx + w
            ]
            tval = pvalid[
                radius + dy : radius + dy + h, radius + dx : radius + dx + w
            ]
            dv = tap - d
            w_c = jnp.exp(-(dv * dv) * (0.5 * inv_sc2))
            wgt = jnp.where(tval, w_s * w_c, 0.0)
            num = num + tap * wgt
            den = den + wgt
    out = jnp.where(valid, num / jnp.maximum(den, 1e-12), 0.0)
    if jnp.issubdtype(orig_dtype, jnp.integer):
        out = jnp.round(out).astype(orig_dtype)
    else:
        out = out.astype(orig_dtype)
    return out
