"""Marching-cubes surface extraction as a fused JAX computation.

Re-design of the reference's mark-and-sweep marching cubes
(ref: src/MarchingCubes/MarkAndSweepMC.cu:133-551). The reference runs a
classify kernel, copies counts to the HOST for a sequential prefix-sum,
then launches a scatter kernel (SURVEY.md §2.3). Here the three phases
are one jit graph with static shapes:

  1. classify every cube from 8 shifted sign slices (no gather);
  2. compact occupied cubes on-device;
  3. sweep the occupied cubes: look up the triangulation
     (ops/mc_tables.py), interpolate edge zero-crossings, and emit
     vertices.

Two strategies share the same math (``scatter_free`` flag):

  - default: cumsum-rank compaction with ``.at[].set`` scatters and
    plain gathers.
  - scatter-free: no XLA scatter, and element gathers only from small
    tables. Compaction is hierarchical ("chunked"): an exact separable min/max pooling over (bz+1, by+1,
    bx+1) voxel windows finds the chunks whose region contains both
    signs (transpose-free block reduces — no full-volume classify at
    all), a tiny sort compacts their ids, the padded volume is
    chunkified ONCE and each active chunk row-gathers itself + its 7
    upper neighbors into a haloed block, cube types / corner values /
    occupancy are computed from those blocks in compacted space, and a
    cumsum-rank + sorted matmul-scatter (ops/scatter.py) compacts the
    occupied cubes with their corner values as payload — so phase 3
    needs no element gather at all. Grids beyond 512^3-class fall back
    to a full-volume ``lax.sort`` compaction + element corner gather,
    as does a chunk overflow (reported via ``overflowed``). The dense
    vertex compaction is the sorted-window matmul scatter
    (ops/scatter.py).

Outputs are fixed-size padded buffers + counts (jit-friendly); triangle
soup semantics match the reference (every 3 consecutive valid vertices =
one triangle, vertices ordered so normals point toward positive TSDF).
Per-vertex bracketing-voxel indices are emitted for SceneFusion's
deformation-field update (ref: generate_vertices
MarkAndSweepMC.cu:290-301).

``layout="masked"`` skips the dense vertex compaction entirely: vertices
stay in their (cube, slot) positions with an explicit validity mask.
That is the per-frame SceneFusion form — every consumer there is a
masked reduction, so compaction would be pure wasted scatter bandwidth.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..volume import TSDFVolume
from .mc_tables import (
    CORNER_OFFSETS,
    EDGE_CORNERS,
    MAX_TRIS,
    TRI_TABLE,
    VERT_COUNTS,
)
from .scatter import gather_flat, scatter_add_flat

_MAX_V = MAX_TRIS * 3
_INT_MAX = np.int32(0x7FFFFFFF)

# The chunked occupancy test is a compare, not a table lookup: a cube emits
# vertices iff its type is neither empty nor full. True for any valid MC
# triangulation table; asserted once against the derived tables.
assert bool(
    np.all(
        (np.asarray(VERT_COUNTS) > 0)
        == ((np.arange(256) != 0) & (np.arange(256) != 255))
    )
), "MC tables violate the type!=0,255 <=> occupied invariant"


class TriangleSoup(NamedTuple):
    """Fixed-size triangle soup; every 3 consecutive valid vertices form
    one triangle. ``valid`` marks live slots: in the dense layout it is
    simply ``arange < n_vertices``; in the masked layout (SceneFusion)
    live vertices stay at their (cube, slot) positions."""

    vertices: jnp.ndarray  # (max_vertices, 3) f32 world mm; garbage past n
    vertex_voxels: jnp.ndarray  # (max_vertices, 2) i32 flat voxel indices
    n_vertices: jnp.ndarray  # () i32 — number of valid vertices
    overflowed: jnp.ndarray  # () bool — buffers were too small
    valid: jnp.ndarray  # (max_vertices,) bool


def extract_surface(
    vol: TSDFVolume,
    max_cubes: int = 1 << 18,
    max_vertices: int = 1 << 20,
    on_cpu: bool | None = None,
    layout: str = "dense",
    use_chunked: bool = True,
    scatter_free: bool = False,
) -> TriangleSoup:
    """Extract the zero isosurface as a triangle soup.

    Args:
      vol: the volume; tsdf < 0 is inside (ref: calculate_cube_type
        MarkAndSweepMC.cu:110-124).
      max_cubes: static capacity for occupied cubes.
      max_vertices: static capacity for emitted vertices (dense layout;
        the masked layout's capacity is ``max_cubes * 15``).
      on_cpu: run the extraction on the host CPU backend. Default False
        (extraction stays on the device). Set True to run on host (e.g.
        one-shot mesh export where the volume already needs a D2H copy
        for the PLY writer anyway).
      layout: "dense" — vertices compacted to [0, n_vertices); "masked"
        — vertices at (cube, slot) positions with ``valid`` mask
        (SceneFusion's per-frame form; skips the compaction scatter).
      use_chunked: allow the chunked compaction (scatter-free path).
        Pass False to force the full-volume sort compaction — the exact
        fallback when a chunk overflow was reported.
      scatter_free: compact with sorts and one-hot matmul scatters
        instead of XLA scatters (see the module docstring).

    Returns:
      TriangleSoup. If ``overflowed`` is set, re-run with
      use_chunked=False (chunk-cap overflow) and/or larger caps.
    """
    if on_cpu is None:
        on_cpu = False
    if on_cpu and jax.default_backend() != "cpu":
        cpu = jax.devices("cpu")[0]
        tsdf = jax.device_put(jax.device_get(vol.tsdf), cpu)
        voxel_size = jax.device_put(jax.device_get(vol.voxel_size), cpu)
        offset = jax.device_put(jax.device_get(vol.offset), cpu)
        with jax.default_device(cpu):
            return _extract_jit(
                tsdf, voxel_size, offset, max_cubes, max_vertices,
                layout, False, True,
            )
    return _extract_jit(
        vol.tsdf, vol.voxel_size, vol.offset, max_cubes, max_vertices,
        layout, scatter_free, use_chunked,
    )


@partial(
    jax.jit,
    static_argnames=(
        "max_cubes", "max_vertices", "layout", "scatter_free",
        "use_chunked",
    ),
)
def _extract_jit(
    tsdf, voxel_size, offset, max_cubes, max_vertices, layout,
    scatter_free, use_chunked,
):
    return _extract_arrays(
        tsdf, voxel_size, offset,
        max_cubes=max_cubes, max_vertices=max_vertices,
        layout=layout, scatter_free=scatter_free, use_chunked=use_chunked,
    )


def _table_lookup(
    table: np.ndarray | jnp.ndarray, idx: jnp.ndarray
) -> jnp.ndarray:
    """out[...] = table[idx[...]] for a small shared 1-D table."""
    table = jnp.asarray(table)
    return jnp.take(table, jnp.clip(idx, 0, table.shape[0] - 1), axis=0)


def _slot_gather(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """out[r, c] = table[r, idx[r, c]] for a narrow per-row table (edge
    -> vertex resolution, W=12), zero where idx is out of range."""
    in_range = (idx >= 0) & (idx < table.shape[1])
    g = jnp.take_along_axis(
        table, jnp.clip(idx, 0, table.shape[1] - 1), axis=1
    )
    return jnp.where(in_range, g, jnp.zeros_like(g))


# Chunked-compaction tuning. Chunk shape (z, y, x) in cubes: 3-D blocks
# so chunk count tracks surface *area*; x-extent 16 keeps some lane
# locality in the transpose while z×y cross-sections stay compact.
_CHUNK = (4, 8, 16)
_MAX_CHUNKS = 2048
# The chunked path materialises one chunkified copy of the (padded)
# volume (~1.25x volume bytes transient); gate it off beyond 512^3-class
# grids, which fall back to the full-volume sort compaction.
_CHUNK_GATE_CUBES = 140 * 1024 * 1024


def _chunk_front(
    d: jnp.ndarray,
    n_cube_z,
    max_chunks: int | None = None,
):
    """Shared front half of the chunked compactions: chunk occupancy
    pooling, active-chunk id sort, one chunkify of the padded volume,
    haloed-block assembly and in-chunk classification.

    Returns a dict with (J = max_chunks, B = prod(_CHUNK)):
      t_r: (J, B) i32 cube types;
      w_r: list of 8 (J, B) f32 corner TSDF values;
      occ: (J, B) bool — occupied AND unmasked AND chunk-valid;
      gz_s/gy_s/gx_s: (J, B) i32 global cube coords per slot;
      chz/chy/chx: (J,) i32 active chunk coords; ids_valid: (J,) bool;
      chunk_overflow: () bool; max_chunks: J; grid dims.
    """
    Z, Y, X = d.shape
    cz, cy, cx = Z - 1, Y - 1, X - 1
    bz, by, bx = _CHUNK
    nbz, nby, nbx = (-(-n // b) for n, b in zip((cz, cy, cx), _CHUNK))
    B = bz * by * bx
    n_chunks = nbz * nby * nbx
    if max_chunks is None:
        # compacted-space work is linear in the cap, so keep it tight:
        # surfaces occupy a few % of chunks (a 255³ sphere: 1754 of
        # 32768). The floor of max(2048, n_chunks/16) is only ~1.2x that
        # sphere — room-scale scenes CAN overflow; overflow is reported
        # via ``overflowed`` and callers fall back to the full-volume
        # sort compaction (use_chunked=False), so no cube is ever
        # silently dropped.
        max_chunks = min(n_chunks, max(_MAX_CHUNKS, n_chunks // 16))

    # Pad the voxel grid by one extra chunk layer with edge replication:
    # replicated voxels introduce no new sign changes, and every chunk's
    # {0,1}^3 neighborhood exists for the halo assembly. Padded cubes
    # (base beyond cz/cy/cx) are masked out of occupancy below.
    pz, py, px = (nbz + 1) * bz, (nby + 1) * by, (nbx + 1) * bx
    dp = jnp.pad(
        d, ((0, pz - Z), (0, py - Y), (0, px - X)), mode="edge"
    )

    # --- chunk occupancy: exact (b+1)-window min/max, separable --------
    def pool_axis(a, b, nb, axis, op):
        # window b+1, stride b along `axis`: op(block-reduce, the plane
        # at (i+1)*b) — exact because min/max are separable
        sl = [slice(None)] * 3
        sl[axis] = slice(0, nb * b)
        blk = a[tuple(sl)]
        shape = list(blk.shape)
        shape[axis : axis + 1] = [nb, b]
        blk = op(blk.reshape(shape), axis=axis + 1)
        sl[axis] = slice(b, nb * b + 1, b)
        return op(jnp.stack([blk, a[tuple(sl)]], 0), axis=0)

    cmin, cmax = dp, dp
    for axis, (b, nb) in enumerate(((bz, nbz), (by, nby), (bx, nbx))):
        cmin = pool_axis(cmin, b, nb, axis, jnp.min)
        cmax = pool_axis(cmax, b, nb, axis, jnp.max)
    active = (cmin < 0.0) & (cmax >= 0.0)  # (nbz, nby, nbx)
    if n_cube_z is not None:
        czrow = jax.lax.broadcasted_iota(jnp.int32, active.shape, 0)
        active = active & (czrow * bz < n_cube_z)

    n_active = jnp.sum(active.astype(jnp.int32))
    chunk_overflow = n_active > max_chunks

    key = jnp.where(
        active.ravel(), jnp.arange(n_chunks, dtype=jnp.int32), _INT_MAX
    )
    ids = jax.lax.sort(key)[:max_chunks]
    ids_valid = ids < _INT_MAX
    ids = jnp.where(ids_valid, ids, 0)

    # --- chunkify the padded volume ONCE; gather haloed blocks ---------
    npz, npy, npx = nbz + 1, nby + 1, nbx + 1
    r = (
        dp.reshape(npz, bz, npy, by, npx, bx)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(npz * npy * npx, B)
    )

    chz = ids // (nby * nbx)
    rem = ids - chz * (nby * nbx)
    chy = rem // nbx
    chx = rem - chy * nbx

    blocks = []
    for dz_ in (0, 1):
        for dy_ in (0, 1):
            for dx_ in (0, 1):
                nid = ((chz + dz_) * npy + (chy + dy_)) * npx + (chx + dx_)
                blocks.append(
                    jnp.take(r, nid, axis=0).reshape(-1, bz, by, bx)
                )
    # assemble (max_chunks, 2bz, 2by, 2bx), keep the +1 halo
    big = jnp.concatenate(
        [
            jnp.concatenate(
                [
                    jnp.concatenate(blocks[4 * i : 4 * i + 2], axis=3),
                    jnp.concatenate(blocks[4 * i + 2 : 4 * i + 4], axis=3),
                ],
                axis=2,
            )
            for i in (0, 1)
        ],
        axis=1,
    )[:, : bz + 1, : by + 1, : bx + 1]

    # --- classify in compacted space ------------------------------------
    inside_blk = big < 0.0
    t_blk = jnp.zeros(inside_blk.shape[:1] + (bz, by, bx), jnp.int32)
    w_r = []
    for k in range(8):
        dx_, dy_, dz_ = (int(v) for v in CORNER_OFFSETS[k])
        sub = (
            slice(None),
            slice(dz_, dz_ + bz),
            slice(dy_, dy_ + by),
            slice(dx_, dx_ + bx),
        )
        t_blk = t_blk | (inside_blk[sub].astype(jnp.int32) << k)
        w_r.append(big[sub].reshape(-1, B))
    t_r = t_blk.reshape(-1, B)

    # slot coords within the chunk; mask padded cubes + n_cube_z exactly
    s = jnp.arange(B, dtype=jnp.int32)
    sz_ = s // (by * bx)
    sr_ = s - sz_ * (by * bx)
    sy_ = sr_ // bx
    sx_ = sr_ - sy_ * bx
    gz_s = chz[:, None] * bz + sz_[None, :]
    gy_s = chy[:, None] * by + sy_[None, :]
    gx_s = chx[:, None] * bx + sx_[None, :]
    occ = (
        (t_r != 0)
        & (t_r != 255)
        & ids_valid[:, None]
        & (gz_s < cz)
        & (gy_s < cy)
        & (gx_s < cx)
    )
    if n_cube_z is not None:
        occ = occ & (gz_s < n_cube_z)
    return dict(
        t_r=t_r, w_r=w_r, occ=occ,
        gz_s=gz_s, gy_s=gy_s, gx_s=gx_s,
        chz=chz, chy=chy, chx=chx, ids=ids, ids_valid=ids_valid,
        chunk_overflow=chunk_overflow, max_chunks=max_chunks,
        dims=(cz, cy, cx, nbz, nby, nbx),
    )


def _chunked_compact(
    d: jnp.ndarray,
    n_cube_z,
    max_cubes: int,
    max_chunks: int | None = None,
):
    """Hierarchical occupied-cube compaction (scatter-free path).

    Everything per-cube happens in COMPACTED chunk space: chunk
    occupancy comes from an exact separable (bz+1, by+1, bx+1)-window
    min/max pooling of the raw TSDF (transpose-free block reduces + one
    strided-slice min per axis — a chunk is active iff its cube-corner
    voxel region contains both signs, a tight superset of "contains an
    occupied cube"), the padded volume is chunkified ONCE, each active
    chunk row-gathers itself + its 7 upper neighbors to assemble a
    haloed (bz+1, by+1, bx+1) block, and cube types / corner values /
    occupancy are computed from those blocks over max_chunks*B slots
    instead of the full cube grid (~16x less classify work at 255³).

    Returns (cid, types, ws, cube_valid, chunk_overflow, n_occ):
      cid: (max_cubes,) i32 global cube ids, ascending;
      types: (max_cubes,) i32 cube types (0 on dead slots);
      ws: (max_cubes, 8) f32 corner TSDF values — NO per-element gather;
      cube_valid: (max_cubes,) bool;
      chunk_overflow: () bool — more active chunks than ``max_chunks``
        (some occupied cubes were not captured);
      n_occ: () i32 — total occupied cubes (exact unless overflowed).
    """
    fr = _chunk_front(d, n_cube_z, max_chunks)
    t_r, w_r, occ = fr["t_r"], fr["w_r"], fr["occ"]
    gz_s, gy_s, gx_s = fr["gz_s"], fr["gy_s"], fr["gx_s"]
    chunk_overflow = fr["chunk_overflow"]
    cz, cy, cx = fr["dims"][:3]
    occ_f = occ.ravel()
    rank = jnp.cumsum(occ_f.astype(jnp.int32)) - 1
    dest = jnp.where(occ_f, rank, -1)
    dest = jnp.maximum(jax.lax.cummax(dest), 0)
    dest = jnp.where(dest >= max_cubes, max_cubes, dest)

    # global cube id per gathered slot — arithmetic only
    gid = (gz_s * cy + gy_s) * cx + gx_s

    payload = [
        (gid.ravel() & 0xFFF).astype(jnp.float32),
        (gid.ravel() >> 12).astype(jnp.float32),
        t_r.ravel().astype(jnp.float32),
    ] + [w.ravel() for w in w_r]
    payload = jnp.stack([jnp.where(occ_f, p, 0.0) for p in payload])
    # dense ascending ranks: a 2048-contribution window spans <= 17
    # output rows, so a 32-row patch suffices — 8x fewer matmul FLOPs
    # than the default 256-row patch
    out = scatter_add_flat(
        max_cubes, dest, payload, is_sorted=True, rows_per_patch=32
    )

    cid = jnp.round(out[0]).astype(jnp.int32) + (
        jnp.round(out[1]).astype(jnp.int32) << 12
    )
    types = jnp.round(out[2]).astype(jnp.int32)
    captured = jnp.sum(occ_f.astype(jnp.int32))
    cube_valid = jnp.arange(max_cubes) < jnp.minimum(captured, max_cubes)

    # Restore global-id emission order (the scatter leaves chunk-major
    # order): one small sort over the max_cubes compacted slots keeps
    # the framework-wide invariant "soup emission order == cube id
    # order" that the sort-compaction and CPU paths provide.
    key = jnp.where(cube_valid, cid, _INT_MAX)
    skey, stypes, *sws = jax.lax.sort(
        [key, types] + [out[3 + k] for k in range(8)], num_keys=1
    )
    cid = jnp.where(cube_valid, skey, 0)
    ws = jnp.stack(sws, axis=-1)  # (max_cubes, 8)
    return cid, stypes, ws, cube_valid, chunk_overflow, captured


def _chunked_compact_cm(
    d: jnp.ndarray,
    n_cube_z,
    max_cubes: int,
    max_chunks: int | None = None,
):
    """CHUNK-MAJOR occupied-cube compaction (the scatter-free SceneFusion
    path).

    ``_chunked_compact`` walks a max_chunks x B ≈ 1M-slot contribution
    stream through the serial matmul-scatter window loop (window
    geometry, not cube count, sets its cost) and then re-sorts the compacted list into global-id order for the
    corner scatter's monotone-target contract. Both disappear here:

      1. per-chunk live-slot prefixes come from ONE batched B-wide key
         sort (``lax.sort`` over the last axis of (J, B) — independent
         small sorts, no global sort);
      2. the dense rank -> (chunk, offset) map is a compare-reduce
         against the J chunk-start offsets (no walk);
      3. per-cube data is pulled with PRE-SORTED ``gather_flat`` calls
         (``is_sorted="trusted"`` — the index streams ascend by
         construction, so both of gather_flat's internal sorts are
         skipped).

    The intermediate stream is CHUNK-MAJOR (grouped by ascending
    active-chunk id, cubes ascending within each chunk), so every
    gather above runs pre-sorted; global-id order is restored at the
    END by two ≤6-operand sorts sharing the cid key (narrow sorts
    compile fast; dead-slot ties carry don't-care payloads). Unlike the
    window walk, cost is bound by the COMPACTED stream (max_cubes),
    not the chunk-slot space; and there is no per-chunk cube cap (a
    wall saturates a chunk cross-section, which would overflow any
    fixed per-chunk allocation).

    Returns (cid, types, ws, cube_valid, chunk_overflow, n_occ) —
    exactly _chunked_compact's contract (ascending cid).
    """
    fr = _chunk_front(d, n_cube_z, max_chunks)
    t_r, w_r, occ = fr["t_r"], fr["w_r"], fr["occ"]
    cz, cy, cx = fr["dims"][:3]
    bz, by, bx = _CHUNK
    J, B = occ.shape

    # --- per-chunk live-slot prefix: batched key-only sort -------------
    s_iota = jax.lax.broadcasted_iota(jnp.int32, (J, B), 1)
    skey = jnp.where(occ, s_iota, B)
    sorted_s = jax.lax.sort(skey, dimension=1)  # (J, B): live prefix

    counts = jnp.sum(occ.astype(jnp.int32), axis=1)  # (J,)
    start = jnp.cumsum(counts) - counts
    n_occ = jnp.sum(counts)
    cube_valid = jnp.arange(max_cubes, dtype=jnp.int32) < jnp.minimum(
        n_occ, max_cubes
    )

    # --- dense rank -> (chunk b, in-chunk rank o): compare-reduce ------
    r = jnp.arange(max_cubes, dtype=jnp.int32)
    b = (
        jnp.sum(
            (start[None, :] <= r[:, None]).astype(jnp.int32), axis=1
        )
        - 1
    )
    b = jnp.clip(b, 0, J - 1)  # non-decreasing in r
    start_b = jnp.round(
        gather_flat(
            start.astype(jnp.float32), b, is_sorted="trusted",
            fill_mode="zero",
        )
    ).astype(jnp.int32)
    o = r - start_b  # in [0, counts[b]) for live ranks

    # --- q = global chunk-slot id; all index streams ascend ------------
    sval = jnp.round(
        gather_flat(
            sorted_s.reshape(-1).astype(jnp.float32),
            b * B + o,
            is_sorted="trusted",
            fill_mode="zero",
        )
    ).astype(jnp.int32)
    q = jnp.where(cube_valid, b * B + sval, J * B)  # suffix sentinels

    # --- per-cube data: ONE 9-channel pre-sorted gather ----------------
    table = jnp.stack(
        [t_r.astype(jnp.float32)] + list(w_r), axis=-1
    ).reshape(J * B, 9)
    dat = gather_flat(table, q, is_sorted="trusted", fill_mode="zero")
    types = jnp.round(dat[:, 0]).astype(jnp.int32)

    # --- global cube ids from chunk coords + in-chunk slot -------------
    ch_tab = jnp.stack(
        [
            fr["chz"].astype(jnp.float32),
            fr["chy"].astype(jnp.float32),
            fr["chx"].astype(jnp.float32),
        ],
        axis=-1,
    )  # (J, 3)
    chb = jnp.round(
        gather_flat(ch_tab, b, is_sorted="trusted", fill_mode="zero")
    ).astype(jnp.int32)
    sz_ = sval // (by * bx)
    srem = sval - sz_ * (by * bx)
    sy_ = srem // bx
    sx_ = srem - sy_ * bx
    gz = chb[:, 0] * bz + sz_
    gy = chb[:, 1] * by + sy_
    gx = chb[:, 2] * bx + sx_
    cid_cm = (gz * cy + gy) * cx + gx
    types = jnp.where(cube_valid, types, 0)

    # --- restore global-id order: two narrow sorts, shared key ---------
    key = jnp.where(cube_valid, cid_cm, _INT_MAX)
    skey, stypes, w0, w1, w2, w3 = jax.lax.sort(
        [key, types.astype(jnp.float32)] + [dat[:, 1 + k] for k in range(4)],
        num_keys=1,
    )
    _k2, w4, w5, w6, w7 = jax.lax.sort(
        [key] + [dat[:, 5 + k] for k in range(4)], num_keys=1
    )
    cid = jnp.where(cube_valid, skey, 0)
    types = jnp.where(
        cube_valid, jnp.round(stypes).astype(jnp.int32), 0
    )
    ws = jnp.stack([w0, w1, w2, w3, w4, w5, w6, w7], axis=-1)

    overflow = fr["chunk_overflow"] | (n_occ > max_cubes)
    return cid, types, ws, cube_valid, overflow, n_occ


def _extract_arrays(
    d: jnp.ndarray,
    voxel_size: jnp.ndarray,
    offset: jnp.ndarray,
    max_cubes: int,
    max_vertices: int,
    n_cube_z=None,
    voxel_index_base=None,
    layout: str = "dense",
    scatter_free: bool = False,
    return_cube_slots: bool = False,
    use_chunked: bool = True,
    chunk_major: bool = True,
    return_edge_verts: bool = False,
) -> TriangleSoup:
    """Core extraction over raw arrays.

    Args:
      n_cube_z: number of valid cube z-rows (traced ok); cubes at or
        beyond it are masked out. Defaults to Z-1. Used by the sharded
        path where a brick's halo row must not emit duplicates.
      voxel_index_base: added to emitted flat voxel indices (sharded
        path: convert brick-local to global indices).
      layout / scatter_free: see extract_surface.
      return_cube_slots: masked layout only — additionally return
        ``(cid, edge_idx, cube_valid)``: the compacted cube ids, each
        slot's MC edge index in [0, 12), and the live-cube mask. The
        fused SceneFusion step uses these to fold slot contributions
        onto cube corners before scattering (cube-corner streams are
        sorted by construction).
      return_edge_verts: with return_cube_slots — append the per-cube
        per-EDGE interpolated vertices (max_cubes, 12, 3) to the tuple.
        The 24 soup slots repeat edges, so the fused SceneFusion step's
        correspondence gathers depth/flow once per EDGE (2x fewer
        lookups) and distributes to slots with a narrow row gather.
      use_chunked: allow the chunked compaction (scatter_free). Pass
        False to force the full-volume sort compaction — the exact
        fallback when a chunk overflow was reported (its only capacity
        limit is max_cubes itself).
      chunk_major: use the chunk-major compaction (_chunked_compact_cm —
        compaction cost bound by max_cubes, not the million-slot chunk
        space; same ascending-cid contract, so outputs are identical).
        Default True for every scatter_free chunked extraction; False
        selects the window-walk compaction (kept as the equality
        reference).
    """
    assert layout in ("dense", "masked"), layout
    Z, Y, X = d.shape
    d = jnp.asarray(d, jnp.float32)  # bf16 storage: interpolate in f32

    # corner k of cube (z, y, x) is voxel (z + dz, y + dy, x + dx)
    cz, cy, cx = Z - 1, Y - 1, X - 1
    n_cubes = cz * cy * cx

    def classify_full():
        # --- phase 1 (full-volume paths): classify every cube ----------
        inside = d < 0.0
        cube_type3 = jnp.zeros((cz, cy, cx), jnp.int32)
        for k in range(8):
            dx, dy, dz = (int(v) for v in CORNER_OFFSETS[k])
            bit = inside[dz : dz + cz, dy : dy + cy, dx : dx + cx]
            cube_type3 = cube_type3 | (bit.astype(jnp.int32) << k)
        occupied3 = (cube_type3 != 0) & (cube_type3 != 255)
        if n_cube_z is not None:
            zrow3 = jax.lax.broadcasted_iota(jnp.int32, (cz, cy, cx), 0)
            occupied3 = occupied3 & (zrow3 < n_cube_z)
        return cube_type3.ravel(), occupied3.ravel()

    # --- phase 2: compact occupied cubes on-device -------------------------
    ws_pre = None
    chunk_overflow = jnp.bool_(False)
    if scatter_free and use_chunked and n_cubes <= _CHUNK_GATE_CUBES:
        # classification happens inside, in compacted chunk space
        compact = _chunked_compact_cm if chunk_major else _chunked_compact
        (cid, types, ws_pre, cube_valid, chunk_overflow, n_occ) = (
            compact(d, n_cube_z, max_cubes)
        )
        vert_counts_c = _table_lookup(
            jnp.asarray(VERT_COUNTS, jnp.int32), types
        )
        occ_counts_c = jnp.where(cube_valid, vert_counts_c, 0)
        cube_offsets = jnp.cumsum(occ_counts_c) - occ_counts_c
        n_verts = jnp.sum(occ_counts_c)
    elif scatter_free:
        cube_type, occupied = classify_full()
        n_occ = jnp.sum(occupied.astype(jnp.int32))
        # ONE sort of (cube-id-if-occupied, type): occupied ids ascend,
        # empties sink to the end as INT_MAX. Rank order == id order, so
        # the sorted prefix IS the compacted cube list.
        key = jnp.where(
            occupied,
            jnp.arange(n_cubes, dtype=jnp.int32),
            _INT_MAX,
        )
        if n_cubes < max_cubes:
            key = jnp.pad(key, (0, max_cubes - n_cubes),
                          constant_values=_INT_MAX)
            cube_type_p = jnp.pad(cube_type, (0, max_cubes - n_cubes))
        else:
            cube_type_p = cube_type
        skey, stype = jax.lax.sort([key, cube_type_p], num_keys=1)
        cube_valid = skey[:max_cubes] < _INT_MAX
        cid = jnp.where(cube_valid, skey[:max_cubes], 0)
        types = jnp.where(cube_valid, stype[:max_cubes], 0)
        vert_counts_c = _table_lookup(
            jnp.asarray(VERT_COUNTS, jnp.int32), types
        )
        occ_counts_c = jnp.where(cube_valid, vert_counts_c, 0)
        cube_offsets = jnp.cumsum(occ_counts_c) - occ_counts_c
        n_verts = jnp.sum(occ_counts_c)
    else:
        cube_type, occupied = classify_full()
        n_occ = jnp.sum(occupied.astype(jnp.int32))
        vert_counts = jnp.take(
            jnp.asarray(VERT_COUNTS, jnp.int32), cube_type, axis=0
        )
        occ_rank = jnp.cumsum(occupied.astype(jnp.int32)) - 1
        scatter_to = jnp.where(occupied, occ_rank, max_cubes)
        cid = (
            jnp.zeros(max_cubes, jnp.int32)
            .at[scatter_to]
            .set(jnp.arange(n_cubes, dtype=jnp.int32), mode="drop")
        )
        # per-cube vertex write offsets (exclusive cumsum over occupied)
        occ_counts = jnp.where(occupied, vert_counts, 0)
        offsets_all = jnp.cumsum(occ_counts) - occ_counts
        cube_offsets = (
            jnp.zeros(max_cubes, jnp.int32)
            .at[scatter_to]
            .set(offsets_all, mode="drop")
        )
        n_verts = jnp.sum(occ_counts)
        cube_valid = jnp.arange(max_cubes) < n_occ
        types = jnp.take(cube_type, cid, axis=0)

    # --- phase 3: sweep ----------------------------------------------------
    # geometry of the occupied cubes
    cub_z = cid // (cy * cx)
    rem = cid - cub_z * (cy * cx)
    cub_y = rem // cx
    cub_x = rem - cub_y * cx

    vs = voxel_size
    flat_d = d.ravel()

    def corner_data(k):
        dx, dy, dz = (int(v) for v in CORNER_OFFSETS[k])
        vx = cub_x + dx
        vy = cub_y + dy
        vz = cub_z + dz
        lin = (vz * Y + vy) * X + vx
        if ws_pre is not None:
            # chunked path: corner values came along in the compaction
            # payload — no element gather at all
            w = ws_pre[:, k]
        else:
            # one element gather per corner: 8 x max_cubes lookups
            w = jnp.take(flat_d, lin, axis=0, mode="clip")
        centre = (
            jnp.stack(
                [
                    vx.astype(jnp.float32) + 0.5,
                    vy.astype(jnp.float32) + 0.5,
                    vz.astype(jnp.float32) + 0.5,
                ],
                axis=-1,
            )
            * vs[None, :]
            + offset[None, :]
        )
        return w, centre, lin

    ws, centres, lins = zip(*(corner_data(k) for k in range(8)))
    ws = jnp.stack(ws, axis=-1)  # (max_cubes, 8)
    centres = jnp.stack(centres, axis=-2)  # (max_cubes, 8, 3)
    lins = jnp.stack(lins, axis=-1)  # (max_cubes, 8)

    # per-edge interpolated vertices (max_cubes, 12, 3)
    ec = jnp.asarray(EDGE_CORNERS, jnp.int32)
    w0 = ws[:, ec[:, 0]]
    w1 = ws[:, ec[:, 1]]
    v0 = centres[:, ec[:, 0]]
    v1 = centres[:, ec[:, 1]]
    denom = w1 - w0
    denom = jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
    ratio = jnp.clip(-w0 / denom, 0.0, 1.0)[..., None]
    edge_verts = v0 + ratio * (v1 - v0)  # ref: interpolate MC.cu:47-63
    edge_vox = jnp.stack(
        [lins[:, ec[:, 0]], lins[:, ec[:, 1]]], axis=-1
    )  # (max_cubes, 12, 2)
    if voxel_index_base is not None:
        edge_vox = edge_vox + voxel_index_base

    # triangulation lookup: _MAX_V slot-edges per cube from the 256-row table
    tri_table = jnp.asarray(TRI_TABLE, jnp.int32)
    tri_edges = tri_table[types]  # (max_cubes, _MAX_V)
    slot_valid = (tri_edges >= 0) & cube_valid[:, None]
    edge_idx = jnp.maximum(tri_edges, 0)

    vert = jnp.take_along_axis(edge_verts, edge_idx[..., None], axis=1)
    vvox = jnp.take_along_axis(edge_vox, edge_idx[..., None], axis=1)

    if layout == "masked":
        n_slots = max_cubes * _MAX_V
        overflowed = (n_occ > max_cubes) | chunk_overflow
        soup = TriangleSoup(
            vertices=vert.reshape(n_slots, 3),
            vertex_voxels=vvox.reshape(n_slots, 2),
            n_vertices=jnp.minimum(n_verts, n_slots),
            overflowed=overflowed,
            valid=slot_valid.reshape(n_slots),
        )
        if return_cube_slots:
            if return_edge_verts:
                return soup, (cid, edge_idx, cube_valid, edge_verts)
            return soup, (cid, edge_idx, cube_valid)
        return soup

    dest = cube_offsets[:, None] + jnp.arange(_MAX_V, dtype=jnp.int32)[None, :]
    if scatter_free:
        # matmul-scatter compaction (ops/scatter.py). Valid dests ascend
        # (offsets are a cumsum); invalid slots re-target the previous
        # valid dest via a running max and contribute zeros — harmless
        # for ADD with unique real targets, and the stream stays sorted
        # so no sort pass is needed.
        sv = slot_valid.ravel()
        lin = jnp.where(sv, dest.ravel(), -1)
        lin = jnp.maximum(jax.lax.cummax(lin), 0)
        lin = jnp.where(lin >= max_vertices, max_vertices, lin)
        payload = jnp.concatenate(
            [
                jnp.where(sv, vert.reshape(-1, 3).T, 0.0),
                jnp.where(sv, (vvox.reshape(-1, 2).T & 0xFFF), 0).astype(
                    jnp.float32
                ),
                jnp.where(sv, (vvox.reshape(-1, 2).T >> 12), 0).astype(
                    jnp.float32
                ),
            ],
            axis=0,
        )  # (7, n_slots)
        # dense ascending write offsets: same 32-row-patch shortcut as
        # the chunked compaction (a 2048-window spans <= 17 rows)
        out = scatter_add_flat(
            max_vertices, lin, payload, is_sorted=True, rows_per_patch=32
        )
        vertices = out[:3].T
        vertex_voxels = (
            jnp.round(out[3:5]).astype(jnp.int32)
            + (jnp.round(out[5:7]).astype(jnp.int32) << 12)
        ).T
    else:
        dest = jnp.where(slot_valid, dest, max_vertices)
        vertices = (
            jnp.zeros((max_vertices, 3), jnp.float32)
            .at[dest.ravel()]
            .set(vert.reshape(-1, 3), mode="drop")
        )
        vertex_voxels = (
            jnp.zeros((max_vertices, 2), jnp.int32)
            .at[dest.ravel()]
            .set(vvox.reshape(-1, 2), mode="drop")
        )

    overflowed = (
        (n_occ > max_cubes) | (n_verts > max_vertices) | chunk_overflow
    )
    n_out = jnp.minimum(n_verts, max_vertices)
    return TriangleSoup(
        vertices=vertices,
        vertex_voxels=vertex_voxels,
        n_vertices=n_out,
        overflowed=overflowed,
        valid=jnp.arange(max_vertices) < n_out,
    )


def soup_to_numpy(soup: TriangleSoup):
    """Host-side: (n, 3) vertices f32 + (n/3, 3) triangle index array.

    Accepts both layouts: masked soups are compacted here with numpy
    (slot order == emission order, so triangles stay contiguous).

    D2H discipline: the soup buffers are STATIC caps (max_vertices can
    be 1M+ slots), so the dense layout slices to the live count ON
    DEVICE before transferring (a concrete-int slice), and the masked
    layout pulls only up to the last live slot.
    """
    n = int(soup.n_vertices)
    cap = soup.vertices.shape[0]
    valid_head = np.asarray(soup.valid[: min(n, cap)])
    if n <= cap and valid_head.all():  # dense layout
        verts = np.asarray(soup.vertices[:n])
    else:
        # masked layout: live slots end at the last valid index
        valid_dev = soup.valid
        last = int(
            jnp.max(
                jnp.where(
                    valid_dev,
                    jnp.arange(cap, dtype=jnp.int32) + 1,
                    0,
                )
            )
        )
        valid = np.asarray(valid_dev[:last])
        verts = np.asarray(soup.vertices[:last])[valid][:n]
    # An overflowed masked soup counts n_vertices over the FULL cube
    # grid while only max_cubes slots were captured: clamp so the
    # triangle list never references vertices that were not emitted
    # (callers should check soup.overflowed and re-extract; this keeps
    # the PLY well-formed either way).
    n = min(n, len(verts)) // 3 * 3
    verts = verts[:n]
    tris = np.arange(n, dtype=np.int32).reshape(-1, 3)
    return verts, tris


def sample_color_at(vol: TSDFVolume, vertices) -> np.ndarray:
    """Host-side trilinear sample of the fused colour volume at world
    points — per-vertex colours for mesh export (beyond reference: the
    reference allocates/saves colours but never writes or reads them,
    TSDFVolume.hpp:23-26).

    Mesh export already ends on the host (PLY is host I/O), so the
    lookup is plain numpy. Sampling
    convention matches trilinear TSDF interpolation: voxel centres at
    offset + (i + 0.5) * voxel_size, coordinates clamped to the lattice
    (the reference's tsdf_value_at clamp, TSDF_utilities.cu:29-37).

    Args:
      vol: volume with ``color`` (Z, Y, X, 3) u8 (see with_color()).
      vertices: (N, 3) world-mm points (x, y, z).

    Returns:
      (N, 3) u8 RGB.
    """
    if vol.color is None:
        raise ValueError(
            "volume has no colour field; fuse with rgb / with_color()"
        )
    col = np.asarray(vol.color, dtype=np.float32)  # (Z, Y, X, 3)
    verts = np.asarray(vertices, dtype=np.float32)
    offset = np.asarray(vol.offset, dtype=np.float32)
    vs = np.asarray(vol.voxel_size, dtype=np.float32)
    sz, sy, sx = col.shape[:3]

    # continuous lattice coords: centre of voxel i at offset+(i+0.5)*vs
    cf = (verts - offset[None, :]) / vs[None, :] - 0.5  # (N,3) x,y,z
    dims = np.array([sx, sy, sz], dtype=np.int64)
    i0 = np.floor(cf).astype(np.int64)
    frac = cf - i0
    i0c = np.clip(i0, 0, dims - 1)
    i1c = np.clip(i0 + 1, 0, dims - 1)

    out = np.zeros((len(verts), 3), np.float32)
    for dz in (0, 1):
        zi = (i1c if dz else i0c)[:, 2]
        wz = np.where(dz, frac[:, 2], 1.0 - frac[:, 2])
        for dy in (0, 1):
            yi = (i1c if dy else i0c)[:, 1]
            wy = np.where(dy, frac[:, 1], 1.0 - frac[:, 1])
            for dx in (0, 1):
                xi = (i1c if dx else i0c)[:, 0]
                wx = np.where(dx, frac[:, 0], 1.0 - frac[:, 0])
                w = (wz * wy * wx).astype(np.float32)
                out += w[:, None] * col[zi, yi, xi]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)
