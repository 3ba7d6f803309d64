"""SceneFusion: non-rigid fusion with a per-voxel deformation field.

Re-design of the reference's SceneFusion orchestrator + kernel chain (ref: src/SceneFusion/SceneFusion.cpp:46-185,
SceneFusion_krnl.cu:236-401). Per frame:

  1. extract the current isosurface mesh with per-vertex bracketing
     voxel indices (ops/marching_cubes.py, the reference's
     extract_surface_ms);
  2. find correspondences: project each mesh vertex into the depth
     frame, accept when the reprojected depth agrees within 10 mm
     (ref: find_mesh_vertex_correspondences SceneFusion_krnl.cu:74-114,
     threshold :15);
  3. update the deformation field: every corresponding vertex adds
     flow(pixel)/usage(voxel) to BOTH its bracketing voxels'
     translations. The reference does this with racy non-atomic adds
     (ref: update_deformation_field SceneFusion_krnl.cu:211-232,
     SURVEY.md §5 'known race'); here the adds are XLA ``.at[].add``
     scatter-adds, or with ``scatter_free`` the sorted matmul scatter
     (ops/scatter.py);
  4. integrate the new depth frame into the (now deformed) volume
     (ref: SceneFusion.cpp:139).

The reference's host-side compaction scan (SceneFusion_krnl.cu:126-167)
disappears: masking does the same work without leaving the device.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import Camera
from ..ops.integrate import integrate
from ..ops.marching_cubes import (
    TriangleSoup,
    _extract_arrays,
    extract_surface,
)
from ..ops.scatter import scatter_add_flat
from ..volume import TSDFVolume, make_volume

# ref: SceneFusion_krnl.cu:15
CORRESPONDENCE_THRESHOLD_MM = 10.0

# Slot-correspondence walk block size: each block pays one gather_flat
# (whose internal sort dominates, and sort cost is super-linear in
# length).
_CORR_BLK = 1 << 16


@dataclasses.dataclass(frozen=True)
class SceneFusionConfig:
    volume_size: tuple[int, int, int] = (255, 255, 255)  # ref: SceneFusion.cpp:49
    physical_size_mm: float = 2550.0
    offset_mm: tuple[float, float, float] = (-1275.0, -1275.0, 0.0)
    threshold_mm: float = CORRESPONDENCE_THRESHOLD_MM
    max_cubes: int = 1 << 18
    max_vertices: int = 1 << 20
    # First-rung cube cap for the fused step: the per-cube work after
    # compaction scales with the STATIC cap, not the live cube count. On
    # overflow the frame is re-run at the ``max_cubes`` ceiling — nothing
    # is ever truncated. Set equal to max_cubes to disable the ladder.
    max_cubes_fast: int = 1 << 16
    # Compile the overflow-fallback step variants in a background thread
    # after the first frame (lower + compile, no execution), so a
    # mid-run overflow swaps to an already-compiled graph instead of
    # stalling the frame loop on a compile.
    prewarm_fallback: bool = True

    def make_volume(self) -> TSDFVolume:
        return make_volume(
            self.volume_size,
            self.physical_size_mm,
            offset=self.offset_mm,
            with_deformation=True,
        )


def _slot_correspondence(
    verts: jnp.ndarray,
    slot_valid: jnp.ndarray,
    depth: jnp.ndarray,
    camera: Camera,
    flow: jnp.ndarray,
    threshold_mm: float,
):
    """Project mesh vertices into the frame; accept when the reprojected
    depth agrees within the threshold (ref: SceneFusion_krnl.cu:74-114).
    Returns (corr mask, per-vertex flow zeroed on non-corresponding)."""
    h, w = depth.shape
    # one world_to_camera for both the projection and the depth gate
    # (bit-identical to camera.world_to_pixel, which is cam @ K.T +
    # perspective divide + round)
    cam_pts = camera.world_to_camera(verts)  # (N, 3)
    img_h = cam_pts @ camera.k.T
    pix = jnp.round(img_h[..., 0:2] / img_h[..., 2:3])  # (N, 2)
    px = pix[..., 0].astype(jnp.int32)
    py = pix[..., 1].astype(jnp.int32)
    in_img = (px >= 0) & (px < w) & (py >= 0) & (py < h) & slot_valid
    lin = jnp.clip(py, 0, h - 1) * w + jnp.clip(px, 0, w - 1)

    # one fused image gather: [depth, flow] as 4 channels per pixel.
    # The slot buffer is a static cap (max_cubes * 24 slots, ~6.3M at
    # the 255^3 default) but live cubes are a compacted prefix, so the
    # walk covers 64k-slot blocks and stops at the last live slot —
    # cost tracks the actual surface, not the cap. Each block goes
    # through gather_flat (the sorted-window matmul gather,
    # ops/scatter.py); per-block sorting keeps the sort cost at 64k
    # elements, and dead slots map to an off-the-end sentinel that
    # gather_flat zero-fills.
    img = jnp.concatenate(
        [
            depth.reshape(-1, 1),
            jnp.asarray(flow, jnp.float32).reshape(-1, 3),
        ],
        axis=-1,
    )
    N = lin.shape[0]
    if N <= (1 << 16):
        g = jnp.take(img, lin, axis=0, mode="clip")  # (N, 4)
    else:
        from ..ops.scatter import gather_flat

        n_live = jnp.max(
            jnp.where(slot_valid, jnp.arange(N, dtype=jnp.int32) + 1, 0)
        )
        BLK = _CORR_BLK
        nb = -(-N // BLK)
        linp = jnp.pad(
            jnp.where(slot_valid, lin, img.shape[0]),
            (0, nb * BLK - N),
            constant_values=img.shape[0],
        )

        def cond(st):
            b, _ = st
            return b * BLK < n_live

        def body(st):
            b, out = st
            lw = jax.lax.dynamic_slice(linp, (b * BLK,), (BLK,))
            gb = gather_flat(img, lw, fill_mode="zero")
            return b + 1, jax.lax.dynamic_update_slice(
                out, gb, (b * BLK, 0)
            )

        _, gp = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.zeros((nb * BLK, 4), jnp.float32))
        )
        g = gp[:N]
    d = g[:, 0]
    # Compare CAMERA-space depth (the reference's depth-only distance,
    # ref: SceneFusion_krnl.cu:100-105, where the camera frame is the
    # world frame). Comparing world z would only be correct for an
    # identity rotation; and a vertex BEHIND the camera mirror-projects
    # into the image (both pixel signs flip back in range), so gate on
    # cam_z > 0 — the same behind-camera gate ops/integrate.py applies
    # to the ungated reference projection.
    cam_z = cam_pts[..., 2]
    corr = (
        in_img
        & (d > 0)
        & (cam_z > 0)
        & (jnp.abs(d - cam_z) < threshold_mm)
    )
    return corr, jnp.where(corr[:, None], g[:, 1:], 0.0)


def update_deformation(
    vol: TSDFVolume,
    soup: TriangleSoup,
    depth: jnp.ndarray,
    camera: Camera,
    flow: jnp.ndarray,
    threshold_mm: float = CORRESPONDENCE_THRESHOLD_MM,
    scatter_free: bool = False,
) -> tuple[TSDFVolume, jnp.ndarray]:
    """Apply one scene-flow observation to the deformation field.

    Args:
      soup: current surface mesh (vertices + bracketing voxel pairs),
        dense or masked layout.
      depth: (H, W) mm.
      flow: (H, W, 3) mm scene flow per pixel.
      scatter_free: route the per-voxel accumulation through the sorted
        matmul scatter (ops/scatter.py) instead of XLA scatter-add.

    Returns (updated volume, number of corresponding vertices).
    """
    depth = jnp.asarray(depth, jnp.float32)
    slot_valid = soup.valid
    verts = soup.vertices
    corr, flow_at_vert = _slot_correspondence(
        verts, slot_valid, depth, camera, flow, threshold_mm
    )

    # per-voxel accumulation: mesh-usage counts over ALL mesh vertices
    # (ref: atomicIncUint8 during generate_vertices MC.cu:297-298) and
    # flow sums over corresponding vertices — both bracketing voxels of
    # each vertex receive the contribution (SceneFusion_krnl.cu:211-232;
    # the reference's adds race, here they are deterministic sums).
    n_vox = vol.tsdf.size
    vox = soup.vertex_voxels  # (N, 2)
    if scatter_free:
        vox2 = vox.ravel()  # (2N,) — vertex i contributes at 2i, 2i+1
        sv2 = jnp.repeat(slot_valid, 2)
        flow2 = jnp.repeat(flow_at_vert, 2, axis=0)  # already corr-masked
        lin2 = jnp.where(sv2, vox2, -1)  # out of range -> dropped
        payload = jnp.concatenate(
            [sv2.astype(jnp.float32)[None, :], flow2.T], axis=0
        )  # (4, 2N)
        acc = scatter_add_flat(n_vox, lin2, payload)
        counts = acc[0]
        flow_sum = acc[1:4].T
    else:
        vox_safe = jnp.where(slot_valid[:, None], vox, n_vox)
        counts = jnp.zeros(n_vox + 1, jnp.float32).at[
            vox_safe.ravel()
        ].add(1.0, mode="drop")[:n_vox]
        vox_corr = jnp.where(corr[:, None], vox, n_vox)  # drop non-corr
        flow_sum = (
            jnp.zeros((n_vox + 1, 3), jnp.float32)
            .at[vox_corr.ravel()]
            .add(jnp.repeat(flow_at_vert, 2, axis=0), mode="drop")[:n_vox]
        )
    delta = flow_sum / jnp.maximum(counts, 1.0)[:, None]
    new_deform = vol.deform + delta.reshape(vol.deform.shape)
    return vol.replace(deform=new_deform), jnp.sum(corr.astype(jnp.int32))


def _cube_corner_scatter(
    contrib: jnp.ndarray,
    cid: jnp.ndarray,
    edge_idx: jnp.ndarray,
    cube_valid: jnp.ndarray,
    shape: tuple[int, int, int],
) -> jnp.ndarray:
    """Fold per-slot contributions onto cube corners and scatter.

    Args:
      contrib: (C, _MAX_V, D) per-slot payload (already masked).
      cid: (C,) ascending cube ids over the (Z-1, Y-1, X-1) cube grid of
        a volume of ``shape`` voxels.
      edge_idx: (C, _MAX_V) MC edge per slot.
      cube_valid: (C,) live-cube prefix mask.
      shape: (Z, Y, X) of the TARGET voxel grid — the sharded caller
        passes its local-slab-plus-one-halo shape so corner taps that
        cross the brick boundary land in the halo slab.

    Returns (D, Z*Y*X) f32 accumulated per voxel.
    """
    from ..ops.marching_cubes import CORNER_OFFSETS

    Z, Y, X = shape

    # Dead slots carry edge 0 but a zero contribution.
    payload = _slot_corner_fold(contrib, edge_idx)

    cy, cx = Y - 1, X - 1
    cz_ = cid // (cy * cx)
    rem = cid - cz_ * (cy * cx)
    cy_ = rem // cx
    cx_ = rem - cy_ * cx
    n_vox = Z * Y * X

    offs = []
    for k in range(8):
        dx, dy, dz = (int(v) for v in CORNER_OFFSETS[k])
        offs.append((dz * Y + dy) * X + dx)
    lin0 = (cz_ * Y + cy_) * X + cx_  # cube-base voxel id (corner 3)
    # invalid cubes sit at the tail (cube_valid is a prefix); point
    # them past the end so the sorted scatter stops there
    lin0 = jnp.where(cube_valid, lin0, n_vox)
    # one window walk + one matmul per window for all 8 corners, folded
    # into a D-channel accumulator via the static corner offsets (a
    # dense 8*D-channel accumulator would be 8x the bytes — ~2 GB at
    # 255^3 and an OOM at 512^3)
    # "trusted": cid is ascending by construction (compaction emits
    # sorted ids) and cube_valid is a prefix, so the sentinel remap
    # keeps the stream monotone — skipping the checked hint's lax.cond
    # sort branch.
    return scatter_add_flat(
        n_vox,
        lin0,
        jnp.concatenate(payload, axis=0),
        is_sorted="trusted",
        fold_offsets=tuple(offs),
        # the walk's per-window cost scales with window x rows_per_patch
        # (one-hot build), so a sparse cube stream favours small windows
        window=512,
        rows_per_patch=128,
    )  # (D, n_vox)


def _edge_correspondence(
    soup: TriangleSoup,
    edge_idx: jnp.ndarray,
    edge_verts: jnp.ndarray,
    depth: jnp.ndarray,
    camera: Camera,
    flow: jnp.ndarray,
    threshold_mm: float,
):
    """Per-EDGE correspondence: the 24 soup slots repeat the ≤12
    distinct edge vertices, so the depth/flow image gather runs once
    per edge and a width-12 row gather distributes values back to
    slots — identical math to the per-slot `_slot_correspondence` at
    half the gather stream. Shared by the fused single-device step and
    the brick-parallel sharded frame. Returns (corr (N,), flow (N, 3))
    in slot layout."""
    from ..ops.marching_cubes import _MAX_V, _slot_gather

    C = edge_idx.shape[0]
    slot_valid = soup.valid.reshape(C, _MAX_V)
    ei = edge_idx  # (C, _MAX_V) in [0, 12)
    edge_used = jnp.stack(
        [jnp.any(slot_valid & (ei == e), axis=1) for e in range(12)],
        axis=1,
    )  # (C, 12)
    corr_e, flow_e = _slot_correspondence(
        edge_verts.reshape(C * 12, 3),
        edge_used.reshape(-1),
        depth, camera, flow, threshold_mm,
    )
    fe = flow_e.reshape(C, 12, 3)
    flow_slot = jnp.stack(
        [_slot_gather(fe[:, :, d], ei) for d in range(3)],
        axis=-1,
    )  # (C, _MAX_V, 3)
    corr_slot = (
        _slot_gather(corr_e.astype(jnp.float32).reshape(C, 12), ei)
        > 0.5
    )
    corr = (corr_slot & slot_valid).reshape(-1)
    return corr, jnp.where(corr[:, None], flow_slot.reshape(-1, 3), 0.0)


def _slot_corner_fold(contrib: jnp.ndarray, edge_idx: jnp.ndarray):
    """Fold per-slot contributions onto the 8 cube corners.

    Each corner k is incident to exactly 3 of the 12 MC edges, so the
    per-slot weight for corner k is the sum of 3 edge-equality masks —
    pure VPU compares, no table gather (ref: the per-vertex bracketing
    pair writes, MarkAndSweepMC.cu:290-301). Returns a list of 8
    (D, C) payload blocks, corner order = CORNER_OFFSETS.
    """
    from ..ops.marching_cubes import EDGE_CORNERS

    ec = np.asarray(EDGE_CORNERS)  # (12, 2) static
    edge_mask = [
        (edge_idx == i).astype(jnp.float32) for i in range(12)
    ]  # 12 x (C, _MAX_V)
    corner_edges = [
        [i for i in range(12) if k in (int(ec[i, 0]), int(ec[i, 1]))]
        for k in range(8)
    ]
    assert all(len(v) == 3 for v in corner_edges)
    payload = []
    for k in range(8):
        a, b, c = corner_edges[k]
        w_k = edge_mask[a] + edge_mask[b] + edge_mask[c]  # (C, _MAX_V)
        payload.append(jnp.einsum("cs,csd->dc", w_k, contrib))  # (D, C)
    return payload


def update_deformation_cubes(
    vol: TSDFVolume,
    soup: TriangleSoup,
    cid: jnp.ndarray,
    edge_idx: jnp.ndarray,
    cube_valid: jnp.ndarray,
    depth: jnp.ndarray,
    camera: Camera,
    flow: jnp.ndarray,
    threshold_mm: float = CORRESPONDENCE_THRESHOLD_MM,
    edge_verts: jnp.ndarray | None = None,
) -> tuple[TSDFVolume, jnp.ndarray]:
    """``update_deformation`` over cube slots, for the scatter-free arm.

    Same math, different factoring: every bracketing voxel of a mesh
    vertex is a corner of its cube, so the (count, flow) contributions
    fold per cube onto its 8 corners with a static edge→corner table
    (pure VPU compares + reductions over the _MAX_V=24 slots), and all
    8 corner streams ride ONE 32-channel ``scatter_add_flat`` targeted
    at the cube-base voxel (z, y, x) (cid is id-sorted, so the stream
    is pre-sorted and there is a single window walk); corner k's dense
    result is then shifted into place by its static voxel offset
    (out[lin+off] += v == shift(scatter(lin, v), off)) — ~48× fewer
    matmul windows than scattering the raw 2·24·max_cubes slot stream,
    and 8× fewer than one scatter per corner.

    With ``edge_verts``: the depth/flow image gather runs per EDGE (the
    ≤12 distinct vertices each cube can own) instead of per slot (24,
    which repeat edges) — the gather stream halves, and the per-slot
    values come back through a narrow width-12 row gather.
    Identical math: a slot's pixel is its edge's pixel.
    """
    from ..ops.marching_cubes import _MAX_V

    depth = jnp.asarray(depth, jnp.float32)
    C = cid.shape[0]
    if edge_verts is not None:
        corr, flow_at_vert = _edge_correspondence(
            soup, edge_idx, edge_verts, depth, camera, flow, threshold_mm
        )
    else:
        corr, flow_at_vert = _slot_correspondence(
            soup.vertices, soup.valid, depth, camera, flow, threshold_mm
        )
    n_corr = jnp.sum(corr.astype(jnp.int32))

    # (C, _MAX_V, 4) contributions: count channel over all valid slots,
    # flow channels over corresponding slots (already corr-masked)
    contrib = jnp.concatenate(
        [
            soup.valid.astype(jnp.float32)[:, None],
            flow_at_vert,
        ],
        axis=-1,
    ).reshape(C, _MAX_V, 4)

    acc = _cube_corner_scatter(
        contrib, cid, edge_idx, cube_valid, vol.tsdf.shape
    )  # (4, n_vox)

    counts = acc[0]
    flow_sum = acc[1:4].T
    delta = flow_sum / jnp.maximum(counts, 1.0)[:, None]
    new_deform = vol.deform + delta.reshape(vol.deform.shape)
    return vol.replace(deform=new_deform), n_corr


@partial(
    jax.jit,
    static_argnames=(
        "max_cubes", "threshold_mm", "scatter_free", "use_chunked",
        "chunk_major",
    ),
)
def _sf_step(
    vol: TSDFVolume,
    depth: jnp.ndarray,
    flow: jnp.ndarray,
    camera: Camera,
    *,
    max_cubes: int,
    threshold_mm: float,
    scatter_free: bool = False,
    use_chunked: bool = True,
    chunk_major: bool = True,
):
    """One fused SceneFusion frame: masked-layout surface extraction ->
    deformation-field update -> deformed-volume integrate, all in ONE
    jit so the host never syncs mid-frame (ref loop:
    SceneFusion.cpp:84-185).

    Returns (volume, correspondence count, extraction-overflow flag). A
    set overflow means max_cubes (or, scatter_free, the chunked
    compaction's active-chunk cap) truncated the mesh; the caller
    re-runs the frame with a larger cap / ``use_chunked=False``.
    """
    with jax.named_scope("extract"):
        if scatter_free:
            soup, (cid, edge_idx, cube_valid, edge_verts) = _extract_arrays(
                vol.tsdf,
                vol.voxel_size,
                vol.offset,
                max_cubes=max_cubes,
                max_vertices=1,  # unused by the masked layout
                layout="masked",
                scatter_free=True,
                return_cube_slots=True,
                use_chunked=use_chunked,
                chunk_major=use_chunked and chunk_major,
                return_edge_verts=True,
            )
        else:
            soup = _extract_arrays(
                vol.tsdf,
                vol.voxel_size,
                vol.offset,
                max_cubes=max_cubes,
                max_vertices=1,  # unused by the masked layout
                layout="masked",
            )
    with jax.named_scope("deformation_update"):
        if scatter_free:
            vol, n_corr = update_deformation_cubes(
                vol, soup, cid, edge_idx, cube_valid, depth, camera, flow,
                threshold_mm, edge_verts=edge_verts,
            )
        else:
            vol, n_corr = update_deformation(
                vol, soup, depth, camera, flow, threshold_mm
            )
    with jax.named_scope("integrate"):
        out = integrate(vol, depth, camera)
    return out, n_corr, soup.overflowed


class SceneFusion:
    """Orchestrator wiring an RGBD device to a scene-flow provider.

    ref: SceneFusion.cpp:46-185 — observer-callback driven; per frame
    pair, update the warp field from scene flow and integrate.
    """

    def __init__(
        self,
        scene_flow_provider,
        device,
        config: SceneFusionConfig = SceneFusionConfig(),
        camera: Optional[Camera] = None,
        dump_every: int = 0,
        dump_dir: str = ".",
        mesh=None,
    ):
        self.config = config
        self.sfa = scene_flow_provider
        self.device = device
        self.camera = camera or Camera.default_depth_camera()
        self.volume = config.make_volume()
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.ops import shard_volume

            self.volume = shard_volume(self.volume, mesh)
        self.last_depth = None
        self.frame_index = 0
        self.dump_every = dump_every
        self.dump_dir = dump_dir
        self._fallback_warmed = False
        device.add_observer(self.process_frames)

    def process_frames(self, depth, colour=None):
        """Observer callback (ref: SceneFusion::process_frames :84-185)."""
        depth = jnp.asarray(depth, jnp.float32)
        cfg = self.config
        if self.last_depth is None:
            if self.mesh is not None:
                from ..parallel.ops import integrate_sharded

                self.volume = integrate_sharded(
                    self.volume, depth, self.camera, self.mesh
                )
            else:
                self.volume = integrate(self.volume, depth, self.camera)
        elif self.mesh is not None:
            # brick-parallel path: sharded deformation update + deformed
            # integrate per brick (parallel/ops.py)
            from ..parallel.ops import scenefusion_frame_sharded

            _t, _r, flow = self.sfa.compute_scene_flow(depth, colour)
            self.volume, _n = scenefusion_frame_sharded(
                self.volume, depth, self.camera,
                jnp.asarray(flow, jnp.float32), self.mesh,
                max_cubes_per_brick=cfg.max_cubes,
                threshold_mm=cfg.threshold_mm,
            )
        else:
            _t, _r, flow = self.sfa.compute_scene_flow(depth, colour)
            self.volume = self._fused_frame(
                depth, jnp.asarray(flow, jnp.float32)
            )
        self.last_depth = depth
        if self.dump_every and self.frame_index % self.dump_every == 0:
            self.dump(self.frame_index)
        self.frame_index += 1

    def _fused_frame(self, depth, flow) -> TSDFVolume:
        """One fused step with the cube-cap ladder: the fast cap first,
        escalating on overflow to the ``max_cubes`` ceiling."""
        cfg = self.config
        step = partial(_sf_step, threshold_mm=cfg.threshold_mm)
        rungs = [dict(max_cubes=min(cfg.max_cubes_fast, cfg.max_cubes))]
        if cfg.max_cubes_fast < cfg.max_cubes:
            rungs.append(dict(max_cubes=cfg.max_cubes))
        if cfg.prewarm_fallback and not self._fallback_warmed:
            self._fallback_warmed = True
            lowereds = [
                step.func.lower(
                    self.volume, depth, flow, self.camera,
                    **step.keywords, **r,
                )
                for r in rungs[1:]
            ]
            import threading

            def _compile_all(ls=lowereds):
                for low in ls:
                    low.compile()

            threading.Thread(target=_compile_all, daemon=True).start()
        for r in rungs:
            vol, _n, overflow = step(
                self.volume, depth, flow, self.camera, **r
            )
            if not bool(overflow):
                return vol
        import warnings

        warnings.warn(
            f"SceneFusion frame {self.frame_index}: occupied cubes exceed "
            f"max_cubes={cfg.max_cubes}; mesh (and the deformation update) "
            "truncated — raise SceneFusionConfig.max_cubes",
            stacklevel=3,
        )
        return vol

    def dump(self, index: int) -> None:
        """Periodic checkpoint + canonical and warped meshes
        (ref: SceneFusion.cpp:142-181)."""
        import os

        import numpy as np

        from ..io.ply import write_ply
        from ..io.tsdf_file import save_tsdf
        from ..ops.deform import deform_points
        from ..ops.marching_cubes import soup_to_numpy

        os.makedirs(self.dump_dir, exist_ok=True)
        save_tsdf(
            self.volume,
            os.path.join(self.dump_dir, f"frame_{index:03d}.tsdf"),
        )
        soup = self.extract_mesh()
        verts, tris = soup_to_numpy(soup)
        write_ply(
            os.path.join(self.dump_dir, f"mesh_canonical_{index:03d}.ply"),
            verts,
            tris,
        )
        warped, _valid = deform_points(self.volume, jnp.asarray(verts))
        write_ply(
            os.path.join(self.dump_dir, f"mesh_warped_{index:03d}.ply"),
            np.asarray(warped),
            tris,
        )

    def extract_mesh(self) -> TriangleSoup:
        return extract_surface(
            self.volume,
            max_cubes=self.config.max_cubes,
            max_vertices=self.config.max_vertices,
        )
