"""shard_map'd fusion ops: brick-sharded integrate, ray-tiled raycast.

Multi-device versions of the reference's single-GPU kernel launches
(SURVEY.md §2.9): the CUDA grid/block decomposition becomes the XLA device
mesh, and the H<->D memcpy boundaries become collectives.

  * integrate: each device owns a z-slab ("brick") of the volume; the depth
    frame is replicated, so the update is embarrassingly parallel — zero
    collectives, perfect weak scaling (replaces integrate_kernel's
    (y,z)-thread decomposition, ref: src/TSDF/TSDFVolume.cu:889-892).
  * raycast: ray tiles are sharded over the whole mesh while each device
    all-gathers the volume over the brick axis once per frame (rays cross
    brick boundaries freely; one tiled all_gather replaces the
    reference's per-pixel global-memory traversal, ref:
    src/RayCaster/GPURaycaster.cu:479-481).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..camera import Camera
from ..volume import TSDFVolume
from ..ops.integrate import integrate
from ..ops.raycast import (
    REFERENCE_MAX_STEPS,
    compute_normals_from_vertices,
    march_image,
    ray_directions,
)
from .mesh import volume_sharding, replicated


def shard_volume(vol: TSDFVolume, mesh: Mesh) -> TSDFVolume:
    """Place a volume on the mesh: dense arrays z-sharded, metadata
    replicated. The volume's Z extent must divide the "b" axis size."""
    vs = volume_sharding(mesh)
    rep = replicated(mesh)

    def place(arr, sharded):
        if arr is None:
            return None
        return jax.device_put(arr, vs if sharded else rep)

    return TSDFVolume(
        tsdf=place(vol.tsdf, True),
        weight=place(vol.weight, True),
        color=place(vol.color, True),
        deform=place(vol.deform, True),
        deform_rot=place(vol.deform_rot, True),
        physical_size=place(vol.physical_size, False),
        offset=place(vol.offset, False),
        truncation_distance=place(vol.truncation_distance, False),
        max_weight=place(vol.max_weight, False),
        global_rotation=place(vol.global_rotation, False),
        global_translation=place(vol.global_translation, False),
    )


def _local_slab_volume(
    tsdf, weight, deform, physical_size, offset, trunc, max_weight, nb
):
    """Reconstruct a TSDFVolume describing this device's z-slab.

    The slab keeps the global voxel size; its world offset shifts by
    brick_index * slab_thickness along z.
    """
    bi = jax.lax.axis_index("b")
    sz_local = tsdf.shape[0]
    slab_phys_z = physical_size[2] / nb
    local_offset = offset + jnp.array([0.0, 0.0, 1.0], jnp.float32) * (
        bi.astype(jnp.float32) * slab_phys_z
    )
    local_phys = physical_size * jnp.array(
        [1.0, 1.0, 1.0 / nb], jnp.float32
    )
    return TSDFVolume(
        tsdf=tsdf,
        weight=weight,
        color=None,
        deform=deform,
        deform_rot=None,
        physical_size=local_phys,
        offset=local_offset,
        truncation_distance=trunc,
        max_weight=max_weight,
        global_rotation=jnp.zeros(3, jnp.float32),
        global_translation=jnp.zeros(3, jnp.float32),
    )


def integrate_sharded(
    vol: TSDFVolume,
    depth: jnp.ndarray,
    camera: Camera,
    mesh: Mesh,
    cap_weight: bool = False,
    rgb: jnp.ndarray | None = None,
) -> TSDFVolume:
    """Brick-parallel depth integration: ``ops.integrate`` on each
    device's z-slab, with no collectives (the brick decomposition of the
    reference's ``integrate_kernel`` launch, ref:
    src/TSDF/TSDFVolume.cu:889-892). Rigid and deformed volumes alike.

    Pass ``rgb`` (H, W, 3 u8, replicated) to fuse colour into a
    with_color rigid volume.

    Requires vol.tsdf.shape[0] % mesh.shape["b"] == 0.
    """
    if rgb is not None:
        if vol.color is None:
            raise ValueError(
                "rgb frame given but the volume has no colour field"
            )
        if vol.deform is not None:
            raise ValueError(
                "colour fusion is the rigid path (no deformed variant)"
            )
        rgb = jnp.asarray(rgb)
    return _integrate_sharded_jit(
        vol, jnp.asarray(depth, jnp.float32), camera, rgb, mesh=mesh,
        cap_weight=cap_weight,
    )


@partial(jax.jit, static_argnames=("mesh", "cap_weight"))
def _integrate_sharded_jit(
    vol: TSDFVolume,
    depth: jnp.ndarray,
    camera: Camera,
    rgb,
    *,
    mesh: Mesh,
    cap_weight: bool,
):
    nb = mesh.shape["b"]
    has_deform = vol.deform is not None
    has_rgb = rgb is not None

    def local(tsdf, weight, deform, color, depth, rgb, k, pose, pose_inv,
              physical_size, offset, trunc, max_weight):
        lvol = _local_slab_volume(
            tsdf, weight, deform, physical_size, offset, trunc, max_weight,
            nb,
        )
        if color is not None:
            lvol = lvol.replace(color=color)
        cam = Camera(
            k=k, k_inv=jnp.linalg.inv(k), pose=pose, pose_inv=pose_inv
        )
        out = integrate(lvol, depth, cam, cap_weight=cap_weight, rgb=rgb)
        return out.tsdf, out.weight, out.color if has_rgb else None

    if has_deform:
        deform_arg = vol.deform
        deform_spec = P("b")
    else:
        # None is an empty pytree: its spec subtree must be empty too.
        deform_arg = None
        deform_spec = None

    if has_rgb:
        color_arg, color_spec = vol.color, P("b")
        rgb_arg, rgb_spec = rgb, P()
        color_out_spec = P("b")
    else:
        color_arg, color_spec = None, None
        rgb_arg, rgb_spec = None, None
        color_out_spec = None

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P("b"), P("b"), deform_spec, color_spec, P(), rgb_spec,
            P(), P(), P(), P(), P(), P(), P(),
        ),
        out_specs=(P("b"), P("b"), color_out_spec),
        check_vma=False,
    )
    new_tsdf, new_weight, new_color = fn(
        vol.tsdf,
        vol.weight,
        deform_arg,
        color_arg,
        depth,
        rgb_arg,
        camera.k,
        camera.pose,
        camera.pose_inv,
        vol.physical_size,
        vol.offset,
        vol.truncation_distance,
        vol.max_weight,
    )
    out = vol.replace(tsdf=new_tsdf, weight=new_weight)
    if has_rgb:
        out = out.replace(color=new_color)
    return out


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "width", "height", "mode", "max_steps",
        "replicate_volume_ok",
    ),
)
def raycast_sharded(
    vol: TSDFVolume,
    camera: Camera,
    mesh: Mesh,
    width: int = 640,
    height: int = 480,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
    replicate_volume_ok: bool = False,
):
    """Ray-tiled raycast: image rows sharded over every device, volume
    all-gathered over the brick axis (one tiled all_gather), each row
    tile marched by ``march_image`` (the per-tile kernel on a GPU).

    EXPLICIT OPT-IN: the all_gather gives every device an O(volume)
    copy, which defeats brick sharding's memory reason to exist at
    volumes beyond one device; acknowledge the cost with
    ``replicate_volume_ok=True``.

    Returns (vertices, normals) as in ops.raycast.
    """
    if not replicate_volume_ok:
        raise ValueError(
            "raycast_sharded all_gathers the WHOLE volume to every "
            "device (O(volume) per-device memory); pass "
            "replicate_volume_ok=True to accept the cost."
        )
    n_dev = mesh.shape["b"] * mesh.shape["r"]
    dirs = ray_directions(camera, width, height)
    hp = -(-height // n_dev) * n_dev
    # padded rows duplicate the last real row and are cropped below
    dirs = jnp.pad(dirs, ((0, hp - height), (0, 0), (0, 0)), mode="edge")

    def local(tsdf_slab, dirs_rows, physical_size, offset, trunc, origin):
        full = jax.lax.all_gather(tsdf_slab, "b", axis=0, tiled=True)
        lvol = TSDFVolume.for_geometry(
            full, physical_size, offset, trunc
        )
        return march_image(
            lvol, origin, dirs_rows,
            mode=mode, max_steps=max_steps, step_scale=step_scale,
        )

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("b"), P(("b", "r")), P(), P(), P(), P()),
        out_specs=P(("b", "r")),
        check_vma=False,
    )
    verts = fn(
        vol.tsdf,
        dirs,
        vol.physical_size,
        vol.offset,
        vol.truncation_distance,
        camera.position,
    )[:height]
    normals = compute_normals_from_vertices(verts)
    return verts, normals


def icp_step_sharded(
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    vmap_curr: jnp.ndarray,
    nmap_curr: jnp.ndarray,
    vmap_prev: jnp.ndarray,
    nmap_prev: jnp.ndarray,
    intrinsics: tuple,
    mesh: Mesh,
    dist_thresh: float = 100.0,
    angle_thresh: float = 0.342,
):
    """ICP normal equations with the residual reduction psum'd over the
    mesh — the mesh-wide version of estimate.cu's 29-vector
    warp-shuffle reduction tree (ref: estimate.cu:26-85, 264-281).

    Current-frame pixel rows are sharded over every device; the model
    (previous) maps are replicated since projective association crosses
    row boundaries. Requires H % n_devices == 0.
    """
    from ..tracking.icp import icp_step

    fx, fy, cx, cy = intrinsics

    def local(vc, nc, vp, np_, rot, trans):
        a, b, res, inl = icp_step(
            rot, trans, vc, nc, vp, np_, fx, fy, cx, cy,
            dist_thresh, angle_thresh,
        )
        axes = ("b", "r")
        return (
            jax.lax.psum(a, axes),
            jax.lax.psum(b, axes),
            jax.lax.psum(res, axes),
            jax.lax.psum(inl, axes),
        )

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(("b", "r")), P(("b", "r")), P(), P(), P(), P(),
        ),
        out_specs=(P(), P(), P(), P()),
    )
    return fn(vmap_curr, nmap_curr, vmap_prev, nmap_prev, rot, trans)


@partial(
    jax.jit,
    static_argnames=("mesh", "levels", "iterations", "band"),
)
def get_incremental_transformation_sharded(
    depth_curr: jnp.ndarray,
    depth_prev: jnp.ndarray,
    intrinsics: jnp.ndarray,  # (4,) fx, fy, cx, cy
    mesh: Mesh,
    levels: int = 3,
    iterations: tuple[int, ...] = (10, 5, 4),
    band: int | None = None,
    conv_eps: float = 0.0,
    init_pose: jnp.ndarray | None = None,
    dist_thresh: float | None = None,
    angle_thresh: float | None = None,
    adaptive: bool = True,
):
    """The FULL coarse-to-fine ICP pyramid on the device mesh.

    Row-shards every pyramid level's current-frame maps over all mesh
    devices; the whole 10/5/4 Gauss-Newton loop runs inside ONE
    shard_map, each iteration psum-ing the 6x7 normal equations and
    solving replicated — the mesh-wide version of estimate.cu's
    block-reduction tree + host LDLT (ref: ICPOdometry.cpp:97-135,
    estimate.cu:264-281). Round-1 gap: only a single sharded step
    existed, so tracked fusion could not run sharded end-to-end.

    Every level's height must be divisible by the mesh size (480-class
    images divide 2/3/4/5/6/8-device meshes at 3 levels).

    Returns an ICPResult (pose, error, inliers), replicated.
    """
    from ..tracking.icp import (
        ANGLE_THRESH,
        DIST_THRESH_MM,
        ICPResult,
        depth_pyramid,
        icp_step,
        icp_step_banded,
        normal_map,
        run_level,
        vertex_map,
    )

    if dist_thresh is None:
        dist_thresh = DIST_THRESH_MM
    if angle_thresh is None:
        angle_thresh = ANGLE_THRESH
    n_dev = mesh.shape["b"] * mesh.shape["r"]
    fx, fy, cx, cy = (
        intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3],
    )

    pyr_c = depth_pyramid(jnp.asarray(depth_curr, jnp.float32), levels)
    pyr_p = depth_pyramid(jnp.asarray(depth_prev, jnp.float32), levels)

    maps = []
    for lvl in range(levels):
        s = 1.0 / (1 << lvl)
        lfx, lfy, lcx, lcy = fx * s, fy * s, cx * s, cy * s
        vc = vertex_map(pyr_c[lvl], lfx, lfy, lcx, lcy)
        vp = vertex_map(pyr_p[lvl], lfx, lfy, lcx, lcy)
        nc = normal_map(vc)
        # pad the sharded (current) maps to a multiple of the mesh size
        # with NaN rows — invalid vertices contribute nothing
        pad = (-vc.shape[0]) % n_dev
        if pad:
            vc = jnp.pad(vc, ((0, pad), (0, 0), (0, 0)),
                         constant_values=jnp.nan)
            nc = jnp.pad(nc, ((0, pad), (0, 0), (0, 0)),
                         constant_values=jnp.nan)
        maps.append(
            (
                vc,
                nc,
                vp,
                normal_map(vp),
                pyr_p[lvl],
                jnp.stack(
                    [
                        jnp.asarray(v, jnp.float32)
                        for v in (lfx, lfy, lcx, lcy)
                    ]
                ),
            )
        )
    maps = tuple(maps)

    def local(maps):
        dev = (
            jax.lax.axis_index("b") * mesh.shape["r"]
            + jax.lax.axis_index("r")
        )
        pose = (
            jnp.eye(4, dtype=jnp.float32) if init_pose is None
            else jnp.asarray(init_pose, jnp.float32)
        )
        err = jnp.array(0.0, jnp.float32)
        inl = jnp.array(0.0, jnp.float32)
        # concrete 0.0 stays concrete: run_level then compiles the
        # static-count fori_loop (see tracking/icp.py)
        eps = (
            conv_eps
            if isinstance(conv_eps, (int, float))
            and float(conv_eps) == 0.0
            else jnp.asarray(conv_eps, jnp.float32)
        )
        for lvl in range(levels - 1, -1, -1):
            vc, nc, vp, np_, dp_prev, intr = maps[lvl]
            lfx, lfy, lcx, lcy = intr[0], intr[1], intr[2], intr[3]
            h_local = vc.shape[0]

            def step(pose, _lvl=lvl, _vc=vc, _nc=nc, _vp=vp, _np=np_,
                     _dp=dp_prev, _fx=lfx, _fy=lfy, _cx=lcx, _cy=lcy,
                     _h=h_local):
                if band is not None:
                    A, b, res_sq, inliers = icp_step_banded(
                        pose[0:3, 0:3], pose[0:3, 3], _vc, _nc, _dp,
                        _fx, _fy, _cx, _cy,
                        band=max(band >> _lvl, 8),
                        dist_thresh=dist_thresh, angle_thresh=angle_thresh,
                        adaptive=adaptive,
                        row_offset=dev * _h,
                    )
                else:
                    A, b, res_sq, inliers = icp_step(
                        pose[0:3, 0:3], pose[0:3, 3], _vc, _nc, _vp, _np,
                        _fx, _fy, _cx, _cy, dist_thresh, angle_thresh,
                    )
                # psum'd normal equations -> every device solves the
                # SAME system in run_level, so the early exit branches
                # together and cannot deadlock the collectives
                return (
                    jax.lax.psum(A, ("b", "r")),
                    jax.lax.psum(b, ("b", "r")),
                    jax.lax.psum(res_sq, ("b", "r")),
                    jax.lax.psum(inliers, ("b", "r")),
                )

            pose, err, inl = run_level(
                step, iterations[lvl], eps, pose, err, inl
            )
        return pose, err, inl

    shard = P(("b", "r"))
    specs = tuple(
        (shard, shard, P(), P(), P(), P()) for _ in range(levels)
    )
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(specs,),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    pose, err, inl = fn(maps)
    return ICPResult(pose=pose, error=err, inliers=inl)


def track_and_fuse_frames_sharded(
    vol: TSDFVolume,
    camera: Camera,
    frames,
    mesh: Mesh,
    use_bilateral_filter: bool = False,
    band: int | None = None,
    width: int = 640,
    height: int = 480,
    conv_eps: float = 0.0,
):
    """Full tracked KinectFusion on the device mesh: bilateral
    (replicated) -> sharded ICP pyramid vs a ray-tiled model render ->
    brick-parallel integrate. The mesh-wide analogue of
    pipelines.track_and_fuse_frames; trajectories match the
    single-device loop (tests/test_parallel_icp.py).

    The model render all-gathers the volume to every device
    (``raycast_sharded``), so each device holds the whole volume during
    the render.

    Returns (volume, camera, poses, stats) as the single-device loop.
    """
    from ..ops.bilateral import bilateral_filter

    k = camera.k
    intr = jnp.stack([k[0, 0], k[1, 1], k[0, 2], k[1, 2]])

    poses, stats = [], []
    first = True
    for depth in frames:
        depth = jnp.asarray(depth, jnp.float32)
        if use_bilateral_filter:
            depth = bilateral_filter(depth)
        if not first:
            verts, _ = raycast_sharded(
                vol, camera, mesh, width=width, height=height,
                replicate_volume_ok=True,
            )
            cam_pts = camera.world_to_camera(
                jnp.where(jnp.isfinite(verts), verts, 0.0).reshape(-1, 3)
            ).reshape(height, width, 3)
            model_depth = jnp.where(
                jnp.isfinite(verts).all(-1), cam_pts[..., 2], 0.0
            )
            res = get_incremental_transformation_sharded(
                depth, model_depth, intr, mesh, band=band,
                conv_eps=conv_eps,
            )
            camera = camera.set_pose(camera.pose @ res.pose)
            stats.append((res.error, res.inliers))
        else:
            stats.append((jnp.array(0.0), jnp.array(0.0)))
            first = False
        vol = integrate_sharded(vol, depth, camera, mesh)
        poses.append(camera.pose)
    return vol, camera, poses, stats


def extract_surface_sharded(
    vol: TSDFVolume,
    mesh: Mesh,
    max_cubes_per_brick: int = 1 << 16,
    max_vertices_per_brick: int = 1 << 18,
    use_chunked: bool = True,
    scatter_free: bool = False,
):
    """Brick-parallel marching cubes.

    Each brick extracts the cubes whose base voxel it owns, reading its
    +z neighbour's first slab via halo exchange (the reference needs a
    host-side scan between its two kernels, SURVEY.md §2.3; here the
    whole thing stays on device and parallel over bricks).

    ``scatter_free`` / ``use_chunked``: as in ops.extract_surface. The
    scatter-free chunked compaction's active-chunk cap can overflow on
    very dense surfaces independently of ``max_cubes_per_brick``;
    re-extract with ``use_chunked=False`` (full-volume sort compaction)
    when ``merge_brick_soups`` reports a chunk-capacity overflow.

    Returns a TriangleSoup-like tuple of stacked per-brick buffers:
      vertices:      (nb, max_vertices_per_brick, 3) world mm
      vertex_voxels: (nb, max_vertices_per_brick, 2) GLOBAL voxel indices
      n_vertices:    (nb,)
      overflowed:    (nb,)
    Merge on host with ``merge_brick_soups``.
    """
    from ..ops.marching_cubes import _extract_arrays
    from .halo import halo_exchange_z

    nb = mesh.shape["b"]
    Z, Y, X = vol.tsdf.shape
    if Z % nb:
        raise ValueError(
            f"Z={Z} must divide the brick axis ({nb}) for the sharded "
            "extraction"
        )
    zl = Z // nb
    ext = halo_exchange_z(vol.tsdf, mesh, halo=1)  # (Z + 2nb, Y, X)

    def local(ext_block, physical_size, offset, voxel_size):
        bi = jax.lax.axis_index("b")
        # block = [prev halo | own zl slabs | next halo]; cubes rooted in
        # own slabs need slabs [1 .. zl+1] of the block
        tsdf_loc = ext_block[1:]
        z0 = bi * zl
        local_offset = offset + jnp.array(
            [0.0, 0.0, 1.0], jnp.float32
        ) * (z0.astype(jnp.float32) * voxel_size[2])
        # last brick owns one fewer cube row (no z+1 neighbour)
        n_cube_z = jnp.where(bi == nb - 1, zl - 1, zl)
        soup = _extract_arrays(
            tsdf_loc,
            voxel_size,
            local_offset,
            max_cubes=max_cubes_per_brick,
            max_vertices=max_vertices_per_brick,
            n_cube_z=n_cube_z,
            voxel_index_base=z0 * (Y * X),
            scatter_free=scatter_free,
            use_chunked=use_chunked,
        )
        return (
            soup.vertices[None],
            soup.vertex_voxels[None],
            soup.n_vertices[None],
            soup.overflowed[None],
        )

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("b"), P(), P(), P()),
        out_specs=(P("b"), P("b"), P("b"), P("b")),
        # the matmul scatter/gather walks carry replicated-initialized
        # while_loop state that becomes device-varying after one
        # iteration, which strict VMA typing rejects
        check_vma=False,
    )
    return fn(ext, vol.physical_size, vol.offset, vol.voxel_size)


def merge_brick_soups(brick_soups):
    """Host-side: concatenate per-brick triangle soups into
    (verts (n, 3), tris (n/3, 3)) numpy arrays."""
    import numpy as np

    verts_b, _voxels_b, n_b, overflow_b = brick_soups
    if bool(np.asarray(overflow_b).any()):
        raise ValueError(
            "a brick overflowed: raise max_cubes/max_vertices_per_brick, "
            "or — if this is the chunked compaction's active-chunk cap "
            "(scatter_free on a dense surface) — re-extract with "
            "extract_surface_sharded(..., use_chunked=False)"
        )
    # one D2H each — per-brick np.asarray would re-transfer the stacked
    # buffer once per brick
    verts_np = np.asarray(verts_b)
    n_np = np.asarray(n_b)
    parts = []
    for b in range(verts_np.shape[0]):
        n = int(n_np[b])
        parts.append(verts_np[b, :n])
    verts = np.concatenate(parts, axis=0)
    n = len(verts) - len(verts) % 3
    verts = verts[:n]
    tris = np.arange(n, dtype=np.int32).reshape(-1, 3)
    return verts, tris

# ---------------------------------------------------------------------------
# Sharded SceneFusion: brick-parallel deformation-field update
# ---------------------------------------------------------------------------


def update_deformation_sharded(
    vol: TSDFVolume,
    depth: jnp.ndarray,
    camera: Camera,
    flow: jnp.ndarray,
    mesh: Mesh,
    max_cubes_per_brick: int = 1 << 16,
    threshold_mm: float | None = None,
    scatter_free: bool = False,
):
    """Brick-parallel deformation-field update (non-rigid SceneFusion on
    the device mesh; single-device semantics: pipelines/scenefusion.py,
    ref chain: SceneFusion_krnl.cu:236-401).

    Each brick extracts its own cubes (masked layout, z+1 halo slab from
    ``halo_exchange_z``), finds correspondences against the replicated
    depth frame, folds (count, flow) contributions onto cube corners and
    scatters them into a LOCAL (zl+1)-slab accumulator — corner taps of
    the brick's last cube row land in the extra halo slab, which one
    ``ppermute`` hands to the +z neighbour. Cube ownership partitions the
    mesh, so contributions never double-count; the per-voxel
    flow/usage normalisation happens after the halo merge, exactly as in
    the single-device update.

    Returns (updated volume, total correspondence count).
    """
    from ..pipelines.scenefusion import CORRESPONDENCE_THRESHOLD_MM

    if threshold_mm is None:
        threshold_mm = CORRESPONDENCE_THRESHOLD_MM
    new_deform, n_corr, overflow = _update_deformation_sharded_jit(
        vol.tsdf,
        vol.deform,
        jnp.asarray(depth, jnp.float32),
        jnp.asarray(flow, jnp.float32),
        camera,
        vol.physical_size,
        vol.offset,
        vol.voxel_size,
        mesh=mesh,
        max_cubes_per_brick=max_cubes_per_brick,
        threshold_mm=float(threshold_mm),
        scatter_free=scatter_free,
    )
    if scatter_free and bool(overflow):
        # chunked-compaction cap truncated some brick's cube list: redo
        # through the full-volume sort compaction (exact-or-skip — the
        # same fallback the single-device orchestrator takes)
        new_deform, n_corr, overflow = _update_deformation_sharded_jit(
            vol.tsdf,
            vol.deform,
            jnp.asarray(depth, jnp.float32),
            jnp.asarray(flow, jnp.float32),
            camera,
            vol.physical_size,
            vol.offset,
            vol.voxel_size,
            mesh=mesh,
            max_cubes_per_brick=max_cubes_per_brick,
            threshold_mm=float(threshold_mm),
            scatter_free=scatter_free,
            use_chunked=False,
        )
    if bool(overflow):
        import warnings

        warnings.warn(
            "update_deformation_sharded: a brick's occupied cubes "
            f"exceed max_cubes_per_brick={max_cubes_per_brick}; the "
            "deformation update was truncated — raise the cap",
            stacklevel=2,
        )
    return vol.replace(deform=new_deform), n_corr


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "max_cubes_per_brick", "threshold_mm", "scatter_free",
        "use_chunked",
    ),
)
def _update_deformation_sharded_jit(
    tsdf,
    deform,
    depth,
    flow,
    camera: Camera,
    physical_size,
    offset,
    voxel_size,
    *,
    mesh: Mesh,
    max_cubes_per_brick: int,
    threshold_mm: float,
    scatter_free: bool,
    use_chunked: bool = True,
):
    from ..ops.marching_cubes import _MAX_V, _extract_arrays
    from ..pipelines.scenefusion import (
        _cube_corner_scatter,
        _edge_correspondence,
    )
    from .halo import halo_exchange_z

    nb = mesh.shape["b"]
    Z, Y, X = tsdf.shape
    if Z % nb:
        raise ValueError(f"Z={Z} must divide the brick axis ({nb})")
    zl = Z // nb

    ext = halo_exchange_z(tsdf, mesh, halo=1)  # (Z + 2nb, Y, X)

    def local(ext_block, deform_local, depth, flow, cam, vs, off):
        bi = jax.lax.axis_index("b")
        tsdf_loc = ext_block[1:]  # own zl slabs + next's first slab
        z0 = bi * zl
        local_offset = off + jnp.array(
            [0.0, 0.0, 1.0], jnp.float32
        ) * (z0.astype(jnp.float32) * vs[2])
        # last brick owns one fewer cube row (no z+1 neighbour)
        n_cube_z = jnp.where(bi == nb - 1, zl - 1, zl)
        soup, (cid, edge_idx, cube_valid, edge_verts) = _extract_arrays(
            tsdf_loc,
            vs,
            local_offset,
            max_cubes=max_cubes_per_brick,
            max_vertices=1,  # unused by the masked layout
            n_cube_z=n_cube_z,
            layout="masked",
            scatter_free=scatter_free,
            return_cube_slots=True,
            use_chunked=use_chunked,
            return_edge_verts=True,
        )
        overflow = jax.lax.psum(
            soup.overflowed.astype(jnp.int32), "b"
        ) > 0
        # per-EDGE correspondence: gather depth/flow once per cube edge
        # and distribute to the 24 slots — identical math, half the
        # gathers
        corr, flow_at_vert = _edge_correspondence(
            soup, edge_idx, edge_verts, depth, cam, flow, threshold_mm
        )
        n_corr = jax.lax.psum(jnp.sum(corr.astype(jnp.int32)), "b")

        C = cid.shape[0]
        contrib = jnp.concatenate(
            [soup.valid.astype(jnp.float32)[:, None], flow_at_vert],
            axis=-1,
        ).reshape(C, _MAX_V, 4)
        acc = _cube_corner_scatter(
            contrib, cid, edge_idx, cube_valid, (zl + 1, Y, X)
        )  # (4, (zl+1)*Y*X) — last slab = contributions for next brick
        own = acc[:, : zl * Y * X]
        halo = acc[:, zl * Y * X :]  # (4, Y*X)
        recv = jax.lax.ppermute(
            halo, "b", [(i, (i + 1) % nb) for i in range(nb)]
        )
        # the last brick emits no halo contributions (its final cube row
        # is masked), so brick 0's wrap-around receive is zero; guard it
        # anyway for robustness
        recv = jnp.where(bi == 0, jnp.zeros_like(recv), recv)
        own = jnp.concatenate(
            [own[:, : Y * X] + recv, own[:, Y * X :]], axis=1
        )
        counts = own[0]
        delta = own[1:4] / jnp.maximum(counts, 1.0)[None, :]
        new_local = deform_local + delta.T.reshape(zl, Y, X, 3)
        return new_local, n_corr[None], overflow[None]

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("b"), P("b"), P(), P(), P(), P(), P()),
        out_specs=(P("b"), P("b"), P("b")),
        check_vma=False,
    )
    new_deform, n_corr_b, overflow_b = fn(
        ext, deform, depth, flow, camera, voxel_size, offset
    )
    # every brick psum'd the same total; "b"-stacked copies are equal
    return new_deform, n_corr_b[0], overflow_b[0]


def scenefusion_frame_sharded(
    vol: TSDFVolume,
    depth: jnp.ndarray,
    camera: Camera,
    flow: jnp.ndarray,
    mesh: Mesh,
    max_cubes_per_brick: int = 1 << 16,
    threshold_mm: float | None = None,
    scatter_free: bool = False,
):
    """One non-rigid SceneFusion frame on the device mesh: brick-parallel
    deformation update (``update_deformation_sharded``) followed by the
    brick-parallel deformed-volume integrate. The mesh analogue of the
    single-device fused step (pipelines/scenefusion.py:_sf_step;
    ref loop: SceneFusion.cpp:84-185).

    Returns (updated volume, total correspondence count).
    """
    vol, n_corr = update_deformation_sharded(
        vol, depth, camera, flow, mesh,
        max_cubes_per_brick=max_cubes_per_brick,
        threshold_mm=threshold_mm,
        scatter_free=scatter_free,
    )
    return integrate_sharded(vol, depth, camera, mesh), n_corr


def integrate_pose_sharded(
    vol: TSDFVolume,
    depth: jnp.ndarray,
    camera: Camera,
    delta: jnp.ndarray,
    mesh: Mesh,
    cap_weight: bool = False,
    image_term: bool = True,
) -> TSDFVolume:
    """Differentiable fusion w.r.t. pose on the device mesh.

    Forward: brick-parallel integrate at pose ``se3_exp(delta) @
    camera.pose``. Backward: each brick runs the pose adjoint
    (ops/integrate_diff.py:pose_adjoint) on its slab and the pose_inv
    matrix cotangent all-reduces over the brick axis — the distributed
    training-step shape (gradient psum); ``se3_exp`` / the 4x4 inverse
    chain by ordinary AD so jax.grad is exact at any delta. Volume
    cotangents stay brick-local. Semantics: ops/integrate_diff.py:
    integrate_pose.

    Returns the fused volume, differentiable in ``delta`` (and the
    volume). Rigid volumes only.
    """
    from ..utils.se3 import se3_exp

    if vol.deform is not None:
        raise ValueError(
            "integrate_pose_sharded is the rigid path: pass a volume "
            "without a deformation field"
        )
    pose = se3_exp(delta) @ camera.pose
    pose_inv = jnp.linalg.inv(pose)
    return _integrate_core_sharded(
        vol, jnp.asarray(depth, jnp.float32), camera.k, pose_inv,
        mesh, cap_weight, image_term,
    )


@partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6))
def _integrate_core_sharded(
    vol, depth, k, pose_inv, mesh, cap_weight, image_term
):
    from ..ops.integrate_diff import camera_from_inv

    return _integrate_sharded_jit(
        vol, depth, camera_from_inv(k, pose_inv), None, mesh=mesh,
        cap_weight=cap_weight,
    )


def _integrate_core_sharded_fwd(
    vol, depth, k, pose_inv, mesh, cap_weight, image_term
):
    out = _integrate_core_sharded(
        vol, depth, k, pose_inv, mesh, cap_weight, image_term
    )
    return out, (vol, depth, k, pose_inv)


@partial(jax.jit, static_argnames=("mesh", "cap_weight", "image_term"))
def _pose_grad_sharded_jit(
    vol, depth, k, pose_inv, gbar_d, gbar_w, *, mesh, cap_weight,
    image_term,
):
    from ..ops.integrate_diff import pose_adjoint

    nb = mesh.shape["b"]

    def local(tsdf, weight, gbar_d, gbar_w, depth, k, pose_inv,
              physical_size, offset, trunc, max_weight):
        lvol = _local_slab_volume(
            tsdf, weight, None, physical_size, offset, trunc, max_weight,
            nb,
        )
        dd, dw, dpinv = pose_adjoint(
            lvol, depth, k, pose_inv, gbar_d, gbar_w,
            cap_weight=cap_weight, image_term=image_term,
        )
        return dd, dw, jax.lax.psum(dpinv, "b")[None]

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P("b"), P("b"), P("b"), P("b"), P(), P(), P(), P(), P(), P(),
            P(),
        ),
        out_specs=(P("b"), P("b"), P("b")),
        check_vma=False,
    )
    dd, dw, dpinv_b = fn(
        vol.tsdf, vol.weight,
        jnp.asarray(gbar_d, jnp.float32),
        jnp.asarray(gbar_w, jnp.float32),
        depth, k, pose_inv, vol.physical_size, vol.offset,
        vol.truncation_distance, vol.max_weight,
    )
    return dd, dw, dpinv_b[0]  # psum'd: every brick holds the total


def _integrate_core_sharded_bwd(mesh, cap_weight, image_term, res, gvol):
    vol, depth, k, pose_inv = res
    dd, dw, dpinv = _pose_grad_sharded_jit(
        vol, depth, k, pose_inv, gvol.tsdf, gvol.weight,
        mesh=mesh, cap_weight=cap_weight, image_term=image_term,
    )
    # identity pass-through fields keep their output cotangent (see
    # ops/integrate_diff.py:_integrate_core_bwd)
    vol_cot = gvol.replace(
        tsdf=dd.astype(vol.tsdf.dtype), weight=dw.astype(vol.weight.dtype)
    )
    return vol_cot, jnp.zeros_like(depth), jnp.zeros_like(k), dpinv


_integrate_core_sharded.defvjp(
    _integrate_core_sharded_fwd, _integrate_core_sharded_bwd
)
