"""Pinhole camera as a differentiable JAX pytree.

Re-design of the reference's host-side ``Camera`` class
(ref: src/Camera.cpp:1-391, src/include/Camera.hpp:17-215) and the CUDA
device transforms (ref: src/Utilities/cuda_coordinate_transforms.cu:10-160).

Conventions (identical to the reference so arrays compare 1:1):
  * units are millimetres everywhere;
  * ``k`` is the 3x3 intrinsic matrix [[fx,0,cx],[0,fy,cy],[0,0,1]];
  * ``pose`` is the 4x4 camera->world matrix; ``pose_inv`` its inverse;
  * pixel x = column, pixel y = row; depth images are (H, W) arrays;
  * point batches have trailing dimension 3: shape (..., 3).

Unlike the reference every transform here is a pure function of pytree
leaves, so gradients w.r.t. pose and intrinsics exist by construction.
"""

from __future__ import annotations

import jax.numpy as jnp

from .struct import pytree_dataclass

# Kinect / TUM fr1 defaults (ref: src/include/Camera.hpp:41-44).
DEFAULT_FX = 591.1
DEFAULT_FY = 590.1
DEFAULT_CX = 331.0
DEFAULT_CY = 234.6


@pytree_dataclass
class Camera:
    """Intrinsics + extrinsics; all four matrices kept for cheap reuse."""

    k: jnp.ndarray  # (3, 3) f32
    k_inv: jnp.ndarray  # (3, 3) f32
    pose: jnp.ndarray  # (4, 4) f32, camera->world
    pose_inv: jnp.ndarray  # (4, 4) f32, world->camera

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_intrinsics(fx, fy, cx, cy, pose=None) -> "Camera":
        """ref: Camera::Camera(float,float,float,float) src/Camera.cpp:33-44."""
        k = jnp.array(
            [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=jnp.float32
        )
        return Camera.from_k(k, pose)

    @staticmethod
    def from_k(k, pose=None) -> "Camera":
        k = jnp.asarray(k, dtype=jnp.float32)
        if pose is None:
            pose = jnp.eye(4, dtype=jnp.float32)
        pose = jnp.asarray(pose, dtype=jnp.float32)
        return Camera(
            k=k,
            k_inv=jnp.linalg.inv(k),
            pose=pose,
            pose_inv=jnp.linalg.inv(pose),
        )

    @staticmethod
    def default_depth_camera(pose=None) -> "Camera":
        """ref: Camera::default_depth_camera src/include/Camera.hpp:41-44."""
        return Camera.from_intrinsics(
            DEFAULT_FX, DEFAULT_FY, DEFAULT_CX, DEFAULT_CY, pose
        )

    # -- pose manipulation -------------------------------------------------

    def set_pose(self, pose) -> "Camera":
        """ref: Camera::set_pose src/Camera.cpp:108-111."""
        pose = jnp.asarray(pose, dtype=jnp.float32)
        return self.replace(pose=pose, pose_inv=jnp.linalg.inv(pose))

    def move_to(self, xyz) -> "Camera":
        """Translate, keeping orientation (ref: src/Camera.cpp:129-135)."""
        pose = self.pose.at[0:3, 3].set(jnp.asarray(xyz, dtype=jnp.float32))
        return self.set_pose(pose)

    def look_at(self, target) -> "Camera":
        """gluLookAt-style basis with +Y up and degenerate up/down handling.

        ref: Camera::look_at src/Camera.cpp:142-204 — pose columns become
        [left, up, forward] with forward = normalize(target - position).
        """
        target = jnp.asarray(target, dtype=jnp.float32)
        eps = 1e-6
        position = self.pose[0:3, 3]
        forward = target - position
        forward = forward / jnp.linalg.norm(forward)
        straight = (jnp.abs(forward[0]) < eps) & (jnp.abs(forward[2]) < eps)
        up = jnp.where(
            straight,
            jnp.where(
                forward[1] < 0,
                jnp.array([0.0, 0.0, 1.0], jnp.float32),
                jnp.array([0.0, 0.0, -1.0], jnp.float32),
            ),
            jnp.array([0.0, 1.0, 0.0], jnp.float32),
        )
        left = jnp.cross(up, forward)
        left = left / jnp.linalg.norm(left)
        up = jnp.cross(forward, left)
        up = up / jnp.linalg.norm(up)
        pose = jnp.eye(4, dtype=jnp.float32)
        pose = pose.at[0:3, 0].set(left)
        pose = pose.at[0:3, 1].set(up)
        pose = pose.at[0:3, 2].set(forward)
        pose = pose.at[0:3, 3].set(position)
        return self.set_pose(pose)

    # -- accessors ---------------------------------------------------------

    @property
    def position(self) -> jnp.ndarray:
        """Camera centre in world coordinates (ref: src/Camera.cpp:214-216)."""
        return self.pose[0:3, 3]

    @property
    def rotation(self) -> jnp.ndarray:
        """Camera->world rotation block."""
        return self.pose[0:3, 0:3]

    # -- transforms (all broadcast over leading dims) ----------------------

    def pixel_to_image_plane(self, pixels) -> jnp.ndarray:
        """(..., 2) pixels -> (..., 2) normalized image-plane coords.

        ref: Camera::pixel_to_image_plane src/Camera.cpp:229-252.
        """
        pixels = jnp.asarray(pixels, dtype=jnp.float32)
        homo = jnp.concatenate(
            [pixels, jnp.ones_like(pixels[..., :1])], axis=-1
        )
        cam = homo @ self.k_inv.T
        return cam[..., 0:2] / cam[..., 2:3]

    def image_plane_to_pixel(self, coords) -> jnp.ndarray:
        """(..., 2) image-plane -> (..., 2) rounded pixel coords.

        ref: Camera::image_plane_to_pixel src/Camera.cpp:259-269.
        """
        coords = jnp.asarray(coords, dtype=jnp.float32)
        homo = jnp.concatenate(
            [coords, jnp.ones_like(coords[..., :1])], axis=-1
        )
        img = homo @ self.k.T
        return jnp.round(img[..., 0:2])

    def camera_to_world(self, points) -> jnp.ndarray:
        """(..., 3) camera-space -> world (ref: src/Camera.cpp:278-285)."""
        points = jnp.asarray(points, dtype=jnp.float32)
        r = points @ self.pose[0:3, 0:3].T + self.pose[0:3, 3]
        w = points @ self.pose[3:4, 0:3].T + self.pose[3, 3]
        return r / w

    def world_to_camera(self, points) -> jnp.ndarray:
        """(..., 3) world -> camera space (ref: src/Camera.cpp:302-310,
        device twin cuda_coordinate_transforms.cu:105-125)."""
        points = jnp.asarray(points, dtype=jnp.float32)
        r = points @ self.pose_inv[0:3, 0:3].T + self.pose_inv[0:3, 3]
        w = points @ self.pose_inv[3:4, 0:3].T + self.pose_inv[3, 3]
        return r / w

    def world_to_camera_normal(self, normals) -> jnp.ndarray:
        """Rotate world normals into camera frame (ref: src/Camera.cpp:292-294)."""
        normals = jnp.asarray(normals, dtype=jnp.float32)
        return normals @ self.pose_inv[0:3, 0:3].T

    def world_to_pixel(self, points) -> jnp.ndarray:
        """(..., 3) world -> (..., 2) rounded pixel coords.

        K @ (pose_inv @ p), perspective divide, round — the exact op the
        integrate kernel uses (ref: cuda_coordinate_transforms.cu:10-30,
        host twin src/Camera.cpp:317-338).
        """
        cam = self.world_to_camera(points)
        img = cam @ self.k.T
        return jnp.round(img[..., 0:2] / img[..., 2:3])

    def camera_to_pixel(self, points) -> jnp.ndarray:
        """(..., 3) camera-space -> (..., 2) rounded pixels.

        NOTE the reference's device version has a live bug (it projects to
        the image plane and then multiplies the already-updated x into y,
        ref: cuda_coordinate_transforms.cu:71-96 where ``image_x`` is
        reassigned before computing ``image_y``). We implement the intended
        math: K @ (x/z, y/z, 1).
        """
        points = jnp.asarray(points, dtype=jnp.float32)
        img = points[..., 0:2] / points[..., 2:3]
        homo = jnp.concatenate([img, jnp.ones_like(img[..., :1])], axis=-1)
        pix = homo @ self.k.T
        return jnp.round(pix[..., 0:2])

    def pixel_to_camera(self, pixels, depth) -> jnp.ndarray:
        """(..., 2) pixels + (...,) depth -> (..., 3) camera-space points.

        depth * K^-1 @ (x, y, 1): ref cuda_coordinate_transforms.cu:128-160.
        Since K^-1's bottom row is (0,0,1), result.z == depth exactly.
        """
        pixels = jnp.asarray(pixels, dtype=jnp.float32)
        depth = jnp.asarray(depth, dtype=jnp.float32)
        homo = jnp.concatenate(
            [pixels, jnp.ones_like(pixels[..., :1])], axis=-1
        )
        plane = homo @ self.k_inv.T
        return plane * depth[..., None]

    def pixel_to_world(self, pixels, depth) -> jnp.ndarray:
        """ref: cuda_coordinate_transforms.cu:36-69."""
        return self.camera_to_world(self.pixel_to_camera(pixels, depth))

    # -- depth-map geometry ------------------------------------------------

    def depth_map_to_vertices(self, depth) -> tuple[jnp.ndarray, jnp.ndarray]:
        """(H, W) depth in mm -> ((H, W, 3) camera-space vertices, mask).

        Zero depth yields an invalid vertex (mask False). The reference
        marks those with a BAD_VERTEX float-max sentinel
        (ref: src/Camera.cpp:336-390, src/Definitions.cpp:13-15); we return
        an explicit boolean mask instead and keep vertices finite (0).
        """
        depth = jnp.asarray(depth, dtype=jnp.float32)
        h, w = depth.shape
        ys, xs = jnp.mgrid[0:h, 0:w]
        pixels = jnp.stack([xs, ys], axis=-1).astype(jnp.float32)
        verts = self.pixel_to_camera(pixels, depth)
        mask = depth > 0
        return jnp.where(mask[..., None], verts, 0.0), mask
