"""TUM RGB-D dataset loader.

Host-side twin of the reference ``TUMDataLoader``
(ref: src/DataLoader/TUMDataLoader.cpp:12-140): parses
``<dir>/ground_truth.txt`` lines ``timestamp tx ty tz qx qy qz qw``,
loads ``<dir>/depth/<timestamp>.png``, scales TUM depth (1/5000 m units)
to mm (x 0.2, ref: :96-98), and converts the 7-float pose to a 4x4
camera->world matrix with translation in mm (ref: to_pose :47-76).
"""

from __future__ import annotations

import os

import numpy as np

from .depth_image import DepthImage


def tum_pose_matrix(vars7) -> np.ndarray:
    """7 floats (tx ty tz qx qy qz qw, metres) -> 4x4 pose, mm.

    ref: TUMDataLoader::to_pose TUMDataLoader.cpp:47-76 — standard unit
    quaternion to rotation matrix, translation x 1000.
    """
    tx, ty, tz, x, y, z, w = [float(v) for v in vars7]
    pose = np.zeros((4, 4), dtype=np.float32)
    pose[0, 0] = 1 - 2 * (y * y + z * z)
    pose[0, 1] = 2 * (x * y - w * z)
    pose[0, 2] = 2 * (x * z + w * y)
    pose[1, 0] = 2 * (x * y + w * z)
    pose[1, 1] = 1 - 2 * (x * x + z * z)
    pose[1, 2] = 2 * (y * z - w * x)
    pose[2, 0] = 2 * (x * z - w * y)
    pose[2, 1] = 2 * (y * z + w * x)
    pose[2, 2] = 1 - 2 * (x * x + y * y)
    pose[0, 3] = tx * 1000.0
    pose[1, 3] = ty * 1000.0
    pose[2, 3] = tz * 1000.0
    pose[3, 3] = 1.0
    return pose


class TUMDataLoader:
    """Iterates (DepthImage, pose 4x4) pairs from a TUM directory."""

    def __init__(self, directory: str):
        """Parse ground_truth.txt (ref: TUMDataLoader.cpp:12-29,111-140)."""
        self.directory = directory
        self.entries: list[tuple[str, np.ndarray]] = []
        gt = os.path.join(directory, "ground_truth.txt")
        with open(gt) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) != 8:
                    continue
                stamp = parts[0]
                depth_path = os.path.join(
                    directory, "depth", f"{stamp}.png"
                )
                self.entries.append(
                    (depth_path, tum_pose_matrix(parts[1:8]))
                )
        self._cursor = 0

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        # Prefetch-decode frames ahead of the consumer with the native
        # threaded loader when it is available (tsdf_tpu/native) — the
        # host feeding pipeline overlaps device compute.
        from .. import native

        if len(self.entries) > 1 and native.available():
            # The prefetcher decodes strictly native 16-bit-grey PNGs
            # (bit-identical to the io/png.py fallback); any other format
            # errors per-frame and is loaded through the fallback path
            # instead, so both loaders always agree.
            pf = native.PNGPrefetcher([p for p, _ in self.entries])
            try:
                for i, (path, pose) in enumerate(self.entries):
                    try:
                        frame = pf.get(i)
                        yield DepthImage(frame).scale_depth(0.2), pose
                    except IOError:
                        yield self._load(path), pose
            finally:
                pf.close()
            return
        for depth_path, pose in self.entries:
            yield self._load(depth_path), pose

    def next(self):
        """(DepthImage, pose) or (None, None) at end
        (ref: TUMDataLoader::next TUMDataLoader.cpp:84-108)."""
        if self._cursor >= len(self.entries):
            return None, None
        depth_path, pose = self.entries[self._cursor]
        self._cursor += 1
        return self._load(depth_path), pose

    @staticmethod
    def _load(depth_path: str) -> DepthImage:
        # TUM depth PNGs are in 1/5000 m; x 0.2 converts to mm
        # (ref: TUMDataLoader.cpp:96-98).
        return DepthImage.from_png(depth_path).scale_depth(0.2)

    def iter_with_rgb(self):
        """Yield (DepthImage, pose, rgb | None) triples.

        The reference loader is depth-only (its colour arrays are never
        written, SURVEY §2.1); this framework fuses colour, so the same
        simplified TUM layout is extended with ``rgb/<stamp>.png``
        (u8 RGB) sharing the depth frame's timestamp. Missing rgb files
        yield None for that frame.
        """
        from .png import load_png

        for depth_path, pose in self.entries:
            stamp = os.path.splitext(os.path.basename(depth_path))[0]
            rgb_path = os.path.join(
                self.directory, "rgb", f"{stamp}.png"
            )
            rgb = None
            if os.path.exists(rgb_path):
                img = load_png(rgb_path)
                if img.ndim == 2:  # greyscale: broadcast to RGB
                    img = np.repeat(img[..., None], 3, axis=-1)
                rgb = img[..., :3].astype(np.uint8)
            yield self._load(depth_path), pose, rgb
