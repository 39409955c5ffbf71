"""KITTI raw-data IO: calibration, labels, road planes, scene access.

The port's copy of `ssd3d/data/kitti_io.py` (numpy only;
tests/test_torch_data.py holds the two to the same outputs).

Behavior parity with the reference's kitti_util.py / kitti_object.py (itself
derived from the public frustum-pointnets helpers): velo->rect is
R0 @ (V2C @ [x|1]); labels give bottom-face centers in rect coords; planes
are normalized with the normal facing up (-y).

No cv2/TF dependencies: image sizes are read from PNG headers directly.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np


class Calibration:
    """Projection matrices for one KITTI frame.

    P2: rect -> image2; V2C: velo -> camera reference; R0: ref -> rect.
    """

    def __init__(self, P2: np.ndarray, V2C: np.ndarray, R0: np.ndarray):
        self.P = P2.reshape(3, 4).astype(np.float32)
        self.V2C = V2C.reshape(3, 4).astype(np.float32)
        self.R0 = R0.reshape(3, 3).astype(np.float32)
        inv = np.zeros_like(self.V2C)
        inv[:, :3] = self.V2C[:, :3].T
        inv[:, 3] = -self.V2C[:, :3].T @ self.V2C[:, 3]
        self.C2V = inv
        self.c_u, self.c_v = self.P[0, 2], self.P[1, 2]
        self.f_u, self.f_v = self.P[0, 0], self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

    @classmethod
    def from_file(cls, path: str) -> "Calibration":
        mats = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key, _, value = line.partition(":")
                try:
                    mats[key.strip()] = np.array(
                        [float(x) for x in value.split()]
                    )
                except ValueError:
                    continue
        return cls(mats["P2"], mats["Tr_velo_to_cam"], mats["R0_rect"])

    def _hom(self, pts: np.ndarray) -> np.ndarray:
        return np.hstack([pts, np.ones((pts.shape[0], 1), pts.dtype)])

    def velo_to_rect(self, pts: np.ndarray) -> np.ndarray:
        ref = self._hom(pts) @ self.V2C.T
        return ref @ self.R0.T

    def rect_to_velo(self, pts: np.ndarray) -> np.ndarray:
        ref = pts @ np.linalg.inv(self.R0).T
        return self._hom(ref) @ self.C2V.T

    def rect_to_image(self, pts: np.ndarray) -> np.ndarray:
        uvw = self._hom(pts) @ self.P.T
        return uvw[:, 0:2] / uvw[:, 2:3]

    def image_to_rect(self, uv_depth: np.ndarray) -> np.ndarray:
        z = uv_depth[:, 2]
        x = (uv_depth[:, 0] - self.c_u) * z / self.f_u + self.b_x
        y = (uv_depth[:, 1] - self.c_v) * z / self.f_v + self.b_y
        return np.stack([x, y, z], axis=1)


@dataclass
class KittiLabel:
    """One object line from a KITTI label_2 file."""

    type: str
    truncation: float
    occlusion: int
    alpha: float
    box2d: np.ndarray  # [x1, y1, x2, y2]
    h: float
    w: float
    l: float  # noqa: E741
    t: tuple  # bottom-face center in rect coords
    ry: float
    score: float = -1.0

    @property
    def box_3d(self) -> np.ndarray:
        """[x, y, z, l, h, w, ry] (our framework-wide box convention)."""
        return np.array(
            [*self.t, self.l, self.h, self.w, self.ry], np.float32
        )


def parse_label_line(line: str) -> KittiLabel:
    f = line.strip().split(" ")
    vals = [float(x) for x in f[1:]]
    return KittiLabel(
        type=f[0],
        truncation=vals[0],
        occlusion=int(vals[1]),
        alpha=vals[2],
        box2d=np.array(vals[3:7], np.float32),
        h=vals[7], w=vals[8], l=vals[9],
        t=(vals[10], vals[11], vals[12]),
        ry=vals[13],
        score=vals[14] if len(vals) > 14 else -1.0,
    )


def read_labels(path: str) -> list[KittiLabel]:
    with open(path) as f:
        return [parse_label_line(line) for line in f if line.strip()]


def read_plane(path: str) -> np.ndarray:
    """Road plane coefficients, normal forced upward (-y), unit-normalized."""
    with open(path) as f:
        lines = f.readlines()
    plane = np.array([float(x) for x in lines[3].split()])
    if plane[1] > 0:
        plane = -plane
    return plane / np.linalg.norm(plane[0:3])


def read_velo(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def png_size(path: str) -> tuple[int, int]:
    """(height, width) from the PNG IHDR chunk — no image decode needed."""
    with open(path, "rb") as f:
        header = f.read(24)
    if header[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG: {path}")
    width, height = struct.unpack(">II", header[16:24])
    return height, width


class KittiScene:
    """File access for one KITTI object split (reference kitti_object.py)."""

    def __init__(self, root_dir: str, split: str = "training"):
        self.split_dir = os.path.join(root_dir, split)
        self.has_labels = split == "training"

    def _p(self, sub: str, idx: int, ext: str) -> str:
        return os.path.join(self.split_dir, sub, f"{idx:06d}.{ext}")

    def lidar(self, idx: int) -> np.ndarray:
        return read_velo(self._p("velodyne", idx, "bin"))

    def calib(self, idx: int) -> Calibration:
        return Calibration.from_file(self._p("calib", idx, "txt"))

    def labels(self, idx: int) -> list[KittiLabel]:
        return read_labels(self._p("label_2", idx, "txt"))

    def plane(self, idx: int) -> np.ndarray:
        return read_plane(self._p("planes", idx, "txt"))

    def image_size(self, idx: int) -> tuple[int, int]:
        return png_size(self._p("image_2", idx, "png"))
