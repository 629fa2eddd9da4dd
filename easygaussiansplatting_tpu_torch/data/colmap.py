"""COLMAP binary sparse-model readers and writers.

Port of easygaussiansplatting_tpu/data/colmap.py: self-contained
struct-based parsers for COLMAP's documented binary format (cameras.bin /
images.bin / points3D.bin), and the writers the tests and tooling use. Pure
``struct`` and numpy, so it is the JAX module's code with the port's own
imports: the JAX module cannot be imported here, because its package's
``__init__`` imports jax.
"""

import dataclasses
import struct

import numpy as np

# model_id -> (name, num_params); COLMAP's camera model table
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclasses.dataclass(frozen=True)
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # fx [fy] cx cy [distortion...]

    @property
    def intrinsics(self):
        """(fx, fy, cx, cy); distortion is ignored (reference does the same,
        gausplat_dataset.py:40-46)."""
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            f, cx, cy = self.params[:3]
            return float(f), float(f), float(cx), float(cy)
        fx, fy, cx, cy = self.params[:4]
        return float(fx), float(fy), float(cx), float(cy)


@dataclasses.dataclass(frozen=True)
class ColmapImage:
    id: int
    qvec: np.ndarray  # wxyz, world->camera
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(q):
    """wxyz quaternion -> rotation matrix (world->camera)."""
    w, x, y, z = (float(v) for v in q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cameras[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cameras


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<i4d3di")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            chars = bytearray()
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                chars.extend(c)
            (n_p2d,) = _read(f, "<Q")
            f.seek(24 * n_p2d, 1)  # skip (x f8, y f8, point3D_id i8) per point
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, chars.decode("utf-8")
            )
    return images


def read_points3d_binary(path):
    """Returns (xyz [N,3] f64, rgb [N,3] u8, error [N] f64)."""
    xyzs, rgbs, errors = [], [], []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<Q3d3Bd")
            xyzs.append(vals[1:4])
            rgbs.append(vals[4:7])
            errors.append(vals[7])
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, 1)  # skip (image_id i4, point2D_idx i4)
    return (
        np.array(xyzs, np.float64).reshape(-1, 3),
        np.array(rgbs, np.uint8).reshape(-1, 3),
        np.array(errors, np.float64),
    )


# ----------------------------------------------------------------- writers
# (test fixtures + tooling; the reference only reads)


def write_cameras_binary(path, cameras):
    name_to_id = {v[0]: k for k, v in CAMERA_MODELS.items()}
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id = name_to_id[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(path, images):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i4d3di", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path, xyz, rgb, error=None):
    xyz = np.asarray(xyz, np.float64)
    rgb = np.asarray(rgb, np.uint8)
    error = np.zeros(len(xyz)) if error is None else np.asarray(error, np.float64)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<Q3d3Bd", i + 1, *xyz[i], *rgb[i], error[i]))
            f.write(struct.pack("<Q", 0))
