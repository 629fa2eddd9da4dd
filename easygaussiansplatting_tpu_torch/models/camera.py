"""Camera model.

Port of easygaussiansplatting_tpu/models/camera.py: a pinhole camera with
world->camera extrinsics. The leaves stay on the host as float32 numpy
values, as the JAX ``Camera.from_dict`` keeps them: the stages read them as
float32 scalars and the CUDA preprocess kernel takes them by value, so a
camera never needs a device copy.
"""

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Camera:
    Rcw: np.ndarray  # [3,3] float32 world->camera rotation
    tcw: np.ndarray  # [3] float32 world->camera translation
    fx: np.float32
    fy: np.float32
    cx: np.float32
    cy: np.float32
    width: int
    height: int
    id: int = 0

    @property
    def twc(self):
        """Camera center in world coordinates: -Rcw^T tcw, computed in float32
        exactly as the JAX camera does for host leaves (another derivation
        drifts the SH view direction)."""
        return -np.swapaxes(self.Rcw, -1, -2) @ self.tcw

    @staticmethod
    def from_dict(d, dtype=np.float32):
        return Camera(
            Rcw=np.asarray(d["Rcw"], dtype),
            tcw=np.asarray(d["tcw"], dtype),
            fx=np.asarray(d["fx"], dtype),
            fy=np.asarray(d["fy"], dtype),
            cx=np.asarray(d["cx"], dtype),
            cy=np.asarray(d["cy"], dtype),
            width=int(d["width"]),
            height=int(d["height"]),
            id=int(d.get("id", 0)),
        )
