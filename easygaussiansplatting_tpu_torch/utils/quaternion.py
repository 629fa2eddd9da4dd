"""Quaternion utilities (wxyz convention) on torch tensors.

Port of ``quaternion_to_matrix`` and ``rotate_vector_by_quaternion`` from
easygaussiansplatting_tpu/utils/quaternion.py, with the same expressions.
"""

import torch


def quaternion_to_matrix(q):
    """Batched unit quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - z * w),
                     2.0 * (x * z + y * w)], dim=-1),
        torch.stack([2.0 * (x * y + z * w), 1.0 - 2.0 * (x * x + z * z),
                     2.0 * (y * z - x * w)], dim=-1),
        torch.stack([2.0 * (x * z - y * w), 2.0 * (y * z + x * w),
                     1.0 - 2.0 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rotate_vector_by_quaternion(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4), wxyz, normalised
    first: v' = 2 u (u . v) + v (s^2 - u . u) + 2 s (u x v)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    s = q[..., 0:1]
    u = q[..., 1:4]
    udotv = torch.sum(u * v, dim=-1, keepdim=True)
    return (2.0 * u * udotv + v * (s * s - torch.sum(u * u, dim=-1, keepdim=True))
            + 2.0 * s * torch.linalg.cross(u, v, dim=-1))
