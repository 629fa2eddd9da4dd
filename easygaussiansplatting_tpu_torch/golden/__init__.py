"""The float64 NumPy oracle: a copy of easygaussiansplatting_tpu/golden/ kept
in the port, so that the port's gradient gate runs where JAX is not
installed (golden/model.py says more)."""

from easygaussiansplatting_tpu_torch.golden.model import (
    MIN_DEPTH,
    compute_cov2d,
    compute_cov3d,
    inverse_cov2d,
    project,
    render,
    render_tiles,
    sh2color,
    tile_lists,
)
from easygaussiansplatting_tpu_torch.golden.numdiff import check, numerical_derivative

__all__ = [
    "MIN_DEPTH",
    "project",
    "compute_cov3d",
    "compute_cov2d",
    "sh2color",
    "inverse_cov2d",
    "tile_lists",
    "render_tiles",
    "render",
    "numerical_derivative",
    "check",
]
