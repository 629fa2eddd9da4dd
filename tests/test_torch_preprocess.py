"""PyTorch port: K1's plain version (through the K1 wrapper on CPU tensors)
against the JAX fused preprocess run through the Pallas interpreter (which
runs ``_fwd_kernel``), at the edges of the CUDA kernel's 128-gaussian
blocks and at SH degrees 0, 3 and 5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.data import example_camera
from easygaussiansplatting_tpu.models import Camera as JaxCamera
from easygaussiansplatting_tpu.ops.pallas.preprocess import fused_preprocess as jax_fused
from easygaussiansplatting_tpu_torch.data.fixtures import PRE_EDGES, preprocess_case
from easygaussiansplatting_tpu_torch.models.convert import camera_from_numpy
from easygaussiansplatting_tpu_torch.ops import stages
from easygaussiansplatting_tpu_torch.ops.kernels import preprocess

torch.set_num_threads(2)

KEYS = ("pws", "shs", "alphas", "scales", "rots")
JCAM = JaxCamera.from_dict(example_camera())
CAM = camera_from_numpy(JCAM)
# the extents are ceil()s of a float; one ulp moves one only where the
# pre-ceil value sits on an integer
EXTENT_EDGE = 1e-4


@pytest.mark.parametrize("deg", [0, 3, 5])
@pytest.mark.parametrize("n", PRE_EDGES)
def test_plain_matches_jax_fused_at_block_edges(n, deg):
    """Every float output within 2e-5 (abs or rel) of the interpreted
    Pallas kernel's, the visibility mask equal, and the extents equal
    except where the pre-ceil value lies within EXTENT_EDGE of an
    integer."""
    d = preprocess_case(n, deg)
    want = jax_fused(*(jnp.asarray(d[k]) for k in KEYS), JCAM, sh_degree=deg, interpret=True)
    args = [torch.from_numpy(d[k]) for k in KEYS]
    table = preprocess.preprocess_fwd(*args, CAM, sh_degree=deg)  # CPU: the plain version
    got = preprocess.table_views(table, args[2])
    for key in ("us", "cinv2ds", "colors", "alphas", "depths"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-5,
                                   rtol=2e-5, err_msg=key)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    cov2d = stages.preprocess(*args, CAM, sh_degree=deg)["cov2ds"][:, [0, 2]].numpy()
    pre_ceil = 3.0 * np.sqrt(np.abs(cov2d))
    near_int = np.abs(pre_ceil - np.round(pre_ceil)) < EXTENT_EDGE
    same = got["areas"].numpy() == np.asarray(want["areas"])
    assert np.all(same | near_int)
