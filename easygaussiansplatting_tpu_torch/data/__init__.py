from easygaussiansplatting_tpu_torch.data.fixtures import example_camera, example_gaussians
from easygaussiansplatting_tpu_torch.data.gau_io import load_gs, load_ply

__all__ = ["example_gaussians", "example_camera", "load_gs", "load_ply"]
