from easygaussiansplatting_tpu_torch.models.camera import Camera

__all__ = ["Camera"]
