"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the CPU only when
the caller asks for it. A CUDA request on a machine without a usable CUDA
device raises instead of quietly running somewhere else.
"""

import torch


def resolve_device(device="cuda"):
    """``device`` (str or torch.device) -> torch.device; raises when CUDA is
    requested but ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(dev):
    """Wait for ``dev``'s queued work when it is a CUDA device; the CPU runs
    eagerly, so there is nothing to wait for."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
