"""The viewer: headless turntables (headless.py), the interactive web viewer
(server.py with index.html) and the live training monitor (monitor.py).
Port of easygaussiansplatting_tpu/viewer/."""

from easygaussiansplatting_tpu_torch.viewer.headless import (
    orbit_cameras,
    render_turntable,
    save_gif,
)

__all__ = ["orbit_cameras", "render_turntable", "save_gif"]
