"""Training configuration.

Port of easygaussiansplatting_tpu/train/config.py: every hyper-parameter of
the reference recipe, with the same defaults. The JAX ``tile``, ``k_chunk``
and ``n_chunks`` fields are left out: the port blends 16x16 tiles only
(``ops.binning.TILE``), its plain blend walks every chunk of a tile list
(``ops.rasterize_tiled.K_CHUNK``), and its CUDA kernels take no chunk size.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # epochs / cadence
    epochs: int = 100
    densify_every_epochs: int = 5
    densify_until_epoch: int = 50
    reset_alpha_every_epochs: int = 15
    save_every_epochs: int = 10

    # learning rates
    lr_low_shs: float = 1e-3
    lr_high_shs: float = 1e-3 / 20.0
    lr_alphas: float = 0.05
    lr_scales: float = 5e-3
    lr_rots: float = 1e-3
    lr_pws_init_scale: float = 1e-4   # * scene_size
    lr_pws_final_scale: float = 1e-6  # * scene_size
    lr_delay_mult: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-15

    # densification thresholds
    grad_threshold: float = 4e-7
    scale_threshold_scale: float = 0.01   # * scene_size
    alpha_threshold: float = 0.005
    big_threshold_scale: float = 0.1      # * scene_size
    reset_alpha_val: float = 0.01
    split_scale_factor: float = 0.6

    # loss
    loss_lambda: float = 0.2

    # rasteriser ("auto" = the CUDA kernels on a CUDA device, the plain
    # PyTorch path on the CPU; ops/rasterize.resolve_backend)
    backend: str = "auto"
    max_patches: int = 2**18
    max_rows: int = None  # None = max_patches
    sh_degree: int = 3

    # adaptive patch budget (the epoch driver's PatchBudget)
    adaptive_budget: bool = True
    budget_headroom: float = 1.05
    budget_quantum: int = 16384

    # pool
    capacity_headroom: float = 4.0  # initial capacity = headroom * n_init
