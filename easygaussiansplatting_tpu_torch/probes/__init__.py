"""Card-side counterparts of the measurement probes in the repository's
``scripts/``: ``micro_bench`` (K9) and ``exp_dma_stream`` (K10), each run as
``python -m easygaussiansplatting_tpu_torch.probes.<name> [--device cpu]``."""
