"""Card-side counterparts of the measurement probes in the repository's
``scripts/``: ``micro_bench`` (K9) and ``exp_dma_stream`` (K10); and
``chunk_stop``, the plain stage-6 forward's chunk exit against K4 and K5.
Each runs as ``python -m easygaussiansplatting_tpu_torch.probes.<name>
[--device cpu]``."""
