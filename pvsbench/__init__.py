"""The benchmark of the PyTorch and CUDA port (``pointvs_tpu_torch``):
cells, their traffic, their plain reference and their metrics. See
``README.md``."""
