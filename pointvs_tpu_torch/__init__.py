"""PyTorch/CUDA port of PointVS-TPU.

The JAX package ``pointvs_tpu`` is the reference this package is held
against; nothing here imports it or JAX. The layout mirrors the reference
(``ops/``, ``models/``, ``data/``, ``training/``, ``inference.py``) so each
module has an obvious counterpart. The segment reductions that the JAX
package wrote as Pallas TPU kernels are hand-written CUDA kernels for
Hopper (``ops/csrc/``), built with ``nvcc`` at first use.
"""
