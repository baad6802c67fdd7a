"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. A CUDA
request on a machine without CUDA raises instead of silently falling back,
so a CPU run is never mistaken for a GPU one.
"""
from __future__ import annotations

import torch


def resolve_device(name: str = 'cuda') -> torch.device:
    """``'cuda'`` or ``'cpu'`` -> torch.device, with full-f32 matmuls.

    TF32 is switched off for matmuls and cuDNN: the reference computes in
    full float32 and the E(3)-invariance gate (3e-5) needs it. bf16
    matmuls (``--bf16``) accumulate in float32, as XLA's do: cuBLAS may
    otherwise reduce their split-K partial sums in bf16.
    """
    device = torch.device(name)
    if device.type not in ('cuda', 'cpu'):
        raise ValueError(f'device must be cuda or cpu, got {name!r}')
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA was requested but torch.cuda.is_available() is False; '
            'pass --device cpu to run on the CPU')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return device


def refuse_double_on_cuda(double: bool, device_name: str) -> None:
    """``--double`` runs on the CPU only, as the reference's does (its
    ``main`` refuses any backend but the CPU): raise ``SystemExit`` naming
    ``--device cpu`` before any CUDA work."""
    if double and torch.device(device_name).type != 'cpu':
        raise SystemExit(
            '--double (float64) runs on the CPU only, as in the reference '
            'package; pass --device cpu, or drop --double')
