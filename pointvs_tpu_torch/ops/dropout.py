"""flax's ``nn.Dropout`` under a JAX threefry key, with its plain version.

``threefry_dropout(x, key, rate)`` returns ``where(keep, x / (1 - rate),
0)`` with ``keep = jax.random.bernoulli(key, 1 - rate, x.shape)``: the
mask the reference's lucid draws at a dropout site whose flax rng is
``key`` (a raw uint32[2] key from ``ops/prng.py``). Entry i of the
flattened tensor hashes the two 32-bit halves of i (partitionable
threefry), so the mask is the reference's bit for bit.

A tensor on the CPU takes the plain version (uint32 arithmetic emulated
in int64; float64 tensors draw 52-bit uniforms, as JAX does under x64).
A float32 tensor on the card launches the hand-written kernel
``csrc/threefry_dropout.cu`` (hash, keep test and scale in one pass),
forward and backward (the op's gradient is the same op on the
gradient); each launch is counted in ``threefry_dropout.launches``. The
kernel is not a port of a TPU kernel: the reference draws the mask
inside its XLA program.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Integer operations an entry: 2 key adds, 20 rounds of add, rotate and
# xor, 5 key injections of 3 adds, then xor, shift, or, compare, divide
# and select (the kernel's work for its bound).
OPS_PER_ENTRY = 2 + 20 * 3 + 5 * 3 + 6


def _threefry_bits(n: int, key, device, chunk: int = 1 << 20):
    """The two threefry words (int64 tensors holding uint32) of the flat
    indices 0..n-1 under ``key``. In place, a chunk at a time, so the
    working set stays in cache (15x faster on a CPU than whole-tensor
    ops at lucid's sizes)."""
    k0, k1 = (int(v) for v in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    out0 = torch.empty(n, dtype=torch.int64, device=device)
    out1 = torch.empty_like(out0)
    tmp = torch.empty(min(chunk, n), dtype=torch.int64, device=device)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        x0, x1, t = out0[lo:hi], out1[lo:hi], tmp[:hi - lo]
        torch.arange(lo, hi, out=x1)
        x0.copy_(x1).bitwise_right_shift_(32).add_(ks[0]).bitwise_and_(
            _MASK32)
        x1.bitwise_and_(_MASK32).add_(ks[1]).bitwise_and_(_MASK32)
        for block in range(5):
            for r in _ROTATIONS[block % 2]:
                x0.add_(x1).bitwise_and_(_MASK32)
                torch.bitwise_right_shift(x1, 32 - r, out=t)
                x1.bitwise_left_shift_(r).bitwise_and_(_MASK32).bitwise_or_(t)
                x1.bitwise_xor_(x0)
            x0.add_(ks[(block + 1) % 3]).bitwise_and_(_MASK32)
            x1.add_(ks[(block + 2) % 3] + block + 1).bitwise_and_(_MASK32)
    return out0, out1


def threefry_dropout_plain(x: torch.Tensor, key, rate: float
                           ) -> torch.Tensor:
    """The plain PyTorch version (any device, float32 or float64)."""
    keep = 1.0 - rate
    b0, b1 = _threefry_bits(x.numel(), key, x.device)
    if x.dtype == torch.float64:
        mantissa = (b0 << 20) | (b1 >> 12)   # the 64-bit word >> 12
        u = mantissa.to(torch.float64) * 2.0 ** -52
    else:
        u = ((b0 ^ b1) >> 9).to(torch.float32) * 2.0 ** -23
    p = torch.tensor(keep, dtype=x.dtype, device=x.device)
    mask = (u < p).view(x.shape)
    return torch.where(mask, x / p, x.new_zeros(()))


def _launch(x: torch.Tensor, key, keep: float) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise ValueError(f'threefry_dropout on the card takes float32, got '
                         f'{x.dtype}')
    x = x.contiguous()
    out = torch.empty_like(x)
    k0, k1 = (int(v) for v in np.asarray(key, np.uint32))
    from pointvs_tpu_torch.ops._build import load
    lib = load('threefry_dropout')
    with torch.cuda.device(x.device):
        err = lib.pvs_threefry_dropout(
            x.data_ptr(), out.data_ptr(), x.numel(), k0, k1,
            ctypes.c_float(keep),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'threefry_dropout kernel launch failed: '
                           f'cudaError {err}')
    threefry_dropout.launches += 1
    return out


class _ThreefryDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, keep):
        ctx.key, ctx.keep = key, keep
        return _launch(x, key, keep)

    @staticmethod
    def backward(ctx, grad):
        return _launch(grad, ctx.key, ctx.keep), None, None


def threefry_dropout(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    """flax's ``Dropout(rate)`` of ``x`` under the raw key ``key``."""
    if rate <= 0:
        return x
    if rate >= 1:
        return torch.zeros_like(x)
    if x.device.type == 'cpu':
        return threefry_dropout_plain(x, key, rate)
    key = np.asarray(key, np.uint32)
    return _ThreefryDropout.apply(x, key, float(np.float32(1.0 - rate)))


threefry_dropout.launches = 0


def kernel_info() -> dict:
    """Registers, spills, shared bytes and resident blocks per SM of the
    kernel's scalar and float4 variants (builds them if needed)."""
    from pointvs_tpu_torch.ops._build import read_kernel_info
    return {name: read_kernel_info('threefry_dropout',
                                   'pvs_threefry_dropout_info', i)
            for i, name in enumerate(('threefry_dropout',
                                      'threefry_dropout<float4>'))}
