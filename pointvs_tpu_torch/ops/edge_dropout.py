"""Undirected edge dropout on a static-shape edge list (counterpart of
``pointvs_tpu/ops/edge_dropout.py``).

Edges are dropped by zeroing their mask. An edge's fate is a hash of the
seed and its canonical (min, max) node pair, so (i, j) and (j, i) always
agree, and the same seed gives the same mask on any device and in a
recomputed forward. The hash is murmur3's 32-bit finaliser (fmix32) on
uint32 values, carried in int64 tensors: every xor, shift and product is
reduced mod 2**32, and each product is split into 16-bit halves of the
constant so that no intermediate leaves the int64 range.
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for x in [0, 2**32) and a constant c < 2**32, with
    every intermediate below 2**49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def undirected_edge_dropout(senders: torch.Tensor, receivers: torch.Tensor,
                            edge_mask: torch.Tensor, rate: float,
                            seed: int) -> torch.Tensor:
    """A new edge mask with about ``rate`` of the undirected edges dropped.

    ``seed`` is a uint32 (vary it per step); padding edges (mask 0) stay 0.
    An edge is kept when float32(hash) / 2**32 >= rate.
    """
    s, r = senders.long(), receivers.long()
    lo = torch.minimum(s, r) & _MASK32
    hi = torch.maximum(s, r) & _MASK32
    h = _mix(_mix(lo ^ (int(seed) & _MASK32)) ^ hi)
    uniform = h.to(torch.float32) / 4294967296.0
    return edge_mask * (uniform >= rate).to(edge_mask.dtype)
