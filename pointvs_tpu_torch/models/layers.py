"""Building blocks of the EGNN: activations, MLPs, reference init.

Counterpart of ``pointvs_tpu/models/layers.py``. Initialisation follows the
reference's torch defaults: every Linear draws weight and bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); the coordinate MLP's final layer is
bias-free with xavier-uniform gain 0.001 (ref egnn_satorras.py:88-89); the
lucid family's Linears are xavier-normal with zero biases (ref
egnn_lucid.py:102-107). Parameters are drawn from an explicit
``torch.Generator``.

``Linear`` takes an optional compute dtype, the counterpart of
``TorchLinear(dtype=...)``: the parameters stay in their own dtype (f32,
also in the checkpoint) and each call casts the input, the weight and the
bias to the compute dtype, as flax's ``Dense(dtype=bfloat16)`` does
(``--bf16``).

Also the lucid family's pieces: ``fourier_encode_dist``, ``CoorsNorm``
and ``Dropout``, flax's ``nn.Dropout`` under a JAX key
(``ops/dropout.threefry_dropout``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pointvs_tpu_torch.ops.dropout import threefry_dropout

def _logistic_by_ops(x):
    """1 / (1 + exp(-x)), each op rounded to x's dtype: the reference's
    sigmoid as XLA evaluates it on a bf16 array."""
    return 1 / (1 + torch.exp(-x))


class _SiLUByOps(torch.autograd.Function):
    """x * sigmoid(x) op by op in x's dtype, keeping only x for the
    backward, which recomputes the sigmoid: autograd through the ops would
    keep three tensors of x's size (x, exp(-x), the sigmoid), more than a
    fused f32 SiLU keeps."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * _logistic_by_ops(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = _logistic_by_ops(x)
        return g * (s + x * (s * (1 - s)))


class SiLU(nn.SiLU):
    """SiLU; on bf16 input x * sigmoid(x) with every op rounded to bf16,
    as the reference's ``nn.silu`` computes in bf16 (``--bf16``)."""

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            return _SiLUByOps.apply(x)
        return super().forward(x)


class Sigmoid(nn.Sigmoid):
    """Sigmoid; on bf16 input op by op, as ``SiLU``."""

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            return _logistic_by_ops(x)
        return super().forward(x)


ACTIVATIONS = {
    'silu': SiLU,
    'relu': nn.ReLU,
    'sigmoid': Sigmoid,
    'tanh': nn.Tanh,
    'softplus': nn.Softplus,
    'identity': nn.Identity,
}


def activation(name: str) -> nn.Module:
    return ACTIVATIONS[name]()


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` when one is given (None: the
    parameters' own dtype). ``F.linear`` takes one dtype, so the input,
    the weight and the bias are each cast to it; the product is rounded
    to ``dtype`` before the bias is added, as flax's ``Dense`` does."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dtype = self.compute_dtype
        if dtype is None:
            return super().forward(x)
        out = F.linear(x.to(dtype), self.weight.to(dtype))
        return out if self.bias is None else out + self.bias.to(dtype)


class XavierLinear(Linear):
    """Linear whose weight is drawn xavier-uniform with ``gain``."""

    def __init__(self, in_features: int, out_features: int, gain: float,
                 bias: bool = True, dtype: torch.dtype | None = None):
        self.gain = gain
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)


class XavierNormalLinear(Linear):
    """Linear whose weight is drawn xavier-normal and whose bias is zero
    (the lucid family's init)."""


def mlp(in_features: int, features: Sequence[int], acts: Sequence[str],
        final_gain: float | None = None, final_bias: bool = True,
        dtype: torch.dtype | None = None) -> nn.Sequential:
    """[Linear, act] * len(features) as one Sequential, computing in
    ``dtype`` (``Linear``).

    Every activation is a module (Identity included), so the Linears sit
    at even indices as in the reference state_dict schema.
    """
    modules = []
    for i, (feats, act) in enumerate(zip(features, acts)):
        final = i == len(features) - 1
        bias = final_bias if final else True
        if final and final_gain is not None:
            modules.append(XavierLinear(in_features, feats, final_gain,
                                        bias=bias, dtype=dtype))
        else:
            modules.append(Linear(in_features, feats, bias=bias,
                                  dtype=dtype))
        modules.append(activation(act))
        in_features = feats
    return nn.Sequential(*modules)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Linear of ``module`` with the reference init, in
    module order, from ``generator`` (a CPU generator; move the module to
    its device afterwards)."""
    for sub in module.modules():
        if not isinstance(sub, nn.Linear):
            continue
        fan_in, fan_out = sub.in_features, sub.out_features
        if isinstance(sub, XavierNormalLinear):
            sub.weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                               generator=generator)
            if sub.bias is not None:
                sub.bias.zero_()
            continue
        if isinstance(sub, XavierLinear):
            bound = sub.gain * math.sqrt(6.0 / (fan_in + fan_out))
        else:
            bound = 1.0 / math.sqrt(fan_in)
        sub.weight.uniform_(-bound, bound, generator=generator)
        if sub.bias is not None:
            bias_bound = 1.0 / math.sqrt(fan_in)
            sub.bias.uniform_(-bias_bound, bias_bound, generator=generator)


def fourier_encode_dist(x: torch.Tensor, num_encodings: int = 4
                        ) -> torch.Tensor:
    """[E, 1] squared distances -> [E, 2 * num_encodings + 1]: sin and cos
    of x / 2**i for i < num_encodings, then x itself (egnn_pytorch's
    encoding, as the lucid family calls it)."""
    scales = 2.0 ** torch.arange(num_encodings, dtype=x.dtype,
                                 device=x.device)
    scaled = x / scales
    return torch.cat([torch.sin(scaled), torch.cos(scaled), x], dim=-1)


class CoorsNorm(nn.Module):
    """Relative coordinate vectors scaled to unit length times a learnt
    ``scale`` (init 1e-2). The clamp is inside the sqrt: padding edges
    have rel_coors == 0, and sqrt'(0) would put NaN into every gradient
    although the forward masks them out downstream."""

    def __init__(self, scale_init: float = 1e-2, eps: float = 1e-8):
        super().__init__()
        self.scale = nn.Parameter(torch.full((1,), scale_init))
        self.eps = eps

    def forward(self, rel_coors: torch.Tensor) -> torch.Tensor:
        sq = (rel_coors ** 2).sum(dim=-1, keepdim=True)
        norm = torch.sqrt(torch.clamp_min(sq, self.eps ** 2))
        return rel_coors / norm * self.scale


class Dropout(nn.Module):
    """flax's ``nn.Dropout(rate)``: with a raw JAX key (uint32[2], the
    site's flax rng), ``where(keep, x / (1 - rate), 0)`` with ``keep``
    drawn as ``jax.random.bernoulli(key, 1 - rate, x.shape)``; with no
    key, the identity. It holds no parameters, so it can sit in a
    reference-schema Sequential."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        if key is None or self.rate <= 0:
            return x
        return threefry_dropout(x, key, self.rate)
