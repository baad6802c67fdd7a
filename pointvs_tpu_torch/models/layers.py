"""Building blocks of the EGNN: activations, MLPs, reference init.

Counterpart of ``pointvs_tpu/models/layers.py``. Initialisation follows the
reference's torch defaults: every Linear draws weight and bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); the coordinate MLP's final layer is
bias-free with xavier-uniform gain 0.001 (ref egnn_satorras.py:88-89).
Parameters are drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

ACTIVATIONS = {
    'silu': nn.SiLU,
    'relu': nn.ReLU,
    'sigmoid': nn.Sigmoid,
    'tanh': nn.Tanh,
    'softplus': nn.Softplus,
    'identity': nn.Identity,
}


def activation(name: str) -> nn.Module:
    return ACTIVATIONS[name]()


class XavierLinear(nn.Linear):
    """Linear whose weight is drawn xavier-uniform with ``gain``."""

    def __init__(self, in_features: int, out_features: int, gain: float,
                 bias: bool = True):
        self.gain = gain
        super().__init__(in_features, out_features, bias=bias)


def mlp(in_features: int, features: Sequence[int], acts: Sequence[str],
        final_gain: float | None = None,
        final_bias: bool = True) -> nn.Sequential:
    """[Linear, act] * len(features) as one Sequential.

    Every activation is a module (Identity included), so the Linears sit
    at even indices as in the reference state_dict schema.
    """
    modules = []
    for i, (feats, act) in enumerate(zip(features, acts)):
        final = i == len(features) - 1
        bias = final_bias if final else True
        if final and final_gain is not None:
            modules.append(XavierLinear(in_features, feats, final_gain,
                                        bias=bias))
        else:
            modules.append(nn.Linear(in_features, feats, bias=bias))
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
        if isinstance(sub, XavierLinear):
            bound = sub.gain * math.sqrt(6.0 / (fan_in + fan_out))
        else:
            bound = 1.0 / math.sqrt(fan_in)
        sub.weight.uniform_(-bound, bound, generator=generator)
        if sub.bias is not None:
            bias_bound = 1.0 / math.sqrt(fan_in)
            sub.bias.uniform_(-bias_bound, bias_bound, generator=generator)
