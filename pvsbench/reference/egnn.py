"""Plain PyTorch EGNN of PointVS (Satorras et al. 2021, as PointVS's
``egnn_satorras.py`` builds it): the forward, the loss and the parameter
schema, in float32 with TF32 off, over graphs concatenated in blocks.

One layer, for edges (s, r) of a graph with features h and coordinates x:

    d = x_s - x_r,  q = |d|^2,  d <- d / (sqrt(q) + 1e-8)      (normalise)
    m = silu(W2 silu(W1 [h_s, h_r, q, class one-hot]))          edge MLP
    a = softmax of att(m) over the edges of each sender s
    x_s <- x_s + mean over s's edges of d * tanh(C2 silu(C1 m))
    h_s <- h_s + N3 silu(GraphNorm(N0 [h_s, sum over s's edges of a m]))

GraphNorm (Cai et al. 2021) takes each graph's statistics,
``w * (o - mu * ms) / sqrt(var + 1e-5) + b``. The network embeds the 12
node features linearly, runs the layers, averages each graph's node
features and maps them through one linear head to a logit (pose
classification) or a pK (regression). Parameter names follow PointVS's
state_dict. Only the flags the benchmark's configurations use are
implemented; any other raises.

``tf32=True`` is the control: every product's operands rounded to TF32
(10 mantissa bits) before a float32 accumulation, as tensor cores compute
a float32 product with TF32 on. On a CUDA device the products run with
TF32 enabled; on the CPU the rounding is emulated.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

# The model flags the reference implements, all of which it requires;
# the other flags a configuration may set shape the data or the training.
MODEL_FLAGS = {'egnn_attention', 'softmax_attention', 'egnn_residual',
               'egnn_normalise', 'egnn_tanh', 'graphnorm', 'compact'}
NON_MODEL = {'estimate_bonds', 'warm_restarts', 'remat'}


def check_flags(flags: dict) -> None:
    """Raise for a configuration the reference does not implement."""
    on = {k for k, v in flags.items() if v is True}
    missing = MODEL_FLAGS - on
    extra = on - MODEL_FLAGS - NON_MODEL
    if missing or extra:
        raise ValueError(f'the reference EGNN takes the flags '
                         f'{sorted(MODEL_FLAGS)} together; missing '
                         f'{sorted(missing)}, unsupported {sorted(extra)}')


def param_schema(k: int, layers: int, dim_input: int = 12,
                 dim_output: int = 1) -> list:
    """[(name, shape, init)] in PointVS's state_dict order; ``init`` is
    ('uniform', bound) or ('const', value). Linear layers draw weight and
    bias from U(-1/sqrt(fan_in), 1/sqrt(fan_in)); the coordinate MLP's
    last layer has no bias and draws xavier-uniform with gain 0.001;
    GraphNorm starts at weight 1, bias 0, mean scale 1."""
    def linear(name, fan_in, fan_out, bias=True, gain=None):
        bound = (gain * math.sqrt(6.0 / (fan_in + fan_out)) if gain
                 else 1.0 / math.sqrt(fan_in))
        out = [(f'{name}.weight', (fan_out, fan_in), ('uniform', bound))]
        if bias:
            out.append((f'{name}.bias', (fan_out,),
                        ('uniform', 1.0 / math.sqrt(fan_in))))
        return out

    schema = linear('layers.0.m', dim_input, k)
    for i in range(1, layers + 1):
        p = f'layers.{i}.'
        schema += linear(p + 'edge_mlp.0', 2 * k + 4, k)
        schema += linear(p + 'edge_mlp.2', k, k)
        schema += linear(p + 'node_mlp.0', 2 * k, k)
        schema += [(p + 'node_mlp.1.weight', (k,), ('const', 1.0)),
                   (p + 'node_mlp.1.bias', (k,), ('const', 0.0)),
                   (p + 'node_mlp.1.mean_scale', (k,), ('const', 1.0))]
        schema += linear(p + 'node_mlp.3', k, k)
        schema += linear(p + 'coord_mlp.0', k, k)
        schema += linear(p + 'coord_mlp.2', k, 1, bias=False, gain=0.001)
        schema += linear(p + 'att_mlp.0', k, 1)
    schema += linear('feats_linear_layers.0', k, dim_output)
    return schema


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even; the
    gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32).to(torch.int64)
    bits = bits + 0xFFF + ((bits >> 13) & 1)
    bits = bits & ~0x1FFF
    return x + (bits.to(torch.int32).view(torch.float32) - x).detach()


class Precision:
    """How the reference multiplies: float32 with TF32 off, or TF32."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def linear(self, x, w, b=None):
        if self.tf32 and x.device.type == 'cpu':
            x, w = round_tf32(x), round_tf32(w)
        y = x @ w.t()
        return y if b is None else y + b

    @contextlib.contextmanager
    def active(self):
        """Sets the CUDA matmul precision for the duration."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


def block(graphs: list, device) -> dict:
    """Graphs (``featurise`` dicts) concatenated: node and edge arrays on
    ``device`` with node offsets applied, and each node's graph."""
    offsets = [0]
    for g in graphs:
        offsets.append(offsets[-1] + len(g['coords']))

    def cat(key):
        return torch.from_numpy(np.concatenate([g[key] for g in graphs]))

    shift = torch.cat([torch.full((len(g['senders']),), o, dtype=torch.int64)
                       for g, o in zip(graphs, offsets)])
    return dict(
        feats=cat('feats').to(device), coords=cat('coords').to(device),
        senders=(cat('senders') + shift).to(device),
        receivers=(cat('receivers') + shift).to(device),
        attr=F.one_hot(cat('eclass'), 3).float().to(device),
        graph=torch.repeat_interleave(
            torch.arange(len(graphs)),
            torch.tensor([len(g['coords']) for g in graphs])).to(device),
        num_graphs=len(graphs), num_nodes=offsets[-1])


def _segment_sum(values, index, n):
    out = values.new_zeros((n,) + values.shape[1:])
    return out.index_add_(0, index, values)


def _segment_mean(values, index, n):
    count = _segment_sum(torch.ones_like(index, dtype=values.dtype), index, n)
    total = _segment_sum(values, index, n)
    return total / count.clamp(min=1.0).reshape((n,) + (1,) * (values.dim()
                                                               - 1))


def _softmax_by(logits, index, n):
    top = logits.new_full((n,), -math.inf).scatter_reduce(
        0, index, logits.detach(), 'amax', include_self=True)
    ex = torch.exp(logits - top[index])
    return ex / _segment_sum(ex, index, n)[index]


def forward(p: dict, b: dict, layers: int, prec: Precision) -> torch.Tensor:
    """Logits [num_graphs, out] of a ``block``."""
    s, r, n, g = b['senders'], b['receivers'], b['num_nodes'], b['graph']
    lin = lambda x, name, bias=True: prec.linear(  # noqa: E731
        x, p[name + '.weight'], p[name + '.bias'] if bias else None)
    silu = F.silu
    h = lin(b['feats'], 'layers.0.m')
    x = b['coords']
    for i in range(1, layers + 1):
        q = f'layers.{i}.'
        d = x[s] - x[r]
        radial = (d * d).sum(1, keepdim=True)
        d = d / (torch.sqrt(radial).detach() + 1e-8)
        m = silu(lin(torch.cat([h[s], h[r], radial, b['attr']], 1),
                     q + 'edge_mlp.0'))
        m = silu(lin(m, q + 'edge_mlp.2'))
        att = _softmax_by(lin(m, q + 'att_mlp.0')[:, 0], s, n)
        agg = _segment_sum(att[:, None] * m, s, n)
        trans = d * torch.tanh(lin(silu(lin(m, q + 'coord_mlp.0')),
                                   q + 'coord_mlp.2', bias=False))
        x = x + _segment_mean(trans, s, n)
        o = lin(torch.cat([h, agg], 1), q + 'node_mlp.0')
        mean = _segment_mean(o, g, b['num_graphs'])[g]
        o = o - mean * p[q + 'node_mlp.1.mean_scale']
        var = _segment_mean(o * o, g, b['num_graphs'])[g]
        o = (p[q + 'node_mlp.1.weight'] * o / torch.sqrt(var + 1e-5)
             + p[q + 'node_mlp.1.bias'])
        h = h + lin(silu(o), q + 'node_mlp.3')
    pooled = _segment_mean(h, g, b['num_graphs'])
    return lin(pooled, 'feats_linear_layers.0')


def loss_sum(logits: torch.Tensor, y: torch.Tensor, task: str):
    """Summed loss of a block's graphs: binary cross-entropy on the pose
    logit, or the squared error of the pK."""
    logits = logits.reshape(-1)
    if task == 'classification':
        return F.binary_cross_entropy_with_logits(logits, y,
                                                  reduction='sum')
    if task == 'regression':
        return ((logits - y) ** 2).sum()
    raise ValueError(f'task {task!r} is not implemented by the reference')


# Edges per block of graphs in the reference's forward and backward.
EDGE_BUDGET = 400_000


def blocks_of(graphs: list, edge_budget: int) -> list:
    """Index ranges of consecutive graphs holding at most ``edge_budget``
    edges each (one graph at least)."""
    spans, lo = [], 0
    while lo < len(graphs):
        hi, edges = lo, 0
        while hi < len(graphs) and (hi == lo or edges
                                    + len(graphs[hi]['senders'])
                                    <= edge_budget):
            edges += len(graphs[hi]['senders'])
            hi += 1
        spans.append((lo, hi))
        lo = hi
    return spans
