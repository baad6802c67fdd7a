"""Fused Satorras EGNN edge pass: kernel K3 and its differentiable wrapper.

Counterpart of ``pointvs_tpu/ops/pallas/fused_egnn.py``
(``fused_edge_forward`` and the custom-VJP ``fused_edge_pass``). Per edge
e with sender s (senders sorted ascending; an id equal to N marks a
padding edge):

    x_e   = [h[s], h_dst[e], extras[e]]      extras = [radial, attr0..2]
    m_e   = silu(W2 silu(W1 x_e + b1) + b2)  (+ prev[e] where mask > 0)
    phi_e = cw2 . silu(cW1 m_e + cb1)        (tanh'd when ``tanh``)
    a_e   = attention(attw . m_e + attb)     none/sigmoid/tanh/relu/silu,
                                             or softmax over s's edges
    agg[s] = sum_e where(mask > 0, a_e m_e, 0)   (m_e when attention none)

Outputs are edge-major (the torch idiom): agg [N, K], phi [E], att [E]
(0 in mode none), messages [E, K] (= m_e). Positions of padding edges are
0. The reference's feature-major ``[K, E_pad]`` / ``[8, E_pad]`` layout,
its 128-node windows and its per-window edge capacity are TPU tiling and
have no counterpart here.

CPU tensors take ``fused_edge_forward_plain``; CUDA tensors launch K3
(``csrc/fused_egnn.cu``), never the plain version: blocks of equal edge
shares, 64-edge tiles whose edge-MLP products run on tensor cores
(mma.sync TF32 with a 3xTF32 split, f32-accurate), the softmax and the
per-sender sums inside tiles cut at sender boundaries, no float atomics
(two runs give identical bits).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

ATTENTION_MODES = ('none', 'sigmoid', 'tanh', 'relu', 'silu', 'softmax')
PARAM_NAMES = ('w1', 'b1', 'w2', 'b2', 'cw1', 'cb1', 'cw2', 'attw', 'attb')
MAX_K = 32


def _pad_index(senders, n):
    """Sender ids with padding (== n) mapped to a spare row n."""
    return senders.long().clamp(max=n)


def _scatter_sum(values, senders, n):
    out = values.new_zeros((n + 1,) + values.shape[1:])
    out.index_add_(0, _pad_index(senders, n), values)
    return out[:n]


def _per_sender(values_n, senders, n, fill=0.0):
    """values_n[senders] with ``fill`` for padding edges."""
    padded = torch.cat([values_n, values_n.new_full((1,), fill)])
    return padded[_pad_index(senders, n)]


def _softmax_per_sender(logits, mask, senders, n):
    """Exact per-sender softmax as the reference's kernel computes it."""
    guarded = torch.where(mask > 0, logits, logits.new_tensor(-1e30))
    node_max = logits.new_full((n + 1,), -1e30).scatter_reduce(
        0, _pad_index(senders, n), guarded, 'amax', include_self=True)[:n]
    node_max = torch.where(node_max > -1e29, node_max,
                           node_max.new_zeros(()))
    expd = torch.exp(guarded - _per_sender(node_max, senders, n)) * mask
    denom = _scatter_sum(expd, senders, n)
    denom_e = _per_sender(torch.clamp_min(denom, 1e-16), senders, n)
    return expd / torch.where(denom_e == 0, denom_e.new_ones(()), denom_e)


def attention_from_logits(logits, mask, senders, n, attention):
    if attention == 'sigmoid':
        return torch.sigmoid(logits)
    if attention == 'tanh':
        return torch.tanh(logits)
    if attention == 'relu':
        return torch.clamp_min(logits, 0.0)
    if attention == 'silu':
        return F.silu(logits)
    return _softmax_per_sender(logits, mask, senders, n)


def edge_mlp_forward(h, h_dst, extras, edge_mask, senders, prev, params):
    """The recomputed per-edge forward shared by both plain versions:
    (x, pre1, hidden, pre2, m, prec, chidden, prephi)."""
    n = h.shape[0]
    clamped = senders.long().clamp(max=n - 1)
    own = (senders < n)[:, None]
    h_src = torch.where(own, h[clamped], h.new_zeros(()))
    x = torch.cat([h_src, h_dst, extras], dim=1)
    pre1 = x @ params['w1'].T + params['b1']
    hidden = F.silu(pre1)
    pre2 = hidden @ params['w2'].T + params['b2']
    m = F.silu(pre2)
    if prev is not None:
        # Padding rows of prev may hold NaN: select, never multiply.
        m = m + torch.where(edge_mask[:, None] > 0, prev, prev.new_zeros(()))
    prec = m @ params['cw1'].T + params['cb1']
    chidden = F.silu(prec)
    prephi = chidden @ params['cw2']
    return x, pre1, hidden, pre2, m, prec, chidden, prephi


def fused_edge_forward_plain(h, h_dst, extras, edge_mask, senders, prev,
                             params, attention: str, tanh: bool):
    """Plain PyTorch version of K3: (agg, phi, att, messages)."""
    n = h.shape[0]
    _, _, _, _, m, _, _, prephi = edge_mlp_forward(
        h, h_dst, extras, edge_mask, senders, prev, params)
    phi = torch.tanh(prephi) if tanh else prephi
    if attention == 'none':
        att = torch.zeros_like(phi)
        messages = m
    else:
        logits = m @ params['attw'] + params['attb']
        att = attention_from_logits(logits, edge_mask, senders, n, attention)
        messages = m * att[:, None]
    messages = torch.where(edge_mask[:, None] > 0, messages,
                           messages.new_zeros(()))
    agg = _scatter_sum(messages, senders, n)
    own = senders < n
    zero = phi.new_zeros(())
    return (agg, torch.where(own, phi, zero), torch.where(own, att, zero),
            torch.where(own[:, None], m, zero))


def check_edge_inputs(name, h, h_dst, extras, edge_mask, senders, prev,
                      params, attention):
    """Device, type, shape and contiguity checks of a CUDA launch."""
    if attention not in ATTENTION_MODES:
        raise ValueError(f'{name}: attention must be one of '
                         f'{ATTENTION_MODES}, got {attention!r}')
    n, k = h.shape
    e = senders.shape[0]
    if not 0 < k <= MAX_K:
        raise ValueError(f'{name}: the CUDA kernel takes 1 <= K <= {MAX_K} '
                         f'features, got K={k}')
    if senders.dtype != torch.int32 or senders.dim() != 1:
        raise ValueError(f'{name}: senders must be 1-D int32')
    shapes = {'h_dst': (h_dst, (e, k)), 'extras': (extras, (e, 4)),
              'edge_mask': (edge_mask, (e,)),
              'w1': (params['w1'], (k, 2 * k + 4)), 'b1': (params['b1'], (k,)),
              'w2': (params['w2'], (k, k)), 'b2': (params['b2'], (k,)),
              'cw1': (params['cw1'], (k, k)), 'cb1': (params['cb1'], (k,)),
              'cw2': (params['cw2'], (k,)), 'attw': (params['attw'], (k,)),
              'attb': (params['attb'], (1,))}
    if prev is not None:
        shapes['prev'] = (prev, (e, k))
    for arg, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f'{name}: {arg} has shape {tuple(t.shape)}, '
                             f'expected {shape}')
    for arg, t in [('h', h), ('senders', senders)] + [
            (a, s[0]) for a, s in shapes.items()]:
        if t.device != h.device or t.device.type != 'cuda':
            raise ValueError(f'{name}: {arg} on {t.device}; all tensors '
                             f'must be on one CUDA device')
        if t is not senders and t.dtype != torch.float32:
            raise ValueError(f'{name}: {arg} must be float32, got {t.dtype}')


def ptr(t):
    return 0 if t is None else t.data_ptr()


def fused_edge_forward(h, h_dst, extras, edge_mask, senders, prev, params,
                       attention: str, tanh: bool):
    """(agg [N, K], phi [E], att [E], messages [E, K]) of the edge pass.

    CUDA: kernel K3 ``fused_edge_forward``. CPU: the plain version.
    """
    if h.device.type == 'cpu' and senders.device.type == 'cpu':
        return fused_edge_forward_plain(h, h_dst, extras, edge_mask, senders,
                                        prev, params, attention, tanh)
    params = {p: params[p].detach().contiguous() for p in PARAM_NAMES}
    h, h_dst, extras, edge_mask, senders = (
        t.detach().contiguous() for t in (h, h_dst, extras, edge_mask,
                                          senders))
    prev = None if prev is None else prev.detach().contiguous()
    check_edge_inputs('fused_edge_forward', h, h_dst, extras, edge_mask,
                      senders, prev, params, attention)
    n, k = h.shape
    e = senders.shape[0]
    agg = torch.empty((n, k), device=h.device, dtype=torch.float32)
    phi = torch.empty((e,), device=h.device, dtype=torch.float32)
    att = torch.empty((e,), device=h.device, dtype=torch.float32)
    msg = torch.empty((e, k), device=h.device, dtype=torch.float32)
    from pointvs_tpu_torch.ops._build import load
    lib = load('fused_egnn')
    with torch.cuda.device(h.device):
        err = lib.pvs_fused_edge_forward(
            h.data_ptr(), h_dst.data_ptr(), extras.data_ptr(),
            edge_mask.data_ptr(), senders.data_ptr(), ptr(prev),
            *[params[p].data_ptr() for p in PARAM_NAMES],
            agg.data_ptr(), phi.data_ptr(), att.data_ptr(), msg.data_ptr(),
            e, k, n, ATTENTION_MODES.index(attention), int(tanh),
            torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'fused_edge_forward kernel launch failed: '
                           f'cudaError {err}')
    fused_edge_forward.launches += 1
    return agg, phi, att, msg


fused_edge_forward.launches = 0

def kernel_info() -> dict:
    """K3's resources on the current CUDA device
    (``_build.read_kernel_info``)."""
    from pointvs_tpu_torch.ops._build import read_kernel_info
    return read_kernel_info('fused_egnn', 'pvs_fused_forward_info')


class FusedEdgePass(torch.autograd.Function):
    """Differentiable edge pass (the reference's ``fused_edge_pass``):
    forward K3, backward the recompute kernel K4, then the per-edge
    sender cotangents scattered to the nodes with K1.

    ``apply(h, h_dst, extras, prev, w1, b1, w2, b2, cw1, cb1, cw2, attw,
    attb, edge_mask, senders, attention, tanh, offsets)``; ``prev`` is None
    when the edge residual is off; ``offsets`` are the senders' row offsets
    for K1 (``segment_kernels.segment_offsets``; found by K1's wrapper
    when None). Only column 0 (radial) of ``extras`` gets a gradient, as in
    the reference.
    """

    @staticmethod
    def forward(ctx, h, h_dst, extras, prev, w1, b1, w2, b2, cw1, cb1, cw2,
                attw, attb, edge_mask, senders, attention, tanh,
                offsets=None):
        params = dict(zip(PARAM_NAMES, (w1, b1, w2, b2, cw1, cb1, cw2, attw,
                                        attb)))
        out = fused_edge_forward(h, h_dst, extras, edge_mask, senders, prev,
                                 params, attention, tanh)
        ctx.save_for_backward(h, h_dst, extras, prev, edge_mask, senders,
                              offsets, w1, b1, w2, b2, cw1, cb1, cw2, attw,
                              attb)
        ctx.attention, ctx.tanh = attention, tanh
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, d_agg, d_phi, d_att, d_msg):
        from pointvs_tpu_torch.ops import segment_kernels
        from pointvs_tpu_torch.ops.fused_egnn_bwd import fused_edge_backward
        (h, h_dst, extras, prev, edge_mask, senders, offsets,
         *weights) = ctx.saved_tensors
        params = dict(zip(PARAM_NAMES, weights))
        n, k = h.shape
        e = senders.shape[0]
        d_agg = h.new_zeros((n, k)) if d_agg is None else d_agg
        d_phi = h.new_zeros((e,)) if d_phi is None else d_phi
        d_att = h.new_zeros((e,)) if d_att is None else d_att
        d_h_src, d_h_dst, d_radial, d_prev, d_params = fused_edge_backward(
            h, h_dst, extras, edge_mask, senders, prev, params, d_agg, d_phi,
            d_att, d_msg, ctx.attention, ctx.tanh)
        # Select padding positions out with the mask row (never multiply),
        # then scatter the sender cotangents over the sorted senders (K1).
        keep = edge_mask > 0
        zero = h.new_zeros(())
        d_h_src = torch.where(keep[:, None], d_h_src, zero)
        d_h_dst = torch.where(keep[:, None], d_h_dst, zero)
        d_extras = torch.zeros_like(extras)
        d_extras[:, 0] = torch.where(keep, d_radial, zero)
        d_h = segment_kernels.windowed_segment_sum(d_h_src.contiguous(),
                                                   senders, n, offsets)
        if d_prev is not None:
            d_prev = torch.where(keep[:, None], d_prev, zero)
        return (d_h, d_h_dst, d_extras, d_prev,
                *[d_params[p] for p in PARAM_NAMES], None, None, None, None,
                None)


def fused_edge_pass(h, h_dst, extras, prev, params, edge_mask, senders,
                    attention: str, tanh: bool, offsets=None):
    """(agg, phi, att, messages), differentiable in h, h_dst, extras[:, 0],
    prev and every parameter; ``offsets`` as ``FusedEdgePass``'s."""
    return FusedEdgePass.apply(h, h_dst, extras, prev,
                               *[params[p] for p in PARAM_NAMES], edge_mask,
                               senders, attention, tanh, offsets)
