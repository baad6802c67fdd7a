"""Recompute backward of the fused edge pass: kernel K4.

Counterpart of ``pointvs_tpu/ops/pallas/fused_egnn_bwd.py``
(``fused_edge_backward``). Nothing is saved by the forward: each edge's
x, hidden, m, coordinate-MLP activations and attention are recomputed,
and the cotangents ``d_agg[s]``, ``d_phi``, ``d_att`` and ``d_msg`` are
chained through attention, the coordinate MLP, the edge residual and the
edge MLP exactly as the reference's ``_bwd_kernel`` does. Cotangents are
selected against ``valid = (sender < N) & (mask > 0)``; padding rows of
``prev`` may hold NaN and are selected out.

Returns per-edge ``d_h_src [E, K]``, ``d_h_dst [E, K]``, ``d_radial [E]``,
``d_prev [E, K]`` (None without the edge residual) and the parameter
gradients (the shapes of ``ops/fused_egnn.PARAM_NAMES``). Positions of
padding edges are 0. The node-side scatter of ``d_h_src`` happens outside
(``fused_egnn.FusedEdgePass``, with K1).

CPU tensors take ``fused_edge_backward_plain``; CUDA tensors launch K4
(``csrc/fused_egnn_bwd.cu``): 64-edge tiles whose edge-MLP products and
parameter-gradient products run on tensor cores (mma.sync TF32 with a
3xTF32 split, f32-accurate), per-block partial parameter gradients and a
fixed-order reduce (no float atomics, so two runs give identical bits).
"""
from __future__ import annotations

import torch

from pointvs_tpu_torch.ops.fused_egnn import (
    ATTENTION_MODES,
    MAX_K,
    PARAM_NAMES,
    _per_sender,
    _scatter_sum,
    attention_from_logits,
    check_edge_inputs,
    edge_mlp_forward,
    ptr,
    read_kernel_info,
)

def _dsilu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def fused_edge_backward_plain(h, h_dst, extras, edge_mask, senders, prev,
                              params, d_agg, d_phi, d_att, d_msg,
                              attention: str, tanh: bool):
    """Plain PyTorch version of K4 (see the module docstring)."""
    n, k = h.shape
    own = senders < n
    valid = own & (edge_mask > 0)
    zero = h.new_zeros(())
    x, pre1, hidden, pre2, m, prec, chidden, prephi = edge_mlp_forward(
        h, h_dst, extras, edge_mask, senders, prev, params)
    phi = torch.tanh(prephi) if tanh else prephi

    g_phi = torch.where(valid, d_phi, zero)
    clamped = senders.long().clamp(max=n - 1)
    g_messages = torch.where(own[:, None], d_agg[clamped], zero) \
        * edge_mask[:, None]
    if attention != 'none':
        logits = m @ params['attw'] + params['attb']
        att = attention_from_logits(logits, edge_mask, senders, n, attention)
        g_m = g_messages * att[:, None]
        g_att = (g_messages * m).sum(1) + torch.where(valid, d_att, zero)
        if attention == 'sigmoid':
            g_logits = g_att * att * (1.0 - att)
        elif attention == 'tanh':
            g_logits = g_att * (1.0 - att * att)
        elif attention == 'relu':
            g_logits = g_att * (logits > 0).to(g_att.dtype)
        elif attention == 'silu':
            g_logits = g_att * _dsilu(logits)
        else:   # softmax: per-sender sum of att * g_att
            s_e = _per_sender(_scatter_sum(att * g_att, senders, n),
                              senders, n)
            g_logits = att * (g_att - s_e)
        g_logits = torch.where(valid, g_logits, zero)
        g_m = g_m + g_logits[:, None] * params['attw'][None, :]
        d_attw = g_logits @ m
        d_attb = g_logits.sum()[None]
    else:
        g_m = g_messages
        d_attw = torch.zeros_like(params['attw'])
        d_attb = torch.zeros_like(params['attb'])
    if d_msg is not None:
        g_m = g_m + torch.where(valid[:, None], d_msg, zero)

    g_prephi = g_phi * (1.0 - phi * phi) if tanh else g_phi
    d_cw2 = g_prephi @ chidden
    g_chidden = g_prephi[:, None] * params['cw2'][None, :]
    g_prec = torch.where(valid[:, None], g_chidden * _dsilu(prec), zero)
    d_cw1 = g_prec.T @ m
    d_cb1 = g_prec.sum(0)
    g_m = g_m + g_prec @ params['cw1']
    g_m = torch.where(valid[:, None], g_m, zero)
    g_pre2 = g_m * _dsilu(pre2)
    d_w2 = g_pre2.T @ hidden
    d_b2 = g_pre2.sum(0)
    g_pre1 = (g_pre2 @ params['w2']) * _dsilu(pre1)
    d_w1 = g_pre1.T @ x
    d_b1 = g_pre1.sum(0)
    g_x = torch.where(own[:, None], g_pre1 @ params['w1'], zero)
    d_params = dict(zip(PARAM_NAMES, (d_w1, d_b1, d_w2, d_b2, d_cw1, d_cb1,
                                      d_cw2, d_attw, d_attb)))
    return (g_x[:, :k], g_x[:, k:2 * k], g_x[:, 2 * k],
            None if prev is None else g_m, d_params)


def unpack_param_grads(flat, k: int) -> dict:
    """The kernel's packed gradient vector (rows zero-padded to MAX_K
    features; dW1's padded input columns are [h_src 0..31 | h_dst 32..63 |
    extras 64..67]) -> the parameter shapes of ``PARAM_NAMES``."""
    m, width = MAX_K, 2 * MAX_K + 4
    sizes = (m * width, m, m * m, m, m * m, m, m, m, 1)
    w1p, b1, w2, b2, cw1, cb1, cw2, attw, attb = torch.split(flat, sizes)
    w1p = w1p.view(m, width)[:k]
    w1 = torch.cat([w1p[:, :k], w1p[:, m:m + k], w1p[:, 2 * m:]], dim=1)
    grads = dict(w1=w1, b1=b1[:k], w2=w2.view(m, m)[:k, :k], b2=b2[:k],
                 cw1=cw1.view(m, m)[:k, :k], cb1=cb1[:k], cw2=cw2[:k],
                 attw=attw[:k], attb=attb)
    return {name: g.contiguous() for name, g in grads.items()}


def fused_edge_backward(h, h_dst, extras, edge_mask, senders, prev, params,
                        d_agg, d_phi, d_att, d_msg, attention: str,
                        tanh: bool):
    """(d_h_src, d_h_dst, d_radial, d_prev or None, d_params).

    CUDA: kernel K4 ``fused_edge_backward``. CPU: the plain version.
    """
    if h.device.type == 'cpu' and senders.device.type == 'cpu':
        return fused_edge_backward_plain(h, h_dst, extras, edge_mask,
                                         senders, prev, params, d_agg, d_phi,
                                         d_att, d_msg, attention, tanh)
    params = {p: params[p].detach().contiguous() for p in PARAM_NAMES}
    h, h_dst, extras, edge_mask, senders, d_agg, d_phi, d_att = (
        t.detach().contiguous() for t in (h, h_dst, extras, edge_mask,
                                          senders, d_agg, d_phi, d_att))
    prev = None if prev is None else prev.detach().contiguous()
    d_msg = None if d_msg is None else d_msg.detach().contiguous()
    check_edge_inputs('fused_edge_backward', h, h_dst, extras, edge_mask,
                      senders, prev, params, attention)
    n, k = h.shape
    e = senders.shape[0]
    for arg, t, shape in (('d_agg', d_agg, (n, k)), ('d_phi', d_phi, (e,)),
                          ('d_att', d_att, (e,)),
                          ('d_msg', d_msg, (e, k))):
        if t is None:
            continue
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != h.device):
            raise ValueError(f'fused_edge_backward: {arg} must be float32 '
                             f'{shape} on {h.device}, got '
                             f'{tuple(t.shape)} {t.dtype} {t.device}')
    dev = h.device
    d_h_src = torch.empty((e, k), device=dev, dtype=torch.float32)
    d_h_dst = torch.empty((e, k), device=dev, dtype=torch.float32)
    d_radial = torch.empty((e,), device=dev, dtype=torch.float32)
    d_prev = (None if prev is None else
              torch.empty((e, k), device=dev, dtype=torch.float32))
    from pointvs_tpu_torch.ops._build import load
    lib = load('fused_egnn_bwd')
    width = lib.pvs_fused_backward_param_width()
    scratch = torch.empty((e if attention == 'softmax' else 1, 2),
                          device=dev, dtype=torch.float32)
    flat = torch.empty((width,), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        # One row per block; the block count follows the card's residency.
        partials = torch.empty((lib.pvs_fused_backward_num_blocks(n), width),
                               device=dev, dtype=torch.float32)
        err = lib.pvs_fused_edge_backward(
            h.data_ptr(), h_dst.data_ptr(), extras.data_ptr(),
            edge_mask.data_ptr(), senders.data_ptr(), ptr(prev),
            *[params[p].data_ptr() for p in PARAM_NAMES],
            d_agg.data_ptr(), d_phi.data_ptr(), d_att.data_ptr(), ptr(d_msg),
            d_h_src.data_ptr(), d_h_dst.data_ptr(), d_radial.data_ptr(),
            ptr(d_prev), scratch.data_ptr(), partials.data_ptr(),
            flat.data_ptr(), e, k, n, ATTENTION_MODES.index(attention),
            int(tanh), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'fused_edge_backward kernel launch failed: '
                           f'cudaError {err}')
    fused_edge_backward.launches += 1
    return d_h_src, d_h_dst, d_radial, d_prev, unpack_param_grads(flat, k)


fused_edge_backward.launches = 0


def kernel_info() -> dict:
    """K4's resources on the current CUDA device (``read_kernel_info``)."""
    return read_kernel_info('fused_egnn_bwd', 'pvs_fused_backward_info')
