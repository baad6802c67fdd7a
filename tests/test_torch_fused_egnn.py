"""The fused edge pass (K3/K4 plain versions) against the JAX package.

Same inputs (numpy, seeded) go through the JAX Pallas kernels in interpret
mode and the port's plain versions, converting between the reference's
feature-major ``[K, E_pad]`` / ``[8, E_pad]`` layout and the port's
edge-major one. Tolerances: per-edge outputs and cotangents atol 1e-5,
compared where ``edge_mask > 0`` (the reference leaves other positions
uninitialised); ``agg`` everywhere; parameter gradients atol 3e-5 x
max(1, |ref|) (sums over all edges in another order). The edge cases
come from ``tests/test_torch_cuda_kernels.make_edge_case`` and
``tile_stress_case``, which the GPU tests share.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvs_tpu.ops.pallas.fused_egnn import fused_edge_forward as \
    jax_fused_edge_forward
from pointvs_tpu.ops.pallas.fused_egnn_bwd import fused_edge_backward as \
    jax_fused_edge_backward
from pointvs_tpu_torch.ops.fused_egnn import ATTENTION_MODES, PARAM_NAMES, \
    FusedEdgePass, fused_edge_forward_plain
from pointvs_tpu_torch.ops.fused_egnn_bwd import fused_edge_backward_plain
from tests.test_torch_cuda_kernels import make_edge_case, tile_stress_case

WINDOW = 128


def _torch(case):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return (t(case['h']), t(case['h_dst']), t(case['extras']),
            t(case['mask']), t(case['senders']), t(case['prev']),
            {p: t(a) for p, a in case['params'].items()})


def _jax_layout(case):
    """The reference kernels' arguments: feature-major, padded by max_eb
    columns so every window's slice holds all of its edges."""
    n, k = case['h'].shape
    e = len(case['senders'])
    max_eb = -(-e // 128) * 128 + 128
    cols = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((max_eb,) + a.shape[1:], a.dtype)]).T
    extras_t = np.zeros((8, e + max_eb), np.float32)
    extras_t[0:4, :e] = case['extras'].T
    extras_t[4, :e] = case['mask']
    extras_t[5] = n
    extras_t[5, :e] = case['senders']
    p = case['params']
    params = dict(w1=p['w1'], b1=p['b1'][:, None], w2=p['w2'],
                  b2=p['b2'][:, None], cw1=p['cw1'], cb1=p['cb1'][:, None],
                  cw2=p['cw2'][None, :], attw=p['attw'][None, :],
                  attb=p['attb'][None, :])
    prev_t = None if case['prev'] is None else cols(case['prev'])
    return (dict(h=case['h'], h_dst_t=cols(case['h_dst']), extras_t=extras_t,
                 prev_t=prev_t, params={q: jnp.asarray(a)
                                        for q, a in params.items()}),
            dict(num_nodes=n, window=WINDOW, max_eb=max_eb), cols)


def _assert_edges(got, want, mask, name, atol=1e-5):
    keep = mask > 0
    np.testing.assert_allclose(np.asarray(got)[keep], np.asarray(want)[keep],
                               atol=atol, rtol=1e-5, err_msg=name)


FWD_CASES = [(a, tanh, res) for a in ATTENTION_MODES for tanh in (False, True)
             for res in (False, True)]


def _forward_matches_jax_kernel(case, attention, tanh):
    args, kw, _ = _jax_layout(case)
    agg, phi_t, att_t, msg_t = jax_fused_edge_forward(
        args['h'], args['h_dst_t'], args['extras_t'], args['prev_t'],
        args['params'], attention=attention, tanh=tanh, emit_messages=True,
        interpret=True, **kw)
    h, h_dst, extras, mask, senders, prev, params = _torch(case)
    g_agg, g_phi, g_att, g_msg = fused_edge_forward_plain(
        h, h_dst, extras, mask, senders, prev, params, attention, tanh)
    e = len(case['senders'])
    np.testing.assert_allclose(g_agg.numpy(), np.asarray(agg), atol=1e-5,
                               rtol=1e-5)
    _assert_edges(g_phi.numpy(), np.asarray(phi_t)[0, :e], case['mask'],
                  'phi')
    _assert_edges(g_msg.numpy(), np.asarray(msg_t)[:, :e].T, case['mask'],
                  'messages')
    if attention != 'none':
        _assert_edges(g_att.numpy(), np.asarray(att_t)[0, :e], case['mask'],
                      'attention')
    for out in (g_agg, g_phi, g_att, g_msg):
        assert torch.isfinite(out).all()


@pytest.mark.parametrize('attention,tanh,residual', FWD_CASES)
def test_plain_forward_matches_jax_kernel(attention, tanh, residual):
    case, _ = make_edge_case(ATTENTION_MODES.index(attention), k=16,
                             residual=residual)
    _forward_matches_jax_kernel(case, attention, tanh)


@pytest.mark.parametrize('name', ['hub', 'hub_sigmoid', 'hub65',
                                  'masked_run', 'empty_block'])
def test_plain_forward_matches_jax_kernel_on_tile_layouts(name):
    """The plain version that the card holds K3 against, on the layouts
    K3's block and tile cuts depend on (hub senders of 350, 70, 65 and 64
    edges, a tile of NaN canaries, blocks without edges), in the JAX
    kernel's window layout."""
    case, _, attention, _, tanh = tile_stress_case(name, jax_layout=True)
    _forward_matches_jax_kernel(case, attention, tanh)


@pytest.mark.parametrize('attention', ATTENTION_MODES)
def test_plain_backward_matches_jax_kernel(attention):
    seed = 10 + ATTENTION_MODES.index(attention)
    residual = attention in ('softmax', 'sigmoid', 'none')
    tanh = attention in ('softmax', 'relu', 'none')
    with_dmsg = attention != 'tanh'
    case, cot = make_edge_case(seed, k=16, residual=residual)
    args, kw, cols = _jax_layout(case)
    e = len(case['senders'])

    def rows8(a):   # a per-edge row as the reference's 8-row block
        return np.broadcast_to(cols(a)[None, :], (8, cols(a).shape[0]))

    d_hsrc_t, d_hdst_t, d_rad_t, d_prev_t, d_params = \
        jax_fused_edge_backward(
            args['h'], args['h_dst_t'], args['extras_t'], args['prev_t'],
            args['params'], cot['d_agg'], rows8(cot['d_phi']),
            rows8(cot['d_att']), cols(cot['d_msg']) if with_dmsg else None,
            attention=attention, tanh=tanh, interpret=True, **kw)
    h, h_dst, extras, mask, senders, prev, params = _torch(case)
    t = {key: torch.from_numpy(v) for key, v in cot.items()}
    got = fused_edge_backward_plain(
        h, h_dst, extras, mask, senders, prev, params, t['d_agg'],
        t['d_phi'], t['d_att'], t['d_msg'] if with_dmsg else None,
        attention, tanh)
    _assert_edges(got[0].numpy(), np.asarray(d_hsrc_t)[:, :e].T,
                  case['mask'], 'd_h_src')
    _assert_edges(got[1].numpy(), np.asarray(d_hdst_t)[:, :e].T,
                  case['mask'], 'd_h_dst')
    _assert_edges(got[2].numpy(), np.asarray(d_rad_t)[0, :e], case['mask'],
                  'd_radial')
    if residual:
        _assert_edges(got[3].numpy(), np.asarray(d_prev_t)[:, :e].T,
                      case['mask'], 'd_prev')
    shapes = {q: v.shape for q, v in case['params'].items()}
    for name in PARAM_NAMES:
        want = np.asarray(d_params[name]).reshape(shapes[name])
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got[4][name].numpy(), want,
                                   atol=3e-5 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize('attention,residual', [
    ('softmax', True), ('sigmoid', False), ('tanh', False), ('silu', True),
    ('none', True)])
def test_fused_edge_pass_gradcheck(attention, residual):
    """FusedEdgePass (plain K3 forward, plain K4 backward and the K1
    scatter) against finite differences, in float64 at E ~ 64, on the
    outputs' defined positions."""
    case, _ = make_edge_case(20, n=16, k=4, residual=residual,
                             dtype=np.float64)
    h, h_dst, extras, mask, senders, prev, params = _torch(case)
    if prev is not None:
        prev = torch.nan_to_num(prev)
    attrs = extras[:, 1:]
    inputs = [h, h_dst, extras[:, 0].contiguous()] + (
        [prev] if prev is not None else []) + [params[p] for p in PARAM_NAMES]
    inputs = [x.clone().requires_grad_(True) for x in inputs]

    def fn(*xs):
        h_, hd_, rad_ = xs[:3]
        prev_ = xs[3] if prev is not None else None
        ws = xs[4:] if prev is not None else xs[3:]
        ext = torch.cat([rad_[:, None], attrs], dim=1)
        agg, phi, att, msg = FusedEdgePass.apply(
            h_, hd_, ext, prev_, *ws, mask, senders, attention, True)
        # Per-edge outputs are defined where mask > 0 only: the backward
        # selects the cotangents of the others out, as the reference does.
        keep = mask > 0
        return (agg, torch.where(keep, phi, 0.0), torch.where(keep, att, 0.0),
                torch.where(keep[:, None], msg, 0.0))

    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-5,
                                    rtol=1e-4)
