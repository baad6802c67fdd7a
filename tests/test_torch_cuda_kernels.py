"""The CUDA kernels against their plain PyTorch versions, on a GPU.

Imports only torch, numpy and the port, so it runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
on a machine with a CUDA GPU and nvcc. Without a GPU the tests skip.

K1/K2 edge cases (also used by tests/test_torch_segment_kernels.py against
the JAX package): K not a multiple of 8, empty rows, an all-padding tail,
tied maximum logits, rows with every edge masked, and E < 4 * 128; besides
``CASES``, a hub row of 300 edges, rows of exactly one edge, a batch of
padding edges only and a single row. K1 runs at widths 1, 2, 3, 4, 13,
16, 32, 35, 36 and 132 (4- and 16-byte columns, a lane or a few per row,
two 4-byte columns per lane, more 16-byte columns than lanes), with its
row offsets passed in and found by the wrapper, and twice for identical
bits. K3/K4
edge cases (``make_edge_case``, also used by tests/test_torch_fused_egnn.py
against the JAX package): empty senders, fully masked senders, a padding
tail, NaN canaries in the previous messages, E < 128, a single block of
senders, every attention mode, with and without the edge residual. The
tile edge cases of K3 and K4 (``tile_stress_case``, also run by
chip_smoke.py, and in their JAX layout by tests/test_torch_fused_egnn.py):
a hub sender over several tiles, senders of exactly 64 and 65 edges, tiles
straddling senders and blocks, 64+ consecutive masked edges (a tile of NaN
canaries in ``prev``), blocks without edges, K = 20 and K = 13; K3 and K4
run twice must give identical bits. The dropout-mask kernel
(``ops/dropout.py``) equals its plain version and the CPU's bit for bit.
Tolerance atol 1e-5, rtol 1e-5 (f32 sums of the same terms in a different
order); K4's parameter gradients, sums over every edge, atol 3e-5 x
max(1, |plain|).
"""
import numpy as np
import pytest
import torch

from pointvs_tpu_torch.ops import segment_kernels as sk
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from pointvs_tpu_torch.ops.fused_egnn import ATTENTION_MODES, PARAM_NAMES, \
    fused_edge_forward, fused_edge_forward_plain, fused_edge_pass
from pointvs_tpu_torch.ops.fused_egnn_bwd import fused_edge_backward, \
    fused_edge_backward_plain

TOL = dict(atol=1e-5, rtol=1e-5)
CASES = ['plain', 'small', 'empty_rows', 'padding_tail', 'tied_max',
         'all_masked_rows']
EXTRA_CASES = ['hub', 'one_edge', 'all_padding', 'n1']
K1_WIDTHS = [1, 2, 3, 4, 13, 16, 32, 35, 36, 132]


def make_case(name):
    """(ids, feat, logits, trans, mask, n) for one edge case."""
    rng = np.random.RandomState((CASES + EXTRA_CASES).index(name))
    n, e, k, pad = 300, 2400, 13, 200          # K not a multiple of 8
    if name == 'small':                        # E < 4 * 128
        n, e, k, pad = 40, 300, 16, 20
    if name == 'all_padding':                  # no real edge at all
        pad = e
    if name == 'n1':                           # a single row
        n, e, pad = 1, 40, 10
    ids = np.sort(rng.randint(0, n, e - pad))
    if name == 'empty_rows':                   # every other row empty
        ids = np.sort(rng.randint(0, n // 2, e - pad)) * 2
    if name == 'padding_tail':                 # last rows have no edges
        ids = np.sort(rng.randint(0, n // 2, e - pad))
    if name == 'hub':                          # row 7 has 300 edges
        ids = rng.randint(0, n - 1, e - pad - 300)
        ids = np.sort(np.concatenate([ids + (ids >= 7), np.full(300, 7)]))
    if name == 'one_edge':                     # rows of exactly one edge
        n, k = 300, 16
        ids = np.sort(rng.choice(n, 250, replace=False))
        e = len(ids) + pad
    ids = np.concatenate([ids, np.full(pad, n)]).astype(np.int32)
    feat = rng.randn(e, k).astype(np.float32)
    logits = (rng.randn(e) * 2).astype(np.float32)
    if name == 'tied_max':                     # ties at every row's max
        logits = np.round(logits).astype(np.float32)
    trans = rng.randn(e, 3).astype(np.float32)
    mask = (ids < n).astype(np.float32)
    mask[rng.rand(e) < 0.1] = 0.0
    if name == 'all_masked_rows':              # rows with every edge masked
        mask[(ids % 5 == 0) & (ids < n)] = 0.0
    return ids, feat, logits, trans, mask, n


def make_edge_case(seed, n=256, k=16, residual=True, dtype=np.float32,
                   mean_degree=3.0, pad=37, deg=None, masked_runs=()):
    """Edge-major inputs of one edge pass: empty senders, senders whose
    edges are all masked, 10% masked edges, a padding tail (sender == n),
    and NaN canaries in ``prev`` wherever the mask is 0. ``deg`` gives the
    edges of each sender in place of the seeded degrees; each (sender,
    offset, length) of ``masked_runs`` masks a run of that sender's edges."""
    rng = np.random.RandomState(seed)
    if deg is None:
        deg = rng.poisson(mean_degree, n)
        deg[::7] = 0                            # empty senders
        deg[n - n // 8:] = 0                    # a tail of empty senders
    n = len(deg)
    senders = np.repeat(np.arange(n), deg)
    senders = np.concatenate([senders, np.full(pad, n)]).astype(np.int32)
    e = len(senders)
    mask = (senders < n).astype(dtype)
    mask[rng.rand(e) < 0.1] = 0.0
    mask[(senders % 11 == 3) & (senders < n)] = 0.0   # fully masked senders
    first = np.concatenate([[0], np.cumsum(deg)])
    for s, off, length in masked_runs:
        mask[first[s] + off:first[s] + off + length] = 0.0
    radial = rng.rand(e) * 4
    attr = np.eye(3)[rng.randint(0, 3, e)]
    case = dict(
        h=rng.randn(n, k), h_dst=rng.randn(e, k),
        extras=np.concatenate([radial[:, None], attr], 1),
        mask=mask, senders=senders,
        prev=np.where(mask[:, None] > 0, rng.randn(e, k), np.nan)
        if residual else None,
        params=dict(
            w1=rng.uniform(-1, 1, (k, 2 * k + 4)) / np.sqrt(2 * k + 4),
            b1=rng.uniform(-0.3, 0.3, k),
            w2=rng.uniform(-1, 1, (k, k)) / np.sqrt(k),
            b2=rng.uniform(-0.3, 0.3, k),
            cw1=rng.uniform(-1, 1, (k, k)) / np.sqrt(k),
            cb1=rng.uniform(-0.3, 0.3, k),
            cw2=rng.uniform(-1, 1, k) / np.sqrt(k),
            attw=rng.uniform(-1, 1, k), attb=rng.uniform(-0.3, 0.3, 1)))
    cot = dict(d_agg=rng.randn(n, k), d_phi=rng.randn(e), d_att=rng.randn(e),
               d_msg=rng.randn(e, k))
    cast = lambda a: None if a is None else np.asarray(a, dtype)  # noqa
    case = {key: (cast(v) if key != 'params' else
                  {p: cast(a) for p, a in v.items()})
            for key, v in case.items()}
    case['senders'] = senders
    return case, {key: cast(v) for key, v in cot.items()}


def tile_stress_case(name, jax_layout=False):
    """K3's and K4's tile edge cases: (case, cotangents, attention,
    residual, tanh).

    hub*: a sender with 350 edges (six tiles), one with 70 and one with
    exactly 64 (blocks with a sender of more than 64 edges take the
    two-pass paths; sigmoid tiles straddle senders and blocks); hub65: one
    sender with exactly 65 edges, the fewest that take the two-pass paths,
    and a run of senders with exactly 64 edges, whose tiles end on a
    sender's last edge; masked_run: 130 consecutive masked edges of one
    sender, so a whole 64-edge tile of ``prev`` is NaN canaries;
    empty_block: 300 consecutive senders without edges, so whole blocks
    own none; k20 / k13: K = 20 (16-byte copies) and K = 13 (4-byte copies,
    no paired stores). Real edge counts are not multiples of 64.

    With ``jax_layout`` the layout fits the JAX kernel's 128-node windows:
    senders without edges are appended up to a multiple of 128 of at least
    256, and empty_block shrinks to 640 senders (300 of them empty).
    """
    rng = np.random.RandomState(len(name))

    def layout(deg):
        if not jax_layout:
            return deg
        n = max(256, -(-len(deg) // 128) * 128)
        return np.concatenate([deg, np.zeros(n - len(deg), deg.dtype)])

    if name.startswith('hub'):
        deg = rng.poisson(6.0, 200)
        if name == 'hub65':
            deg[7] = 65
            deg[100:104] = 64
        else:
            deg[7], deg[40], deg[41] = 350, 70, 64
        attention, residual = (('sigmoid', False) if name == 'hub_sigmoid'
                               else ('softmax', True))
        case, cot = make_edge_case(5 if name == 'hub65' else 1, k=32,
                                   residual=residual, deg=layout(deg),
                                   pad=29)
        return case, cot, attention, residual, True
    if name == 'masked_run':
        deg = rng.poisson(6.0, 300)
        deg[5] = 200
        case, cot = make_edge_case(2, k=32, deg=layout(deg), pad=29,
                                   masked_runs=[(5, 20, 130)])
        return case, cot, 'softmax', True, True
    if name == 'empty_block':
        deg = rng.poisson(6.0, 640 if jax_layout else 3000)
        if jax_layout:
            deg[100:400] = 0
        else:
            deg[1000:1300] = 0
        case, cot = make_edge_case(3, k=32, residual=False, deg=layout(deg),
                                   pad=29)
        return case, cot, 'softmax', False, True
    k = {'k20': 20, 'k13': 13}[name]
    case, cot = make_edge_case(4, k=k, deg=layout(rng.poisson(9.0, 400)),
                               pad=29)
    return case, cot, 'softmax', True, False


TILE_STRESS = ['hub', 'hub_sigmoid', 'hub65', 'masked_run', 'empty_block',
               'k20', 'k13']


def _t(*arrays, device):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES)
def test_cuda_kernels_match_plain(case, cuda_device):
    ids, feat, logits, trans, mask, n = make_case(case)
    args = _t(feat, logits, trans, mask, ids, device=cuda_device)
    before = sk.launch_counts()
    got = sk.windowed_segment_sum(args[0], args[4], n)
    want = sk.windowed_segment_sum_plain(args[0], args[4], n)
    torch.testing.assert_close(got, want, **TOL)
    for mode in ('softmax', 'sigmoid'):
        out, seg_max = sk.fused_softmax_aggregate(*args, n, mode)
        want_out, want_max = sk.fused_softmax_aggregate_plain(*args, n, mode)
        torch.testing.assert_close(out, want_out, **TOL)
        torch.testing.assert_close(seg_max, want_max, **TOL)
    torch.cuda.synchronize()
    after = sk.launch_counts()
    assert after['segment_sum_sorted'] == before['segment_sum_sorted'] + 1
    assert (after['softmax_aggregate_sorted']
            == before['softmax_aggregate_sorted'] + 2)


def _width_case(case, k):
    """(ids, data [E, k], n): a case's ids with features of width k."""
    ids, _, _, _, _, n = make_case(case)
    rng = np.random.RandomState(100 + k)
    return ids, rng.randn(len(ids), k).astype(np.float32), n


def _unaligned_copy(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary, so the kernels take their 4-byte loads."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out = flat.view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4 and out.is_contiguous()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('k', K1_WIDTHS)
@pytest.mark.parametrize('case', CASES + EXTRA_CASES[:2])
def test_k1_widths_match_plain(case, k, cuda_device):
    """K1 at every width against the plain version (evaluated in float64:
    the f32 plain version on the card adds by atomics, in no fixed order,
    and on the 300-edge row errs by as much as the gate), also with 4-byte
    loads at a width that takes 16-byte ones; offsets passed in and found
    by the wrapper, and a repeat, give identical bits; the wrapper finds
    offsets only when none are passed."""
    ids_np, data_np, n = _width_case(case, k)
    data, ids = _t(data_np, ids_np, device=cuda_device)
    before = sk.launch_counts()
    offsets = sk.segment_offsets(ids, n)
    got = sk.windowed_segment_sum(data, ids, n, offsets)
    again = sk.windowed_segment_sum(data, ids, n, offsets)
    found = sk.windowed_segment_sum(data, ids, n)
    unaligned = sk.windowed_segment_sum(_unaligned_copy(data), ids, n,
                                        offsets)
    want = sk.windowed_segment_sum_plain(data.double(), ids, n).float()
    torch.cuda.synchronize()
    after = sk.launch_counts()
    np.testing.assert_array_equal(offsets.cpu().numpy(),
                                  np.searchsorted(ids_np, np.arange(n + 1)))
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(unaligned, want, **TOL)
    assert torch.equal(got, again) and torch.equal(got, found)
    assert after['segment_sum_sorted'] == before['segment_sum_sorted'] + 4
    assert after['segment_offsets'] == before['segment_offsets'] + 2


@pytest.mark.cuda
@pytest.mark.parametrize('width', ['own', 32])
@pytest.mark.parametrize('mode', ['softmax', 'sigmoid'])
@pytest.mark.parametrize('case', CASES + EXTRA_CASES[:2])
def test_k2_matches_plain_with_offsets(case, mode, width, cuda_device):
    """K2 in both modes at the case's width (13 or 16) and at 32, against
    the plain version (in float64, as for K1): offsets passed in or found
    by the wrapper, and a repeat, give identical bits; the dead column and
    sigmoid's seg_max are zero."""
    ids, feat, logits, trans, mask, n = make_case(case)
    if width == 32:
        feat = np.random.RandomState(132).randn(len(ids), 32).astype(
            np.float32)
    args = _t(feat, logits, trans, mask, ids, device=cuda_device)
    k = feat.shape[1]
    before = sk.launch_counts()
    offsets = sk.segment_offsets(args[4], n)
    got = sk.fused_softmax_aggregate(*args, n, mode, offsets)
    again = sk.fused_softmax_aggregate(*args, n, mode, offsets)
    found = sk.fused_softmax_aggregate(*args, n, mode)
    want = sk.fused_softmax_aggregate_plain(
        *[a.double() for a in args[:4]], args[4], n, mode)
    torch.cuda.synchronize()
    after = sk.launch_counts()
    for g, a, f, w in zip(got, again, found, want):
        torch.testing.assert_close(g, w.float(), **TOL)
        assert torch.equal(g, a) and torch.equal(g, f)
    assert torch.all(got[0][:, k + 3] == 0)
    if mode == 'sigmoid':
        assert torch.all(got[1] == 0)
    assert (after['softmax_aggregate_sorted']
            == before['softmax_aggregate_sorted'] + 3)
    assert after['segment_offsets'] == before['segment_offsets'] + 2


def two_launch_mean_to_src(agg, data, mask):
    """``EdgeAggregator.mean_to_src`` as two K1 launches (sums, counts)."""
    total = agg.sum_to_src(data, mask)
    counts = agg.sum_to_src(mask, torch.ones_like(mask))
    denom = torch.maximum(counts, counts.new_tensor(1.0))
    return total / (denom[:, None] if data.dim() > 1 else denom)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', ['rows', 'vector'])
def test_mean_to_src_one_launch_equals_two_launch_form(shape, cuda_device):
    """The packed [data * mask | mask] launch sums each column alone in
    edge order, so it gives the two-launch form's bits."""
    ids, feat, _, trans, mask, n = make_case('plain')
    data = trans if shape == 'rows' else feat[:, 0].copy()
    ids_t, data_t, mask_t = _t(ids, data, mask, device=cuda_device)
    agg = EdgeAggregator(ids_t, ids_t, mask_t, num_nodes=n)
    outs, grads = [], []
    for fn in (agg.mean_to_src, lambda d, m: two_launch_mean_to_src(
            agg, d, m)):
        leaf = data_t.clone().requires_grad_(True)
        before = sk.launch_counts()['segment_sum_sorted']
        out = fn(leaf, mask_t)
        outs.append((out, sk.launch_counts()['segment_sum_sorted'] - before))
        (out * out).sum().backward()
        grads.append(leaf.grad)
    (one, one_launches), (two, two_launches) = outs
    assert (one_launches, two_launches) == (1, 2)
    assert torch.equal(one, two)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-6, rtol=0)


def _edge_tensors(case, device):
    t = lambda a: None if a is None else torch.from_numpy(a).to(device)  # noqa
    return (t(case['h']), t(case['h_dst']), t(case['extras']),
            t(case['mask']), t(case['senders']), t(case['prev']),
            {p: t(a) for p, a in case['params'].items()})


# (attention, residual, tanh, n, k, mean degree, padding edges)
EDGE_CASES = [(a, res, a in ('softmax', 'relu', 'none'), 600, 32, 6.0, 100)
              for a in ATTENTION_MODES for res in (False, True)] + [
    ('softmax', True, True, 300, 16, 4.0, 50),     # K < 32
    ('softmax', False, True, 20, 32, 3.0, 9),      # E < 128, one block
    ('sigmoid', True, False, 1, 32, 5.0, 3),       # one node, all padding
]


def _edge_case_id(c):
    return f'{c[0]}-res{int(c[1])}-n{c[3]}-k{c[4]}'


@pytest.mark.cuda
@pytest.mark.parametrize('case', EDGE_CASES, ids=_edge_case_id)
def test_fused_edge_kernels_match_plain(case, cuda_device):
    attention, residual, tanh, n, k, degree, pad = case
    data, cot = make_edge_case(EDGE_CASES.index(case), n=n, k=k,
                               residual=residual, mean_degree=degree,
                               pad=pad)
    args = _edge_tensors(data, cuda_device)
    d = {key: torch.from_numpy(v).to(cuda_device) for key, v in cot.items()}
    before = sk.launch_counts()
    got = fused_edge_forward(*args[:5], args[5], args[6], attention, tanh)
    want = fused_edge_forward_plain(*args[:5], args[5], args[6], attention,
                                    tanh)
    for name, g, w in zip(('agg', 'phi', 'att', 'msg'), got, want):
        torch.testing.assert_close(g, w, **TOL, msg=name)
    for d_msg in (d['d_msg'], None):
        cots = (d['d_agg'], d['d_phi'], d['d_att'], d_msg)
        got = fused_edge_backward(*args, *cots, attention, tanh)
        want = fused_edge_backward_plain(*args, *cots, attention, tanh)
        for name, g, w in zip(('d_h_src', 'd_h_dst', 'd_radial', 'd_prev'),
                              got[:4], want[:4]):
            if w is None:
                assert g is None
            else:
                torch.testing.assert_close(g, w, **TOL, msg=name)
        for name in PARAM_NAMES:
            scale = max(1.0, want[4][name].abs().max().item())
            torch.testing.assert_close(got[4][name], want[4][name],
                                       atol=3e-5 * scale, rtol=0, msg=name)
        again = fused_edge_backward(*args, *cots, attention, tanh)
        for name in PARAM_NAMES:   # no float atomics: identical bits
            assert torch.equal(again[4][name], got[4][name]), name
    torch.cuda.synchronize()
    after = sk.launch_counts()
    assert after['fused_edge_forward'] == before['fused_edge_forward'] + 1
    assert after['fused_edge_backward'] == before['fused_edge_backward'] + 4


@pytest.mark.cuda
@pytest.mark.parametrize('name', TILE_STRESS)
def test_k4_tile_edge_cases_match_plain(name, cuda_device):
    data, cot, attention, residual, tanh = tile_stress_case(name)
    args = _edge_tensors(data, cuda_device)
    cots = [None if cot[key] is None else
            torch.from_numpy(cot[key]).to(cuda_device)
            for key in ('d_agg', 'd_phi', 'd_att', 'd_msg')]
    before = sk.launch_counts()['fused_edge_backward']
    got = fused_edge_backward(*args, *cots, attention, tanh)
    again = fused_edge_backward(*args, *cots, attention, tanh)
    want = fused_edge_backward_plain(*args, *cots, attention, tanh)
    for name_, g, a, w in zip(('d_h_src', 'd_h_dst', 'd_radial', 'd_prev'),
                              got[:4], again[:4], want[:4]):
        if w is None:
            assert g is None and not residual
            continue
        torch.testing.assert_close(g, w, **TOL, msg=name_)
        assert torch.equal(g, a), name_
    for p in PARAM_NAMES:
        scale = max(1.0, want[4][p].abs().max().item())
        torch.testing.assert_close(got[4][p], want[4][p], atol=3e-5 * scale,
                                   rtol=0, msg=p)
        assert torch.equal(got[4][p], again[4][p]), p
    torch.cuda.synchronize()
    assert sk.launch_counts()['fused_edge_backward'] == before + 2


def _double(x):
    """``x`` (a tensor, a dict of tensors or None) in float64."""
    if isinstance(x, dict):
        return {k: v.double() for k, v in x.items()}
    if torch.is_tensor(x) and x.is_floating_point():
        return x.double()
    return x


def _k3_matches_plain_and_repeats(data, attention, tanh, device):
    """K3 against its plain version evaluated in float64 and cast back
    (the float32 plain version sums by atomics in no fixed order, and its
    own rounding can reach the gate), and bit-identical on repeat."""
    args = _edge_tensors(data, device)
    before = sk.launch_counts()['fused_edge_forward']
    got = fused_edge_forward(*args, attention, tanh)
    again = fused_edge_forward(*args, attention, tanh)
    want = [w.float() for w in fused_edge_forward_plain(
        *[_double(a) for a in args], attention, tanh)]
    for name, g, a, w in zip(('agg', 'phi', 'att', 'msg'), got, again,
                             want):
        torch.testing.assert_close(g, w, **TOL, msg=name)
        assert torch.equal(g, a), name   # no float atomics: identical bits
    torch.cuda.synchronize()
    assert sk.launch_counts()['fused_edge_forward'] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize('name', TILE_STRESS)
def test_k3_tile_edge_cases_match_plain(name, cuda_device):
    data, _, attention, _, tanh = tile_stress_case(name)
    _k3_matches_plain_and_repeats(data, attention, tanh, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize('attention', ATTENTION_MODES)
def test_k3_two_pass_blocks_every_attention_mode(attention, cuda_device):
    """hub65's layout in every mode: blocks with a 65-edge sender take
    the two-pass path, the others the one-pass path."""
    data, _, _, _, _ = tile_stress_case('hub65')
    _k3_matches_plain_and_repeats(data, attention, attention != 'relu',
                                  cuda_device)


@pytest.mark.cuda
def test_fused_edge_pass_backward_launches_k4(cuda_device):
    data, _ = make_edge_case(3, n=300, k=32)
    h, h_dst, extras, mask, senders, prev, params = _edge_tensors(
        data, cuda_device)
    leaves = [h, h_dst, prev] + [params[p] for p in PARAM_NAMES]
    for x in leaves:
        x.requires_grad_(True)
    before = sk.launch_counts()
    agg, phi, _, msg = fused_edge_pass(h, h_dst, extras, prev, params, mask,
                                       senders, 'softmax', True)
    (agg.square().sum() + torch.where(mask > 0, phi, 0.0).sum()
     + torch.where(mask[:, None] > 0, msg, 0.0).sum()).backward()
    after = sk.launch_counts()
    assert after['fused_edge_forward'] == before['fused_edge_forward'] + 1
    assert after['fused_edge_backward'] == before['fused_edge_backward'] + 1
    assert after['segment_sum_sorted'] == before['segment_sum_sorted'] + 1
    assert all(torch.isfinite(x.grad).all() for x in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['plain', 'empty_rows', 'all_masked_rows'])
def test_aggregation_gradients_on_gpu_match_cpu(case, cuda_device):
    """K1/K2 under autograd on the card against the plain versions' autograd
    on the CPU: the gathers (sorted, unsorted, pair), the sum, the mean and
    the softmax / sigmoid aggregations."""
    ids, feat, logits, trans, mask, n = make_case(case)
    rng = np.random.RandomState(7)
    node = rng.randn(n, 8).astype(np.float32)
    recv = rng.permutation(ids).astype(np.int32)   # unsorted, same padding

    def run(device):
        leaves = [torch.from_numpy(a).to(device).requires_grad_(True)
                  for a in (feat, logits, trans, node)]
        f, lg, tr, nd = leaves
        i, r, m = (torch.from_numpy(a).to(device) for a in (ids, recv, mask))
        agg = EdgeAggregator(i, r, m, num_nodes=n)
        outs = [agg.sum_to_src(f, mask=m), agg.mean_to_src(tr, mask=m),
                *agg.fused_softmax_aggregate(f, lg, tr, mask=m),
                *agg.fused_sigmoid_aggregate(f, lg, tr, mask=m),
                agg.gather_src(nd), agg.gather_dst(nd)]
        weights = np.random.RandomState(8)
        loss = sum((o * torch.from_numpy(weights.randn(*o.shape).astype(
            np.float32)).to(device)).sum() for o in outs)
        loss.backward()
        return [x.grad.cpu() for x in leaves]

    counts = sk.launch_counts()
    got = run(cuda_device)
    after = sk.launch_counts()
    assert after['segment_sum_sorted'] > counts['segment_sum_sorted']
    assert (after['softmax_aggregate_sorted']
            == counts['softmax_aggregate_sorted'] + 2)
    # The aggregator's two offset computations (senders, and the sorted
    # receivers for gather_dst's backward); no launch found its own.
    assert after['segment_offsets'] == counts['segment_offsets'] + 2
    for g, w in zip(got, run(torch.device('cpu'))):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['plain', 'empty_rows', 'all_masked_rows'])
def test_destination_aggregations_on_gpu_match_cpu(case, cuda_device):
    """The lucid and en_transformer paths under autograd on the card
    against the plain versions on the CPU: sum_to_dst and mean_to_dst (K1
    over receivers_sorted; their backward a gather by the receivers) and
    a 4-head softmax_src (one K1 launch for all heads' denominators)."""
    ids, feat, logits, trans, mask, n = make_case(case)
    rng = np.random.RandomState(9)
    recv = rng.permutation(ids).astype(np.int32)   # unsorted, same padding
    heads = rng.randn(len(ids), 4).astype(np.float32)

    def run(device):
        leaves = [torch.from_numpy(a).to(device).requires_grad_(True)
                  for a in (feat, trans, heads)]
        f, tr, hd = leaves
        i, r, m = (torch.from_numpy(a).to(device) for a in (ids, recv, mask))
        agg = EdgeAggregator(i, r, m, num_nodes=n)
        outs = [agg.sum_to_dst(f, mask=m), agg.mean_to_dst(tr, mask=m),
                agg.mean_to_dst(f), agg.softmax_src(hd, mask=m)]
        weights = np.random.RandomState(10)
        loss = sum((o * torch.from_numpy(weights.randn(*o.shape).astype(
            np.float32)).to(device)).sum() for o in outs)
        loss.backward()
        return [o.detach().cpu() for o in outs] + [x.grad.cpu()
                                                   for x in leaves]

    counts = sk.launch_counts()
    got = run(cuda_device)
    after = sk.launch_counts()
    # 3 destination sums and the softmax's denominators forward; the
    # denominators' gather backward.
    assert after['segment_sum_sorted'] == counts['segment_sum_sorted'] + 5
    assert after['segment_offsets'] == counts['segment_offsets'] + 2
    for g, w in zip(got, run(torch.device('cpu'))):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1001, 37), (4096, 64), (7,)],
                         ids=str)
def test_threefry_dropout_matches_plain_and_the_cpu(shape, cuda_device):
    """The dropout-mask kernel (scalar and float4 paths) against its plain
    version on the card and on the CPU: masks, values and the gradient bit
    for bit; a misaligned view takes the scalar path."""
    from pointvs_tpu_torch.ops import prng
    from pointvs_tpu_torch.ops.dropout import threefry_dropout, \
        threefry_dropout_plain
    key = prng.step_key(4, 2)
    x = torch.from_numpy(np.random.RandomState(3).randn(*shape).astype(
        np.float32))
    gpu = x.to(cuda_device).requires_grad_(True)
    before = threefry_dropout.launches
    got = threefry_dropout(gpu, key, 0.1)
    got.backward(torch.ones_like(got))
    assert threefry_dropout.launches == before + 2
    want = threefry_dropout(x, key, 0.1)
    assert torch.equal(got.detach().cpu(), want)
    assert torch.equal(got.detach(), threefry_dropout_plain(
        gpu.detach(), key, 0.1))
    assert torch.equal(gpu.grad.cpu(), threefry_dropout(
        torch.ones_like(x), key, 0.1))
    view = torch.cat([x.new_zeros(1), x.reshape(-1)]).to(cuda_device)[1:]
    assert torch.equal(threefry_dropout(view, key, 0.1).cpu(),
                       threefry_dropout(x.reshape(-1), key, 0.1))
