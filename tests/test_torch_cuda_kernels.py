"""The CUDA kernels against their plain PyTorch versions, on a GPU.

Imports only torch, numpy and the port, so it runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
on a machine with a CUDA GPU and nvcc. Without a GPU the tests skip. The
edge cases (also used by tests/test_torch_segment_kernels.py against the
JAX package): K not a multiple of 8, empty rows, an all-padding tail, tied
maximum logits, rows with every edge masked, and E < 4 * 128. Tolerance
atol 1e-5, rtol 1e-5: f32 sums of the same terms in a different order.
"""
import numpy as np
import pytest
import torch

from pointvs_tpu_torch.ops import segment_kernels as sk

TOL = dict(atol=1e-5, rtol=1e-5)
CASES = ['plain', 'small', 'empty_rows', 'padding_tail', 'tied_max',
         'all_masked_rows']


def make_case(name):
    """(ids, feat, logits, trans, mask, n) for one edge case."""
    rng = np.random.RandomState(CASES.index(name))
    n, e, k, pad = 300, 2400, 13, 200          # K not a multiple of 8
    if name == 'small':                        # E < 4 * 128
        n, e, k, pad = 40, 300, 16, 20
    ids = np.sort(rng.randint(0, n, e - pad))
    if name == 'empty_rows':                   # every other row empty
        ids = np.sort(rng.randint(0, n // 2, e - pad)) * 2
    if name == 'padding_tail':                 # last rows have no edges
        ids = np.sort(rng.randint(0, n // 2, e - pad))
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
