"""The two segment kernels' plain versions against the JAX package.

Same inputs (made with numpy from a seed) through the port's plain
versions (what a CPU tensor takes) and through the JAX functions they
replace: the Pallas kernels in interpret mode, as
tests/test_pallas_kernels.py runs them, and the XLA paths the JAX package
takes on the CPU. Tolerance atol 1e-5, rtol 1e-5: f32 sums of the same
terms in a different order. The cases are those of
tests/test_torch_cuda_kernels.py, which holds the CUDA kernels against
the same plain versions on a GPU. Also the row offsets the kernels read
(``segment_offsets``) against numpy and the JAX wrappers' window starts,
``EdgeAggregator`` with its cached offsets against the JAX aggregator, and
``mean_to_src``'s one packed launch against its two-launch form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvs_tpu.ops.aggregate import EdgeAggregator as JaxAggregator
from pointvs_tpu.ops.pallas.segment_kernels import (
    pallas_fused_softmax_aggregate,
    pallas_windowed_segment_sum,
)
from pointvs_tpu.ops.sorted_segment import WINDOW, _xla_windowed_impl
from pointvs_tpu_torch.ops import segment_kernels as sk
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from tests.test_torch_cuda_kernels import CASES, EXTRA_CASES, TOL, \
    make_case, two_launch_mean_to_src


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize('case', CASES)
def test_segment_sum_matches_jax(case):
    ids, feat, _, _, _, n = make_case(case)
    e, k = feat.shape
    max_eb = -(-e // 128) * 128                # covers any window's load
    got = sk.windowed_segment_sum(*_t(feat, ids), n).numpy()
    pallas = np.asarray(pallas_windowed_segment_sum(
        jnp.asarray(feat), jnp.asarray(ids), n, WINDOW, max_eb,
        interpret=True))
    xla = np.asarray(_xla_windowed_impl(
        jnp.asarray(feat), jnp.asarray(ids), n, WINDOW, max_eb))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)
    empty = np.bincount(ids[ids < n], minlength=n) == 0
    assert np.all(got[empty] == 0)


@pytest.mark.parametrize('mode', ['softmax', 'sigmoid'])
@pytest.mark.parametrize('case', CASES)
def test_softmax_aggregate_matches_pallas(case, mode):
    ids, feat, logits, trans, mask, n = make_case(case)
    e, k = feat.shape
    max_eb = -(-e // 128) * 128
    out, seg_max = sk.fused_softmax_aggregate(
        *_t(feat, logits, trans, mask, ids), n, mode)
    want_out, want_max = pallas_fused_softmax_aggregate(
        jnp.asarray(feat), jnp.asarray(logits), jnp.asarray(trans),
        jnp.asarray(mask), jnp.asarray(ids), n, WINDOW, max_eb,
        interpret=True, mode=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(seg_max.numpy(), np.asarray(want_max), **TOL)
    assert np.all(out.numpy()[:, k + 3] == 0)   # the dead column


@pytest.mark.parametrize('mode', ['softmax', 'sigmoid'])
@pytest.mark.parametrize('case', CASES)
def test_fused_aggregate_matches_jax_composable(case, mode):
    """After the wrapper's division, against the branch the JAX package
    takes on the CPU (aggregate.py, composable softmax / sigmoid)."""
    ids, feat, logits, trans, mask, n = make_case(case)
    port = EdgeAggregator(*_t(ids, ids), torch.from_numpy(mask), n)
    jax_agg = JaxAggregator(jnp.asarray(ids), jnp.asarray(ids), None,
                            jnp.asarray(mask), n)
    fn = ('fused_softmax_aggregate' if mode == 'softmax'
          else 'fused_sigmoid_aggregate')
    got = getattr(port, fn)(*_t(feat, logits[:, None], trans))
    want = getattr(jax_agg, fn)(jnp.asarray(feat),
                                jnp.asarray(logits[:, None]),
                                jnp.asarray(trans))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_cpu_wrapper_counts_no_launch():
    ids, feat, logits, trans, mask, n = make_case('plain')
    before = sk.launch_counts()
    sk.windowed_segment_sum(*_t(feat, ids), n)
    sk.fused_softmax_aggregate(*_t(feat, logits, trans, mask, ids), n)
    assert sk.launch_counts() == before


@pytest.mark.parametrize('case', CASES + ['hub', 'all_padding', 'n1'])
def test_segment_offsets_match_searchsorted_and_window_starts(case):
    """offsets[n] is the first edge with id >= n; at every WINDOW-th row
    they are the JAX wrappers' window starts before the 128-alignment
    (``pointvs_tpu/ops/pallas/segment_kernels.py:206-209``)."""
    ids, _, _, _, _, n = make_case(case)
    got = sk.segment_offsets(torch.from_numpy(ids), n)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n + 1,)
    got = got.numpy()
    np.testing.assert_array_equal(got, np.searchsorted(ids, np.arange(n + 1)))
    assert got[n] == np.sum(ids < n)
    nb = -(-n // WINDOW)
    starts = jnp.searchsorted(jnp.asarray(ids),
                              jnp.arange(nb, dtype=jnp.int32) * WINDOW)
    np.testing.assert_array_equal(got[::WINDOW][:nb], np.asarray(starts))


@pytest.mark.parametrize('k', [1, 3, 35])
def test_segment_sum_narrow_and_odd_widths_match_pallas(k):
    """The plain K1 at the fused path's widths (1 and 3 in mean_to_src's
    old form, 35 in gather_dst's backward) on the hub case."""
    ids, _, _, _, _, n = make_case('hub')
    data = np.random.RandomState(k).randn(len(ids), k).astype(np.float32)
    max_eb = -(-len(ids) // 128) * 128
    got = sk.windowed_segment_sum(*_t(data, ids), n).numpy()
    want = np.asarray(pallas_windowed_segment_sum(
        jnp.asarray(data), jnp.asarray(ids), n, WINDOW, max_eb,
        interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('case', ['plain', 'hub', 'one_edge'])
def test_aggregator_cached_offsets_match_jax(case):
    """The port's aggregator finds the senders' offsets once and the sorted
    receivers' at the first gather with a backward; every aggregation and
    both gathers' gradients match the JAX aggregator's."""
    ids, feat, logits, trans, mask, n = make_case(case)
    recv = np.random.RandomState(9).permutation(ids).astype(np.int32)
    port = EdgeAggregator(*_t(ids, recv), torch.from_numpy(mask), n)
    jax_agg = JaxAggregator(jnp.asarray(ids), jnp.asarray(recv),
                            jnp.asarray(np.argsort(recv, kind='stable')),
                            jnp.asarray(mask), n)
    np.testing.assert_array_equal(port.src_offsets.numpy(),
                                  np.searchsorted(ids, np.arange(n + 1)))
    assert port.dst_offsets is None
    node = np.random.RandomState(10).randn(n, 5).astype(np.float32)
    f, lg, tr = _t(feat, logits[:, None], trans)
    for name, got, want in [
            ('sum', port.sum_to_src(f), jax_agg.sum_to_src(feat)),
            ('mean', port.mean_to_src(tr), jax_agg.mean_to_src(trans)),
            ('softmax', port.softmax_src(lg),
             jax_agg.softmax_src(jnp.asarray(logits[:, None]))),
            ('fused_softmax', port.fused_softmax_aggregate(f, lg, tr),
             jax_agg.fused_softmax_aggregate(
                 jnp.asarray(feat), jnp.asarray(logits[:, None]),
                 jnp.asarray(trans)))]:
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=name)
    leaf = torch.from_numpy(node).requires_grad_(True)
    (port.gather_src(leaf).sum(1) * torch.from_numpy(logits)
     + port.gather_dst(leaf).sum(1) * torch.from_numpy(mask)).sum().backward()
    np.testing.assert_array_equal(
        port.dst_offsets.numpy(),
        np.searchsorted(np.sort(recv), np.arange(n + 1)))

    def jax_loss(h):
        return jnp.sum(jax_agg.gather_src(h).sum(1) * logits
                       + jax_agg.gather_dst(h).sum(1) * mask)
    want = jax.grad(jax_loss)(jnp.asarray(node))
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('shape', ['rows', 'vector', 'rows_no_mask'])
def test_mean_to_src_one_launch_matches_two_launch_form(shape):
    """[data * mask | mask] in one segment sum gives the two-sum form's
    means and gradients (the CPU takes the plain K1; the cuda test holds
    the bits through K1)."""
    ids, feat, _, trans, mask, n = make_case('empty_rows')
    data = trans if shape != 'vector' else feat[:, 0].copy()
    mask_t = torch.from_numpy(mask)
    agg = EdgeAggregator(*_t(ids, ids), mask_t, n)
    if shape == 'rows_no_mask':     # the aggregator's edge mask is taken
        outs = [agg.mean_to_src, lambda d: two_launch_mean_to_src(
            agg, d, mask_t)]
    else:
        outs = [lambda d: agg.mean_to_src(d, mask_t),
                lambda d: two_launch_mean_to_src(agg, d, mask_t)]
    results = []
    for fn in outs:
        leaf = torch.from_numpy(data).requires_grad_(True)
        out = fn(leaf)
        (out * torch.arange(out.numel()).reshape(out.shape).float().cos()
         ).sum().backward()
        results.append((out.detach(), leaf.grad))
    (one, d_one), (two, d_two) = results
    torch.testing.assert_close(one, two, atol=1e-6, rtol=0)
    torch.testing.assert_close(d_one, d_two, atol=1e-6, rtol=0)
