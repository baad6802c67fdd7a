"""The two segment kernels' plain versions against the JAX package.

Same inputs (made with numpy from a seed) through the port's plain
versions (what a CPU tensor takes) and through the JAX functions they
replace: the Pallas kernels in interpret mode, as
tests/test_pallas_kernels.py runs them, and the XLA paths the JAX package
takes on the CPU. Tolerance atol 1e-5, rtol 1e-5: f32 sums of the same
terms in a different order. The cases are those of
tests/test_torch_cuda_kernels.py, which holds the CUDA kernels against
the same plain versions on a GPU.
"""
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
from tests.test_torch_cuda_kernels import CASES, TOL, make_case


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
