"""Numerics of kernel K3 (``ops/csrc/fused_egnn.cu``) that the CPU can
check: its whole chain with the edge MLP products on tensor cores in
3xTF32, held against float64.

The chain as the kernel computes it, in float32 (x = [h[s] | h_dst |
radial, attr0..2]): pre1 = x W1^T + b1, pre2 = silu(pre1) W2^T + b2,
m = silu(pre2) (+ prev where mask > 0, selected, never multiplied),
prec = m cW1^T + cb1, phi = tanh(cw2 . silu(prec)), logit = attw . m +
attb, att the per-sender softmax with the kernel's guards (-1e30 at
masked edges, a row max of 0 when none is unmasked, the denominator
max(denom, 1e-16)) or the sigmoid, and agg[s] the per-sender sum of
where(mask > 0, att m, 0). The three products go through the numpy
emulation of ``cvt.rna`` and the 3xTF32 split of
tests/test_torch_k4_numerics.py; everything else is float32, the silus
included (the kernel's are the accurate expf and division that K4's
recompute also takes). At the layer's initial weight scales (uniform
+-1/sqrt(fan_in); cw2 xavier-uniform with gain 0.001), K = 16 and 32,
softmax and sigmoid attention, with and without the edge residual, the
split meets K3's gates
against float64 (atol 1e-5 + rtol 1e-5 per element of agg, phi, att and
msg) and plain TF32 (hi_a hi_b) misses them on msg and agg.
"""
import numpy as np
import pytest

from tests.test_torch_k4_numerics import product

OUTPUTS = ('agg', 'phi', 'att', 'msg')


def silu(v):
    return v / (1 + np.exp(-v))


def k3_case(k, residual, seed, senders=256, mean_degree=8.0):
    """Sorted senders (some without edges), 10% masked edges, NaN canaries
    in ``prev`` where the mask is 0, and the layer's weights at their
    initial scales."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(mean_degree, senders)
    deg[::9] = 0
    ids = np.repeat(np.arange(senders), deg)
    e = len(ids)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    h = rng.standard_normal((senders, k))
    x = np.concatenate([h[ids], rng.standard_normal((e, k)),
                        rng.random((e, 1)) * 16,
                        np.eye(3)[rng.integers(0, 3, e)]], 1)
    mask = (rng.random(e) >= 0.1).astype(np.float32)
    prev = (np.where(mask[:, None] > 0, rng.standard_normal((e, k)), np.nan)
            if residual else None)

    def uniform(shape, fan_in):
        return rng.uniform(-1, 1, shape) / np.sqrt(fan_in)

    fan1 = 2 * k + 4
    params = dict(w1=uniform((k, fan1), fan1), b1=uniform(k, fan1),
                  w2=uniform((k, k), k), b2=uniform(k, k),
                  cw1=uniform((k, k), k), cb1=uniform(k, k),
                  cw2=rng.uniform(-1, 1, k) * 0.001 * np.sqrt(6 / (k + 1)),
                  attw=uniform(k, k), attb=uniform(1, k))
    return dict(ids=ids, n=senders, x=f32(x), mask=mask,
                prev=None if prev is None else f32(prev),
                params={name: f32(v) for name, v in params.items()})


def k3_chain(case, matmul, dtype, attention):
    """(agg, phi, att, msg) with the edge MLP products taken by ``matmul``
    and everything else in ``dtype``."""
    p = {name: np.asarray(v, dtype) for name, v in case['params'].items()}
    mask = np.asarray(case['mask'], dtype)
    pre1 = matmul(np.asarray(case['x'], dtype), p['w1'].T) + p['b1']
    m = silu(matmul(silu(pre1), p['w2'].T) + p['b2'])
    if case['prev'] is not None:
        m = m + np.where(mask[:, None] > 0, case['prev'], 0).astype(dtype)
    prec = matmul(m, p['cw1'].T) + p['cb1']
    phi = np.tanh(silu(prec) @ p['cw2'])
    logit = m @ p['attw'] + p['attb']
    ids = case['ids']
    starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    counts = np.diff(np.r_[starts, len(ids)])

    def per_sender(reduce, v):
        return np.repeat(reduce.reduceat(v, starts), counts)

    if attention == 'softmax':
        guarded = np.where(mask > 0, logit, dtype(-1e30))
        row_max = per_sender(np.maximum, guarded)
        row_max = np.where(row_max > -1e29, row_max, 0).astype(dtype)
        expd = np.exp(guarded - row_max) * mask
        att = expd / np.maximum(per_sender(np.add, expd), dtype(1e-16))
    else:
        att = 1 / (1 + np.exp(-logit))
    agg = np.zeros((case['n'], m.shape[1]), dtype)
    agg[ids[starts]] = np.add.reduceat(
        np.where(mask[:, None] > 0, att[:, None] * m, 0).astype(dtype),
        starts)
    return agg, phi, att, m


def meets_gates(got, ref):
    err = np.abs(got.astype(np.float64) - ref)
    return bool((err <= 1e-5 + 1e-5 * np.abs(ref)).all())


@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('attention', ['softmax', 'sigmoid'])
@pytest.mark.parametrize('k', [16, 32])
def test_3xtf32_chain_meets_k3_gates_and_plain_tf32_does_not(k, attention,
                                                            residual):
    case = k3_case(k, residual, seed=k + int(residual))
    ref = k3_chain(case, np.matmul, np.float64, attention)
    three = k3_chain(case, lambda a, b: product(a, b, True), np.float32,
                     attention)
    for name, got, want in zip(OUTPUTS, three, ref):
        assert got.dtype == np.float32, name
        assert np.isfinite(got).all() and meets_gates(got, want), name
    plain = k3_chain(case, lambda a, b: product(a, b, False), np.float32,
                     attention)
    for name in ('agg', 'msg'):
        i = OUTPUTS.index(name)
        assert not meets_gates(plain[i], ref[i]), name
