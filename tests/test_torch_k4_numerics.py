"""Numerics of kernel K4 (``ops/csrc/fused_egnn_bwd.cu``) that the CPU can
check: the 3xTF32 split its tensor-core products use, and the packed
parameter-gradient layout its wrapper unpacks.

3xTF32. ``tf32`` emulates ``cvt.rna.tf32.f32`` (round to nearest, ties
away from zero: add 0x1000 to the bits, clear the low 13). Each operand x
is split into hi = tf32(x) and lo = tf32(x - hi); a product is
lo_a hi_b + hi_a lo_b + hi_a hi_b with float32 accumulation, and the
parameter gradients accumulate 64-edge tiles in float32 as the kernel's C
fragments do. Held against float64 at K4's shapes and weight scales
(U(+-1)/sqrt(fan_in)), the split meets the kernel's gates (atol 1e-5 +
rtol 1e-5 per element; 3e-5 x max(1, |ref|) for the parameter gradients)
and plain TF32 (hi_a hi_b) does not.
"""
import numpy as np
import pytest
import torch

from pointvs_tpu_torch.ops.fused_egnn import MAX_K, PARAM_NAMES
from pointvs_tpu_torch.ops.fused_egnn_bwd import unpack_param_grads

TILE = 64


def tf32(x):
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(np.float32(x) - hi)


def product(a, b, three):
    """a @ b on the tensor cores: 3xTF32 when ``three``, else plain TF32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if not three:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def tiled_outer(g, x, three):
    """g^T x accumulated tile by tile (64 edges) in float32."""
    acc = np.zeros((g.shape[1], x.shape[1]), np.float32)
    for e0 in range(0, g.shape[0], TILE):
        acc += product(g[e0:e0 + TILE].T, x[e0:e0 + TILE], three)
    return acc


def k4_operands(k, edges, seed):
    """The edge MLP input x = [h_src | h_dst | radial, one-hot attr], a
    pre-activation gradient g, and W1, W2 at their initial scales."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    x = f32(np.concatenate([
        rng.standard_normal((edges, 2 * k)), rng.random((edges, 1)) * 16,
        np.eye(3)[rng.integers(0, 3, edges)]], 1))
    g = f32(rng.standard_normal((edges, k)))
    w1 = f32(rng.uniform(-1, 1, (k, 2 * k + 4)) / np.sqrt(2 * k + 4))
    w2 = f32(rng.uniform(-1, 1, (k, k)) / np.sqrt(k))
    return x, g, w1, w2


# name -> (edges, operands -> (a, b) of the product, per-element gate)
PRODUCTS = {
    'x_w1t': (4096, lambda x, g, w1, w2: (x, w1.T), True),
    'g_w1': (4096, lambda x, g, w1, w2: (g, w1), True),
    'g_w2': (4096, lambda x, g, w1, w2: (g, w2), True),
    'gt_x': (100_032, lambda x, g, w1, w2: (g, x), False),
}


def meets_gate(got, ref, elementwise):
    err = np.abs(got.astype(np.float64) - ref)
    if elementwise:
        return bool((err <= 1e-5 + 1e-5 * np.abs(ref)).all())
    return bool(err.max() <= 3e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize('k', [16, 32])
@pytest.mark.parametrize('name', sorted(PRODUCTS))
def test_3xtf32_meets_k4_gates_and_plain_tf32_does_not(name, k):
    edges, pick, elementwise = PRODUCTS[name]
    a, b = pick(*k4_operands(k, edges, seed=k))
    ref = a.astype(np.float64) @ b.astype(np.float64) if elementwise else \
        a.astype(np.float64).T @ b.astype(np.float64)
    run = (lambda three: product(a, b, three)) if elementwise else \
        (lambda three: tiled_outer(a, b, three))
    assert meets_gate(run(True), ref, elementwise)
    assert not meets_gate(run(False), ref, elementwise)


def test_tf32_split_is_exact_to_22_bits():
    x = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21


def pack_param_grads(grads, k):
    """The kernel's packed layout (``kOff*`` in fused_egnn_bwd.cu): rows
    zero-padded to 32 features, dW1's input columns at [h_src 0.. | h_dst
    32.. | extras 64..67]; padding holds NaN so an unpack that reads it
    shows."""
    m, width = MAX_K, 2 * MAX_K + 4
    w1 = np.full((m, width), np.nan, np.float32)
    w1[:k, :k] = grads['w1'][:, :k]
    w1[:k, m:m + k] = grads['w1'][:, k:2 * k]
    w1[:k, 2 * m:] = grads['w1'][:, 2 * k:]

    def square(a):
        out = np.full((m, m), np.nan, np.float32)
        out[:k, :k] = a
        return out.ravel()

    def vector(a):
        out = np.full(m, np.nan, np.float32)
        out[:k] = a
        return out

    return np.concatenate([
        w1.ravel(), vector(grads['b1']), square(grads['w2']),
        vector(grads['b2']), square(grads['cw1']), vector(grads['cb1']),
        vector(grads['cw2']), vector(grads['attw']), grads['attb']])


@pytest.mark.parametrize('k', [16, 20, 32])
def test_unpack_param_grads_round_trip(k):
    rng = np.random.default_rng(k)
    shapes = dict(w1=(k, 2 * k + 4), b1=(k,), w2=(k, k), b2=(k,),
                  cw1=(k, k), cb1=(k,), cw2=(k,), attw=(k,), attb=(1,))
    assert tuple(shapes) == PARAM_NAMES
    grads = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
    flat = pack_param_grads(grads, k)
    assert flat.shape == (4385,)   # pvs_fused_backward_param_width()
    got = unpack_param_grads(torch.from_numpy(flat), k)
    for name in PARAM_NAMES:
        assert got[name].is_contiguous()
        np.testing.assert_array_equal(got[name].numpy(), grads[name],
                                      err_msg=name)
