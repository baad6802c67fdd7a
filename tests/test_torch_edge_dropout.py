"""Edge dropout and remat in the port against the JAX package.

The undirected mask equals ``pointvs_tpu.ops.edge_dropout`` bit for bit
(node ids up to 2**31 - 1, four seeds); (i, j) and (j, i) share their
fate; a training forward with a fixed seed equals the JAX model's
``apply(..., train=True)`` within 1e-5 when the JAX model draws the same
seed (its draw is replaced inside the test); under the step's JAX key the
port draws the seed the reference draws (flax's ``make_rng('dropout')``
in the model's root scope, then ``randint``) and its training forward
equals the reference's, for egnn and multitask, with nothing replaced;
remat leaves the loss and every gradient unchanged within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvs_tpu.ops.edge_dropout import \
    undirected_edge_dropout as jax_edge_dropout
import flax.linen as fnn
from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu_torch.ops import prng
from pointvs_tpu_torch.ops.edge_dropout import undirected_edge_dropout
from pointvs_tpu_torch.training.losses import loss_fn
from tests.setup_and_params import ORIGINAL_GRAPH
from tests.test_torch_egnn import DIM_IN, K, LAYERS, jax_batch, \
    jax_model_and_params, port_batch, port_model
from tests.test_torch_lucid import FWD_TOL, draw_params, port_from_jax

FLAGS = dict(residual=True, normalize=True, tanh=True, graphnorm=True,
             edge_attention=True, softmax_attention=True, dropout=0.3)
SEED = 12345


def _edges(n=50000, seed=0):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 2 ** 31 - 1, n).astype(np.int32)
    r = rng.randint(0, 2 ** 31 - 1, n).astype(np.int32)
    s[:8], r[4:12] = 2 ** 31 - 1, 0
    mask = np.ones(n, np.float32)
    mask[-5:] = 0
    return s, r, mask


@pytest.mark.parametrize('seed', [0, 1, 0x7fffffff, 0xffffffff])
def test_mask_is_bit_identical_to_jax(seed):
    s, r, mask = _edges()
    want = np.asarray(jax_edge_dropout(jnp.asarray(s), jnp.asarray(r),
                                       jnp.asarray(mask), 0.3,
                                       jnp.uint32(seed)))
    got = undirected_edge_dropout(torch.from_numpy(s), torch.from_numpy(r),
                                  torch.from_numpy(mask), 0.3, seed).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.65 < got[:-5].mean() < 0.75 and not got[-5:].any()


def test_both_directions_share_their_fate():
    s, r, _ = _edges(seed=1)
    s_t, r_t = torch.from_numpy(s), torch.from_numpy(r)
    ones = torch.ones(len(s))
    for seed in (7, 0xdeadbeef):
        np.testing.assert_array_equal(
            undirected_edge_dropout(s_t, r_t, ones, 0.5, seed).numpy(),
            undirected_edge_dropout(r_t, s_t, ones, 0.5, seed).numpy())


def test_train_forward_matches_jax_with_the_same_seed(monkeypatch):
    model, params = jax_model_and_params(FLAGS, ORIGINAL_GRAPH, False,
                                         seed=2)
    monkeypatch.setattr(jax.random, 'randint',
                        lambda *a, **k: jnp.asarray(SEED, jnp.int32))
    want = np.asarray(model.apply(params, ORIGINAL_GRAPH, train=True,
                                  rngs={'dropout': jax.random.PRNGKey(0)}))
    plain = np.asarray(model.apply(params, ORIGINAL_GRAPH))
    port = port_model(FLAGS, params)
    batch = port_batch(ORIGINAL_GRAPH)
    with torch.no_grad():
        got = port(batch, train=True, dropout_seed=SEED).numpy()
        got_eval = port(batch).numpy()
    dropped = undirected_edge_dropout(batch.senders, batch.receivers,
                                      batch.edge_mask, 0.3, SEED)
    assert 0 < dropped.sum() < batch.edge_mask.sum()
    assert np.abs(want - plain).max() > 1e-4   # the mask changed it
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_eval, plain, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('name', ['egnn', 'multitask'])
def test_egnn_dropout_key_and_forward_match_flax(name):
    """The EGNN's ``make_rng('dropout')`` in its root scope, its randint
    seed, and the training forward it drops edges by."""
    batch = jax_batch(3, seed=1)
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  residual=True, normalize=True, edge_attention=True,
                  softmax_attention=True, dropout=0.3)
    model = build_jax_model(name, **kwargs)
    params = draw_params(model, batch, seed=2)
    key = prng.step_key(4, 9)
    rngs = {'dropout': jnp.asarray(key)}
    root = fnn.apply(lambda m: m.make_rng('dropout'), model)(
        params, rngs=rngs)
    np.testing.assert_array_equal(prng.make_rng(key, ()), np.asarray(root))
    assert prng.egnn_edge_dropout_seed(key) == int(jax.random.randint(
        root, (), 0, jnp.iinfo(jnp.int32).max))
    want = np.asarray(model.apply(params, batch, train=True, rngs=rngs))
    plain = np.asarray(model.apply(params, batch))
    port = port_from_jax(name, params, **kwargs)
    with torch.no_grad():
        got = port(port_batch(batch), train=True, dropout_rng=key).numpy()
    assert np.abs(want - plain).max() > 1e-4
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_remat_leaves_loss_and_gradients_unchanged():
    _, params = jax_model_and_params(FLAGS, ORIGINAL_GRAPH, False, seed=3)
    batch = port_batch(ORIGINAL_GRAPH)
    results = []
    for remat in (False, True):
        model = port_model(dict(FLAGS, remat=remat), params).train()
        loss_sum, weight = loss_fn(
            model(batch, train=True, dropout_seed=SEED), batch,
            'classification')
        loss = loss_sum / weight.clamp_min(1.0)
        loss.backward()
        results.append((loss.item(), [p.grad.clone()
                                      for p in model.parameters()]))
    (loss_a, grads_a), (loss_b, grads_b) = results
    assert abs(loss_a - loss_b) <= 1e-6
    assert len(grads_a) == len(grads_b)
    for a, b in zip(grads_a, grads_b):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0)
