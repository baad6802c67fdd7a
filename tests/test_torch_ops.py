"""The port's ops against the JAX package's, on the same numpy inputs.

EdgeAggregator forward functions, GraphNorm (per-graph and whole-batch)
and the masked mean pool, at 1e-5 (f32, different summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvs_tpu.ops.aggregate import EdgeAggregator as JaxAggregator
from pointvs_tpu.ops.graphnorm import GraphNorm as JaxGraphNorm
from pointvs_tpu.ops.segment import masked_graph_mean_pool as jax_pool
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from pointvs_tpu_torch.ops.graphnorm import GraphNorm
from pointvs_tpu_torch.ops.segment import masked_graph_mean_pool
from tests.test_torch_egnn import jax_batch

TOL = dict(atol=1e-5, rtol=1e-5)
K = 16


def _aggregators(batch):
    jax_agg = JaxAggregator(
        jnp.asarray(batch.senders), jnp.asarray(batch.receivers),
        jnp.asarray(batch.recv_perm), jnp.asarray(batch.edge_mask),
        num_nodes=batch.node_feats.shape[0],
        inv_recv_perm=(None if batch.inv_recv_perm is None
                       else jnp.asarray(batch.inv_recv_perm)))
    port_agg = EdgeAggregator(
        torch.from_numpy(batch.senders), torch.from_numpy(batch.receivers),
        torch.from_numpy(batch.edge_mask), batch.node_feats.shape[0],
        inv_recv_perm=(None if batch.inv_recv_perm is None
                       else torch.from_numpy(batch.inv_recv_perm)))
    return jax_agg, port_agg


def _edge_inputs(batch, seed=0):
    rng = np.random.RandomState(seed)
    e, n = batch.senders.shape[0], batch.node_feats.shape[0]
    return dict(node=rng.randn(n, K).astype(np.float32),
                feat=rng.randn(e, K).astype(np.float32),
                logits=(rng.randn(e, 1) * 2).astype(np.float32),
                trans=rng.randn(e, 3).astype(np.float32))


def _close(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


OPS = {
    'gather_src': lambda a, x: a.gather_src(x['node']),
    'gather_dst': lambda a, x: a.gather_dst(x['node']),
    'sum_to_src': lambda a, x: a.sum_to_src(x['feat']),
    'mean_to_src': lambda a, x: a.mean_to_src(x['feat']),
    'softmax_src': lambda a, x: a.softmax_src(x['logits']),
    'fused_sum_mean_to_src': lambda a, x: a.fused_sum_mean_to_src(
        x['feat'], x['trans']),
    'fused_softmax_aggregate': lambda a, x: a.fused_softmax_aggregate(
        x['feat'], x['logits'], x['trans']),
    'fused_sigmoid_aggregate': lambda a, x: a.fused_sigmoid_aggregate(
        x['feat'], x['logits'], x['trans']),
}


@pytest.mark.parametrize('op', sorted(OPS))
def test_edge_aggregator_matches_jax(op):
    batch = jax_batch(4, seed=3)
    jax_agg, port_agg = _aggregators(batch)
    inputs = _edge_inputs(batch)
    want = OPS[op](jax_agg, {k: jnp.asarray(v) for k, v in inputs.items()})
    got = OPS[op](port_agg, {k: torch.from_numpy(v)
                             for k, v in inputs.items()})
    _close(got, want)


def test_gather_pair_on_symmetric_edges():
    """A symmetric edge list: the one-gather pair equals the two gathers
    (and the JAX package's pair gather)."""
    from tests.setup_and_params import ORIGINAL_GRAPH as batch
    assert batch.inv_recv_perm is not None
    jax_agg, port_agg = _aggregators(batch)
    node = _edge_inputs(batch)['node']
    s, r = port_agg.gather_pair(torch.from_numpy(node))
    np.testing.assert_array_equal(r.numpy(),
                                  port_agg.gather_dst(
                                      torch.from_numpy(node)).numpy())
    _close((s, r), jax_agg.gather_pair(jnp.asarray(node)))


def _graphnorm_pair(whole_batch, seed):
    rng = np.random.RandomState(seed)
    params = {'weight': rng.uniform(0.5, 1.5, K).astype(np.float32),
              'bias': rng.randn(K).astype(np.float32) * 0.1,
              'mean_scale': rng.uniform(0.5, 1.5, K).astype(np.float32)}
    port = GraphNorm(K, whole_batch=whole_batch)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    jax_gn = JaxGraphNorm(K, whole_batch=whole_batch)
    return port, jax_gn, {'params': params}


@pytest.mark.parametrize('whole_batch', [False, True],
                         ids=['per_graph', 'whole_batch'])
def test_graphnorm_matches_jax(whole_batch):
    batch = jax_batch(4, seed=5)
    x = np.random.RandomState(1).randn(
        batch.node_feats.shape[0], K).astype(np.float32) * 3 + 1
    port, jax_gn, params = _graphnorm_pair(whole_batch, seed=2)
    args = (batch.graph_id, batch.graph_mask.shape[0], batch.node_mask)
    want = jax_gn.apply(params, jnp.asarray(x), jnp.asarray(args[0]),
                        args[1], jnp.asarray(args[2]))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(args[0]), args[1],
                   torch.from_numpy(args[2]))
    _close(got, want)
    pad = batch.node_mask == 0
    assert np.all(got.numpy()[pad] == 0)


def test_graphnorm_deep_stack_stays_finite():
    """16 GraphNorms in a row on a padded batch: padding rows must not
    grow into inf/NaN (they are zeroed each time)."""
    batch = jax_batch(3, seed=6)
    x = torch.from_numpy(np.random.RandomState(2).randn(
        batch.node_feats.shape[0], K).astype(np.float32))
    ids, mask = torch.from_numpy(batch.graph_id), torch.from_numpy(
        batch.node_mask)
    port, jax_gn, params = _graphnorm_pair(False, seed=3)
    y_port, y_jax = x, jnp.asarray(x.numpy())
    with torch.no_grad():
        for _ in range(16):
            y_port = torch.tanh(port(y_port, ids, 3, mask))
            y_jax = jnp.tanh(jax_gn.apply(params, y_jax,
                                          jnp.asarray(batch.graph_id), 3,
                                          jnp.asarray(batch.node_mask)))
    assert torch.isfinite(y_port).all()
    _close(y_port, y_jax)


def test_mean_pool_matches_jax():
    batch = jax_batch(4, seed=7)
    h = np.random.RandomState(3).randn(
        batch.node_feats.shape[0], K).astype(np.float32)
    want = jax.jit(jax_pool, static_argnums=2)(
        jnp.asarray(h), jnp.asarray(batch.graph_id),
        batch.graph_mask.shape[0], jnp.asarray(batch.node_mask))
    got = masked_graph_mean_pool(
        torch.from_numpy(h), torch.from_numpy(batch.graph_id),
        batch.graph_mask.shape[0], torch.from_numpy(batch.node_mask))
    _close(got, want)
