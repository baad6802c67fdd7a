"""The port's scale-out against the JAX package's, on gloo CPU ranks.

The port runs one process per rank over ``torch.distributed``; the JAX
package runs one process over the suite's 8 forced XLA host devices
(``tests/conftest.py``). Both get the same numpy inputs (made from a
seed) and the same weights (``state_dict_from_flax``). One 2-rank gloo
group (``tests/torch_scale_out_worker.py``) serves every 2-rank case and
one 4-rank group the 2-D case:

- ``EdgeAggregator`` edge-sharded over 2 ranks (sums, means, softmax,
  sigmoid, to the senders and to the receivers): outputs and the
  gradients of each rank's edge inputs against JAX's aggregator under
  ``shard_map`` (whose psum transposes to a psum, as the port's
  all-reduce does), within 1e-5;
- egnn, lucid and en_transformer forwards on 2 edge shards against
  ``make_sharded_forward``, within 1e-5; the port's ``shard_graph_batch``
  against the reference's, array for array;
- ``make_sharded_train_step`` (SGD, 3 steps), the dp train step at D=2
  with strict GraphNorm and dropout 0.1 (20 steps of Adam against JAX's
  ``make_train_step`` on a 2-device mesh) and the 2-D dp x gp multitask
  step (dropout 0.1, 3 steps) against ``make_train_step_2d``: losses and
  final weights within atol 1e-4 / rtol 1e-5;
- the loader's stripes: a disjoint, order-keeping partition of one
  seeded index stream, the reference loader's stripes exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from pointvs_tpu.data.buckets import pad_graphs_to_batch as jax_pad
from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu.ops.aggregate import EdgeAggregator as JaxAggregator
from pointvs_tpu.parallel import graph_shard as jax_gs
from pointvs_tpu.parallel.mesh import get_mesh, get_mesh_2d, replicate, \
    shard_batch
from pointvs_tpu.parallel.steps import make_train_step as jax_train_step
from pointvs_tpu.training.optimisers import build_optimiser as jax_optimiser
from pointvs_tpu_torch.data.buckets import GraphBatch
from pointvs_tpu_torch.data.buckets import GraphSample as PortSample
from pointvs_tpu_torch.models.params import state_dict_from_flax
from pointvs_tpu_torch.ops.prng import fold_in, prng_key
from pointvs_tpu_torch.parallel.graph_shard import shard_graph_batch
from tests.test_forward_parity import _random_samples
from tests.test_torch_lucid import draw_params
from tests.test_train_trajectory import _random_samples as traj_samples
from tests.torch_scale_out_worker import AGG_OPS, EDGE_INPUTS, run_ranks

K, DIM_IN, LAYERS = 16, 12, 2
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
TRAJ_TOL = dict(atol=1e-4, rtol=1e-5)
LR, WD = 2e-3, 1e-4

EGNN = dict(residual=True, normalize=True, tanh=True, graphnorm=True)
FORWARDS = {   # name -> (family, flags)
    'egnn_softmax': ('egnn', dict(EGNN, edge_attention=True,
                                  softmax_attention=True)),
    'egnn_sigmoid_strict': ('egnn', dict(EGNN, edge_attention=True,
                                         graphnorm_whole_batch=True)),
    'egnn_plain': ('egnn', dict(EGNN)),
    'lucid': ('lucid', dict(attention=True, norm_coords=True,
                            norm_feats=True, graphnorm=True)),
    'en_transformer': ('en_transformer', dict(heads=2)),
}


def _port_sample(s) -> PortSample:
    return PortSample(node_feats=s.node_feats, coords=s.coords,
                      senders=s.senders, receivers=s.receivers,
                      edge_attr=s.edge_attr, y=s.y)


def _fields(batch) -> dict:
    """A (JAX or port) GraphBatch as the port's GraphBatch fields."""
    return {f: (None if getattr(batch, f) is None
                else np.asarray(getattr(batch, f)))
            for f in GraphBatch._fields}


def _model_kwargs(flags, dim_output=1):
    return dict(dim_input=DIM_IN, k=K, dim_output=dim_output,
                num_layers=LAYERS, **flags)


def _params(family, kwargs, batch, seed=0):
    return draw_params(build_jax_model(family, **kwargs), batch, seed)


# ---------------------------------------------------------- 2-rank group
def _aggregate_inputs():
    samples = _random_samples(3, seed=11)
    full = jax_pad(samples, num_graphs=3)
    shards = jax_gs.shard_graph_batch(samples, 2, num_graphs=3)
    rng = np.random.RandomState(5)
    e = shards.senders.shape[1]
    n = full.node_feats.shape[0]
    edge = {'feat': rng.randn(2, e, K), 'logits': rng.randn(2, e, 1) * 2,
            'trans': rng.randn(2, e, 3)}
    edge = {k: v.astype(np.float32) for k, v in edge.items()}
    # Every op's output shapes on one shard, for its cotangents (the
    # same on both ranks).
    agg = JaxAggregator(jnp.asarray(shards.senders[0]),
                        jnp.asarray(shards.receivers[0]),
                        jnp.asarray(shards.recv_perm[0]),
                        jnp.asarray(shards.edge_mask[0]), num_nodes=n)
    probe = {k: jnp.zeros(v.shape[1:]) for k, v in edge.items()}
    cots = {}
    for op, fn in AGG_OPS.items():
        res = fn(agg, probe)
        res = res if isinstance(res, tuple) else (res,)
        cots[op] = [rng.randn(*r.shape).astype(np.float32) for r in res]
    port_shards = [dict(senders=shards.senders[d],
                        receivers=shards.receivers[d],
                        recv_perm=shards.recv_perm[d],
                        edge_mask=shards.edge_mask[d],
                        **{k: edge[k][d] for k in EDGE_INPUTS})
                   for d in range(2)]
    payload = dict(n_gp=2, num_nodes=n, shards=port_shards,
                   cotangents=cots)
    return payload, shards, edge, n


def _jax_aggregate(op, shards, edge, n, cots):
    """JAX's EdgeAggregator under shard_map over 2 devices: outputs
    [2, ...] (one per device) and each device's edge-input gradients."""
    mesh = JaxMesh(np.array(jax.devices()[:2]), ('gp',))

    def device(senders, receivers, recv_perm, edge_mask, feat, logits,
               trans):
        agg = JaxAggregator(senders[0], receivers[0], recv_perm[0],
                            edge_mask[0], num_nodes=n, axis_name='gp')

        def loss(*xs):
            res = AGG_OPS[op](agg, dict(zip(EDGE_INPUTS, xs)))
            res = res if isinstance(res, tuple) else (res,)
            return sum(jnp.sum(r * c) for r, c in zip(res, cots)), res

        (_, res), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(feat[0], logits[0],
                                                   trans[0])
        return (tuple(r[None] for r in res),
                tuple(g[None] for g in grads))

    fn = jax.jit(shard_map(device, mesh=mesh, in_specs=(P('gp'),) * 7,
                           out_specs=P('gp'), check_rep=False))
    return jax.tree.map(np.asarray, fn(
        shards.senders, shards.receivers, shards.recv_perm,
        shards.edge_mask, edge['feat'], edge['logits'], edge['trans']))


def _forward_inputs(name):
    family, flags = FORWARDS[name]
    samples = _random_samples(2, seed=len(name))
    kwargs = _model_kwargs(flags)
    params = _params(family, kwargs, jax_pad(samples, num_graphs=2))
    port = shard_graph_batch([_port_sample(s) for s in samples], 2,
                             num_graphs=2)
    payload = dict(n_gp=2, name=family, kwargs=kwargs,
                   state_dict=_numpy_sd(params),
                   shards=[_fields(b) for b in port])
    return payload, samples, params


def _numpy_sd(params):
    return {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree.map(np.asarray, params)).items()}


def _jax_sharded_forward(name, samples, params):
    family, flags = FORWARDS[name]
    model = build_jax_model(family, edge_shard_axis='gp',
                            **_model_kwargs(flags))
    mesh = get_mesh(2, axis_name='gp')
    batch = jax_gs.shard_graph_batch(samples, 2, num_graphs=2)
    fwd = jax_gs.make_sharded_forward(model, mesh)
    return np.asarray(fwd(replicate(params, mesh),
                          shard_batch(batch, mesh, axis_name='gp')))


def _keys(seed, steps):
    return [fold_in(prng_key(seed), t) for t in range(steps)]


def _sharded_train_inputs():
    """One 2-graph batch, edges over 2 gp ranks, 3 SGD steps."""
    samples = _random_samples(2, seed=21)
    flags = dict(EGNN, edge_attention=True, softmax_attention=True)
    kwargs = _model_kwargs(flags)
    params = _params('egnn', kwargs, jax_pad(samples, num_graphs=2), 3)
    port = shard_graph_batch([_port_sample(s) for s in samples], 2,
                             num_graphs=2)
    payload = dict(n_gp=2, name='egnn', kwargs=kwargs,
                   state_dict=_numpy_sd(params), optimiser='sgd', wd=WD,
                   lr=0.05, task='classification',
                   batches=[[_fields(b) for b in port]] * 3,
                   keys=[None] * 3)
    return payload, samples, params


def _jax_sharded_train(samples, params, payload):
    model = build_jax_model('egnn', edge_shard_axis='gp',
                            **payload['kwargs'])
    mesh = get_mesh(2, axis_name='gp')
    tx = jax_optimiser('sgd', WD)
    step = jax_gs.make_sharded_train_step(model, tx, 'classification', 'mse',
                                          mesh)
    batch = shard_batch(jax_gs.shard_graph_batch(samples, 2, num_graphs=2),
                        mesh, axis_name='gp')
    params = replicate(params, mesh)
    opt_state = replicate(tx.init(params), mesh)
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, batch,
                                       jnp.float32(payload['lr']),
                                       jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses, params


def _rows(seed, n_rows, graphs, n_batches=4):
    """``n_batches`` batches of ``n_rows`` rows of ``graphs`` samples, every
    row padded to one shape."""
    rng = np.random.RandomState(seed)
    sets = [[traj_samples(graphs, rng) for _ in range(n_rows)]
            for _ in range(n_batches)]
    n_pad = max(sum(s.num_nodes for s in row) for b in sets
                for row in b) + 7
    e_pad = max(sum(s.num_edges for s in row) for b in sets
                for row in b) + 13
    return sets, n_pad, e_pad


DP_STEPS = 20


def _dp_inputs():
    """2 dp rows of 4 graphs, strict GraphNorm and edge dropout 0.1."""
    sets, n_pad, e_pad = _rows(31, 2, 4)
    flags = dict(EGNN, edge_attention=True, softmax_attention=True,
                 graphnorm_whole_batch=True, dropout=0.1)
    kwargs = _model_kwargs(flags)
    rows = [[jax_pad(row, num_graphs=4, n_pad=n_pad, e_pad=e_pad)
             for row in b] for b in sets]
    params = _params('egnn', kwargs, rows[0][0], 4)
    keys = _keys(7, DP_STEPS)
    payload = dict(n_gp=1, name='egnn', kwargs=kwargs,
                   state_dict=_numpy_sd(params), optimiser='adam', wd=WD,
                   lr=LR, task='classification',
                   batches=[[_fields(r) for r in rows[t % 4]]
                            for t in range(DP_STEPS)],
                   keys=keys)
    return payload, rows, params


def _jax_dp_train(rows, params, payload):
    model = build_jax_model('egnn', batch_shard_axis='dp',
                            **payload['kwargs'])
    mesh = get_mesh(2)
    tx = jax_optimiser('adam', WD)
    step = jax_train_step(model, tx, 'classification', 'mse', mesh)
    stacked = [shard_batch(jax.tree.map(lambda *xs: np.stack(xs), *b),
                           mesh) for b in rows]
    params = replicate(params, mesh)
    opt_state = replicate(tx.init(params), mesh)
    losses = []
    for t, key in enumerate(payload['keys']):
        params, opt_state, loss = step(params, opt_state, stacked[t % 4],
                                       jnp.float32(LR),
                                       jnp.asarray(key, jnp.uint32))
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
    return losses, params


@pytest.fixture(scope='module')
def two_ranks():
    agg_payload, agg_shards, agg_edge, n = _aggregate_inputs()
    cases = {'aggregate': ('aggregate', agg_payload)}
    forwards = {}
    for name in FORWARDS:
        payload, samples, params = _forward_inputs(name)
        cases[f'forward_{name}'] = ('forward', payload)
        forwards[name] = (samples, params)
    sharded_payload, sharded_samples, sharded_params = \
        _sharded_train_inputs()
    cases['sharded_train'] = ('train', sharded_payload)
    dp_payload, dp_rows, dp_params = _dp_inputs()
    cases['dp_train'] = ('train', dp_payload)
    results = run_ranks(2, cases)
    return dict(
        results=results,
        aggregate=(agg_payload, agg_shards, agg_edge, n),
        forwards=forwards,
        sharded=(sharded_payload, sharded_samples, sharded_params),
        dp=(dp_payload, dp_rows, dp_params))


@pytest.mark.parametrize('op', sorted(AGG_OPS))
def test_sharded_aggregation_matches_jax(two_ranks, op):
    payload, shards, edge, n = two_ranks['aggregate']
    want_out, want_grads = _jax_aggregate(
        op, shards, edge, n, payload['cotangents'][op])
    for rank, result in enumerate(two_ranks['results']):
        outs, grads = result['aggregate'][op]
        assert len(outs) == len(want_out)
        for got, want in zip(outs, want_out):
            np.testing.assert_allclose(got, want[rank], **FWD_TOL)
        for name, got, want in zip(EDGE_INPUTS, grads, want_grads):
            want = want[rank]
            got = np.zeros_like(want) if got is None else got
            np.testing.assert_allclose(got, want, err_msg=f'd/d{name}',
                                       **FWD_TOL)


def test_shard_graph_batch_matches_jax():
    samples = _random_samples(3, seed=2)
    want = jax_gs.shard_graph_batch(samples, 4, num_graphs=3)
    got = shard_graph_batch([_port_sample(s) for s in samples], 4,
                            num_graphs=3)
    assert len(got) == 4
    for d, shard in enumerate(got):
        assert shard.inv_recv_perm is None
        for field in GraphBatch._fields[:-1]:
            np.testing.assert_array_equal(
                getattr(shard, field), np.asarray(getattr(want, field))[d],
                err_msg=field)


@pytest.mark.parametrize('name', sorted(FORWARDS))
def test_sharded_forward_matches_jax(two_ranks, name):
    samples, params = two_ranks['forwards'][name]
    want = _jax_sharded_forward(name, samples, params)
    for result in two_ranks['results']:
        np.testing.assert_allclose(result[f'forward_{name}'], want,
                                   **FWD_TOL)


def test_sharded_train_step_matches_jax(two_ranks):
    payload, samples, params = two_ranks['sharded']
    losses, want = _jax_sharded_train(samples, params, payload)
    want = state_dict_from_flax(jax.tree.map(np.asarray, want))
    for result in two_ranks['results']:
        got = result['sharded_train']
        np.testing.assert_allclose(got['losses'], losses, **TRAJ_TOL)
        for key, value in want.items():
            np.testing.assert_allclose(got['state_dict'][key],
                                       value.numpy(), err_msg=key,
                                       **TRAJ_TOL)


def test_dp_train_step_matches_jax(two_ranks):
    """D=2, strict GraphNorm over the global batch, edge dropout 0.1 keyed
    by fold_in(step key, dp rank): 20 steps against JAX's 2-device
    make_train_step."""
    payload, rows, params = two_ranks['dp']
    losses, want = _jax_dp_train(rows, params, payload)
    want = state_dict_from_flax(jax.tree.map(np.asarray, want))
    a, b = (r['dp_train'] for r in two_ranks['results'])
    assert a['losses'] == b['losses'] and len(a['losses']) == DP_STEPS
    np.testing.assert_allclose(a['losses'], losses, **TRAJ_TOL)
    for key, value in want.items():
        np.testing.assert_array_equal(a['state_dict'][key],
                                      b['state_dict'][key])
        np.testing.assert_allclose(a['state_dict'][key], value.numpy(),
                                   err_msg=key, **TRAJ_TOL)


# ------------------------------------------------------ 4-rank 2-D group
TWO_D_STEPS = 3


@pytest.fixture(scope='module')
def four_ranks():
    """dp 2 x gp 2: multitask affinity head, dropout 0.1."""
    sets, n_pad, e_pad = _rows(41, 2, 2, n_batches=TWO_D_STEPS)
    flags = dict(EGNN, edge_attention=True, softmax_attention=True,
                 dropout=0.1)
    kwargs = _model_kwargs(flags)
    full = jax_pad(sets[0][0], num_graphs=2, n_pad=n_pad, e_pad=e_pad)
    params = _params('multitask', kwargs, full, 5)
    keys = _keys(9, TWO_D_STEPS)
    batches = []
    for b in sets:
        pieces = []
        for row in b:
            pieces += [_fields(s) for s in shard_graph_batch(
                [_port_sample(s) for s in row], 2, num_graphs=2,
                n_pad=n_pad, e_pad=e_pad)]
        batches.append(pieces)
    payload = dict(n_gp=2, name='multitask', kwargs=kwargs,
                   state_dict=_numpy_sd(params), optimiser='adam', wd=WD,
                   lr=LR, task='regression', multitask=True,
                   batches=batches, keys=keys)
    results = run_ranks(4, {'train_2d': ('train', payload)})

    model = build_jax_model('multitask', edge_shard_axis='gp', **kwargs)
    mesh = get_mesh_2d(2, 2)
    tx = jax_optimiser('adam', WD)
    step = jax_gs.make_train_step_2d(model, tx, 'regression', 'mse', mesh,
                                     multitask=True)
    jparams = replicate(params, mesh)
    opt_state = replicate(tx.init(jparams), mesh)
    losses = []
    for b, key in zip(sets, keys):
        batch = shard_batch(jax_gs.stack_2d_batches(
            b, 2, num_graphs=2, n_pad=n_pad, e_pad=e_pad), mesh,
            ('dp', 'gp'))
        jparams, opt_state, loss = step(jparams, opt_state, batch,
                                        jnp.float32(LR),
                                        jnp.asarray(key, jnp.uint32))
        losses.append(float(loss))
    want = state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    return results, losses, want


def test_2d_multitask_train_step_matches_jax(four_ranks):
    results, losses, want = four_ranks
    for result in results:
        got = result['train_2d']
        np.testing.assert_allclose(got['losses'], losses, **TRAJ_TOL)
        for key, value in want.items():
            np.testing.assert_allclose(got['state_dict'][key],
                                       value.numpy(), err_msg=key,
                                       **TRAJ_TOL)


# ------------------------------------------------------------- loaders
@pytest.mark.parametrize('weighted', [False, True],
                         ids=['shuffled', 'weighted'])
def test_loader_stripes_partition_the_stream(weighted):
    """Each rank's stripe of the seeded stream is the reference loader's,
    and the stripes partition the one-rank stream in order."""
    from pointvs_tpu.data.loader import GraphDataLoader as JaxLoader
    from pointvs_tpu_torch.data.loader import GraphDataLoader

    class _Dataset:
        model_task = 'classification'
        sample_weights = (np.linspace(1, 3, 11) if weighted else None)
        rot, p_noise, p_remove_entity = False, -1, 0

        def __len__(self):
            return 11

    ds = _Dataset()
    full = GraphDataLoader(ds, batch_size=4, mode='train', seed=3,
                           prefetch=0)
    stripes = [GraphDataLoader(ds, batch_size=2, mode='train', seed=3,
                               prefetch=0, shard_index=r, num_shards=2)
               for r in range(2)]
    refs = [JaxLoader(ds, batch_size=2, mode='train', seed=3, prefetch=0,
                      shard_index=r, num_shards=2) for r in range(2)]
    assert [len(s) for s in stripes] == [len(full)] * 2 == \
        [len(r) for r in refs]
    for _ in range(3):
        idx = full._epoch_indices()
        got = [s._epoch_indices() for s in stripes]
        np.testing.assert_array_equal(np.sort(np.concatenate(got)),
                                      np.sort(idx))
        for r in range(2):
            np.testing.assert_array_equal(got[r], idx[r::2])
            np.testing.assert_array_equal(got[r], refs[r]._epoch_indices())



@pytest.mark.parametrize('graph_shard', [1, 2])
def test_exhausted_stripe_yields_blank_batches(graph_shard, tmp_path):
    """9 poses over 2 dp ranks at 2 a step: both ranks yield len(loader)
    = 3 batches, the stripes cover every pose once, and the second
    rank's third batch has no real slot, node or edge (it adds nothing to
    a loss or a whole-batch statistic)."""
    from pointvs_tpu_torch.data.loader import get_data_loader
    from tests.setup_and_params import RESOURCES
    from tests.test_torch_train_loader import write_types
    types = write_types(tmp_path / 'train.types', n=9)
    loaders = [get_data_loader(
        RESOURCES, types, batch_size=2, mode='val', radius=4, edge_radius=4,
        estimate_bonds=True, polar_hydrogens=False, prefetch=0,
        shard_index=r, num_shards=2,
        graph_shard=graph_shard) for r in range(2)]
    batches = [list(loader) for loader in loaders]
    assert [len(b) for b in batches] == [len(loaders[0])] * 2 == [3, 3]
    items = np.concatenate([m.items for b in batches for _, m in b])
    np.testing.assert_array_equal(np.sort(items), np.arange(9))
    blank, meta = batches[1][2]
    assert len(meta.items) == 0 and meta.lig_fnames == []
    for field in ('graph_mask', 'node_mask', 'edge_mask', 'y'):
        assert not getattr(blank, field).any(), field
    full, _ = batches[0][0]
    assert full.node_mask.any() and full.graph_mask.all()
