"""The port's scoring batches against the JAX package's data loader.

On tests/resources/test.types both pipelines must produce the same real
rows: node features, coordinates, masks, graph ids, edges (sorted by
sender, then receiver), edge attributes and the symmetric-edge inverse
permutation. Padded sizes may differ (the port does not grow the edge
padding for the TPU's window capacity); the padding conventions are
asserted on the port's batch.
"""
import numpy as np
import pytest

from pointvs_tpu.data import get_data_loader as jax_get_data_loader
from pointvs_tpu_torch.data.loader import get_data_loader
from tests.setup_and_params import RESOURCES

SETTINGS = {
    'estimate_bonds': dict(radius=4, edge_radius=4, estimate_bonds=True,
                           prune=False, use_atomic_numbers=False),
    'pruned_atomic_numbers': dict(radius=6, edge_radius=3,
                                  estimate_bonds=False, prune=True,
                                  use_atomic_numbers=True),
}


def _batches(settings, batch_size):
    common = dict(compact=True, polar_hydrogens=False, **settings)
    jax_dl = jax_get_data_loader(
        RESOURCES, types_fname=RESOURCES / 'test.types',
        batch_size=batch_size, rot=False, mode='val', prefetch=0, **common)
    jax_batch = next(iter(jax_dl))[0]
    jax_batch = type(jax_batch)(*[None if a is None else np.asarray(a)[0]
                                  for a in jax_batch])
    port_batch, meta = next(iter(get_data_loader(
        RESOURCES, RESOURCES / 'test.types', batch_size=batch_size,
        **common)))
    return jax_batch, port_batch, meta


@pytest.mark.parametrize('batch_size', [2, 3], ids=['full', 'short'])
@pytest.mark.parametrize('name', sorted(SETTINGS))
def test_batch_matches_jax_loader(name, batch_size):
    want, got, meta = _batches(SETTINGS[name], batch_size)
    n = int(want.node_mask.sum())
    e = int(want.edge_mask.sum())
    assert n > 0 and e > 0
    assert int(got.node_mask.sum()) == n and int(got.edge_mask.sum()) == e
    for field in ('node_feats', 'coords', 'node_mask', 'graph_id'):
        np.testing.assert_array_equal(getattr(got, field)[:n],
                                      getattr(want, field)[:n], field)
    for field in ('senders', 'receivers', 'edge_attr', 'edge_mask',
                  'inv_recv_perm'):
        np.testing.assert_array_equal(getattr(got, field)[:e],
                                      getattr(want, field)[:e], field)
    for field in ('y', 'graph_mask'):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), field)
    assert len(meta.lig_fnames) == int(want.graph_mask.sum())

    # Padding conventions.
    n_pad, num_graphs = got.node_feats.shape[0], got.graph_mask.shape[0]
    assert num_graphs == batch_size
    assert np.all(got.graph_id[n:] == num_graphs)
    assert np.all(got.node_mask[n:] == 0) and np.all(got.coords[n:] == 0)
    assert np.all(got.senders[e:] == n_pad)
    assert np.all(got.receivers[e:] == n_pad)
    assert np.all(got.edge_mask[e:] == 0)
    assert np.all(np.diff(got.senders) >= 0)
    np.testing.assert_array_equal(got.receivers[got.recv_perm], got.senders)
    np.testing.assert_array_equal(got.inv_recv_perm[got.recv_perm],
                                  np.arange(len(got.senders)))


def test_asymmetric_edges_have_no_inverse_permutation():
    from pointvs_tpu_torch.data.buckets import GraphSample, \
        pad_graphs_to_batch
    sample = GraphSample(
        node_feats=np.zeros((3, 12), np.float32),
        coords=np.zeros((3, 3), np.float32),
        senders=np.array([0, 1], np.int32),
        receivers=np.array([1, 2], np.int32),
        edge_attr=np.zeros((2, 3), np.float32), y=np.float32(1))
    batch = pad_graphs_to_batch([sample], num_graphs=2)
    assert batch.inv_recv_perm is None
    assert batch.graph_mask.tolist() == [1.0, 0.0]
