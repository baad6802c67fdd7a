"""The port's training loader against the JAX package's, batch for batch.

Types files written over the two test complexes (``rec_0``/``lig_0`` and
``rec``/``lig``) with mixed labels and an RMSD column. Each setting runs
3 epochs through ``get_data_loader(mode='train')`` of both packages (JAX
with ``prefetch=0``); the real rows of every batch (node features,
coordinates, masks, graph ids, edges, edge attributes, ``recv_perm``,
``y`` and the graph mask) must be equal. Augmented items depend only on
(seed, epoch, item), so epochs 0-2 hold them to the JAX draws by array
equality. Also: a second loader over the same ``cache_dir`` gives the
first's batches, and ``prefetch=2`` gives the batches of ``prefetch=0``.
"""
import numpy as np
import pytest

from pointvs_tpu.data.loader import get_data_loader as jax_get_data_loader
from pointvs_tpu_torch.data.loader import get_data_loader
from tests.setup_and_params import RESOURCES

EPOCHS = 3
COMMON = dict(batch_size=3, radius=4, edge_radius=4, estimate_bonds=True,
              polar_hydrogens=False, compact=True, seed=5, mode='train')
COMPLEXES = ('rec_0.parquet lig_0.parquet', 'rec.parquet lig.parquet')
NODE_FIELDS = ('node_feats', 'coords', 'node_mask', 'graph_id')
EDGE_FIELDS = ('senders', 'receivers', 'edge_attr', 'edge_mask',
               'recv_perm')


def write_types(path, n=8, labels=None, regression=False):
    lines = []
    for i in range(n):
        pair = COMPLEXES[i % 2]
        if regression:
            pki = -1 if i % 3 == 0 else 4.5 + 0.5 * i
            lines.append(f'{pki} {6.0 + 0.25 * i} {-1 if i % 4 else 7.5} '
                         f'{pair}')
        else:
            label = labels(i) if labels else int(i % 3 == 0)
            lines.append(f'{label} -1 {0.4 + 0.7 * i:.2f} {pair}')
    path.write_text('\n'.join(lines) + '\n')
    return path


SETTINGS = {
    'weighted': {},
    'shuffle_single_class': dict(labels=lambda i: 1),
    'augmented_actives': dict(augmented_actives=2),
    'p_noise': dict(p_noise=0.3),
    'p_remove_entity': dict(p_remove_entity=0.3),
    'rot': dict(rot=True),
    'rmsd_relabel': dict(max_active_rms_distance=1.5,
                         min_inactive_rms_distance=2.0,
                         max_inactive_rms_distance=4.5),
    'regression': dict(model_task='regression'),
    'multi_regression': dict(model_task='multi_regression'),
}


def _loaders(tmp_path, settings):
    settings = dict(settings)
    labels = settings.pop('labels', None)
    types = write_types(tmp_path / 'train.types', labels=labels,
                        regression='regression' in settings.get(
                            'model_task', ''))
    kwargs = dict(COMMON, **{'rot': False, **settings})
    jax_dl = jax_get_data_loader(RESOURCES, types_fname=types, prefetch=0,
                                 num_devices=1, **kwargs)
    return jax_dl, get_data_loader(RESOURCES, types, prefetch=0, **kwargs)


def assert_same_batch(got, want):
    n, e = int(want.node_mask.sum()), int(want.edge_mask.sum())
    assert int(got.node_mask.sum()) == n and int(got.edge_mask.sum()) == e
    for fields, rows in ((NODE_FIELDS, n), (EDGE_FIELDS, e)):
        for field in fields:
            np.testing.assert_array_equal(getattr(got, field)[:rows],
                                          getattr(want, field)[:rows],
                                          field)
    for field in ('y', 'graph_mask'):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), field)


def _epochs(loader, unstack=False):
    out = []
    for _ in range(EPOCHS):
        for batch, meta in loader:
            if unstack:
                batch = type(batch)(*[None if a is None else np.asarray(a)[0]
                                      for a in batch])
            out.append((batch, meta))
    return out


@pytest.mark.parametrize('name', sorted(SETTINGS))
def test_train_batches_match_jax(tmp_path, name):
    jax_dl, port_dl = _loaders(tmp_path, SETTINGS[name])
    assert len(port_dl) == len(jax_dl) and len(port_dl.dataset) == len(
        jax_dl.dataset)
    if name == 'weighted':
        assert port_dl.use_weighted_sampler
    if name == 'shuffle_single_class':
        assert not port_dl.use_weighted_sampler and port_dl.shuffle
    want, got = _epochs(jax_dl, unstack=True), _epochs(port_dl)
    assert len(got) == len(want) == EPOCHS * len(port_dl)
    for (g, g_meta), (w, w_meta) in zip(got, want):
        assert_same_batch(g, w)
        assert g_meta.lig_fnames == w_meta.lig_fnames
    if name == 'augmented_actives':
        ds = port_dl.dataset
        assert len(ds) > ds.pre_aug_ds_len
        assert ds.aug_rejects == jax_dl.dataset.aug_rejects
        assert ds.aug_fallbacks == jax_dl.dataset.aug_fallbacks


def test_disk_cache_and_prefetch_give_the_same_batches(tmp_path):
    types = write_types(tmp_path / 'train.types')
    kwargs = dict(COMMON, rot=True, p_remove_entity=0.3,
                  augmented_actives=1, cache_dir=tmp_path / 'cache')
    first = _epochs(get_data_loader(RESOURCES, types, prefetch=0, **kwargs))
    assert len(list((tmp_path / 'cache').glob('*.bin'))) == 2
    second = _epochs(get_data_loader(RESOURCES, types, prefetch=0, **kwargs))
    prefetched = _epochs(get_data_loader(RESOURCES, types, prefetch=2,
                                         **kwargs))
    assert len(first) == len(second) == len(prefetched)
    for (a, _), (b, _), (c, _) in zip(first, second, prefetched):
        assert_same_batch(b, a)
        assert_same_batch(c, a)


def test_prefetch_surfaces_the_producer_error(tmp_path):
    types = write_types(tmp_path / 'train.types')
    (tmp_path / 'lig.parquet').write_bytes(b'not a parquet file')
    (tmp_path / 'rec.parquet').write_bytes(
        (RESOURCES / 'rec.parquet').read_bytes())
    loader = get_data_loader(tmp_path, types, prefetch=2,
                             **dict(COMMON, seed=0))
    with pytest.raises(Exception, match='(?i)parquet'):
        list(loader)
